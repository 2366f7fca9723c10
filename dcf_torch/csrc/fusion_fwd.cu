// Continuous-fusion forward for one BEV scale, hand-written for Hopper.
//
// Replaces the TPU kernel dcf/ops/pallas/fusion_kernel.py::_fwd_kernel
// (pallas_call in _fwd_impl), forward only. Computes, for every BEV
// pixel (b, i, j) of an H x W grid:
//   1. the K nearest valid binned points of the (2r+1)^2 cell window, by
//      squared BEV distance to the pixel centre;
//   2. per neighbour k: h_k = relu(z1[gidx_k] + Wg . (dx, dy, z, dist) + bg)
//      with dist = sqrt(min(d2, 1e6));
//   3. out[..., :hid] = sum_k h_k, out[..., hid] = number of neighbours.
//
// Contract (the plain version: dcf_torch/ops/fusion.py::fused_fusion_plain,
// after dcf/ops/pallas/fusion_kernel.py::fused_fusion_reference):
//   data  [B, H, W, C, 4] f32, payload (x, y, z, gidx) already quantized
//         (quantize_payload_xyz); valid [B, H, W, C] bool (1 byte);
//   z1    [B, P, hid] f32; wgt [hid, 4] f32; bg [hid] f32;
//   out   [B, H, W, hid + 1] f32;
//   stash (training only; both null when serving): per (pixel, k),
//         sel [B, H, W, K] int32, the selected point index or -1 where
//         the pixel has fewer than k + 1 neighbours, and geo
//         [B, H, W, K, 4] f32, its (dx, dy, z, dist) (0 where sel is -1).
//         The backward (fusion_bwd.cu) rebuilds the pre-activations from
//         them, as the TPU kernel's STASH output lets its backward skip
//         the KNN.
//
// Selection rule: the K smallest candidates by the key (d2, scan index),
// lexicographically, where the scan index is (di * win + dj) * C + c
// (window shift major, then bin slot); candidates with d2 >= 1e30 or NaN
// are never taken. That is the plain version's repeated first-minimum
// argmin, ties included. Within one tile the halo slot index
// ((ti + di) * halo_w + tj + dj) * C + c orders a pixel's candidates as
// the scan index does, so it serves as the index; the key is one 64-bit
// integer, d2's bits above the index (d2 >= 0, so its bits order as the
// floats do).
//
// What bounds it on the card: bytes. At the finest main-path scale
// (352 x 400 pixels, C = 8, hid = 64) it writes 37 MB of output (11 us at
// 3.35 TB/s) and reads the valid mask (1.1 MB), the payload of the valid
// slots and the selected z1 rows, against ~0.08 GFLOP of f32 arithmetic.
// The thread-per-pixel kernel this one replaced took 0.052-0.059 ms per
// launch at every scale: a serial latency chain per thread (72 candidates
// with dependent global loads, then 65 channels of dependent z1
// gathers). Design, a block of 256 threads per 2-D tile of one frame's
// pixels (8x16, 8x8 or 4x8 for L = 2, 4, 8 lanes per pixel; the wrapper
// picks L per launch, fusion.py::fusion_launch_shape, so that the coarse
// scales still fill the card):
//   - halo: a thread per cell of the tile plus its r-cell halo reads the
//     cell's valid bytes (8-byte loads where C allows), keeps them as a
//     bit mask in shared memory, and starts cp.async copies of its valid
//     slots' 16-byte payloads, all issued before any is used;
//   - phase 1, KNN from shared memory only: a pixel's candidates are
//     split over L consecutive lanes by bin slot (lane l takes c = l,
//     l + L, ...; it walks the set bits of its slots in each cell's
//     mask). Each lane keeps a sorted K-list of keys in registers (K is a
//     template parameter; an insertion compares with all K entries at
//     once); a butterfly of bitonic merges over warp shuffles leaves the
//     pixel's K in every lane;
//   - phase 2: a thread keeps one group of V = 4 channels, their Wg and
//     bg in registers, and walks the tile's pixels, its K z1 loads for a
//     pixel issued together (float4 along hid); the tile's [pixels,
//     hid + 1] output is staged in shared memory (over the halo);
//   - store: each of the tile's image rows leaves as one bulk copy (TMA)
//     where its global start is 16-byte aligned (W % 4 == 0; a 65-float
//     pixel row is not aligned), else by coalesced 4-byte stores.
// The keys, the insertion, the merge and the halo's slot masks are
// shared with knn.cu (knn_select.cuh).
// Everything accumulates in f32 in the plain version's order (features
// 0..3, then + bg, then + z1; neighbours in key order) and the library is
// built with --fmad=false, so the result equals the plain version bit
// for bit. Tensor cores would not help: the per-pair work is a 4-wide
// dot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int V = 4;           // channels per z1 load (one float4)

using dcf::Key;
using dcf::kEmpty;

struct Smem {
  float* wg;       // [hid, 4]
  float* bg;       // [hid]
  float4* geo;     // [tile, K]
  int* row;        // [tile, K], b * P + gidx
  int* cnt;        // [tile]
  float4* pay;     // phase 1: [cells, C] payloads (valid slots only)
  uint32_t* mask;  // phase 1: [cells], bit c set where slot c is valid
  float* stage;    // phase 2: [tile, hid + 1], over pay / mask
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Byte offsets of the dynamic shared memory layout, alike on host and
// device: wg + bg, geo, row, cnt, then the halo (pay, mask) or, after
// phase 1, the output stage; the last entry is the total.
struct Layout {
  size_t geo, row, cnt, halo, mask, bytes;
  __host__ __device__ Layout(int K, int tile, int cells, int C, int hid) {
    geo = align16(sizeof(float) * hid * 5);
    row = align16(geo + sizeof(float4) * tile * K);
    cnt = align16(row + sizeof(int) * tile * K);
    halo = align16(cnt + sizeof(int) * tile);
    mask = halo + sizeof(float4) * cells * C;
    const size_t end_halo = mask + sizeof(uint32_t) * cells;
    const size_t end_stage = halo + sizeof(float) * tile * (hid + 1);
    bytes = align16(end_halo > end_stage ? end_halo : end_stage);
  }
};

// K: neighbours. A phase-2 thread handles V = 4 channels (hid % 4 == 0).
template <int K>
__global__ void __launch_bounds__(kThreads)
fusion_fwd_kernel(const float4* __restrict__ data,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ z1,
                  const float* __restrict__ wgt,
                  const float* __restrict__ bg,
                  float* __restrict__ out,
                  int* __restrict__ stash_sel,
                  float4* __restrict__ stash_geo,
                  int H, int W, int C, int P, int hid, int r, int L,
                  int TH, int TW, bool wide, float ox, float oy,
                  float cell) {
  extern __shared__ __align__(16) char smem_raw[];
  const int tile = TH * TW;
  const int HH = TH + 2 * r, HW = TW + 2 * r, cells = HH * HW;
  const Layout lay(K, tile, cells, C, hid);
  Smem sm;
  sm.wg = reinterpret_cast<float*>(smem_raw);
  sm.bg = sm.wg + hid * 4;
  sm.geo = reinterpret_cast<float4*>(smem_raw + lay.geo);
  sm.row = reinterpret_cast<int*>(smem_raw + lay.row);
  sm.cnt = reinterpret_cast<int*>(smem_raw + lay.cnt);
  sm.pay = reinterpret_cast<float4*>(smem_raw + lay.halo);
  sm.mask = reinterpret_cast<uint32_t*>(smem_raw + lay.mask);
  sm.stage = reinterpret_cast<float*>(smem_raw + lay.halo);
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int lshift = __ffs(L) - 1, twshift = __ffs(TW) - 1;   // powers of 2

  // ---- stage the halo: a thread per cell reads its valid bytes, keeps
  // them as a bit mask, and at once starts the copies of its valid
  // slots' payloads ----
  for (int e = tid; e < hid * 4; e += kThreads) sm.wg[e] = wgt[e];
  for (int e = tid; e < hid; e += kThreads) sm.bg[e] = bg[e];
  for (int cl = tid; cl < cells; cl += kThreads) {
    const int gi = i0 - r + cl / HW, gj = j0 - r + cl % HW;
    uint32_t m = 0;
    if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
      const size_t base = ((size_t)(b * H + gi) * W + gj) * C;
      m = dcf::slot_mask(valid, base, C, wide);
      for (uint32_t t = m; t != 0; t &= t - 1) {
        const int c = __ffs(t) - 1;
        dcf::cp_async16(sm.pay + cl * C + c, data + base + c);
      }
    }
    sm.mask[cl] = m;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- phase 1: L lanes per pixel, each over slots c = lane (mod L) ----
  {
    const int p = tid >> lshift, lane = tid & (L - 1);
    const int ti = p >> twshift, tj = p & (TW - 1);
    const int i = i0 + ti, j = j0 + tj;
    const bool inside = p < tile && i < H && j < W;
    // pixel centre, f32 as the plain version computes it
    const float cx = ox + ((float)i + 0.5f) * cell;
    const float cy = oy + ((float)j + 0.5f) * cell;
    Key bk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) bk[k] = kEmpty;
    if (inside) {
      // this lane's slots: c = lane, lane + L, ... (C <= 32)
      const uint32_t mine =
          (L == 2 ? 0x55555555u : L == 4 ? 0x11111111u : 0x01010101u) << lane;
      const int win = 2 * r + 1;
      for (int di = 0; di < win; ++di) {
        for (int dj = 0; dj < win; ++dj) {
          const int cl = (ti + di) * HW + tj + dj;
          for (uint32_t t = sm.mask[cl] & mine; t != 0; t &= t - 1) {
            const int s = cl * C + __ffs(t) - 1;
            const float4 q = sm.pay[s];
            const float ddx = q.x - cx;
            const float ddy = q.y - cy;
            const float d = ddx * ddx + ddy * ddy;
            // the plain version marks invalid slots with d2 = 1e30 and
            // never selects anything at or above it
            if (!(d < 1e30f)) continue;
            const Key key = dcf::make_key(d, s);
            if (key < bk[K - 1]) dcf::insert<K>(bk, key);
          }
        }
      }
    }
    // butterfly merge of the L lanes' lists (lanes of a pixel are L
    // consecutive lanes of one warp; L divides 32)
    dcf::merge_lanes<K>(bk, L);
    if (inside) {
      int n = 0;
      const size_t pix = ((size_t)b * H + i) * W + j;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool hit = bk[k] != kEmpty;
        n += hit ? 1 : 0;
        if ((k & (L - 1)) != lane) continue;
        float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        int sel = -1;
        if (hit) {
          const float4 q = sm.pay[dcf::key_s(bk[k])];
          g = make_float4(q.x - cx, q.y - cy, q.z,
                          sqrtf(fminf(dcf::key_d(bk[k]), 1e6f)));
          sel = (int)q.w;
          sm.row[p * K + k] = b * P + sel;
        }
        sm.geo[p * K + k] = g;
        if (stash_sel != nullptr) {
          stash_sel[pix * K + k] = sel;
          stash_geo[pix * K + k] = g;
        }
      }
      if (lane == 0) sm.cnt[p] = n;
    } else if (p < tile && lane == 0) {
      sm.cnt[p] = 0;
    }
  }
  __syncthreads();   // the halo is dead from here: phase 2 stages over it

  // ---- phase 2: a thread keeps one group of V channels (its Wg and bg
  // in registers) and walks pixels, its K z1 loads issued at once ----
  const int hp1 = hid + 1;
  const int groups = hid / V;
  const int rows = kThreads / groups;          // pixels per pass
  const int g = tid % groups;
  if (tid < rows * groups) {
    float w[V][4], bc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int f = 0; f < 4; ++f) w[v][f] = sm.wg[(g * V + v) * 4 + f];
      bc[v] = sm.bg[g * V + v];
    }
    for (int p = tid / groups; p < tile; p += rows) {
      const int n = sm.cnt[p];
      float z[K][V];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < n) {
          const float* src = z1 + (size_t)sm.row[p * K + k] * hid + g * V;
          const float4 v = __ldg(reinterpret_cast<const float4*>(src));
          z[k][0] = v.x;
          z[k][1] = v.y;
          z[k][2] = v.z;
          z[k][3] = v.w;
        }
      }
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < n) {
          const float4 gk = sm.geo[p * K + k];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float geo = gk.x * w[v][0] + gk.y * w[v][1] +
                              gk.z * w[v][2] + gk.w * w[v][3];
            acc[v] += fmaxf(z[k][v] + (geo + bc[v]), 0.0f);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) sm.stage[p * hp1 + g * V + v] = acc[v];
    }
  }
  for (int p = tid; p < tile; p += kThreads)
    sm.stage[p * hp1 + hid] = (float)sm.cnt[p];
  // the stage is read next by the bulk copies (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // ---- the tile's image rows: one bulk copy (TMA) each where both ends
  // are 16-byte aligned and the size a multiple of 16, else coalesced
  // 4-byte stores ----
  const int tw = min(TW, W - j0), th = min(TH, H - i0);
  bool bulk = false;
  for (int ti = 0; ti < th; ++ti) {
    float* dst = out + (((size_t)b * H + i0 + ti) * W + j0) * hp1;
    const float* src = sm.stage + ti * TW * hp1;
    const int n = tw * hp1;
    if (((reinterpret_cast<uintptr_t>(dst) | (n * 4)) & 15) == 0) {
      if (tid == 0) {
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                "l"(dst),
            "r"((unsigned)__cvta_generic_to_shared(src)), "r"(n * 4)
            : "memory");
        bulk = true;
      }
    } else {
      for (int o = tid; o < n; o += kThreads) dst[o] = src[o];
    }
  }
  if (bulk) {   // the stage must outlive the copies' reads
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int K>
cudaError_t launch(const void* data, const void* valid, const void* z1,
                   const void* wgt, const void* bg, void* out,
                   void* stash_sel, void* stash_geo, int B, int H, int W,
                   int C, int P, int hid, int r, int L, int TH, int TW,
                   float ox, float oy, float cell, cudaStream_t stream) {
  if ((long long)B * H * W == 0) return cudaGetLastError();
  const int cells = (TH + 2 * r) * (TW + 2 * r);
  const size_t smem = Layout(K, TH * TW, cells, C, hid).bytes;
  // above 48 KB only after opting in; once per instantiation, before any
  // graph capture (the wrappers' first call is never captured)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fusion_fwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fusion_fwd_kernel<K><<<grid, kThreads, smem, stream>>>(
      static_cast<const float4*>(data), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(z1), static_cast<const float*>(wgt),
      static_cast<const float*>(bg), static_cast<float*>(out),
      static_cast<int*>(stash_sel), static_cast<float4*>(stash_geo), H, W, C,
      P, hid, r, L, TH, TW,
      (C % 8 == 0) && (reinterpret_cast<uintptr_t>(valid) % 8 == 0), ox, oy,
      cell);
  return cudaGetLastError();
}

}  // namespace

// lanes: 2, 4 or 8 per pixel; tile_h x tile_w = 256 / lanes pixels,
// tile_w a power of two.
extern "C" int dcf_fusion_fwd(const void* data, const void* valid,
                              const void* z1, const void* wgt,
                              const void* bg, void* out, void* stash_sel,
                              void* stash_geo, int B, int H, int W, int C,
                              int P, int hid, int K, int r, int lanes,
                              int tile_h, int tile_w, float ox, float oy,
                              float cell, void* stream) {
  if ((lanes != 2 && lanes != 4 && lanes != 8) ||
      tile_h * tile_w * lanes != kThreads || (tile_w & (tile_w - 1)) ||
      r < 0 || C < 1 || C > 32 || hid < V || hid % V != 0 ||
      hid > kThreads)   // phase 2: at most one channel group per thread
    return (int)cudaErrorInvalidValue;
  // cp.async of 16-byte payloads, float4 loads of z1 rows
  if ((reinterpret_cast<uintptr_t>(data) | reinterpret_cast<uintptr_t>(z1)) %
          16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define DCF_CASE(k)                                                        \
  case k:                                                                  \
    return launch<k>(data, valid, z1, wgt, bg, out, stash_sel, stash_geo,  \
                     B, H, W, C, P, hid, r, lanes, tile_h, tile_w, ox, oy, \
                     cell, s);
    DCF_CASE(1) DCF_CASE(2) DCF_CASE(3) DCF_CASE(4)
    DCF_CASE(5) DCF_CASE(6) DCF_CASE(7) DCF_CASE(8)
#undef DCF_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dcf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
