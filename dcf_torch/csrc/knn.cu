// Standalone K-nearest-neighbour selection over dense BEV bins,
// hand-written for Hopper.
//
// Replaces the TPU kernel dcf/ops/pallas/knn_kernel.py::_knn_kernel
// (pallas_call in knn_select_pallas). For every BEV pixel (b, i, j) of an
// H x W grid: the K nearest valid binned points of its (2r+1)^2 cell
// window, by squared BEV distance to the pixel centre.
//
// Contract (the plain version: dcf_torch/ops/knn.py::knn_select_plain,
// after dcf/ops/knn.py::knn_select_dense):
//   data  [B, H, W, C, D] f32 payload, columns 0 and 1 are BEV (x, y);
//   valid [B, H, W, C] bool (1 byte);
//   nbr   [B, H, W, K, D] f32, the selected payloads (0 where not valid);
//   ok    [B, H, W, K] bool, whether the pixel has k + 1 neighbours;
//   dist2 [B, H, W, K] f32, their squared distances (inf where not ok).
// valid, dist2 and the valid rows of nbr equal the plain version's bit
// for bit: the pixel centre and the distance are computed in f32 in the
// plain version's order, and the library is built with --fmad=false.
//
// Tie order is the plain version's (and fusion_fwd.cu's), not the TPU
// kernel's. Candidates are scanned window-shift-major (di, then dj),
// then bin slot; of two equal distances the earlier candidate wins, as
// the plain version's first-minimum argmin does. The TPU kernel scans
// bin slot first (for c, then di, dj), so at equal distances it can pick
// other points.
//
// What bounds it on the card: bytes. At the finest main-path scale
// (352 x 400 pixels, C = 8, D = 4, K = 4, r = 1) it reads the valid mask
// (1.1 MB) and the payload of the valid slots, and writes 11.8 MB (~4 us
// at 3.35 TB/s); the distances are ~5 f32 operations per valid
// candidate. The thread-per-pixel kernel this one replaced took 0.015-
// 0.035 ms per scale, longest at the coarsest (18 blocks of 128 threads
// for 44 x 50 pixels, each thread a serial chain of byte loads, payload
// loads and insertions). Design: the fusion forward's selection
// (knn_select.cuh) with its own write-out, a block of 256 threads per
// 2-D tile of one frame's pixels (8x16, 8x8, 4x8, 4x4 or 2x4 for L = 2,
// 4, 8, 16, 32 lanes per pixel; the wrapper picks L per launch,
// knn.py::knn_launch_shape):
//   - halo: a thread per cell of the tile plus its r-cell halo reads the
//     cell's valid bytes (8-byte loads where C allows), keeps them as a
//     bit mask in shared memory, and starts cp.async copies of its valid
//     slots' payloads (16 bytes at a time where D % 4 == 0, else 4), all
//     issued before any is used;
//   - selection from shared memory only: a pixel's window candidates,
//     numbered (window cell) * C + slot, are split over L consecutive
//     lanes by that number mod L, so a lane walks the set bits of its
//     slots in each cell's mask (for L > C the split takes cells as well
//     as slots). Each lane keeps a sorted K-list of 64-bit keys, d2's
//     bits above the candidate's halo slot index; a butterfly of bitonic
//     merges over warp shuffles leaves the pixel's K in every lane. Any
//     split gives the same keys, so the same bits;
//   - write-out: lane l of a pixel takes its entries k = l (mod L). It
//     stores dist2 and ok from registers (a warp's pixels are one
//     contiguous run of an image row, so a warp's stores cover one run)
//     and copies the entry's payload row from the halo into a stage of
//     the tile's nbr rows ([pixels, K, D], beside the halo: both are live
//     during the copy). Each image row of the tile's nbr leaves as one
//     bulk copy (TMA) where K * D % 4 == 0 (a row then starts 16-byte
//     aligned whatever j0 is), else by coalesced 4-byte stores.
// On the card a block is a chain of latencies (two dependent loads for
// the halo, the selection of its busiest lane, the butterfly, the bulk
// copy) rather than a stream of bytes; more lanes shorten the selection
// but add blocks and merge rounds (python -m dcf_torch.tools.profile_knn).
// Limits (the wrapper raises beyond them): K 1-8 (template instances),
// C <= 32 (a 32-bit slot mask), 2 <= D <= 16, r <= 3; the wrapper picks
// a smaller tile where a shape's does not fit in shared memory (227 KB),
// and within these limits the 2x4 tile always fits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_select.cuh"

namespace {

using dcf::Key;
using dcf::kEmpty;

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Byte offsets of the dynamic shared memory layout, alike on host and
// device (and in knn.py::knn_smem_bytes): the halo's payloads [cells, C,
// D] f32 and slot masks [cells], then the nbr stage [tile, K, D] f32;
// the last entry is the total.
struct Layout {
  size_t mask, nbr, bytes;
  __host__ __device__ Layout(int K, int tile, int cells, int C, int D) {
    mask = align16(sizeof(float) * cells * C * D);
    nbr = align16(mask + sizeof(uint32_t) * cells);
    bytes = align16(nbr + sizeof(float) * tile * K * D);
  }
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// K: neighbours. wide: 8-byte valid loads; vec: 16-byte payload copies;
// bulk: nbr rows leave by bulk copies.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_select_kernel(const float* __restrict__ data,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ nbr, uint8_t* __restrict__ ok,
                  float* __restrict__ dist2, int H, int W, int C, int D,
                  int r, int L, int TH, int TW, bool wide, bool vec,
                  bool bulk, float ox, float oy, float cell) {
  extern __shared__ __align__(16) char smem_raw[];
  const int tile = TH * TW;
  const int HW = TW + 2 * r, cells = (TH + 2 * r) * HW;
  const Layout lay(K, tile, cells, C, D);
  float* pay = reinterpret_cast<float*>(smem_raw);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem_raw + lay.mask);
  float* s_nbr = reinterpret_cast<float*>(smem_raw + lay.nbr);
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int lshift = __ffs(L) - 1, twshift = __ffs(TW) - 1;   // powers of 2

  // ---- stage the halo: a thread per cell reads its valid bytes, keeps
  // them as a bit mask, and at once starts the copies of its valid
  // slots' payloads ----
  for (int cl = tid; cl < cells; cl += kThreads) {
    const int gi = i0 - r + cl / HW, gj = j0 - r + cl % HW;
    uint32_t m = 0;
    if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
      const size_t base = ((size_t)(b * H + gi) * W + gj) * C;
      m = dcf::slot_mask(valid, base, C, wide);
      for (uint32_t t = m; t != 0; t &= t - 1) {
        const int c = __ffs(t) - 1;
        float* dst = pay + (size_t)(cl * C + c) * D;
        const float* src = data + (base + c) * D;
        if (vec) {
#pragma unroll 1
          for (int f = 0; f < D; f += 4) dcf::cp_async16(dst + f, src + f);
        } else {
#pragma unroll 1
          for (int f = 0; f < D; ++f) cp_async4(dst + f, src + f);
        }
      }
    }
    mask[cl] = m;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- selection: L lanes per pixel, lane l over the window candidates
  // w * C + c = l (mod L), w the window cell ----
  const int p = tid >> lshift, lane = tid & (L - 1);
  const int ti = p >> twshift, tj = p & (TW - 1);
  const int i = i0 + ti, j = j0 + tj;
  const bool inside = i < H && j < W;   // tile * L == kThreads: p < tile
  // pixel centre, f32 as the plain version computes it
  const float cx = ox + ((float)i + 0.5f) * cell;
  const float cy = oy + ((float)j + 0.5f) * cell;
  Key bk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) bk[k] = kEmpty;
  if (inside) {
    // slots c = off (mod L) of a cell, C <= 32
    const uint32_t every = L == 2    ? 0x55555555u
                           : L == 4  ? 0x11111111u
                           : L == 8  ? 0x01010101u
                           : L == 16 ? 0x00010001u
                                     : 0x00000001u;
    const int win = 2 * r + 1;
    int off = lane;   // (lane - w * C) mod L
    for (int di = 0; di < win; ++di) {
      for (int dj = 0; dj < win; ++dj) {
        const int cl = (ti + di) * HW + tj + dj;
        for (uint32_t t = mask[cl] & (every << off); t != 0; t &= t - 1) {
          const int s = cl * C + __ffs(t) - 1;
          const float ddx = pay[s * D] - cx;
          const float ddy = pay[s * D + 1] - cy;
          const float d = ddx * ddx + ddy * ddy;
          // the plain version marks invalid slots with d2 = 1e30 and
          // never selects anything at or above it
          if (!(d < 1e30f)) continue;
          const Key key = dcf::make_key(d, s);
          if (key < bk[K - 1]) dcf::insert<K>(bk, key);
        }
        off = (off - C) & (L - 1);
      }
    }
  }
  // the pixel's L lanes are L consecutive lanes of one warp
  dcf::merge_lanes<K>(bk, L);

  // ---- write-out: lane l of a pixel takes its entries k = l (mod L):
  // dist2 and ok straight from registers (a warp's pixels are one
  // contiguous run of an image row), the payload row into the stage ----
  if (inside) {
    const size_t pix = ((size_t)b * H + i) * W + j;
    for (int k = lane; k < K; k += L) {
      Key key = bk[0];   // bk[k] by selects: a runtime index would spill
#pragma unroll
      for (int q = 1; q < K; ++q)
        if (q == k) key = bk[q];
      const bool hit = key != kEmpty;
      dist2[pix * K + k] =
          hit ? dcf::key_d(key) : __int_as_float(0x7f800000);   // +inf
      ok[pix * K + k] = hit ? 1 : 0;
      float* dst = s_nbr + (p * K + k) * D;
      const float* src = pay + (size_t)(hit ? dcf::key_s(key) : 0) * D;
      if ((D & 3) == 0) {   // 16-byte rows in the halo and the stage
#pragma unroll 1
        for (int f = 0; f < D; f += 4)
          *reinterpret_cast<float4*>(dst + f) =
              hit ? *reinterpret_cast<const float4*>(src + f)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
#pragma unroll 1
        for (int f = 0; f < D; ++f) dst[f] = hit ? src[f] : 0.0f;
      }
    }
  }
  // the nbr stage is read next by the bulk copies (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int tw = min(TW, W - j0), th = min(TH, H - i0);
  const int kd = K * D, n = tw * kd;           // floats of one nbr row
  const size_t row0 = ((size_t)b * H + i0) * W + j0;   // pixel (i0, j0)
  if (bulk) {   // a thread per image row of the tile
    if (tid < th) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
              "l"(nbr + (row0 + (size_t)tid * W) * kd),
          "r"((unsigned)__cvta_generic_to_shared(s_nbr + tid * TW * kd)),
          "r"(n * 4)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  } else {
    for (int o = tid; o < th * n; o += kThreads) {
      const int ti2 = o / n, e = o - ti2 * n;
      nbr[(row0 + (size_t)ti2 * W) * kd + e] = s_nbr[ti2 * TW * kd + e];
    }
  }
  if (bulk && tid < th)   // the stage must outlive the copy's reads
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int K>
cudaError_t launch(const void* data, const void* valid, void* nbr, void* ok,
                   void* dist2, int B, int H, int W, int C, int D, int r,
                   int L, int TH, int TW, float ox, float oy, float cell,
                   cudaStream_t stream) {
  if ((long long)B * H * W == 0) return cudaGetLastError();
  const int cells = (TH + 2 * r) * (TW + 2 * r);
  const size_t smem = Layout(K, TH * TW, cells, C, D).bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // above 48 KB only after opting in; once per instantiation, before any
  // graph capture (the wrapper's first call is never captured)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_select_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const auto addr = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr);
  };
  const bool wide = C % 8 == 0 && addr(valid) % 8 == 0;
  const bool vec = D % 4 == 0 && addr(data) % 16 == 0;
  const bool bulk = (K * D) % 4 == 0 && addr(nbr) % 16 == 0;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  knn_select_kernel<K><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(data), static_cast<const uint8_t*>(valid),
      static_cast<float*>(nbr), static_cast<uint8_t*>(ok),
      static_cast<float*>(dist2), H, W, C, D, r, L, TH, TW, wide, vec, bulk,
      ox, oy, cell);
  return cudaGetLastError();
}

}  // namespace

// lanes: 2, 4, 8, 16 or 32 per pixel; tile_h x tile_w = 256 / lanes
// pixels, tile_w a power of two.
extern "C" int dcf_knn_select(const void* data, const void* valid, void* nbr,
                              void* ok, void* dist2, int B, int H, int W,
                              int C, int D, int K, int r, int lanes,
                              int tile_h, int tile_w, float ox, float oy,
                              float cell, void* stream) {
  if (lanes < 2 || lanes > 32 || (lanes & (lanes - 1)) || tile_w < 1 ||
      (tile_w & (tile_w - 1)) || tile_h * tile_w * lanes != kThreads ||
      r < 0 || r > 3 || C < 1 || C > 32 || D < 2 || D > 16)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(data) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dist2) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define DCF_CASE(k)                                                          \
  case k:                                                                    \
    return launch<k>(data, valid, nbr, ok, dist2, B, H, W, C, D, r, lanes,   \
                     tile_h, tile_w, ox, oy, cell, s);
    DCF_CASE(1) DCF_CASE(2) DCF_CASE(3) DCF_CASE(4)
    DCF_CASE(5) DCF_CASE(6) DCF_CASE(7) DCF_CASE(8)
#undef DCF_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
