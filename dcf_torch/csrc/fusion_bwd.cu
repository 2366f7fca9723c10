// Continuous-fusion backward for one BEV scale, hand-written for Hopper.
//
// Replaces the TPU kernel dcf/ops/pallas/fusion_kernel.py::_bwd_kernel
// (pallas_call in _bwd_impl; the custom VJP _fused_fusion_bwd). The
// forward (fusion_fwd.cu) stashes, per (pixel, k), the selected point
// index `sel` (-1: no k-th neighbour) and its geometric features
// geo = (dx, dy, z, dist). From them this kernel rebuilds
//   pre = z1[b, sel] + (Wg . geo + bg)
// and, with dpre = dacc[pixel] where pre > 0 and sel >= 0 (else 0),
// accumulates
//   d_z1[b, sel, :] += dpre          (segment sum over the pairs)
//   d_wg[:, f]      += dpre * geo[f]  (f = 0..3)
//   d_bg            += dpre.
// The count channel's cotangent is dropped: the count depends on no
// parameter (as in _fused_fusion_bwd).
//
// Contract (the plain version: dcf_torch/ops/fusion.py::
// fused_fusion_bwd_plain):
//   sel [B, H, W, K] int32; geo [B, H, W, K, 4] f32;
//   z1 [B, P, hid] f32; wgt [hid, 4] f32; bg [hid] f32;
//   dacc [B, H, W, ld] f32, of which channels 0..hid-1 are read;
//   dz1 [B, P, hid], dwgt [hid, 4], dbg [hid] f32, written whole;
//   scratch: cnt [B * P] int32, zero on entry;
//   lists [B * P, kCap] int32; feats [B * P, kCap, 4] f32;
//   partials [hid * 5, blocks] f32, blocks <= 256 (the gather's grid).
//
// `pre` is rebuilt exactly as the forward builds it (features 0..3 in
// order, then + bg, then + z1; the library is built with --fmad=false),
// so the relu mask `pre > 0` -- the TPU kernel's rule (live = pre > 0)
// -- agrees with the forward bit for bit.
//
// What bounds it on the card: bytes (the stash, the dacc rows of pixels
// with a selection, the z1 rows of selected points, d_z1 written once),
// against ~10 f32 operations per (pair, channel). A point is selected by
// up to (2r+1)^2 pixels, so a pixel-major scatter needs a float atomic
// per live (pair, channel), and those contend on popular rows and sum in
// an order that changes from run to run. This kernel is point-major
// instead, and deterministic:
//   1. fill: one thread per (pixel, k) slot appends its pair index and
//      features to its point's bucket (integer atomics on the bucket's
//      count, at most one per pair: lanes that share a bucket share one);
//   2. gather: one warp per point, channels across lanes. It sorts the
//      bucket by pair index (a rank sort in shared memory), loads the
//      pairs' dacc rows a few at a time, and sums d_z1 in pair order, the
//      order in which the CPU's `index_add_` adds them, so d_z1 equals
//      the plain version run on the CPU bit for bit. It writes every d_z1
//      row once (zeros for points no pair selects). d_wg / d_bg terms
//      sum per lane in registers, then per block by a fixed tree in
//      shared memory;
//   3. combine: d_wg / d_bg from the blocks' partials, in block order.
// The gather and the combine are launched to start while the kernel before
// them finishes (programmatic dependent launch), and wait for its results
// before reading them.
// A bucket holds kCap = 32 pairs, more than the (2r+1)^2 = 9 or 25 pixels
// that can select one point at radius 1 or 2; a point with more pairs
// (another radius, or a stash from elsewhere) is summed by a scan of its
// frame's pairs, in pair order too: the same bits, slower.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kCap = 32;           // pairs per bucket
constexpr int kFillThreads = 256;
constexpr int kMaxBlocks = 256;    // the gather's grid, at most
constexpr int kCombineThreads = 256;

// One thread per (pixel, k) slot; the lanes of a warp that append to one
// bucket share one atomic (their slots follow lane order).
__global__ void __launch_bounds__(kFillThreads)
fusion_bwd_fill(const int* __restrict__ sel, const float4* __restrict__ geo,
                int* __restrict__ cnt, int* __restrict__ lists,
                float4* __restrict__ feats, int npix, int hw, int K, int P) {
  cudaTriggerProgrammaticLaunchCompletion();   // the gather may start
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kFillThreads + threadIdx.x;
  const int p = q < npix * K ? sel[q] : -1;
  const bool live = p >= 0 && p < P;
  const int key = (q / (hw * K)) * P + p;
  const unsigned peers = __match_any_sync(0xffffffffu, live ? key : -1);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (live && lane == leader) base = atomicAdd(cnt + key, __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  const int slot = base + __popc(peers & ((1u << lane) - 1));
  if (live && slot < kCap) {
    lists[key * kCap + slot] = q;
    feats[key * kCap + slot] = geo[q];
  }
}

// One live-or-dead pair for the lane's channels: rebuild pre, and where
// pre > 0 add the cotangent into d_z1's sum and the d_wg / d_bg partials
// (those fused: d_wg / d_bg are held to a tolerance, d_z1 to the bits).
template <int CH>
__device__ __forceinline__ void accumulate(const float4 g, const float (&d)[CH],
                                           const float (&zr)[CH],
                                           const float (&w)[CH][4],
                                           const float (&bc)[CH],
                                           float (&acc)[CH],
                                           float (&part)[CH][5]) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const float gg = g.x * w[j][0] + g.y * w[j][1] + g.z * w[j][2] +
                     g.w * w[j][3];
    const float pre = zr[j] + (gg + bc[j]);
    if (pre > 0.0f) {
      acc[j] = acc[j] + d[j];
      part[j][0] = __fmaf_rn(d[j], g.x, part[j][0]);
      part[j][1] = __fmaf_rn(d[j], g.y, part[j][1]);
      part[j][2] = __fmaf_rn(d[j], g.z, part[j][2]);
      part[j][3] = __fmaf_rn(d[j], g.w, part[j][3]);
      part[j][4] += d[j];
    }
  }
}

// The pairs of one point that its bucket holds (n <= kCap): lane i holds
// entry i (pair index e, INT_MAX beyond n; features g). The entries are
// sorted by pair index in shared memory, the dacc rows loaded kBatch
// pairs at a time, and the pairs summed in order.
template <int CH>
__device__ __forceinline__ void sum_bucket(
    int n, int e, float4 g, int* s_e, int* s_row, float4* s_g,
    const float* __restrict__ dacc, int ld, int K, int hid, int lane,
    const float (&zr)[CH], const float (&w)[CH][4], const float (&bc)[CH],
    float (&acc)[CH], float (&part)[CH][5]) {
  constexpr int kBatch = CH >= 4 ? 2 : 4;
  s_e[lane] = e;
  __syncwarp();
  int rank = 0;
  for (int i = 0; i < n; ++i) rank += s_e[i] < e;
  if (lane < n) {
    s_row[rank] = (e / K) * ld;   // the pixel's dacc row
    s_g[rank] = g;
  }
  __syncwarp();
  for (int t0 = 0; t0 < n; t0 += kBatch) {
    float dv[kBatch][CH];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u;
      const float* row = dacc + (t < n ? s_row[t] : 0);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c = lane + 32 * j;
        dv[u][j] = (t < n && c < hid) ? row[c] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (t0 + u < n) accumulate<CH>(s_g[t0 + u], dv[u], zr, w, bc, acc, part);
    }
  }
  __syncwarp();
}

// CH channels per lane (c = lane + 32 j), NT threads per block, one block
// per SM. Warp gw takes the points gw + i * (warps in the grid), 32 at a
// time: one load brings their counts, and each selected point's bucket
// and z1 row are loaded while the point before it is summed. The block's
// d_wg / d_bg partial goes to partials[:, block].
template <int CH, int NT>
__global__ void __launch_bounds__(NT, 1)
fusion_bwd_gather(const int* __restrict__ sel, const float4* __restrict__ geo,
                  const float* __restrict__ z1, const float* __restrict__ wgt,
                  const float* __restrict__ bg,
                  const float* __restrict__ dacc, int ld,
                  const int* __restrict__ lists,
                  const float4* __restrict__ feats,
                  const int* __restrict__ cnt,
                  float* __restrict__ dz1, float* __restrict__ partials,
                  int nkeys, int P, int hwk, int K, int hid) {
  constexpr int NW = NT / 32;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ int s_e[NW][kCap];    // the bucket as filled
  __shared__ int s_row[NW][kCap];  // ... sorted by pair index: dacc rows
  __shared__ float4 s_g[NW][kCap];  // ... and features
  extern __shared__ float s_red[];  // [NW / 2][hid * 5]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float w[CH][4], bc[CH], part[CH][5];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = lane + 32 * j;
    const bool on = c < hid;
#pragma unroll
    for (int f = 0; f < 4; ++f) w[j][f] = on ? wgt[c * 4 + f] : 0.0f;
    bc[j] = on ? bg[c] : 0.0f;
#pragma unroll
    for (int f = 0; f < 5; ++f) part[j][f] = 0.0f;
  }

  cudaGridDependencySynchronize();   // the fill's buckets are complete
  cudaTriggerProgrammaticLaunchCompletion();   // the combine may start
  const int tw = gridDim.x * NW;
  for (int base = blockIdx.x * NW + warp; base < nkeys; base += 32 * tw) {
    const int my_key = base + lane * tw;
    const int my_n = my_key < nkeys ? cnt[my_key] : 0;
    unsigned todo = __ballot_sync(kAll, my_n > 0);
    const unsigned inside = __ballot_sync(kAll, my_key < nkeys);
    // a point's bucket entry for this lane, and its z1 row
    int n = 0, e = INT_MAX, jc = 0;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    float zr[CH];
    auto fetch = [&](unsigned left, int& jj, int& nn, int& ee, float4& gg,
                     float (&zz)[CH]) {
      jj = __ffs(left) - 1;
      const int key = base + jj * tw;
      nn = __shfl_sync(kAll, my_n, jj);
      ee = INT_MAX;
      gg = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lane < nn && nn <= kCap) {
        ee = lists[key * kCap + lane];
        gg = feats[key * kCap + lane];
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c = lane + 32 * j;
        zz[j] = c < hid ? z1[(long long)key * hid + c] : 0.0f;
      }
    };
    if (todo) fetch(todo, jc, n, e, g, zr);
    for (unsigned z = inside & ~todo; z; z &= z - 1) {   // unselected: 0
      const long long row = (long long)(base + (__ffs(z) - 1) * tw) * hid;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c = lane + 32 * j;
        if (c < hid) dz1[row + c] = 0.0f;
      }
    }
    while (todo) {
      todo &= todo - 1;
      const int key = base + jc * tw;
      int jn = 0, nn = 0, en = INT_MAX;
      float4 gn = make_float4(0.f, 0.f, 0.f, 0.f);
      float zn[CH];
      if (todo) fetch(todo, jn, nn, en, gn, zn);   // the next point, ahead
      float acc[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) acc[j] = 0.0f;
      if (n <= kCap) {
        sum_bucket<CH>(n, e, g, s_e[warp], s_row[warp], s_g[warp], dacc, ld,
                       K, hid, lane, zr, w, bc, acc, part);
      } else {
        // more pairs than a bucket holds: scan the frame's pairs in order
        const int b = key / P;
        const int p = key - b * P;
        const long long first = (long long)b * hwk;
        for (int q0 = 0; q0 < hwk; q0 += 32) {
          const bool hit = q0 + lane < hwk && sel[first + q0 + lane] == p;
          unsigned m = __ballot_sync(kAll, hit);
          while (m) {
            const long long q = first + q0 + (__ffs(m) - 1);
            m &= m - 1;
            const float* row = dacc + (q / K) * ld;
            float dv[CH];
#pragma unroll
            for (int j = 0; j < CH; ++j) {
              const int c = lane + 32 * j;
              dv[j] = c < hid ? row[c] : 0.0f;
            }
            accumulate<CH>(geo[q], dv, zr, w, bc, acc, part);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int c = lane + 32 * j;
        if (c < hid) dz1[(long long)key * hid + c] = acc[j];
      }
      jc = jn;
      n = nn;
      e = en;
      g = gn;
#pragma unroll
      for (int j = 0; j < CH; ++j) zr[j] = zn[j];
    }
  }

  // d_wg / d_bg: the warps' partials summed by a fixed tree
  const int hid5 = hid * 5;
  if (warp >= NW / 2) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lane + 32 * j;
      if (c < hid) {
#pragma unroll
        for (int f = 0; f < 5; ++f)
          s_red[(warp - NW / 2) * hid5 + c * 5 + f] = part[j][f];
      }
    }
  }
  __syncthreads();
  if (warp < NW / 2) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lane + 32 * j;
      if (c < hid) {
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          float* r = s_red + warp * hid5 + c * 5 + f;
          *r = part[j][f] + *r;
        }
      }
    }
  }
  __syncthreads();
  for (int rows = NW / 2; rows > 1;) {      // halve the rows, rounding up
    const int half = (rows + 1) / 2;
    for (int e = threadIdx.x; e < (rows - half) * hid5; e += NT) {
      s_red[e] = s_red[e] + s_red[e + half * hid5];
    }
    rows = half;
    __syncthreads();
  }
  for (int e = threadIdx.x; e < hid5; e += NT) {
    partials[e * gridDim.x + blockIdx.x] = s_red[e];
  }
}

// d_wg / d_bg from the G blocks' partials, a warp per element: lane l sums
// blocks l, l + 32, ... in order, then a butterfly over the lanes.
__global__ void __launch_bounds__(kCombineThreads)
fusion_bwd_combine(const float* __restrict__ partials,
                   float* __restrict__ dwgt, float* __restrict__ dbg, int G,
                   int hid5) {
  cudaGridDependencySynchronize();   // the gather's partials are complete
  const int lane = threadIdx.x & 31;
  const int e = (blockIdx.x * kCombineThreads + threadIdx.x) >> 5;
  if (e >= hid5) return;
  float v[kMaxBlocks / 32];
#pragma unroll
  for (int k = 0; k < kMaxBlocks / 32; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < G ? partials[e * G + i] : 0.0f;
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxBlocks / 32; ++k) sum = sum + v[k];
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    sum = sum + __shfl_xor_sync(0xffffffffu, sum, m);
  }
  if (lane == 0) {
    const int c = e / 5;
    const int f = e - c * 5;
    if (f < 4) {
      dwgt[c * 4 + f] = sum;
    } else {
      dbg[c] = sum;
    }
  }
}

// Launch `kernel` so that it may start while the kernel before it on the
// stream finishes (programmatic dependent launch): it waits for that
// kernel's results itself (cudaGridDependencySynchronize).
template <typename... Params, typename... Args>
int launch_after(void (*kernel)(Params...), int blocks, int threads,
                 size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, kernel, args...);
}

template <int CH, int NT>
int launch_gather(const int* sel, const float4* geo, const float* z1,
                  const float* wgt, const float* bg, const float* dacc, int ld,
                  const int* lists, const float4* feats, const int* cnt,
                  float* dz1,
                  float* partials, int nkeys, int P, int hwk, int K, int hid,
                  int blocks, cudaStream_t stream) {
  // shared memory: 24 KB of buckets at most, the tree's 20 KB at most
  return launch_after(fusion_bwd_gather<CH, NT>, blocks, NT,
                      sizeof(float) * (NT / 64) * hid * 5, stream, sel, geo,
                      z1, wgt, bg, dacc, ld, lists, feats, cnt, dz1, partials,
                      nkeys, P, hwk, K, hid);
}

}  // namespace

extern "C" int dcf_fusion_bwd(const void* sel, const void* geo,
                              const void* z1, const void* wgt,
                              const void* bg, const void* dacc, int ld,
                              void* dz1, void* dwgt, void* dbg, void* cnt,
                              void* lists, void* feats, void* partials, int B,
                              int H, int W, int K, int P, int hid, int blocks,
                              void* stream) {
  if (hid < 1 || hid > 256 || ld < hid || K < 1 || blocks < 1 ||
      blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const long long hwk = (long long)H * W * K;
  const long long npairs = (long long)B * hwk;
  const long long nkeys = (long long)B * P;
  if (npairs >= INT_MAX || nkeys * kCap >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<int*>(cnt);
  auto* l = static_cast<int*>(lists);
  auto* f = static_cast<float4*>(feats);
  const long long npix = (long long)B * H * W;
  if (npix > 0) {
    fusion_bwd_fill<<<(int)((npix * K + kFillThreads - 1) / kFillThreads),
                      kFillThreads, 0, s>>>(
        static_cast<const int*>(sel), static_cast<const float4*>(geo), c, l, f,
        (int)npix, H * W, K, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto go = [&](auto launch) {
    return launch(static_cast<const int*>(sel), static_cast<const float4*>(geo),
                  static_cast<const float*>(z1), static_cast<const float*>(wgt),
                  static_cast<const float*>(bg),
                  static_cast<const float*>(dacc), ld, l, f, c,
                  static_cast<float*>(dz1), static_cast<float*>(partials),
                  (int)nkeys, P, (int)hwk, K, hid, blocks, s);
  };
  int err;
  if (hid <= 32) {
    err = go(launch_gather<1, 1024>);
  } else if (hid <= 64) {
    err = go(launch_gather<2, 1024>);
  } else if (hid <= 128) {
    err = go(launch_gather<4, 512>);
  } else {
    err = go(launch_gather<8, 256>);
  }
  if (err != 0) return err;
  const int hid5 = hid * 5;
  return launch_after(fusion_bwd_combine,
                      (hid5 * 32 + kCombineThreads - 1) / kCombineThreads,
                      kCombineThreads, 0, s,
                      static_cast<const float*>(partials),
                      static_cast<float*>(dwgt), static_cast<float*>(dbg),
                      blocks, hid5);
}
