// PointPillars' pillar encoder, hand-written for Hopper: pillarization and
// the pillar feature net (PFN) fused with its scatter onto the canvas.
//
// They replace no TPU kernel (the JAX package has no PointPillars). They
// exist because a pillar's number and a point's slot depend on the data:
// with nonzero / unique in PyTorch they would cost a host sync every
// frame; and because the PFN in plain ops writes and reads a [P, N, C]
// tensor (12,000 x 100 x 64: 154 MB in bf16) where this kernel reads the
// points.
//
// Contract (dcf_torch/ops/pillars.py has the rule and the plain versions,
// which these kernels give bit for bit):
//   dcf_pillarize: points [B, n, 4] f32, mask [B, n] bool ->
//     coords [B, P, 2] i32 (zeroed by the caller), counts [B, P] i32,
//     pmask [B, P] bool, table [B, P, N] i32 (-1 filled by the caller),
//     stats [B, 3] i32 (points in the ROI, points kept, non-empty cells);
//     scratch: first [B, gx * gy] i32 (INT_MAX filled by the caller),
//     per-point [B, n] i32.
//   dcf_pfn_scatter: points, the tables, the folded linear + BatchNorm
//     weight [9, C] f32 and bias [C] f32 -> canvas [B, gx, gy, C] (f32 or
//     bf16, zeroed by the caller), the kept pillars' rows written.
//
// What bounds them on the card. Pillarize: latency. Its bytes are a few
// hundred KB (points, the cell array, the tables' rows in use), but
// numbering pillars by their first point and giving slots in point order
// are orderings over the whole cloud. Design: one block of 1024 threads
// per frame. The cells and each cell's first point (atomicMin, whose
// result does not depend on the order) are parallel; pillar numbers are
// an exclusive block scan of the first-point flags in point order; slots
// are given by one warp walking the points 32 at a time, __match_any_sync
// grouping the lanes of one pillar; the points' cells and then pillars,
// and the running counts, live in shared memory (4 bytes a point and a
// pillar: 146 KB at 24,576 points and 12,000 pillars), so that walk
// waits on no global load. The table is filled with -1 and `first` with
// INT_MAX by the caller's fills (whole-card writes, faster than one
// block's). PFN: bytes (each kept point read once, 16 bytes, its slot's
// index, and 2 bytes a channel of each kept pillar's canvas row written
// once), against 9 multiplies and adds a point and channel in float32
// (outside the tensor cores). Design: one warp per pillar, two channels a
// lane at C = 64; the pillar's mean needs its kept points' sum first, so
// the warp walks the pillar's slots twice (the second pass hits L1); the
// weights live in shared memory.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPillarizeThreads = 1024;
constexpr int kPillarizeWarps = kPillarizeThreads / 32;
constexpr int kPfnThreads = 256;                 // 8 pillars a block
constexpr int kPfnWarps = kPfnThreads / 32;
constexpr int kFeatures = 9;
constexpr int kMaxPerLane = 4;                   // C <= 128

__global__ void __launch_bounds__(kPillarizeThreads)
pillarize_kernel(const float4* __restrict__ points,
                 const unsigned char* __restrict__ mask, int n,
                 int* __restrict__ first, int* __restrict__ scratch,
                 int* __restrict__ coords, int* __restrict__ counts,
                 unsigned char* __restrict__ pmask, int* __restrict__ table,
                 int* __restrict__ stats, int gx, int gy, int P, int N,
                 float x_min, float y_min, float z_min, float z_max,
                 float inv) {
  extern __shared__ int smem[];
  int* cnt = smem;                               // [P] points seen a pillar
  int* cell_of = smem + P;                       // [n] cell, then pillar
  __shared__ int warp_base[kPillarizeWarps];
  __shared__ int total_s;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  points += (size_t)b * n;
  mask += (size_t)b * n;
  first += (size_t)b * gx * gy;
  int* first_pid = scratch + (size_t)b * n;      // at first points
  coords += (size_t)b * P * 2;
  counts += (size_t)b * P;
  pmask += (size_t)b * P;
  table += (size_t)b * P * N;

  for (int p = t; p < P; p += kPillarizeThreads) cnt[p] = 0;

  // 1. each point's cell (-1 outside the ROI), each cell's first point
  for (int i = t; i < n; i += kPillarizeThreads) {
    int c = -1;
    if (mask[i]) {
      const float4 q = points[i];
      const float fx = floorf((q.x - x_min) * inv);
      const float fy = floorf((q.y - y_min) * inv);
      if (fx >= 0.0f && fx < (float)gx && fy >= 0.0f && fy < (float)gy &&
          q.z >= z_min && q.z < z_max)
        c = (int)fx * gy + (int)fy;
    }
    cell_of[i] = c;
    if (c >= 0) atomicMin(&first[c], i);
  }
  __syncthreads();

  // 2. pillar numbers: an exclusive scan of the first-point flags in point
  //    order, thread t owning the points [lo, hi)
  const int per = (n + kPillarizeThreads - 1) / kPillarizeThreads;
  const int lo = min(t * per, n);
  const int hi = min(lo + per, n);
  int mine = 0;
  for (int i = lo; i < hi; ++i) {
    const int c = cell_of[i];
    mine += (c >= 0 && first[c] == i);
  }
  int incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_base[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_base[lane];
    int wi = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi += v;
    }
    warp_base[lane] = wi - w;
    if (lane == 31) total_s = wi;
  }
  __syncthreads();
  int next = warp_base[warp] + incl - mine;
  for (int i = lo; i < hi; ++i) {
    const int c = cell_of[i];
    if (c >= 0 && first[c] == i) {
      first_pid[i] = next;
      if (next < P) {
        coords[2 * next] = c / gy;
        coords[2 * next + 1] = c % gy;
      }
      ++next;
    }
  }
  __syncthreads();
  const int total = total_s;

  // 3. each point's pillar: the number at its cell's first point
  for (int i = t; i < n; i += kPillarizeThreads) {
    const int c = cell_of[i];
    cell_of[i] = c >= 0 ? first_pid[first[c]] : -1;
  }
  __syncthreads();

  // 4. slots in point order: one warp walks the points 32 at a time
  if (warp == 0) {
    int in_roi = 0, placed = 0;
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const int p = i < n ? cell_of[i] : -1;
      in_roi += p >= 0;
      const bool kept = p >= 0 && p < P;
      const unsigned peers = __match_any_sync(kFull, kept ? p : -1);
      const int rank = __popc(peers & below);
      const int seen = kept ? cnt[p] : 0;
      __syncwarp();
      if (kept) {
        const int slot = seen + rank;
        if (slot < N) {
          table[(size_t)p * N + slot] = i;
          ++placed;
        }
        if (rank == 0) cnt[p] = seen + __popc(peers);
      }
      __syncwarp();
    }
    for (int d = 16; d > 0; d >>= 1) {
      in_roi += __shfl_down_sync(kFull, in_roi, d);
      placed += __shfl_down_sync(kFull, placed, d);
    }
    if (lane == 0) {
      stats[3 * b] = in_roi;
      stats[3 * b + 1] = placed;
      stats[3 * b + 2] = total;
    }
  }
  __syncthreads();

  // 5. counts and the pillar mask
  for (int p = t; p < P; p += kPillarizeThreads) {
    counts[p] = min(cnt[p], N);
    pmask[p] = p < total;
  }
}

__device__ __forceinline__ float relu(float v) { return v > 0.0f ? v : 0.0f; }

__global__ void __launch_bounds__(kPfnThreads)
pfn_scatter_kernel(const float4* __restrict__ points,
                   const int* __restrict__ table,
                   const int* __restrict__ counts,
                   const unsigned char* __restrict__ pmask,
                   const int* __restrict__ coords,
                   const float* __restrict__ weight,
                   const float* __restrict__ bias, void* __restrict__ canvas,
                   int out_bf16, int B, int n, int P, int N, int C, int gx,
                   int gy, float x_min, float y_min, float vs) {
  extern __shared__ float sw[];                  // weight [9, C], bias [C]
  for (int k = threadIdx.x; k < (kFeatures + 1) * C; k += kPfnThreads)
    sw[k] = k < kFeatures * C ? weight[k] : bias[k - kFeatures * C];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int pillar = blockIdx.x * kPfnWarps + (threadIdx.x >> 5);
  if (pillar >= B * P || !pmask[pillar]) return;
  const int b = pillar / P;
  const int cnt = counts[pillar];
  const int* row = table + (size_t)pillar * N;
  const float4* pts = points + (size_t)b * n;
  const int per_lane = C / 32;

  // the mean of the kept points, summed in slot order
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int s = 0; s < cnt; ++s) {
    const float4 q = pts[row[s]];
    sx = sx + q.x;
    sy = sy + q.y;
    sz = sz + q.z;
  }
  const float den = (float)cnt;
  const float mx = sx / den, my = sy / den, mz = sz / den;
  const int ix = coords[2 * pillar];
  const int iy = coords[2 * pillar + 1];
  const float cx = ((float)ix + 0.5f) * vs + x_min;
  const float cy = ((float)iy + 0.5f) * vs + y_min;

  float best[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    best[j] = 0.0f;
    if (j < per_lane && cnt < N) {               // an empty slot: features 0
      const int c = lane + 32 * j;
      float acc = 0.0f * sw[c];
#pragma unroll
      for (int k = 1; k < kFeatures; ++k) acc = acc + 0.0f * sw[k * C + c];
      best[j] = relu(acc + sw[kFeatures * C + c]);
    }
  }
  for (int s = 0; s < cnt; ++s) {
    const float4 q = pts[row[s]];
    const float f[kFeatures] = {q.x, q.y, q.z, q.w, q.x - mx, q.y - my,
                                q.z - mz, q.x - cx, q.y - cy};
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      if (j < per_lane) {
        const int c = lane + 32 * j;
        float acc = f[0] * sw[c];
#pragma unroll
        for (int k = 1; k < kFeatures; ++k) acc = acc + f[k] * sw[k * C + c];
        const float v = relu(acc + sw[kFeatures * C + c]);
        best[j] = v > best[j] ? v : best[j];
      }
    }
  }
  const size_t at = (((size_t)b * gx + ix) * gy + iy) * C;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    if (j < per_lane) {
      const int c = lane + 32 * j;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(canvas)[at + c] =
            __float2bfloat16_rn(best[j]);
      else
        static_cast<float*>(canvas)[at + c] = best[j];
    }
  }
}

}  // namespace

extern "C" int dcf_pillarize(const void* points, const void* mask,
                             void* first, void* scratch, void* coords,
                             void* counts, void* pmask, void* table,
                             void* stats, int B, int n, int gx, int gy, int P,
                             int N, float x_min, float y_min, float z_min,
                             float z_max, float inv, void* stream) {
  const size_t smem = sizeof(int) * ((size_t)P + n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pillarize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pillarize_kernel<<<B, kPillarizeThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float4*>(points),
      static_cast<const unsigned char*>(mask), n, static_cast<int*>(first),
      static_cast<int*>(scratch), static_cast<int*>(coords),
      static_cast<int*>(counts), static_cast<unsigned char*>(pmask),
      static_cast<int*>(table), static_cast<int*>(stats), gx, gy, P, N, x_min,
      y_min, z_min, z_max, inv);
  return (int)cudaGetLastError();
}

extern "C" int dcf_pfn_scatter(const void* points, const void* table,
                               const void* counts, const void* pmask,
                               const void* coords, const void* weight,
                               const void* bias, void* canvas, int out_bf16,
                               int B, int n, int P, int N, int C, int gx,
                               int gy, float x_min, float y_min, float vs,
                               void* stream) {
  const int blocks = (B * P + kPfnWarps - 1) / kPfnWarps;
  const size_t smem = sizeof(float) * (size_t)(kFeatures + 1) * C;
  pfn_scatter_kernel<<<blocks, kPfnThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float4*>(points), static_cast<const int*>(table),
      static_cast<const int*>(counts),
      static_cast<const unsigned char*>(pmask),
      static_cast<const int*>(coords), static_cast<const float*>(weight),
      static_cast<const float*>(bias), canvas, out_bf16, B, n, P, N, C, gx,
      gy, x_min, y_min, vs);
  return (int)cudaGetLastError();
}
