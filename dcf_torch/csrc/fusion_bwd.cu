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
//   dz1 [B, P, hid], dwgt [hid, 4], dbg [hid] f32, zeroed by the caller.
//
// `pre` is rebuilt exactly as the forward builds it (features 0..3 in
// order, then + bg, then + z1; the library is built with --fmad=false),
// so the relu mask `pre > 0` -- the TPU kernel's rule (live = pre > 0)
// -- agrees with the forward bit for bit.
//
// What bounds it on the card: bytes. Per live pair and channel it reads
// a dacc value and a z1 value and does one f32 atomic add into d_z1;
// at the finest main-path scale (2 x 352 x 400 pixels, K = 4, hid = 64)
// the stash is 22.5 MB and dacc 37 MB, against ~10 f32 operations per
// (pair, channel). Design for that:
//   - one thread per (pair, channel), channel fastest: a warp reads 32
//     consecutive channels of one dacc row and of one z1 row (coalesced),
//     and its atomics into d_z1 hit 32 consecutive addresses;
//   - the block size is a multiple of hid, so in the grid-stride loop a
//     thread keeps its channel: its d_wg / d_bg terms sum in registers,
//     are reduced per block in shared memory, and reach device memory as
//     one atomic add per block and (channel, feature);
//   - a point is selected by up to (2r+1)^2 pixels, so d_z1 atomics on a
//     popular row contend; the sums' order then varies from run to run,
//     and the kernel agrees with its plain version to a tolerance that
//     follows from the sums' lengths (fusion.py::fusion_bwd_tolerance),
//     not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // at most; rounded down to a multiple of hid
constexpr int kMaxBlocks = 132 * 8;

__global__ void __launch_bounds__(kThreads)
fusion_bwd_kernel(const int* __restrict__ sel,
                  const float4* __restrict__ geo,
                  const float* __restrict__ z1,
                  const float* __restrict__ wgt,
                  const float* __restrict__ bg,
                  const float* __restrict__ dacc, int ld,
                  float* __restrict__ dz1,
                  float* __restrict__ dwgt,
                  float* __restrict__ dbg,
                  long long npairs, long long pairs_per_frame, int K, int P,
                  int hid) {
  extern __shared__ float s_red[];         // [hid, 5]: d_wg[0..3], d_bg
  for (int e = threadIdx.x; e < hid * 5; e += blockDim.x) s_red[e] = 0.0f;
  __syncthreads();

  const int ch = threadIdx.x % hid;
  const int ppb = blockDim.x / hid;        // pairs per block and pass
  const float w0 = wgt[ch * 4 + 0], w1 = wgt[ch * 4 + 1];
  const float w2 = wgt[ch * 4 + 2], w3 = wgt[ch * 4 + 3];
  const float bc = bg[ch];

  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f, ab = 0.0f;
  const long long stride = (long long)gridDim.x * ppb;
  for (long long pair = (long long)blockIdx.x * ppb + threadIdx.x / hid;
       pair < npairs; pair += stride) {
    const int idx = sel[pair];
    if (idx < 0) continue;
    const float4 g = geo[pair];
    const long long b = pair / pairs_per_frame;
    const long long row = (b * P + idx) * hid + ch;
    const float gg = g.x * w0 + g.y * w1 + g.z * w2 + g.w * w3;
    const float pre = z1[row] + (gg + bc);
    if (!(pre > 0.0f)) continue;
    const float d = dacc[(pair / K) * ld + ch];
    atomicAdd(dz1 + row, d);
    a0 += d * g.x;
    a1 += d * g.y;
    a2 += d * g.z;
    a3 += d * g.w;
    ab += d;
  }
  atomicAdd(s_red + ch * 5 + 0, a0);
  atomicAdd(s_red + ch * 5 + 1, a1);
  atomicAdd(s_red + ch * 5 + 2, a2);
  atomicAdd(s_red + ch * 5 + 3, a3);
  atomicAdd(s_red + ch * 5 + 4, ab);
  __syncthreads();
  for (int e = threadIdx.x; e < hid * 5; e += blockDim.x) {
    const int c = e / 5;
    const int f = e - c * 5;
    if (f < 4) {
      atomicAdd(dwgt + c * 4 + f, s_red[e]);
    } else {
      atomicAdd(dbg + c, s_red[e]);
    }
  }
}

}  // namespace

extern "C" int dcf_fusion_bwd(const void* sel, const void* geo,
                              const void* z1, const void* wgt,
                              const void* bg, const void* dacc, int ld,
                              void* dz1, void* dwgt, void* dbg, int B, int H,
                              int W, int K, int P, int hid, void* stream) {
  if (hid < 1 || hid > kThreads || ld < hid) return (int)cudaErrorInvalidValue;
  const long long pairs_per_frame = (long long)H * W * K;
  const long long npairs = (long long)B * pairs_per_frame;
  if (npairs == 0) return (int)cudaGetLastError();
  const int ppb = kThreads / hid;
  const long long want = (npairs + ppb - 1) / ppb;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  const size_t smem = sizeof(float) * hid * 5;
  fusion_bwd_kernel<<<blocks, ppb * hid, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sel), static_cast<const float4*>(geo),
      static_cast<const float*>(z1), static_cast<const float*>(wgt),
      static_cast<const float*>(bg), static_cast<const float*>(dacc), ld,
      static_cast<float*>(dz1), static_cast<float*>(dwgt),
      static_cast<float*>(dbg), npairs, pairs_per_frame, K, P, hid);
  return (int)cudaGetLastError();
}
