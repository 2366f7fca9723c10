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
//   out   [B, H, W, hid + 1] f32.
//
// Tie order is the plain version's, not the Pallas kernel's: candidates
// are scanned window-shift-major (di, then dj), then bin slot, and among
// equal distances the earlier candidate wins (argmin's first index). The
// K-deep insertion list keeps that order: a new candidate goes after
// every entry with an equal distance.
//
// What bounds it on the card: bytes. At the finest main-path scale
// (352 x 400 pixels, C = 8, hid = 64) it reads 19 MB of bins and writes
// 37 MB of output (17 us at 3.35 TB/s), against ~0.08 GFLOP of f32
// arithmetic for a synthetic KITTI-like frame (~1 us at 67 TFLOP/s).
// Design for that:
//   - phase 1, one thread per pixel: the KNN runs with the insertion
//     list in registers (K is a template parameter, so the list is fully
//     unrolled) and leaves the selections (z1 row, 4 geometric features)
//     in shared memory; neighbouring threads read neighbouring bins;
//   - phase 2, the block's threads walk (pixel, channel) pairs channel-
//     fastest, so z1 rows are gathered directly (no one-hot matmul) and
//     the [tile, hid + 1] output is written with coalesced stores;
//   - Wg and bg sit in shared memory; everything accumulates in f32, in
//     the plain version's order (features 0..3, then + bg, then + z1;
//     neighbours in distance order).
// Tensor cores would not help: the per-pair work is a 4-wide dot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // pixels (and threads) per block

template <int K>
__global__ void __launch_bounds__(kTile)
fusion_fwd_kernel(const float4* __restrict__ data,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ z1,
                  const float* __restrict__ wgt,
                  const float* __restrict__ bg,
                  float* __restrict__ out,
                  int B, int H, int W, int C, int P, int hid, int r,
                  float ox, float oy, float cell) {
  extern __shared__ float smem[];
  float* s_wg = smem;                       // [hid, 4]
  float* s_bg = s_wg + hid * 4;             // [hid]
  float* s_geo = s_bg + hid;                // [kTile, K, 4]
  int* s_row = reinterpret_cast<int*>(s_geo + kTile * K * 4);  // [kTile, K]
  int* s_cnt = s_row + kTile * K;           // [kTile]

  for (int e = threadIdx.x; e < hid * 4; e += blockDim.x) s_wg[e] = wgt[e];
  for (int e = threadIdx.x; e < hid; e += blockDim.x) s_bg[e] = bg[e];

  const long long npix = (long long)B * H * W;
  const long long pix0 = (long long)blockIdx.x * kTile;
  const long long pix = pix0 + threadIdx.x;

  if (pix < npix) {
    const int b = (int)(pix / ((long long)H * W));
    const int rem = (int)(pix - (long long)b * H * W);
    const int i = rem / W;
    const int j = rem - i * W;
    // pixel centre, f32 as the plain version computes it
    const float cx = ox + ((float)i + 0.5f) * cell;
    const float cy = oy + ((float)j + 0.5f) * cell;

    float best_d[K];
    int best_s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      best_d[k] = __int_as_float(0x7f800000);  // +inf: empty entry
      best_s[k] = -1;
    }
    const int win = 2 * r + 1;
    for (int di = 0; di < win; ++di) {
      const int ni = i + di - r;
      if (ni < 0 || ni >= H) continue;
      for (int dj = 0; dj < win; ++dj) {
        const int nj = j + dj - r;
        if (nj < 0 || nj >= W) continue;
        const int base = ((b * H + ni) * W + nj) * C;
        for (int c = 0; c < C; ++c) {
          if (!valid[base + c]) continue;
          const float4 p = data[base + c];
          const float ddx = p.x - cx;
          const float ddy = p.y - cy;
          float d = ddx * ddx + ddy * ddy;
          // the plain version marks invalid slots with d2 = 1e30 and
          // never selects anything at or above it
          if (!(d < 1e30f) || !(d < best_d[K - 1])) continue;
          int s = base + c;
          bool shifting = false;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const bool take = shifting || d < best_d[k];
            if (take) {
              const float td = best_d[k];
              const int ts = best_s[k];
              best_d[k] = d;
              best_s[k] = s;
              d = td;
              s = ts;
            }
            shifting = take;
          }
        }
      }
    }

    int n = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float* g = s_geo + (threadIdx.x * K + k) * 4;
      if (best_s[k] >= 0) {
        const float4 p = data[best_s[k]];
        g[0] = p.x - cx;
        g[1] = p.y - cy;
        g[2] = p.z;
        g[3] = sqrtf(fminf(best_d[k], 1e6f));
        s_row[threadIdx.x * K + k] = b * P + (int)p.w;
        ++n;
      }
    }
    s_cnt[threadIdx.x] = n;
  }
  __syncthreads();

  const int tile = (int)min((long long)kTile, npix - pix0);
  const int hp1 = hid + 1;
  for (int e = threadIdx.x; e < tile * hp1; e += blockDim.x) {
    const int p = e / hp1;
    const int ch = e - p * hp1;
    const int n = s_cnt[p];
    float acc;
    if (ch == hid) {
      acc = (float)n;
    } else {
      const float w0 = s_wg[ch * 4 + 0], w1 = s_wg[ch * 4 + 1];
      const float w2 = s_wg[ch * 4 + 2], w3 = s_wg[ch * 4 + 3];
      const float bc = s_bg[ch];
      acc = 0.0f;
      for (int k = 0; k < n; ++k) {
        const float* g = s_geo + (p * K + k) * 4;
        const float geo = g[0] * w0 + g[1] * w1 + g[2] * w2 + g[3] * w3;
        const float pre =
            z1[(long long)s_row[p * K + k] * hid + ch] + (geo + bc);
        acc += fmaxf(pre, 0.0f);
      }
    }
    out[(pix0 + p) * hp1 + ch] = acc;
  }
}

template <int K>
cudaError_t launch(const void* data, const void* valid, const void* z1,
                   const void* wgt, const void* bg, void* out, int B, int H,
                   int W, int C, int P, int hid, int r, float ox, float oy,
                   float cell, cudaStream_t stream) {
  const long long npix = (long long)B * H * W;
  if (npix == 0) return cudaGetLastError();
  const int blocks = (int)((npix + kTile - 1) / kTile);
  const size_t smem = sizeof(float) * (hid * 5 + kTile * K * 4) +
                      sizeof(int) * (kTile * K + kTile);
  fusion_fwd_kernel<K><<<blocks, kTile, smem, stream>>>(
      static_cast<const float4*>(data), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(z1), static_cast<const float*>(wgt),
      static_cast<const float*>(bg), static_cast<float*>(out), B, H, W, C,
      P, hid, r, ox, oy, cell);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dcf_fusion_fwd(const void* data, const void* valid,
                              const void* z1, const void* wgt,
                              const void* bg, void* out, int B, int H, int W,
                              int C, int P, int hid, int K, int r, float ox,
                              float oy, float cell, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define DCF_CASE(k) \
  case k:           \
    return launch<k>(data, valid, z1, wgt, bg, out, B, H, W, C, P, hid, r, \
                     ox, oy, cell, s);
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
