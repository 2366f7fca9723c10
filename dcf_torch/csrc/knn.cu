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
// then bin slot: candidate index (di * win + dj) * C + c. A strict `<`
// insertion into the K-deep list keeps the earlier of two equal
// distances, as the plain version's first-minimum argmin does. The TPU
// kernel scans bin slot first (for c, then di, dj), so at equal distances
// it can pick other points.
//
// What bounds it on the card: bytes. At the finest main-path scale
// (352 x 400 pixels, C = 8, D = 4, K = 4, r = 1) it reads the bins once
// (140,800 x 8 x 17 B = 19.1 MB) and writes 11.8 MB (~9 us at
// 3.35 TB/s); the distances are ~5 f32 operations per valid candidate.
// Design: one thread per pixel, the selection as in fusion_fwd.cu's
// phase 1 (the insertion list in registers, K a template parameter);
// neighbouring threads read neighbouring bins, and a slot's payload is
// read only when it is valid. The payload rows are read again for the
// K winners and copied out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // pixels (and threads) per block

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_select_kernel(const float* __restrict__ data,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ nbr, uint8_t* __restrict__ ok,
                  float* __restrict__ dist2, int B, int H, int W, int C,
                  int D, int r, float ox, float oy, float cell) {
  const long long npix = (long long)B * H * W;
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= npix) return;
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
        const float* p = data + (long long)(base + c) * D;
        const float ddx = p[0] - cx;
        const float ddy = p[1] - cy;
        float d = ddx * ddx + ddy * ddy;
        // the plain version marks invalid slots with d2 = 1e30 and never
        // selects anything at or above it
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

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long o = pix * K + k;
    const bool hit = best_s[k] >= 0;
    const float* p = data + (long long)(hit ? best_s[k] : 0) * D;
    for (int f = 0; f < D; ++f) nbr[o * D + f] = hit ? p[f] : 0.0f;
    ok[o] = hit ? 1 : 0;
    dist2[o] = best_d[k];  // +inf where no neighbour was inserted
  }
}

template <int K>
cudaError_t launch(const void* data, const void* valid, void* nbr, void* ok,
                   void* dist2, int B, int H, int W, int C, int D, int r,
                   float ox, float oy, float cell, cudaStream_t stream) {
  const long long npix = (long long)B * H * W;
  if (npix == 0) return cudaGetLastError();
  const int blocks = (int)((npix + kThreads - 1) / kThreads);
  knn_select_kernel<K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(data), static_cast<const uint8_t*>(valid),
      static_cast<float*>(nbr), static_cast<uint8_t*>(ok),
      static_cast<float*>(dist2), B, H, W, C, D, r, ox, oy, cell);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dcf_knn_select(const void* data, const void* valid, void* nbr,
                              void* ok, void* dist2, int B, int H, int W,
                              int C, int D, int K, int r, float ox, float oy,
                              float cell, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define DCF_CASE(k) \
  case k:           \
    return launch<k>(data, valid, nbr, ok, dist2, B, H, W, C, D, r, ox, oy, \
                     cell, s);
    DCF_CASE(1) DCF_CASE(2) DCF_CASE(3) DCF_CASE(4)
    DCF_CASE(5) DCF_CASE(6) DCF_CASE(7) DCF_CASE(8)
#undef DCF_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
