// The rotated clip of dcf_torch/csrc/clip.cu with each vertex list in a
// register array instead of a per-thread column of shared memory: a
// variant kept for measurement, not built into the kernel library.
//
//     python -m dcf_torch.tools.profile_clip   # times both on the card
//
// Same contract, entry point, operations and order as clip.cu (so the
// same bits; its comment gives the argument), with the same list sizes:
// 6 / 9 / 13 / 19 slots after the four stages. A register array can only
// be indexed at compile time, so every stage is unrolled on its input
// slots (template recursion, which also keeps nvcc from demoting the
// arrays to local memory), and a vertex is written to its runtime slot m
// by a select on each slot that m can reach: O(inputs x slots) selects a
// stage where the shared-memory version stores once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// Write (vx, vy) into slot m of a register list: selects on the
// compile-time slots J..HI (m <= HI).
template <int J, int HI, int S>
__device__ __forceinline__ void put(float (&ox)[S], float (&oy)[S], int m,
                                    float vx, float vy) {
  if constexpr (J <= HI && J < S) {
    if (m == J) {
      ox[J] = vx;
      oy[J] = vy;
    }
    put<J + 1, HI, S>(ox, oy, m, vx, vy);
  }
}

// The last live vertex (slot n - 1) of a register list.
template <int K, int S>
__device__ __forceinline__ void last(const float (&x)[S], const float (&y)[S],
                                     int n, float& lx, float& ly) {
  if constexpr (K < S) {
    if (K == n - 1) {
      lx = x[K];
      ly = y[K];
    }
    last<K + 1, S>(x, y, n, lx, ly);
  }
}

// Input vertex I of the clip of (ix, iy) by the edge; the operations of
// the shared-memory version.
template <int I, int NIN, int NOUT>
__device__ __forceinline__ void clip_step(const float (&ix)[NIN],
                                          const float (&iy)[NIN], int n,
                                          float (&ox)[NOUT], float (&oy)[NOUT],
                                          float ex, float ey, float p1x,
                                          float p1y, float& qx, float& qy,
                                          float& d_prev, int& m,
                                          bool* first_x) {
  if constexpr (I < NIN) {
    if (I < n) {
      const float cx = ix[I], cy = iy[I];
      const float d = ex * (cy - p1y) - ey * (cx - p1x);
      const bool cur_in = d >= 0.0f;
      if (cur_in != (d_prev >= 0.0f)) {
        const float denom = d_prev - d;
        const float t = d_prev / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
        put<0, 2 * I, NOUT>(ox, oy, m, qx + t * (cx - qx),
                            qy + t * (cy - qy));
        ++m;
        if (I == 0) *first_x = true;
      }
      if (cur_in) {
        put<0, 2 * I + 1, NOUT>(ox, oy, m, cx, cy);
        ++m;
      }
      qx = cx;
      qy = cy;
      d_prev = d;
      clip_step<I + 1, NIN, NOUT>(ix, iy, n, ox, oy, ex, ey, p1x, p1y, qx,
                                  qy, d_prev, m, first_x);
    }
  }
}

template <int NIN, int NOUT>
__device__ __forceinline__ int clip_stage(const float (&ix)[NIN],
                                          const float (&iy)[NIN], int n,
                                          float (&ox)[NOUT], float (&oy)[NOUT],
                                          float p1x, float p1y, float p2x,
                                          float p2y, bool* first_x) {
  *first_x = false;
  if (n == 0) return 0;
  const float ex = p2x - p1x;
  const float ey = p2y - p1y;
  float qx = ix[0], qy = iy[0];
  last<1, NIN>(ix, iy, n, qx, qy);
  float d_prev = ex * (qy - p1y) - ey * (qx - p1x);
  int m = 0;
  clip_step<0, NIN, NOUT>(ix, iy, n, ox, oy, ex, ey, p1x, p1y, qx, qy,
                          d_prev, m, first_x);
  return m;
}

// The shoelace terms from slot I on, in order.
template <int I, int S>
__device__ __forceinline__ void shoelace(const float (&x)[S],
                                         const float (&y)[S], int m,
                                         float& acc) {
  if constexpr (I < S) {
    if (I < m) {
      acc = acc + (x[I - 1] * y[I] - y[I - 1] * x[I]);
      shoelace<I + 1, S>(x, y, m, acc);
    }
  }
}

__device__ __forceinline__ void corners(const float* box, float (&x)[4],
                                        float (&y)[4]) {
  const float c = cosf(box[4]);
  const float s = sinf(box[4]);
  const float hx[4] = {box[2] * 0.5f, -box[2] * 0.5f, -box[2] * 0.5f,
                       box[2] * 0.5f};
  const float hy[4] = {box[3] * 0.5f, box[3] * 0.5f, -box[3] * 0.5f,
                       -box[3] * 0.5f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = hx[k] * c - hy[k] * s + box[0];
    y[k] = hx[k] * s + hy[k] * c + box[1];
  }
}

__global__ void __launch_bounds__(kThreads)
clip_pairs_kernel(const float* __restrict__ boxes_a,
                  const float* __restrict__ boxes_b,
                  float* __restrict__ out, int n) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  float a[5], b[5];
#pragma unroll
  for (int f = 0; f < 5; ++f) {
    a[f] = boxes_a[idx * 5 + f];
    b[f] = boxes_b[idx * 5 + f];
  }
  float ax[4], ay[4], bx[4], by[4];
  corners(a, ax, ay);  // the polygon
  corners(b, bx, by);  // the clip edges b[k] -> b[k + 1]

  float x1[6], y1[6], x2[9], y2[9], x3[13], y3[13], x4[19], y4[19];
  bool first_x;
  int m = clip_stage(ax, ay, 4, x1, y1, bx[0], by[0], bx[1], by[1], &first_x);
  bool split = !first_x;
  m = clip_stage(x1, y1, m, x2, y2, bx[1], by[1], bx[2], by[2], &first_x);
  split |= !first_x;
  m = clip_stage(x2, y2, m, x3, y3, bx[2], by[2], bx[3], by[3], &first_x);
  split |= !first_x;
  m = clip_stage(x3, y3, m, x4, y4, bx[3], by[3], bx[0], by[0], &first_x);
  split |= !first_x;
  if (m == 0) {
    out[idx] = 0.0f;
    return;
  }
  float lx = x4[0], ly = y4[0];
  last<1, 19>(x4, y4, m, lx, ly);
  const float closing = lx * y4[0] - ly * x4[0];
  float acc = split ? closing : 0.0f;
  shoelace<1, 19>(x4, y4, m, acc);
  if (!split) acc = acc + closing;
  out[idx] = 0.5f * fabsf(acc);
}

}  // namespace

extern "C" int dcf_clip_pairs(const void* boxes_a, const void* boxes_b,
                              void* out, int n, void* stream) {
  if (n > 0) {
    clip_pairs_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes_a), static_cast<const float*>(boxes_b),
        static_cast<float*>(out), n);
  }
  return (int)cudaGetLastError();
}
