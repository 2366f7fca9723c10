// Intersection areas of rotated BEV rectangle pairs, hand-written for
// Hopper.
//
// Replaces the TPU kernel dcf/ops/pallas/clip_kernel.py::_clip_kernel
// (pallas_call in rotated_intersection_area_pairs). Contract:
//   boxes_a [N, 5], boxes_b [N, 5] f32 (x, y, dx, dy, yaw) -> out [N] f32,
// the area of a's rectangle clipped by the four edges of b's.
//
// The plain version (dcf_torch/geometry/boxes.py::
// rotated_intersection_area) repeats the reference: a sort-free
// Sutherland-Hodgman clip whose vertex buffer doubles 4 -> 8 -> 16 -> 32
// -> 64 (every slot emits its edge crossing and itself), dropped slots
// filled with their nearest valid predecessor, an `alive` flag that
// zeroes pairs whose polygon ever empties, and the shoelace terms summed
// in slot order. This kernel clips the live vertices only (compacting
// Sutherland-Hodgman), and gives the same bits, because:
//   - a filled slot is a copy of a live vertex; no crossing is emitted
//     between two equal vertices, and a repeated vertex adds an exact 0
//     to the shoelace sum (x*y - y*x, no FMA: --fmad=false);
//   - so the filled buffer is the list of live candidates read
//     cyclically, starting at the first one when slot 0 is live, else at
//     a copy of the last one ("split": slot 0 and the last slot are
//     copies of one vertex, and that vertex's incoming edge is clipped
//     last instead of first). Once split, slot 0 is a copy in every later
//     stage;
//   - the compacting clip emits, edge by edge in list order, exactly the
//     live candidates, each computed with the plain version's operations
//     on the same operand values, and tracks `split` (set when the first
//     edge emits no crossing); the shoelace sum then starts at the
//     closing edge when split and ends with it otherwise.
// tests/test_torch_kernel_order.py holds a plain model of this order to
// rotated_intersection_area bit for bit; the kernel agrees with its plain
// version bit for bit wherever CUDA's cosf / sinf agree with PyTorch's.
//
// What bounds it on the card: bytes. A pair reads 40 bytes and writes 4:
// at the main path's 196,608 pairs that is ~9 MB (2.6 us at 3.35 TB/s),
// against ~180 f32 operations per pair on live vertices (~0.5 us at 67
// TFLOP/s outside the tensor cores) and a division only per emitted
// crossing (at most 2 per edge of b on a convex polygon). Design: one
// thread per pair; a polygon lives in a per-thread column of shared
// memory ([slot][thread], so a warp's accesses hit 32 banks whatever the
// slots), two lists in turn, appended to at a running count. A clip of an
// n-vertex list by a half-plane emits at most 1.5 n candidates (kept +
// crossings <= n - c/2 + c for c crossings, c <= n), so 4 -> 6 -> 9 -> 13
// -> 19 holds every input, rounding's non-convex lists included. Lists in
// register arrays instead (csrc/variants/clip_registers.cu) need a select
// on every slot a write can reach, twice the instructions, and run
// slower: python -m dcf_torch.tools.profile_clip times both.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlotsA = 13;        // the outputs of stages 1 and 3
constexpr int kSlotsB = 19;        // the outputs of stages 2 and 4

// Clip the n-vertex list `in` by the half-plane left of p1 -> p2 into
// `out` (both strided by kThreads); returns the count and sets *first_x
// when the first edge (in[n-1] -> in[0]) emits a crossing.
__device__ __forceinline__ int clip_stage(const float2* in, int n, float2* out,
                                          float p1x, float p1y, float p2x,
                                          float p2y, bool* first_x) {
  *first_x = false;
  if (n == 0) return 0;
  const float ex = p2x - p1x;
  const float ey = p2y - p1y;
  float2 prev = in[(n - 1) * kThreads];
  float d_prev = ex * (prev.y - p1y) - ey * (prev.x - p1x);
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const float2 cur = in[i * kThreads];
    const float d = ex * (cur.y - p1y) - ey * (cur.x - p1x);
    const bool cur_in = d >= 0.0f;
    if (cur_in != (d_prev >= 0.0f)) {
      const float denom = d_prev - d;
      const float t = d_prev / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
      out[m * kThreads] = make_float2(prev.x + t * (cur.x - prev.x),
                                      prev.y + t * (cur.y - prev.y));
      ++m;
      if (i == 0) *first_x = true;
    }
    if (cur_in) {
      out[m * kThreads] = cur;
      ++m;
    }
    prev = cur;
    d_prev = d;
  }
  return m;
}

// The first clip, of a's corners (in registers) by the edge p1 -> p2:
// the same operations as clip_stage, on compile-time indices.
__device__ __forceinline__ int clip_corners(const float (&x)[4],
                                            const float (&y)[4], float2* out,
                                            float p1x, float p1y, float p2x,
                                            float p2y, bool* first_x) {
  const float ex = p2x - p1x;
  const float ey = p2y - p1y;
  float d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = ex * (y[k] - p1y) - ey * (x[k] - p1x);
  *first_x = false;
  int m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pv = (i + 3) & 3;
    const bool cur_in = d[i] >= 0.0f;
    if (cur_in != (d[pv] >= 0.0f)) {
      const float denom = d[pv] - d[i];
      const float t = d[pv] / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
      out[m * kThreads] = make_float2(x[pv] + t * (x[i] - x[pv]),
                                      y[pv] + t * (y[i] - y[pv]));
      ++m;
      if (i == 0) *first_x = true;
    }
    if (cur_in) {
      out[m * kThreads] = make_float2(x[i], y[i]);
      ++m;
    }
  }
  return m;
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
  __shared__ float2 s_poly[kSlotsA + kSlotsB][kThreads];
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

  float2* la = &s_poly[0][threadIdx.x];
  float2* lb = &s_poly[kSlotsA][threadIdx.x];
  bool first_x;
  int m = clip_corners(ax, ay, la, bx[0], by[0], bx[1], by[1], &first_x);
  bool split = !first_x;
  m = clip_stage(la, m, lb, bx[1], by[1], bx[2], by[2], &first_x);
  split |= !first_x;
  m = clip_stage(lb, m, la, bx[2], by[2], bx[3], by[3], &first_x);
  split |= !first_x;
  m = clip_stage(la, m, lb, bx[3], by[3], bx[0], by[0], &first_x);
  split |= !first_x;
  if (m == 0) {
    out[idx] = 0.0f;
    return;
  }

  // shoelace over lb[0 .. m-1]: terms v_i x v_{i+1}, the closing term
  // v_{m-1} x v_0 first when split, last otherwise
  const float2 v0 = lb[0];
  const float2 vl = lb[(m - 1) * kThreads];
  const float closing = vl.x * v0.y - vl.y * v0.x;
  float acc = split ? closing : 0.0f;
  float2 prev = v0;
  for (int i = 1; i < m; ++i) {
    const float2 cur = lb[i * kThreads];
    acc = acc + (prev.x * cur.y - prev.y * cur.x);
    prev = cur;
  }
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
