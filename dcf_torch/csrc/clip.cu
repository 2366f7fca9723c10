// Intersection areas of rotated BEV rectangle pairs, hand-written for
// Hopper.
//
// Replaces the TPU kernel dcf/ops/pallas/clip_kernel.py::_clip_kernel
// (pallas_call in rotated_intersection_area_pairs). Contract:
//   boxes_a [N, 5], boxes_b [N, 5] f32 (x, y, dx, dy, yaw) -> out [N] f32,
// the area of a's rectangle clipped by the four edges of b's.
//
// One thread per pair. The arithmetic mirrors dcf/geometry/boxes.py
// (box_corners_bev, _clip_by_edge, _fill_forward, _polygon_area) op for
// op: sort-free Sutherland-Hodgman whose vertex buffer doubles
// 4 -> 8 -> 16 -> 32 -> 64 (every vertex emits its edge crossing and
// itself), dropped slots filled with their nearest valid predecessor
// (circularly; no valid slot at all fills with slot 0), an `alive` flag
// that zeroes pairs whose polygon ever empties, and the shoelace terms
// summed in vertex order as the TPU kernel sums them. The plain version
// (dcf_torch/geometry/boxes.py::rotated_intersection_area) does the same
// operations in the same order, and the library is built with
// --fmad=false, so the two agree bit for bit where cosf/sinf do.
//
// What bounds it on the card: bytes. A pair reads 40 bytes and writes 4:
// at the main path's 196,608 pairs that is ~9 MB (2.6 us at 3.35 TB/s).
// A clip that kept only live vertices (at most 8) would need ~200 f32
// operations per pair on random boxes (~0.6 us at 67 TFLOP/s outside the
// tensor cores), but this one clips through all 60 candidate vertices of
// the doubling (~1,200 operations, ~4 us): the price of matching the
// reference op for op. Design for that: every vertex buffer lives in
// registers (the stages are templates on the vertex count, so every index
// is a compile-time constant), the fill-forward is a sequential select
// rather than the TPU kernel's log-depth ladder (the same values, fewer
// selects), and the last stage is never stored: its 64 candidates stream
// straight into the shoelace sum, which keeps the live state under the
// register limit.

#include <cuda_runtime.h>

namespace {

// One clip of a V-vertex polygon by the half-plane left of p1 -> p2:
// writes the 2V filled candidates, returns whether any was valid.
template <int V>
__device__ __forceinline__ bool clip_stage(const float (&px)[V],
                                           const float (&py)[V],
                                           float (&qx)[2 * V],
                                           float (&qy)[2 * V], float p1x,
                                           float p1y, float p2x, float p2y) {
  const float ex = p2x - p1x;
  const float ey = p2y - p1y;
  float d[V];
#pragma unroll
  for (int v = 0; v < V; ++v) d[v] = ex * (py[v] - p1y) - ey * (px[v] - p1x);
  bool has[2 * V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int pv = (v + V - 1) % V;
    const bool cur_in = d[v] >= 0.0f;
    const bool prev_in = d[pv] >= 0.0f;
    const float denom = d[pv] - d[v];
    const float t = d[pv] / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
    qx[2 * v] = px[pv] + t * (px[v] - px[pv]);
    qy[2 * v] = py[pv] + t * (py[v] - py[pv]);
    has[2 * v] = cur_in != prev_in;
    qx[2 * v + 1] = px[v];
    qy[2 * v + 1] = py[v];
    has[2 * v + 1] = cur_in;
  }
  // fill-forward: the running value starts at the last valid candidate
  // (slot 0 if none), which is what the slots before the first valid
  // one take
  float lx = qx[0], ly = qy[0];
  bool any = false;
#pragma unroll
  for (int m = 0; m < 2 * V; ++m) {
    if (has[m]) {
      lx = qx[m];
      ly = qy[m];
      any = true;
    }
  }
#pragma unroll
  for (int m = 0; m < 2 * V; ++m) {
    if (has[m]) {
      lx = qx[m];
      ly = qy[m];
    }
    qx[m] = lx;
    qy[m] = ly;
  }
  return any;
}

// The last clip fused with the shoelace sum: the 2V filled candidates
// are produced in order and never stored.
template <int V>
__device__ __forceinline__ float clip_area(const float (&px)[V],
                                           const float (&py)[V], float p1x,
                                           float p1y, float p2x, float p2y,
                                           bool* any) {
  const float ex = p2x - p1x;
  const float ey = p2y - p1y;
  float d[V];
#pragma unroll
  for (int v = 0; v < V; ++v) d[v] = ex * (py[v] - p1y) - ey * (px[v] - p1x);

  // pass 1: the last valid candidate (slot 0 if none)
  float lx, ly;
  {
    const float denom = d[V - 1] - d[0];
    const float t = d[V - 1] / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
    lx = px[V - 1] + t * (px[0] - px[V - 1]);
    ly = py[V - 1] + t * (py[0] - py[V - 1]);
  }
  *any = false;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int pv = (v + V - 1) % V;
    const bool cur_in = d[v] >= 0.0f;
    const bool prev_in = d[pv] >= 0.0f;
    if (cur_in != prev_in) {
      const float denom = d[pv] - d[v];
      const float t = d[pv] / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
      lx = px[pv] + t * (px[v] - px[pv]);
      ly = py[pv] + t * (py[v] - py[pv]);
      *any = true;
    }
    if (cur_in) {
      lx = px[v];
      ly = py[v];
      *any = true;
    }
  }

  // pass 2: stream the filled candidates f_0 .. f_{2V-1} into the sum of
  // f_m x f_{m+1}, m = 0 .. 2V-1, with f_{2V} = f_0
  float cx = lx, cy = ly;  // running fill value
  float fx0 = 0.0f, fy0 = 0.0f, prevx = 0.0f, prevy = 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < 2 * V; ++m) {
    const int v = m >> 1;
    const int pv = (v + V - 1) % V;
    const bool cur_in = d[v] >= 0.0f;
    const bool prev_in = d[pv] >= 0.0f;
    if ((m & 1) == 0) {
      if (cur_in != prev_in) {
        const float denom = d[pv] - d[v];
        const float t = d[pv] / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
        cx = px[pv] + t * (px[v] - px[pv]);
        cy = py[pv] + t * (py[v] - py[pv]);
      }
    } else if (cur_in) {
      cx = px[v];
      cy = py[v];
    }
    if (m == 0) {
      fx0 = cx;
      fy0 = cy;
    } else {
      const float term = prevx * cy - prevy * cx;
      acc = (m == 1) ? term : acc + term;
    }
    prevx = cx;
    prevy = cy;
  }
  acc = acc + (prevx * fy0 - prevy * fx0);
  return 0.5f * fabsf(acc);
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

__global__ void __launch_bounds__(128)
clip_pairs_kernel(const float* __restrict__ boxes_a,
                  const float* __restrict__ boxes_b,
                  float* __restrict__ out, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float a[5], b[5];
#pragma unroll
  for (int f = 0; f < 5; ++f) {
    a[f] = boxes_a[idx * 5 + f];
    b[f] = boxes_b[idx * 5 + f];
  }
  float p4x[4], p4y[4], bx[4], by[4];
  corners(a, p4x, p4y);  // the polygon
  corners(b, bx, by);    // the clip edges b[k] -> b[k + 1]

  float p8x[8], p8y[8], p16x[16], p16y[16], p32x[32], p32y[32];
  bool alive = clip_stage<4>(p4x, p4y, p8x, p8y, bx[0], by[0], bx[1], by[1]);
  alive &= clip_stage<8>(p8x, p8y, p16x, p16y, bx[1], by[1], bx[2], by[2]);
  alive &= clip_stage<16>(p16x, p16y, p32x, p32y, bx[2], by[2], bx[3], by[3]);
  bool last;
  const float area = clip_area<32>(p32x, p32y, bx[3], by[3], bx[0], by[0],
                                   &last);
  out[idx] = (alive && last) ? area : 0.0f;
}

}  // namespace

extern "C" int dcf_clip_pairs(const void* boxes_a, const void* boxes_b,
                              void* out, int n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    clip_pairs_kernel<<<(n + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes_a), static_cast<const float*>(boxes_b),
        static_cast<float*>(out), n);
  }
  return (int)cudaGetLastError();
}
