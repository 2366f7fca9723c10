// The port's compiled host core: the hot host loops of a frame's path and
// of the evaluator, each the compiled twin of a numpy function that stays
// in the package as its plain version (named at each entry point).
//
// A plain C ABI, loaded with ctypes.CDLL (every call releases the GIL, so
// the loader's threads run in parallel). Built by dcf_torch/native/
// __init__.py with `g++ -O3 -ffp-contract=off -shared -fPIC`: no
// contraction of a multiply and an add, so every float32 expression
// rounds as the numpy version's separate IEEE operations do, and the
// results are bit-equal.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ROI crop + static-shape pad (plain: data/voxelize.py::crop_and_pad_plain).
// roi = [x_min, x_max, y_min, y_max, z_min, z_max].
// out: [max_points, 4] zero-padded; mask: [max_points] 0/1.
// Returns the number of points written (the kept count, capped).
int dcf_crop_pad(const float* pts, int64_t n, const double* roi,
                 int64_t max_points, int64_t stride_floats,
                 float* out, uint8_t* mask) {
  std::memset(out, 0, (size_t)max_points * 4 * sizeof(float));
  std::memset(mask, 0, (size_t)max_points);
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * stride_floats;
    if (p[0] >= roi[0] && p[0] < roi[1] && p[1] >= roi[2] && p[1] < roi[3] &&
        p[2] >= roi[4] && p[2] < roi[5]) {
      if (kept < max_points) {
        float* q = out + kept * 4;
        q[0] = p[0]; q[1] = p[1]; q[2] = p[2];
        q[3] = stride_floats > 3 ? p[3] : 0.f;
        mask[kept] = 1;
      }
      ++kept;
    }
  }
  return (int)std::min<int64_t>(kept, max_points);
}

namespace {

struct P2 { double x, y; };

inline double cross(const P2& o, const P2& a, const P2& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// corners of (x, y, dx, dy, yaw), CCW
inline void corners(const double* b, P2* c) {
  const double hx = b[2] * 0.5, hy = b[3] * 0.5;
  const double cs = std::cos(b[4]), sn = std::sin(b[4]);
  const double lx[4] = {hx, -hx, -hx, hx};
  const double ly[4] = {hy, hy, -hy, -hy};
  for (int k = 0; k < 4; ++k) {
    c[k].x = lx[k] * cs - ly[k] * sn + b[0];
    c[k].y = lx[k] * sn + ly[k] * cs + b[1];
  }
}

// Sutherland-Hodgman intersection area of two rotated rects.
double rect_intersection(const double* a, const double* b) {
  P2 ca[4], cb[4];
  corners(a, ca);
  corners(b, cb);
  P2 poly[16], next[16];
  int n = 4;
  for (int k = 0; k < 4; ++k) poly[k] = ca[k];
  for (int e = 0; e < 4 && n > 0; ++e) {
    const P2& p1 = cb[e];
    const P2& p2 = cb[(e + 1) & 3];
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const P2& cur = poly[i];
      const P2& prev = poly[(i + n - 1) % n];
      const double dc = cross(p1, p2, cur);
      const double dp = cross(p1, p2, prev);
      if ((dc >= 0) != (dp >= 0)) {
        const double t = dp / (dp - dc);
        next[m].x = prev.x + t * (cur.x - prev.x);
        next[m].y = prev.y + t * (cur.y - prev.y);
        ++m;
      }
      if (dc >= 0) next[m++] = cur;
    }
    n = m;
    for (int i = 0; i < n; ++i) poly[i] = next[i];
  }
  if (n < 3) return 0.0;
  double area2 = 0.0;
  for (int i = 0; i < n; ++i) {
    const P2& p = poly[i];
    const P2& q = poly[(i + 1) % n];
    area2 += p.x * q.y - p.y * q.x;
  }
  return std::fabs(area2) * 0.5;
}

}  // namespace

// Pairwise rotated BEV IoU: boxes [n,5] x [m,5] (x, y, dx, dy, yaw) ->
// [n,m] (plain: geometry/np_boxes.py::rotated_iou_bev, within 1e-9: its
// clipping differs in the order of its float64 operations).
void dcf_rotated_iou_bev(const double* boxes_a, int64_t n,
                         const double* boxes_b, int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const double* a = boxes_a + i * 5;
    const double area_a = a[2] * a[3];
    for (int64_t j = 0; j < m; ++j) {
      const double* b = boxes_b + j * 5;
      const double dx = a[0] - b[0], dy = a[1] - b[1];
      const double r = 0.5 * (std::hypot(a[2], a[3]) + std::hypot(b[2], b[3]));
      double iou = 0.0;
      if (dx * dx + dy * dy <= r * r) {
        const double inter = rect_intersection(a, b);
        const double uni = area_a + b[2] * b[3] - inter;
        iou = uni > 1e-9 ? inter / uni : 0.0;
      }
      out[i * m + j] = iou;
    }
  }
}

// Pairwise 3D IoU of box7s [n,7] x [m,7] -> [n,m] (plain:
// geometry/np_boxes.py::iou_3d, within 1e-9).
void dcf_iou_3d(const double* boxes_a, int64_t n,
                const double* boxes_b, int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const double* a = boxes_a + i * 7;
    const double bev_a[5] = {a[0], a[1], a[3], a[4], a[6]};
    const double vol_a = a[3] * a[4] * a[5];
    for (int64_t j = 0; j < m; ++j) {
      const double* b = boxes_b + j * 7;
      const double bev_b[5] = {b[0], b[1], b[3], b[4], b[6]};
      const double lo = std::max(a[2] - a[5] * 0.5, b[2] - b[5] * 0.5);
      const double hi = std::min(a[2] + a[5] * 0.5, b[2] + b[5] * 0.5);
      double iou = 0.0;
      if (hi > lo) {
        const double inter = rect_intersection(bev_a, bev_b) * (hi - lo);
        const double uni = vol_a + b[3] * b[4] * b[5] - inter;
        iou = uni > 1e-9 ? inter / uni : 0.0;
      }
      out[i * m + j] = iou;
    }
  }
}

// Points inside rotated 3D boxes (plain: geometry/np_boxes.py::
// points_in_boxes3d: the rotated rectangle of points_in_bev_boxes, then
// the z slab). xyz: [n, 3]; boxes: [m, 7] (x, y, z, dx, dy, dz, yaw); cs:
// [m, 2] each yaw's cos and sin as numpy computed them, so nothing here
// does trigonometry. out: [n, m] 0/1, or with any_box [n]: 1 where the
// point lies in any box. Each test is the plain version's float64
// expression in its order, so the answers are bit-equal.
//
// A square of half-side r around the box's centre, then the z slab, turn
// most pairs away before the rotation, and neither turns away a point the
// rotated test keeps. The slab is the plain version's own test. A point
// whose rotated coordinates pass lies within hypot(hx, hy) of the centre
// on either axis, give or take 20 * 2^-53 of it for the rounding of the
// four products and two sums; r is that half-diagonal widened by 1e-9
// relative and 1e-300 absolute (subnormals). A NaN fails both, as it
// fails the rotated test. On gt-sampling's calls (120,000 points, 19-26
// boxes) the square takes about a third off the loop's time.
void dcf_points_in_boxes3d(const double* xyz, int64_t n, const double* boxes,
                           const double* cs, int64_t m, int64_t any_box,
                           uint8_t* out) {
  struct Box { double x, y, c, s, hx, hy, zlo, zhi, r; };
  std::vector<Box> bx((size_t)m);
  for (int64_t j = 0; j < m; ++j) {
    const double* b = boxes + j * 7;
    Box& q = bx[(size_t)j];
    q.x = b[0];
    q.y = b[1];
    q.c = cs[j * 2];
    q.s = cs[j * 2 + 1];
    q.hx = b[3] * 0.5 + 0.0;
    q.hy = b[4] * 0.5 + 0.0;
    q.zlo = b[2] - b[5] * 0.5;
    q.zhi = b[2] + b[5] * 0.5;
    q.r = std::hypot(q.hx, q.hy) * (1.0 + 1e-9) + 1e-300;
  }
  for (int64_t i = 0; i < n; ++i) {
    const double px = xyz[i * 3], py = xyz[i * 3 + 1], pz = xyz[i * 3 + 2];
    uint8_t hit = 0;
    for (int64_t j = 0; j < m; ++j) {
      const Box& q = bx[(size_t)j];
      const double r0 = px - q.x, r1 = py - q.y;
      bool in = std::fabs(r0) <= q.r && std::fabs(r1) <= q.r &&
                pz >= q.zlo && pz <= q.zhi;
      if (in) {
        const double lx = r0 * q.c + r1 * q.s;
        const double ly = -r0 * q.s + r1 * q.c;
        in = std::fabs(lx) <= q.hx && std::fabs(ly) <= q.hy;
      }
      if (!any_box) {
        out[i * m + j] = in;
      } else if (in) {
        hit = 1;
        break;
      }
    }
    if (any_box) out[i] = hit;
  }
}

// The devkit's per-frame matching statistics at every score threshold
// (plain: eval/kitti_eval.py::_frame_statistics, once per threshold).
//
// overlaps:   [n_det, n_gt] row-major
// ignored_gt: 0 counted, 1 ignored, -1 irrelevant
// ignored_det: same codes (1 = below min 2D height)
// dc_overlap: [n_det, n_dc] criterion-0 overlaps vs DontCare (may be null)
// gt_alphas/dt_alphas: observation angles for AOS (may be null)
// outputs tp/fp/fn/sim: [n_thresh]
void dcf_eval_statistics(const double* overlaps, int64_t n_det, int64_t n_gt,
                         const double* dt_scores, const int32_t* ignored_gt,
                         const int32_t* ignored_det, const double* dc_overlap,
                         int64_t n_dc, double min_overlap,
                         const double* thresholds, int64_t n_thresh,
                         const double* gt_alphas, const double* dt_alphas,
                         int32_t* tp, int32_t* fp, int32_t* fn, double* sim) {
  std::vector<uint8_t> assigned(static_cast<size_t>(n_det));
  for (int64_t t = 0; t < n_thresh; ++t) {
    const double thresh = thresholds[t];
    std::fill(assigned.begin(), assigned.end(), 0);
    int32_t tp_t = 0, fn_t = 0;
    double sim_t = 0.0;
    for (int64_t i = 0; i < n_gt; ++i) {
      if (ignored_gt[i] == -1) continue;
      int64_t det_idx = -1;
      double max_overlap = 0.0;
      bool found = false, assigned_ignored = false;
      for (int64_t j = 0; j < n_det; ++j) {
        if (ignored_det[j] == -1 || assigned[j] || dt_scores[j] < thresh)
          continue;
        const double ov = overlaps[j * n_gt + i];
        if (ov <= min_overlap) continue;
        if (ignored_det[j] == 0 && (ov > max_overlap || assigned_ignored)) {
          max_overlap = ov;
          det_idx = j;
          found = true;
          assigned_ignored = false;
        } else if (ignored_det[j] == 1 && !found) {
          det_idx = j;
          found = true;
          assigned_ignored = true;
        }
      }
      if (!found && ignored_gt[i] == 0) {
        ++fn_t;
      } else if (found && (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
        assigned[det_idx] = 1;
      } else if (found) {
        ++tp_t;
        assigned[det_idx] = 1;
        if (gt_alphas && dt_alphas)
          sim_t += (1.0 + std::cos(gt_alphas[i] - dt_alphas[det_idx])) * 0.5;
      }
    }
    int32_t fp_t = 0;
    for (int64_t j = 0; j < n_det; ++j) {
      if (assigned[j] || ignored_det[j] != 0 || dt_scores[j] < thresh)
        continue;
      bool in_dc = false;
      for (int64_t k = 0; dc_overlap && k < n_dc; ++k) {
        if (dc_overlap[j * n_dc + k] > min_overlap) { in_dc = true; break; }
      }
      if (!in_dc) ++fp_t;
    }
    tp[t] = tp_t;
    fp[t] = fp_t;
    fn[t] = fn_t;
    sim[t] = sim_t;
  }
}

// Per-scale in-cell fusion ranks by arrival order (plain:
// data/preprocess.py::fusion_ranks_plain, a stable argsort per scale).
// Every float expression is the plain version's float32 one.
//
// pts: [P,4] f32 (host-sorted order), mask: [P] 0/1, uvz: [P,3] f32.
// strides: [S] BEV fusion strides. ranks out: [S,P] i32 (-1 invalid).
void dcf_fusion_ranks(const float* pts, const uint8_t* mask,
                      const float* uvz, int64_t P,
                      const int32_t* strides, int64_t S,
                      double x_min, double y_min, double voxel_size,
                      int64_t grid_x, int64_t grid_y,
                      int64_t img_h, int64_t img_w, int32_t* ranks) {
  std::vector<int32_t> cnt;
  for (int64_t si = 0; si < S; ++si) {
    const int64_t s = strides[si];
    const int64_t istride = std::min<int64_t>(2 * s, 32);
    const int64_t Hi = img_h / istride, Wi = img_w / istride;
    const int64_t H = grid_x / s, W = grid_y / s;
    const float cell = (float)(voxel_size * (double)s);
    const float xm = (float)x_min, ym = (float)y_min;
    const float fis = (float)istride;
    const float wlim = (float)(Wi - 1), hlim = (float)(Hi - 1);
    cnt.assign((size_t)(H * W), 0);
    int32_t* rk = ranks + si * P;
    for (int64_t i = 0; i < P; ++i) {
      rk[i] = -1;
      if (!mask[i]) continue;
      const float* q = uvz + i * 3;
      if (!(q[2] > 0.1f)) continue;                     // in front
      const float u = q[0] / fis, v = q[1] / fis;
      if (!(u >= 0.f && u <= wlim && v >= 0.f && v <= hlim)) continue;
      const float* p = pts + i * 4;
      const int64_t ix = (int64_t)std::floor((p[0] - xm) / cell);
      const int64_t iy = (int64_t)std::floor((p[1] - ym) / cell);
      if (ix < 0 || ix >= H || iy < 0 || iy >= W) continue;
      rk[i] = cnt[(size_t)(ix * W + iy)]++;             // arrival rank
    }
  }
}

// Perspective divide: uvw [P,3] (the numpy BLAS product + bias) -> uvz
// (u, v, depth), uv = uvw / max(|d|, 1e-6) * sign(d) (plain:
// data/preprocess.py::uvw_to_uvz_plain).
void dcf_uvw_to_uvz(const float* uvw, int64_t P, float* uvz) {
  for (int64_t i = 0; i < P; ++i) {
    const float* w = uvw + i * 3;
    const float d = w[2];
    const float den = std::max(std::fabs(d), 1e-6f);
    const float s = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
    float* o = uvz + i * 3;
    o[0] = w[0] / den * s;
    o[1] = w[1] / den * s;
    o[2] = d;
  }
}

// u8 -> f32 letterbox + space-to-depth(4) of an image already at its
// letterboxed size (plain: data/preprocess.py::prepare_image, then
// s2d_image). img: [h2, w2, 3] u8; out: [H/4, W/4, 48] f32 with
// out[i, j, (a*4+b)*3 + c] == img[4i+a, 4j+b, c] / 255 inside the
// letterbox, 0 elsewhere. u8/255.0f is one IEEE divide per byte value (a
// 256-entry table), as numpy's float32 divide computes it.
void dcf_image_s2d_u8(const uint8_t* img, int64_t h2, int64_t w2,
                      int64_t H, int64_t W, float* out) {
  float lut[256];
  for (int i = 0; i < 256; ++i) lut[i] = (float)i / 255.0f;
  const int64_t Ho = H / 4, Wo = W / 4;
  std::memset(out, 0, (size_t)(Ho * Wo * 48) * sizeof(float));
  const int64_t hc = std::min(h2, H), wc = std::min(w2, W);
  for (int64_t y = 0; y < hc; ++y) {
    const int64_t i = y / 4, a = y % 4;
    const uint8_t* p = img + y * w2 * 3;
    float* orow = out + (i * Wo) * 48 + a * 12;
    // whole 4-pixel groups: 12 contiguous floats per group
    const int64_t jfull = wc / 4;
    for (int64_t j = 0; j < jfull; ++j) {
      float* o = orow + j * 48;
      for (int k = 0; k < 12; ++k) o[k] = lut[p[k]];
      p += 12;
    }
    for (int64_t x = jfull * 4; x < wc; ++x) {
      float* o = orow + (x / 4) * 48 + (x % 4) * 3;
      o[0] = lut[p[0]]; o[1] = lut[p[1]]; o[2] = lut[p[2]];
      p += 3;
    }
  }
}

namespace {

constexpr float kCoefScale = 2048.0f;    // OpenCV's 11-bit resize weights

// Taps and 11-bit weights of the first n_take of n_out outputs of a
// half-pixel bilinear resize from n_in along one axis (plain:
// data/preprocess.py::_fixed_taps). The source coordinate is computed in
// double and rounded to float once; the fraction and the weights are
// float32, rounded half to even. Along x (clamp_frac) a tap below 0 or
// at/past the last pixel is clamped with a zero fraction; along y only the
// row indices are clamped.
void fixed_taps(int64_t n_out, int64_t n_in, int64_t n_take, bool clamp_frac,
                std::vector<int64_t>& i0, std::vector<int64_t>& i1,
                std::vector<int32_t>& w0, std::vector<int32_t>& w1) {
  i0.resize((size_t)n_take); i1.resize((size_t)n_take);
  w0.resize((size_t)n_take); w1.resize((size_t)n_take);
  const double scale = (double)n_in / (double)n_out;
  for (int64_t d = 0; d < n_take; ++d) {
    const float f = (float)(((double)d + 0.5) * scale - 0.5);
    const float s = std::floor(f);
    float frac = f - s;
    int64_t s0 = (int64_t)s, s1;
    if (clamp_frac) {
      if (s0 < 0) {
        s0 = 0; frac = 0.f;
      } else if (s0 >= n_in - 1) {
        s0 = n_in - 1; frac = 0.f;
      }
      s1 = std::min<int64_t>(s0 + 1, n_in - 1);
    } else {
      s1 = std::min<int64_t>(std::max<int64_t>(s0 + 1, 0), n_in - 1);
      s0 = std::min<int64_t>(std::max<int64_t>(s0, 0), n_in - 1);
    }
    i0[(size_t)d] = s0;
    i1[(size_t)d] = s1;
    w1[(size_t)d] = (int32_t)std::nearbyint(frac * kCoefScale);
    w0[(size_t)d] = (int32_t)std::nearbyint((1.0f - frac) * kCoefScale);
  }
}

}  // namespace

// Resize + normalize + letterbox + space-to-depth(4) in one pass from the
// uint8 image (plain: data/preprocess.py::resize_bilinear, then
// prepare_image's letterbox and s2d_image). img: [h, w, 3] u8, resized to
// [h2, w2] with OpenCV's uint8 INTER_LINEAR arithmetic: the horizontal
// pass in integers, S = a0 * p[x0] + a1 * p[x1]; the vertical pass
// (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2. Only the
// rows and columns inside the letterbox are computed. out as
// dcf_image_s2d_u8's; an image already at [h2, w2] goes there directly.
void dcf_image_resize_s2d_u8(const uint8_t* img, int64_t h, int64_t w,
                             int64_t h2, int64_t w2, int64_t H, int64_t W,
                             float* out) {
  if (h == h2 && w == w2) {
    dcf_image_s2d_u8(img, h2, w2, H, W, out);
    return;
  }
  float lut[256];
  for (int i = 0; i < 256; ++i) lut[i] = (float)i / 255.0f;
  const int64_t Ho = H / 4, Wo = W / 4;
  std::memset(out, 0, (size_t)(Ho * Wo * 48) * sizeof(float));
  const int64_t hc = std::min(h2, H), wc = std::min(w2, W);
  std::vector<int64_t> x0, x1, y0, y1;
  std::vector<int32_t> a0, a1, b0, b1;
  fixed_taps(w2, w, wc, true, x0, x1, a0, a1);
  fixed_taps(h2, h, hc, false, y0, y1, b0, b1);
  // the horizontal passes of two source rows; rows only move down, so an
  // output row reuses what the one above it computed
  std::vector<int32_t> rows[2] = {std::vector<int32_t>((size_t)(wc * 3)),
                                  std::vector<int32_t>((size_t)(wc * 3))};
  int64_t row_of[2] = {-1, -1};
  auto fill = [&](int k, int64_t sy) {
    const uint8_t* src = img + sy * w * 3;
    int32_t* dst = rows[k].data();
    for (int64_t x = 0; x < wc; ++x) {
      const uint8_t* p0 = src + x0[(size_t)x] * 3;
      const uint8_t* p1 = src + x1[(size_t)x] * 3;
      const int32_t c0 = a0[(size_t)x], c1 = a1[(size_t)x];
      for (int c = 0; c < 3; ++c) dst[x * 3 + c] = c0 * p0[c] + c1 * p1[c];
    }
    row_of[k] = sy;
  };
  auto slot = [&](int64_t sy) {
    return row_of[0] == sy ? 0 : (row_of[1] == sy ? 1 : -1);
  };
  for (int64_t y = 0; y < hc; ++y) {
    const int64_t r0 = y0[(size_t)y], r1 = y1[(size_t)y];
    int k0 = slot(r0), k1 = slot(r1);
    if (r0 == r1) {
      if (k0 < 0) fill(k0 = 0, r0);
      k1 = k0;
    } else {
      if (k0 < 0) fill(k0 = (k1 == 0 ? 1 : 0), r0);
      if (k1 < 0) fill(k1 = 1 - k0, r1);
    }
    const int32_t* s0 = rows[k0].data();
    const int32_t* s1 = rows[k1].data();
    const int32_t c0 = b0[(size_t)y], c1 = b1[(size_t)y];
    float* orow = out + ((y / 4) * Wo) * 48 + (y % 4) * 12;
    for (int64_t x = 0; x < wc; ++x) {
      float* o = orow + (x / 4) * 48 + (x % 4) * 3;
      for (int c = 0; c < 3; ++c) {
        const int64_t k = x * 3 + c;
        int32_t v = (((c0 * (s0[k] >> 4)) >> 16) +
                     ((c1 * (s1[k] >> 4)) >> 16) + 2) >> 2;
        v = std::min<int32_t>(std::max<int32_t>(v, 0), 255);
        o[c] = lut[v];
      }
    }
  }
}

// Fine-grid row-major stable counting sort of the padded cloud (plain:
// data/preprocess.py::sort_points_host_plain's stable argsort; a counting
// sort with an ascending placement pass is the same permutation). The key
// is the plain version's float32 formula.
void dcf_sort_points_fine(const float* pts, const uint8_t* mask, int64_t P,
                          double x_min, double y_min, double voxel_size,
                          int64_t fine, int64_t grid_x, int64_t grid_y,
                          float* out_pts, uint8_t* out_mask) {
  const int64_t Hf = grid_x / fine, Wf = grid_y / fine;
  const float cell = (float)(voxel_size * (double)fine);
  const float xm = (float)x_min, ym = (float)y_min;
  const int64_t K = Hf * Wf + 1;                        // +1: sentinel
  std::vector<int32_t> key((size_t)P);
  std::vector<int64_t> pos((size_t)K + 1, 0);
  for (int64_t i = 0; i < P; ++i) {
    const float* p = pts + i * 4;
    const int64_t ix = (int64_t)std::floor((p[0] - xm) / cell);
    const int64_t iy = (int64_t)std::floor((p[1] - ym) / cell);
    const bool inb = mask[i] && ix >= 0 && ix < Hf && iy >= 0 && iy < Wf;
    key[(size_t)i] = inb ? (int32_t)(ix * Wf + iy) : (int32_t)(Hf * Wf);
    ++pos[(size_t)key[(size_t)i] + 1];
  }
  for (int64_t k = 0; k < K; ++k) pos[(size_t)k + 1] += pos[(size_t)k];
  for (int64_t i = 0; i < P; ++i) {
    const int64_t o = pos[(size_t)key[(size_t)i]]++;
    std::memcpy(out_pts + o * 4, pts + i * 4, 4 * sizeof(float));
    out_mask[o] = mask[i];
  }
}

// Undo the PNG row filters (plain: data/png.py::_unfilter). raw: height
// rows of 1 + rowbytes bytes, each a filter byte (0 None, 1 Sub, 2 Up,
// 3 Average, 4 Paeth) and the filtered bytes; bpp: bytes per pixel (1-4
// for 8-bit samples); out: [height, rowbytes]. Bytes left of column 0 and
// above row 0 are zeros. Returns 0, or -1 at a filter byte above 4.
int dcf_png_unfilter(const uint8_t* raw, int64_t height, int64_t rowbytes,
                     int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* r = raw + y * (rowbytes + 1);
    const uint8_t ft = r[0];
    ++r;
    uint8_t* o = out + y * rowbytes;
    const uint8_t* up = y > 0 ? o - rowbytes : nullptr;
    const int64_t lead = std::min(bpp, rowbytes);    // bytes with a = 0
    switch (ft) {
      case 0:
        std::memcpy(o, r, (size_t)rowbytes);
        break;
      case 1:
        std::memcpy(o, r, (size_t)lead);
        for (int64_t x = lead; x < rowbytes; ++x)
          o[x] = (uint8_t)(r[x] + o[x - bpp]);
        break;
      case 2:
        if (up) {
          for (int64_t x = 0; x < rowbytes; ++x)
            o[x] = (uint8_t)(r[x] + up[x]);
        } else {
          std::memcpy(o, r, (size_t)rowbytes);
        }
        break;
      case 3:
        for (int64_t x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? o[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          o[x] = (uint8_t)(r[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? o[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          const int pa = std::abs(b - c);          // |p - a|, p = a + b - c
          const int pb = std::abs(a - c);          // |p - b|
          const int pc = std::abs(a + b - 2 * c);  // |p - c|
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[x] = (uint8_t)(r[x] + pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

}  // extern "C"
