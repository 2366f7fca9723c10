"""Frame -> static-shape example (host).

Mirrors `dcf.data.preprocess`: pads/subsamples points, sorts them
fine-grid row-major, resizes and letterboxes the image to the configured
size (folding any resize scale into the projection matrix), projects the
points and ranks them in their fusion bins at every scale, and pads gt
boxes to a fixed capacity with a mask. The loops run in the compiled
host core (`dcf_torch.native`); each keeps a numpy plain version here
(`resize_bilinear` with `prepare_image` and `s2d_image`,
`sort_points_host_plain`, `fusion_host_arrays_plain`). Every float is
computed in float32 with the reference's formulas, and the resize with
OpenCV's fixed-point arithmetic, so the arrays are bit-equal to the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from dcf_torch import native
from dcf_torch.config import Config
from dcf_torch.data.synthetic import Frame
from dcf_torch.data.voxelize import crop_and_pad
from dcf_torch.utils import trace


def _linear_taps(n_out: int, n_in: int):
    """Source taps and float64 weights of a half-pixel bilinear resize
    along one axis (the float branch of `resize_bilinear`): a source
    coordinate below 0 or at/after the last pixel is clamped with a zero
    fraction."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0
    low = i0 < 0
    high = i0 >= n_in - 1
    frac[low | high] = 0.0
    i0[low] = 0
    i0[high] = n_in - 1
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, frac


def _fixed_taps(n_out: int, n_in: int, clamp_frac: bool):
    """Taps and 11-bit integer weights of OpenCV's uint8 INTER_LINEAR
    along one axis: the source coordinate in float64, rounded to float32
    once; the fraction and the weights rint(frac * 2048), rint((1 - frac)
    * 2048) in float32, rounded half to even. Along x (`clamp_frac`) a
    tap below 0 or at/past the last pixel is clamped with a zero
    fraction; along y only the row indices are clamped, so row 0 of an
    upscale blends rows (0, 0). Returns (i0, i1, w0, w1)."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out)
         - 0.5).astype(np.float32)
    s = np.floor(f)
    frac = f - s
    i0 = s.astype(np.int64)
    if clamp_frac:
        out = (i0 < 0) | (i0 >= n_in - 1)
        frac[out] = 0
        i0 = np.clip(i0, 0, n_in - 1)
        i1 = np.minimum(i0 + 1, n_in - 1)
    else:
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        i0 = np.clip(i0, 0, n_in - 1)
    scale = np.float32(2048)
    w1 = np.rint(frac * scale).astype(np.int32)
    w0 = np.rint((np.float32(1) - frac) * scale).astype(np.int32)
    return i0, i1, w0, w1


def resize_bilinear(image: np.ndarray, width: int, height: int
                    ) -> np.ndarray:
    """Bilinear resize of an [h, w, C] image to [height, width, C], the
    numpy counterpart of `cv2.resize(..., INTER_LINEAR)` (pixel centres
    aligned). A uint8 image is resized with OpenCV's fixed-point
    arithmetic, byte for byte: the horizontal pass in integers,
    S = a0 * p[x0] + a1 * p[x1], then the vertical pass
    (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2. This
    is the plain version of the compiled `native.image_resize_s2d`. A
    float image is resized in float64."""
    h, w = image.shape[:2]
    if image.dtype == np.uint8:
        x0, x1, a0, a1 = _fixed_taps(width, w, True)
        y0, y1, b0, b1 = _fixed_taps(height, h, False)
        src = image.astype(np.int32)
        rows = (src[:, x0] * a0[:, None] + src[:, x1] * a1[:, None])
        out = (((b0[:, None, None] * (rows[y0] >> 4)) >> 16)
               + ((b1[:, None, None] * (rows[y1] >> 4)) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    y0, y1, fy = _linear_taps(height, h)
    x0, x1, fx = _linear_taps(width, w)
    src = image.astype(np.float64)
    fx = fx[None, :, None]
    rows0 = src[y0][:, x0] * (1 - fx) + src[y0][:, x1] * fx
    rows1 = src[y1][:, x0] * (1 - fx) + src[y1][:, x1] * fx
    fy = fy[:, None, None]
    out = rows0 * (1 - fy) + rows1 * fy
    return out.astype(image.dtype)


def _fit_size(shape, cfg: Config):
    """The aspect-preserving size of an image of `shape` inside
    (cfg.image.height, cfg.image.width): (height, width, scale)."""
    H, W = cfg.image.height, cfg.image.width
    h, w = shape[:2]
    scale = min(H / h, W / w)
    if scale == 1.0:
        return h, w, scale
    return int(round(h * scale)), int(round(w * scale)), scale


def _resize_to_fit(image: np.ndarray, cfg: Config):
    """Aspect-preserving resize into (cfg.image.height, cfg.image.width);
    dtype-preserving. Returns (resized, scale)."""
    h2, w2, scale = _fit_size(image.shape, cfg)
    if scale != 1.0:
        image = resize_bilinear(image, w2, h2)
    return image, scale


def prepare_image(image: np.ndarray, cfg: Config):
    """Letterbox `image` into (cfg.image.height, cfg.image.width).

    Returns (image_f32 [H, W, 3] in [0,1], scale factor applied).
    """
    H, W = cfg.image.height, cfg.image.width
    image, scale = _resize_to_fit(image, cfg)
    h2, w2 = image.shape[:2]
    out = np.zeros((H, W, 3), np.float32)
    out[:min(h2, H), :min(w2, W)] = (
        image[:min(h2, H), :min(w2, W)].astype(np.float32) / 255.0)
    return out, scale


def s2d_image(image: np.ndarray) -> np.ndarray:
    """Space-to-depth(4): [H, W, C] -> [H/4, W/4, 16*C], channel
    (a*4 + b)*C + c == image[4i+a, 4j+b, c] (the patchify stem's
    layout)."""
    H, W, C = image.shape
    assert H % 4 == 0 and W % 4 == 0, (H, W)
    return (image.reshape(H // 4, 4, W // 4, 4, C)
            .transpose(0, 2, 1, 3, 4).reshape(H // 4, W // 4, 16 * C))


def prepare_image_s2d(image: np.ndarray, cfg: Config):
    """Resize, normalize, letterbox and space-to-depth(4) in one compiled
    pass from a uint8 [h, w, 3] image (`native.image_resize_s2d`),
    bit-equal to `s2d_image(prepare_image(image, cfg)[0])`, its plain
    version.

    Returns ([H/4, W/4, 48] f32, scale factor applied)."""
    h2, w2, scale = _fit_size(image.shape, cfg)
    return native.image_resize_s2d(image, h2, w2, cfg.image.height,
                                   cfg.image.width), scale


def sort_points_host(points: np.ndarray, mask: np.ndarray, cfg: Config
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Stable fine-grid row-major sort of the padded cloud, compiled
    (`native.sort_points_fine`, a counting sort); bit-equal to
    `sort_points_host_plain`."""
    vox = cfg.voxel
    return native.sort_points_fine(
        points, mask, vox.x_min, vox.y_min, vox.voxel_size,
        min(cfg.backbone.fusion_strides), vox.grid_x, vox.grid_y)


def sort_points_host_plain(points: np.ndarray, mask: np.ndarray,
                           cfg: Config) -> Tuple[np.ndarray, np.ndarray]:
    """Stable fine-grid row-major sort of the padded cloud (numpy).

    The key is computed in float32 ((x - x_min) / cell, then floor), as
    the reference computes it; invalid and out-of-grid points go last.
    """
    vox = cfg.voxel
    fine = min(cfg.backbone.fusion_strides)
    Hf, Wf = vox.grid_x // fine, vox.grid_y // fine
    cell = np.float32(vox.voxel_size * fine)
    pts = points.astype(np.float32, copy=False)
    ix = np.floor((pts[:, 0] - np.float32(vox.x_min)) / cell).astype(np.int32)
    iy = np.floor((pts[:, 1] - np.float32(vox.y_min)) / cell).astype(np.int32)
    inb = mask & (ix >= 0) & (ix < Hf) & (iy >= 0) & (iy < Wf)
    key = np.where(inb, ix * Wf + iy, Hf * Wf)
    order = np.argsort(key, kind="stable")
    return points[order], mask[order]


def image_stride_for(bev_stride: int) -> int:
    """BEV stride -> image pyramid stride (2 -> 4, 4 -> 8, 8 -> 16,
    16 -> 32, clamped to the coarsest level)."""
    return min(bev_stride * 2, 32)


def fusion_host_arrays(points: np.ndarray, mask: np.ndarray,
                       v2i: np.ndarray, cfg: Config) -> Dict[str, np.ndarray]:
    """The projection and the per-scale fusion binning ranks.

    Points must already be in their final (host-sorted) order: ranks
    index arrival order. The product with the projection matrix is
    numpy's float32 BLAS product, as in the reference; the perspective
    divide and the ranks are compiled (`native.uvw_to_uvz`,
    `native.fusion_ranks`), bit-equal to `fusion_host_arrays_plain`.

    Returns:
      {"points_uvz": [P, 3] f32 (u, v, depth),
       "fusion_rank": [S, P] int32, -1 where the point is invalid for
       that scale (padding / behind camera / outside that pyramid
       level's image / outside the BEV grid), else its rank among its
       cell's valid points}.
    """
    vox = cfg.voxel
    pts = points.astype(np.float32, copy=False)
    m = v2i.astype(np.float32)
    uvz = native.uvw_to_uvz(pts[:, :3] @ m[:, :3].T + m[:, 3])
    ranks = native.fusion_ranks(
        pts, mask, uvz, cfg.backbone.fusion_strides, vox.x_min, vox.y_min,
        vox.voxel_size, vox.grid_x, vox.grid_y, cfg.image.height,
        cfg.image.width)
    return {"points_uvz": uvz, "fusion_rank": ranks}


def fusion_host_arrays_plain(points: np.ndarray, mask: np.ndarray,
                             v2i: np.ndarray, cfg: Config
                             ) -> Dict[str, np.ndarray]:
    """`fusion_host_arrays` in numpy: every float32 expression with the
    reference's formulas, the ranks from a stable argsort per scale."""
    pts = points.astype(np.float32, copy=False)
    m = v2i.astype(np.float32)
    uvz = uvw_to_uvz_plain(pts[:, :3] @ m[:, :3].T + m[:, 3])
    return {"points_uvz": uvz,
            "fusion_rank": fusion_ranks_plain(pts, mask, uvz, cfg)}


def uvw_to_uvz_plain(uvw: np.ndarray) -> np.ndarray:
    """Perspective divide of `uvw [P, 3]` f32: (u, v, depth) with
    uv = uvw / max(|depth|, 1e-6) * sign(depth)."""
    depth = uvw[:, 2:3]
    uv = (uvw[:, :2] / np.maximum(np.abs(depth), np.float32(1e-6))
          * np.sign(depth))
    return np.concatenate([uv, depth], axis=-1).astype(np.float32)


def fusion_ranks_plain(pts: np.ndarray, mask: np.ndarray, uvz: np.ndarray,
                       cfg: Config) -> np.ndarray:
    """Per-scale in-cell ranks by arrival order, [S, P] int32 (-1 where
    invalid), from a stable argsort per scale."""
    vox = cfg.voxel
    in_front = uvz[:, 2] > 0.1
    P = len(pts)
    ranks = np.full((len(cfg.backbone.fusion_strides), P), -1, np.int32)
    for si, s in enumerate(cfg.backbone.fusion_strides):
        istride = image_stride_for(s)
        Hi = cfg.image.height // istride
        Wi = cfg.image.width // istride
        u = uvz[:, 0] / np.float32(istride)
        v = uvz[:, 1] / np.float32(istride)
        inside = (u >= 0) & (u <= Wi - 1) & (v >= 0) & (v <= Hi - 1)
        H, W = vox.grid_x // s, vox.grid_y // s
        cell = np.float32(vox.voxel_size * s)
        ix = np.floor((pts[:, 0] - np.float32(vox.x_min))
                      / cell).astype(np.int64)
        iy = np.floor((pts[:, 1] - np.float32(vox.y_min))
                      / cell).astype(np.int64)
        ok = (mask & in_front & inside
              & (ix >= 0) & (ix < H) & (iy >= 0) & (iy < W))
        cid = np.where(ok, ix * W + iy, H * W)
        order = np.argsort(cid, kind="stable")   # keeps arrival order
        sc = cid[order]
        start = np.r_[True, sc[1:] != sc[:-1]]
        run_start = np.maximum.accumulate(
            np.where(start, np.arange(P), 0))
        rank_sorted = np.arange(P) - run_start
        valid_sorted = ok[order]
        ranks[si, order[valid_sorted]] = rank_sorted[valid_sorted]
    return ranks


def frame_to_example(frame: Frame, cfg: Config, seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """Build the static-shape example dict the detector consumes."""
    with trace.span("preprocess", frame=frame.frame_id):
        return _frame_to_example(frame, cfg, seed)


def _frame_to_example(frame: Frame, cfg: Config, seed: int
                      ) -> Dict[str, np.ndarray]:
    with trace.span("preprocess.crop"):
        points, mask = crop_and_pad(frame.points, cfg.voxel, seed=seed)
    if cfg.with_fusion:
        with trace.span("preprocess.sort"):
            points, mask = sort_points_host(points, mask, cfg)
    with trace.span("preprocess.image"):
        if cfg.with_camera:           # [H/4, W/4, 48], the stem's layout
            image, scale = prepare_image_s2d(frame.image, cfg)
        else:
            image, scale = prepare_image(frame.image, cfg)
    v2i = frame.calib.velo_to_image_matrix.copy()
    v2i[:2] *= scale                     # resize folded into projection

    mb = cfg.augment.max_boxes
    gt_boxes = np.zeros((mb, 7), np.float32)
    gt_labels = np.zeros((mb,), np.int32)
    gt_mask = np.zeros((mb,), bool)
    n = min(len(frame.boxes), mb)
    if n:
        gt_boxes[:n] = frame.boxes[:n]
        gt_labels[:n] = frame.labels[:n]
        gt_mask[:n] = True

    out = {
        "points": points,
        "point_mask": mask,
        "image": image,
        "velo_to_image": v2i.astype(np.float32),
        "gt_boxes": gt_boxes,
        "gt_labels": gt_labels,
        "gt_mask": gt_mask,
    }
    if cfg.with_fusion:
        with trace.span("preprocess.fusion_arrays"):
            out.update(fusion_host_arrays(points, mask,
                                          out["velo_to_image"], cfg))
    return out


def stack_examples(examples) -> Dict[str, np.ndarray]:
    """Collate a list of example dicts into a batched dict."""
    with trace.span("preprocess.stack"):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
