"""BEV and camera drawings for debugging (the counterpart of
`dcf.utils.viz`), rasterized with numpy and written as PNG by
`dcf_torch.data.png`: lidar points gray, gt boxes green, detections red
with alpha 0.3 + 0.7 * score. The geometry follows the JAX package's
drawings; their pixels (matplotlib, OpenCV) do not.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from dcf_torch.config import VoxelConfig
from dcf_torch.data.png import write_png
from dcf_torch.geometry import np_boxes

GT_RGB = (44, 160, 44)            # matplotlib's tab:green
DET_RGB = (214, 39, 40)           # tab:red
POINT_RGB = (153, 153, 153)       # gray 0.6
BOX_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
             (7, 4), (0, 4), (1, 5), (2, 6), (3, 7))


def _clip_segment(p: np.ndarray, q: np.ndarray, h: int, w: int):
    """The part of segment p-q ((row, col) floats) inside [0, h) x [0, w)
    (Liang-Barsky), or None."""
    t0, t1 = 0.0, 1.0
    d = q - p
    for k, hi in ((0, h - 1e-6), (1, w - 1e-6)):
        for num, den in ((p[k], -d[k]), (hi - p[k], d[k])):
            if den == 0:
                if num < 0:
                    return None
                continue
            t = num / den
            if den < 0:
                t0 = max(t0, t)
            else:
                t1 = min(t1, t)
    if t0 > t1:
        return None
    return p + t0 * d, p + t1 * d


def draw_line(img: np.ndarray, p, q, rgb: Sequence[int],
              alpha: float = 1.0) -> None:
    """Blend a one-pixel line from p to q ((row, col), in pixels; the
    pixel holding a point is its floor) into `img` [H, W, 3] uint8, in
    place; the part outside the image is clipped."""
    h, w = img.shape[:2]
    seg = _clip_segment(np.asarray(p, np.float64), np.asarray(q, np.float64),
                        h, w)
    if seg is None:
        return
    a, b = seg
    n = int(np.ceil(np.abs(b - a).max())) + 1
    t = np.linspace(0.0, 1.0, n)[:, None]
    rc = np.unique(np.floor(a + t * (b - a)).astype(np.int64), axis=0)
    rows = np.clip(rc[:, 0], 0, h - 1)
    cols = np.clip(rc[:, 1], 0, w - 1)
    old = img[rows, cols].astype(np.float64)
    new = (1.0 - alpha) * old + alpha * np.asarray(rgb, np.float64)
    img[rows, cols] = np.rint(new).astype(np.uint8)


def bev_pixels(xy: np.ndarray, vox: VoxelConfig,
               px_per_m: float) -> np.ndarray:
    """Lidar (x, y) -> BEV image (row, col): x forward is up (x_max on
    row 0), y left is to the left (y_max on column 0)."""
    xy = np.asarray(xy, np.float64)
    return np.stack([(vox.x_max - xy[..., 0]) * px_per_m,
                     (vox.y_max - xy[..., 1]) * px_per_m], axis=-1)


def draw_bev(path: Optional[str], points: np.ndarray, vox: VoxelConfig,
             gt_boxes: Optional[np.ndarray] = None,
             det_boxes: Optional[np.ndarray] = None,
             det_scores: Optional[np.ndarray] = None,
             px_per_m: float = 10.0) -> np.ndarray:
    """Bird's-eye view of the voxel range at `px_per_m` pixels a metre:
    the points inside the range, then the gt boxes (green) and the
    detections (red, alpha 0.3 + 0.7 * score) as closed outlines from
    `np_boxes.box_corners_bev`. Writes a PNG to `path` (when given) and
    returns the image, uint8 [H, W, 3] on a white ground."""
    h = int(round((vox.x_max - vox.x_min) * px_per_m))
    w = int(round((vox.y_max - vox.y_min) * px_per_m))
    img = np.full((h, w, 3), 255, np.uint8)
    pts = np.asarray(points)
    keep = ((pts[:, 0] >= vox.x_min) & (pts[:, 0] < vox.x_max)
            & (pts[:, 1] >= vox.y_min) & (pts[:, 1] < vox.y_max))
    rc = np.floor(bev_pixels(pts[keep, :2], vox, px_per_m)).astype(np.int64)
    img[np.clip(rc[:, 0], 0, h - 1), np.clip(rc[:, 1], 0, w - 1)] = POINT_RGB

    def outlines(boxes7, rgb, scores=None):
        if boxes7 is None or len(boxes7) == 0:
            return
        corners = np_boxes.box_corners_bev(
            np.asarray(boxes7)[:, [0, 1, 3, 4, 6]])
        for k, poly in enumerate(bev_pixels(corners, vox, px_per_m)):
            a = 1.0 if scores is None else 0.3 + 0.7 * float(scores[k])
            for i in range(4):
                draw_line(img, poly[i], poly[(i + 1) % 4], rgb, a)

    outlines(gt_boxes, GT_RGB)
    outlines(det_boxes, DET_RGB, det_scores)
    if path:
        write_png(path, img)
    return img


def draw_image_with_boxes(path: Optional[str], image: np.ndarray, boxes7,
                          calib, color: Sequence[int] = (255, 64, 64)
                          ) -> np.ndarray:
    """Project 3D boxes into the camera image (`calib.velo_to_image` of
    their 8 corners, `np_boxes.boxes3d_corners`) and draw the 12 edges of
    each; a box with a corner at depth <= 0.1 is skipped. Pixel
    coordinates are truncated to integers, as the JAX drawing does.
    Writes a PNG to `path` (when given) and returns the image."""
    img = np.array(image, np.uint8, copy=True)
    if boxes7 is not None and len(boxes7):
        for box in np_boxes.boxes3d_corners(np.asarray(boxes7)):
            uvz = calib.velo_to_image(box)
            if (uvz[:, 2] <= 0.1).any():
                continue
            uv = uvz[:, :2].astype(int)
            for a, b in BOX_EDGES:
                draw_line(img, (uv[a, 1], uv[a, 0]), (uv[b, 1], uv[b, 0]),
                          color)
    if path:
        write_png(path, img)
    return img
