"""Rotated-box helpers on the host (numpy) for training augmentation:
a copy of the parts of `dcf.geometry.np_boxes` that gt-sampling uses
(collision checks, points inside boxes), so augmentation draws and
decides exactly as the JAX package's does.
"""

from __future__ import annotations

import numpy as np


def box_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """[..., 5] (x, y, dx, dy, yaw) -> [..., 4, 2] CCW corners."""
    boxes = np.asarray(boxes, np.float64)
    x, y, dx, dy, yaw = np.moveaxis(boxes[..., :5], -1, 0)
    cx = np.stack([dx, -dx, -dx, dx], axis=-1) * 0.5
    cy = np.stack([dy, dy, -dy, -dy], axis=-1) * 0.5
    c, s = np.cos(yaw)[..., None], np.sin(yaw)[..., None]
    wx = cx * c - cy * s + x[..., None]
    wy = cx * s + cy * c + y[..., None]
    return np.stack([wx, wy], axis=-1)


def _clip_polygon(poly: np.ndarray, p1: np.ndarray, p2: np.ndarray):
    """Sutherland-Hodgman: clip `poly` (list of 2D pts) by half-plane left
    of p1->p2."""
    out = []
    n = len(poly)
    for i in range(n):
        cur, prev = poly[i], poly[i - 1]
        # 2-D cross product z-component (np.cross on 2-D vectors is
        # deprecated in numpy 2.0)
        e = p2 - p1
        a, b = cur - p1, prev - p1
        d_cur = e[0] * a[1] - e[1] * a[0]
        d_prev = e[0] * b[1] - e[1] * b[0]
        if (d_cur >= 0) != (d_prev >= 0):
            t = d_prev / (d_prev - d_cur)
            out.append(prev + t * (cur - prev))
        if d_cur >= 0:
            out.append(cur)
    return out


def _poly_area(poly) -> float:
    if len(poly) < 3:
        return 0.0
    pts = np.asarray(poly)
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def rotated_intersection_area(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Intersection area of two rotated BEV rects ([5] each)."""
    ca = box_corners_bev(np.asarray(box_a)[None])[0]
    cb = box_corners_bev(np.asarray(box_b)[None])[0]
    poly = list(ca)
    for k in range(4):
        poly = _clip_polygon(poly, cb[k], cb[(k + 1) % 4])
        if not poly:
            return 0.0
    return _poly_area(poly)


def boxes_collide_bev(boxes_a: np.ndarray, boxes_b: np.ndarray,
                      margin: float = 0.0) -> np.ndarray:
    """[N, 5] x [M, 5] -> [N, M] bool rotated-rect overlap test
    (gt-sampling collision check)."""
    boxes_a = np.asarray(boxes_a, np.float64).reshape(-1, 5).copy()
    boxes_b = np.asarray(boxes_b, np.float64).reshape(-1, 5).copy()
    boxes_a[:, 2:4] += margin
    boxes_b[:, 2:4] += margin
    out = np.zeros((len(boxes_a), len(boxes_b)), bool)
    for i, a in enumerate(boxes_a):
        for j, b in enumerate(boxes_b):
            # cheap reject by circumscribed circles first
            r = (np.hypot(a[2], a[3]) + np.hypot(b[2], b[3])) * 0.5
            if np.hypot(a[0] - b[0], a[1] - b[1]) > r:
                continue
            out[i, j] = rotated_intersection_area(a, b) > 1e-9
    return out


def points_in_bev_boxes(points: np.ndarray, boxes: np.ndarray,
                        margin: float = 0.0) -> np.ndarray:
    """[N, >=2] points x [M, 5] boxes -> [N, M] bool."""
    points = np.asarray(points, np.float64)
    boxes = np.asarray(boxes, np.float64).reshape(-1, 5)
    rel = points[:, None, :2] - boxes[None, :, :2]
    c = np.cos(boxes[:, 4])[None]
    s = np.sin(boxes[:, 4])[None]
    local_x = rel[..., 0] * c + rel[..., 1] * s
    local_y = -rel[..., 0] * s + rel[..., 1] * c
    return ((np.abs(local_x) <= boxes[None, :, 2] * 0.5 + margin)
            & (np.abs(local_y) <= boxes[None, :, 3] * 0.5 + margin))


def points_in_boxes3d(points: np.ndarray, boxes7: np.ndarray) -> np.ndarray:
    """[N, >=3] points x [M, 7] box7s -> [N, M] bool."""
    boxes7 = np.asarray(boxes7, np.float64).reshape(-1, 7)
    bev = points_in_bev_boxes(points, boxes7[:, [0, 1, 3, 4, 6]])
    z = np.asarray(points)[:, 2:3]
    z_ok = ((z >= boxes7[None, :, 2] - boxes7[None, :, 5] * 0.5)
            & (z <= boxes7[None, :, 2] + boxes7[None, :, 5] * 0.5))
    return bev & z_ok
