"""Rotated-BEV box math in torch, mirroring `dcf.geometry.boxes`.

Box convention (lidar frame, x forward / y left / z up):

    box7 = (x, y, z, dx, dy, dz, yaw)

with (x, y, z) the geometric centre, dx the extent along the heading,
dy across it, dz vertical, and yaw CCW around +z.

`rotated_intersection_area` is the plain version of the clip kernel
(`dcf_torch.ops.clip`): a sort-free Sutherland-Hodgman clip whose vertex
buffer doubles 4 -> 8 -> 16 -> 32 -> 64, with dropped slots filled by
their nearest valid predecessor. It repeats the reference op for op and
sums the shoelace terms in vertex order, as the TPU kernel does, so the
CUDA kernel can be held to it tightly.
"""

from __future__ import annotations

import torch


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, dx, dy, yaw) -> [..., 4, 2] corners, CCW."""
    x, y, dx, dy, yaw = boxes[..., :5].unbind(-1)
    cx = torch.stack([dx, -dx, -dx, dx], dim=-1) * 0.5
    cy = torch.stack([dy, dy, -dy, -dy], dim=-1) * 0.5
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    wx = cx * c - cy * s + x[..., None]
    wy = cx * s + cy * c + y[..., None]
    return torch.stack([wx, wy], dim=-1)


def _cross2(o: torch.Tensor, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """2D cross product (a - o) x (b - o); [..., 2] inputs -> [...]."""
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _fill_forward(cand: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Replace each invalid vertex by its nearest valid predecessor,
    circularly: slots before the first valid one take the last valid
    vertex, and with no valid vertex every slot takes slot 0.
    [..., V, 2], [..., V] -> [..., V, 2]. Pure selection, so the values
    are exactly the reference's."""
    V = valid.shape[-1]
    slot = torch.arange(V, device=valid.device).expand(valid.shape)
    last_at = torch.cummax(torch.where(valid, slot, -1), dim=-1).values
    last = last_at[..., -1:].clamp(min=0)
    src = torch.where(last_at >= 0, last_at, last)
    return torch.gather(cand, -2, src[..., None].expand(cand.shape))


def _clip_by_edge(poly: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Clip convex polygons by the half-plane left of edge p1 -> p2.

    Every input vertex emits two candidates (crossing point, kept
    vertex); the buffer doubles instead of compacting. Returns
    (poly[..., 2V, 2], nonempty[...]).
    """
    prev = torch.roll(poly, 1, dims=-2)
    p1e = p1[..., None, :]
    p2e = p2[..., None, :]
    d_cur = _cross2(p1e, p2e, poly)
    d_prev = _cross2(p1e, p2e, prev)
    cur_in = d_cur >= 0.0
    prev_in = d_prev >= 0.0

    denom = d_prev - d_cur
    t = d_prev / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    inter = prev + t[..., None] * (poly - prev)

    cand = torch.stack([inter, poly], dim=-2)
    cand_valid = torch.stack([cur_in != prev_in, cur_in], dim=-1)
    V = poly.shape[-2]
    cand = cand.reshape(cand.shape[:-3] + (2 * V, 2))
    cand_valid = cand_valid.reshape(cand_valid.shape[:-2] + (2 * V,))
    return _fill_forward(cand, cand_valid), cand_valid.any(dim=-1)


def _polygon_area(poly: torch.Tensor) -> torch.Tensor:
    """Shoelace area, terms summed in vertex order. [..., V, 2] -> [...]."""
    nxt = torch.roll(poly, -1, dims=-2)
    cross = poly[..., 0] * nxt[..., 1] - poly[..., 1] * nxt[..., 0]
    acc = cross[..., 0]
    for v in range(1, cross.shape[-1]):
        acc = acc + cross[..., v]
    return 0.5 * acc.abs()


def rotated_intersection_area(boxes_a: torch.Tensor,
                              boxes_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of rotated BEV rectangles, elementwise.

    Args:
      boxes_a, boxes_b: [..., 5] (x, y, dx, dy, yaw), broadcastable; the
        polygon of `a` is clipped by the edges of `b`.

    Returns:
      [...] float32 areas.
    """
    ca = box_corners_bev(boxes_a)
    cb = box_corners_bev(boxes_b)
    batch = torch.broadcast_shapes(ca.shape[:-2], cb.shape[:-2])
    poly = ca.expand(batch + (4, 2))
    cb = cb.expand(batch + (4, 2))
    alive = torch.ones(batch, dtype=torch.bool, device=poly.device)
    for k in range(4):
        poly, nonempty = _clip_by_edge(poly, cb[..., k, :],
                                       cb[..., (k + 1) % 4, :])
        alive = alive & nonempty
    return torch.where(alive, _polygon_area(poly), 0.0)


def rotated_iou_bev(boxes_a: torch.Tensor,
                    boxes_b: torch.Tensor) -> torch.Tensor:
    """[N, 5] x [M, 5] -> [N, M] rotated BEV IoU (plain clip)."""
    inter = rotated_intersection_area(boxes_a[:, None, :],
                                      boxes_b[None, :, :])
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor
                 ) -> torch.Tensor:
    """SECOND-style residuals: [..., 7] deltas + anchors -> box7s."""
    xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
    xt, yt, zt, dxt, dyt, dzt, rt = deltas.unbind(-1)
    diag = torch.sqrt(dxa * dxa + dya * dya)
    return torch.stack([xt * diag + xa, yt * diag + ya, zt * dza + za,
                        torch.exp(dxt) * dxa, torch.exp(dyt) * dya,
                        torch.exp(dzt) * dza, rt + ra], dim=-1)


def encode_boxes(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """SECOND-style residuals of gt box7s against anchor box7s, the
    inverse of `decode_boxes`: [..., 7] x [..., 7] -> [..., 7]. The same
    arithmetic as `dcf.geometry.boxes.encode_boxes_cm`, in the [N, 7]
    layout; the angle is the raw difference (the loss applies the
    sin-difference)."""
    xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
    xg, yg, zg, dxg, dyg, dzg, rg = gt.unbind(-1)
    diag = torch.sqrt(dxa * dxa + dya * dya)
    return torch.stack([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                        torch.log(dxg / dxa), torch.log(dyg / dya),
                        torch.log(dzg / dza), rg - ra], dim=-1)
