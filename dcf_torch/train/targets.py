"""Anchor target assignment on the device, mirroring `dcf.train.targets`.

Matching rule (SECOND lineage, per-class thresholds):
  positive: IoU >= matched_threshold[anchor]    (same-class gt only)
  negative: IoU <  unmatched_threshold[anchor]
  ignored:  in between (zero loss weight)
  plus force matching: every valid gt claims its best-IoU anchor.

Anchors lie on a regular [Hd, Wd, A] grid, so a gt box can only overlap
anchors inside a fixed window around its centre: rotated IoUs are
computed only inside a [win, win, Ay] window per gt, restricted to the
gt's own class when every class has the same rotation count. The IoUs
of every window of the whole batch come from ONE call of
`dcf_torch.ops.clip.rotated_intersection_area_pairs` (the clip kernel
on the card). The windows merge into the anchor grid by scatter-max,
then scatter-min of the gt index among equal maxima: the first gt wins
ties, as in the reference. `assign_targets_dense` (every gt against
every anchor) is the parity reference.

Layout: the port keeps regression targets as [..., N, 7]; the JAX
package's channel-major [7, N] is a TPU layout choice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dcf_torch.geometry.boxes import encode_boxes
from dcf_torch.ops.clip import rotated_intersection_area_pairs


class AnchorTargets(NamedTuple):
    cls_target: torch.Tensor    # [B, N] f32 0/1 (positive objectness)
    cls_weight: torch.Tensor    # [B, N] f32 (0 for ignored anchors)
    reg_target: torch.Tensor    # [B, N, 7] encoded residuals (0 if not pos)
    reg_weight: torch.Tensor    # [B, N] f32, 1 for positives
    dir_target: torch.Tensor    # [B, N] int64 0/1 direction bin
    num_pos: torch.Tensor       # [B] f32


_BEV = [0, 1, 3, 4, 6]          # (x, y, dx, dy, yaw) of a box7


def _finalize(anchors, matched_thr, unmatched_thr, gt_boxes, best_iou,
              best_gt, gt_best_iou, gt_best_anchor, gt_mask
              ) -> AnchorTargets:
    """Thresholds, force matching and encoding, batched: anchors and
    thresholds [N(, 7)]; gt_* [B, G(, 7)]; best_* [B, N]; gt_best_*
    [B, G]."""
    B, G = gt_mask.shape
    N = anchors.shape[0]
    dev = anchors.device
    pos = best_iou >= matched_thr
    neg = best_iou < unmatched_thr

    # force matching: gt g claims anchor gt_best_anchor[g] if it found
    # any overlap; scatter-max, so an invalid gt never clobbers a valid
    # forced match (ties go to the highest gt index)
    force_ok = gt_mask & (gt_best_iou > 1e-4)
    forced_pos = torch.zeros((B, N), dtype=torch.int64, device=dev
                             ).scatter_reduce(
        1, gt_best_anchor, force_ok.to(torch.int64), "amax").bool()
    g_ids = torch.arange(G, device=dev).expand(B, G)
    forced_gt = torch.full((B, N), -1, dtype=torch.int64, device=dev
                           ).scatter_reduce(
        1, gt_best_anchor, torch.where(force_ok, g_ids, -1), "amax")
    best_gt = torch.where(forced_pos & (forced_gt >= 0), forced_gt, best_gt)
    pos = pos | forced_pos
    neg = neg & ~forced_pos

    matched = torch.gather(gt_boxes, 1, best_gt[..., None].expand(B, N, 7))
    reg_target = torch.where(pos[..., None],
                             encode_boxes(matched, anchors[None]), 0.0)
    reg_weight = pos.to(torch.float32)
    return AnchorTargets(
        cls_target=pos.to(torch.float32),
        cls_weight=(pos | neg).to(torch.float32),
        reg_target=reg_target, reg_weight=reg_weight,
        dir_target=(matched[..., 6] > 0).to(torch.int64),
        num_pos=reg_weight.sum(-1))


def _pair_iou(a_box7: torch.Tensor, g_box7: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU of box7 pairs [M, 7] x [M, 7] -> [M], the areas
    from one launch of the clip kernel (the plain clip on the CPU)."""
    a_bev = a_box7[:, _BEV].contiguous()
    g_bev = g_box7[:, _BEV].contiguous()
    inter = rotated_intersection_area_pairs(a_bev, g_bev)
    a_area = a_bev[:, 2] * a_bev[:, 3]
    g_area = g_bev[:, 2] * g_bev[:, 3]
    return inter / torch.clamp(a_area + g_area - inter, min=1e-9)


def assign_targets_dense(anchors: torch.Tensor, anchor_classes: torch.Tensor,
                         matched_thr: torch.Tensor,
                         unmatched_thr: torch.Tensor,
                         gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                         gt_mask: torch.Tensor) -> AnchorTargets:
    """Reference assignment, batched: every gt against every anchor.

    Args:
      anchors: [N, 7]; anchor_classes / matched_thr / unmatched_thr: [N].
      gt_boxes: [B, G, 7] padded; gt_labels: [B, G]; gt_mask: [B, G] bool.
    """
    B, G = gt_mask.shape
    N = anchors.shape[0]
    iou = _pair_iou(anchors[None, None].expand(B, G, N, 7).reshape(-1, 7),
                    gt_boxes[:, :, None].expand(B, G, N, 7).reshape(-1, 7))
    keep = gt_mask[..., None] & (anchor_classes == gt_labels[..., None])
    iou_all = torch.where(keep, iou.reshape(B, G, N), 0.0)       # [B, G, N]
    best_iou, best_gt = iou_all.max(dim=1)
    gt_best_iou, gt_best_anchor = iou_all.max(dim=2)
    # torch.max picks the first maximum, as argmax does in the reference
    return _finalize(anchors, matched_thr, unmatched_thr, gt_boxes,
                     best_iou, best_gt, gt_best_iou, gt_best_anchor,
                     gt_mask)


def assign_targets_batch(anchors: torch.Tensor, anchor_classes: torch.Tensor,
                         matched_thr: torch.Tensor,
                         unmatched_thr: torch.Tensor,
                         gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                         gt_mask: torch.Tensor,
                         grid_shape: Optional[Tuple[int, int, int]] = None,
                         grid_origin: Optional[Tuple[float, float]] = None,
                         grid_cell: Optional[float] = None,
                         window: int = 32,
                         per_class_anchors: Optional[int] = None
                         ) -> AnchorTargets:
    """Windowed target assignment over a batch of frames.

    Args:
      anchors: [N, 7] laid out as a [Hd, Wd, A] grid
        (`dcf_torch.models.anchors`); anchor_classes, thresholds: [N].
      gt_boxes [B, G, 7], gt_labels [B, G], gt_mask [B, G].
      grid_shape / grid_origin / grid_cell: the grid's geometry; without
        them, the dense reference runs.
      per_class_anchors: anchors per class (A // num_classes) when every
        class has the same rotation count: each window is then cut to its
        gt's own class.
    """
    if grid_shape is None:
        return assign_targets_dense(anchors, anchor_classes, matched_thr,
                                    unmatched_thr, gt_boxes, gt_labels,
                                    gt_mask)
    Hd, Wd, A = grid_shape
    B, G = gt_mask.shape
    N = anchors.shape[0]
    dev = anchors.device
    win = min(window, Hd, Wd)
    Ay = per_class_anchors if per_class_anchors is not None else A
    M = win * win * Ay
    labels = gt_labels.to(torch.int64)

    # window origins (cells), clipped so every window stays in the grid;
    # float32 arithmetic and truncation toward zero, as the reference
    oy = torch.clamp(((gt_boxes[..., 0] - grid_origin[0]) / grid_cell)
                     .to(torch.int32) - win // 2, 0, Hd - win).to(torch.int64)
    ox = torch.clamp(((gt_boxes[..., 1] - grid_origin[1]) / grid_cell)
                     .to(torch.int32) - win // 2, 0, Wd - win).to(torch.int64)
    if per_class_anchors is not None:
        cls_off = torch.clamp(labels * Ay, 0, A - Ay)
    else:
        cls_off = torch.zeros_like(labels)

    # flat anchor index of every window slot: [B, G, win, win, Ay]
    r = torch.arange(win, device=dev)
    a = torch.arange(Ay, device=dev)
    idx = (((oy[..., None, None, None] + r[:, None, None]) * Wd
            + (ox[..., None, None, None] + r[None, :, None])) * A
           + cls_off[..., None, None, None] + a).reshape(B, G, M)

    # every window of the batch through one clip call: B x G x M pairs
    iou = _pair_iou(anchors[idx.reshape(-1)],
                    gt_boxes[:, :, None].expand(B, G, M, 7).reshape(-1, 7))
    keep = gt_mask[..., None] & (anchor_classes[idx] == labels[..., None])
    iou_all = torch.where(keep, iou.reshape(B, G, M), 0.0)       # [B, G, M]

    # per-gt best anchor (force matching)
    gt_best_iou, flat = iou_all.max(dim=2)
    gt_best_anchor = torch.gather(idx, 2, flat[..., None])[..., 0]

    # merge the windows into the anchor grid: scatter-max the IoUs, read
    # each window's final best back, scatter-min the gt index among the
    # slots that reach it -- the first gt wins ties
    idx_b = idx.reshape(B, G * M)
    best_iou = torch.zeros((B, N), device=dev).scatter_reduce(
        1, idx_b, iou_all.reshape(B, G * M), "amax")
    best_w = torch.gather(best_iou, 1, idx_b).reshape(B, G, M)
    is_best = (iou_all >= best_w) & (iou_all > 0.0)
    g_ids = torch.arange(G, device=dev)[None, :, None].expand(B, G, M)
    best_gt = torch.full((B, N), G, dtype=torch.int64, device=dev
                         ).scatter_reduce(
        1, idx_b, torch.where(is_best, g_ids, G).reshape(B, G * M), "amin")
    best_gt = torch.where(best_gt < G, best_gt, 0)
    return _finalize(anchors, matched_thr, unmatched_thr, gt_boxes,
                     best_iou, best_gt, gt_best_iou, gt_best_anchor,
                     gt_mask)


def assign_targets(anchors, anchor_classes, matched_thr, unmatched_thr,
                   gt_boxes, gt_labels, gt_mask, **grid) -> AnchorTargets:
    """Single-frame assignment: gt_* without the batch dimension (same
    keyword arguments as `assign_targets_batch`)."""
    out = assign_targets_batch(anchors, anchor_classes, matched_thr,
                               unmatched_thr, gt_boxes[None],
                               gt_labels[None], gt_mask[None], **grid)
    return AnchorTargets(*(t[0] for t in out))
