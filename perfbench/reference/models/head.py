"""Detection head, anchor decode and post-processing, mirroring
`dcf.models.head`.

Head: a conv stack over the FPN map emitting, per anchor, one class
logit, 7 box residuals and 2 direction logits. Post-processing: sigmoid
scores -> per-class exact top-k -> box decode and direction fix-up ->
rotated NMS over one IoU matrix per class -> fixed-size (padded + mask)
detection lists. On CUDA, all classes' k x k intersection areas come
from ONE launch of the clip kernel.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.config import Config
from perfbench.reference.geometry.boxes import decode_boxes
from perfbench.reference.models.layers import ConvNorm
from perfbench.reference.ops.clip import rotated_intersection_area_pairs
from perfbench.reference.ops.nms import rotated_nms_parallel, top_k


class DetectionHead(nn.Module):
    """Conv head over the FPN feature map (NHWC in, NHWC maps out)."""

    def __init__(self, cfg: Config, in_channels: int):
        super().__init__()
        self.cfg = cfg
        A = cfg.anchors_per_loc
        c = cfg.head.head_channels
        for i in range(cfg.head.num_convs):
            self.add_module(f"ConvNorm_{i}",
                            ConvNorm(in_channels if i == 0 else c, c, 3, 1,
                                     quant=cfg.backbone.quant_mode))
        cin = c if cfg.head.num_convs else in_channels
        self.cls = nn.Conv2d(cin, A, 1)
        self.reg = nn.Conv2d(cin, A * 7, 1)
        self.dir = (nn.Conv2d(cin, A * 2, 1)
                    if cfg.head.use_direction_classifier else None)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        for i in range(self.cfg.head.num_convs):
            x = getattr(self, f"ConvNorm_{i}")(x)
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        out = {"cls": self.cls(x), "reg": self.reg(x)}
        if self.dir is not None:
            out["dir"] = self.dir(x)
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)   # cls bias init: p = 0.01


def flatten_predictions(preds: Dict[str, torch.Tensor], cfg: Config
                        ) -> Dict[str, torch.Tensor]:
    """[B, H, W, A * k] maps -> [B, N, k] in the anchor layout
    (location-major, then per-location anchor)."""
    B = preds["cls"].shape[0]
    out = {"cls": preds["cls"].reshape(B, -1),
           "reg": preds["reg"].reshape(B, -1, 7)}
    if "dir" in preds:
        out["dir"] = preds["dir"].reshape(B, -1, 2)
    return out


def decode_and_nms(flat: Dict[str, torch.Tensor], anchors: torch.Tensor,
                   anchor_classes: torch.Tensor, cfg: Config
                   ) -> Dict[str, torch.Tensor]:
    """Batched decode + per-class rotated NMS.

    Args:
      flat: {"cls": [B, N], "reg": [B, N, 7], "dir": [B, N, 2]?}.
      anchors: [N, 7]; anchor_classes: [N] int.

    Returns:
      {"boxes": [B, D, 7], "scores": [B, D], "classes": [B, D] int32,
       "valid": [B, D] bool} with D = cfg.head.max_detections.
    """
    B, N = flat["cls"].shape
    C = cfg.num_classes
    k = min(cfg.head.pre_nms_top_k, N)
    D = cfg.head.nms_max_per_class
    dev = flat["cls"].device

    scores = torch.sigmoid(flat["cls"].to(torch.float32))           # [B, N]
    class_ids = torch.arange(C, device=dev)
    own = anchor_classes[None, :] == class_ids[:, None]              # [C, N]
    cls_scores = torch.where(own[None], scores[:, None, :], 0.0)     # [B,C,N]
    top_scores, top_idx = top_k(cls_scores, k)                       # [B,C,k]

    bi = torch.arange(B, device=dev)[:, None, None]
    top_boxes = decode_boxes(flat["reg"][bi, top_idx].to(torch.float32),
                             anchors[top_idx])                       # [B,C,k,7]
    if "dir" in flat:
        dir_label = torch.argmax(flat["dir"][bi, top_idx], dim=-1)
        yaw = top_boxes[..., 6]
        opp = (yaw > 0) != (dir_label == 1)
        yaw = torch.where(opp, yaw + math.pi, yaw)
        yaw = torch.remainder(yaw + math.pi, 2 * math.pi) - math.pi
        top_boxes = torch.cat([top_boxes[..., :6], yaw[..., None]], dim=-1)
    valid = top_scores > cfg.head.score_threshold

    bev = top_boxes[..., [0, 1, 3, 4, 6]]                            # [B,C,k,5]
    aa = bev[:, :, :, None, :].expand(B, C, k, k, 5).reshape(-1, 5)
    bb = bev[:, :, None, :, :].expand(B, C, k, k, 5).reshape(-1, 5)
    inter = rotated_intersection_area_pairs(
        aa.contiguous(), bb.contiguous()).reshape(B, C, k, k)
    area = bev[..., 2] * bev[..., 3]
    iou = inter / torch.clamp(area[..., :, None] + area[..., None, :] - inter,
                              min=1e-9)
    keep_idx, keep_mask = rotated_nms_parallel(
        iou, top_scores, valid, cfg.head.nms_iou_threshold, D)     # [B, C, D]

    boxes_cat = torch.gather(
        top_boxes, 2, keep_idx[..., None].expand(B, C, D, 7)).reshape(B, C * D, 7)
    scores_cat = torch.gather(top_scores, 2, keep_idx).reshape(B, C * D)
    cls_cat = class_ids.to(torch.int32).repeat_interleave(D)[None].expand(B, -1)
    valid_cat = keep_mask.reshape(B, C * D)
    final_scores, idx = top_k(
        torch.where(valid_cat, scores_cat, -torch.inf), cfg.head.max_detections)
    sel_valid = torch.gather(valid_cat, 1, idx)
    return {"boxes": torch.gather(boxes_cat, 1,
                                  idx[..., None].expand(*idx.shape, 7)),
            "scores": torch.where(sel_valid, final_scores, 0.0),
            "classes": torch.gather(cls_cat, 1, idx),
            "valid": sel_valid}
