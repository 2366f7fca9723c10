"""Detection losses, mirroring `dcf.train.losses`: focal loss on anchor
objectness, smooth-L1 on box residuals with the sin-difference angle
trick, and cross-entropy on the direction bin, all in float32 whatever
the backbone's compute dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from dcf_torch.config import LossConfig
from dcf_torch.train.targets import AnchorTargets


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float, gamma: float) -> torch.Tensor:
    """Elementwise focal loss on sigmoid logits."""
    p = torch.sigmoid(logits)
    ce = F.softplus(-logits) * targets + F.softplus(logits) * (1.0 - targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    focal = 1.0 - p_t
    if float(gamma) == int(gamma) and 1 <= int(gamma) <= 4:
        # an integer gamma is repeated products, as in the reference
        w = focal
        for _ in range(int(gamma) - 1):
            w = w * focal
    else:
        w = torch.pow(focal, gamma)
    return alpha_t * w * ce


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def add_sin_difference(reg_pred: torch.Tensor, reg_target: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace the angle pair (p, t) by (sin p cos t, cos p sin t), so the
    loss sees sin(p - t): yaw becomes pi-periodic (the direction
    classifier disambiguates). [..., 7] in and out."""
    sin_p = torch.sin(reg_pred[..., 6:7]) * torch.cos(reg_target[..., 6:7])
    sin_t = torch.cos(reg_pred[..., 6:7]) * torch.sin(reg_target[..., 6:7])
    return (torch.cat([reg_pred[..., :6], sin_p], dim=-1),
            torch.cat([reg_target[..., :6], sin_t], dim=-1))


def detection_loss_sums(flat_preds: Dict[str, torch.Tensor],
                        targets: AnchorTargets, cfg: LossConfig
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """UNNORMALIZED loss sums over a (micro-)batch: (weighted sum, {
    cls_sum, reg_sum, num_pos[, dir_sum]}). Normalizing by the batch's
    num_pos happens in `metrics_from_sums` (num_pos depends on no
    parameter, so gradient accumulation sums these and divides once)."""
    cls_logits = flat_preds["cls"].to(torch.float32)
    reg_pred = flat_preds["reg"].to(torch.float32)

    cls_elem = sigmoid_focal_loss(cls_logits, targets.cls_target,
                                  cfg.focal_alpha, cfg.focal_gamma)
    cls_sum = torch.sum(cls_elem * targets.cls_weight)

    pred_s, target_s = add_sin_difference(reg_pred, targets.reg_target)
    reg_elem = smooth_l1(pred_s, target_s, cfg.smooth_l1_beta)
    reg_sum = torch.sum(reg_elem.sum(-1) * targets.reg_weight)

    weighted = cfg.cls_weight * cls_sum + cfg.reg_weight * reg_sum
    sums = {"cls_sum": cls_sum, "reg_sum": reg_sum,
            "num_pos": torch.sum(targets.num_pos)}
    if "dir" in flat_preds:
        dir_logits = flat_preds["dir"].to(torch.float32)
        # 2-class cross-entropy in closed form: -log softmax_t(l0, l1)
        # = softplus((1 - 2t) (l1 - l0))
        d = dir_logits[..., 1] - dir_logits[..., 0]
        t = targets.dir_target.to(torch.float32)
        dir_sum = torch.sum(F.softplus((1.0 - 2.0 * t) * d)
                            * targets.reg_weight)
        weighted = weighted + cfg.dir_weight * dir_sum
        sums["dir_sum"] = dir_sum
    return weighted, sums


def metrics_from_sums(weighted: torch.Tensor, sums: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Normalize (accumulated) loss sums into (loss, metrics)."""
    num_pos = torch.clamp(sums["num_pos"], min=1.0)
    metrics = {"loss_cls": sums["cls_sum"] / num_pos,
               "loss_reg": sums["reg_sum"] / num_pos,
               "num_pos": sums["num_pos"]}
    if "dir_sum" in sums:
        metrics["loss_dir"] = sums["dir_sum"] / num_pos
    total = weighted / num_pos
    metrics["loss"] = total
    return total, metrics


def detection_loss(flat_preds: Dict[str, torch.Tensor],
                   targets: AnchorTargets, cfg: LossConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss over a batch, normalized by the batch's num_pos.

    Args:
      flat_preds: {"cls": [B, N], "reg": [B, N, 7], "dir": [B, N, 2]?}
        (`dcf_torch.models.head.flatten_predictions`).
      targets: batched AnchorTargets.
    """
    return metrics_from_sums(*detection_loss_sums(flat_preds, targets, cfg))
