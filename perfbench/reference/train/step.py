"""The training step in plain float32 PyTorch: forward, target
assignment, losses, backward, clip + AdamW.

The batch runs one example at a time (GroupNorm normalizes per example,
so nothing couples the examples but the loss's division by the batch's
num_pos): the gradients of the UNNORMALIZED loss sums are accumulated
over the examples and divided once by the batch's num_pos, which is the
whole batch's gradient, with one example's activations in memory.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench.reference.config import Config
from perfbench.reference.models.anchors import anchor_grid_shape
from perfbench.reference.models.detector import ContFuseDetector
from perfbench.reference.models.head import flatten_predictions
from perfbench.reference.train.losses import (detection_loss_sums,
                                              metrics_from_sums)
from perfbench.reference.train.state import AdamW
from perfbench.reference.train.targets import assign_targets_batch

Batch = Dict[str, torch.Tensor]


def loss_sums(cfg: Config, model: ContFuseDetector, batch: Batch,
              pack: Batch) -> Tuple[torch.Tensor, Dict]:
    """(weighted loss sum, sums) of `model` on a batch of device tensors;
    `pack` is `models.anchors.anchor_pack(cfg, device)`."""
    rot_counts = {len(a.rotations) for a in cfg.anchors}
    per_class = rot_counts.pop() if len(rot_counts) == 1 else None
    flat = flatten_predictions(model(batch), cfg)
    with torch.no_grad():
        targets = assign_targets_batch(
            pack["boxes"], pack["classes"], pack["matched_thr"],
            pack["unmatched_thr"], batch["gt_boxes"], batch["gt_labels"],
            batch["gt_mask"], grid_shape=anchor_grid_shape(cfg),
            grid_origin=(cfg.voxel.x_min, cfg.voxel.y_min),
            grid_cell=cfg.voxel.voxel_size * cfg.backbone.head_stride,
            window=cfg.train.assigner_window, per_class_anchors=per_class)
    return detection_loss_sums(flat, targets, cfg.loss)


def train_step(cfg: Config, model: ContFuseDetector, opt: AdamW,
               examples: List[Batch], pack: Batch
               ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """One step over `examples` (each a batch of one): returns the raw
    gradients (one per parameter, before clipping) and the metrics; the
    parameters are updated in place."""
    model.train()
    params = list(model.parameters())
    for p in params:
        p.grad = None
    weighted, sums = 0.0, None
    for ex in examples:
        w, s = loss_sums(cfg, model, ex, pack)
        w.backward()
        weighted = weighted + w.detach()
        sums = ({k: v.detach() for k, v in s.items()} if sums is None
                else {k: sums[k] + s[k].detach() for k in sums})
    g = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    torch._foreach_div_(g, torch.clamp(sums["num_pos"], min=1.0))
    _, metrics = metrics_from_sums(weighted, sums)
    opt.step(g)
    return g, metrics
