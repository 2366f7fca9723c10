"""The training step, mirroring `dcf.train.step.make_train_step`: forward,
target assignment, losses, backward (through the fusion kernels on the
card), clip + AdamW, EMA.

`cfg.train.accum_steps > 1` splits the batch into that many micro-batches
and accumulates the gradients of the UNNORMALIZED loss sums, then divides
once by the whole batch's num_pos: the full-batch gradient exactly, since
num_pos depends on no parameter, with one micro-batch's activations in
memory at a time.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from dcf_torch.config import Config
from dcf_torch.device import resolve_device
from dcf_torch.models.anchors import anchor_grid_shape
from dcf_torch.models.detector import ContFuseDetector
from dcf_torch.models.head import flatten_predictions
from dcf_torch.train.losses import detection_loss_sums, metrics_from_sums
from dcf_torch.train.state import TrainState, global_norm
from dcf_torch.train.targets import assign_targets_batch

Batch = Dict[str, torch.Tensor]


def build_loss_sums_fn(cfg: Config, model: ContFuseDetector
                       ) -> Callable[[Batch, Batch], Tuple[torch.Tensor,
                                                           Dict]]:
    """Returns sums_fn(batch, pack) -> (weighted loss sum, sums), the
    unnormalized loss of `model` on a batch of device tensors; `pack` is
    `dcf_torch.models.anchors.anchor_pack(cfg, device)`."""
    grid_shape = anchor_grid_shape(cfg)
    grid_origin = (cfg.voxel.x_min, cfg.voxel.y_min)
    grid_cell = cfg.voxel.voxel_size * cfg.backbone.head_stride
    # class-restricted assigner windows need equal per-class rotation
    # counts (the anchor axis is class-major)
    rot_counts = {len(a.rotations) for a in cfg.anchors}
    per_class = rot_counts.pop() if len(rot_counts) == 1 else None

    def sums_fn(batch: Batch, pack: Batch):
        flat = flatten_predictions(model(batch), cfg)
        with torch.no_grad():
            targets = assign_targets_batch(
                pack["boxes"], pack["classes"], pack["matched_thr"],
                pack["unmatched_thr"], batch["gt_boxes"],
                batch["gt_labels"], batch["gt_mask"],
                grid_shape=grid_shape, grid_origin=grid_origin,
                grid_cell=grid_cell, window=cfg.train.assigner_window,
                per_class_anchors=per_class)
        return detection_loss_sums(flat, targets, cfg.loss)

    return sums_fn


def make_train_step(cfg: Config, model: ContFuseDetector, device
                    ) -> Callable[[TrainState, Batch, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns train_step(state, batch, pack) -> (state, metrics).

    `batch` holds device tensors (`dcf_torch.eval.inference.
    batch_to_device`), `pack` the anchor tensors; `state.model` must be
    `model`, on `device`. The state is updated in place and returned.
    Metrics are device scalars: loss, loss_cls, loss_reg, loss_dir,
    num_pos and grad_norm (of the raw grads, before clipping).
    """
    device = resolve_device(device)
    if any(p.device.type != device.type for p in model.parameters()):
        raise ValueError(f"make_train_step: the model is not on {device}")
    sums_fn = build_loss_sums_fn(cfg, model)
    accum = cfg.train.accum_steps
    decay = cfg.train.ema_decay
    params = list(model.parameters())

    def grads_of(loss: torch.Tensor, first: bool) -> None:
        if first:
            for p in params:
                p.grad = None
        loss.backward()

    def grads() -> list:
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in params]

    def train_step(state: TrainState, batch: Batch, pack: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        if accum == 1:
            loss, metrics = metrics_from_sums(*sums_fn(batch, pack))
            grads_of(loss, True)
            g = grads()
        else:
            B = batch["points"].shape[0]
            if B % accum:
                raise ValueError(f"batch {B} not divisible by accum_steps "
                                 f"{accum}")
            m = B // accum
            weighted, sums = 0.0, None
            for i in range(accum):
                micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                w, s = sums_fn(micro, pack)
                grads_of(w, i == 0)
                weighted = weighted + w.detach()
                sums = ({k: v.detach() for k, v in s.items()} if sums is None
                        else {k: sums[k] + s[k].detach() for k in sums})
            num_pos = torch.clamp(sums["num_pos"], min=1.0)
            g = grads()
            torch._foreach_div_(g, num_pos)
            _, metrics = metrics_from_sums(weighted, sums)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(g)
        state.optimizer.step(g)
        if state.ema is not None and decay > 0:
            with torch.no_grad():
                ema = list(state.ema.values())
                torch._foreach_mul_(ema, decay)
                torch._foreach_add_(ema, params, alpha=1.0 - decay)
        state.step += 1
        return state, metrics

    return train_step
