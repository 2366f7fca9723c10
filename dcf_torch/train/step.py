"""The training step, mirroring `dcf.train.step.make_train_step`: forward,
target assignment, losses, backward (through the fusion kernels on the
card), clip + AdamW, EMA.

`cfg.train.accum_steps > 1` splits the batch into that many micro-batches
and accumulates the gradients of the UNNORMALIZED loss sums, then divides
once by the whole batch's num_pos: the full-batch gradient exactly, since
num_pos depends on no parameter, with one micro-batch's activations in
memory at a time. Across processes (`dcf_torch.parallel.mesh`) the same
arithmetic holds: each rank takes the gradients of its own sums, one
flat all-reduce adds those gradients, the sums and num_pos over the
ranks, and the division by the global num_pos follows, so every rank
applies the global batch's update, as the JAX step computes it
(`dcf/train/losses.py` divides by the global num_pos), and logs the
global batch's metrics.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch

from dcf_torch.config import Config
from dcf_torch.device import resolve_device
from dcf_torch.models.anchors import anchor_grid_shape
from dcf_torch.models.detector import ContFuseDetector
from dcf_torch.models.head import flatten_predictions
from dcf_torch.parallel import mesh as pmesh
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


def _check_finite(what: str, names: List[str],
                  tensors: List[torch.Tensor]) -> None:
    """Raise naming the first of `tensors` that holds a NaN or an inf."""
    bad = torch.stack([~torch.isfinite(t).all() for t in tensors])
    if bool(bad.any()):
        name = names[int(bad.nonzero()[0])]
        raise FloatingPointError(f"train step: {what} {name} is not finite")


def make_train_step(cfg: Config, model: ContFuseDetector, device,
                    debug: bool = False
                    ) -> Callable[[TrainState, Batch, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns train_step(state, batch, pack) -> (state, metrics).

    `batch` holds device tensors (`dcf_torch.eval.inference.
    batch_to_device`), `pack` the anchor tensors; `state.model` must be
    `model`, on `device`. The state is updated in place and returned.
    Metrics are device scalars: loss, loss_cls, loss_reg, loss_dir,
    num_pos and grad_norm (of the raw grads, before clipping), over the
    global batch when several processes train together.

    debug=True is the counterpart of `dcf.parallel.mesh.
    jit_train_step_debug`: the forward and backward run under
    `torch.autograd.detect_anomaly()` (a backward op that returns a NaN
    raises with the forward op's traceback), then the step raises
    FloatingPointError naming the first of the loss, the gradients and
    (after the update) the parameters that is not finite; the gradients
    are checked before the update, so the state keeps its last finite
    values. Slower (a host sync per check); never the production path.
    Of checkify's checks it does not cover: the z-slab user check (the
    port drops no fusion pairs, so it has no slab); integer division
    checks; index checks (torch raises on an out-of-bounds index on the
    CPU and asserts on the device, where jnp gathers clamp).
    """
    device = resolve_device(device)
    if any(p.device.type != device.type for p in model.parameters()):
        raise ValueError(f"make_train_step: the model is not on {device}")
    sums_fn = build_loss_sums_fn(cfg, model)
    accum = cfg.train.accum_steps
    decay = cfg.train.ema_decay
    names, params = zip(*model.named_parameters())
    names, params = list(names), list(params)
    world = pmesh.process_count()
    reduce_sums = accum > 1 or world > 1

    def grads_of(loss: torch.Tensor, first: bool) -> None:
        if first:
            for p in params:
                p.grad = None
        loss.backward()

    def grads() -> list:
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in params]

    def forward_backward(batch: Batch, pack: Batch):
        """(raw grads, loss, metrics) of the (global) batch."""
        if not reduce_sums:
            loss, metrics = metrics_from_sums(*sums_fn(batch, pack))
            grads_of(loss, True)
            return grads(), loss, metrics
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
        g = grads()
        if world > 1:
            keys = sorted(sums)
            n = len(g)
            out = pmesh.all_reduce_sum(
                [*g, weighted, *(sums[k] for k in keys)])
            g, weighted = out[:n], out[n]
            sums = dict(zip(keys, out[n + 1:]))
        torch._foreach_div_(g, torch.clamp(sums["num_pos"], min=1.0))
        loss, metrics = metrics_from_sums(weighted, sums)
        return g, loss, metrics

    def train_step(state: TrainState, batch: Batch, pack: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        with (torch.autograd.detect_anomaly() if debug
              else contextlib.nullcontext()):
            g, loss, metrics = forward_backward(batch, pack)
        if debug:
            _check_finite("the", ["loss"], [loss.detach()])
            _check_finite("the gradient of", names, g)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(g)
        state.optimizer.step(g)
        if state.ema is not None and decay > 0:
            with torch.no_grad():
                ema = list(state.ema.values())
                torch._foreach_mul_(ema, decay)
                torch._foreach_add_(ema, params, alpha=1.0 - decay)
        if debug:
            _check_finite("the parameter", names, params)
        state.step += 1
        return state, metrics

    return train_step
