"""Training orchestration, mirroring `dcf.train.loop.train` on one device:
the host feeds prefetched batches, keeps the step counter, logs scalars
and checkpoints; the step itself runs on the device.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from dcf_torch.config import Config
from dcf_torch.data.augment import GTDatabase
from dcf_torch.data.loader import Loader, infinite_batches
from dcf_torch.device import resolve_device
from dcf_torch.eval.inference import batch_to_device
from dcf_torch.models.anchors import anchor_pack
from dcf_torch.params import init_params
from dcf_torch.train import checkpoint as ckpt
from dcf_torch.train.state import TrainState, create_train_state
from dcf_torch.train.step import make_train_step
from dcf_torch.utils.logging import MetricsLogger


def train(cfg: Config, dataset, workdir: str, device="cuda",
          gt_db: Optional[GTDatabase] = None, resume: bool = False,
          num_steps: Optional[int] = None,
          eval_hook: Optional[Callable[[TrainState, int], None]] = None,
          eval_every: int = 0) -> TrainState:
    """Run (or resume) a training job on `device`; returns the final state.

    The parameters start from `init_params` seeded with cfg.train.seed;
    with `resume`, from the latest checkpoint under `workdir/checkpoints`.
    Every `log_every` steps (and at the last) the step's metrics go to
    `workdir/metrics.jsonl`, with `steps_per_sec` over the steps since the
    previous line; every `checkpoint_every` steps (and at the last) a
    checkpoint is written. eval_hook(state, step) runs every `eval_every`
    steps and at the last one.
    """
    device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    t = cfg.train
    loader = Loader(dataset, cfg, training=True, gt_db=gt_db, seed=t.seed)
    batches = infinite_batches(loader)
    try:
        pending = next(batches)
        model = init_params(cfg, torch.Generator().manual_seed(t.seed),
                            device=device)
        state = create_train_state(cfg, model, seed=t.seed)
        ckpt_dir = os.path.join(workdir, "checkpoints")
        if resume:
            latest = ckpt.latest_checkpoint(ckpt_dir)
            if latest:
                state = ckpt.restore_checkpoint(latest, state)
                print(f"resumed from {latest} at step {state.step}")
        pack = anchor_pack(cfg, device)
        step_fn = make_train_step(cfg, model, device)
        logger = MetricsLogger(os.path.join(workdir, "metrics.jsonl"))
        total = num_steps if num_steps is not None else t.num_steps
        step, t0, since = state.step, time.time(), 0
        while step < total:
            state, metrics = step_fn(state, batch_to_device(pending, device),
                                     pack)
            pending = next(batches)
            step += 1
            since += 1
            if step % t.log_every == 0 or step == total:
                # reading the metrics waits for the device: the rate is
                # over finished steps
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["steps_per_sec"] = since / max(time.time() - t0, 1e-9)
                t0, since = time.time(), 0
                logger.log(m)
            if step % t.checkpoint_every == 0 or step == total:
                path = ckpt.save_checkpoint(ckpt_dir, state, cfg)
                print(f"saved {path}")
            if eval_hook is not None and eval_every and (
                    step % eval_every == 0 or step == total):
                eval_hook(state, step)
        return state
    finally:
        batches.close()
