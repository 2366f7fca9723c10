"""Training orchestration, mirroring `dcf.train.loop.train`: the host
feeds prefetched batches, keeps the step counter, logs scalars and
checkpoints; the step itself runs on the device. Several processes
(`dcf_torch.parallel.mesh.initialize_distributed`) train data parallel,
one device each.
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
from dcf_torch.parallel import mesh as pmesh
from dcf_torch.params import init_params
from dcf_torch.train import checkpoint as ckpt
from dcf_torch.train.state import TrainState, create_train_state
from dcf_torch.train.step import make_train_step
from dcf_torch.utils import trace
from dcf_torch.utils.logging import MetricsLogger

# the spans whose mean ms since the previous line each metrics line
# carries while the tracer is enabled (`--trace PATH`)
LOGGED_SPANS = ("loop.wait_batch", "loop.h2d", "augment", "loader.example")


class _ProcessShard:
    """Dataset view restricted to this process's stride (a copy of
    `dcf.train.loop._ProcessShard`): process p of n sees frames p, p+n,
    p+2n, ... so processes read disjoint data.

    Step-based semantics, not epoch-exact: indexing wraps modulo the
    underlying dataset, so for uneven dataset/process splits a process
    may revisit a frame within what another would call an "epoch", and
    `len()` clamps to >= 1 so every process can always draw a batch."""

    def __init__(self, dataset, process_index: int, process_count: int):
        self.dataset = dataset
        self.offset = process_index
        self.stride = process_count

    def __len__(self) -> int:
        return max((len(self.dataset) - self.offset + self.stride - 1)
                   // self.stride, 1)

    def __getitem__(self, i: int):
        return self.dataset[(i * self.stride + self.offset)
                            % len(self.dataset)]


def train(cfg: Config, dataset, workdir: str, device="cuda",
          gt_db: Optional[GTDatabase] = None, resume: bool = False,
          num_steps: Optional[int] = None,
          num_data_shards: Optional[int] = None, debug: bool = False,
          eval_hook: Optional[Callable[[TrainState, int], None]] = None,
          eval_every: int = 0) -> TrainState:
    """Run (or resume) a training job on `device`; returns the final state.

    The parameters start from `init_params` seeded with cfg.train.seed;
    with `resume`, from the latest checkpoint under `workdir/checkpoints`.
    Every `log_every` steps (and at the last) the step's metrics go to
    `workdir/metrics.jsonl`, with `steps_per_sec` over the steps since the
    previous line (and, while the tracer is enabled, the mean ms of each
    of `LOGGED_SPANS` since then, as `<span>_ms`); every
    `checkpoint_every` steps (and at the last) a checkpoint is written.
    eval_hook(state, step) runs every `eval_every` steps and at the last
    one.

    Several processes: each loads a disjoint stride of the dataset with
    the loader seed cfg.train.seed + rank (global batch = batch_size x
    processes); every rank restores from the same `workdir` and then
    takes rank 0's state; checkpoints, metrics.jsonl and eval_hook run on
    rank 0 only. `num_data_shards`, when given, must equal the number of
    processes (one device each). debug=True runs the debug step
    (`dcf_torch.train.step.make_train_step`).
    """
    device = resolve_device(device)
    rank, world = pmesh.process_index(), pmesh.process_count()
    if num_data_shards is not None and num_data_shards != world:
        raise ValueError(
            f"--data-shards {num_data_shards} with {world} process(es): "
            f"each process drives one device, so the data shards are the "
            f"processes")
    is_main = rank == 0
    if world > 1:
        device = pmesh.process_device(device)
        dataset = _ProcessShard(dataset, rank, world)
    if is_main:
        os.makedirs(workdir, exist_ok=True)
    t = cfg.train
    loader = Loader(dataset, cfg, training=True, gt_db=gt_db,
                    seed=t.seed + rank)
    batches = infinite_batches(loader)
    try:
        with trace.span("loop.wait_batch", step=0):
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
        if world > 1:
            pmesh.broadcast_state(state)
        pack = anchor_pack(cfg, device)
        step_fn = make_train_step(cfg, model, device, debug=debug)
        logger = MetricsLogger(os.path.join(workdir, "metrics.jsonl"))
        total = num_steps if num_steps is not None else t.num_steps
        step, t0, since = state.step, time.time(), 0
        logged_spans = {}
        while step < total:
            with trace.span("loop.h2d", step=step + 1):
                batch = batch_to_device(pending, device)
            with trace.span("loop.step", step=step + 1):
                state, metrics = step_fn(state, batch, pack)
            del batch
            with trace.span("loop.wait_batch", step=step + 1):
                pending = next(batches)
            step += 1
            since += 1
            if not is_main:
                continue
            if step % t.log_every == 0 or step == total:
                with trace.span("loop.log", step=step):
                    # reading the metrics waits for the device: the rate
                    # is over finished steps
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    m["steps_per_sec"] = since / max(time.time() - t0, 1e-9)
                    t0, since = time.time(), 0
                    if trace.TRACER.on:
                        means = trace.TRACER.mean_ms_since(LOGGED_SPANS,
                                                           logged_spans)
                        m.update({f"{k}_ms": v for k, v in means.items()})
                    logger.log(m)
            if step % t.checkpoint_every == 0 or step == total:
                with trace.span("loop.checkpoint", step=step):
                    path = ckpt.save_checkpoint(ckpt_dir, state, cfg)
                print(f"saved {path}")
            if eval_hook is not None and eval_every and (
                    step % eval_every == 0 or step == total):
                eval_hook(state, step)
        return state
    finally:
        batches.close()
