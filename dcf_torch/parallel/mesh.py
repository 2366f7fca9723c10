"""Data parallel across processes, the counterpart of
`dcf.parallel.mesh`.

Each process drives one device and loads its own stride of the dataset
(`dcf_torch.train.loop._ProcessShard`), so the data shards are the
processes: the global batch is cfg.train.batch_size x process_count().
The JAX module's mesh, shardings, `replicate_state` and
`jit_train_step` have no counterpart here. Parameters stay replicated
because every rank starts from rank 0's state (`broadcast_state`) and
applies the same update: the train step all-reduces the gradients of the
unnormalized loss sums together with the sums and num_pos, then divides
once by the global num_pos (`dcf_torch.train.step`), which is the global
batch's gradient, as the JAX step computes it.

The backend is NCCL for CUDA and gloo for the CPU unless the caller
names one; gloo also reduces CUDA tensors, through the host.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group; call once per process before training.

    Arguments fall back to torchrun's variables (MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK). Returns True when the group is (or
    already was) initialized, False for a single process (no coordinator
    and no process count anywhere)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            f"initialize_distributed needs a coordinator HOST:PORT, a "
            f"process count and a process id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_device(device: torch.device) -> torch.device:
    """The device this process drives: for "cuda" without an index, card
    LOCAL_RANK (torchrun's variable), else the rank modulo the cards; it
    becomes the current device (NCCL launches on the current one)."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else process_index() % torch.cuda.device_count())
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _flat_groups(tensors: List[torch.Tensor]):
    """Indices of `tensors` grouped by dtype (one flat buffer each)."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups.values()


def all_reduce_sum(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise sums of `tensors` over every process, by one flat
    all-reduce per dtype; returns new tensors shaped as the inputs."""
    tensors = list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _flat_groups(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        parts = flat.split([tensors[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            out[i] = part.view_as(tensors[i])
    return out


@torch.no_grad()
def _broadcast_tensors(tensors: Iterable[torch.Tensor],
                       src: int = 0) -> None:
    """Overwrite `tensors` in place with process `src`'s values."""
    tensors = list(tensors)
    for idx in _flat_groups(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.broadcast(flat, src=src)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            tensors[i].copy_(part.view_as(tensors[i]))


def broadcast_state(state, src: int = 0) -> None:
    """Make `state` (`dcf_torch.train.state.TrainState`) process `src`'s
    on every process, in place: the parameters and buffers, AdamW's
    moments and update count, the EMA and the step. The seeded generator
    is not sent: every process seeds it alike or restores it from the
    same checkpoint."""
    model = state.model
    device = next(model.parameters()).device
    counters = torch.tensor([state.step, state.optimizer.count],
                            dtype=torch.int64, device=device)
    tensors = [counters, *model.parameters(), *model.buffers(),
               *state.optimizer.mu, *state.optimizer.nu]
    if state.ema is not None:
        tensors += list(state.ema.values())
    _broadcast_tensors(tensors, src)
    state.step, state.optimizer.count = (int(v) for v in counters.tolist())
