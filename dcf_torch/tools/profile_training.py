"""Where the time of a training step goes on the card.

    python -m dcf_torch.tools.profile_training [--steps 8]

`multi_scale_config()` at full width, bf16, B=2, seeded random weights,
seed-varied synthetic frames through the augmenting `Loader` (gt-sampling
from a database of 4 of them). Reports:
  - the loader alone: host ms per batch of 2 frames, consumed back to back
    (its thread pool and prefetch queue as `train()` uses them);
  - the step alone (`make_train_step` on batches already on the card):
    host p50 / p95 ms per step, each ended by a device sync, with no
    profiler;
  - the top kernels by device time (torch.profiler) and the device's busy
    share: the kernels' device time over the unprofiled wall time of the
    same steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from dcf_torch.config import train_config
from dcf_torch.data.augment import GTDatabase
from dcf_torch.data.loader import Loader, infinite_batches
from dcf_torch.data.synthetic import SyntheticDataset
from dcf_torch.eval.inference import batch_to_device
from dcf_torch.models.anchors import anchor_pack
from dcf_torch.params import init_params
from dcf_torch.train.state import create_train_state
from dcf_torch.train.step import make_train_step


def _run(step, state, batches, pack):
    """Host ms per step, each step ended by a device sync."""
    host = []
    for batch in batches:
        t = time.perf_counter()
        step(state, batch, pack)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    return host


def load_batches(n: int):
    """`n` batches of 2 from the augmenting `Loader` over 16 seed-varied
    frames (gt-sampling from a database of 4), consumed back to back:
    (config, batches, host ms per batch, the loader's worker count)."""
    cfg = train_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2))
    data = SyntheticDataset(16, varied=True)
    loader = Loader(data, cfg, gt_db=GTDatabase.build(
        [data[i] for i in range(4)]), seed=cfg.train.seed)
    stream = infinite_batches(loader)
    t = time.perf_counter()
    batches = list(itertools.islice(stream, n))
    stream.close()
    ms = (time.perf_counter() - t) * 1e3 / len(batches)
    return cfg, batches, ms, loader.num_workers


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: needs a CUDA device")
    cfg, host_batches, load_ms, workers = load_batches(args.steps + 1)

    model = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, "cuda")
    pack = anchor_pack(cfg, "cuda")
    batches = [batch_to_device(b, "cuda") for b in host_batches]
    step(state, batches[-1], pack)                       # warm-up
    torch.cuda.synchronize()
    host = _run(step, state, batches[:-1], pack)         # unprofiled
    n = len(host)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; multi_scale_config, "
          f"{cfg.backbone.dtype}, B=2; loader {load_ms:.3f} ms per batch "
          f"(host, {workers} workers); step alone: p50 "
          f"{np.percentile(host, 50):.3f} ms, p95 "
          f"{np.percentile(host, 95):.3f} ms over {n} steps (no profiler)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = _run(step, state, batches[:-1], pack)
    kernels = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] += evt.device_time_total / 1e3   # ms
    busy = sum(kernels.values())
    print(f"device busy {busy / n:.3f} ms per step of {sum(host) / n:.3f} "
          f"ms wall without the profiler: busy share "
          f"{busy / sum(host):.3f} (the profiled steps took "
          f"{sum(profiled) / n:.3f} ms each)")
    print("top kernels by device time, ms per step:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms / n:9.4f}  {name[:110]}")


if __name__ == "__main__":
    main()
