"""Training entry point.

    python -m dcf_torch.cli.train --config full --data-root /data/kitti \
        --workdir runs/full [--gt-db runs/gt_db.pkl] [--resume]
    python -m dcf_torch.cli.train --config tiny --synthetic 8 --steps 20

Data parallel, one process per device (global batch = the config's
batch x processes), with torchrun or with the flags:

    torchrun --nproc-per-node 4 -m dcf_torch.cli.train --config full ...
    python -m dcf_torch.cli.train --coordinator localhost:29500 \
        --num-processes 2 --process-id {0,1} ...

Checkpoints go to WORKDIR/checkpoints (`ckpt_<step>.pt`), metrics to
WORKDIR/metrics.jsonl, both from process 0 only. With --trace PATH the
program's spans and counters (`dcf_torch.utils.trace`) are written to
PATH as a Chrome trace at exit, and each metrics line also carries the
mean ms of the batch wait, the host-to-device copy, the augmentation and
an example's build since the previous line.
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from dcf_torch.cli.common import (CONFIGS, add_data_args, add_trace_arg,
                                  resolve_dataset, tracing)
from dcf_torch.data.augment import GTDatabase
from dcf_torch.device import resolve_device
from dcf_torch.parallel.mesh import initialize_distributed
from dcf_torch.train.loop import train


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="full",
                   choices=list(CONFIGS))
    p.add_argument("--workdir", default="runs/default")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--gt-db", default=None,
                   help="gt-sampling database pickle "
                        "(dcf_torch.cli.build_gt_db)")
    p.add_argument("--data-shards", type=int, default=None,
                   help="data-parallel shards; must equal the number of "
                        "processes (one device each)")
    p.add_argument("--debug", action="store_true",
                   help="anomaly detection and finite checks of the loss, "
                        "gradients and parameters every step")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="data parallel: rank 0's address (or set "
                        "MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, "
                        "as torchrun does)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    add_trace_arg(p)
    add_data_args(p)
    args = p.parse_args(argv)
    entry = CONFIGS[args.config]
    if entry.serve_only:
        p.error(f"--config {args.config}: {entry.serve_only}")
    device = resolve_device(args.device)

    cfg = entry.make()
    dataset = resolve_dataset(args)
    gt_db = GTDatabase.load(args.gt_db) if args.gt_db else None
    # a group this call joins is left again at the end
    owned = not dist.is_initialized() and initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        backend="gloo" if device.type == "cpu" else None)
    try:
        with tracing(args.trace):
            train(cfg, dataset, args.workdir, device=device, gt_db=gt_db,
                  resume=args.resume, num_steps=args.steps,
                  num_data_shards=args.data_shards, debug=args.debug)
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
