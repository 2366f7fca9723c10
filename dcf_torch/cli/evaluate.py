"""Evaluation entry point: the latest checkpoint of a workdir over a
split, KITTI AP printed as JSON.

    python -m dcf_torch.cli.evaluate --workdir runs/full \
        --data-root /data/kitti --split val [--results-dir runs/full/res]

It reads the port's own workdirs (`dcf_torch.cli.train`: config.json and
ckpt_<step>.pt under WORKDIR/checkpoints). A JAX workdir's .msgpack
checkpoints are not read.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from dcf_torch.cli.common import add_data_args, resolve_dataset
from dcf_torch.device import resolve_device
from dcf_torch.eval.evaluate import run_eval
from dcf_torch.params import init_params
from dcf_torch.train import checkpoint as ckpt
from dcf_torch.train.state import create_train_state


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--results-dir", default=None,
                   help="write one KITTI result txt per frame here")
    p.add_argument("--num-frames", type=int, default=None)
    p.add_argument("--score-threshold", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=8,
                   help="frames per device batch during inference")
    p.add_argument("--num-points", type=int, default=40,
                   help="40=R40 (official), 11=R11, 0=exact area-under-PR")
    p.add_argument("--metrics", default="3d,bev",
                   help="comma list of 3d/bev/bbox")
    add_data_args(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    ckpt_dir = os.path.join(args.workdir, "checkpoints")
    latest = ckpt.latest_checkpoint(ckpt_dir)
    if latest is None:
        raise SystemExit(f"no checkpoint ckpt_*.pt in {ckpt_dir}")
    cfg = ckpt.load_config(ckpt_dir)
    model = init_params(cfg, torch.Generator().manual_seed(0), device=device)
    state = ckpt.restore_checkpoint(latest, create_train_state(cfg, model))
    print(f"evaluating {latest}")

    results = run_eval(cfg, state.model, resolve_dataset(args),
                       result_dir=args.results_dir,
                       score_threshold=args.score_threshold,
                       num_frames=args.num_frames,
                       num_points=args.num_points,
                       batch_size=args.batch_size,
                       metrics=tuple(args.metrics.split(",")),
                       device=device)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
