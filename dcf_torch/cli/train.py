"""Training entry point.

    python -m dcf_torch.cli.train --config full --data-root /data/kitti \
        --workdir runs/full [--gt-db runs/gt_db.pkl] [--resume]
    python -m dcf_torch.cli.train --config tiny --synthetic 8 --steps 20

Checkpoints go to WORKDIR/checkpoints (`ckpt_<step>.pt`), metrics to
WORKDIR/metrics.jsonl.
"""

from __future__ import annotations

import argparse

from dcf_torch.cli.common import CONFIGS, add_data_args, resolve_dataset
from dcf_torch.data.augment import GTDatabase
from dcf_torch.device import resolve_device
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
    add_data_args(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = CONFIGS[args.config]()
    dataset = resolve_dataset(args)
    gt_db = GTDatabase.load(args.gt_db) if args.gt_db else None
    train(cfg, dataset, args.workdir, device=device, gt_db=gt_db,
          resume=args.resume, num_steps=args.steps)


if __name__ == "__main__":
    main()
