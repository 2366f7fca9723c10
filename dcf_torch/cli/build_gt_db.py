"""Offline gt-sampling database builder.

    python -m dcf_torch.cli.build_gt_db --data-root /data/kitti \
        --split train --out runs/gt_db.pkl
"""

from __future__ import annotations

import argparse

from dcf_torch.cli.common import add_data_args, resolve_dataset
from dcf_torch.data.augment import GTDatabase
from dcf_torch.device import resolve_device


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--min-points", type=int, default=8)
    add_data_args(p)
    args = p.parse_args(argv)
    resolve_device(args.device)

    dataset = resolve_dataset(args)
    frames = (dataset[i] for i in range(len(dataset)))
    db = GTDatabase.build(frames, min_points=args.min_points)
    db.save(args.out)
    counts = {k: len(v) for k, v in db.db.items()}
    print(f"wrote {args.out}: {counts}")


if __name__ == "__main__":
    main()
