"""Shared CLI plumbing of the port's entry points (mirrors
`dcf.cli.common`): the configs by name, the data arguments and the
device argument."""

from __future__ import annotations

import argparse

from dcf_torch import config as cfgmod
from dcf_torch.data.synthetic import SyntheticDataset

CONFIGS = {
    "lidar": cfgmod.lidar_only_config,
    "camera": cfgmod.camera_config,
    "fusion1": cfgmod.fusion_single_scale_config,
    "full": cfgmod.multi_scale_config,
    "tiny": cfgmod.tiny_config,        # CI-sized full architecture
}


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-root", default=None,
                   help="KITTI object root (training/velodyne etc.)")
    p.add_argument("--split", default="train")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="use N synthetic frames instead of KITTI data")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs; cuda without a card raises")


def resolve_dataset(args):
    if args.synthetic:
        return SyntheticDataset(args.synthetic)
    if not args.data_root:
        raise SystemExit("need --data-root or --synthetic N")
    from dcf_torch.data.kitti import KittiDataset
    return KittiDataset(args.data_root, split=args.split)
