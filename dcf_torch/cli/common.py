"""Shared CLI plumbing of the port's entry points (mirrors
`dcf.cli.common`): the configs by name with their models and examples,
the data arguments, the device argument and the trace flag."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
from typing import Callable, Optional

import torch

from dcf_torch import config as cfgmod
from dcf_torch.config import Config
from dcf_torch.data.preprocess import frame_to_example
from dcf_torch.data.synthetic import SyntheticDataset
from dcf_torch.models import pointpillars
from dcf_torch.parallel import mesh as pmesh
from dcf_torch.params import init_params
from dcf_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class ConfigEntry:
    """A config by name: `make()` gives its `Config`, `build(cfg,
    generator, device=...)` its detector with seeded random weights,
    `example(frame, cfg)` a frame's example for that detector;
    `serve_only`, where set, says why the config cannot be trained."""

    make: Callable[[], Config]
    build: Callable[..., torch.nn.Module] = init_params
    example: Callable = frame_to_example
    serve_only: Optional[str] = None


CONFIGS = {
    "lidar": ConfigEntry(cfgmod.lidar_only_config),
    "camera": ConfigEntry(cfgmod.camera_config),
    "fusion1": ConfigEntry(cfgmod.fusion_single_scale_config),
    "full": ConfigEntry(cfgmod.multi_scale_config),
    "tiny": ConfigEntry(cfgmod.tiny_config),   # CI-sized full architecture
    "pointpillars": ConfigEntry(
        pointpillars.pointpillars_config, pointpillars.init_pointpillars,
        pointpillars.pillar_example,
        serve_only="training PointPillars is not supported yet: it needs "
                   "BatchNorm in training mode, the pillar feature net's "
                   "backward and target assignment at head stride 2"),
}


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-root", default=None,
                   help="KITTI object root (training/velodyne etc.)")
    p.add_argument("--split", default="train")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="use N synthetic frames instead of KITTI data")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs; cuda without a card raises")


def add_trace_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record the program's spans and counters and "
                        "write them here as a Chrome trace at exit")


@contextlib.contextmanager
def tracing(path: Optional[str]):
    """With a path, the tracer records inside the block and its records
    are written to `path` as a Chrome trace on the way out, whatever
    ends the block; with several processes, rank r writes
    `<path stem>.rank<r><suffix>`."""
    if not path:
        yield
        return
    if pmesh.process_count() > 1:
        stem, ext = os.path.splitext(path)
        path = f"{stem}.rank{pmesh.process_index()}{ext}"
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.enable(False)
        trace.export_chrome(path)
        print(f"wrote {path}")


def resolve_dataset(args):
    if args.synthetic:
        return SyntheticDataset(args.synthetic)
    if not args.data_root:
        raise SystemExit("need --data-root or --synthetic N")
    from dcf_torch.data.kitti import KittiDataset
    return KittiDataset(args.data_root, split=args.split)
