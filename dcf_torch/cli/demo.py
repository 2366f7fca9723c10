"""Single-frame end-to-end demo: a raw frame in, 3D boxes out, with
seeded random weights.

    python -m dcf_torch.cli.demo [--config full] [--synthetic 1]
    python -m dcf_torch.cli.demo --config full --data-root /data/kitti
    python -m dcf_torch.cli.demo --config tiny --device cpu
    python -m dcf_torch.cli.demo --config tiny --viz /tmp/demo.png
    python -m dcf_torch.cli.demo --config pointpillars

With --viz, a bird's-eye view of the frame (points, gt boxes green,
detections red by score) is written as a PNG; with --trace PATH, the
frame's spans and counters (`dcf_torch.utils.trace`) as a Chrome trace.
"""

from __future__ import annotations

import argparse

import torch

from dcf_torch.cli.common import (CONFIGS, add_data_args, add_trace_arg,
                                  resolve_dataset, tracing)
from dcf_torch.data.kitti import CLASS_NAMES
from dcf_torch.data.preprocess import stack_examples
from dcf_torch.device import resolve_device
from dcf_torch.eval.inference import make_inference_fn, to_host
from dcf_torch.utils.viz import draw_bev


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="tiny",
                   choices=list(CONFIGS))
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--viz", default=None, help="write a BEV png here")
    add_trace_arg(p)
    add_data_args(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if not args.synthetic and not args.data_root:
        args.synthetic = 1

    entry = CONFIGS[args.config]
    cfg = entry.make()
    frame = resolve_dataset(args)[args.frame]
    model = entry.build(cfg, torch.Generator().manual_seed(0), device=device)
    infer = make_inference_fn(cfg, model, device=device)
    with tracing(args.trace):
        out = to_host(infer(stack_examples([entry.example(frame, cfg)])))

    keep = out["valid"][0]
    boxes = out["boxes"][0][keep]
    scores = out["scores"][0][keep]
    classes = out["classes"][0][keep]
    print(f"frame {frame.frame_id}: {keep.sum()} detections "
          f"({len(frame.boxes)} gt boxes)")
    for b, s, c in zip(boxes[:10], scores[:10], classes[:10]):
        print(f"  {CLASS_NAMES[c]:<10} score={s:.3f} "
              f"xyz=({b[0]:.1f},{b[1]:.1f},{b[2]:.1f}) "
              f"lwh=({b[3]:.1f},{b[4]:.1f},{b[5]:.1f}) yaw={b[6]:.2f}")

    if args.viz:
        draw_bev(args.viz, frame.points, cfg.voxel, gt_boxes=frame.boxes,
                 det_boxes=boxes, det_scores=scores)
        print(f"wrote {args.viz}")


if __name__ == "__main__":
    main()
