"""The learning check on the card: the train-and-evaluate workflow
(`dcf_torch.tools.generalization`) at full width, then the same final
weights evaluated again in float32 with TF32 off, and one summary.

    python -m dcf_torch.tools.learning_check --steps 2000 --ema 0.999 \
        --eval-every 250 --probe-frames 8 --int8-eval --workdir runs/learn

Takes the workflow's flags. Prints the card's name and power limit
(nvidia-smi), then as the last line one JSON object: the steps reached,
the training rate (the median of the loop's logged steps_per_sec; each
is over 50 steps, and the windows that hold a probe evaluation are
slower), the probe curve, the val split's exact moderate AP of the final
weights in bf16 (the workflow's), in float32 and in int8, and the
workflow's wall seconds. Also writes it to WORKDIR/learning_check.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from dcf_torch.eval.evaluate import run_eval
from dcf_torch.params import init_params
from dcf_torch.tools import generalization as gen
from dcf_torch.train import checkpoint as ckpt
from dcf_torch.train.state import create_train_state


def float32_val_ap(workdir: str, val_frames: int, device) -> dict:
    """Exact moderate AP of the workdir's latest checkpoint on the val
    split, computed in float32 with TF32 off."""
    ckpt_dir = os.path.join(workdir, "checkpoints")
    cfg = ckpt.load_config(ckpt_dir)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="float32"))
    model = init_params(cfg, torch.Generator().manual_seed(0), device=device)
    state = ckpt.restore_checkpoint(ckpt.latest_checkpoint(ckpt_dir),
                                    create_train_state(cfg, model))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        val_ds = gen.VariedDataset(range(gen.VAL_SEEDS,
                                         gen.VAL_SEEDS + val_frames))
        r = run_eval(cfg, state.model, val_ds, num_points=0, device=device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {k: round(v, 4) for k, v in r.items() if "moderate" in k}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    args = gen.parser().parse_args(argv)
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(f"card: {smi}", flush=True)
    t = time.time()
    results = gen.main(argv)
    wall = time.time() - t
    with open(os.path.join(args.workdir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    curve = []
    if args.eval_every:
        with open(os.path.join(args.workdir, "eval_curve.json")) as f:
            curve = json.load(f)
    f32 = float32_val_ap(args.workdir, args.val_frames, args.device)
    moderate = {k[:-len("_exact")]: v for k, v in results.items()
                if k.endswith("moderate_exact")}
    int8 = {k[:-len("_int8_exact")]: v for k, v in results.items()
            if k.endswith("_int8_exact")}
    summary = {
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu"),
        "steps": logged[-1]["step"],
        "steps_per_sec_median": float(np.median(
            [m["steps_per_sec"] for m in logged])),
        "wall_s": round(wall, 1),
        "val_exact_bf16": moderate, "val_exact_f32": f32,
        "val_exact_int8": int8,
        "best": {k: results[k] for k in ("best_step", "best_kind")
                 if k in results},
        "probe_curve": curve,
    }
    with open(os.path.join(args.workdir, "learning_check.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
