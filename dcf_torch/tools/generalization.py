"""Train-and-evaluate workflow, the counterpart of
`scripts/generalization.py`: train the flagship config on seed-varied
synthetic frames, then evaluate KITTI AP on a held-out split.

Train, val and probe frames are disjoint seed ranges of
`make_varied_frame` (train 1000+, val 2000+, probe 3000+), so the run
shows that the detector learns, not that it memorizes.

    python -m dcf_torch.tools.generalization [--steps 1500]
        [--train-frames 64] [--val-frames 16] [--batch 2]
        [--ema 0.999 --eval-every 250 --probe-frames 8] [--gt-db]
        [--int8-eval] [--workdir runs/gen] [--device cuda]

Writes WORKDIR/generalization.json (val AP: `*_R40`, `*_exact`,
`*_ema_exact`, `*_best_exact` with `best_step` / `best_kind`,
`*_int8_exact`) and, with --eval-every, WORKDIR/eval_curve.json (the
probe split's moderate 3D AP of the raw and EMA parameters). The JAX
script's `--resident-batches` (a TPU transfer workaround) is left out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable, Dict, Iterable, Optional

import torch

from dcf_torch.config import Config, multi_scale_config
from dcf_torch.data.augment import GTDatabase
from dcf_torch.data.preprocess import frame_to_example, stack_examples
from dcf_torch.data.synthetic import make_varied_frame
from dcf_torch.device import resolve_device
from dcf_torch.eval.evaluate import run_eval
from dcf_torch.eval.inference import make_inference_fn
from dcf_torch.params import from_flax, init_params, to_flax
from dcf_torch.quant import calibrate, quant_config
from dcf_torch.train.loop import train
from dcf_torch.train.state import TrainState

CLASSES = ("Car", "Pedestrian", "Cyclist")
TRAIN_SEEDS, VAL_SEEDS, PROBE_SEEDS = 1000, 2000, 3000

Params = Dict[str, torch.Tensor]


class VariedDataset:
    """Frames `make_varied_frame(seed=s)` for the given seeds."""

    def __init__(self, seeds: Iterable[int]):
        self.seeds = list(seeds)

    def __len__(self) -> int:
        return len(self.seeds)

    def __getitem__(self, i: int):
        s = self.seeds[i]
        return make_varied_frame(frame_id=f"{s:06d}", seed=s)


def workflow_config(base: Config, steps: int = 1500, batch: int = 2,
                    lr: float = 1e-3, ema: float = 0.0,
                    preset: str = "base", dir_weight: Optional[float] = None,
                    gt_db: bool = False, image_paste: bool = True) -> Config:
    """`base` with the workflow's overrides (scripts/generalization.py:
    the `fast` preset's widths, warmup min(150, steps // 10), one
    checkpoint at the end, a log line every 50 steps)."""
    r = dataclasses.replace
    cfg = base
    if preset == "fast":
        cfg = r(cfg, backbone=r(
            cfg.backbone,
            bev_stage_channels=(48, 96, 144, 192),
            bev_blocks_per_stage=(1, 1, 2, 2),
            image_stage_channels=(48, 96, 192, 320),
            image_blocks_per_stage=(1, 1, 2, 2),
            fpn_channels=96),
            head=r(cfg.head, head_channels=96))
    cfg = r(cfg, train=r(
        cfg.train, batch_size=batch, num_steps=steps, learning_rate=lr,
        warmup_steps=min(150, steps // 10), checkpoint_every=steps,
        log_every=50, ema_decay=ema))
    if dir_weight is not None:
        cfg = r(cfg, loss=r(cfg.loss, dir_weight=dir_weight))
    return r(cfg, augment=r(cfg.augment, gt_sampling=gt_db,
                            gt_sample_image_paste=image_paste))


def build_gt_db(train_ds) -> GTDatabase:
    return GTDatabase.build((train_ds[i] for i in range(len(train_ds))),
                            min_points=8, with_image=True)


class Evaluator:
    """KITTI AP of any parameters through one inference function.

    The parameters are copied into a model of its own, never into the
    model being trained, and every evaluation reuses the one
    `make_inference_fn` built over that copy."""

    def __init__(self, cfg: Config, device):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = init_params(cfg, torch.Generator().manual_seed(0),
                                 device=self.device)
        self.infer = make_inference_fn(cfg, self.model, device=self.device)

    @torch.no_grad()
    def load(self, params: Params) -> None:
        for name, p in self.model.named_parameters():
            p.copy_(params[name])

    def __call__(self, params: Params, dataset, num_points: int,
                 metrics=("3d", "bev")) -> Dict[str, float]:
        self.load(params)
        return run_eval(self.cfg, self.model, dataset, num_points=num_points,
                        metrics=metrics, infer=self.infer,
                        device=self.device)


def raw_params(state: TrainState) -> Params:
    return dict(state.model.named_parameters())


def probe_hook(evaluate: Callable[..., Dict[str, float]], probe_ds,
               curve: list, best: dict
               ) -> Callable[[TrainState, int], None]:
    """The loop's eval hook: the raw (and EMA) parameters' moderate 3D AP
    on the probe split, appended to `curve`; `best` keeps a copy of the
    parameters with the highest minimum over the classes (the first of
    equals), with their step and kind."""

    def hook(state: TrainState, step: int) -> None:
        cands = [("raw", raw_params(state))]
        if state.ema is not None:
            cands.append(("ema", state.ema))
        row = {"step": step}
        for kind, params in cands:
            r = evaluate(params, probe_ds, num_points=0, metrics=("3d",))
            aps = {c: round(r[f"{c}_3d_moderate"], 4) for c in CLASSES}
            row[kind] = aps
            score = min(aps.values())
            if score > best["score"]:
                best.update(score=score, step=step, kind=kind, params={
                    n: t.detach().clone() for n, t in params.items()})
        curve.append(row)
        print("probe-eval", json.dumps(row), flush=True)

    return hook


def val_results(evaluate: Callable[..., Dict[str, float]],
                state: TrainState, val_ds, best: dict) -> Dict:
    """The val split's AP of the final raw parameters (R40 and exact,
    easy and moderate), of the EMA and of the best probe parameters
    (exact moderate 3D), keyed as scripts/generalization.py keys them."""
    results = {}
    for npts, tag in ((40, "R40"), (0, "exact")):
        r = evaluate(raw_params(state), val_ds, num_points=npts)
        results.update({f"{k}_{tag}": round(v, 4) for k, v in r.items()
                        if "moderate" in k or "easy" in k})
    if state.ema is not None:
        r = evaluate(state.ema, val_ds, num_points=0, metrics=("3d",))
        results.update({f"{k}_ema_exact": round(v, 4) for k, v in r.items()
                        if "moderate" in k})
    if best["params"] is not None:
        r = evaluate(best["params"], val_ds, num_points=0, metrics=("3d",))
        results.update({f"{k}_best_exact": round(v, 4)
                        for k, v in r.items() if "moderate" in k})
        results["best_step"] = best["step"]
        results["best_kind"] = best["kind"]
    return results


def int8_results(evaluator: Evaluator, params: Params, train_ds,
                 val_ds) -> Dict:
    """Post-training int8 (`dcf_torch.quant`) of `params`, calibrated on
    pairs of the first 8 train frames: the val split's exact moderate
    AP."""
    cfg = evaluator.cfg
    evaluator.load(params)
    n_calib = min(8, len(train_ds) - len(train_ds) % 2)
    batches = [stack_examples([frame_to_example(train_ds[i], cfg),
                               frame_to_example(train_ds[i + 1], cfg)])
               for i in range(0, n_calib, 2)]
    quant = calibrate(cfg, evaluator.model, batches)
    cfg_q = quant_config(cfg)
    model_q = from_flax({**to_flax(evaluator.model), **quant}, cfg_q,
                        device=evaluator.device)
    r = run_eval(cfg_q, model_q, val_ds, num_points=0,
                 device=evaluator.device)
    return {f"{k}_int8_exact": round(v, 4) for k, v in r.items()
            if "moderate" in k}


def run(cfg: Config, train_ds, val_ds, workdir: str, device="cuda",
        gt_db: Optional[GTDatabase] = None, probe_ds=None,
        eval_every: int = 0, int8_eval: bool = False) -> Dict:
    """Train `cfg` on `train_ds`, evaluate on `val_ds` (and every
    `eval_every` steps on `probe_ds`); writes and returns the results."""
    evaluator = Evaluator(cfg, device)
    curve: list = []
    best = {"score": -1.0, "params": None, "step": None, "kind": None}
    hook = (probe_hook(evaluator, probe_ds, curve, best)
            if eval_every else None)
    state = train(cfg, train_ds, workdir, device=evaluator.device,
                  gt_db=gt_db, eval_hook=hook, eval_every=eval_every)
    results = val_results(evaluator, state, val_ds, best)
    if best["params"] is not None:
        with open(os.path.join(workdir, "eval_curve.json"), "w") as f:
            json.dump(curve, f, indent=2)
    if int8_eval:
        results.update(int8_results(evaluator, raw_params(state), train_ds,
                                    val_ds))
    print(json.dumps(results, indent=2))
    with open(os.path.join(workdir, "generalization.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--train-frames", type=int, default=64)
    p.add_argument("--val-frames", type=int, default=16)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dir-weight", type=float, default=None,
                   help="override LossConfig.dir_weight")
    p.add_argument("--gt-db", action="store_true",
                   help="build a gt-sampling db from the train frames "
                        "and train with gt-sampling on")
    p.add_argument("--image-paste", choices=("on", "off"), default="on",
                   help="camera-consistent image pasting for gt-sampling")
    p.add_argument("--workdir", default="runs/gen")
    p.add_argument("--preset", choices=("base", "fast"), default="base",
                   help="fast = width/depth-cut backbone")
    p.add_argument("--int8-eval", action="store_true",
                   help="also evaluate the final parameters through the "
                        "int8 post-training quantization (dcf_torch.quant)")
    p.add_argument("--ema", type=float, default=0.0,
                   help="params-EMA decay (TrainConfig.ema_decay); "
                        "0 disables")
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate raw+EMA params on the probe split "
                        "(seeds 3000+) every N steps; the best probe "
                        "parameters (max over steps of the min per-class "
                        "exact moderate AP) are also evaluated on val")
    p.add_argument("--probe-frames", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs; cuda without a card raises")
    return p


def main(argv=None) -> Dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = workflow_config(
        multi_scale_config(), steps=args.steps, batch=args.batch,
        lr=args.lr, ema=args.ema, preset=args.preset,
        dir_weight=args.dir_weight, gt_db=args.gt_db,
        image_paste=args.image_paste == "on")
    train_ds = VariedDataset(range(TRAIN_SEEDS,
                                   TRAIN_SEEDS + args.train_frames))
    val_ds = VariedDataset(range(VAL_SEEDS, VAL_SEEDS + args.val_frames))
    probe_ds = VariedDataset(range(PROBE_SEEDS,
                                   PROBE_SEEDS + args.probe_frames))
    gt_db = None
    if args.gt_db:
        gt_db = build_gt_db(train_ds)
        print("gt-db sizes:", {k: len(v) for k, v in gt_db.db.items()},
              flush=True)
    return run(cfg, train_ds, val_ds, args.workdir, device=device,
               gt_db=gt_db, probe_ds=probe_ds, eval_every=args.eval_every,
               int8_eval=args.int8_eval)


if __name__ == "__main__":
    main()
