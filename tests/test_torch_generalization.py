"""The train-and-evaluate workflow (`dcf_torch.tools.generalization`,
the counterpart of `scripts/generalization.py`) on the CPU at
`tiny_config`, driven through its pieces:

  - the same flags as the JAX script but `--resident-batches` (a TPU
    transfer workaround, left out), plus `--device`;
  - the same config overrides and `fast` widths;
  - frames equal to `dcf.data.synthetic.make_varied_frame`'s for the
    same seeds, in the same seed ranges;
  - `run` writes `generalization.json` and `eval_curve.json` with the
    JAX script's keys (APs in [0, 1]);
  - the best parameters are the ones with the highest minimum per-class
    probe AP, copied, never the live model's.

The workflow's run keeps 64 pre-NMS candidates a class (tiny_config:
256): the plain rotated clip of 3 x 256 x 256 NMS pairs a frame, on the
CPU, would take most of this file's time over 15 served batches.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import dcf.data.synthetic as jsyn
from dcf_torch.config import multi_scale_config, tiny_config
from dcf_torch.tools import generalization as gen

torch.set_num_threads(1)
SCRIPT = "scripts/generalization.py"
SPLITS = ("Car", "Pedestrian", "Cyclist")


def _jax_flags():
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, SCRIPT)) as f:
        return set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', f.read()))


def test_flags_are_the_jax_scripts_but_resident_batches():
    ours = {a for action in gen.parser()._actions
            for a in action.option_strings if a.startswith("--")} - {"--help"}
    assert ours == (_jax_flags() - {"--resident-batches"}) | {"--device"}
    d = gen.parser().parse_args([])
    assert (d.steps, d.train_frames, d.val_frames, d.batch, d.lr, d.ema,
            d.eval_every, d.probe_frames, d.preset, d.image_paste,
            d.device) == (1500, 64, 16, 2, 1e-3, 0.0, 0, 8, "base", "on",
                          "cuda")


@pytest.mark.parametrize("steps", [20, 2000])
def test_config_overrides(steps):
    cfg = gen.workflow_config(multi_scale_config(), steps=steps, batch=3,
                              lr=5e-4, ema=0.999, preset="fast",
                              dir_weight=0.5, gt_db=True, image_paste=False)
    t = cfg.train
    assert (t.batch_size, t.num_steps, t.learning_rate, t.warmup_steps,
            t.checkpoint_every, t.log_every, t.ema_decay) == (
        3, steps, 5e-4, min(150, steps // 10), steps, 50, 0.999)
    b = cfg.backbone
    assert (b.bev_stage_channels, b.bev_blocks_per_stage,
            b.image_stage_channels, b.image_blocks_per_stage,
            b.fpn_channels, cfg.head.head_channels) == (
        (48, 96, 144, 192), (1, 1, 2, 2), (48, 96, 192, 320), (1, 1, 2, 2),
        96, 96)
    assert cfg.loss.dir_weight == 0.5
    assert cfg.augment.gt_sampling and not cfg.augment.gt_sample_image_paste
    base = gen.workflow_config(multi_scale_config(), steps=steps)
    assert base.backbone == multi_scale_config().backbone
    assert not base.augment.gt_sampling


@pytest.mark.parametrize("seed", [gen.TRAIN_SEEDS, gen.VAL_SEEDS + 3,
                                  gen.PROBE_SEEDS + 7])
def test_varied_frames_match_jax(seed):
    got = gen.VariedDataset([seed])[0]
    want = jsyn.make_varied_frame(frame_id=f"{seed:06d}", seed=seed)
    assert got.frame_id == want.frame_id == f"{seed:06d}"
    for k in ("points", "image", "boxes", "labels", "difficulty"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (gen.TRAIN_SEEDS, gen.VAL_SEEDS, gen.PROBE_SEEDS) == (1000, 2000,
                                                                3000)


class _State:
    def __init__(self, model, ema):
        self.model, self.ema = model, ema


def test_best_is_the_highest_minimum_and_a_copy():
    model = torch.nn.Linear(1, 1)
    ema = {n: p.detach() + 1 for n, p in model.named_parameters()}
    scripted = iter([(0.2, 0.9, 0.9), (0.3, 0.3, 0.3),    # step 1 raw, ema
                     (0.5, 0.4, 0.6), (0.4, 0.4, 0.4),    # step 2
                     (0.4, 0.6, 0.9), (0.1, 0.1, 0.1)])   # step 3: a tie

    def evaluate(params, dataset, num_points, metrics):
        assert (num_points, metrics) == (0, ("3d",))
        return {f"{c}_3d_moderate": v for c, v in zip(SPLITS,
                                                      next(scripted))}

    curve, best = [], {"score": -1.0, "params": None, "step": None,
                       "kind": None}
    hook = gen.probe_hook(evaluate, None, curve, best)
    for step in (1, 2, 3):
        hook(_State(model, ema), step)
        with torch.no_grad():
            model.weight += 1.0
    assert (best["score"], best["step"], best["kind"]) == (0.4, 2, "raw")
    assert [row["step"] for row in curve] == [1, 2, 3]
    assert curve[1]["ema"] == {"Car": 0.4, "Pedestrian": 0.4, "Cyclist": 0.4}
    # a copy of step 2's weight, not the live (since moved) parameter
    assert torch.equal(best["params"]["weight"] + 1.0 + 1.0, model.weight)


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("gen")
    base = tiny_config()
    base = dataclasses.replace(base, head=dataclasses.replace(
        base.head, pre_nms_top_k=64))
    cfg = gen.workflow_config(base, steps=4, batch=2, ema=0.5, gt_db=True)
    train_ds = gen.VariedDataset(range(gen.TRAIN_SEEDS,
                                       gen.TRAIN_SEEDS + 4))
    val_ds = gen.VariedDataset(range(gen.VAL_SEEDS, gen.VAL_SEEDS + 2))
    probe_ds = gen.VariedDataset(range(gen.PROBE_SEEDS,
                                       gen.PROBE_SEEDS + 2))
    results = gen.run(cfg, train_ds, val_ds, str(workdir), device="cpu",
                      gt_db=gen.build_gt_db(train_ds), probe_ds=probe_ds,
                      eval_every=2, int8_eval=True)
    return workdir, results


def _jax_keys():
    keys = set()
    for tag in ("R40", "exact"):
        keys |= {f"{c}_{m}_{d}_{tag}" for c in SPLITS for m in ("3d", "bev")
                 for d in ("easy", "moderate")}
    keys |= {f"{c}_3d_moderate_{tag}" for c in SPLITS
             for tag in ("ema_exact", "best_exact")}
    keys |= {f"{c}_{m}_moderate_int8_exact" for c in SPLITS
             for m in ("3d", "bev")}
    return keys | {"best_step", "best_kind"}


def test_workflow_writes_the_jax_scripts_files(workflow):
    workdir, results = workflow
    with open(workdir / "generalization.json") as f:
        written = json.load(f)
    assert written == results
    assert set(written) == _jax_keys()
    for k, v in written.items():
        if k not in ("best_step", "best_kind"):
            assert 0.0 <= v <= 1.0, k
    assert written["best_kind"] in ("raw", "ema")
    with open(workdir / "eval_curve.json") as f:
        curve = json.load(f)
    assert [row["step"] for row in curve] == [2, 4]
    assert written["best_step"] in (2, 4)
    for row in curve:
        for kind in ("raw", "ema"):
            assert set(row[kind]) == set(SPLITS)
    assert (workdir / "checkpoints" / "ckpt_00000004.pt").exists()
