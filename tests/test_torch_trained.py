"""The port against the JAX package with the trained weights in the repo
(`runs_r5/gen_r5/checkpoints/ckpt_00008000.msgpack`, the flagship
`multi_scale_config()` after 8,000 steps), on the CPU, at full width.

Marked `slow` (about three minutes, 2.6 GiB): tier-1 runs
`-m 'not slow'`. Run it with

    JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_trained.py

The checkpoint is read with flax here, in the test; the port reads
numpy arrays (`from_flax`). Frames: the validation seeds 2000-2001 of
scripts/generalization.py; calibration: its training seeds 1000-1003.
Both packages serve in float32 (the JAX side on its CPU twins, exact
top-k).

- float32: the same detections (valid, classes, order); scores and boxes
  within 1e-4 (the head maps' float32 noise, as tests/test_torch_detector.py).
- calibration: every `in_amax` within relative 1e-5.
- int8: quantization flips a few roundings where the two packages'
  float32 activations differ in the last bits (tests/test_torch_quant.py),
  so detections are matched rather than compared in order: the same
  count, each detection of either side with a same-class one of the
  other at BEV IoU >= 0.7, matched scores within 0.05.
- int8 against float32 in the port: the share of float32 detections
  with a same-class int8 detection at BEV IoU >= 0.7, at least 0.9.
`-s` prints the numbers.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcf.config as jcfg
import dcf.quant as jq
from dcf.data.preprocess import frame_to_example, stack_examples
from dcf.data.synthetic import make_varied_frame
from dcf.models.anchors import generate_anchors
from dcf.models.detector import ContFuseDetector as JaxDetector
from dcf.models.head import decode_and_nms, flatten_predictions
import dcf_torch.config as tcfg
import dcf_torch.quant as tq
from dcf_torch.eval.inference import make_inference_fn
from dcf_torch.geometry.boxes import rotated_iou_bev
from dcf_torch.params import from_flax

pytestmark = pytest.mark.slow
torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "runs_r5", "gen_r5", "checkpoints",
                    "ckpt_00008000.msgpack")


def _f32(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="float32"))


def _frames(cfg, seeds):
    return [stack_examples([frame_to_example(
        make_varied_frame(frame_id=f"{s:06d}", seed=s), cfg)])
        for s in seeds]


def _jax_serve(cfg, variables, batches):
    model = JaxDetector(cfg)
    anchors, classes, *_ = generate_anchors(cfg)

    @jax.jit
    def run(v, b):
        return decode_and_nms(flatten_predictions(model.apply(v, b), cfg),
                              jnp.asarray(anchors), jnp.asarray(classes),
                              cfg)
    return [jax.device_get(run(variables, {k: jnp.asarray(v)
                                           for k, v in b.items()}))
            for b in batches]


@pytest.fixture(scope="module")
def runs():
    import flax.serialization
    with open(CKPT, "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    params = {"params": raw["params"]["params"]}
    cfg = jcfg.resolve_platform(_f32(jcfg.multi_scale_config()))
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, exact_topk=True))
    tc = _f32(tcfg.multi_scale_config())
    val, calib = _frames(cfg, (2000, 2001)), _frames(cfg, range(1000, 1004))
    out = {"jax_f32": _jax_serve(cfg, params, val)}
    model = from_flax(params, tc, device="cpu")
    infer = make_inference_fn(tc, model, device="cpu")
    out["port_f32"] = [{k: v.numpy() for k, v in infer(b).items()}
                       for b in val]
    quant = jax.device_get(jq.calibrate(
        cfg, params, [{k: jnp.asarray(v) for k, v in b.items()}
                      for b in calib]))
    out["jax_quant"], out["port_quant"] = quant, tq.calibrate(tc, model,
                                                              calib)
    out["jax_int8"] = _jax_serve(jq.quant_config(cfg),
                                 {**params, **quant}, val)
    model8 = from_flax({**params, **quant}, tq.quant_config(tc), "cpu")
    infer8 = make_inference_fn(tq.quant_config(tc), model8, device="cpu")
    out["port_int8"] = [{k: v.numpy() for k, v in infer8(b).items()}
                        for b in val]
    return out


def _valid(d):
    v = np.asarray(d["valid"])
    return (np.asarray(d["boxes"])[v], np.asarray(d["scores"])[v],
            np.asarray(d["classes"])[v])


def _matches(got, want, thr=0.7):
    """Per detection of `want`: whether `got` has one of its class at BEV
    IoU >= thr, and the score difference to the best such one."""
    (bg, sg, cg), (bw, sw, cw) = _valid(got), _valid(want)
    if len(bw) == 0:
        return np.zeros(0, bool), np.zeros(0)
    if len(bg) == 0:
        return np.zeros(len(bw), bool), np.zeros(len(bw))
    iou = rotated_iou_bev(torch.from_numpy(bw[:, [0, 1, 3, 4, 6]].copy()),
                          torch.from_numpy(bg[:, [0, 1, 3, 4, 6]].copy())
                          ).numpy()
    iou[cw[:, None] != cg[None, :]] = 0.0
    best = iou.argmax(1)
    return iou.max(1) >= thr, np.abs(sg[best] - sw)


def test_float32_detections_equal(runs):
    for got, want in zip(runs["port_f32"], runs["jax_f32"]):
        v = np.asarray(want["valid"])
        assert v.sum() > 0
        np.testing.assert_array_equal(got["valid"], v)
        np.testing.assert_array_equal(got["classes"][v],
                                      np.asarray(want["classes"])[v])
        ds = np.abs(got["scores"][v] - np.asarray(want["scores"])[v]).max()
        db = np.abs(got["boxes"][v] - np.asarray(want["boxes"])[v]).max()
        print(f"float32: {int(v.sum())} detections equal, scores within "
              f"{ds:.3g}, boxes within {db:.3g}; scores "
              f"{[round(float(s), 4) for s in np.asarray(want['scores'])[v]]}")
        assert ds <= 1e-4 and db <= 1e-4


def test_calibration_matches_jax(runs):
    want = {jax.tree_util.keystr(p): float(v) for p, v in
            jax.tree_util.tree_leaves_with_path(runs["jax_quant"])}
    got = {jax.tree_util.keystr(p): float(v) for p, v in
           jax.tree_util.tree_leaves_with_path(runs["port_quant"])}
    assert got.keys() == want.keys() and len(want) > 40
    rel = max(abs(got[k] - w) / w for k, w in want.items())
    print(f"calibration: {len(want)} in_amax, max relative difference "
          f"{rel:.3g}")
    assert rel <= 1e-5


def test_int8_detections_match_jax(runs):
    for got, want in zip(runs["port_int8"], runs["jax_int8"]):
        n = int(np.asarray(want["valid"]).sum())
        assert n > 0 and int(got["valid"].sum()) == n
        ok_w, ds_w = _matches(got, want)
        ok_g, ds_g = _matches(want, got)
        print(f"int8: {n} detections, all matched at BEV IoU >= 0.7: "
              f"{bool(ok_w.all() and ok_g.all())}, scores within "
              f"{max(ds_w.max(), ds_g.max()):.3g}")
        assert ok_w.all() and ok_g.all()
        assert ds_w.max() <= 0.05 and ds_g.max() <= 0.05


def test_int8_against_float32_in_the_port(runs):
    ok, ds = zip(*(_matches(g, w) for g, w in zip(runs["port_int8"],
                                                   runs["port_f32"])))
    ok, ds = np.concatenate(ok), np.concatenate(ds)
    share = ok.mean()
    print(f"int8 vs float32 (port): {int(ok.sum())} of {len(ok)} float32 "
          f"detections matched at BEV IoU >= 0.7 (share {share:.3f}), "
          f"matched scores within {ds[ok].max():.3g}")
    assert len(ok) > 0 and share >= 0.9
