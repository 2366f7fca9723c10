"""The port's KITTI AP with the trained weights in the repo
(`runs_r5/gen_r5/checkpoints/ckpt_00008000.msgpack`, the flagship
`multi_scale_config()` after 8,000 steps) against the JAX package's, on
the CPU, at full width, in float32.

Marked `slow` (minutes): tier-1 runs `-m 'not slow'`. Run it with

    JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_ap.py

The checkpoint is read with flax here, in the test; the port reads numpy
arrays (`from_flax`). Frames: the 16 validation seeds 2000-2015 of
scripts/generalization.py (`make_varied_frame`), each package reading
them through its own host path (the image resizes differ by at most one
uint8 level, tests/test_torch_host.py). The JAX side serves on its CPU
twins with exact top-k (the TPU run behind generalization.json used
approx_max_k and dropped fusion pairs: that file is not the reference).
`run_eval` of each package at num_points 0 (exact area under the PR
curve) and 40 (R40), metrics 3d and bev: every AP entry equal within
AP_BOUND. `-s` prints both tables and the seconds each side took.
"""

import dataclasses
import hashlib
import os
import time

import jax
import numpy as np
import pytest
import torch

import dcf.config as jcfg
from dcf.data.synthetic import make_varied_frame as jax_frame
from dcf.eval.evaluate import run_eval as jax_run_eval
from dcf.eval.inference import make_inference_fn as jax_inference_fn
from dcf.models.detector import ContFuseDetector as JaxDetector
import dcf_torch.config as tcfg
from dcf_torch.data.synthetic import make_varied_frame as port_frame
from dcf_torch.eval.evaluate import run_eval
from dcf_torch.eval.inference import make_inference_fn
from dcf_torch.params import from_flax

pytestmark = pytest.mark.slow
torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "runs_r5", "gen_r5", "checkpoints",
                    "ckpt_00008000.msgpack")
SEEDS = range(2000, 2016)
# the same detections give the same AP up to the order of float64 sums
AP_BOUND = 1e-9


def _f32(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="float32"))


class _Memo:
    """Runs each distinct batch once: the num_points 40 evaluation reuses
    the detections of the num_points 0 one."""

    def __init__(self, fn, batch_of):
        self.fn, self.batch_of, self.outputs = fn, batch_of, {}
        self.seconds = 0.0

    def __call__(self, *args):
        key = hashlib.sha1(np.asarray(
            self.batch_of(*args)["points"]).tobytes()).hexdigest()
        if key not in self.outputs:
            t = time.perf_counter()
            self.outputs[key] = jax.block_until_ready(self.fn(*args))
            self.seconds += time.perf_counter() - t
        return self.outputs[key]


@pytest.fixture(scope="module")
def aps():
    import flax.serialization
    with open(CKPT, "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    params = {"params": raw["params"]["params"]}
    jc = jcfg.resolve_platform(_f32(jcfg.multi_scale_config()))
    jc = dataclasses.replace(jc, head=dataclasses.replace(
        jc.head, exact_topk=True))
    tc = _f32(tcfg.multi_scale_config())
    jframes = [jax_frame(frame_id=f"{s:06d}", seed=s) for s in SEEDS]
    tframes = [port_frame(frame_id=f"{s:06d}", seed=s) for s in SEEDS]
    model = JaxDetector(jc)
    jax_infer = _Memo(jax.jit(jax_inference_fn(jc, model)),
                      lambda p, b, pack: b)
    port = from_flax(params, tc, device="cpu")
    port_infer = _Memo(make_inference_fn(tc, port, device="cpu"),
                       lambda b: b)
    out = {}
    for p in (0, 40):
        t = time.perf_counter()
        out[("jax", p)] = jax_run_eval(jc, model, params, jframes,
                                       num_points=p, batch_size=4,
                                       infer_fn=jax_infer)
        out[("jax_s", p)] = time.perf_counter() - t
        t = time.perf_counter()
        out[("port", p)] = run_eval(tc, port, tframes, num_points=p,
                                    batch_size=4, infer=port_infer,
                                    device="cpu")
        out[("port_s", p)] = time.perf_counter() - t
    out["infer_s"] = {"jax": jax_infer.seconds, "port": port_infer.seconds}
    # the port's detections (16 frames in 4 batches, none padded) against
    # the ground truth: the traffic a trained model gives the evaluator
    out["counts"] = (
        sum(int(o["valid"].sum()) for o in port_infer.outputs.values()),
        sum(len(f.names) for f in tframes))
    return out


@pytest.mark.parametrize("num_points", [0, 40])
def test_trained_ap_matches_jax(aps, num_points):
    want, got = aps[("jax", num_points)], aps[("port", num_points)]
    assert got.keys() == want.keys() and len(want) == 18
    print(f"\nnum_points {num_points}: run_eval seconds JAX "
          f"{aps[('jax_s', num_points)]:.1f}, port "
          f"{aps[('port_s', num_points)]:.1f} (inference, first call "
          f"only: JAX {aps['infer_s']['jax']:.1f}, port "
          f"{aps['infer_s']['port']:.1f}); port detections "
          f"{aps['counts'][0]} for {aps['counts'][1]} gt boxes")
    print(f"{'entry':<26} {'JAX':>10} {'port':>10}")
    for key, value in want.items():
        print(f"{key:<26} {value:>10.6f} {got[key]:>10.6f}")
    assert sum(want.values()) > 1.0          # trained: far from zero
    for key, value in want.items():
        assert abs(got[key] - value) <= AP_BOUND, key
