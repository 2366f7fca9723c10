"""The port's detector end to end against the JAX package, and the port's
boundaries: parameters, entry points, imports.

One module-scoped JAX reference: the tiny multi-scale detector in
float32 (as tests/test_oracle_e2e.py runs it), its flax parameters, its
head maps and its detections under exact top-k, on the batch the JAX
package builds from `make_frame(seed=0)`. The port loads the same
parameters (`from_flax`) and serves the same batch on the CPU, where
every kernel wrapper takes its plain version. Head maps: the tolerances
of tests/test_oracle_e2e.py (atol 2e-4 x max|want|, rtol 2e-3).
Detections: the same boxes kept, in the same order (valid and classes
exact), boxes and scores to 1e-4 relative (they inherit the maps'
float32 noise).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcf.config as jcfg
from dcf.data.preprocess import frame_to_example, stack_examples
from dcf.data.synthetic import make_frame
from dcf.models.anchors import generate_anchors
from dcf.models.detector import ContFuseDetector as JaxDetector
from dcf.models.head import decode_and_nms, flatten_predictions
import dcf_torch.config as tcfg
from dcf_torch.eval.inference import batch_to_device, make_inference_fn
from dcf_torch.params import from_flax, init_params, to_flax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f32(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="float32"))


def _reference(with_fusion):
    cfg = _f32(jcfg.tiny_config(with_fusion))
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, exact_topk=True))
    batch = stack_examples([frame_to_example(make_frame(seed=0), cfg)])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxDetector(cfg)
    params = jax.jit(model.init)(jax.random.key(0), jb)
    anchors, classes, *_ = generate_anchors(cfg)

    @jax.jit
    def run(p, b):
        preds = model.apply(p, b)
        return preds, decode_and_nms(flatten_predictions(preds, cfg),
                                     jnp.asarray(anchors),
                                     jnp.asarray(classes), cfg)
    preds, dets = jax.device_get(run(params, jb))
    return {"params": jax.device_get(params), "batch": batch,
            "preds": preds, "dets": dets,
            "cfg": _f32(tcfg.tiny_config(with_fusion))}


@pytest.fixture(scope="module")
def fusion_ref():
    return _reference(True)


@pytest.fixture(scope="module")
def fusion_port(fusion_ref):
    model = from_flax(fusion_ref["params"], fusion_ref["cfg"], device="cpu")
    with torch.no_grad():
        preds = model(batch_to_device(fusion_ref["batch"], "cpu"))
    dets = make_inference_fn(fusion_ref["cfg"], model,
                             device="cpu")(fusion_ref["batch"])
    return model, preds, dets


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=2e-3)


def test_param_round_trip_exact(fusion_ref, fusion_port):
    want = jax.tree_util.tree_leaves_with_path(fusion_ref["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(to_flax(fusion_port[0])))
    assert len(want) == len(got)
    for path, v in want:
        np.testing.assert_array_equal(np.asarray(v), got[path])


@pytest.mark.parametrize("name", ["cls", "reg", "dir"])
def test_multi_scale_forward_matches_jax(fusion_ref, fusion_port, name):
    _close(fusion_port[1][name].numpy(), fusion_ref["preds"][name])


@pytest.mark.parametrize("name", ["valid", "classes", "boxes", "scores"])
def test_detections_match_jax(fusion_ref, fusion_port, name):
    got, want = fusion_port[2], fusion_ref["dets"]
    v = np.asarray(want["valid"])
    assert v.sum() > 0
    if name in ("valid", "classes"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    else:
        np.testing.assert_allclose(got[name].numpy()[v],
                                   np.asarray(want[name])[v], rtol=1e-4,
                                   atol=1e-4)


def test_lidar_only_forward_matches_jax():
    ref = _reference(False)
    model = from_flax(ref["params"], ref["cfg"], device="cpu")
    with torch.no_grad():
        preds = model(batch_to_device(ref["batch"], "cpu"))
    for name in ("cls", "reg", "dir"):
        _close(preds[name].numpy(), ref["preds"][name])


def test_init_params_seeded():
    cfg = tcfg.tiny_config(True)
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    kernel = "bev_stage1_block0.ConvNorm_0.Conv_0.weight"
    assert not torch.equal(sa[kernel], sc[kernel])
    # flax's lecun_normal: std 1/sqrt(fan_in), truncated at 2 sigma
    fan_in = sa[kernel][0].numel()
    assert sa[kernel].abs().max() <= 2 / (0.8796 * fan_in ** 0.5) + 1e-6
    assert torch.all(sa["head.cls.bias"] == torch.tensor(-np.log(99.0)))
    assert torch.all(sa["fpn.ConvNorm_0.GroupNorm_0.weight"] == 1)


def test_init_params_draws_the_reference_distribution(fusion_ref):
    """`init_params` and flax's `model.init` draw from one distribution
    with different random streams (a torch.Generator against threefry).
    Same leaves, shapes and dtypes; every non-kernel leaf equal; each
    kernel leaf's std within 10% of the reference's, or within 4 standard
    errors of the ratio of two sample stds (1 / sqrt(n) for n values)
    where a leaf is too small for 10%; and over all kernels, the values
    scaled by sqrt(fan_in) (lecun-normal: unit variance) within 2%."""
    want = dict(jax.tree_util.tree_leaves_with_path(fusion_ref["params"]))
    model = init_params(fusion_ref["cfg"], torch.Generator().manual_seed(0),
                        device="cpu")
    got = dict(jax.tree_util.tree_leaves_with_path(to_flax(model)))
    assert got.keys() == want.keys()
    sums = {"got": 0.0, "want": 0.0}
    n_kernel = 0
    for path, w in want.items():
        w, g = np.asarray(w), got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if jax.tree_util.keystr(path).endswith("kernel']"):
            ratio = g.std() / w.std()
            assert abs(ratio - 1) <= max(0.1, 4 / np.sqrt(w.size)), path
            fan_in = w[..., 0].size     # all axes but the last (flax)
            sums["got"] += float((g.astype(np.float64) ** 2).sum()) * fan_in
            sums["want"] += float((w.astype(np.float64) ** 2).sum()) * fan_in
            n_kernel += w.size
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
    rms = {k: np.sqrt(v / n_kernel) for k, v in sums.items()}
    assert abs(rms["got"] - 1) <= 0.02 and abs(rms["want"] - 1) <= 0.02


def test_entry_points_need_cuda_or_cpu():
    """Entry points default to the card and never fall back silently."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tcfg.tiny_config(True)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, gen)
    model = init_params(cfg, gen, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_inference_fn(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_flax(to_flax(model), cfg)
    make_inference_fn(cfg, model, device="cpu")


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "matplotlib",
            "msgpack", "dcf")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
blocked = set(sys.argv[1].split(","))

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
import dcf_torch
names = [m.name for m in pkgutil.walk_packages(dcf_torch.__path__,
                                               "dcf_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in blocked)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_flax_cv2_pil_or_dcf():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, ",".join(_BLOCKED)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20
