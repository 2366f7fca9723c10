"""The port against the JAX package on the two configurations that the
CLI offers beyond tiny / lidar / full: `camera_config()` (the image
backbone, no fusion) and `fusion_single_scale_config()` (fusion at BEV
stride 4 only), each as a tiny variant (tiny_config's widths, the Car
class only, as the full configs have).

As tests/test_torch_detector.py does for the two configs it covers: the
same flax parameters in both packages (seeded by the port's
`init_params`, read back with `to_flax`; the JAX package's own init
would compile the model once more), float32 compute, the batch the JAX
package builds from `make_frame(seed=0)`; head maps within
tests/test_oracle_e2e.py's tolerances (atol 2e-4 x max|want|, rtol
2e-3), detections equal in order (valid and classes exact, boxes and
scores within 1e-4).
"""

import dataclasses

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
from dcf_torch.cli.common import CONFIGS
from dcf_torch.eval.inference import batch_to_device, make_inference_fn
from dcf_torch.params import from_flax, init_params, to_flax

torch.set_num_threads(1)


def _tiny(m, name):
    """The tiny variant of `camera_config()` / `fusion_single_scale_config()`
    in package `m` (dcf.config or dcf_torch.config), in float32."""
    cfg = m.tiny_config(True)
    full = {"camera": m.camera_config,
            "fusion1": m.fusion_single_scale_config}[name]()
    cfg = dataclasses.replace(
        cfg, anchors=full.anchors, with_camera=full.with_camera,
        with_fusion=full.with_fusion,
        backbone=dataclasses.replace(
            cfg.backbone, dtype="float32",
            fusion_strides=full.backbone.fusion_strides))
    if m is jcfg:
        cfg = dataclasses.replace(cfg, head=dataclasses.replace(
            cfg.head, exact_topk=True))
    return cfg


def _run(name):
    jc, tc = _tiny(jcfg, name), _tiny(tcfg, name)
    batch = stack_examples([frame_to_example(make_frame(seed=0), jc)])
    params = to_flax(init_params(tc, torch.Generator().manual_seed(0),
                                 device="cpu"))
    model = JaxDetector(jc)
    anchors, classes, *_ = generate_anchors(jc)

    @jax.jit
    def run(p, b):
        preds = model.apply(p, b)
        return preds, decode_and_nms(flatten_predictions(preds, jc),
                                     jnp.asarray(anchors),
                                     jnp.asarray(classes), jc)
    preds, dets = jax.device_get(run(params, {k: jnp.asarray(v)
                                              for k, v in batch.items()}))
    port = from_flax(params, tc, device="cpu")
    with torch.no_grad():
        got = port(batch_to_device(batch, "cpu"))
    got_dets = make_inference_fn(tc, port, device="cpu")(batch)
    return preds, dets, got, got_dets


@pytest.fixture(scope="module")
def runs():
    """name -> (JAX maps, JAX detections, port maps, port detections),
    each config run once."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = _run(name)
        return done[name]
    return get


NAMES = ["camera", "fusion1"]


def test_tiny_variants_keep_the_configs_shape():
    for name in NAMES:
        full, tiny = CONFIGS[name](), _tiny(tcfg, name)
        assert tiny.with_camera and tiny.with_fusion == full.with_fusion
        assert len(tiny.anchors) == 1 and tiny.anchors[0].name == "Car"
        assert tiny.backbone.fusion_strides == full.backbone.fusion_strides
    assert _tiny(tcfg, "fusion1").backbone.fusion_strides == (4,)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("head", ["cls", "reg", "dir"])
def test_forward_matches_jax(runs, name, head):
    preds, _, got, _ = runs(name)
    want = np.asarray(preds[head], np.float64)
    g = got[head].numpy().astype(np.float64)
    assert g.shape == want.shape
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(g, want, atol=2e-4 * scale, rtol=2e-3)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("field", ["valid", "classes", "boxes", "scores"])
def test_detections_match_jax(runs, name, field):
    _, want, _, got = runs(name)
    v = np.asarray(want["valid"])
    assert v.sum() > 0
    if field in ("valid", "classes"):
        np.testing.assert_array_equal(got[field].numpy(),
                                      np.asarray(want[field]))
    else:
        np.testing.assert_allclose(got[field].numpy()[v],
                                   np.asarray(want[field])[v], rtol=1e-4,
                                   atol=1e-4)
