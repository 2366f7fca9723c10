"""The port's rotated-box clip, decode and NMS against the JAX package.

The plain clip (`dcf_torch.geometry.boxes.rotated_intersection_area`,
the plain version of the CUDA clip kernel) repeats the jnp clip op for
op; the candidate selection is exact, and the areas differ only through
cos/sin (torch's and XLA's differ in the last ulp) and the order of the
shoelace sum: atol 2e-5 x (1 + max|coordinate|)^2, a few ulps of the
largest shoelace term. The interpreted Pallas kernel is held to the
same. NMS, top-k and the post-processing are selection logic and must
agree exactly on the same inputs; decoded boxes get rtol 1e-6 (exp).

The CUDA kernel is held to the plain version on the card, in
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcf.config as jcfg
import dcf.geometry.boxes as jbox
import dcf.models.anchors as janc
import dcf.models.head as jhead
import dcf.ops.nms as jnms
import dcf.ops.pallas.clip_kernel as jclip
from chip_smoke import CLIP_HARD, check_clip_hard
import dcf_torch.config as tcfg
import dcf_torch.geometry.boxes as tbox
import dcf_torch.models.head as thead
import dcf_torch.ops.clip as tclip
import dcf_torch.ops.nms as tnms

torch.set_num_threads(1)

# the JAX side jitted, as the package runs it (eager dispatch of the
# clip's scans costs tens of seconds)
_jarea = jax.jit(jbox.rotated_intersection_area)
_jiou = jax.jit(jbox.rotated_iou_bev)
_jnms = jax.jit(
    lambda iou, s, v: jnms.rotated_nms_parallel(None, s, v, 0.25, 16,
                                                precomputed_iou=iou))

def _random_pairs(seed, n, center=(0.0, 0.0), spread=3.0):
    rng = np.random.default_rng(seed)

    def boxes():
        b = np.zeros((n, 5), np.float32)
        b[:, :2] = rng.uniform(-spread, spread, (n, 2)) + np.array(center)
        b[:, 2:4] = rng.uniform(0.3, 5.0, (n, 2))
        b[:, 4] = rng.uniform(-np.pi, np.pi, n)
        return b
    return boxes(), boxes()


def _tol(a, b):
    return 2e-5 * (1 + max(np.abs(a[:, :2]).max(), np.abs(b[:, :2]).max())
                   + 5.0) ** 2


PAIRS = {"hard": (CLIP_HARD[:, 0], CLIP_HARD[:, 1]),
         "near_origin": _random_pairs(0, 500),
         "at_kitti_range": _random_pairs(1, 500, center=(45.0, -20.0))}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_plain_clip_matches_jnp(case):
    a, b = PAIRS[case]
    want = np.asarray(_jarea(jnp.asarray(a), jnp.asarray(b)))
    got = tclip.rotated_intersection_area_pairs(torch.from_numpy(a),
                                                torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(a, b))


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_plain_clip_matches_interpreted_pallas(case):
    a, b = PAIRS[case]
    want = np.asarray(jclip.rotated_intersection_area_pairs(
        jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = tbox.rotated_intersection_area(torch.from_numpy(a),
                                         torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(a, b))


def test_hard_case_areas():
    got = tbox.rotated_intersection_area(torch.from_numpy(CLIP_HARD[:, 0]),
                                         torch.from_numpy(CLIP_HARD[:, 1]))
    check_clip_hard(got)


def test_rotated_iou_bev_matches_jnp():
    a, b = _random_pairs(2, 40)
    want = np.asarray(_jiou(jnp.asarray(a), jnp.asarray(b)))
    got = tbox.rotated_iou_bev(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_decode_boxes_matches_jnp():
    rng = np.random.default_rng(3)
    anchors = np.zeros((64, 7), np.float32)
    anchors[:, :2] = rng.uniform(0, 60, (64, 2))
    anchors[:, 2:6] = [-1.0, 3.9, 1.6, 1.56]
    anchors[:, 6] = rng.choice([0.0, np.pi / 2], 64)
    deltas = rng.normal(0, 0.3, (64, 7)).astype(np.float32)
    want = np.asarray(jbox.decode_boxes(jnp.asarray(deltas),
                                        jnp.asarray(anchors)))
    got = tbox.decode_boxes(torch.from_numpy(deltas),
                            torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_top_k_tie_order_matches_lax():
    x = np.array([[3, 1, 3, 2, 3, -np.inf, -np.inf, 2]], np.float32)
    want = jax.lax.top_k(jnp.asarray(x), 6)
    got = tnms.top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches_jnp(seed):
    """Clustered boxes (long suppression chains) with tied scores."""
    rng = np.random.default_rng(seed)
    K = 48
    boxes = np.zeros((K, 5), np.float32)
    boxes[:, :2] = rng.uniform(0, 6, (K, 2))
    boxes[:, 2:4] = rng.uniform(1, 3, (K, 2))
    boxes[:, 4] = rng.uniform(-np.pi, np.pi, K)
    scores = rng.choice(np.linspace(0.1, 1, 12), K).astype(np.float32)
    valid = rng.uniform(size=K) < 0.9
    iou = np.array(_jiou(jnp.asarray(boxes), jnp.asarray(boxes)))
    want = _jnms(jnp.asarray(iou), jnp.asarray(scores), jnp.asarray(valid))
    got = tnms.rotated_nms_parallel(torch.from_numpy(iou),
                                    torch.from_numpy(scores),
                                    torch.from_numpy(valid), 0.25, 16)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_and_nms_matches_jax(seed):
    """Post-processing on the same random head outputs (tiny config,
    exact top-k in the reference)."""
    cfg_j = jcfg.tiny_config(with_fusion=False)
    cfg_j = dataclasses.replace(cfg_j, head=dataclasses.replace(
        cfg_j.head, exact_topk=True))
    cfg_t = tcfg.tiny_config(with_fusion=False)
    anchors, classes, *_ = janc.generate_anchors(cfg_j)
    rng = np.random.default_rng(seed)
    N = anchors.shape[0]
    flat = {"cls": rng.normal(-4, 2, (2, N)).astype(np.float32),
            "reg": rng.normal(0, 0.1, (2, N, 7)).astype(np.float32),
            "dir": rng.normal(0, 1, (2, N, 2)).astype(np.float32)}
    want = jax.device_get(jax.jit(
        lambda f, a, c: jhead.decode_and_nms(f, a, c, cfg_j))(
            {k: jnp.asarray(v) for k, v in flat.items()},
            jnp.asarray(anchors), jnp.asarray(classes)))
    got = thead.decode_and_nms(
        {k: torch.from_numpy(v) for k, v in flat.items()},
        torch.from_numpy(anchors), torch.from_numpy(classes), cfg_t)
    v = np.asarray(want["valid"])
    assert v.sum() > 10
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy()[v],
                               np.asarray(want["boxes"])[v], rtol=1e-5,
                               atol=1e-5)
