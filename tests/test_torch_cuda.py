"""The port's CUDA kernels on the card, held to their plain versions.

Every test here needs an NVIDIA GPU and nvcc, is marked `cuda`, and
skips without a card. The file imports neither JAX nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX.)

Tolerances: the fusion kernel repeats its plain version's operations in
the same order and the library is built without FMA contraction, so it
must agree exactly. The clip kernel does too, except that CUDA's cosf /
sinf and PyTorch's may differ in the last ulp: atol 1e-4 x (1 + area).
Served end to end in float32 (TF32 off), the card and the CPU differ by
cuDNN's and the CPU's summation orders: chip_smoke.py's small-input
reference, at the tolerances of tests/test_oracle_e2e.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dcf_torch.config import multi_scale_config
from dcf_torch.data.preprocess import frame_to_example
from dcf_torch.data.synthetic import make_varied_frame
from dcf_torch.ops import clip, fusion
from dcf_torch.ops.knn import bin_points_dense

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _fusion_args(seed, device, B=2, H=24, W=40, cap=8, k=4, hid=64, P=3000,
                 lattice=False):
    rng = np.random.default_rng(seed)
    pts = np.zeros((B, P, 4), np.float32)
    if lattice:   # quarter-cell lattice: many exactly equal distances
        pts[..., 0] = rng.integers(0, 4 * H, (B, P)) / 4 + 0.125
        pts[..., 1] = rng.integers(0, 4 * W, (B, P)) / 4 + 0.125
    else:
        pts[..., 0] = rng.uniform(-1, H + 1, (B, P))
        pts[..., 1] = rng.uniform(-1, W + 1, (B, P))
    pts[..., 2] = rng.uniform(-2, 2, (B, P))
    pts[..., 3] = np.arange(P)
    mask = rng.uniform(size=(B, P)) < 0.9
    bins = bin_points_dense(torch.from_numpy(pts).to(device),
                            torch.from_numpy(mask).to(device), (0.0, 0.0),
                            1.0, (H, W), cap)
    data = fusion.quantize_payload_xyz(bins.data, (0.0, 0.0), 1.0)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(device)
    return (data.contiguous(), bins.valid.contiguous(),
            t(rng.normal(size=(B, P, hid))), t(rng.normal(size=(hid, 4)) * .3),
            t(rng.normal(size=hid) * .1), (0.0, 0.0), 1.0, k, 1)


@pytest.mark.parametrize("k,lattice", [(1, False), (4, False), (4, True),
                                       (8, True)])
def test_fusion_kernel_matches_plain(card, k, lattice):
    args = _fusion_args(k, card, k=k, lattice=lattice)
    before = fusion.fused_fusion.launches
    got = fusion.fused_fusion(*args)
    assert fusion.fused_fusion.launches == before + 1
    torch.testing.assert_close(got, fusion.fused_fusion_plain(*args),
                               rtol=0, atol=0)


def test_fusion_kernel_main_path_shapes(card):
    """All four scales of one full-size frame (352 x 400 down to 44 x 50
    pixels, K = 4, C = 8, hid = 64), built as chip_smoke.py builds them."""
    cfg = multi_scale_config()
    ex = frame_to_example(make_varied_frame(seed=5), cfg)
    rng = np.random.default_rng(0)
    for _, args in chip_smoke.fusion_inputs(cfg, ex, card, rng):
        got = fusion.fused_fusion(*args)
        assert got[..., -1].sum() > 0
        torch.testing.assert_close(got, fusion.fused_fusion_plain(*args),
                                   rtol=0, atol=0)


def test_fusion_wrapper_rejects_bad_inputs(card):
    args = list(_fusion_args(0, card))
    bad = [(0, args[0].transpose(1, 2)),                # not contiguous
           (2, args[2].to(torch.float64)),              # wrong dtype
           (4, args[4][:-1])]                           # wrong shape
    for i, value in bad:
        with pytest.raises(ValueError):
            fusion.fused_fusion(*(args[:i] + [value] + args[i + 1:]))
    with pytest.raises(ValueError):
        fusion.fused_fusion(*(args[:7] + [9] + args[8:]))   # k > 8


def test_clip_kernel_matches_plain(card):
    a, b = chip_smoke.clip_pairs(card, 20000)
    before = clip.rotated_intersection_area_pairs.launches
    got = clip.rotated_intersection_area_pairs(a, b)
    assert clip.rotated_intersection_area_pairs.launches == before + 1
    want = clip.rotated_intersection_area_pairs_plain(a, b)
    assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all()
    chip_smoke.check_clip_hard(got)
    assert clip.rotated_intersection_area_pairs(a[:0], b[:0]).shape == (0,)


def test_tiny_serving_on_card_matches_cpu(card):
    """tiny_config in float32, card (kernels, 4 + 1 launches) against CPU
    (plain versions): chip_smoke.py's small-input reference."""
    chip_smoke.check_tiny_reference()
