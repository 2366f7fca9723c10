"""The port's CUDA kernels on the card, held to their plain versions.

Every test here needs an NVIDIA GPU and nvcc, is marked `cuda`, and
skips without a card. The file imports neither JAX nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX.)

Tolerances: the fusion kernel repeats its plain version's operations in
the same order and the library is built without FMA contraction, so it
must agree exactly, at every lane count and with the stash. The clip kernel does too, except that CUDA's cosf /
sinf and PyTorch's may differ in the last ulp: atol 1e-4 x (1 + area).
The KNN kernel repeats its plain version's selection in the same scan
order: valid and dist2 exactly, nbr exactly where valid (0 elsewhere),
with exact distance ties, at every lane count. The int8 micro-benchmark
kernel is exact (integer sums); its bf16 twin is within `int8_mma.selection_mma_tolerance`, the bound
for its summation order. The int8
conv's unfold + `torch._int_mm` equals the float64 plain conv exactly.
Served end to end in float32 (TF32 off), the card and the CPU differ by
cuDNN's and the CPU's summation orders: chip_smoke.py's small-input
reference, at the tolerances of tests/test_oracle_e2e.py.

The fusion backward kernel is deterministic (two launches give the same
bits) and sums each point's pairs in pair order, as `index_add_` does
on the CPU, so its d_z1 must equal the plain version run on the CPU
exactly; d_wgt / d_bg, and all three against the plain version on the
card (whose `index_add_` and matmul sum in other orders), are held
within `fusion.fusion_bwd_tolerance` (2 n u sum|terms| for a sum of n
terms); its stash must equal the plain forward's selections exactly. One
tiny float32 train step on the card must agree with the CPU's and give
gradients to `img_proj`, `geo_kernel`, `geo_bias` and the image stem,
whose only path to the loss is that kernel.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dcf_torch.config import multi_scale_config
from dcf_torch.data.preprocess import frame_to_example
from dcf_torch.data.synthetic import make_varied_frame
from dcf_torch.ops import clip, fusion, int8, int8_mma, knn
from dcf_torch.ops.knn import bin_points_dense
from dcf_torch.tools import bench_int8_mma

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


# every K, r = 1 and 2, grids that no tile divides (tiles are 8x16, 8x8
# and 4x8), random points and the quarter-cell lattice's exact ties
@pytest.mark.parametrize("k,lattice,H,W,r", [
    (1, False, 24, 40, 1), (2, True, 7, 9, 1), (3, False, 44, 50, 2),
    (4, False, 24, 40, 1), (4, True, 45, 51, 1), (5, True, 7, 9, 2),
    (6, False, 45, 51, 2), (7, True, 44, 50, 1), (8, True, 45, 51, 2)])
def test_fusion_kernel_matches_plain(card, k, lattice, H, W, r):
    """Bit-equal to the plain version at every lane count, with and
    without the stash."""
    args = list(_fusion_args(k + 10 * r, card, H=H, W=W, k=k,
                             lattice=lattice))
    args[8] = r
    want, (sel, geo) = fusion.fused_fusion_plain(*args, stash=True)
    assert want[..., -1].sum() > 0
    before = fusion.fused_fusion.launches
    got = fusion.fused_fusion(*args)
    assert fusion.fused_fusion.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for lanes in fusion.FWD_TILES:
        got = fusion._forward(*args, stash=False, lanes=lanes)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        got, (s, g) = fusion._forward(*args, stash=True, lanes=lanes)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert torch.equal(s, sel) and torch.equal(g, geo)
    if lattice and k > 1:
        ties = (geo[..., 1:, 3] == geo[..., :-1, 3]) & (sel[..., 1:] >= 0)
        assert int(ties.sum()) > 0


def test_fusion_kernel_all_invalid(card):
    args = list(_fusion_args(0, card, H=45, W=51))
    args[1] = torch.zeros_like(args[1])
    for lanes in fusion.FWD_TILES:
        got, (sel, geo) = fusion._forward(*args, stash=True, lanes=lanes)
        assert not got.any() and (sel == -1).all() and not geo.any()


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


def _bwd_on_card(stash, z1, wgt, bg, dacc):
    """The kernel twice (one launch each, the same bits), its d_z1 equal
    to the plain version on the CPU, and all outputs within bound of the
    plain version on the card. Returns the kernel's outputs."""
    before = fusion.fused_fusion_bwd.launches
    got = fusion.fused_fusion_bwd(stash, z1, wgt, bg, dacc)
    again = fusion.fused_fusion_bwd(stash, z1, wgt, bg, dacc)
    assert fusion.fused_fusion_bwd.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    cpu = fusion.fused_fusion_bwd_plain(
        tuple(t.cpu() for t in stash), z1.cpu(), wgt.cpu(), bg.cpu(),
        dacc.cpu())
    torch.testing.assert_close(got[0].cpu(), cpu[0], rtol=0, atol=0)
    ref = fusion.fused_fusion_bwd_plain(stash, z1, wgt, bg, dacc)
    tols = fusion.fusion_bwd_tolerance(stash, z1, wgt, bg, dacc)
    for a, b, tol in zip(got, ref, tols):
        assert a.shape == b.shape and bool(((a - b).abs() <= tol).all())
    return got


# every K, hid 16 to 256, r = 1 and 2, grids that no tile divides, random
# points and the quarter-cell lattice's exact ties
@pytest.mark.parametrize("k,lattice,hid,H,W,r", [
    (1, False, 64, 24, 40, 1), (4, False, 64, 24, 40, 1),
    (4, True, 16, 24, 40, 1), (8, True, 48, 24, 40, 1),
    (2, True, 128, 7, 9, 2), (3, False, 16, 45, 51, 2),
    (5, True, 64, 45, 51, 1), (6, False, 128, 44, 50, 2),
    (7, False, 256, 24, 40, 1), (8, True, 64, 45, 51, 2)])
def test_fusion_bwd_kernel_matches_plain(card, k, lattice, hid, H, W, r):
    args = list(_fusion_args(10 + k, card, k=k, lattice=lattice, hid=hid,
                             H=H, W=W))
    args[8] = r
    out, stash = fusion._forward(*args, stash=True)
    want, (sel, geo) = fusion.fused_fusion_plain(*args, stash=True)
    assert torch.equal(out, want)
    assert torch.equal(stash[0], sel) and torch.equal(stash[1], geo)
    z1, wgt, bg = args[2:5]
    dout = torch.randn(out.shape, device=card,
                       generator=torch.Generator(card).manual_seed(k))
    dacc = dout[..., :-1]              # a strided view, as autograd gives
    got = _bwd_on_card(stash, z1, wgt, bg, dacc)
    assert got[0].abs().sum() > 0


def test_fusion_bwd_kernel_empty_and_overfull(card):
    """All-invalid stashes give zeros; a stash where every pixel picks
    from 3 points (far more pairs per point than a bucket holds) takes
    the scan and still gives the CPU's d_z1 bit for bit."""
    args = _fusion_args(4, card, H=45, W=51)
    z1, wgt, bg = args[2:5]
    _, (sel, geo) = fusion.fused_fusion_plain(*args, stash=True)
    dacc = torch.randn((2, 45, 51, z1.shape[-1]), device=card,
                       generator=torch.Generator(card).manual_seed(1))
    empty = (torch.full_like(sel, -1), torch.zeros_like(geo))
    got = _bwd_on_card(empty, z1, wgt, bg, dacc)
    assert not any(t.any() for t in got)
    full = (torch.where(sel >= 0, sel % 3, sel), geo)
    assert int((full[0][0] == 0).sum()) > fusion.BWD_BUCKET
    got = _bwd_on_card(full, z1, wgt, bg, dacc)
    assert got[0][:, :3].abs().sum() > 0 and not got[0][:, 3:].any()


def test_fused_fusion_autograd_on_card(card):
    """`fused_fusion` with autograd on CUDA tensors: one forward launch
    (with the stash), one backward launch, the plain version's gradients;
    under no_grad a forward launch alone."""
    args = list(_fusion_args(3, card))
    for i in (2, 3, 4):
        args[i] = args[i].clone().requires_grad_()
    launches = (fusion.fused_fusion.launches,
                fusion.fused_fusion_bwd.launches)
    out = fusion.fused_fusion(*args)
    dout = torch.randn_like(out)
    (out * dout).sum().backward()
    assert (fusion.fused_fusion.launches - launches[0],
            fusion.fused_fusion_bwd.launches - launches[1]) == (1, 1)
    _, stash = fusion.fused_fusion_plain(*args, stash=True)
    plain = [t.detach() for t in args[2:5]]
    ref = fusion.fused_fusion_bwd_plain(stash, *plain, dout[..., :-1])
    tols = fusion.fusion_bwd_tolerance(stash, *plain, dout[..., :-1])
    for p, r, tol in zip(args[2:5], ref, tols):
        assert bool(((p.grad - r).abs() <= tol).all())
    with torch.no_grad():
        assert fusion.fused_fusion(*args).grad_fn is None
    assert fusion.fused_fusion_bwd.launches - launches[1] == 1


def test_tiny_train_step_on_card_matches_cpu(card):
    """chip_smoke.py's small-input training reference: one tiny float32
    train step, card (4 + 4 + 1 launches) against CPU, every gradient leaf,
    and gradients for the parameters behind the fusion backward."""
    chip_smoke.check_tiny_train()


@pytest.mark.parametrize("n", [20000, 129, 1])
def test_clip_kernel_matches_plain(card, n):
    """n pairs (odd counts: a ragged last block), CLIP_HARD among them
    where they fit, and N = 0."""
    a, b = chip_smoke.clip_pairs(card, 20000)
    a, b = a[-n:].contiguous(), b[-n:].contiguous()
    before = clip.rotated_intersection_area_pairs.launches
    got = clip.rotated_intersection_area_pairs(a, b)
    assert clip.rotated_intersection_area_pairs.launches == before + 1
    want = clip.rotated_intersection_area_pairs_plain(a, b)
    assert ((got - want).abs() <= 1e-4 * (1 + want.abs())).all()
    if n >= len(chip_smoke.CLIP_HARD):
        chip_smoke.check_clip_hard(got)
    assert clip.rotated_intersection_area_pairs(a[:0], b[:0]).shape == (0,)


def test_tiny_serving_on_card_matches_cpu(card):
    """tiny_config in float32, card (kernels, 4 + 1 launches) against CPU
    (plain versions): chip_smoke.py's small-input reference."""
    chip_smoke.check_tiny_reference()


def _knn_bins(seed, device, B, H, W, C, D, lattice, frac=0.9):
    """Dense bins of about 0.6 x H x W x C points with D payload columns
    (x, y on a quarter-cell lattice with `lattice`), a fraction `frac`
    of them valid."""
    rng = np.random.default_rng(seed)
    P = max(1, int(0.6 * H * W * C))
    pts = np.zeros((B, P, D), np.float32)
    if lattice:
        pts[..., 0] = rng.integers(-4, 4 * H + 4, (B, P)) / 4 + 0.125
        pts[..., 1] = rng.integers(-4, 4 * W + 4, (B, P)) / 4 + 0.125
    else:
        pts[..., 0] = rng.uniform(-1, H + 1, (B, P))
        pts[..., 1] = rng.uniform(-1, W + 1, (B, P))
    pts[..., 2:] = rng.normal(size=(B, P, D - 2))
    mask = rng.uniform(size=(B, P)) < frac
    bins = bin_points_dense(torch.from_numpy(pts).to(device),
                            torch.from_numpy(mask).to(device), (0.0, 0.0),
                            1.0, (H, W), C)
    return knn.DenseBins(bins.data.contiguous(), bins.valid.contiguous())


def _knn_equal(got, want):
    """ok and dist2 bit for bit, nbr where valid and 0 elsewhere."""
    pn, pv, pd = want
    nbr, ok, d2 = got
    assert torch.equal(ok, pv) and torch.equal(d2, pd)
    assert torch.equal(nbr[pv], pn[pv]) and not nbr[~pv].any()


# every K, r = 0 / 1 / 2, grids that no tile divides, B = 1 and 2,
# C = 4 / 8 / 32, D = 2 / 3 / 4 / 7 / 16, random points and the
# quarter-cell lattice's exact ties; the first five are the main path's
# C = 8, D = 4 on 24 x 40
@pytest.mark.parametrize("k,lattice,r,B,H,W,C,D", [
    (1, False, 1, 2, 24, 40, 8, 4), (4, False, 1, 2, 24, 40, 8, 4),
    (4, True, 1, 2, 24, 40, 8, 4), (8, True, 2, 2, 24, 40, 8, 4),
    (3, True, 0, 2, 24, 40, 8, 4),
    (2, True, 1, 2, 7, 9, 4, 2), (5, False, 2, 1, 45, 51, 32, 7),
    (6, True, 0, 2, 45, 51, 8, 3), (7, True, 1, 1, 7, 9, 32, 4),
    (8, False, 2, 2, 45, 51, 4, 3), (1, True, 2, 1, 45, 51, 8, 7),
    (3, False, 1, 2, 7, 9, 8, 2), (5, True, 2, 2, 45, 51, 32, 16)])
def test_knn_kernel_matches_plain(card, k, lattice, r, B, H, W, C, D):
    """Bit-equal to the plain version with the wrapper's launch shape (one
    launch) and at every lane count whose tile fits."""
    if (B, H, W, C, D) == (2, 24, 40, 8, 4):
        data, valid = _fusion_args(20 + k, card, k=k, lattice=lattice)[:2]
        bins = knn.DenseBins(data, valid)
    else:
        bins = _knn_bins(20 + k, card, B, H, W, C, D, lattice)
    want = knn.knn_select_plain(bins, (0.0, 0.0), 1.0, k, r)
    before = knn.knn_select_dense.launches
    _knn_equal(knn.knn_select_dense(bins, (0.0, 0.0), 1.0, k, r), want)
    assert knn.knn_select_dense.launches == before + 1
    for lanes, (th, tw) in knn.KNN_TILES.items():
        if knn.knn_smem_bytes(th, tw, C, D, k, r) <= knn.SMEM_BYTES:
            _knn_equal(knn._select(bins, (0.0, 0.0), 1.0, k, r, lanes=lanes),
                       want)
    pv, pd = want[1:]
    ties = int(((pd[..., 1:] == pd[..., :-1]) & pv[..., 1:]).sum())
    if lattice and k > 1:
        assert ties > (50 if B * H * W >= 1000 else 0)


def test_knn_kernel_all_invalid_and_empty(card):
    """All-invalid bins: no neighbour, inf distances, zero rows, at every
    lane count; an empty grid: empty results and no launch."""
    bins = _knn_bins(1, card, 2, 45, 51, 8, 4, False, frac=0.0)
    assert not bins.valid.any()
    for lanes in knn.KNN_TILES:
        nbr, ok, d2 = knn._select(bins, (0.0, 0.0), 1.0, 4, 1, lanes=lanes)
        assert not ok.any() and not nbr.any() and bool(torch.isinf(d2).all())
    empty = knn.DenseBins(bins.data[:, :0], bins.valid[:, :0])
    before = knn.knn_select_dense.launches
    nbr, ok, d2 = knn.knn_select_dense(empty, (0.0, 0.0), 1.0, 4, 1)
    assert knn.knn_select_dense.launches == before
    assert (nbr.shape, ok.shape, d2.shape) == ((2, 0, 51, 4, 4), (2, 0, 51, 4),
                                               (2, 0, 51, 4))


def test_knn_wrapper_rejects_beyond_limits(card):
    """k 1-8, C <= 32, 2 <= D <= 16, r <= 3, and the tensors' type and
    layout: beyond them the wrapper raises, it does not fall back."""
    bins = _knn_bins(2, card, 1, 9, 11, 8, 4, False)
    wide = _knn_bins(2, card, 1, 9, 11, 33, 4, False)
    for args in ((bins, 9, 1), (bins, 0, 1), (bins, 4, 4), (bins, 4, -1),
                 (wide, 4, 1), (_knn_bins(2, card, 1, 9, 11, 8, 17, False),
                                4, 1)):
        with pytest.raises(ValueError):
            knn.knn_select_dense(args[0], (0.0, 0.0), 1.0, *args[1:])
    narrow = knn.DenseBins(bins.data[..., :1].contiguous(), bins.valid)
    bad = (knn.DenseBins(bins.data.transpose(1, 2), bins.valid),
           knn.DenseBins(bins.data.double(), bins.valid),
           knn.DenseBins(bins.data, bins.valid[..., :-1]), narrow)
    for b in bad:
        with pytest.raises(ValueError):
            knn.knn_select_dense(b, (0.0, 0.0), 1.0, 4, 1)
    with pytest.raises(ValueError):
        knn._select(bins, (0.0, 0.0), 1.0, 4, 1, lanes=3)


def test_knn_kernel_main_path_shapes(card):
    cfg = multi_scale_config()
    ex = frame_to_example(make_varied_frame(seed=5), cfg)
    rng = np.random.default_rng(0)
    for _, args in chip_smoke.fusion_inputs(cfg, ex, card, rng):
        data, valid, *_, origin, cell, k, r = args
        bins = knn.DenseBins(data, valid)
        got = knn.knn_select_dense(bins, origin, cell, k, r)
        want = knn.knn_select_plain(bins, origin, cell, k, r)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert torch.equal(got[0][want[1]], want[0][want[1]])
        assert got[1].any()


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_selection_mma_kernels_match_plain(card, kind):
    """Both micro-benchmark kernels, on the benchmark's operands and on
    denser ones, at one program, fewer programs than SMs, two per SM
    (the default) and one more than that (the persistent grid's tail)."""
    before = (int8_mma.selection_mma_int8.launches,
              int8_mma.selection_mma_bf16.launches)
    for density in (1 / int8_mma.CAPR, 0.05):
        slab, oh = bench_int8_mma.make_inputs(card, 3, density)[kind]
        for blocks in (1, 131, 264, 265):
            bench_int8_mma.check(kind, slab, oh, blocks)
    after = (int8_mma.selection_mma_int8.launches,
             int8_mma.selection_mma_bf16.launches)
    assert [a - b for a, b in zip(after, before)] == (
        [8, 0] if kind == "int8" else [0, 8])


# the last two: 30 and 48 rows, 32 and 64 columns, which cuBLASLt's int8
# product refuses unpadded
@pytest.mark.parametrize("B,H,W,C,O,k,s", [
    (1, 3, 4, 5, 3, 3, 1), (2, 9, 11, 8, 16, 3, 2), (1, 88, 100, 84, 64, 2, 1),
    (2, 7, 6, 12, 8, 1, 2), (1, 24, 78, 64, 64, 3, 1),
    (1, 6, 20, 24, 32, 1, 2), (1, 4, 12, 8, 64, 1, 1)])
def test_int8_conv_on_card_matches_plain(card, B, H, W, C, O, k, s):
    g = torch.Generator().manual_seed(B * H + C)
    xq = torch.randint(-127, 128, (B, H, W, C), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (O, C, k, k), generator=g).to(torch.int8)
    xq, wq = xq.to(card), wq.to(card)
    before = int8.int8_conv2d.launches
    got = int8.int8_conv2d(xq, wq, s)
    assert int8.int8_conv2d.launches == before + 1
    assert torch.equal(got, int8.int8_conv2d_plain(xq, wq, s))


def _pillar_case(seed, device, n=24576, P=12000, N=100, crowd=0):
    """A cropped cloud at the PointPillars grid (uniform ground, `crowd`
    points stacked in a few cells), its mask, the voxel config, P, N."""
    from dcf_torch.models.pointpillars import pointpillars_config
    vox = pointpillars_config().voxel
    rng = np.random.default_rng(seed)
    pts = np.zeros((1, n, 4), np.float32)
    pts[0, :, 0] = rng.uniform(-1.0, 70.0, n)
    pts[0, :, 1] = rng.uniform(-40.0, 40.0, n)
    pts[0, :, 2] = rng.uniform(-3.5, 1.5, n)
    pts[0, :, 3] = rng.uniform(0.0, 1.0, n)
    if crowd:
        pts[0, :crowd, :2] = rng.uniform(10.0, 10.5, (crowd, 2))
    mask = rng.uniform(size=(1, n)) < 0.85
    return (torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device),
            vox, P, N)


@pytest.mark.parametrize("seed, n, P, N, crowd", [
    (0, 24576, 12000, 100, 0), (1, 24576, 12000, 100, 3000),
    (2, 24576, 4000, 100, 0), (3, 24576, 12000, 8, 2000),
    (4, 5000, 12000, 100, 0), (5, 0, 12000, 100, 0)])
def test_pillar_kernels_match_plain(card, seed, n, P, N, crowd):
    """Pillarize's tables and the PFN's canvas (bf16 and float32) equal
    their plain versions exactly, with either cap binding."""
    from dcf_torch.ops import pillars
    pts, mask, vox, P, N = _pillar_case(seed, card, n, P, N, crowd)
    got = pillars.pillarize(pts, mask, vox, P, N)
    want = pillars.pillarize_plain(pts, mask, vox, P, N)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(9, 64)).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)).to(card)
    for dtype in (torch.bfloat16, torch.float32):
        shape = (1, vox.grid_x, vox.grid_y, 64)
        out = pillars.pfn_scatter(pts, got, w, b, vox,
                                  torch.zeros(shape, dtype=dtype, device=card))
        ref = pillars.pfn_scatter_plain(pts, want, w, b, vox, torch.zeros(
            shape, dtype=dtype, device=card))
        torch.cuda.synchronize()
        assert torch.equal(out, ref), dtype


def test_pillar_wrappers_reject_bad_inputs(card):
    from dcf_torch.ops import pillars
    pts, mask, vox, P, N = _pillar_case(0, card, 1000)
    with pytest.raises(ValueError):
        pillars.pillarize(pts.double(), mask, vox, P, N)
    with pytest.raises(ValueError):
        pillars.pillarize(pts, mask, vox, 60000, N)
    t = pillars.pillarize(pts, mask, vox, P, N)
    w = torch.zeros((9, 48), device=card)
    with pytest.raises(ValueError):
        pillars.pfn_scatter(pts, t, w, torch.zeros(48, device=card), vox,
                            torch.zeros((1, vox.grid_x, vox.grid_y, 48),
                                        device=card))


GRAPH_FRAMES = 5


@pytest.fixture(scope="module")
def graphed_serving():
    """`contfuse-ms` (`multi_scale_config()`, bf16, seeded weights) served
    at B=1 on GRAPH_FRAMES frames through `make_inference_fn`: first with
    the forward held eager, then as served (frame 0 eager, frame 1
    captured, the rest replayed), with the tracer on, hooks on the image
    backbone and each fusion module, and the fusion and clip launches
    counted; every returned head map kept until all frames were served."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from dcf_torch.data.preprocess import stack_examples
    from dcf_torch.eval.inference import make_inference_fn, to_host
    from dcf_torch.params import init_params
    from dcf_torch.utils import trace
    device = torch.device("cuda")
    cfg = multi_scale_config()
    model = init_params(cfg, torch.Generator().manual_seed(1), device=device)
    infer = make_inference_fn(cfg, model, device=device)
    batches = [stack_examples([frame_to_example(
        make_varied_frame(seed=10 + s), cfg)]) for s in range(GRAPH_FRAMES)]
    maps, calls = [], {}

    def count(key):
        def hook(_m, _a, _o):
            calls[key] = calls.get(key, 0) + 1
        return hook
    hooks = [model.register_forward_hook(lambda _m, _a, o: maps.append(o)),
             model.image_backbone.register_forward_hook(
                 count("image_backbone"))]
    hooks += [m.register_forward_hook(count(name))
              for name, m in model.named_children()
              if name.startswith("fusion_s")]

    def served():
        maps.clear()
        calls.clear()
        launches = (fusion.fused_fusion.launches,
                    clip.rotated_intersection_area_pairs.launches)
        trace.reset()
        trace.enable()
        try:
            dets = [to_host(infer(b)) for b in batches]
            counters = trace.snapshot()["counters"]
        finally:
            trace.enable(False)
            trace.reset()
        return {"dets": dets, "maps": list(maps), "counters": counters,
                "calls": dict(calls),
                "fusion_launches": fusion.fused_fusion.launches - launches[0],
                "clip_launches":
                    clip.rotated_intersection_area_pairs.launches
                    - launches[1]}

    try:
        model.replays = lambda inputs: False       # the forward held eager
        try:
            eager = served()
        finally:
            del model.replays
        graphed = served()
    finally:
        for h in hooks:
            h.remove()
    return {"eager": eager, "graphed": graphed, "cfg": cfg}


def test_graph_replay_maps_equal_eager(graphed_serving):
    """Every frame's head maps, read after all frames were served (so a
    map that aliased the graph's outputs would hold the last frame's),
    equal the eager forward's bit for bit."""
    eager, graphed = graphed_serving["eager"], graphed_serving["graphed"]
    assert len(graphed["maps"]) == GRAPH_FRAMES
    for got, want in zip(graphed["maps"], eager["maps"]):
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_graph_replay_detections_equal_eager(graphed_serving):
    eager, graphed = graphed_serving["eager"], graphed_serving["graphed"]
    for got, want in zip(graphed["dets"], eager["dets"]):
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)


def test_graph_counters(graphed_serving):
    """One capture and GRAPH_FRAMES - 2 replayed forwards; the fusion
    layers' device counters as the eager forward counts them."""
    eager = graphed_serving["eager"]["counters"]
    got = graphed_serving["graphed"]["counters"]
    assert got["graph.captures"] == 1
    assert got["graph.forwards"] == GRAPH_FRAMES - 2
    assert "graph.captures" not in eager and "graph.forwards" not in eager
    for k in ("fusion.bin_eligible", "fusion.bin_dropped", "fusion.pairs"):
        assert got[k] == eager[k] > 0, k


def test_graph_replay_launches_and_hooks(graphed_serving):
    """The hand-written fusion kernel still launches once per fusion layer
    a frame (4) and the clip once, and forward hooks on the image backbone
    and on each fusion module fire once a frame."""
    cfg, graphed = graphed_serving["cfg"], graphed_serving["graphed"]
    nf = len(cfg.backbone.fusion_strides)
    assert graphed["fusion_launches"] == nf * GRAPH_FRAMES
    assert graphed["clip_launches"] == GRAPH_FRAMES
    names = ["image_backbone"] + [f"fusion_s{s}"
                                  for s in cfg.backbone.fusion_strides]
    assert graphed["calls"] == {n: GRAPH_FRAMES for n in names}
