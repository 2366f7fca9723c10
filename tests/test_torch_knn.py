"""The port's KNN search (`dcf_torch.ops.knn`) against the JAX package.

Binning and selection are integer / selection logic plus elementwise
float32 arithmetic done in the same order, so the port must equal the
reference exactly: indices, validity, distances and payloads, with
exactly equal distances included (quarter-cell lattices put many
candidates at one distance from a pixel centre). Among equal distances
both pick the earlier-scanned candidate: window row-major, then bin
slot (`argmin`'s first minimum in `knn_select_dense`, `lax.top_k`'s
lower index in `knn_query_grid`). The JAX side runs eagerly, op by op:
under `jax.jit`, XLA's CPU backend contracts `ddx * ddx + ddy * ddy`
into a fused multiply-add, which differs in the last bit.

The TPU kernel (`knn_select_pallas`, run in interpret mode as
tests/test_pallas.py runs it) scans bin slot first, so it is compared on
tie-free random points only; `test_tpu_kernel_tie_order_differs` shows
where the two orders part.

The CUDA kernel behind `knn_select_dense` is held to the plain version on
the card, in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcf.ops.knn as jknn
import dcf_torch.ops.knn as tknn

torch.set_num_threads(1)

H, W = 12, 20


def _points(seed, P=500, lattice=False, D=4):
    """[P, D] rows (x, y, z, index) over an H x W grid of 1 m cells at
    origin 0, some outside it; with `lattice`, x / y on a quarter-cell
    lattice (exact in float32, many equal distances)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((P, D), np.float32)
    if lattice:
        pts[:, 0] = rng.integers(-4, 4 * H + 4, P) / 4 + 0.125
        pts[:, 1] = rng.integers(-4, 4 * W + 4, P) / 4 + 0.125
    else:
        pts[:, 0] = rng.uniform(-1, H + 1, P)
        pts[:, 1] = rng.uniform(-1, W + 1, P)
    pts[:, 2] = rng.uniform(-2, 2, P)
    pts[:, 3] = np.arange(P)
    mask = rng.uniform(size=P) < 0.9
    return pts, mask


@pytest.mark.parametrize("seed,lattice,k,r", [
    (0, False, 1, 1), (1, False, 4, 1), (2, False, 3, 2),
    (3, True, 4, 1), (4, True, 8, 1), (5, True, 2, 2), (6, True, 4, 0)])
def test_knn_select_dense_equal(seed, lattice, k, r):
    pts, mask = _points(seed, lattice=lattice)
    jb = jknn.bin_points_dense(jnp.asarray(pts), jnp.asarray(mask),
                               (0.0, 0.0), 1.0, (H, W), 8)
    data, valid = np.array(jb.data), np.array(jb.valid)
    jn, jv, jd = (np.asarray(a) for a in jknn.knn_select_dense(
        jb, (0.0, 0.0), 1.0, k, r))
    bins = tknn.DenseBins(torch.from_numpy(data)[None],
                          torch.from_numpy(valid)[None])
    tn, tv, td = tknn.knn_select_dense(bins, (0.0, 0.0), 1.0, k, r)
    np.testing.assert_array_equal(tv[0].numpy(), jv)
    np.testing.assert_array_equal(td[0].numpy(), jd)
    np.testing.assert_array_equal(tn[0].numpy()[jv], jn[jv])
    if lattice:     # the case is only worth its name with real ties
        d = td[0].numpy()
        assert (d[..., 1:] == d[..., :-1])[jv[..., 1:]].sum() > 50
    # on a CPU tensor the entry point IS the plain version
    for a, b in zip((tn, tv, td), tknn.knn_select_plain(bins, (0.0, 0.0),
                                                        1.0, k, r)):
        assert torch.equal(a, b)


def test_knn_select_dense_batched_and_empty():
    """A batch of two frames, one with no valid point: each frame as
    alone, and the empty one with no neighbour and inf distances."""
    pts, mask = _points(7)
    one = tknn.bin_points_dense(torch.from_numpy(pts)[None],
                                torch.from_numpy(mask)[None],
                                (0.0, 0.0), 1.0, (H, W), 4)
    none = np.zeros_like(mask)
    two = tknn.bin_points_dense(torch.from_numpy(np.stack([pts, pts])),
                                torch.from_numpy(np.stack([mask, none])),
                                (0.0, 0.0), 1.0, (H, W), 4)
    n1, v1, d1 = tknn.knn_select_dense(one, (0.0, 0.0), 1.0, 3)
    n2, v2, d2 = tknn.knn_select_dense(two, (0.0, 0.0), 1.0, 3)
    assert torch.equal(v2[:1], v1) and torch.equal(d2[:1], d1)
    assert torch.equal(n2[:1][v1], n1[v1])
    assert not v2[1].any() and torch.isinf(d2[1]).all()


def test_knn_select_dense_rejects_other_devices():
    pts, mask = _points(8)
    bins = tknn.bin_points_dense(torch.from_numpy(pts)[None],
                                 torch.from_numpy(mask)[None],
                                 (0.0, 0.0), 1.0, (H, W), 4)
    with pytest.raises(ValueError):
        tknn.knn_select_dense(tknn.DenseBins(*(t.to("meta") for t in bins)),
                              (0.0, 0.0), 1.0, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_tpu_kernel_without_ties(seed):
    """The TPU kernel in interpret mode, at tests/test_pallas.py's 8 x 128
    shapes, on uniform random points (no equal distances): the same
    selections; distances within rtol 1e-6, tests/test_pallas.py's
    tolerance, because the kernel runs under `jax.jit`, where the CPU
    backend fuses the distance's multiply-add (1 ulp)."""
    from dcf.ops.pallas.knn_kernel import knn_select_pallas
    rng = np.random.default_rng(seed)
    h, w, P = 8, 128, 300
    pts = np.zeros((P, 4), np.float32)
    pts[:, 0] = rng.uniform(0, h, P)
    pts[:, 1] = rng.uniform(0, w, P)
    pts[:, 2] = rng.uniform(-2, 2, P)
    pts[:, 3] = np.arange(P)
    mask = rng.uniform(size=P) < 0.9
    jb = jknn.bin_points_dense(jnp.asarray(pts), jnp.asarray(mask),
                               (0.0, 0.0), 1.0, (h, w), 4)
    pn, pv, pd = (np.asarray(a) for a in knn_select_pallas(
        jb, (0.0, 0.0), 1.0, 3, 1, tile_rows=8, interpret=True))
    tn, tv, td = tknn.knn_select_dense(
        tknn.DenseBins(torch.tensor(np.asarray(jb.data))[None],
                       torch.tensor(np.asarray(jb.valid))[None]),
        (0.0, 0.0), 1.0, 3, 1)
    np.testing.assert_array_equal(tv[0].numpy(), pv)
    np.testing.assert_allclose(td[0].numpy(), pd, rtol=1e-6)
    np.testing.assert_array_equal(tn[0].numpy()[pv], pn[pv])


def test_tpu_kernel_tie_order_differs():
    """Two points of one bin at the same distance from a pixel centre, the
    earlier one in a later window cell: the port (window first) and the
    TPU kernel (slot first) keep different ones at K = 1. Pixel (1, 1) of
    a 2 x 128 grid, centre (1.5, 1.5): point 0 at (2.25, 1.5) sits in
    cell (2, 1) and slot 0 there; point 1 at (1.5, 0.75) in cell (1, 0)
    slot 1, after a filler in slot 0 (filler farther away)."""
    from dcf.ops.pallas.knn_kernel import knn_select_pallas
    pts = np.array([[2.25, 1.5, 0, 0], [1.5, 0.75, 0, 1],
                    [1.05, 0.05, 0, 2]], np.float32)
    order = [2, 1, 0]               # arrival order fixes the slots
    jb = jknn.bin_points_dense(jnp.asarray(pts[order]),
                               jnp.ones(3, bool), (0.0, 0.0), 1.0, (3, 128),
                               2)
    pn, pv, _ = knn_select_pallas(jb, (0.0, 0.0), 1.0, 1, 1, tile_rows=8,
                                  interpret=True)
    tn, tv, _ = tknn.knn_select_dense(
        tknn.DenseBins(torch.tensor(np.asarray(jb.data))[None],
                       torch.tensor(np.asarray(jb.valid))[None]),
        (0.0, 0.0), 1.0, 1, 1)
    assert bool(tv[0, 1, 1, 0]) and bool(np.asarray(pv)[1, 1, 0])
    assert tn[0, 1, 1, 0, 3] == 1.0           # window (1, 0) before (2, 1)
    assert np.asarray(pn)[1, 1, 0, 3] == 0.0  # slot 0 before slot 1


def _jax_table(pts, mask, cap):
    return jknn.bin_points(jnp.asarray(pts[:, :2]), jnp.asarray(mask),
                           (0.0, 0.0), 1.0, (H, W), cap)


@pytest.mark.parametrize("seed,lattice,cap", [(0, False, 4), (1, True, 2),
                                              (2, True, 8)])
def test_bin_points_equal(seed, lattice, cap):
    pts, mask = _points(seed, P=700, lattice=lattice)
    jt = _jax_table(pts, mask, cap)
    tt = tknn.bin_points(torch.from_numpy(pts[:, :2]), torch.from_numpy(mask),
                         (0.0, 0.0), 1.0, (H, W), cap)
    assert tt.shape == jt.shape == (H, W)
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
    np.testing.assert_array_equal(tt.indices.numpy(), np.asarray(jt.indices))
    if cap <= 4:    # 700 points in 240 cells: some bins overflow
        kept = int(tt.valid.sum())
        inside = ((pts[:, 0] >= 0) & (pts[:, 0] < H) & (pts[:, 1] >= 0)
                  & (pts[:, 1] < W) & mask).sum()
        assert kept < inside


@pytest.mark.parametrize("seed,lattice,cap,k,r", [
    (0, False, 4, 3, 1), (1, True, 2, 4, 1), (2, True, 8, 5, 2),
    (3, True, 4, 2, 0)])
def test_knn_query_grid_equal(seed, lattice, cap, k, r):
    pts, mask = _points(seed, P=700, lattice=lattice)
    xy = pts[:, :2]
    ji, jv, jd = (np.asarray(a) for a in jknn.knn_query_grid(
        _jax_table(pts, mask, cap), jnp.asarray(xy), (0.0, 0.0), 1.0, k, r))
    tt = tknn.bin_points(torch.from_numpy(xy), torch.from_numpy(mask),
                         (0.0, 0.0), 1.0, (H, W), cap)
    ti, tv, td = tknn.knn_query_grid(tt, torch.from_numpy(xy), (0.0, 0.0),
                                     1.0, k, r)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(ti.numpy(), ji)
    if lattice:
        assert (jd[:, 1:] == jd[:, :-1])[jv[:, 1:]].sum() > 50
