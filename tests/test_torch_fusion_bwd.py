"""The port's fusion backward against autograd and against the JAX
package's `jax.vjp` of its CPU twin.

`fused_fusion_bwd_plain` (the backward kernel's contract) is held to
  - torch autograd through `fused_fusion_plain`: the same products summed
    in other orders, so within the bound of `dcf_torch.ops.fusion.
    fusion_bwd_tolerance` (2 n u sum|terms| for a sum of n float32 terms);
  - `jax.vjp` of `dcf.ops.pallas.fusion_kernel.fused_fusion_reference` on
    the same numpy inputs (float32, the twin the JAX package's CPU tests
    run), within the same bound.
Inputs follow tests/test_torch_fusion.py, quarter-cell lattices included
(many exact distance ties).

Known parity hazards, and how these tests meet them:
  - the relu tie at pre == 0: `jnp.maximum` gives the gradient 0.5 there,
    `torch.clamp(min=0)` 1, `torch.relu` and the TPU kernel 0; the port
    follows the kernel (`pre > 0`). The inputs here hold no exact zero:
    each test counts the pre-activations within 1e-6 of 0 and requires
    none, so the three rules cannot disagree;
  - d_z1 precision: the JAX package's bf16 z1 table scatters d_z1 through
    a bf16 gather transpose, where the port and the Pallas kernel
    accumulate in float32; gradient parity is therefore held in float32
    (here z1 is float32 on both sides).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcf.ops.knn as jknn
import dcf.ops.pallas.fusion_kernel as jfk
import dcf_torch.ops.fusion as tfk

torch.set_num_threads(1)

ORIGIN, CELL = (0.0, 0.0), 1.0


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _bins(pts, mask, H, W, cap):
    return jax.vmap(lambda p, m: jknn.bin_points_dense(
        p, m, ORIGIN, CELL, (H, W), cap))(pts, mask)


@functools.partial(jax.jit, static_argnums=(5,))
def _jax_vjp(bins, z1, wgt, bg, dout, k):
    """The twin's output and its vjp at `dout` (jitted: eager dispatch of
    the twin's KNN costs seconds)."""
    def ref(z1, wgt, bg):
        return jfk.fused_fusion_reference(bins, z1, wgt, bg[:, None], ORIGIN,
                                          CELL, k, radius_cells=1)
    out, vjp = jax.vjp(ref, z1, wgt, bg)
    return out, vjp(dout)


def _case(seed, lattice, B=2, H=12, W=20, cap=4, k=3, hid=8, P=400):
    """Inputs on a 1 m grid, as tests/test_torch_fusion.py builds them,
    plus a cotangent for every output channel."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((B, P, 4), np.float32)
    if lattice:
        pts[..., 0] = rng.integers(0, 4 * H, (B, P)) / 4 + 0.125
        pts[..., 1] = rng.integers(0, 4 * W, (B, P)) / 4 + 0.125
    else:
        pts[..., 0] = rng.uniform(-1, H + 1, (B, P))
        pts[..., 1] = rng.uniform(-1, W + 1, (B, P))
    pts[..., 2] = rng.uniform(-2, 2, (B, P))
    pts[..., 3] = np.arange(P)
    mask = rng.uniform(size=(B, P)) < 0.9
    jb = _bins(jnp.asarray(pts), jnp.asarray(mask), H, W, cap)
    arrays = {
        "z1": rng.normal(size=(B, P, hid)).astype(np.float32),
        "wgt": (rng.normal(size=(hid, 4)) * 0.3).astype(np.float32),
        "bg": (rng.normal(size=(hid,)) * 0.1).astype(np.float32),
        "dout": rng.normal(size=(B, H, W, hid + 1)).astype(np.float32)}
    data = tfk.quantize_payload_xyz(torch.tensor(np.asarray(jb.data)),
                                    ORIGIN, CELL)
    return jb, data, torch.tensor(np.asarray(jb.valid)), arrays, k


def _torch(arrays, grad=False):
    return {n: torch.tensor(v, requires_grad=grad and n != "dout")
            for n, v in arrays.items()}


def _pre_ties(stash, t):
    """Pre-activations of selected pairs within 1e-6 of 0."""
    sel, geo = stash
    B, P = t["z1"].shape[:2]
    b = torch.arange(B)[:, None, None, None]
    ok = sel >= 0
    rows = (b * P + sel.long())[ok]
    g = geo[ok]
    pre = t["z1"].reshape(B * P, -1)[rows] + (g @ t["wgt"].t() + t["bg"])
    return int((pre.abs() < 1e-6).sum())


def _assert_within(got, want, tol, what):
    err = (got - want).abs()
    assert bool((err <= tol).all()), (
        f"{what}: max|err| {err.max().item()}, worst excess "
        f"{(err - tol).max().item()}")


def _plain_grads(data, valid, t, k):
    out, stash = tfk.fused_fusion_plain(data, valid, t["z1"], t["wgt"],
                                        t["bg"], ORIGIN, CELL, k, 1,
                                        stash=True)
    dacc = t["dout"][..., :-1]
    return out, stash, tfk.fused_fusion_bwd_plain(
        stash, t["z1"], t["wgt"], t["bg"], dacc)


@pytest.mark.parametrize("seed,lattice,k", [(0, False, 3), (1, False, 1),
                                            (4, True, 3), (5, True, 8)])
def test_bwd_plain_matches_autograd_through_plain_forward(seed, lattice, k):
    _, data, valid, arrays, _ = _case(seed, lattice, k=k)
    t = _torch(arrays)
    _, stash, got = _plain_grads(data, valid, t, k)
    assert _pre_ties(stash, t) == 0
    g = _torch(arrays, grad=True)
    out = tfk.fused_fusion_plain(data, valid, g["z1"], g["wgt"], g["bg"],
                                 ORIGIN, CELL, k, 1)
    (out * g["dout"]).sum().backward()
    tols = tfk.fusion_bwd_tolerance(stash, t["z1"], t["wgt"], t["bg"],
                                t["dout"][..., :-1])
    for name, gv, want, tol in zip(("d_z1", "d_wgt", "d_bg"), got,
                                   (g["z1"].grad, g["wgt"].grad,
                                    g["bg"].grad), tols):
        assert gv.shape == want.shape
        _assert_within(gv, want, tol, name)
    assert got[0].abs().sum() > 0 and got[1].abs().sum() > 0


@pytest.mark.parametrize("seed,lattice,k", [(0, False, 3), (2, True, 4),
                                            (3, True, 8)])
def test_bwd_plain_matches_jax_vjp_of_reference(seed, lattice, k):
    jb, data, valid, arrays, _ = _case(seed, lattice, k=k)
    t = _torch(arrays)
    out, stash, got = _plain_grads(data, valid, t, k)
    assert _pre_ties(stash, t) == 0
    want_out, want = _jax_vjp(jb, *(jnp.asarray(arrays[n]) for n in (
        "z1", "wgt", "bg", "dout")), k)
    np.testing.assert_array_equal(out[..., -1].numpy(),
                                  np.asarray(want_out)[..., -1])
    tols = tfk.fusion_bwd_tolerance(stash, t["z1"], t["wgt"], t["bg"],
                                t["dout"][..., :-1])
    for name, gv, w, tol in zip(("d_z1", "d_wgt", "d_bg"), got, want, tols):
        _assert_within(gv, torch.tensor(np.asarray(w)), tol, name)


def test_stash_selections():
    """The stash: the selected point index of every (pixel, k) that has a
    neighbour (-1 elsewhere, with zero features), the neighbour count
    equal to the number of selections."""
    _, data, valid, arrays, k = _case(6, True)
    t = _torch(arrays)
    out, (sel, geo) = tfk.fused_fusion_plain(
        data, valid, t["z1"], t["wgt"], t["bg"], ORIGIN, CELL, k, 1,
        stash=True)
    assert sel.dtype == torch.int32 and geo.shape == sel.shape + (4,)
    np.testing.assert_array_equal((sel >= 0).sum(-1).numpy(),
                                  out[..., -1].numpy())
    assert not geo[sel < 0].any()
    assert bool(((sel >= -1) & (sel < t["z1"].shape[1])).all())
    # the stash-free forward is the same forward
    assert torch.equal(out, tfk.fused_fusion_plain(
        data, valid, t["z1"], t["wgt"], t["bg"], ORIGIN, CELL, k, 1))


def test_fused_fusion_function_on_cpu():
    """On CPU tensors `fused_fusion` runs the plain forward and, when
    autograd records, the plain backward through `FusedFusion`; under
    no_grad it builds no graph and writes no stash."""
    _, data, valid, arrays, k = _case(7, False)
    g = _torch(arrays, grad=True)
    launches = (tfk.fused_fusion.launches, tfk.fused_fusion_bwd.launches)
    out = tfk.fused_fusion(data, valid, g["z1"], g["wgt"], g["bg"], ORIGIN,
                           CELL, k, 1)
    assert isinstance(out.grad_fn, tfk.FusedFusion._backward_cls)
    (out * g["dout"]).sum().backward()
    t = _torch(arrays)
    want_out, _, want = _plain_grads(data, valid, t, k)
    assert torch.equal(out.detach(), want_out)
    for p, w in zip((g["z1"], g["wgt"], g["bg"]), want):
        assert torch.equal(p.grad, w)
    with torch.no_grad():
        out = tfk.fused_fusion(data, valid, g["z1"], g["wgt"], g["bg"],
                               ORIGIN, CELL, k, 1)
    assert out.grad_fn is None and torch.equal(out, want_out)
    # plain versions launch nothing
    assert (tfk.fused_fusion.launches,
            tfk.fused_fusion_bwd.launches) == launches


def test_fused_fusion_bwd_rejects_other_devices():
    _, data, valid, arrays, k = _case(0, False)
    t = _torch(arrays)
    _, stash, _ = _plain_grads(data, valid, t, k)
    meta = [x.to("meta") for x in (t["z1"], t["wgt"], t["bg"])]
    with pytest.raises(ValueError):
        tfk.fused_fusion_bwd(tuple(s.to("meta") for s in stash), *meta,
                             t["dout"][..., :-1].to("meta"))
