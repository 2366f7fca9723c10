"""The port's continuous fusion against the JAX package's CPU path.

The JAX side runs as its own tests run it on the CPU: the non-Pallas
twins (`bin_points_dense`, `knn_select_dense`, `fused_fusion_reference`,
the non-Pallas branch of `ContinuousFusionLayer`). Binning, the payload
quantization and the KNN selection are integer/selection logic plus
elementwise float32 arithmetic done in the same order, so they must be
exactly equal, exact distance ties included. The MLP sums differ only in
order (XLA's 4-wide dot against the port's sequential sum) and in the
last ulp of CPU sqrt, hence rtol 1e-5 of the output scale. The fusion
layer runs both frameworks' linear maps: rtol 2e-5.

The CUDA kernel itself is held to the plain version on the card, in
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcf.config as jcfg
import dcf.models.fusion as jfus
import dcf.ops.bilinear as jbil
import dcf.ops.knn as jknn
import dcf.ops.pallas.fusion_kernel as jfk
import dcf_torch.config as tcfg
import dcf_torch.models.fusion as tfus
import dcf_torch.ops.bilinear as tbil
import dcf_torch.ops.fusion as tfk
import dcf_torch.ops.knn as tknn
from dcf_torch.params import load_flax

torch.set_num_threads(1)


def _points(seed, B=2, H=12, W=20, P=400, lattice=False):
    """Payload rows (x, y, z, index) on a 1 m grid with origin 0. With
    `lattice`, x/y sit on a quarter-cell lattice: many candidates are at
    exactly equal distances from a pixel centre, and every quantity is
    exact in float32 (bf16 keeps the offsets too)."""
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
    return pts, mask, rng


def _jbins(pts, mask, H, W, cap):
    return jax.vmap(lambda p, m: jknn.bin_points_dense(
        p, m, (0.0, 0.0), 1.0, (H, W), cap))(jnp.asarray(pts),
                                              jnp.asarray(mask))


@pytest.mark.parametrize("seed,lattice", [(0, False), (1, True)])
def test_bins_and_quantization_equal(seed, lattice):
    pts, mask, _ = _points(seed, lattice=lattice)
    jb = _jbins(pts, mask, 12, 20, 4)
    tb = tknn.bin_points_dense(torch.from_numpy(pts), torch.from_numpy(mask),
                               (0.0, 0.0), 1.0, (12, 20), 4)
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
    jq = jax.vmap(lambda d: jfk.quantize_payload_xyz(d, (0.0, 0.0), 1.0))(
        jb.data)
    tq = tfk.quantize_payload_xyz(tb.data, (0.0, 0.0), 1.0)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("seed,lattice,k", [(0, False, 3), (2, True, 4),
                                            (3, True, 8)])
def test_knn_select_equal(seed, lattice, k):
    pts, mask, _ = _points(seed, lattice=lattice)
    jb = _jbins(pts, mask, 12, 20, 8)
    jn, jv, jd = jax.vmap(lambda b: jknn.knn_select_dense(
        b, (0.0, 0.0), 1.0, k, 1))(jb)
    tn, tv, td = tknn.knn_select_dense(
        tknn.DenseBins(torch.tensor(np.asarray(jb.data)),
                       torch.tensor(np.asarray(jb.valid))),
        (0.0, 0.0), 1.0, k, 1)
    v = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), v)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tn.numpy()[v], np.asarray(jn)[v])


def _fusion_case(seed, lattice, B=2, H=12, W=20, cap=4, k=3, hid=8, P=400):
    pts, mask, rng = _points(seed, B, H, W, P, lattice)
    jb = _jbins(pts, mask, H, W, cap)
    z1 = rng.normal(size=(B, P, hid)).astype(np.float32)
    wgt = (rng.normal(size=(hid, 4)) * 0.3).astype(np.float32)
    bg = (rng.normal(size=(hid,)) * 0.1).astype(np.float32)
    want = np.asarray(jfk.fused_fusion_reference(
        jb, jnp.asarray(z1), jnp.asarray(wgt), jnp.asarray(bg[:, None]),
        (0.0, 0.0), 1.0, k, radius_cells=1))
    data = tfk.quantize_payload_xyz(torch.tensor(np.asarray(jb.data)),
                                    (0.0, 0.0), 1.0)
    args = (data, torch.tensor(np.asarray(jb.valid)),
            torch.from_numpy(z1), torch.from_numpy(wgt), torch.from_numpy(bg),
            (0.0, 0.0), 1.0, k, 1)
    return args, want


@pytest.mark.parametrize("seed,lattice,k", [(0, False, 3), (1, False, 1),
                                            (4, True, 3), (5, True, 8)])
def test_fused_fusion_plain_matches_reference(seed, lattice, k):
    args, want = _fusion_case(seed, lattice, k=k)
    got = tfk.fused_fusion_plain(*args).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., -1], want[..., -1])   # counts
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # on CPU tensors the wrapper IS the plain version
    np.testing.assert_array_equal(tfk.fused_fusion(*args).numpy(), got)


def test_fused_fusion_empty_bins():
    args, want = _fusion_case(6, False)
    args = (args[0], torch.zeros_like(args[1])) + args[2:]
    got = tfk.fused_fusion_plain(*args)
    assert not got.any()


def test_fused_fusion_rejects_other_devices():
    args, _ = _fusion_case(0, False)
    with pytest.raises(ValueError):
        tfk.fused_fusion(*[a.to("meta") if torch.is_tensor(a) else a
                           for a in args])


def test_bilinear_sample_equal():
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(2, 9, 13, 5)).astype(np.float32)
    uv = rng.uniform(-1.5, 14.5, (2, 300, 2)).astype(np.float32)
    uv[:, :4] = [[0, 0], [12, 8], [12, 3.5], [6.25, 8]]     # exact edges
    jo, ji = jax.vmap(jbil.bilinear_sample)(jnp.asarray(feat),
                                            jnp.asarray(uv))
    to, ti = tbil.bilinear_sample(torch.from_numpy(feat), torch.from_numpy(uv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("stride", [4, 16])
def test_fusion_layer_matches_flax(stride):
    """The layer from host-ranked points to its BEV contribution, float32,
    the flax module's non-Pallas branch against the port's."""
    from dcf.data.preprocess import frame_to_example
    from dcf.data.synthetic import make_varied_frame
    cfg_j = jcfg.tiny_config(True)
    cfg_j = dataclasses.replace(cfg_j, backbone=dataclasses.replace(
        cfg_j.backbone, dtype="float32"))
    cfg_t = tcfg.tiny_config(True)
    cfg_t = dataclasses.replace(cfg_t, backbone=dataclasses.replace(
        cfg_t.backbone, dtype="float32"))
    ex = frame_to_example(make_varied_frame(seed=3), cfg_j)
    si = cfg_j.backbone.fusion_strides.index(stride)
    istride = min(2 * stride, 32)
    out_ch = cfg_j.backbone.bev_stage_channels[si]
    img_ch = cfg_j.backbone.image_stage_channels[{4: 0, 8: 1, 16: 2,
                                                  32: 3}[istride]]
    hid = cfg_j.fusion.hidden_dim
    rng = np.random.default_rng(stride)
    feat = rng.normal(size=(1, 96 // istride, 320 // istride, img_ch)
                      ).astype(np.float32)
    pts, mask = ex["points"][None], ex["point_mask"][None]
    uvz, rank = ex["points_uvz"][None], ex["fusion_rank"][None, si]

    def rand(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
    # non-zero biases, so the count * bias term is exercised
    params = {"img_proj": {"kernel": rand(img_ch, hid)},
              "geo_kernel": rand(4, hid), "geo_bias": rand(hid),
              "out_kernel": rand(hid, out_ch), "out_bias": rand(out_ch)}
    layer = jfus.ContinuousFusionLayer(cfg_j, out_ch, stride, istride)
    want = np.asarray(layer.apply(
        {"params": params}, jnp.asarray(pts), jnp.asarray(mask), None,
        jnp.asarray(ex["velo_to_image"][None]), jnp.asarray(feat),
        uvz=jnp.asarray(uvz), rank=jnp.asarray(rank)))
    mod = load_flax(tfus.ContinuousFusionLayer(cfg_t, img_ch, out_ch, stride,
                                               istride), params)
    with torch.no_grad():
        got = mod(torch.from_numpy(pts), torch.from_numpy(uvz),
                  torch.from_numpy(rank), torch.from_numpy(feat)).numpy()
    assert got.shape == want.shape
    assert (rank >= 0).sum() > 0
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())
