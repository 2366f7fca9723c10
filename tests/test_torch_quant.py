"""The port's int8 post-training quantization against the JAX package's.

- The int8 conv of one ConvNorm: the same input and `in_amax` give the
  same int8 operands, the same int32 product (XLA's
  `conv_general_dilated`, recorded where `ConvNorm._int8_conv` calls it)
  and the same dequantized pre-GroupNorm output, bit for bit: rounding
  is half to even in both, every division is a true division, and the
  int32 sums are exact.
- The same holds for every ConvNorm of the tiny int8 detector, each fed
  the activation it meets in the port's forward.
- `calibrate`: each `in_amax` within relative 1e-5 of `dcf.quant`'s (the
  maxima of float32 activations that differ by summation order).
- The whole int8 detector: quantization is discontinuous, so the float32
  noise between the two packages (~1e-5 relative after GroupNorm) flips
  a few roundings by one step, and each flip moves the next layers. The
  head maps are held to a relative L2 distance below 0.75 of the
  distance between JAX's int8 maps and the float32 ones on the same
  weights:
  two independent realizations of the quantization noise would sit near
  sqrt(2) of it, implementations that share every rounding but the
  flipped ones sit below (0.54-0.55 here), and a wrong scale, rounding
  or padding shows up at 1 or more.
- The unfold + `torch._int_mm` product (the card's path) equals the
  float64 plain path on the CPU, exactly.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcf.config as jcfg
import dcf.models.layers as jl
import dcf.quant as jq
from dcf.data.preprocess import frame_to_example, stack_examples
from dcf.data.synthetic import make_frame, make_varied_frame
from dcf.models.detector import ContFuseDetector as JaxDetector
import dcf_torch.config as tcfg
import dcf_torch.models.layers as tl
import dcf_torch.ops.int8 as ti8
import dcf_torch.quant as tq
from dcf_torch.eval.inference import batch_to_device, make_inference_fn
from dcf_torch.params import (from_flax, init_params, load_flax,
                              quant_from_flax, quant_to_flax, to_flax)

torch.set_num_threads(1)


class _Int8Conv(jl.ConvNorm):
    """`dcf.models.layers.ConvNorm._int8_conv` alone: the dequantized
    pre-GroupNorm output of the int8 mode, under the same variable
    names."""

    @fnn.compact
    def __call__(self, x):
        return self._int8_conv(x)


def _flax_int8(monkeypatch, features, kernel, stride, dtype, w, amax, x):
    """(int32 product, dequantized output) of the reference's int8 conv."""
    seen = []
    conv = jax.lax.conv_general_dilated

    def record(*args, **kwargs):
        out = conv(*args, **kwargs)
        seen.append(out)
        return out
    monkeypatch.setattr(jax.lax, "conv_general_dilated", record)
    out = _Int8Conv(features, kernel, stride, dtype).apply(
        {"params": {"Conv_0": {"kernel": w}},
         "quant": {"in_amax": np.float32(amax)}}, jnp.asarray(x))
    monkeypatch.setattr(jax.lax, "conv_general_dilated", conv)
    assert len(seen) == 1 and seen[0].dtype == jnp.int32
    return np.asarray(seen[0]), out


def _port_int8(norm, x):
    xq, wq, s_x, s_w = norm.quantized(x)
    y = ti8.int8_conv2d(xq, wq, norm.stride)
    return y, ti8.dequantize(y, s_x, s_w, x.dtype)


@pytest.mark.parametrize("cin,cout,k,s,dtype,amax", [
    (8, 16, 3, 1, "float32", 2.5), (8, 16, 3, 2, "float32", 1.5),
    (84, 16, 2, 1, "float32", 3.0),     # the BEV entry conv's shape
    (12, 8, 1, 2, "bfloat16", 2.0), (48, 8, 1, 1, "bfloat16", 127.0)])
def test_convnorm_int8_bit_equal(monkeypatch, cin, cout, k, s, dtype, amax):
    """One ConvNorm: int32 product and dequantized output bit-equal. The
    input mixes normal values, values beyond `in_amax` (clipped) and
    exact half steps (amax 127 makes s_x 1: round half to even)."""
    rng = np.random.default_rng(cin + k)
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    x[0, 0, :, 0] = np.arange(11) - 5.5           # half steps
    x[1, 1, 1, :4] = [9.0, -9.0, 300.0, -300.0]    # beyond amax
    w = (rng.normal(size=(k, k, cin, cout)) * 0.2).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x = np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    want_y, want = _flax_int8(monkeypatch, cout, k, s, jdt, w, amax,
                              jnp.asarray(x).astype(jdt))
    norm = tl.ConvNorm(cin, cout, k, s, quant="int8")
    load_flax(norm, {"Conv_0": {"kernel": w},
                     "GroupNorm_0": {"scale": np.ones(cout, np.float32),
                                     "bias": np.zeros(cout, np.float32)}})
    norm.in_amax.fill_(amax)
    with torch.no_grad():
        y, got = _port_int8(norm, torch.from_numpy(x).to(getattr(torch,
                                                                 dtype)))
    np.testing.assert_array_equal(y.numpy(), want_y)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("B,H,W,C,O,k,s", [
    (1, 3, 4, 5, 3, 3, 1),      # 12 rows, depth 45, 3 columns: all padded
    (2, 9, 11, 8, 16, 3, 2), (1, 8, 10, 84, 16, 2, 1),
    (2, 7, 6, 12, 8, 1, 2), (1, 6, 6, 16, 24, 3, 1)])
def test_int_mm_path_equals_plain(B, H, W, C, O, k, s):
    """unfold + torch._int_mm (the card's path, on the CPU here) against
    the float64 conv, over the full int8 range."""
    g = torch.Generator().manual_seed(H * W + C)
    xq = torch.randint(-127, 128, (B, H, W, C), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (O, C, k, k), generator=g).to(torch.int8)
    xq[0, 0, 0] = 127
    wq[0] = 127                 # a column at the largest products
    got = ti8.int8_conv2d_mm(xq, wq, s)
    want = ti8.int8_conv2d_plain(xq, wq, s)
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape == (B, -(-H // s), -(-W // s), O)
    assert torch.equal(got, want)
    assert torch.equal(ti8.int8_conv2d(xq, wq, s), want)   # CPU: plain


def test_int8_conv_rejects_other_devices_and_types():
    xq = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    wq = torch.zeros((8, 8, 3, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        ti8.int8_conv2d(xq.to("meta"), wq.to("meta"), 1)
    with pytest.raises(ValueError):
        ti8.int8_conv2d(xq.float(), wq, 1)


def _f32(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="float32"))


@pytest.fixture(scope="module")
def ref():
    """The tiny multi-scale detector in float32: seeded parameters (the
    port's `init_params`, as a flax tree), the JAX calibration on two
    varied frames, JAX's int8 head maps and the port's float32 ones on
    `make_frame(seed=0)` (tests/test_torch_detector.py holds the port's
    float32 maps to JAX's)."""
    cfg = _f32(jcfg.tiny_config(True))
    tcfg32 = _f32(tcfg.tiny_config(True))
    calib = [stack_examples([frame_to_example(make_varied_frame(seed=s),
                                              cfg)]) for s in (1, 2)]
    batch = stack_examples([frame_to_example(make_frame(seed=0), cfg)])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = init_params(tcfg32, torch.Generator().manual_seed(0), "cpu")
    params = to_flax(model)
    quant = jax.device_get(jq.calibrate(
        cfg, params, [{k: jnp.asarray(v) for k, v in b.items()}
                      for b in calib]))
    int8 = jax.device_get(jax.jit(JaxDetector(jq.quant_config(cfg)).apply)(
        {"params": params["params"], **quant}, jb))
    with torch.no_grad():
        f32 = {k: v.numpy() for k, v in model(
            batch_to_device(batch, "cpu")).items()}
    return {"params": params, "quant": quant, "calib": calib,
            "batch": batch, "int8": int8, "f32": f32, "cfg": tcfg32}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_calibrate_matches_jax(ref):
    model = from_flax(ref["params"], ref["cfg"], device="cpu")
    got = _leaves(tq.calibrate(ref["cfg"], model, ref["calib"]))
    want = _leaves(ref["quant"])
    n_norms = sum(isinstance(m, tl.ConvNorm) for m in model.modules())
    assert got.keys() == want.keys() and len(want) == n_norms == 30
    for key, w in want.items():
        assert got[key].dtype == np.float32 and got[key].shape == ()
        np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)
    # the modes are restored, the maxima stay in the buffers
    assert {m.quant for m in model.modules()
            if isinstance(m, tl.ConvNorm)} == {"off"}
    assert _leaves(quant_to_flax(model)).keys() == want.keys()
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate(ref["cfg"], model, [])
    with pytest.raises(ValueError, match="another configuration"):
        tq.calibrate(tcfg.tiny_config(True), model, ref["calib"])


def test_quant_tree_round_trip(ref):
    """quant_from_flax / quant_to_flax and from_flax with a "quant"
    collection, bit for bit; a tree that misses a ConvNorm is refused."""
    want = _leaves(ref["quant"])
    model = from_flax({"params": ref["params"]["params"], **ref["quant"]},
                      tq.quant_config(ref["cfg"]), device="cpu")
    got = _leaves(quant_to_flax(model))
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w)
    other = init_params(ref["cfg"], torch.Generator().manual_seed(0), "cpu")
    quant_from_flax(other, quant_to_flax(model))
    for key, v in _leaves(quant_to_flax(other)).items():
        np.testing.assert_array_equal(v, want[key])
    tree = jax.tree_util.tree_map(lambda v: v, ref["quant"]["quant"])
    del tree["head"]
    with pytest.raises(KeyError):
        quant_from_flax(other, {"quant": tree})


@pytest.fixture(scope="module")
def port_int8(ref):
    model = from_flax({"params": ref["params"]["params"], **ref["quant"]},
                      tq.quant_config(ref["cfg"]), device="cpu")
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: inputs.__setitem__(name, args[0]))
        for name, m in model.named_modules() if isinstance(m, tl.ConvNorm)]
    with torch.no_grad():
        preds = model(batch_to_device(ref["batch"], "cpu"))
    for h in hooks:
        h.remove()
    return model, preds, inputs


# one ConvNorm of each kind: 1x1 stem, 2x2 s2d entry, 3x3 stride 2, 1x1
# stride-2 residual, FPN lateral and output, head
NORMS = ("image_backbone.ConvNorm_0", "bev_stage0_block0.ConvNorm_0",
         "bev_stage1_block0.ConvNorm_0",
         "image_backbone.BasicBlock_2.ConvNorm_2", "fpn.ConvNorm_1",
         "fpn.ConvNorm_3", "head.ConvNorm_1")


def test_convnorms_of_the_detector_int8_bit_equal(monkeypatch, ref,
                                                  port_int8):
    """ConvNorms of the tiny int8 detector, each fed the activation it met
    in the port's forward: JAX's int32 product and dequantized output."""
    model, _, inputs = port_int8
    modules = dict(model.named_modules())
    assert len(inputs) == 30
    for name in NORMS:
        x = inputs[name]
        norm = modules[name]
        node_p, node_q = ref["params"]["params"], ref["quant"]["quant"]
        for part in name.split("."):
            node_p, node_q = node_p[part], node_q[part]
        want_y, want = _flax_int8(
            monkeypatch, norm.Conv_0.out_channels, norm.kernel, norm.stride,
            jnp.float32, node_p["Conv_0"]["kernel"], node_q["in_amax"],
            x.numpy())
        with torch.no_grad():
            y, got = _port_int8(norm, x)
        np.testing.assert_array_equal(y.numpy(), want_y, err_msg=name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", ["cls", "reg", "dir"])
def test_int8_detector_matches_jax(ref, port_int8, name):
    got = port_int8[1][name].numpy()
    want, f32 = ref["int8"][name], ref["f32"][name]
    assert got.shape == want.shape and np.isfinite(got).all()
    quant_noise = _rel_l2(want, f32)
    assert quant_noise > 1e-3          # int8 really differs from float32
    assert _rel_l2(got, want) < 0.75 * quant_noise


def test_inference_serves_calibrated_int8_only(ref, port_int8):
    cfg8 = tq.quant_config(ref["cfg"])
    dets = make_inference_fn(cfg8, port_int8[0], device="cpu")(ref["batch"])
    assert np.isfinite(dets["boxes"].numpy()).all()
    fresh = init_params(cfg8, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="calibration"):
        make_inference_fn(cfg8, fresh, device="cpu")
    with pytest.raises(ValueError, match="quant_mode"):
        make_inference_fn(ref["cfg"], port_int8[0], device="cpu")
    assert to_flax(fresh)["params"].keys() == ref["params"]["params"].keys()
