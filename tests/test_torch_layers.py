"""The PyTorch port's layers, backbones and head against the flax modules.

Both sides run in float32 on the CPU with the same parameters (the flax
tree loaded with `dcf_torch.params.load_flax`) and the same numpy-seeded
inputs. Tolerances are those of tests/test_oracle_e2e.py (atol 2e-4 x
max|want|, rtol 2e-3): the two frameworks' convolutions and GroupNorm
moments sum in different orders, and flax computes the variance as
E[x^2] - E[x]^2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcf.config as jcfg
import dcf.models.bev_backbone as jbev
import dcf.models.head as jhead
import dcf.models.layers as jlay
import dcf.models.resnet as jres
import dcf_torch.config as tcfg
import dcf_torch.models.bev_backbone as tbev
import dcf_torch.models.head as thead
import dcf_torch.models.layers as tlay
import dcf_torch.models.resnet as tres
from dcf_torch.params import flax_tree, load_flax

torch.set_num_threads(1)


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=2e-3)


def _run(flax_module, torch_module, *inputs, seed=0):
    """Init the flax module, load its params into the torch module, run
    both on the same inputs (numpy, NHWC)."""
    params = flax_module.init(jax.random.key(seed),
                              *[jnp.asarray(x) for x in inputs])
    want = flax_module.apply(params, *[jnp.asarray(x) for x in inputs])
    load_flax(torch_module, jax.device_get(params)["params"])
    with torch.no_grad():
        got = torch_module(*[torch.from_numpy(x) for x in inputs])
    return got, want, params


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kernel,stride,act,hw", [
    (3, 1, True, (12, 10)), (3, 2, False, (12, 10)), (3, 2, True, (11, 9)),
    (2, 1, True, (8, 6)), (1, 1, False, (8, 6)), (1, 2, True, (9, 7))])
def test_conv_norm(kernel, stride, act, hw):
    x = _x((2, *hw, 12))
    got, want, _ = _run(
        jlay.ConvNorm(16, kernel, stride, jnp.float32,
                      act=jax.nn.relu if act else None),
        tlay.ConvNorm(12, 16, kernel, stride, act), x)
    _close(got, want)


@pytest.mark.parametrize("cin,cout,stride,entry", [
    (8, 8, 1, 3), (8, 16, 2, 3), (84, 16, 1, 2)])
def test_basic_block(cin, cout, stride, entry):
    x = _x((1, 10, 12, cin), seed=1)
    got, want, params = _run(
        jlay.BasicBlock(cout, stride, jnp.float32, entry_kernel=entry),
        tlay.BasicBlock(cin, cout, stride, entry), x)
    _close(got, want)
    assert ("ConvNorm_2" in params["params"]) == (cin != cout or stride != 1)


def test_upsample2x():
    x = _x((2, 3, 5, 4))
    np.testing.assert_array_equal(
        tlay.upsample2x(torch.from_numpy(x)).numpy(),
        np.asarray(jlay.upsample2x(jnp.asarray(x))))


def _backbone_cfg(module):
    cfg = getattr(module, "tiny_config")(True).backbone
    return dataclasses.replace(cfg, dtype="float32")


@pytest.mark.parametrize("layout", ["raw", "s2d"])
def test_image_backbone(layout):
    x = np.random.default_rng(2).uniform(size=(1, 32, 48, 3)).astype(
        np.float32)
    if layout == "s2d":
        x = x.reshape(1, 8, 4, 12, 4, 3).transpose(0, 1, 3, 2, 4, 5).reshape(
            1, 8, 12, 48)
    got, want, _ = _run(jres.ImageBackbone(_backbone_cfg(jcfg)),
                        tres.ImageBackbone(_backbone_cfg(tcfg)), x)
    assert sorted(got) == sorted(want) == [4, 8, 16, 32]
    for s in got:
        _close(got[s], want[s])


def test_bev_fpn():
    cfg_t = _backbone_cfg(tcfg)
    chans = dict(zip((2, 4, 8, 16), cfg_t.bev_stage_channels))
    feats = {s: _x((1, 64 // s, 48 // s, c), seed=s) for s, c in chans.items()}
    flax_fpn = jbev.BEVFPN(_backbone_cfg(jcfg))
    params = flax_fpn.init(jax.random.key(3), feats)
    want = flax_fpn.apply(params, feats)
    fpn = load_flax(tbev.BEVFPN(cfg_t, chans),
                    jax.device_get(params)["params"])
    with torch.no_grad():
        got = fpn({s: torch.from_numpy(v) for s, v in feats.items()})
    _close(got, want)


def test_detection_head():
    cfg_j = jcfg.tiny_config(True)
    cfg_j = dataclasses.replace(cfg_j, backbone=_backbone_cfg(jcfg))
    cfg_t = dataclasses.replace(tcfg.tiny_config(True),
                                backbone=_backbone_cfg(tcfg))
    x = _x((1, 8, 6, 32), seed=4)
    got, want, params = _run(jhead.DetectionHead(cfg_j),
                             thead.DetectionHead(cfg_t, 32), x)
    assert sorted(got) == ["cls", "dir", "reg"]
    for k in got:
        _close(got[k], want[k])
    # the round trip through the port's modules is exact
    tree = flax_tree(load_flax(thead.DetectionHead(cfg_t, 32),
                               jax.device_get(params)["params"]))
    flat_j = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_array_equal(np.asarray(v), flat_t[path])


def test_load_flax_rejects_mismatched_tree():
    module = tlay.ConvNorm(4, 8, 3, 1)
    tree = flax_tree(module)
    tree.pop("GroupNorm_0")
    with pytest.raises(KeyError):
        load_flax(tlay.ConvNorm(4, 8, 3, 1), tree)
    tree = flax_tree(module)
    tree["Conv_0"]["kernel"] = np.zeros((3, 3, 4, 7), np.float32)
    with pytest.raises(ValueError):
        load_flax(tlay.ConvNorm(4, 8, 3, 1), tree)
