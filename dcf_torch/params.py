"""Parameters of the port: conversion from and to the JAX package's flax
parameter tree, and a seeded initialisation.

The port's modules carry the flax module names, so a flax path
`a/b/Conv_0/kernel` is the torch parameter `a.b.Conv_0.weight`. Leaves
convert by module type: a conv kernel HWIO -> OIHW, a Dense kernel
[in, out] -> Linear weight [out, in], GroupNorm scale -> weight; raw
parameters (`geo_kernel`, ...) keep their flax layout. The int8 mode's
"quant" collection maps the same way: `quant/a/b/in_amax` is the buffer
`a.b.in_amax` of a `ConvNorm`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from dcf_torch.config import Config
from dcf_torch.device import resolve_device
from dcf_torch.models.detector import ContFuseDetector
from dcf_torch.models.head import PRIOR_BIAS

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flat(tree: Dict, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _to_torch_layout(module: nn.Module, leaf: str, value: np.ndarray
                     ) -> np.ndarray:
    if isinstance(module, nn.Conv2d) and leaf == "kernel":
        return value.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Linear) and leaf == "kernel":
        return value.T
    return value


def load_flax(module: nn.Module, tree: Dict) -> nn.Module:
    """Copy a flax parameter tree (nested dicts of numpy or jax arrays)
    into `module`, whose submodules carry the flax names. Raises unless
    the tree and the module hold exactly the same parameters."""
    own = dict(module.named_parameters())
    seen = set()
    for path, value in _flat(tree).items():
        owner = module
        for name in path[:-1]:
            owner = getattr(owner, name)
        leaf = path[-1]
        if isinstance(owner, (nn.Conv2d, nn.Linear, nn.GroupNorm)):
            name = ".".join(path[:-1] + (_LEAF_TO_TORCH[leaf],))
        else:
            name = ".".join(path)
        if name not in own:
            raise KeyError(f"load_flax: no parameter for {'/'.join(path)}")
        value = _to_torch_layout(owner, leaf, value)
        if tuple(own[name].shape) != value.shape:
            raise ValueError(f"load_flax: {name} has shape "
                             f"{tuple(own[name].shape)}, flax {value.shape}")
        with torch.no_grad():
            own[name].copy_(torch.from_numpy(np.array(value)))
        seen.add(name)
    missing = set(own) - seen
    if missing:
        raise KeyError(f"load_flax: not in the flax tree: {sorted(missing)}")
    return module


def flax_tree(module: nn.Module, values: Optional[Dict] = None) -> Dict:
    """`module`'s parameters as a flax-layout tree of numpy arrays, the
    inverse of `load_flax`; with `values` (parameter name -> tensor, e.g.
    gradients), those tensors in the parameters' places."""
    modules = dict(module.named_modules())
    tree: Dict = {}
    for name, p in module.named_parameters():
        parts = name.split(".")
        owner = modules[".".join(parts[:-1])]
        src = p if values is None else values[name]
        # a copy: on the CPU .numpy() would be a view of the live tensor
        value = src.detach().cpu().numpy().copy()
        if isinstance(owner, nn.Conv2d) and parts[-1] == "weight":
            parts[-1], value = "kernel", value.transpose(2, 3, 1, 0)
        elif isinstance(owner, nn.Linear):
            parts[-1], value = "kernel", value.T
        elif isinstance(owner, nn.GroupNorm) and parts[-1] == "weight":
            parts[-1] = "scale"
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.ascontiguousarray(value)
    return tree


def from_flax(params, cfg: Config, device="cuda") -> ContFuseDetector:
    """The JAX package's variables loaded into a new `ContFuseDetector` on
    `device`: `model.init(...)`'s parameter tree (numpy or jax arrays),
    bare or as {"params": tree}, or {"params": tree, "quant": tree} with
    the calibration of the int8 mode (`dcf.quant.calibrate`)."""
    device = resolve_device(device)
    model = load_flax(ContFuseDetector(cfg), params.get("params", params))
    if "params" in params and "quant" in params:
        quant_from_flax(model, params)
    return model.to(device).eval()


def to_flax(model: ContFuseDetector) -> Dict:
    """The detector's parameters as {"params": flax-layout tree}."""
    return {"params": flax_tree(model)}


def _amax_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: b for n, b in model.named_buffers() if n.endswith("in_amax")}


def quant_from_flax(model: nn.Module, qvars: Dict) -> nn.Module:
    """Copy the JAX package's "quant" collection ({"quant": tree} or the
    tree) into the `in_amax` buffers of `model`'s ConvNorms. Raises unless
    the tree names exactly those buffers."""
    tree = qvars.get("quant", qvars)
    own = _amax_buffers(model)
    seen = set()
    for path, value in _flat(tree).items():
        name = ".".join(path)
        if name not in own:
            raise KeyError(f"quant_from_flax: no buffer for {'/'.join(path)}")
        with torch.no_grad():
            own[name].copy_(torch.from_numpy(
                np.array(value, dtype=np.float32)).reshape(()))
        seen.add(name)
    missing = set(own) - seen
    if missing:
        raise KeyError(f"quant_from_flax: not in the tree: {sorted(missing)}")
    return model


def quant_to_flax(model: nn.Module) -> Dict:
    """The `in_amax` buffers of `model`'s ConvNorms as {"quant": tree}, the
    layout of the JAX package's "quant" collection (float32 scalars)."""
    tree: Dict = {}
    for name, buf in _amax_buffers(model).items():
        parts = name.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = buf.detach().cpu().numpy().copy()
    return {"quant": tree}


def _lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator):
    # flax's lecun_normal: truncated normal (+-2 sigma), variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def init_params(cfg: Config, generator: torch.Generator, device="cuda"
                ) -> ContFuseDetector:
    """A `ContFuseDetector` on `device` with seeded random weights drawn as
    the reference initialises them: lecun-normal kernels, GroupNorm scale
    1 and bias 0, zero biases, and the class-logit bias at the 0.01
    prior. `generator` is a CPU `torch.Generator`."""
    device = resolve_device(device)
    model = ContFuseDetector(cfg)
    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, nn.Conv2d):
                o, i, kh, kw = module.weight.shape
                _lecun_normal_(module.weight, i * kh * kw, generator)
                if module.bias is not None:
                    module.bias.fill_(PRIOR_BIAS if name.endswith("cls")
                                      else 0.0)
            elif isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, module.weight.shape[1],
                               generator)
            elif isinstance(module, nn.GroupNorm):
                module.weight.fill_(1.0)
                module.bias.fill_(0.0)
            if hasattr(module, "geo_kernel"):
                _lecun_normal_(module.geo_kernel, 4, generator)
                _lecun_normal_(module.out_kernel, module.out_kernel.shape[0],
                               generator)
                module.geo_bias.zero_()
                module.out_bias.zero_()
    return model.to(device).eval()


def grads_to_flax(model: ContFuseDetector) -> Dict:
    """The detector's gradients (`.grad` of every parameter) as
    {"params": flax-layout tree}, the layout of `jax.grad` over the JAX
    package's parameters; a parameter without a gradient gives zeros."""
    return {"params": flax_tree(model, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()})}
