"""Seeded weights, made on the card in one call and handed to both the
program and the plain reference.

The scheme is `dcf_torch.params.init_params`'s (commit fab139f):
lecun-normal kernels truncated at two sigma, and a constant for every
other leaf. Which leaves are kernels, with which fan-in, and the
constants are the model family's (`leaf_init`). All random values come
from one `torch.randn` on the device, drawn by a generator seeded with
the run's seed, and are cut into the parameters in the order of the
reference model's `named_parameters`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
from torch import nn

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
_TRUNC = 0.87962566103423978     # std of a unit normal truncated at 2

# (owning module, leaf name, full name, shape) -> ("normal", fan_in) or
# ("const", value)
LeafInit = Callable[[nn.Module, str, str, Tuple[int, ...]],
                    Tuple[str, float]]


def dense_fan_in(module: nn.Module, leaf: str, shape) -> int:
    """The fan-in of a Conv2d's or Linear's weight, else 0."""
    if isinstance(module, nn.Conv2d) and leaf == "weight":
        return shape[1] * shape[2] * shape[3]
    if isinstance(module, nn.Linear) and leaf == "weight":
        return shape[1]
    return 0


def make_weights(ref_model: nn.Module, seed: int, device,
                 leaf_init: LeafInit) -> Dict[str, torch.Tensor]:
    """{parameter name: float32 tensor on `device`} for a detector with
    the reference model's parameter names (the program's are the same)."""
    modules = dict(ref_model.named_modules())
    plan, total = [], 0
    for name, p in ref_model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        kind, arg = leaf_init(modules[owner], leaf, name, tuple(p.shape))
        plan.append((name, tuple(p.shape), kind, arg, total))
        if kind == "normal":
            total += p.numel()
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    noise = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    out = {}
    for name, shape, kind, arg, off in plan:
        n = math.prod(shape)
        if kind == "normal":
            std = math.sqrt(1.0 / arg) / _TRUNC
            out[name] = (noise[off:off + n] * std).reshape(shape)
        else:
            out[name] = torch.full(shape, float(arg), device=device)
    return out


def load(model: nn.Module, weights: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy `weights` into `model`'s parameters; raises unless they name
    exactly its parameters."""
    own = dict(model.named_parameters())
    if set(own) != set(weights):
        raise ValueError(f"weights: {sorted(set(own) ^ set(weights))[:5]} "
                         f"differ between the model and the weights")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(weights[name])
    return model
