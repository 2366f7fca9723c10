"""Shared building blocks for both backbones, mirroring `dcf.models.layers`.

Public layout is NHWC, as in the JAX package. A conv runs on the NCHW
view of the NHWC tensor (`permute`, no copy), which is PyTorch's
channels-last memory format. Submodules carry the flax module names
(`Conv_0`, `GroupNorm_0`, `ConvNorm_1`, ...) so that parameter paths
match the reference's one to one (`dcf_torch.params`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dcf_torch.ops.int8 import (dequantize, int8_conv2d, quantize_activation,
                                quantize_weight)

QUANT_MODES = ("off", "calib", "int8")


def num_groups(channels: int) -> int:
    for g in (32, 16, 8, 4, 2, 1):
        if channels % g == 0:
            return g
    return 1


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA "SAME" padding of an NCHW tensor for kernel k, stride s: the
    low side gets the smaller half."""
    h, w = x.shape[-2:]

    def pads(n):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        return total // 2, total - total // 2

    top, bottom = pads(h)
    left, right = pads(w)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom))


class ConvNorm(nn.Module):
    """Conv (no bias, SAME) -> GroupNorm (eps 1e-6) -> optional relu.

    Runs in the input's dtype; GroupNorm's statistics are computed in
    float32 internally. `quant` is the int8 post-training quantization
    mode of the conv (`dcf_torch.quant`):
      - "off":   the float conv;
      - "calib": the float conv, and the buffer `in_amax` keeps the
                 running max of |x| (the quant collection's `in_amax` of
                 the JAX package);
      - "int8":  x quantized with `in_amax`, the kernel per output
                 channel, an int8 x int8 -> int32 conv
                 (`dcf_torch.ops.int8`), dequantized to x's dtype.
    GroupNorm and the activation are the same in every mode.
    """

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, act: bool = True, quant: str = "off"):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"ConvNorm: quant {quant!r} not in {QUANT_MODES}")
        self.kernel, self.stride, self.act = kernel, stride, act
        self.quant = quant
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, stride,
                                bias=False)
        self.GroupNorm_0 = nn.GroupNorm(num_groups(features), features,
                                        eps=1e-6)
        self.register_buffer("in_amax", torch.zeros((), dtype=torch.float32))

    def quantized(self, x: torch.Tensor):
        """(xq, wq, s_x, s_w): the int8 operands and scales of the conv
        of x (NHWC) in "int8" mode."""
        xq, s_x = quantize_activation(x, self.in_amax)
        wq, s_w = quantize_weight(self.Conv_0.weight)
        return xq, wq, s_x, s_w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == "int8":
            xq, wq, s_x, s_w = self.quantized(x)
            y = dequantize(int8_conv2d(xq, wq, self.stride), s_x, s_w,
                           x.dtype).permute(0, 3, 1, 2)
            if y.device.type == "cpu":
                y = y.contiguous()      # NCHW on the CPU: see below
        else:
            if self.quant == "calib":
                with torch.no_grad():
                    self.in_amax.copy_(torch.maximum(
                        self.in_amax, x.to(torch.float32).abs().amax()))
            y = x.permute(0, 3, 1, 2)
            if y.device.type == "cpu":
                # NCHW on the CPU: PyTorch's channels-last CPU kernels lose
                # float32 precision in GroupNorm's statistics (relative
                # error ~3e-3 at |mean| / std = 60, against ~1e-6 in NCHW)
                # and can corrupt the heap in the multi-threaded backward
                # of a strided 1x1 conv (torch 2.13.0+cpu, 8 -> 16
                # channels)
                y = y.contiguous()
            y = same_pad(y, self.kernel, self.stride)
            y = F.conv2d(y, self.Conv_0.weight.to(x.dtype),
                         stride=self.stride)
        y = F.group_norm(y, self.GroupNorm_0.num_groups,
                         self.GroupNorm_0.weight.to(x.dtype),
                         self.GroupNorm_0.bias.to(x.dtype),
                         self.GroupNorm_0.eps)
        if self.act:
            y = F.relu(y)
        return y.permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    """ResNet-v1 basic block, NHWC. `entry_kernel` sizes the first conv
    only: kernel 2 / stride 1 on a space-to-depth(2) input covers the
    taps of a 3x3 / stride-2 conv on the full-resolution tensor."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 entry_kernel: int = 3, quant: str = "off"):
        super().__init__()
        self.ConvNorm_0 = ConvNorm(in_features, features, entry_kernel, stride,
                                   quant=quant)
        self.ConvNorm_1 = ConvNorm(features, features, 3, 1, act=False,
                                   quant=quant)
        if in_features != features or stride != 1:
            self.ConvNorm_2 = ConvNorm(in_features, features, 1, stride,
                                       act=False, quant=quant)
        else:
            self.ConvNorm_2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvNorm_1(self.ConvNorm_0(x))
        residual = x if self.ConvNorm_2 is None else self.ConvNorm_2(x)
        return F.relu(y + residual)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample (NHWC)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
