"""int8 x int8 -> int32 convolutions: the arithmetic of the int8 serving
mode (`BackboneConfig.quant_mode == "int8"`), after
`dcf.models.layers.ConvNorm._int8_conv`.

  s_x = max(in_amax, 1e-6) / 127              per tensor (calibrated)
  xq  = clip(round(x / s_x), -127, 127)       int8, round half to even
  s_w = max(max|w| over (kh, kw, cin), 1e-12) / 127   per out channel
  wq  = clip(round(w / s_w), -127, 127)       int8
  y   = conv(xq, wq) in int32, XLA "SAME" padding on the int8 tensor
  out = (float32(y) * (s_x * s_w)).to(x's dtype)

Every division is a true division by a tensor on the operand's device:
PyTorch's CUDA `div` by a Python or CPU scalar multiplies by the
reciprocal, which can differ in the last bit.

The JAX package computes the conv with XLA's `conv_general_dilated`,
outside any Pallas kernel, so no hand-written kernel replaces it. On the
card `int8_conv2d` unfolds the int8 input (im2col) and multiplies with
`torch._int_mm` (cuBLASLt, int8 x int8 -> int32), zero-padding the
operands to its shape rules (exact). Its plain version, for CPU tensors,
is a float64 convolution of the integer values: every product and sum is
an integer below 2^53, so it is exact too (float32 is not: 127 * 127 *
576 > 2^24). A float conv never stands in for the int8 one on the card.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

QMAX = 127.0


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b, a true division: b as a tensor on a's device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_activation(x: torch.Tensor, in_amax: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq int8, s_x f32 scalar) of an activation with calibrated max-abs
    `in_amax` (a float32 scalar tensor on x's device)."""
    s_x = _div(torch.clamp(in_amax.to(torch.float32), min=1e-6), QMAX)
    xq = torch.clamp(torch.round(x.to(torch.float32) / s_x), -QMAX, QMAX)
    return xq.to(torch.int8), s_x


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wq int8 [O, I, kh, kw], s_w f32 [O]) of a float32 OIHW kernel,
    one scale per output channel."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=(1, 2, 3))
    s_w = _div(torch.clamp(amax, min=1e-12), QMAX)
    wq = torch.clamp(torch.round(w / s_w[:, None, None, None]), -QMAX, QMAX)
    return wq.to(torch.int8), s_w


def dequantize(y: torch.Tensor, s_x: torch.Tensor, s_w: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """int32 NHWC conv output -> `dtype`: float32(y) * (s_x * s_w)."""
    return (y.to(torch.float32) * (s_x * s_w)).to(dtype)


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(xq: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA "SAME" zero padding of an NHWC tensor, as
    `dcf_torch.models.layers.same_pad` pads its NCHW view."""
    top, bottom = _same_pads(xq.shape[1], k, s)
    left, right = _same_pads(xq.shape[2], k, s)
    if top == bottom == left == right == 0:
        return xq
    return F.pad(xq, (0, 0, left, right, top, bottom))


def _check(xq: torch.Tensor, wq: torch.Tensor) -> None:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() != 4 \
            or wq.dim() != 4 or wq.shape[1] != xq.shape[3] \
            or wq.shape[2] != wq.shape[3] or xq.device != wq.device:
        raise ValueError(
            f"int8_conv2d: wants int8 NHWC xq and int8 OIHW square wq with "
            f"I == C on one device, got {xq.dtype} {tuple(xq.shape)} on "
            f"{xq.device} and {wq.dtype} {tuple(wq.shape)} on {wq.device}")


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def int8_conv2d_mm(xq: torch.Tensor, wq: torch.Tensor, stride: int
                   ) -> torch.Tensor:
    """The card's path on any device: unfold + `torch._int_mm`.
    xq [B, H, W, C] int8 NHWC, wq [O, C, k, k] int8 -> [B, Ho, Wo, O]
    int32."""
    _check(xq, wq)
    O, C, k, _ = wq.shape
    xp = _pad_same(xq, k, stride)
    cols = xp.unfold(1, k, stride).unfold(2, k, stride)  # [B,Ho,Wo,C,k,k]
    B, Ho, Wo = cols.shape[:3]
    M, K = B * Ho * Wo, k * k * C
    # shapes cuBLASLt's int8 product takes: _int_mm asks for rows > 16
    # and depth and columns in multiples of 8; on an H100 (CUDA 12.8)
    # cuBLASLt also refused 32 and 64 columns for every row count tried
    # (17 to 2,200) but multiples of 32. Zero rows and columns add nothing.
    Mp, Kp, Np = _round_up(M, 32), _round_up(K, 8), _round_up(O, 8)
    a = (torch.zeros if (Mp, Kp) != (M, K) else torch.empty)(
        (Mp, Kp), dtype=torch.int8, device=xq.device)
    a[:M, :K].view(B, Ho, Wo, k, k, C).copy_(cols.permute(0, 1, 2, 4, 5, 3))
    b = torch.zeros((Kp, Np), dtype=torch.int8, device=wq.device)
    b[:K, :O] = wq.permute(2, 3, 1, 0).reshape(K, O)
    y = torch._int_mm(a, b)
    return y[:M, :O].reshape(B, Ho, Wo, O)


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int
                      ) -> torch.Tensor:
    """The plain version: a float64 conv of the integer values (exact),
    cuDNN off so that no transform-based algorithm rounds."""
    _check(xq, wq)
    k = wq.shape[2]
    x = _pad_same(xq, k, stride).permute(0, 3, 1, 2).to(torch.float64)
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x, wq.to(torch.float64), stride=stride)
    return y.to(torch.int32).permute(0, 2, 3, 1)


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride: int
                ) -> torch.Tensor:
    """int8 NHWC xq, int8 OIHW wq -> int32 NHWC, "SAME" padding: unfold +
    `torch._int_mm` for CUDA tensors, the plain version for CPU tensors."""
    if xq.device.type == "cpu":
        return int8_conv2d_plain(xq, wq, stride)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv2d: no int8 product for {xq.device}")
    y = int8_conv2d_mm(xq, wq, stride)
    int8_conv2d.launches += 1
    return y


int8_conv2d.launches = 0
