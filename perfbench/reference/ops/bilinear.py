"""Bilinear feature sampling (torch), mirroring `dcf.ops.bilinear`."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def bilinear_sample(feat: torch.Tensor, uv: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample `feat` at continuous pixel locations.

    Args:
      feat: [B, H, W, C] feature maps.
      uv: [B, N, 2] (u = column, v = row) in pixel units of `feat`.

    Returns:
      (values [B, N, C], inside [B, N]): zeros and False outside
      [0, W - 1] x [0, H - 1]. The +1 neighbours of the last row/column
      read zero padding, as the reference's shifted patches do; their
      weight is 0 there. `values` is float32 when `uv` is, whatever the
      feature dtype (the reference's type promotion).
    """
    B, H, W, C = feat.shape
    u = uv[..., 0]
    v = uv[..., 1]
    inside = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u = torch.clamp(u, 0.0, W - 1.0)
    v = torch.clamp(v, 0.0, H - 1.0)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)

    pad = F.pad(feat, (0, 0, 0, 1, 0, 1))                    # [B, H+1, W+1, C]
    bi = torch.arange(B, device=feat.device)[:, None]
    f00 = pad[bi, v0i, u0i]
    f01 = pad[bi, v0i, u0i + 1]
    f10 = pad[bi, v0i + 1, u0i]
    f11 = pad[bi, v0i + 1, u0i + 1]
    top = f00 * (1 - du) + f01 * du
    bot = f10 * (1 - du) + f11 * du
    out = top * (1 - dv) + bot * dv
    return torch.where(inside[..., None], out, 0.0), inside
