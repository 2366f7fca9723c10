"""Continuous fusion in plain PyTorch: for each BEV pixel the K nearest
binned points of its (2r+1)^2 cell window are selected, and
`relu(z1[gidx] + Wg . (dx, dy, z, dist) + bg)` is summed over them, with
a count channel: [B, H, W, hid + 1] float32. Differentiable in z1, wgt
and bg through autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perfbench.reference.ops.knn import DenseBins, cell_centers, knn_select_plain


def quantize_payload_xyz(data: torch.Tensor, origin: Tuple[float, float],
                         cell_size: float) -> torch.Tensor:
    """Round a bin payload [B, H, W, C, 4] the way the TPU kernel's packed
    planes store it: x/y through bf16 RELATIVE to their bin's cell centre,
    z through plain bf16, the point index unchanged."""
    H, W = data.shape[1:3]
    cx, cy = cell_centers(H, W, origin, cell_size, data.device)
    ccx, ccy = cx[..., None], cy[..., None]                 # [H|1, 1|W, 1]

    def q(v):
        return v.to(torch.bfloat16).to(torch.float32)

    d = data.to(torch.float32)
    return torch.stack([ccx + q(d[..., 0] - ccx), ccy + q(d[..., 1] - ccy),
                        q(d[..., 2]), d[..., 3]], dim=-1)


Stash = Tuple[torch.Tensor, torch.Tensor]     # sel [B,H,W,K], geo [B,H,W,K,4]


def fused_fusion_plain(data: torch.Tensor, valid: torch.Tensor,
                       z1: torch.Tensor, wgt: torch.Tensor, bg: torch.Tensor,
                       origin: Tuple[float, float], cell_size: float, k: int,
                       radius_cells: int = 1, stash: bool = False):
    """Plain PyTorch fusion forward (the kernel's contract).

    Args:
      data: [B, H, W, C, 4] quantized payload (x, y, z, point index).
      valid: [B, H, W, C] bool.
      z1: [B, P, hid] per-point image features (first MLP layer).
      wgt: [hid, 4] geometric weights; bg: [hid] bias.
      stash: also return the selections the backward needs.

    Returns:
      [B, H, W, hid + 1] f32: the masked K-sum and the neighbour count;
      with `stash`, (that, (sel [B, H, W, k] int32, geo [B, H, W, k, 4]
      f32)): per (pixel, k) the selected point index (-1 where the pixel
      has fewer neighbours) and its (dx, dy, z, dist), 0 where sel is -1.
      Sums run in the kernel's order (features 0..3, neighbours in
      distance order), so the two agree bit for bit on the card.
    """
    B, H, W = data.shape[:3]
    nbr, nvalid, d2 = knn_select_plain(DenseBins(data, valid), origin,
                                       cell_size, k, radius_cells)
    cx, cy = cell_centers(H, W, origin, cell_size, data.device)
    gx = nbr[..., 0] - cx[..., None]                         # [B, H, W, k]
    gy = nbr[..., 1] - cy[..., None]
    gz = nbr[..., 2]
    gd = torch.sqrt(torch.clamp(d2, max=1e6))
    idx = nbr[..., 3].to(torch.int64)
    bi = torch.arange(B, device=data.device)[:, None, None, None]
    z1g = z1[bi, idx].to(torch.float32)                      # [B,H,W,k,hid]
    w = wgt.to(torch.float32)
    g = (gx[..., None] * w[:, 0] + gy[..., None] * w[:, 1]
         + gz[..., None] * w[:, 2] + gd[..., None] * w[:, 3])
    h = torch.relu(z1g + (g + bg.to(torch.float32)))
    okf = nvalid.to(torch.float32)
    acc = h[..., 0, :] * okf[..., 0, None]
    cnt = okf[..., 0]
    for kk in range(1, k):
        acc = acc + h[..., kk, :] * okf[..., kk, None]
        cnt = cnt + okf[..., kk]
    out = torch.cat([acc, cnt[..., None]], dim=-1)
    if not stash:
        return out
    sel = torch.where(nvalid, idx, -1).to(torch.int32)
    geo = torch.where(nvalid[..., None],
                      torch.stack([gx, gy, gz, gd], dim=-1), 0.0)
    return out, (sel, geo)



def fused_fusion(data, valid, z1, wgt, bg, origin, cell_size, k,
                 radius_cells=1):
    """The fusion forward in plain PyTorch (autograd gives its backward)."""
    return fused_fusion_plain(data, valid, z1, wgt, bg, origin, cell_size, k,
                              radius_cells)
