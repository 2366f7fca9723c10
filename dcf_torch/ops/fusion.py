"""Continuous-fusion forward: the CUDA kernel, its plain version, and the
payload quantization in front of both.

Replaces the TPU kernel `dcf/ops/pallas/fusion_kernel.py::_fwd_kernel`.
For each BEV pixel the K nearest binned points of its (2r+1)^2 cell
window are selected, and `relu(z1[gidx] + Wg . (dx, dy, z, dist) + bg)`
is summed over them, with a count channel: [B, H, W, hid + 1] float32.
The plain version follows `fused_fusion_reference` (the JAX package's
CPU path); the kernel (`dcf_torch/csrc/fusion_fwd.cu`) reproduces it,
tie order included. `fused_fusion` takes the plain version only for CPU
tensors; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dcf_torch.ops import _cuda
from dcf_torch.ops.knn import DenseBins, cell_centers, knn_select_dense

MAX_NEIGHBORS = 8      # the kernel's insertion list is unrolled up to this


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


def fused_fusion_plain(data: torch.Tensor, valid: torch.Tensor,
                       z1: torch.Tensor, wgt: torch.Tensor, bg: torch.Tensor,
                       origin: Tuple[float, float], cell_size: float, k: int,
                       radius_cells: int = 1) -> torch.Tensor:
    """Plain PyTorch fusion forward (the kernel's contract).

    Args:
      data: [B, H, W, C, 4] quantized payload (x, y, z, point index).
      valid: [B, H, W, C] bool.
      z1: [B, P, hid] per-point image features (first MLP layer).
      wgt: [hid, 4] geometric weights; bg: [hid] bias.

    Returns:
      [B, H, W, hid + 1] f32: the masked K-sum and the neighbour count.
      Sums run in the kernel's order (features 0..3, neighbours in
      distance order), so the two agree bit for bit on the card.
    """
    B, H, W = data.shape[:3]
    nbr, nvalid, d2 = knn_select_dense(DenseBins(data, valid), origin,
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
    h = torch.clamp(z1g + (g + bg.to(torch.float32)), min=0.0)
    okf = nvalid.to(torch.float32)
    acc = h[..., 0, :] * okf[..., 0, None]
    cnt = okf[..., 0]
    for kk in range(1, k):
        acc = acc + h[..., kk, :] * okf[..., kk, None]
        cnt = cnt + okf[..., kk]
    return torch.cat([acc, cnt[..., None]], dim=-1)


def fused_fusion(data: torch.Tensor, valid: torch.Tensor, z1: torch.Tensor,
                 wgt: torch.Tensor, bg: torch.Tensor,
                 origin: Tuple[float, float], cell_size: float, k: int,
                 radius_cells: int = 1) -> torch.Tensor:
    """Fusion forward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same arguments as `fused_fusion_plain`)."""
    if data.device.type == "cpu":
        return fused_fusion_plain(data, valid, z1, wgt, bg, origin,
                                  cell_size, k, radius_cells)
    if data.device.type != "cuda":
        raise ValueError(f"fused_fusion: no kernel for {data.device}")
    B, H, W, C, D = data.shape
    P, hid = z1.shape[1:]
    for name, t, dtype, shape in (
            ("data", data, torch.float32, (B, H, W, C, 4)),
            ("valid", valid, torch.bool, (B, H, W, C)),
            ("z1", z1, torch.float32, (B, P, hid)),
            ("wgt", wgt, torch.float32, (hid, 4)),
            ("bg", bg, torch.float32, (hid,))):
        if t.device != data.device or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_fusion: {name} must be a contiguous {dtype} "
                f"{shape} tensor on {data.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 1 <= k <= MAX_NEIGHBORS:
        raise ValueError(f"fused_fusion: k={k} outside [1, {MAX_NEIGHBORS}]")
    if B * H * W * C >= 2 ** 31 or B * P * hid >= 2 ** 31:
        raise ValueError("fused_fusion: tensors too large for int32 indices")
    out = torch.empty((B, H, W, hid + 1), dtype=torch.float32,
                      device=data.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    err = lib.dcf_fusion_fwd(
        data.data_ptr(), valid.data_ptr(), z1.data_ptr(), wgt.data_ptr(),
        bg.data_ptr(), out.data_ptr(), B, H, W, C, P, hid, k, radius_cells,
        ctypes.c_float(origin[0]), ctypes.c_float(origin[1]),
        ctypes.c_float(cell_size),
        torch.cuda.current_stream(data.device).cuda_stream)
    _cuda.check(err, "fused_fusion")
    fused_fusion.launches += 1
    return out


fused_fusion.launches = 0
