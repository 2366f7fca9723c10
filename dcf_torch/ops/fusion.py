"""Continuous fusion: the CUDA forward and backward kernels, their plain
versions, and the payload quantization in front of them.

Replaces the TPU kernels `dcf/ops/pallas/fusion_kernel.py::_fwd_kernel`
and `::_bwd_kernel` (with the custom VJP around them). For each BEV
pixel the K nearest binned points of its (2r+1)^2 cell window are
selected, and `relu(z1[gidx] + Wg . (dx, dy, z, dist) + bg)` is summed
over them, with a count channel: [B, H, W, hid + 1] float32. The plain
forward follows `fused_fusion_reference` (the JAX package's CPU path);
the kernel (`dcf_torch/csrc/fusion_fwd.cu`) reproduces it, tie order
included.

`fused_fusion` is differentiable in z1, wgt and bg: when a gradient is
wanted it runs `FusedFusion`, whose forward also writes the stash (per
(pixel, k) the selected point index, -1 where invalid, and its four
geometric features) and whose backward (`dcf_torch/csrc/fusion_bwd.cu`)
rebuilds the pre-activations from it. Otherwise (serving, `no_grad`) it
runs the forward alone, without the stash. Every wrapper takes the plain
version only for CPU tensors; for a CUDA tensor it launches the kernel
or raises.

The relu's gradient follows the TPU kernel: live where `pre > 0`, so 0
at an exact tie `pre == 0` (`torch.relu`'s rule too; `jnp.maximum`, in
the JAX package's CPU twin, gives 0.5 there).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dcf_torch.ops import _cuda
from dcf_torch.ops.knn import DenseBins, cell_centers, knn_select_plain

MAX_NEIGHBORS = 8      # the kernel's insertion list is unrolled up to this
# lanes per pixel -> (tile rows, tile columns) of the forward kernel's
# 256-thread blocks
FWD_TILES = {2: (8, 16), 4: (8, 8), 8: (4, 8)}


def fusion_launch_shape(B: int, H: int, W: int, sms: int
                        ) -> Tuple[int, int, int]:
    """(lanes per pixel, tile rows, tile columns) for the forward kernel
    on a card with `sms` multiprocessors: the fewest lanes whose tiles
    give at least two blocks per multiprocessor, else 8 lanes. Fewer
    lanes mean larger tiles (less halo per pixel); more lanes, more
    blocks and fewer candidates per thread for the coarse scales."""
    for lanes, (th, tw) in FWD_TILES.items():
        if B * -(-H // th) * -(-W // tw) >= 2 * sms:
            return (lanes, th, tw)
    return (8,) + FWD_TILES[8]


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


def _live_pairs(stash: Stash, z1: torch.Tensor, wgt: torch.Tensor,
                bg: torch.Tensor, dacc: torch.Tensor):
    """The pairs the backward sums over: (z1 row [M], geo [M, 4], dpre
    [M, hid]) for every (pixel, k) with a selection, where dpre is dacc
    masked by `pre > 0`, pre rebuilt in the forward's order."""
    sel, geo = stash
    B, H, W, K = sel.shape
    P = z1.shape[1]
    pair = (sel >= 0).reshape(-1)
    b = torch.arange(B, device=sel.device)[:, None, None, None]
    rows = (b * P + sel.to(torch.int64)).reshape(-1)[pair]
    g = geo.reshape(-1, 4)[pair]
    w = wgt.to(torch.float32)
    gg = (g[:, 0:1] * w[:, 0] + g[:, 1:2] * w[:, 1] + g[:, 2:3] * w[:, 2]
          + g[:, 3:4] * w[:, 3])
    pre = z1.reshape(B * P, -1)[rows].to(torch.float32) + (
        gg + bg.to(torch.float32))
    da = dacc[:, :, :, None, :].expand(B, H, W, K, dacc.shape[-1])
    dpre = torch.where(pre > 0, da.reshape(-1, dacc.shape[-1])[pair], 0.0)
    return rows, g, dpre


def fused_fusion_bwd_plain(stash: Stash, z1: torch.Tensor, wgt: torch.Tensor,
                           bg: torch.Tensor, dacc: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain PyTorch fusion backward (the backward kernel's contract).

    Args:
      stash: (sel, geo) from the forward (`fused_fusion_plain(...,
        stash=True)` or the kernel's).
      z1, wgt, bg: the forward's inputs.
      dacc: [B, H, W, hid] cotangent of the K-sum (the count channel's
        is dropped: the count depends on no parameter).

    Returns:
      (d_z1 [B, P, hid], d_wgt [hid, 4], d_bg [hid]), float32.
    """
    B, P, hid = z1.shape
    rows, g, dpre = _live_pairs(stash, z1, wgt, bg, dacc)
    dz1 = torch.zeros((B * P, hid), dtype=torch.float32, device=z1.device)
    dz1.index_add_(0, rows, dpre)
    return dz1.reshape(B, P, hid), dpre.t() @ g, dpre.sum(0)


F32_UNIT_ROUNDOFF = 2.0 ** -24


def fusion_bwd_tolerance(stash: Stash, z1: torch.Tensor, wgt: torch.Tensor,
                         bg: torch.Tensor, dacc: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-element bounds on the difference of two evaluations of the
    fusion backward's (d_z1, d_wgt, d_bg) that sum in different orders
    (the kernel's atomics against the plain version). Each element is a
    float32 sum of n products (d_z1: the pairs that select its point, at
    most (2r+1)^2; d_wgt / d_bg: every live pair of its channel); any
    summation order errs by at most (n - 1) u sum|terms| (u = 2^-24), and
    a product rounded or fused into an FMA by at most u |term|, so two
    orders differ by at most 2 n u sum|terms|."""
    B, P, hid = z1.shape
    rows, g, dpre = _live_pairs(stash, z1, wgt, bg, dacc)
    live = (dpre != 0).to(torch.float32)
    a = dpre.abs()
    n_z1 = torch.zeros((B * P, hid), device=z1.device).index_add_(0, rows,
                                                                  live)
    s_z1 = torch.zeros((B * P, hid), device=z1.device).index_add_(0, rows, a)
    n_ch = live.sum(0)

    def tol(n, s):
        return 2.0 * n * F32_UNIT_ROUNDOFF * s
    return (tol(n_z1, s_z1).reshape(B, P, hid),
            tol(n_ch[:, None], a.t() @ g.abs()), tol(n_ch, a.sum(0)))


def _check(fn: str, tensors) -> None:
    """Raise unless every (name, tensor, dtype, shape) is a contiguous
    tensor of that dtype and shape on the first tensor's device."""
    device = tensors[0][1].device
    for name, t, dtype, shape in tensors:
        if t.device != device or t.dtype != dtype or \
                tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} {tuple(shape)} "
                f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _forward(data, valid, z1, wgt, bg, origin, cell_size, k, radius_cells,
             stash: bool, lanes: Optional[int] = None):
    """The forward on the tensors' device: the plain version on the CPU,
    the kernel on CUDA (counted in `fused_fusion.launches`), with `lanes`
    per pixel (default: `fusion_launch_shape`'s choice)."""
    if data.device.type == "cpu":
        return fused_fusion_plain(data, valid, z1, wgt, bg, origin,
                                  cell_size, k, radius_cells, stash=stash)
    if data.device.type != "cuda":
        raise ValueError(f"fused_fusion: no kernel for {data.device}")
    B, H, W, C, D = data.shape
    P, hid = z1.shape[1:]
    _check("fused_fusion", (
        ("data", data, torch.float32, (B, H, W, C, 4)),
        ("valid", valid, torch.bool, (B, H, W, C)),
        ("z1", z1, torch.float32, (B, P, hid)),
        ("wgt", wgt, torch.float32, (hid, 4)),
        ("bg", bg, torch.float32, (hid,))))
    if not 1 <= k <= MAX_NEIGHBORS:
        raise ValueError(f"fused_fusion: k={k} outside [1, {MAX_NEIGHBORS}]")
    if hid % 4 or hid > 256 or C > 32:
        raise ValueError(f"fused_fusion: the kernel takes hid a multiple of "
                         f"4 up to 256 and C up to 32, got hid={hid}, C={C}")
    if B * H * W * C >= 2 ** 31 or B * P * hid >= 2 ** 31:
        raise ValueError("fused_fusion: tensors too large for int32 indices")
    dev = data.device
    out = torch.empty((B, H, W, hid + 1), dtype=torch.float32, device=dev)
    sel = geo = None
    if stash:
        sel = torch.empty((B, H, W, k), dtype=torch.int32, device=dev)
        geo = torch.empty((B, H, W, k, 4), dtype=torch.float32, device=dev)
    if lanes is None:
        lanes, th, tw = fusion_launch_shape(B, H, W, _cuda.sm_count(dev))
    elif lanes in FWD_TILES:
        th, tw = FWD_TILES[lanes]
    else:
        raise ValueError(f"fused_fusion: lanes={lanes} not in {FWD_TILES}")
    if out.numel():
        err = _cuda.library().dcf_fusion_fwd(
            data.data_ptr(), valid.data_ptr(), z1.data_ptr(), wgt.data_ptr(),
            bg.data_ptr(), out.data_ptr(),
            sel.data_ptr() if stash else None,
            geo.data_ptr() if stash else None,
            B, H, W, C, P, hid, k, radius_cells, lanes, th, tw,
            ctypes.c_float(origin[0]), ctypes.c_float(origin[1]),
            ctypes.c_float(cell_size),
            torch.cuda.current_stream(dev).cuda_stream)
        _cuda.check(err, "fused_fusion")
        fused_fusion.launches += 1
    return (out, (sel, geo)) if stash else out


def fused_fusion_bwd(stash: Stash, z1: torch.Tensor, wgt: torch.Tensor,
                     bg: torch.Tensor, dacc: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fusion backward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same arguments as `fused_fusion_bwd_plain`).
    `dacc` may be the [..., :hid] view of a contiguous [..., hid + 1]
    cotangent: the kernel reads it with that row stride."""
    if z1.device.type == "cpu":
        return fused_fusion_bwd_plain(stash, z1, wgt, bg, dacc)
    if z1.device.type != "cuda":
        raise ValueError(f"fused_fusion_bwd: no kernel for {z1.device}")
    sel, geo = stash
    B, H, W, K = sel.shape
    P, hid = z1.shape[1:]
    _check("fused_fusion_bwd", (
        ("z1", z1, torch.float32, (B, P, hid)),
        ("sel", sel, torch.int32, (B, H, W, K)),
        ("geo", geo, torch.float32, (B, H, W, K, 4)),
        ("wgt", wgt, torch.float32, (hid, 4)),
        ("bg", bg, torch.float32, (hid,))))
    ld = dacc.stride(2) if dacc.dim() == 4 else 0
    if dacc.device != z1.device or dacc.dtype != torch.float32 or \
            tuple(dacc.shape) != (B, H, W, hid) or ld < hid or \
            dacc.stride() != (H * W * ld, W * ld, ld, 1):
        raise ValueError(
            f"fused_fusion_bwd: dacc must be a float32 {(B, H, W, hid)} "
            f"tensor on {z1.device} with contiguous rows, got {dacc.dtype} "
            f"{tuple(dacc.shape)} strides {dacc.stride()} on {dacc.device}")
    if B * H * W * ld >= 2 ** 31 or B * P * hid >= 2 ** 31 or hid > 256:
        raise ValueError("fused_fusion_bwd: tensors too large for the kernel")
    dev = z1.device
    dz1 = torch.zeros((B, P, hid), dtype=torch.float32, device=dev)
    dwgt = torch.zeros((hid, 4), dtype=torch.float32, device=dev)
    dbg = torch.zeros((hid,), dtype=torch.float32, device=dev)
    if sel.numel():
        err = _cuda.library().dcf_fusion_bwd(
            sel.data_ptr(), geo.data_ptr(), z1.data_ptr(), wgt.data_ptr(),
            bg.data_ptr(), dacc.data_ptr(), ld, dz1.data_ptr(),
            dwgt.data_ptr(), dbg.data_ptr(), B, H, W, K, P, hid,
            torch.cuda.current_stream(dev).cuda_stream)
        _cuda.check(err, "fused_fusion_bwd")
        fused_fusion_bwd.launches += 1
    return dz1, dwgt, dbg


fused_fusion_bwd.launches = 0


class FusedFusion(torch.autograd.Function):
    """`fused_fusion` with a gradient for z1, wgt and bg (the custom VJP
    `_fused_fusion_p` of the JAX package): the forward stashes its
    selections, the backward is `fused_fusion_bwd`."""

    @staticmethod
    def forward(ctx, data, valid, z1, wgt, bg, origin, cell_size, k,
                radius_cells):
        out, (sel, geo) = _forward(data, valid, z1, wgt, bg, origin,
                                   cell_size, k, radius_cells, stash=True)
        ctx.save_for_backward(sel, geo, z1, wgt, bg)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        sel, geo, z1, wgt, bg = ctx.saved_tensors
        if not grad_out.is_contiguous():
            grad_out = grad_out.contiguous()
        dz1, dwgt, dbg = fused_fusion_bwd(
            (sel, geo), z1, wgt, bg, grad_out[..., :z1.shape[-1]])
        return None, None, dz1, dwgt, dbg, None, None, None, None


def fused_fusion(data: torch.Tensor, valid: torch.Tensor, z1: torch.Tensor,
                 wgt: torch.Tensor, bg: torch.Tensor,
                 origin: Tuple[float, float], cell_size: float, k: int,
                 radius_cells: int = 1) -> torch.Tensor:
    """Fusion forward (same arguments as `fused_fusion_plain`): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    Differentiable in z1, wgt and bg through `FusedFusion` when autograd
    records; without that, no stash is written."""
    if torch.is_grad_enabled() and (z1.requires_grad or wgt.requires_grad
                                    or bg.requires_grad):
        return FusedFusion.apply(data, valid, z1, wgt, bg, origin,
                                 cell_size, k, radius_cells)
    return _forward(data, valid, z1, wgt, bg, origin, cell_size, k,
                    radius_cells, stash=False)


fused_fusion.launches = 0
