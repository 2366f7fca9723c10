"""PointPillars' pillar encoder on the device: pillarization and the pillar
feature net fused with its scatter, as CUDA kernels with their plain
versions.

These replace no TPU kernel: the JAX package has no PointPillars. They
exist because the data-dependent parts of a pillar encoder (which pillar
a point opens, which slot it takes) done with `nonzero` / `unique` would
cost a host sync every frame, and because the PointNet done with plain
ops writes and reads a [P, N, C] tensor (154 MB in bf16 at the paper's
12,000 x 100 x 64) where a fused kernel reads only the points.

The rule of `pillarize` (a deterministic stand-in for the paper's random
sampling of points and pillars):
  - a point lies in cell (ix, iy) = (floor((x - x_min) * inv),
    floor((y - y_min) * inv)), in float32 with inv = float32(1 /
    voxel_size); it is in the ROI if its mask is set, 0 <= ix < grid_x,
    0 <= iy < grid_y and z_min <= z < z_max;
  - non-empty cells are numbered in the order of their first point (the
    lowest point index); a cell numbered P or beyond is dropped, all its
    points with it;
  - a kept cell's points take slots 0, 1, ... in point order; a point
    that arrives when its pillar already holds N points is dropped,
    later points of kept pillars are still kept.

The plain versions run for CPU tensors; CUDA tensors go to the kernels
(`dcf_torch/csrc/pillars.cu`), which give the plain versions' bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dcf_torch.config import VoxelConfig
from dcf_torch.ops import _cuda

INT_MAX = 2 ** 31 - 1
MAX_FEATURES = 128        # the PFN kernel's C: a multiple of 32, <= 128
NUM_FEATURES = 9          # x, y, z, r, offsets from the mean, from the centre
SHARED_BYTES = 227 * 1024 - 1024   # the pillarize block's dynamic share


class Pillars(NamedTuple):
    """The pillar tables of a batch (static shapes, B frames, P pillars of
    N slots):
      coords [B, P, 2] int32   (ix, iy) of each pillar, 0 where unused
      counts [B, P] int32      points kept in each pillar (<= N)
      mask   [B, P] bool       pillar in use
      table  [B, P, N] int32   point index of each slot, -1 where empty
      stats  [B, 3] int32      points in the ROI, points kept, non-empty
                               cells (kept or not)
    """

    coords: torch.Tensor
    counts: torch.Tensor
    mask: torch.Tensor
    table: torch.Tensor
    stats: torch.Tensor


def inverse_voxel(vox: VoxelConfig) -> float:
    """float32(1 / voxel_size), the factor of the cell rule."""
    return float(torch.tensor(1.0 / vox.voxel_size, dtype=torch.float32))


def point_cells(points: torch.Tensor, mask: torch.Tensor, vox: VoxelConfig
                ) -> torch.Tensor:
    """[B, Pts] int64 flat cell index ix * grid_y + iy of each point, -1
    for a point outside the ROI (the rule above)."""
    inv = inverse_voxel(vox)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    fx = torch.floor((x - vox.x_min) * inv)
    fy = torch.floor((y - vox.y_min) * inv)
    inb = (mask & (fx >= 0) & (fx < vox.grid_x) & (fy >= 0)
           & (fy < vox.grid_y) & (z >= vox.z_min) & (z < vox.z_max))
    cell = fx.to(torch.int64) * vox.grid_y + fy.to(torch.int64)
    return torch.where(inb, cell, -1)


def pillarize_plain(points: torch.Tensor, mask: torch.Tensor,
                    vox: VoxelConfig, max_pillars: int, max_points: int
                    ) -> Pillars:
    """`pillarize` with torch ops: the first point of every cell by a
    scatter-min, pillar numbers by a cumulative sum of the first-point
    flags, and slots by a stable sort of the points by pillar."""
    B, n, _ = points.shape
    P, N = max_pillars, max_points
    dev = points.device
    cell = point_cells(points, mask, vox)
    inroi = cell >= 0
    G = vox.grid_x * vox.grid_y
    idx = torch.arange(n, device=dev).expand(B, n)
    first = torch.full((B, G + 1), INT_MAX, dtype=torch.int64, device=dev)
    first.scatter_reduce_(1, torch.where(inroi, cell, G), idx, "amin")
    safe = torch.where(inroi, cell, G)
    is_first = inroi & (torch.gather(first, 1, safe) == idx)
    number = torch.cumsum(is_first.to(torch.int64), 1) - 1   # at first points
    # a point's pillar: the number at its cell's first point
    first_idx = torch.gather(first, 1, safe).clamp(max=n - 1)
    pid = torch.where(inroi, torch.gather(number, 1, first_idx), -1)
    kept = inroi & (pid < P)
    # slot: rank among the points of the same pillar, in point order
    key = torch.where(kept, pid, P)
    order = torch.sort(key, dim=1, stable=True).indices
    skey = torch.gather(key, 1, order)
    start = torch.searchsorted(skey, skey, side="left")
    slot = torch.empty_like(key)
    slot.scatter_(1, order, torch.arange(n, device=dev).expand(B, n) - start)
    placed = kept & (slot < N)
    table = torch.full((B, P * N + 1), -1, dtype=torch.int64, device=dev)
    table.scatter_(1, torch.where(placed, pid * N + slot, P * N), idx)
    counts = torch.zeros((B, P + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, torch.where(placed, pid, P),
                        placed.to(torch.int64))
    total = is_first.sum(1)
    coords = torch.zeros((B, P + 1, 2), dtype=torch.int64, device=dev)
    at = torch.where(is_first & (pid < P), pid, P)
    coords.scatter_(1, at[..., None].expand(B, n, 2),
                    torch.stack([cell // vox.grid_y, cell % vox.grid_y], -1))
    stats = torch.stack([inroi.sum(1), placed.sum(1), total], -1)
    return Pillars(coords=coords[:, :P].to(torch.int32),
                   counts=counts[:, :P].to(torch.int32),
                   mask=torch.arange(P, device=dev)[None] < total[:, None],
                   table=table[:, :P * N].reshape(B, P, N).to(torch.int32),
                   stats=stats.to(torch.int32))


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} {tuple(shape)} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def pillarize(points: torch.Tensor, mask: torch.Tensor, vox: VoxelConfig,
              max_pillars: int, max_points: int) -> Pillars:
    """Pillar tables of a batch of cropped clouds (`points` [B, Pts, 4]
    float32, `mask` [B, Pts] bool) by the rule above: the CUDA kernel for
    CUDA tensors, `pillarize_plain` for CPU tensors. No host sync."""
    if points.device.type == "cpu":
        return pillarize_plain(points, mask, vox, max_pillars, max_points)
    if points.device.type != "cuda":
        raise ValueError(f"pillarize: no kernel for {points.device}")
    B, n = points.shape[:2]
    P, N = max_pillars, max_points
    dev = points.device
    _check("pillarize: points", points, torch.float32, (B, n, 4), dev)
    _check("pillarize: mask", mask, torch.bool, (B, n), dev)
    G = vox.grid_x * vox.grid_y
    if B * max(G, P * N, n) >= 2 ** 31 or P < 1 or N < 1:
        raise ValueError("pillarize: sizes out of range")
    if 4 * (P + n) > SHARED_BYTES:
        raise ValueError(f"pillarize: {P} pillars and {n} points do not fit "
                         f"the block's shared memory (4 bytes each)")
    first = torch.full((B, G), INT_MAX, dtype=torch.int32, device=dev)
    scratch = torch.empty((B, n), dtype=torch.int32, device=dev)
    out = Pillars(
        coords=torch.zeros((B, P, 2), dtype=torch.int32, device=dev),
        counts=torch.empty((B, P), dtype=torch.int32, device=dev),
        mask=torch.empty((B, P), dtype=torch.bool, device=dev),
        table=torch.full((B, P, N), -1, dtype=torch.int32, device=dev),
        stats=torch.empty((B, 3), dtype=torch.int32, device=dev))
    err = _cuda.library().dcf_pillarize(
        points.data_ptr(), mask.data_ptr(), first.data_ptr(),
        scratch.data_ptr(), out.coords.data_ptr(), out.counts.data_ptr(),
        out.mask.data_ptr(), out.table.data_ptr(), out.stats.data_ptr(),
        B, n, vox.grid_x, vox.grid_y, P, N, vox.x_min, vox.y_min, vox.z_min,
        vox.z_max, inverse_voxel(vox),
        torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "pillarize")
    pillarize.launches += 1
    return out


pillarize.launches = 0


def pfn_scatter_plain(points: torch.Tensor, pillars: Pillars,
                      weight: torch.Tensor, bias: torch.Tensor,
                      vox: VoxelConfig, canvas: torch.Tensor) -> torch.Tensor:
    """`pfn_scatter` with torch ops, on the dense [B, P, N] slots: every
    operation in the kernel's order (the mean's sums slot by slot, the
    linear layer feature by feature), so the two agree bit for bit."""
    B, P, N = pillars.table.shape
    C = weight.shape[1]
    cnt = pillars.counts.to(torch.int64)
    live = torch.arange(N, device=points.device) < cnt[..., None]  # [B,P,N]
    n = points.shape[1]
    idx = torch.where(pillars.table >= 0, pillars.table, n).to(torch.int64)
    padded = torch.cat([points, points.new_zeros(B, 1, 4)], 1)  # row n: 0
    pts = torch.gather(padded, 1, idx.reshape(B, P * N, 1).expand(-1, -1, 4)
                       ).reshape(B, P, N, 4)
    sums = [torch.zeros((B, P), dtype=torch.float32, device=points.device)
            for _ in range(3)]
    for s in range(N):
        sums = [a + pts[:, :, s, k] for k, a in enumerate(sums)]
    den = cnt.clamp(min=1).to(torch.float32)
    mean = [a / den for a in sums]
    centre = [(pillars.coords[..., k].to(torch.float32) + 0.5)
              * vox.voxel_size + lo
              for k, lo in enumerate((vox.x_min, vox.y_min))]
    feats = [pts[..., 0], pts[..., 1], pts[..., 2], pts[..., 3],
             pts[..., 0] - mean[0][..., None], pts[..., 1] - mean[1][..., None],
             pts[..., 2] - mean[2][..., None],
             pts[..., 0] - centre[0][..., None],
             pts[..., 1] - centre[1][..., None]]
    feats = [torch.where(live, f, 0.0) for f in feats]   # empty slots: 0
    acc = feats[0][..., None] * weight[0]
    for k in range(1, NUM_FEATURES):
        acc = acc + feats[k][..., None] * weight[k]
    acc = acc + bias
    act = torch.where(acc > 0, acc, 0.0)                  # [B, P, N, C]
    best = act.amax(2)
    keep = pillars.mask & (cnt > 0)
    b = torch.arange(B, device=points.device)[:, None].expand(B, P)[keep]
    ix = pillars.coords[..., 0][keep].to(torch.int64)
    iy = pillars.coords[..., 1][keep].to(torch.int64)
    canvas[b, ix, iy] = best[keep].to(canvas.dtype)
    return canvas


def pfn_scatter(points: torch.Tensor, pillars: Pillars, weight: torch.Tensor,
                bias: torch.Tensor, vox: VoxelConfig, canvas: torch.Tensor
                ) -> torch.Tensor:
    """The pillar feature net with its scatter, into `canvas`
    ([B, grid_x, grid_y, C], zeroed by the caller, float32 or bfloat16):
    per kept pillar, each slot's 9 features (x, y, z, r; x, y, z less
    the mean of the pillar's kept points; x, y less the pillar's centre),
    zeroed in empty slots; then `weight` [9, C] and `bias` [C] (the
    linear layer with its BatchNorm folded in), relu, and the max over
    all N slots, so a pillar of fewer than N points takes relu(bias) into
    its max. The CUDA kernel for CUDA tensors, `pfn_scatter_plain` for
    CPU tensors."""
    if points.device.type == "cpu":
        return pfn_scatter_plain(points, pillars, weight, bias, vox, canvas)
    if points.device.type != "cuda":
        raise ValueError(f"pfn_scatter: no kernel for {points.device}")
    B, n = points.shape[:2]
    P, N = pillars.table.shape[1:]
    C = weight.shape[1]
    dev = points.device
    if C % 32 or C > MAX_FEATURES:
        raise ValueError(f"pfn_scatter: C={C} must be a multiple of 32 up "
                         f"to {MAX_FEATURES}")
    _check("pfn_scatter: points", points, torch.float32, (B, n, 4), dev)
    _check("pfn_scatter: table", pillars.table, torch.int32, (B, P, N), dev)
    _check("pfn_scatter: counts", pillars.counts, torch.int32, (B, P), dev)
    _check("pfn_scatter: mask", pillars.mask, torch.bool, (B, P), dev)
    _check("pfn_scatter: coords", pillars.coords, torch.int32, (B, P, 2), dev)
    _check("pfn_scatter: weight", weight, torch.float32, (NUM_FEATURES, C),
           dev)
    _check("pfn_scatter: bias", bias, torch.float32, (C,), dev)
    if canvas.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pfn_scatter: canvas dtype {canvas.dtype}")
    _check("pfn_scatter: canvas", canvas, canvas.dtype,
           (B, vox.grid_x, vox.grid_y, C), dev)
    if canvas.numel() >= 2 ** 31 or B * P * N >= 2 ** 31:
        raise ValueError("pfn_scatter: sizes out of range")
    err = _cuda.library().dcf_pfn_scatter(
        points.data_ptr(), pillars.table.data_ptr(),
        pillars.counts.data_ptr(), pillars.mask.data_ptr(),
        pillars.coords.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        canvas.data_ptr(), int(canvas.dtype == torch.bfloat16), B, n, P, N,
        C, vox.grid_x, vox.grid_y, vox.x_min, vox.y_min, vox.voxel_size,
        torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "pfn_scatter")
    pfn_scatter.launches += 1
    return canvas


pfn_scatter.launches = 0
