"""Grid-hash K-nearest-neighbour search over BEV space (torch), mirroring
`dcf.ops.knn`: the index form (`bin_points`, `knn_query_grid`) and the
dense (payload) form (`bin_points_dense`, `knn_select_dense`).

Points are binned into a fixed-capacity grid (stable by arrival order),
then each pixel takes the K nearest binned points of its (2r+1)^2 cell
window by BEV distance to the pixel centre. Candidates are scanned
window-shift-major, then bin slot; equal distances go to the earlier
candidate. This is the selection the fusion kernel reproduces.

`knn_select_dense` replaces the TPU kernel
`dcf/ops/pallas/knn_kernel.py::_knn_kernel`: on a CUDA tensor it launches
`dcf_torch/csrc/knn.cu`, on a CPU tensor it runs `knn_select_plain`.
The TPU kernel scans bin slot first (`for c`, then the window), so at
equal distances it can pick other points than its jnp twin; the port
follows the twin.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from dcf_torch.ops import _cuda

_BIG = 1e30


class BinTable(NamedTuple):
    """Fixed-capacity point bins over an H x W grid (index form)."""

    indices: torch.Tensor  # [H * W, capacity] int32 point index, clamped
    valid: torch.Tensor    # [H * W, capacity] bool slot validity
    shape: Tuple[int, int]


class DenseBins(NamedTuple):
    """Fixed-capacity bins holding point payloads directly."""

    data: torch.Tensor     # [B, H, W, capacity, D] payload (0 where empty)
    valid: torch.Tensor    # [B, H, W, capacity] bool


def _rank_within_runs(sorted_vals: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal values ([N] sorted)."""
    n = sorted_vals.shape[0]
    iota = torch.arange(n, device=sorted_vals.device)
    start = torch.ones(n, dtype=torch.bool, device=sorted_vals.device)
    start[1:] = sorted_vals[1:] != sorted_vals[:-1]
    run_start = torch.cummax(torch.where(start, iota, 0), dim=0).values
    return iota - run_start


def _cell_ids(xy: torch.Tensor, mask: torch.Tensor,
              origin: Tuple[float, float], cell_size: float,
              grid_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per point (x, y) its grid cell (ix, iy) as int64, and whether it is
    valid and inside the grid."""
    H, W = grid_hw
    ix = torch.floor((xy[..., 0] - origin[0]) / cell_size).to(torch.int64)
    iy = torch.floor((xy[..., 1] - origin[1]) / cell_size).to(torch.int64)
    inb = mask & (ix >= 0) & (ix < H) & (iy >= 0) & (iy < W)
    return (ix, iy), inb


def bin_points(points_xy: torch.Tensor, mask: torch.Tensor,
               origin: Tuple[float, float], cell_size: float,
               grid_hw: Tuple[int, int], capacity: int) -> BinTable:
    """Scatter point indices into fixed-capacity grid bins.

    Args:
      points_xy: [P, 2] BEV coordinates (metres).
      mask: [P] bool point validity.
      origin: (x0, y0) of grid cell (0, 0).
      cell_size: cell edge length in metres.
      grid_hw: (H, W) cell counts.
      capacity: max points kept per cell (later points dropped).

    Returns:
      BinTable: a cell keeps its first `capacity` valid points in
      arrival order; empty slots hold index 0 and valid False.
    """
    H, W = grid_hw
    (ix, iy), inb = _cell_ids(points_xy, mask, origin, cell_size, grid_hw)
    n_slots = H * W * capacity
    cell = torch.where(inb, ix * W + iy, H * W)
    sorted_cell, order = torch.sort(cell, stable=True)
    rank = _rank_within_runs(sorted_cell)
    ok = (rank < capacity) & (sorted_cell < H * W)
    flat = torch.where(ok, sorted_cell * capacity + rank, n_slots)  # drop
    table = torch.full((n_slots + 1,), -1, dtype=torch.int32,
                       device=points_xy.device)
    table[flat] = order.to(torch.int32)
    table = table[:n_slots]
    valid = table >= 0
    indices = torch.where(valid, table, 0)
    return BinTable(indices.reshape(H * W, capacity),
                    valid.reshape(H * W, capacity), (H, W))


def knn_query_grid(table: BinTable, points_xy: torch.Tensor,
                   origin: Tuple[float, float], cell_size: float,
                   k: int, radius_cells: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K nearest binned points for every grid cell centre.

    Candidates are the (2r+1)^2 cells' slots, window row-major then slot;
    among equal distances the earlier candidate wins (`lax.top_k`'s rule
    in the reference: a stable sort here).

    Returns:
      idx: [H * W, k] int32 point indices (clamped; check valid).
      valid: [H * W, k] bool.
      dist2: [H * W, k] float32 squared BEV distances (inf where invalid).
    """
    H, W = table.shape
    C = table.indices.shape[1]
    win = 2 * radius_cells + 1
    dev = points_xy.device
    cx, cy = cell_centers(H, W, origin, cell_size, dev)
    centers = torch.stack([cx.expand(H, W), cy.expand(H, W)],
                          dim=-1).reshape(H * W, 2)

    rows = torch.arange(H, device=dev)[:, None].expand(H, W).reshape(-1, 1)
    cols = torch.arange(W, device=dev)[None, :].expand(H, W).reshape(-1, 1)
    offs = torch.arange(-radius_cells, radius_cells + 1, device=dev)
    ni = rows + offs.repeat_interleave(win)[None]            # [H*W, win^2]
    nj = cols + offs.repeat(win)[None]
    n_ok = (ni >= 0) & (ni < H) & (nj >= 0) & (nj < W)
    ncell = torch.where(n_ok, ni * W + nj, 0)

    cand_idx = table.indices[ncell].reshape(H * W, win * win * C)
    cand_valid = (table.valid[ncell]
                  & n_ok[..., None]).reshape(H * W, win * win * C)
    cand_xy = points_xy[cand_idx.to(torch.int64)]            # [HW, 9C, 2]
    dx = cand_xy[..., 0] - centers[:, None, 0]
    dy = cand_xy[..., 1] - centers[:, None, 1]
    d2 = torch.where(cand_valid, dx * dx + dy * dy, torch.inf)

    d2s, sel = torch.sort(d2, dim=1, stable=True)
    sel = sel[:, :k]
    return (torch.gather(cand_idx, 1, sel), torch.gather(cand_valid, 1, sel),
            d2s[:, :k])


def bin_points_dense(points: torch.Tensor, mask: torch.Tensor,
                     origin: Tuple[float, float], cell_size: float,
                     grid_hw: Tuple[int, int], capacity: int) -> DenseBins:
    """Scatter point payloads into fixed-capacity grid bins.

    Args:
      points: [B, P, D] rows whose first two columns are BEV (x, y).
      mask: [B, P] validity.

    Returns:
      DenseBins(data [B, H, W, capacity, D], valid [B, H, W, capacity]);
      a cell keeps its first `capacity` valid points in arrival order.
    """
    H, W = grid_hw
    B, P, D = points.shape
    dev = points.device
    (ix, iy), inb = _cell_ids(points, mask, origin, cell_size, grid_hw)
    bi = torch.arange(B, device=dev)[:, None]
    n_slots = B * H * W * capacity
    cell = torch.where(inb, (bi * H + ix) * W + iy, B * H * W).reshape(-1)
    sorted_cell, order = torch.sort(cell, stable=True)
    rank = _rank_within_runs(sorted_cell)
    ok = (rank < capacity) & (sorted_cell < B * H * W)
    flat = torch.where(ok, sorted_cell * capacity + rank, n_slots)  # drop

    data = torch.zeros((n_slots + 1, D), dtype=points.dtype, device=dev)
    data[flat] = points.reshape(B * P, D)[order]
    valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    valid[flat] = True
    return DenseBins(data[:n_slots].reshape(B, H, W, capacity, D),
                     valid[:n_slots].reshape(B, H, W, capacity))


def cell_centers(H: int, W: int, origin: Tuple[float, float],
                 cell_size: float, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """f32 pixel-centre coordinates, cx [H, 1] and cy [1, W]."""
    rows = torch.arange(H, device=device, dtype=torch.float32)
    cols = torch.arange(W, device=device, dtype=torch.float32)
    cx = origin[0] + (rows + 0.5) * cell_size
    cy = origin[1] + (cols + 0.5) * cell_size
    return cx[:, None], cy[None, :]


def knn_select_plain(bins: DenseBins, origin: Tuple[float, float],
                     cell_size: float, k: int, radius_cells: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K nearest point payloads for every grid cell centre: the plain
    PyTorch version (the KNN kernel's contract).

    Returns:
      nbr:   [B, H, W, k, D] selected payloads (undefined where invalid).
      valid: [B, H, W, k] bool.
      dist2: [B, H, W, k] squared BEV distance (inf where invalid).
    """
    B, H, W, C, D = bins.data.shape
    r = radius_cells
    win = 2 * r + 1
    pdata = F.pad(bins.data, (0, 0, 0, 0, r, r, r, r))
    pvalid = F.pad(bins.valid.to(torch.uint8), (0, 0, r, r, r, r)).bool()
    cx, cy = cell_centers(H, W, origin, cell_size, bins.data.device)
    cx, cy = cx[..., None], cy[..., None]                   # [H|1, 1|W, 1]

    cands, d2s = [], []
    for di in range(win):
        for dj in range(win):
            sd = pdata[:, di:di + H, dj:dj + W]              # [B, H, W, C, D]
            sv = pvalid[:, di:di + H, dj:dj + W]
            ddx = sd[..., 0] - cx
            ddy = sd[..., 1] - cy
            d2s.append(torch.where(sv, ddx * ddx + ddy * ddy, _BIG))
            cands.append(sd)
    d2 = torch.cat(d2s, dim=-1)                              # [B, H, W, 9C]
    cand = torch.cat(cands, dim=-2)                          # [B, H, W, 9C, D]

    nbrs, valids, dists = [], [], []
    for _ in range(k):
        best = torch.argmin(d2, dim=-1, keepdim=True)        # first minimum
        bd = torch.gather(d2, -1, best)[..., 0]
        nbrs.append(torch.gather(
            cand, -2, best[..., None].expand(B, H, W, 1, D))[..., 0, :])
        ok = bd < _BIG
        valids.append(ok)
        dists.append(torch.where(ok, bd, torch.inf))
        d2 = d2.scatter(-1, best, _BIG)
    return (torch.stack(nbrs, dim=3), torch.stack(valids, dim=3),
            torch.stack(dists, dim=3))


MAX_NEIGHBORS = 8      # the kernel's insertion list is unrolled up to this


def knn_select_dense(bins: DenseBins, origin: Tuple[float, float],
                     cell_size: float, k: int, radius_cells: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K nearest point payloads for every grid cell centre (same arguments
    and results as `knn_select_plain`): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. The kernel writes 0 into `nbr`
    where `valid` is False; its `valid`, `dist2` and the valid `nbr` rows
    equal the plain version's bit for bit."""
    data, valid = bins
    if data.device.type == "cpu":
        return knn_select_plain(bins, origin, cell_size, k, radius_cells)
    if data.device.type != "cuda":
        raise ValueError(f"knn_select_dense: no kernel for {data.device}")
    B, H, W, C, D = data.shape
    for name, t, dtype, shape in (("data", data, torch.float32,
                                   (B, H, W, C, D)),
                                  ("valid", valid, torch.bool, (B, H, W, C))):
        if t.device != data.device or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"knn_select_dense: {name} must be a contiguous {dtype} "
                f"{shape} tensor on {data.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 1 <= k <= MAX_NEIGHBORS or D < 2 or radius_cells < 0:
        raise ValueError(f"knn_select_dense: k={k} outside [1, "
                         f"{MAX_NEIGHBORS}], D={D} < 2 or r < 0")
    if data.numel() >= 2 ** 31 or B * H * W * k * D >= 2 ** 31:
        raise ValueError("knn_select_dense: tensors too large for int32 "
                         "indices")
    dev = data.device
    nbr = torch.empty((B, H, W, k, D), dtype=torch.float32, device=dev)
    ok = torch.empty((B, H, W, k), dtype=torch.bool, device=dev)
    d2 = torch.empty((B, H, W, k), dtype=torch.float32, device=dev)
    if ok.numel():
        err = _cuda.library().dcf_knn_select(
            data.data_ptr(), valid.data_ptr(), nbr.data_ptr(), ok.data_ptr(),
            d2.data_ptr(), B, H, W, C, D, k, radius_cells,
            ctypes.c_float(origin[0]), ctypes.c_float(origin[1]),
            ctypes.c_float(cell_size),
            torch.cuda.current_stream(dev).cuda_stream)
        _cuda.check(err, "knn_select_dense")
        knn_select_dense.launches += 1
    return nbr, ok, d2


knn_select_dense.launches = 0
