"""Grid-hash K-nearest-neighbour search over BEV space (torch), mirroring
the dense (payload) form of `dcf.ops.knn`.

Points are binned into a fixed-capacity grid (stable by arrival order),
then each pixel takes the K nearest binned points of its (2r+1)^2 cell
window by BEV distance to the pixel centre. Candidates are scanned
window-shift-major, then bin slot; equal distances go to the earlier
candidate. This is the selection the fusion kernel reproduces.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

_BIG = 1e30


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
    ix = torch.floor((points[..., 0] - origin[0]) / cell_size).to(torch.int64)
    iy = torch.floor((points[..., 1] - origin[1]) / cell_size).to(torch.int64)
    inb = mask & (ix >= 0) & (ix < H) & (iy >= 0) & (iy < W)
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


def knn_select_dense(bins: DenseBins, origin: Tuple[float, float],
                     cell_size: float, k: int, radius_cells: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K nearest point payloads for every grid cell centre.

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
