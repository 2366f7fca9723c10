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
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dcf_torch.ops import _cuda
from dcf_torch.utils import trace

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
      The tracer's device counters `fusion.bin_eligible` and
      `fusion.bin_dropped` count the valid points inside the grid and
      those a full cell turned away (`count_bin_drops`).
    """
    bins, inside, kept = bin_points_dense_tally(points, mask, origin,
                                                cell_size, grid_hw, capacity)
    count_bin_drops(inside, kept)
    return bins


def bin_points_dense_tally(points: torch.Tensor, mask: torch.Tensor,
                           origin: Tuple[float, float], cell_size: float,
                           grid_hw: Tuple[int, int], capacity: int
                           ) -> Tuple[DenseBins, torch.Tensor, torch.Tensor]:
    """`bin_points_dense` without counting: (bins, inside, kept), where
    inside [B * P] marks the valid points inside the grid and kept [B * P]
    those given a slot, both in the order of the points sorted by cell
    (what `count_bin_drops` reads)."""
    H, W = grid_hw
    B, P, D = points.shape
    dev = points.device
    (ix, iy), inb = _cell_ids(points, mask, origin, cell_size, grid_hw)
    bi = torch.arange(B, device=dev)[:, None]
    n_slots = B * H * W * capacity
    cell = torch.where(inb, (bi * H + ix) * W + iy, B * H * W).reshape(-1)
    sorted_cell, order = torch.sort(cell, stable=True)
    rank = _rank_within_runs(sorted_cell)
    inside = sorted_cell < B * H * W
    ok = (rank < capacity) & inside
    flat = torch.where(ok, sorted_cell * capacity + rank, n_slots)  # drop

    data = torch.zeros((n_slots + 1, D), dtype=points.dtype, device=dev)
    data[flat] = points.reshape(B * P, D)[order]
    valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    valid.index_fill_(0, flat, True)   # no host scalar: capturable
    return (DenseBins(data[:n_slots].reshape(B, H, W, capacity, D),
                      valid[:n_slots].reshape(B, H, W, capacity)),
            inside, ok)


def count_bin_drops(inside: torch.Tensor, kept: torch.Tensor) -> None:
    """Add the masks of `bin_points_dense_tally` to the tracer's device
    counters `fusion.bin_eligible` and `fusion.bin_dropped` (while it
    records)."""
    if trace.active():
        trace.count_device("fusion.bin_eligible", inside)
        trace.count_device("fusion.bin_dropped", inside & ~kept)


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
# the kernel's other limits: C slots a cell (a 32-bit mask), D payload
# columns, the window radius r (the 2x4 tile's halo then always fits)
MAX_SLOTS, MIN_COLS, MAX_COLS, MAX_RADIUS = 32, 2, 16, 3
# lanes per pixel -> (tile rows, tile columns) of the kernel's 256-thread
# blocks
KNN_TILES = {2: (8, 16), 4: (8, 8), 8: (4, 8), 16: (4, 4), 32: (2, 4)}
FILL_LANES = 8              # the most lanes the rule takes to fill the card
SMEM_BYTES = 227 * 1024     # shared memory a block may opt in to (H100)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def knn_smem_bytes(th: int, tw: int, C: int, D: int, k: int, r: int) -> int:
    """Shared memory of one block of the kernel (knn.cu's `Layout`): the
    halo's payloads and slot masks, then the nbr stage."""
    cells = (th + 2 * r) * (tw + 2 * r)
    mask = _align16(4 * cells * C * D)
    nbr = _align16(mask + 4 * cells)
    return _align16(nbr + 4 * th * tw * k * D)


def knn_launch_shape(B: int, H: int, W: int, C: int, D: int, k: int, r: int,
                     sms: int) -> Tuple[int, int, int]:
    """(lanes per pixel, tile rows, tile columns) for the kernel on a card
    with `sms` multiprocessors. Among the tiles that fit in shared
    memory: the fewest lanes whose grid has a block for every
    multiprocessor, else FILL_LANES; more lanes (4x4 and 2x4 tiles) only
    where no larger tile fits. A block's time is mostly a chain of
    latencies that more lanes shorten only a little, while a second
    block on a multiprocessor shares its issue slots: at the coarse
    scales one block each on fewer multiprocessors was faster than two
    on every one (`python -m dcf_torch.tools.profile_knn`)."""
    fits = [(lanes, th, tw) for lanes, (th, tw) in KNN_TILES.items()
            if knn_smem_bytes(th, tw, C, D, k, r) <= SMEM_BYTES]
    if not fits:
        raise ValueError(f"knn_select_dense: no tile fits C={C}, D={D}, "
                         f"k={k}, r={r} in shared memory")
    fill = [shape for shape in fits if shape[0] <= FILL_LANES]
    for lanes, th, tw in fill:
        if B * -(-H // th) * -(-W // tw) >= sms:
            return (lanes, th, tw)
    return fill[-1] if fill else fits[0]


def knn_select_dense(bins: DenseBins, origin: Tuple[float, float],
                     cell_size: float, k: int, radius_cells: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K nearest point payloads for every grid cell centre (same arguments
    and results as `knn_select_plain`): the CUDA kernel for CUDA tensors,
    one launch per call, the plain version for CPU tensors. The kernel
    writes 0 into `nbr` where `valid` is False; its `valid`, `dist2` and
    the valid `nbr` rows equal the plain version's bit for bit.

    The kernel takes 1 <= k <= 8, C <= 32 bin slots, 2 <= D <= 16 payload
    columns and radius_cells <= 3, and raises a ValueError beyond them;
    the plain version on CPU tensors takes any shape."""
    return _select(bins, origin, cell_size, k, radius_cells)


def _select(bins: DenseBins, origin: Tuple[float, float], cell_size: float,
            k: int, radius_cells: int, lanes: Optional[int] = None):
    """`knn_select_dense` with `lanes` per pixel (default:
    `knn_launch_shape`'s choice)."""
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
    if not (1 <= k <= MAX_NEIGHBORS and 1 <= C <= MAX_SLOTS
            and MIN_COLS <= D <= MAX_COLS and 0 <= radius_cells <= MAX_RADIUS):
        raise ValueError(
            f"knn_select_dense: the kernel takes 1 <= k <= {MAX_NEIGHBORS}, "
            f"C <= {MAX_SLOTS}, {MIN_COLS} <= D <= {MAX_COLS} and "
            f"0 <= r <= {MAX_RADIUS}, got k={k}, C={C}, D={D}, "
            f"r={radius_cells}")
    if data.numel() >= 2 ** 31 or B * H * W * k * D >= 2 ** 31:
        raise ValueError("knn_select_dense: tensors too large for int32 "
                         "indices")
    dev = data.device
    nbr = torch.empty((B, H, W, k, D), dtype=torch.float32, device=dev)
    ok = torch.empty((B, H, W, k), dtype=torch.bool, device=dev)
    d2 = torch.empty((B, H, W, k), dtype=torch.float32, device=dev)
    if ok.numel():
        if lanes is None:
            lanes, th, tw = knn_launch_shape(B, H, W, C, D, k, radius_cells,
                                             _cuda.sm_count(dev))
        elif lanes in KNN_TILES:
            th, tw = KNN_TILES[lanes]
        else:
            raise ValueError(f"knn_select_dense: lanes={lanes} not in "
                             f"{tuple(KNN_TILES)}")
        err = _cuda.library().dcf_knn_select(
            data.data_ptr(), valid.data_ptr(), nbr.data_ptr(), ok.data_ptr(),
            d2.data_ptr(), B, H, W, C, D, k, radius_cells, lanes, th, tw,
            ctypes.c_float(origin[0]), ctypes.c_float(origin[1]),
            ctypes.c_float(cell_size),
            torch.cuda.current_stream(dev).cuda_stream)
        _cuda.check(err, "knn_select_dense")
        knn_select_dense.launches += 1
    return nbr, ok, d2


knn_select_dense.launches = 0
