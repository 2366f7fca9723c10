"""BEV pseudo-image rasterization.

Host side, `crop_and_pad` (numpy) turns a
variable-N cloud into the static `(points[max_points, 4],
mask[max_points])` pair. Device side,
`rasterize_bev_s2d` (torch scatters) emits the PIXOR-style pseudo-image,
one binary-occupancy channel per height slice plus mean intensity,
directly in the space-to-depth(2) layout the first BEV stage consumes.
Mirrors `dcf.data.voxelize`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from perfbench.reference.config import VoxelConfig


def crop_and_pad_plain(points: np.ndarray, cfg: VoxelConfig,
                       shuffle: bool = False, seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """`crop_and_pad` in numpy, and the path of a crop that fills every
    slot (the subsampling policy lives here). Compares float32 points
    with the ROI bounds in float32, where the compiled crop compares in
    float64: the two differ only for a point that equals a bound's
    float32 rounding when that rounding is below the bound."""
    points = np.asarray(points, np.float32).reshape(-1, 4)
    keep = ((points[:, 0] >= cfg.x_min) & (points[:, 0] < cfg.x_max)
            & (points[:, 1] >= cfg.y_min) & (points[:, 1] < cfg.y_max)
            & (points[:, 2] >= cfg.z_min) & (points[:, 2] < cfg.z_max))
    pts = points[keep]
    if shuffle or len(pts) > cfg.max_points:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(pts))
        pts = pts[order[:cfg.max_points]]
    out = np.zeros((cfg.max_points, 4), np.float32)
    mask = np.zeros((cfg.max_points,), bool)
    n = min(len(pts), cfg.max_points)
    out[:n] = pts[:n]
    mask[:n] = True
    return out, mask


crop_and_pad = crop_and_pad_plain


def rasterize_bev_s2d(points: torch.Tensor, mask: torch.Tensor,
                      cfg: VoxelConfig,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, P, 4] points + [B, P] mask -> [B, gx/2, gy/2, 4 * (nz + 1)].

    Channel (a*2 + b)*(nz+1) + c of pixel (p, q) is channel c of the
    full-resolution raster at (2p+a, 2q+b): channels [0, nz) are
    per-slice occupancy, channel nz the mean intensity of the cell's
    points (0 where empty). Occupancy is a scatter of ones (the
    reference's scatter-max of 1 into zeros); intensity sum and count
    ride one [P, 2] scatter-add in float32, and only the mean is cast to
    `dtype`. Out-of-grid points scatter into one extra row that is cut
    off, so no host synchronisation is needed.
    """
    B, P, _ = points.shape
    dev = points.device
    gx, gy, nz = cfg.grid_x, cfg.grid_y, cfg.num_z_slices
    gxh, gyh = gx // 2, gy // 2
    inv_vox = 1.0 / cfg.voxel_size
    inv_slice = 1.0 / cfg.z_slice_size
    ix = torch.floor((points[..., 0] - cfg.x_min) * inv_vox).to(torch.int64)
    iy = torch.floor((points[..., 1] - cfg.y_min) * inv_vox).to(torch.int64)
    iz = torch.floor((points[..., 2] - cfg.z_min) * inv_slice).to(torch.int64)
    inb = (mask & (ix >= 0) & (ix < gx) & (iy >= 0) & (iy < gy)
           & (iz >= 0) & (iz < nz))

    bi = torch.arange(B, device=dev)[:, None].expand(B, P)
    ixh = torch.where(inb, ix >> 1, gxh)             # gxh == drop row
    iyh = torch.where(inb, iy >> 1, 0)
    izs = torch.where(inb, iz, 0)
    blk = torch.where(inb, (ix & 1) * 2 + (iy & 1), 0)

    occ = torch.zeros((B, gxh + 1, gyh, 4, nz), dtype=dtype, device=dev)
    occ.index_put_((bi, ixh, iyh, blk, izs),
                   torch.ones((), dtype=dtype, device=dev))

    cell = ((bi * (gxh + 1) + ixh) * gyh + iyh) * 4 + blk
    upd = torch.stack([torch.where(inb, points[..., 3], 0.0),
                       inb.to(torch.float32)], dim=-1)
    pair = torch.zeros((B * (gxh + 1) * gyh * 4, 2), dtype=torch.float32,
                       device=dev)
    pair.index_add_(0, cell.reshape(-1), upd.reshape(-1, 2))
    inten = (pair[:, 0] / torch.clamp(pair[:, 1], min=1.0)).reshape(
        B, gxh + 1, gyh, 4, 1)
    out = torch.cat([occ, inten.to(dtype)], dim=-1)[:, :gxh]
    return out.reshape(B, gxh, gyh, 4 * (nz + 1))
