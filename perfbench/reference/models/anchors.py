"""Dense BEV anchor grid (numpy), a copy of `dcf.models.anchors`.

Layout contract (shared by head and decode):
  anchors: [H * W * A, 7] where H = grid_x / head_stride,
  W = grid_y / head_stride, and A = sum over classes of len(rotations).
  The per-location axis A is ordered class-major then rotation.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.reference.config import Config


def anchor_grid_shape(cfg: Config) -> Tuple[int, int, int]:
    s = cfg.backbone.head_stride
    return (cfg.voxel.grid_x // s, cfg.voxel.grid_y // s,
            cfg.anchors_per_loc)


def generate_anchors(cfg: Config) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
    """Build the dense anchor set.

    Returns:
      anchors:   [N, 7] float32 box7s.
      classes:   [N] int32 class index per anchor.
      match_thr: [N] float32 matched IoU threshold per anchor.
      unmatch_thr: [N] float32 unmatched IoU threshold per anchor.
    """
    H, W, A = anchor_grid_shape(cfg)
    vox = cfg.voxel
    cell = vox.voxel_size * cfg.backbone.head_stride
    xs = vox.x_min + (np.arange(H) + 0.5) * cell
    ys = vox.y_min + (np.arange(W) + 0.5) * cell
    per_loc = []          # [(size3, z, rot, class_idx, m_thr, u_thr)]
    for ci, a in enumerate(cfg.anchors):
        for rot in a.rotations:
            per_loc.append((a.size, a.z_center, rot, ci,
                            a.matched_threshold, a.unmatched_threshold))
    assert len(per_loc) == A

    gx, gy = np.meshgrid(xs, ys, indexing="ij")              # [H, W]
    anchors = np.zeros((H, W, A, 7), np.float32)
    classes = np.zeros((A,), np.int32)
    m_thr = np.zeros((A,), np.float32)
    u_thr = np.zeros((A,), np.float32)
    for k, (size, z, rot, ci, mt, ut) in enumerate(per_loc):
        anchors[..., k, 0] = gx
        anchors[..., k, 1] = gy
        anchors[..., k, 2] = z
        anchors[..., k, 3:6] = size
        anchors[..., k, 6] = rot
        classes[k] = ci
        m_thr[k] = mt
        u_thr[k] = ut
    n = H * W * A
    return (anchors.reshape(n, 7),
            np.tile(classes, H * W),
            np.tile(m_thr, H * W),
            np.tile(u_thr, H * W))


def anchor_pack(cfg: Config, device) -> Dict[str, torch.Tensor]:
    """The anchor arrays the target assigner reads, as tensors on
    `device`, built once per run: boxes [N, 7] f32, classes [N] int64,
    matched_thr / unmatched_thr [N] f32."""
    boxes, classes, m_thr, u_thr = generate_anchors(cfg)
    return {"boxes": torch.from_numpy(boxes).to(device),
            "classes": torch.from_numpy(classes).to(torch.int64).to(device),
            "matched_thr": torch.from_numpy(m_thr).to(device),
            "unmatched_thr": torch.from_numpy(u_thr).to(device)}
