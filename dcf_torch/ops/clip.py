"""Intersection areas of rotated BEV rectangle pairs: the CUDA kernel and
its plain version.

Replaces the TPU kernel `dcf/ops/pallas/clip_kernel.py::_clip_kernel`.
The plain version is `dcf_torch.geometry.boxes.rotated_intersection_area`
(a sort-free Sutherland-Hodgman clip mirroring the reference op for op);
the kernel (`dcf_torch/csrc/clip.cu`) runs the same operations per pair
with the vertex buffers in registers.
"""

from __future__ import annotations

import torch

from dcf_torch.geometry.boxes import rotated_intersection_area
from dcf_torch.ops import _cuda


# the plain version: [N, 5] x [N, 5] (x, y, dx, dy, yaw) -> [N] f32 areas
# of a's rectangle clipped by b's edges
rotated_intersection_area_pairs_plain = rotated_intersection_area


def rotated_intersection_area_pairs(boxes_a: torch.Tensor,
                                    boxes_b: torch.Tensor) -> torch.Tensor:
    """Elementwise intersection areas: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if boxes_a.device.type == "cpu":
        return rotated_intersection_area_pairs_plain(boxes_a, boxes_b)
    if boxes_a.device.type != "cuda":
        raise ValueError(
            f"rotated_intersection_area_pairs: no kernel for {boxes_a.device}")
    n = boxes_a.shape[0]
    for name, t in (("boxes_a", boxes_a), ("boxes_b", boxes_b)):
        if t.device != boxes_a.device or t.dtype != torch.float32 or \
                tuple(t.shape) != (n, 5) or not t.is_contiguous():
            raise ValueError(
                f"rotated_intersection_area_pairs: {name} must be a "
                f"contiguous float32 ({n}, 5) tensor on {boxes_a.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if 5 * n >= 2 ** 31:
        raise ValueError("rotated_intersection_area_pairs: too many pairs")
    out = torch.empty((n,), dtype=torch.float32, device=boxes_a.device)
    if n == 0:
        return out
    err = _cuda.library().dcf_clip_pairs(
        boxes_a.data_ptr(), boxes_b.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(boxes_a.device).cuda_stream)
    _cuda.check(err, "rotated_intersection_area_pairs")
    rotated_intersection_area_pairs.launches += 1
    return out


rotated_intersection_area_pairs.launches = 0
