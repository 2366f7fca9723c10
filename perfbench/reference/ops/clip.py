"""Intersection areas of rotated BEV rectangle pairs, plain PyTorch: the
sort-free Sutherland-Hodgman clip of `geometry/boxes.py`."""

from __future__ import annotations

from perfbench.reference.geometry.boxes import rotated_intersection_area

# [N, 5] x [N, 5] (x, y, dx, dy, yaw) -> [N] f32 areas of a's rectangle
# clipped by b's edges
rotated_intersection_area_pairs = rotated_intersection_area
