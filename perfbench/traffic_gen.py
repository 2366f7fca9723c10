"""The one traffic generator: a pool of KITTI-like frames from a seed.

A frozen copy of `dcf_torch.data.synthetic.make_varied_frame` (commit
fab139f), with two changes that a benchmark needs:

  - the sizes of a pool's frames (objects, ground points, points per
    object) are one fixed set, spread evenly over the mix's ranges, that
    every seed shares; the seed sets their order, the classes, positions
    and yaws, and every point. So two seeds ask for the same work;
  - each sweep is padded to `sweep_points` with points outside the ROI
    (behind the vehicle, beyond its range, above its height), shuffled
    into the sweep, as a KITTI HDL-64E sweep holds ~120,000 points of
    which the ROI keeps a fraction.

The frame itself (ground plane, surface clusters, image with bright
blobs where the objects project) is `make_frame`, copied unchanged into
`perfbench/reference/data/synthetic.py`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from perfbench.reference.data.synthetic import (CLASS_NAMES, Frame,
                                                make_frame)


def pool_sizes(gen: Dict, pool: int) -> List[Tuple[int, int, int]]:
    """(objects, ground points, points per object) of each pool slot: the
    same set for every seed."""
    lo_o, hi_o = gen["objects"]
    lo_g, hi_g = gen["ground_points"]
    lo_p, hi_p = gen["points_per_object"]
    frac = np.linspace(0.0, 1.0, pool)
    sizes = []
    for j in range(pool):
        sizes.append((lo_o + j % (hi_o - lo_o + 1),
                      int(round(lo_g + (hi_g - lo_g) * frac[(j * 37) % pool])),
                      int(round(lo_p + (hi_p - lo_p) * frac[(j * 23) % pool]))))
    return sizes


def _place(rng: np.random.Generator, n_obj: int
           ) -> List[Tuple[str, float, float, float]]:
    """`make_varied_frame`'s placement: classes, positions in the camera
    frustum 6-60 m ahead, at least 6 m apart, yaws."""
    placed, centers = [], []
    for _ in range(n_obj):
        name = CLASS_NAMES[int(rng.integers(0, len(CLASS_NAMES)))]
        for _attempt in range(10):
            x = float(rng.uniform(6.0, 60.0))
            y = float(rng.uniform(-0.75 * x, 0.75 * x))
            if all((x - cx) ** 2 + (y - cy) ** 2 > 6.0 ** 2
                   for cx, cy in centers):
                placed.append((name, x, y, float(rng.uniform(-np.pi, np.pi))))
                centers.append((x, y))
                break
    return placed


def _pad_sweep(points: np.ndarray, total: int,
               rng: np.random.Generator) -> np.ndarray:
    """Pad to `total` points with thirds behind the vehicle (x < 0),
    beyond 70.4 m and above the ROI's 1 m ceiling, then shuffle."""
    n = total - len(points)
    if n < 0:
        raise ValueError(f"sweep of {len(points)} points exceeds {total}")
    k = [n // 3, n // 3, n - 2 * (n // 3)]
    behind = np.stack([rng.uniform(-70.0, -0.5, k[0]),
                       rng.uniform(-40.0, 40.0, k[0]),
                       rng.uniform(-2.5, 0.5, k[0])], -1)
    far = np.stack([rng.uniform(71.0, 120.0, k[1]),
                    rng.uniform(-60.0, 60.0, k[1]),
                    rng.uniform(-2.5, 0.5, k[1])], -1)
    high = np.stack([rng.uniform(0.5, 69.0, k[2]),
                     rng.uniform(-39.0, 39.0, k[2]),
                     rng.uniform(1.2, 3.0, k[2])], -1)
    pad = np.concatenate([behind, far, high]).astype(np.float32)
    pad = np.concatenate([pad, rng.uniform(0, 1, (n, 1)).astype(np.float32)],
                         -1)
    sweep = np.concatenate([points.astype(np.float32), pad])
    return sweep[rng.permutation(len(sweep))]


def make_pool(gen: Dict, pool: int, seed: int) -> List[Frame]:
    """The mix's pool of frames for `seed` (any non-negative integer)."""
    rng = np.random.default_rng([7, seed])
    sizes = pool_sizes(gen, pool)
    order = rng.permutation(pool)
    frames = []
    for i, j in enumerate(order):
        n_obj, n_ground, per_obj = sizes[j]
        boxes = _place(rng, n_obj)
        frame = make_frame(frame_id=f"{i:06d}", boxes=boxes,
                           n_ground=n_ground, pts_per_box=per_obj,
                           seed=int(rng.integers(2 ** 31)))
        frame.points = _pad_sweep(frame.points, gen["sweep_points"], rng)
        frames.append(frame)
    return frames
