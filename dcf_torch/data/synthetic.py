"""Synthetic KITTI-format frames on the host (numpy).

A copy of `dcf.data.synthetic.make_frame` / `make_varied_frame` /
`write_kitti_tree` and of `dcf.data.kitti.Frame`: the same numpy random
calls in the same order, so a seed gives a bit-equal frame in both
packages. Frames are a ground
plane plus box-shaped point clusters with matching labels, and an image
with bright blobs where the objects project.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dcf_torch.geometry.calib import Calibration

CLASS_NAMES = ("Car", "Pedestrian", "Cyclist")


@dataclasses.dataclass
class Frame:
    """One raw KITTI frame on the host."""

    frame_id: str
    points: np.ndarray            # [N, 4] float32 lidar (x, y, z, intensity)
    image: np.ndarray             # [H, W, 3] uint8 RGB
    calib: Calibration
    boxes: np.ndarray             # [M, 7] float32 lidar-frame box7
    labels: np.ndarray            # [M] int32 index into CLASS_NAMES
    difficulty: np.ndarray        # [M] int32 0=easy 1=moderate 2=hard -1=n/a
    names: List[str]              # [M] raw class strings (incl. DontCare etc)
    # raw camera-frame label fields (KITTI label format)
    truncated: Optional[np.ndarray] = None
    occluded: Optional[np.ndarray] = None
    alpha: Optional[np.ndarray] = None
    bbox2d: Optional[np.ndarray] = None
    # unfiltered label-file parse (incl. DontCare / Van / Person_sitting)
    raw_labels: Optional[Dict[str, np.ndarray]] = None


# KITTI-plausible calibration constants
_FU = 721.5377
_CU = 609.5593
_CV = 172.854
IMG_H, IMG_W = 375, 1242

_CLASS_DIMS = {  # (dx=l, dy=w, dz=h)
    "Car": (3.9, 1.6, 1.56),
    "Pedestrian": (0.8, 0.6, 1.73),
    "Cyclist": (1.76, 0.6, 1.73),
}


def default_calib() -> Calibration:
    return Calibration.identity(fu=_FU, fv=_FU, cu=_CU, cv=_CV)


def _box_surface_points(box7: np.ndarray, n: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Sample lidar-like points on the camera-facing surfaces of a box."""
    x, y, z, dx, dy, dz, yaw = box7
    # sample on the two faces nearest the sensor plus the top edge region
    u = rng.uniform(-0.5, 0.5, (n, 2))
    face = rng.integers(0, 2, n)
    local = np.zeros((n, 3))
    # face 0: side facing origin along local x; face 1: along local y
    local[:, 0] = np.where(face == 0, -0.5, u[:, 0]) * dx
    local[:, 1] = np.where(face == 0, u[:, 0], -0.5 * np.sign(y + 1e-9)) * dy
    local[:, 2] = u[:, 1] * dz
    c, s = np.cos(yaw), np.sin(yaw)
    wx = local[:, 0] * c - local[:, 1] * s + x
    wy = local[:, 0] * s + local[:, 1] * c + y
    wz = local[:, 2] + z
    return np.stack([wx, wy, wz], axis=-1)


def make_frame(frame_id: str = "000000",
               boxes: Optional[Sequence[Tuple[str, float, float, float]]]
               = None,
               n_ground: int = 8000, pts_per_box: int = 300,
               seed: int = 0) -> Frame:
    """Build one synthetic frame.

    Args:
      boxes: list of (class_name, x, y, yaw) in lidar frame; defaults to one
        Car, one Pedestrian, one Cyclist in front of the sensor.
    """
    rng = np.random.default_rng(seed)
    calib = default_calib()
    if boxes is None:
        boxes = [("Car", 15.0, 2.0, 0.3), ("Pedestrian", 10.0, -4.0, 1.2),
                 ("Cyclist", 22.0, 6.0, -0.7)]
    boxes7, labels, names = [], [], []
    for name, x, y, yaw in boxes:
        dx, dy, dz = _CLASS_DIMS[name]
        z = -1.73 + dz / 2.0          # resting on the ground plane
        boxes7.append([x, y, z, dx, dy, dz, yaw])
        labels.append(CLASS_NAMES.index(name))
        names.append(name)
    boxes7 = np.asarray(boxes7, np.float32).reshape(-1, 7)

    # ground plane points in the front view
    gx = rng.uniform(0.5, 69.0, n_ground)
    gy = rng.uniform(-39.0, 39.0, n_ground)
    gz = np.full(n_ground, -1.73) + rng.normal(0, 0.02, n_ground)
    ground = np.stack([gx, gy, gz], axis=-1)
    clusters = [_box_surface_points(b, pts_per_box, rng) for b in boxes7]
    pts = np.concatenate([ground] + clusters, axis=0)
    intensity = rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)
    points = np.concatenate([pts.astype(np.float32), intensity], axis=-1)

    # deterministic "image": smooth gradients + bright blobs where the
    # objects project, so fusion tests have signal to find
    yy, xx = np.mgrid[0:IMG_H, 0:IMG_W].astype(np.float32)
    img = np.stack([xx / IMG_W, yy / IMG_H, 0.5 * np.ones_like(xx)], axis=-1)
    centers_uvz = calib.velo_to_image(boxes7[:, :3])
    for (u, v, zc) in centers_uvz:
        if zc <= 0:
            continue
        r2 = (xx - u) ** 2 + (yy - v) ** 2
        img[..., 0] += 0.8 * np.exp(-r2 / (2 * 40.0 ** 2))
        img[..., 1] += 0.5 * np.exp(-r2 / (2 * 25.0 ** 2))
    image = (np.clip(img, 0, 1) * 255).astype(np.uint8)

    diff = np.zeros(len(boxes7), np.int32)
    # real projected 2D boxes (numpy, host data path): the devkit
    # evaluator height-filters *detections* by their projected box, so gt
    # boxes must use the same geometry or distant objects skew
    # easy-difficulty AP
    bbox2d = np.zeros((len(boxes7), 4), np.float32)
    for i, b in enumerate(boxes7):
        c, s = np.cos(b[6]), np.sin(b[6])
        cx = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * b[3] / 2
        cy = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * b[4] / 2
        cz = np.array([-1, -1, -1, -1, 1, 1, 1, 1]) * b[5] / 2
        corners = np.stack([b[0] + cx * c - cy * s,
                            b[1] + cx * s + cy * c,
                            b[2] + cz], axis=-1)
        uvz = calib.velo_to_image(corners)
        h, w = image.shape[:2]
        bbox2d[i] = [np.clip(uvz[:, 0].min(), 0, w - 1),
                     np.clip(uvz[:, 1].min(), 0, h - 1),
                     np.clip(uvz[:, 0].max(), 0, w - 1),
                     np.clip(uvz[:, 1].max(), 0, h - 1)]
    return Frame(frame_id=frame_id, points=points, image=image, calib=calib,
                 boxes=boxes7, labels=np.asarray(labels, np.int32),
                 difficulty=diff, names=names,
                 truncated=np.zeros(len(boxes7), np.float32),
                 occluded=np.zeros(len(boxes7), np.int32),
                 alpha=np.zeros(len(boxes7), np.float32), bbox2d=bbox2d)


def make_varied_frame(frame_id: str = "000000", seed: int = 0,
                      max_objects: int = 8,
                      n_ground: Optional[int] = None) -> Frame:
    """A synthetic frame with seed-varied scene composition.

    Unlike `make_frame` (fixed three-object layout, used by golden-fixture
    tests), this draws the object count, classes, positions, yaws and
    point density from the seed -- the distribution bench.py latency
    percentiles and the train/held-out generalization split are measured
    over. Objects are rejection-placed so boxes never overlap.
    """
    rng = np.random.default_rng([7, seed])
    n_obj = int(rng.integers(1, max_objects + 1))
    placed: List[Tuple[str, float, float, float]] = []
    centers: List[Tuple[float, float]] = []
    for _ in range(n_obj):
        name = CLASS_NAMES[int(rng.integers(0, len(CLASS_NAMES)))]
        for _attempt in range(10):
            x = float(rng.uniform(6.0, 60.0))
            y = float(rng.uniform(-0.75 * x, 0.75 * x))  # camera frustum
            if all((x - cx) ** 2 + (y - cy) ** 2 > 6.0 ** 2
                   for cx, cy in centers):
                placed.append((name, x, y, float(rng.uniform(-np.pi, np.pi))))
                centers.append((x, y))
                break
    if n_ground is None:
        n_ground = int(rng.integers(4000, 18000))
    return make_frame(frame_id=frame_id, boxes=placed, n_ground=n_ground,
                      pts_per_box=int(rng.integers(120, 400)),
                      seed=int(rng.integers(2 ** 31)))


class SyntheticDataset:
    """List-like dataset of deterministic synthetic frames (a copy of
    `dcf.cli.common.SyntheticDataset`): frame i is `make_frame(seed=i)`,
    or `make_varied_frame(seed=i)` with `varied`, the seed-varied scenes
    (1-8 objects, 4k-18k ground points)."""

    def __init__(self, num_frames: int = 16, varied: bool = False):
        self.num_frames = num_frames
        self.varied = varied

    def __len__(self) -> int:
        return self.num_frames

    def __getitem__(self, i: int) -> Frame:
        make = make_varied_frame if self.varied else make_frame
        return make(frame_id=f"{i:06d}", seed=i)


def write_kitti_tree(root: str, num_frames: int = 3,
                     split: str = "train") -> List[str]:
    """Materialize synthetic frames (`make_frame(seed=i)`) as an on-disk
    KITTI tree: the JAX package's bytes for the `.bin`, calib and label
    files; the PNGs from `dcf_torch.data.png` (the same pixels, other
    compressed bytes than PIL's)."""
    # imported here: dcf_torch.data.kitti imports this module
    from dcf_torch.data.kitti import box7_to_camera_label
    from dcf_torch.data.png import write_png
    subdir = os.path.join(root, "training")
    for d in ("velodyne", "image_2", "calib", "label_2"):
        os.makedirs(os.path.join(subdir, d), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    frame_ids = []
    for i in range(num_frames):
        frame_id = f"{i:06d}"
        frame_ids.append(frame_id)
        frame = make_frame(frame_id, seed=i)
        frame.points.tofile(
            os.path.join(subdir, "velodyne", frame_id + ".bin"))
        write_png(os.path.join(subdir, "image_2", frame_id + ".png"),
                  frame.image)
        calib = frame.calib
        with open(os.path.join(subdir, "calib", frame_id + ".txt"), "w") as f:
            p2 = " ".join(f"{v:.12e}" for v in calib.P2.reshape(-1))
            r0 = " ".join(f"{v:.12e}" for v in calib.R0[:3, :3].reshape(-1))
            tr = " ".join(f"{v:.12e}" for v in calib.V2C[:3].reshape(-1))
            f.write(f"P2: {p2}\nR0_rect: {r0}\nTr_velo_to_cam: {tr}\n")
        loc, dims_hwl, ry = box7_to_camera_label(frame.boxes, calib)
        with open(os.path.join(subdir, "label_2", frame_id + ".txt"),
                  "w") as f:
            for k, name in enumerate(frame.names):
                b = frame.bbox2d[k]
                f.write(
                    f"{name} 0.00 0 0.0 "
                    f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
                    f"{dims_hwl[k, 0]:.2f} {dims_hwl[k, 1]:.2f} "
                    f"{dims_hwl[k, 2]:.2f} "
                    f"{loc[k, 0]:.2f} {loc[k, 1]:.2f} {loc[k, 2]:.2f} "
                    f"{ry[k]:.2f}\n")
    with open(os.path.join(root, "ImageSets", f"{split}.txt"), "w") as f:
        f.write("\n".join(frame_ids) + "\n")
    return frame_ids
