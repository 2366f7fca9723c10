"""Host-side training augmentation (numpy), a copy of `dcf.data.augment`
on the port's own `Frame` and `Calibration`: the same numpy random calls
in the same order, so one `np.random.Generator` seed gives a bit-equal
frame in both packages.

All augmentation operates on the raw `Frame` before static-shape
preprocessing; randomness is driven by a `np.random.Generator` seeded
per (epoch, frame) so runs are reproducible.

- Horizontal flip: negates y in the lidar frame, mirrors the image,
  and rewrites the calibration so projection stays exact
  (Calibration.flip_horizontal) -- fully camera-consistent.
- Global yaw rotation / scaling (SECOND-style): lidar-frame only; they
  break the lidar->image alignment, so they are only applied when the
  model runs without fusion (cfg.with_fusion False) unless forced.
- GT-sampling: pastes objects (points + box) from an offline database
  into the frame with rotated-BEV collision checks. With
  `AugmentConfig.gt_sample_image_paste` (default on) the donor frame's
  image patch is pasted at the box's projection in the TARGET frame's
  camera (far-to-near, so near objects overdraw), keeping the camera
  stream consistent with the pasted lidar points — without it, fusion
  samples road/background pixels at pasted objects, starving the camera
  branch of augmented signal (the standard shortcut of fusion pipelines).
  Which points lie inside which boxes (the database's crops, the ground
  removed under pasted boxes) is decided by the compiled host core
  (`native.points_in_boxes3d`, bit-equal to `np_boxes.points_in_boxes3d`),
  which releases the interpreter lock, so the loader's threads run on.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

from dcf_torch import native
from dcf_torch.config import AugmentConfig
from dcf_torch.data.synthetic import CLASS_NAMES, Frame
from dcf_torch.geometry import np_boxes
from dcf_torch.utils import trace


def flip_frame(frame: Frame) -> Frame:
    """Calibration-consistent horizontal flip."""
    points = frame.points.copy()
    points[:, 1] = -points[:, 1]
    boxes = frame.boxes.copy()
    if len(boxes):
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
    image = frame.image[:, ::-1].copy()
    calib = frame.calib.flip_horizontal(frame.image.shape[1])
    return Frame(frame_id=frame.frame_id, points=points, image=image,
                 calib=calib, boxes=boxes, labels=frame.labels,
                 difficulty=frame.difficulty, names=frame.names,
                 truncated=frame.truncated, occluded=frame.occluded,
                 alpha=frame.alpha, bbox2d=frame.bbox2d)


def global_rotate(frame: Frame, angle: float) -> Frame:
    """Yaw-rotate points + boxes around the lidar origin (lidar-only aug:
    breaks camera alignment)."""
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]], np.float32)
    points = frame.points.copy()
    points[:, :2] = points[:, :2] @ R.T
    boxes = frame.boxes.copy()
    if len(boxes):
        boxes[:, :2] = boxes[:, :2] @ R.T
        boxes[:, 6] = boxes[:, 6] + angle
    return _with(frame, points=points, boxes=boxes)


def global_scale(frame: Frame, scale: float) -> Frame:
    """Uniformly scale the scene (lidar-only aug)."""
    points = frame.points.copy()
    points[:, :3] *= scale
    boxes = frame.boxes.copy()
    if len(boxes):
        boxes[:, :6] *= scale
    return _with(frame, points=points, boxes=boxes)


def _box_corners_3d(box7: np.ndarray) -> np.ndarray:
    """[7] (x, y, z, dx, dy, dz, yaw) -> [8, 3] lidar-frame corners."""
    x, y, z, dx, dy, dz, yaw = [float(v) for v in box7[:7]]
    sx = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64) * dx / 2
    sy = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64) * dy / 2
    sz = np.array([1, -1, 1, -1, 1, -1, 1, -1], np.float64) * dz / 2
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([x + c * sx - s * sy, y + s * sx + c * sy, z + sz], -1)


def _projected_rect(box7: np.ndarray, calib, image_shape):
    """Clipped integer image rect of the box's projection, or None when
    the box is behind the camera or the rect degenerates."""
    uvd = calib.velo_to_image(_box_corners_3d(box7))
    if (uvd[:, 2] <= 0.1).any():
        return None
    h, w = image_shape[:2]
    u0 = int(np.clip(np.floor(uvd[:, 0].min()), 0, w - 1))
    u1 = int(np.clip(np.ceil(uvd[:, 0].max()) + 1, 0, w))
    v0 = int(np.clip(np.floor(uvd[:, 1].min()), 0, h - 1))
    v1 = int(np.clip(np.ceil(uvd[:, 1].max()) + 1, 0, h))
    if u1 - u0 < 2 or v1 - v0 < 2:
        return None
    return u0, v0, u1, v1


def _resize_nearest(patch: np.ndarray, h: int, w: int) -> np.ndarray:
    ph, pw = patch.shape[:2]
    ri = np.minimum((np.arange(h) * ph / h).astype(np.int64), ph - 1)
    ci = np.minimum((np.arange(w) * pw / w).astype(np.int64), pw - 1)
    return patch[ri[:, None], ci[None, :]]


def _with(frame: Frame, **kw) -> Frame:
    args = dict(frame_id=frame.frame_id, points=frame.points,
                image=frame.image, calib=frame.calib, boxes=frame.boxes,
                labels=frame.labels, difficulty=frame.difficulty,
                names=frame.names, truncated=frame.truncated,
                occluded=frame.occluded, alpha=frame.alpha,
                bbox2d=frame.bbox2d)
    args.update(kw)
    return Frame(**args)


class GTDatabase:
    """Offline database of cropped ground-truth objects.

    Layout: {class_name: [{"box7": [7], "points": [N, 4] local (centered at
    box center, box-frame rotation preserved as-is)}]}, pickled; built
    with `GTDatabase.build` and loaded once per training run.
    """

    def __init__(self, db: Dict[str, List[dict]]):
        self.db = db

    @classmethod
    def load(cls, path: str) -> "GTDatabase":
        with open(path, "rb") as f:
            return cls(pickle.load(f))

    def save(self, path: str) -> None:
        import os
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.db, f)
        os.replace(tmp, path)

    @classmethod
    def build(cls, dataset, min_points: int = 8,
              with_image: bool = True) -> "GTDatabase":
        """dataset: any iterable of Frame.

        with_image: store each object's projected donor-image patch
        ("patch" + its rect) for camera-consistent pasting
        (gt_sample_frame); entries without a visible projection simply
        omit the key.
        """
        db: Dict[str, List[dict]] = {n: [] for n in CLASS_NAMES}
        for frame in dataset:
            if not len(frame.boxes):
                continue
            inside = native.points_in_boxes3d(frame.points[:, :3],
                                              frame.boxes)
            for k, name in enumerate(frame.names):
                if name not in db:
                    continue
                pts = frame.points[inside[:, k]]
                if len(pts) < min_points:
                    continue
                local = pts.copy()
                local[:, :3] -= frame.boxes[k, :3]
                entry = {"box7": frame.boxes[k].copy(), "points": local}
                if with_image and frame.image is not None:
                    rect = _projected_rect(frame.boxes[k], frame.calib,
                                           frame.image.shape)
                    if rect is not None:
                        u0, v0, u1, v1 = rect
                        entry["patch"] = frame.image[v0:v1, u0:u1].copy()
                db[name].append(entry)
        return cls(db)

    def sample(self, name: str, n: int,
               rng: np.random.Generator) -> List[dict]:
        pool = self.db.get(name, [])
        if not pool or n <= 0:
            return []
        idx = rng.choice(len(pool), size=min(n, len(pool)), replace=False)
        return [pool[i] for i in idx]


def gt_sample_frame(frame: Frame, db: GTDatabase, cfg: AugmentConfig,
                    rng: np.random.Generator) -> Frame:
    """Paste sampled objects into the frame with collision checks."""
    existing = (frame.boxes[:, [0, 1, 3, 4, 6]].copy()
                if len(frame.boxes) else np.zeros((0, 5)))
    new_points, new_boxes, new_labels, new_names = [], [], [], []
    new_objs = []
    for ci, name in enumerate(CLASS_NAMES):
        want = cfg.gt_sample_max[ci] if ci < len(cfg.gt_sample_max) else 0
        have = int((frame.labels == ci).sum()) if len(frame.labels) else 0
        for obj in db.sample(name, want - have, rng):
            box = obj["box7"]
            bev = box[[0, 1, 3, 4, 6]][None]
            all_prev = (np.concatenate([existing] +
                                       [b[[0, 1, 3, 4, 6]][None]
                                        for b in new_boxes])
                        if new_boxes else existing)
            if len(all_prev) and np_boxes.boxes_collide_bev(
                    bev, all_prev, margin=0.1).any():
                continue
            pts = obj["points"].copy()
            pts[:, :3] += box[:3]
            new_points.append(pts)
            new_boxes.append(box)
            new_labels.append(ci)
            new_names.append(name)
            new_objs.append(obj)
    if not new_boxes:
        return frame

    # camera-consistent pasting: project each pasted box into the TARGET
    # frame's camera and paste the donor patch there, far-to-near so
    # nearer objects overdraw
    image = frame.image
    rects = [None] * len(new_boxes)
    if (cfg.gt_sample_image_paste and frame.image is not None
            and any("patch" in o for o in new_objs)):
        image = frame.image.copy()
        depth = [float(np.hypot(b[0], b[1])) for b in new_boxes]
        for i in np.argsort(depth)[::-1]:
            obj, box = new_objs[i], new_boxes[i]
            if "patch" not in obj:
                continue
            rect = _projected_rect(box, frame.calib, image.shape)
            if rect is None:
                continue
            u0, v0, u1, v1 = rect
            image[v0:v1, u0:u1] = _resize_nearest(
                obj["patch"], v1 - v0, u1 - u0)
            rects[i] = rect

    # remove original points inside the pasted boxes (they were ground)
    pasted = np.stack(new_boxes)
    with trace.span("augment.gt_sample.inside"):
        inside = native.points_in_boxes3d(frame.points[:, :3], pasted,
                                          any_box=True)
    points = np.concatenate([frame.points[~inside]] + new_points)
    boxes = (np.concatenate([frame.boxes, pasted]) if len(frame.boxes)
             else pasted.astype(np.float32))
    labels = np.concatenate([frame.labels,
                             np.asarray(new_labels, np.int32)])
    n_new = len(new_boxes)
    # keep every per-object array of Frame parallel: pasted objects get
    # neutral camera-frame label fields (misaligned lengths would break
    # any later per-box indexing of these fields)
    aux = {}
    for field, fill in (("truncated", np.zeros(n_new, np.float32)),
                        ("occluded", np.zeros(n_new, np.int32)),
                        ("alpha", np.zeros(n_new, np.float32))):
        old = getattr(frame, field)
        if old is not None:
            aux[field] = np.concatenate([old, fill])
    if frame.bbox2d is not None:
        h, w = frame.image.shape[:2]
        full = np.array([0.0, 0.0, w - 1.0, h - 1.0], np.float32)
        b2d = np.stack([np.array(r, np.float32) if r is not None else full
                        for r in rects])     # rect is (u0, v0, u1, v1)
        aux["bbox2d"] = np.concatenate([frame.bbox2d, b2d])
    return _with(
        frame, points=points.astype(np.float32), image=image,
        boxes=boxes.astype(np.float32), labels=labels,
        names=list(frame.names) + new_names,
        difficulty=np.concatenate([frame.difficulty,
                                   np.zeros(n_new, np.int32)]), **aux)


def augment_frame(frame: Frame, cfg: AugmentConfig,
                  rng: np.random.Generator,
                  db: Optional[GTDatabase] = None,
                  lidar_only_augs: bool = False) -> Frame:
    """Full training-time augmentation pipeline for one frame."""
    with trace.span("augment"):
        if db is not None and cfg.gt_sampling:
            with trace.span("augment.gt_sample"):
                frame = gt_sample_frame(frame, db, cfg, rng)
        if rng.uniform() < cfg.flip_prob:
            with trace.span("augment.flip"):
                frame = flip_frame(frame)
        if lidar_only_augs:
            if cfg.global_rotation > 0:
                with trace.span("augment.rotate"):
                    frame = global_rotate(
                        frame, rng.uniform(-cfg.global_rotation,
                                           cfg.global_rotation))
            lo, hi = cfg.global_scale
            if hi > lo:
                with trace.span("augment.scale"):
                    frame = global_scale(frame, rng.uniform(lo, hi))
        return frame
