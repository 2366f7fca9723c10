"""KITTI object-detection frame reader and result writer, a copy of
`dcf.data.kitti` without PIL (images go through `dcf_torch.data.png`).

Parses the standard KITTI object layout:

    root/
      training/velodyne/{frame}.bin    float32 Nx4 (x, y, z, intensity)
      training/image_2/{frame}.png     left color image
      training/calib/{frame}.txt       projection matrices
      training/label_2/{frame}.txt     object labels (camera frame)
      ImageSets/{train,val}.txt        split lists (optional)

Labels are converted at load time from the KITTI camera-frame convention
(location = bottom-face center, dims (h, w, l), rotation_y around y_cam)
into the lidar-frame box7 convention (center x/y/z, dims (dx=l, dy=w,
dz=h), yaw CCW around +z up).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from dcf_torch.data.png import read_png
from dcf_torch.data.synthetic import CLASS_NAMES, Frame
from dcf_torch.geometry.calib import Calibration
from dcf_torch.geometry.np_boxes import boxes3d_corners


def camera_label_to_box7(location: np.ndarray, dims_hwl: np.ndarray,
                         rotation_y: np.ndarray,
                         calib: Calibration) -> np.ndarray:
    """KITTI camera-frame label -> lidar-frame box7.

    location: [M, 3] bottom-face centers in rect camera frame.
    dims_hwl: [M, 3] (h, w, l).
    rotation_y: [M] yaw around y_cam (down).
    """
    location = np.asarray(location, np.float64).reshape(-1, 3)
    dims_hwl = np.asarray(dims_hwl, np.float64).reshape(-1, 3)
    rotation_y = np.asarray(rotation_y, np.float64).reshape(-1)
    h, w, l = dims_hwl[:, 0], dims_hwl[:, 1], dims_hwl[:, 2]
    center_cam = location.copy()
    center_cam[:, 1] -= h / 2.0          # bottom center -> geometric center
    center_velo = calib.rect_to_velo(center_cam)
    # rotation_y = 0 means heading along +x_cam (right); x_cam maps to
    # -y_velo, so yaw_velo = -rotation_y - pi/2.
    yaw = -rotation_y - np.pi / 2.0
    yaw = (yaw + np.pi) % (2 * np.pi) - np.pi
    return np.stack([center_velo[:, 0], center_velo[:, 1], center_velo[:, 2],
                     l, w, h, yaw], axis=-1).astype(np.float32)


def box7_to_camera_label(boxes7: np.ndarray, calib: Calibration):
    """Inverse of camera_label_to_box7: box7 -> (location, dims_hwl, ry)."""
    boxes7 = np.asarray(boxes7, np.float64).reshape(-1, 7)
    center_velo = boxes7[:, :3]
    center_cam = calib.velo_to_rect(center_velo)
    h = boxes7[:, 5]
    location = center_cam.copy()
    location[:, 1] += h / 2.0
    dims_hwl = np.stack([boxes7[:, 5], boxes7[:, 4], boxes7[:, 3]], axis=-1)
    ry = -(boxes7[:, 6] + np.pi / 2.0)
    ry = (ry + np.pi) % (2 * np.pi) - np.pi
    return location, dims_hwl, ry


def compute_difficulty(truncated, occluded, bbox2d) -> np.ndarray:
    """Standard KITTI difficulty buckets from 2D box height/occl/trunc."""
    height = bbox2d[:, 3] - bbox2d[:, 1]
    diff = np.full(len(height), -1, np.int32)
    hard = (height >= 25) & (occluded <= 2) & (truncated <= 0.5)
    mod = (height >= 25) & (occluded <= 1) & (truncated <= 0.3)
    easy = (height >= 40) & (occluded <= 0) & (truncated <= 0.15)
    diff[hard] = 2
    diff[mod] = 1
    diff[easy] = 0
    return diff


def parse_label_file(path: str, calib: Calibration) -> Dict[str, np.ndarray]:
    """Parse one KITTI label_2 txt into arrays (camera + lidar frames)."""
    names, trunc, occ, alpha, bbox, dims, loc, ry = ([] for _ in range(8))
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 15:
                    continue
                names.append(parts[0])
                trunc.append(float(parts[1]))
                occ.append(float(parts[2]))
                alpha.append(float(parts[3]))
                bbox.append([float(v) for v in parts[4:8]])
                # KITTI order: h, w, l, x, y, z, ry
                dims.append([float(v) for v in parts[8:11]])
                loc.append([float(v) for v in parts[11:14]])
                ry.append(float(parts[14]))
    n = len(names)
    out = {
        "names": names,
        "truncated": np.asarray(trunc, np.float32).reshape(n),
        "occluded": np.asarray(occ, np.float32).reshape(n),
        "alpha": np.asarray(alpha, np.float32).reshape(n),
        "bbox2d": np.asarray(bbox, np.float32).reshape(n, 4),
        "dims_hwl": np.asarray(dims, np.float32).reshape(n, 3),
        "location": np.asarray(loc, np.float32).reshape(n, 3),
        "rotation_y": np.asarray(ry, np.float32).reshape(n),
    }
    out["boxes7"] = (camera_label_to_box7(out["location"], out["dims_hwl"],
                                          out["rotation_y"], calib)
                     if n else np.zeros((0, 7), np.float32))
    out["difficulty"] = (compute_difficulty(out["truncated"], out["occluded"],
                                            out["bbox2d"])
                         if n else np.zeros((0,), np.int32))
    return out


class KittiDataset:
    """Random-access KITTI object dataset: frame i -> `Frame` (points,
    image, calib, labels)."""

    def __init__(self, root: str, split: str = "train",
                 subdir: Optional[str] = None):
        self.root = root
        self.split = split
        self.subdir = subdir or ("testing" if split == "test" else "training")
        split_file = os.path.join(root, "ImageSets", f"{split}.txt")
        if os.path.exists(split_file):
            with open(split_file) as f:
                self.frame_ids = [ln.strip() for ln in f if ln.strip()]
        else:
            velo_dir = os.path.join(root, self.subdir, "velodyne")
            self.frame_ids = sorted(
                os.path.splitext(f)[0] for f in os.listdir(velo_dir)
                if f.endswith(".bin"))

    def __len__(self) -> int:
        return len(self.frame_ids)

    def _path(self, kind: str, frame_id: str, ext: str) -> str:
        return os.path.join(self.root, self.subdir, kind, frame_id + ext)

    def read_points(self, frame_id: str) -> np.ndarray:
        # the numpy path of `dcf.native.read_velodyne`: every point of the
        # file (its C++ path stops at 200,000 points; a KITTI sweep has
        # about 120,000)
        return np.fromfile(self._path("velodyne", frame_id, ".bin"),
                           dtype=np.float32).reshape(-1, 4)

    def read_image(self, frame_id: str) -> np.ndarray:
        return read_png(self._path("image_2", frame_id, ".png"))

    def read_calib(self, frame_id: str) -> Calibration:
        return Calibration.from_kitti_calib_file(
            self._path("calib", frame_id, ".txt"))

    def __getitem__(self, index: int) -> Frame:
        frame_id = self.frame_ids[index]
        calib = self.read_calib(frame_id)
        label = parse_label_file(self._path("label_2", frame_id, ".txt"),
                                 calib)
        keep = np.array([n in CLASS_NAMES for n in label["names"]], bool)
        keep = keep.reshape(-1)
        labels = np.array(
            [CLASS_NAMES.index(n) for n, k in zip(label["names"], keep) if k],
            np.int32)
        return Frame(
            frame_id=frame_id,
            points=self.read_points(frame_id),
            image=self.read_image(frame_id),
            calib=calib,
            boxes=label["boxes7"][keep].reshape(-1, 7),
            labels=labels,
            difficulty=label["difficulty"][keep],
            names=[n for n, k in zip(label["names"], keep) if k],
            truncated=label["truncated"][keep],
            occluded=label["occluded"][keep],
            alpha=label["alpha"][keep],
            bbox2d=label["bbox2d"][keep],
            raw_labels=label,
        )


def write_kitti_result(path: str, names: Sequence[str], boxes7: np.ndarray,
                       scores: np.ndarray, calib: Calibration,
                       image_shape=None) -> None:
    """Write detections in KITTI result format (16 fields a line)."""
    boxes7 = np.asarray(boxes7).reshape(-1, 7)
    loc, dims_hwl, ry = box7_to_camera_label(boxes7, calib)
    corners = boxes3d_corners(boxes7)
    lines = []
    for i, name in enumerate(names):
        uvz = calib.velo_to_image(corners[i])
        u, v = uvz[:, 0], uvz[:, 1]
        bbox = [float(u.min()), float(v.min()), float(u.max()), float(v.max())]
        if image_shape is not None:
            bbox[0] = max(bbox[0], 0.0)
            bbox[1] = max(bbox[1], 0.0)
            bbox[2] = min(bbox[2], image_shape[1] - 1.0)
            bbox[3] = min(bbox[3], image_shape[0] - 1.0)
        alpha = float(ry[i] - np.arctan2(loc[i, 0], loc[i, 2]))
        lines.append(
            f"{name} 0.00 0 {alpha:.2f} "
            f"{bbox[0]:.2f} {bbox[1]:.2f} {bbox[2]:.2f} {bbox[3]:.2f} "
            f"{dims_hwl[i, 0]:.2f} {dims_hwl[i, 1]:.2f} {dims_hwl[i, 2]:.2f} "
            f"{loc[i, 0]:.2f} {loc[i, 1]:.2f} {loc[i, 2]:.2f} "
            f"{ry[i]:.2f} {float(scores[i]):.4f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
