"""KITTI calibration on the host (numpy), a copy of the numpy half of
`dcf.geometry.transforms`.

Frames: `velo` lidar (x fwd, y left, z up); `rect` rectified camera
(x right, y down, z fwd); `image` pixel (u right, v down). The model
sees one 3x4 matrix, ``M = P2 @ R0 @ Tr_velo_to_cam``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _to4x4(mat: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=np.float64)
    out[:mat.shape[0], :mat.shape[1]] = mat
    return out


class Calibration:
    """KITTI per-frame calibration."""

    def __init__(self, P2: np.ndarray, R0: np.ndarray,
                 Tr_velo_to_cam: np.ndarray):
        self.P2 = np.asarray(P2, np.float64).reshape(3, 4)
        self.R0 = _to4x4(np.asarray(R0, np.float64).reshape(3, 3))
        self.V2C = _to4x4(np.asarray(Tr_velo_to_cam, np.float64).reshape(3, 4))
        self.C2V = np.linalg.inv(self.V2C)
        self.R0_inv = np.linalg.inv(self.R0)

    @classmethod
    def from_kitti_calib_file(cls, path: str) -> "Calibration":
        fields = cls._parse(path)
        return cls(fields["P2"], fields["R0_rect"], fields["Tr_velo_to_cam"])

    @staticmethod
    def _parse(path: str) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line or ":" not in line:
                    continue
                key, vals = line.split(":", 1)
                out[key.strip()] = np.array(
                    [float(v) for v in vals.split()], np.float64)
        return out

    @classmethod
    def identity(cls, fu: float = 700.0, fv: float = 700.0,
                 cu: float = 620.0, cv: float = 190.0) -> "Calibration":
        """Synthetic calibration: velo->rect is the canonical axis
        permutation (x_c = -y_v, y_c = -z_v, z_c = x_v), pinhole P2."""
        P2 = np.array([[fu, 0, cu, 0], [0, fv, cv, 0], [0, 0, 1, 0]],
                      np.float64)
        Tr = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]],
                      np.float64)
        return cls(P2, np.eye(3), Tr)

    @staticmethod
    def _homo(pts: np.ndarray) -> np.ndarray:
        return np.concatenate(
            [pts, np.ones((*pts.shape[:-1], 1), pts.dtype)], axis=-1)

    def velo_to_rect(self, pts: np.ndarray) -> np.ndarray:
        return (self._homo(pts) @ (self.R0 @ self.V2C).T)[..., :3]

    def rect_to_velo(self, pts: np.ndarray) -> np.ndarray:
        return (self._homo(pts) @ (self.C2V @ self.R0_inv).T)[..., :3]

    def rect_to_image(self, pts: np.ndarray) -> np.ndarray:
        """[N, 3] rect -> [N, 3] (u, v, depth)."""
        uvw = self._homo(pts) @ self.P2.T
        depth = uvw[..., 2:3]
        return np.concatenate(
            [uvw[..., :2] / np.clip(depth, 1e-6, None), depth], axis=-1)

    def velo_to_image(self, pts: np.ndarray) -> np.ndarray:
        return self.rect_to_image(self.velo_to_rect(pts))

    @property
    def velo_to_image_matrix(self) -> np.ndarray:
        """The single 3x4 matrix the model consumes."""
        return (self.P2 @ self.R0 @ self.V2C).astype(np.float32)

    def flip_horizontal(self, image_width: int) -> "Calibration":
        """Calibration consistent with mirroring the image about its
        vertical axis and negating y in the velo frame."""
        mirror_img = np.array(
            [[-1, 0, image_width - 1.0], [0, 1, 0], [0, 0, 1]], np.float64)
        mirror_velo = np.diag([1.0, -1.0, 1.0, 1.0])
        P2 = mirror_img @ self.P2
        V2C = (self.V2C @ mirror_velo)[:3]
        return Calibration(P2, self.R0[:3, :3], V2C)
