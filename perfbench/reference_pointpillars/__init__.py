"""The plain reference of PointPillars (Lang et al., PointPillars: Fast
Encoders for Object Detection from Point Clouds, CVPR 2019,
arXiv:1812.05784, sec. 2-3: the KITTI car network), in float32 PyTorch
with no kernels, importing nothing of `dcf_torch`. It takes from the
frozen `perfbench/reference/` only the configuration classes, the ROI
crop, the anchors, the box decode, the rotated NMS and the plain clip,
unchanged.

  - pillarization: an explicit loop over the cropped points, in point
    order (`pillarize`);
  - the pillar feature net on the dense [P, N, 9] tensor: x, y, z, r,
    the offsets of x, y, z from the mean of the pillar's points, of x, y
    from the pillar's centre; empty slots zeroed before the linear
    layer; linear (no bias), BatchNorm1d as written, ReLU, the max over
    all N slots; the scatter onto the [C, grid_x, grid_y] canvas;
  - the backbone (sec. 2.2): Block(S, L, F) = L 3x3 convs (the first at
    stride 2), each with BatchNorm2d (eval mode, eps 1e-3) and ReLU;
    Up(S_in, S_out, F) = a transposed conv with kernel = stride, then
    BatchNorm2d and ReLU; the three maps concatenated;
  - the head: 1x1 convs for class, box and direction (SSD-style, sec.
    2.3), NHWC maps at stride 2 in the anchor layout of
    `perfbench/reference/models/anchors.py`.

Departures from the paper, each the program's too:
  - points and pillars over the caps are dropped by a fixed rule, not
    sampled at random: pillars are numbered in the order of their first
    point, a point whose pillar is numbered P or beyond is dropped, so is
    a point that arrives when its pillar holds N points;
  - the detection range is the authors' released [0, 69.12) x
    [-39.68, 39.68) m (432 x 496 pillars), since the paper's 70.4 x 80 m
    gives 440 x 500, which the stride-8 block cannot divide;
  - box coding, the direction classifier, per-class top-k before NMS and
    rotated NMS are the port's SECOND-style ones (the paper uses
    axis-aligned NMS);
  - `quant="fp8"` (the benchmark's control) rounds every conv and
    transposed conv of the backbone, input and kernel, through float8.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.config import Config, VoxelConfig
from perfbench.reference.data.voxelize import crop_and_pad_plain
from perfbench.reference.models.layers import fake_fp8

NUM_FEATURES = 9
BN_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class PillarConfig:
    """P pillars of N points, C features; Block i: block_layers[i] convs at
    C * 2**i channels; Up i: stride up_strides[i] to 2C channels."""

    max_pillars: int = 12000
    max_points: int = 100
    features: int = 64
    block_layers: Tuple[int, ...] = (4, 6, 6)
    up_strides: Tuple[int, ...] = (1, 2, 4)

    @property
    def block_channels(self) -> Tuple[int, ...]:
        return tuple(self.features * 2 ** i
                     for i in range(len(self.block_layers)))


@dataclasses.dataclass(frozen=True)
class Spec:
    """The configuration as run: the detector's grid, anchor and head
    (`Config`) and the pillar network's own (`PillarConfig`)."""

    detector: Config
    pillar: PillarConfig

    @property
    def voxel(self) -> VoxelConfig:
        return self.detector.voxel

    @classmethod
    def from_json(cls, text: str) -> "Spec":
        data = json.loads(text)
        rest = {k: v for k, v in data.items() if k != "pillars"}
        pillar = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in data["pillars"].items()}
        return cls(Config.from_json(json.dumps(rest)), PillarConfig(**pillar))


def example(frame, spec: Spec) -> Dict[str, np.ndarray]:
    """The cropped cloud: points [max_points, 4] f32, point_mask bool."""
    points, mask = crop_and_pad_plain(frame.points, spec.voxel)
    return {"points": points, "point_mask": mask}


def pillarize(points: np.ndarray, mask: np.ndarray, spec: Spec
              ) -> Dict[str, np.ndarray]:
    """The pillar tables of one cropped cloud, by a loop over its points:
    coords [P, 2], counts [P], mask [P], table [P, N] (point index per
    slot, -1 where empty), stats [3] (points in the ROI, points kept,
    non-empty cells). A point's cell is (floor((x - x_min) * inv),
    floor((y - y_min) * inv)) in float32, inv = float32(1 / voxel_size)."""
    vox, P, N = spec.voxel, spec.pillar.max_pillars, spec.pillar.max_points
    f32 = np.float32
    inv = f32(1.0 / vox.voxel_size)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    fx = np.floor((x - f32(vox.x_min)) * inv)
    fy = np.floor((y - f32(vox.y_min)) * inv)
    inroi = (mask & (fx >= 0) & (fx < vox.grid_x) & (fy >= 0)
             & (fy < vox.grid_y) & (z >= f32(vox.z_min)) & (z < f32(vox.z_max)))
    coords = np.zeros((P, 2), np.int32)
    counts = np.zeros((P,), np.int32)
    table = np.full((P, N), -1, np.int32)
    number: Dict[Tuple[int, int], int] = {}
    placed = 0
    for i in np.flatnonzero(inroi):
        cell = (int(fx[i]), int(fy[i]))
        p = number.get(cell)
        if p is None:                     # the cell's first point
            p = number[cell] = len(number)
            if p < P:
                coords[p] = cell
        if p >= P:
            continue                      # a pillar beyond the cap
        if counts[p] < N:
            table[p, counts[p]] = i
            counts[p] += 1
            placed += 1
    total = len(number)
    return {"coords": coords, "counts": counts,
            "mask": np.arange(P) < total, "table": table,
            "stats": np.array([inroi.sum(), placed, total], np.int32)}


class PillarFeatureNet(nn.Module):
    def __init__(self, pillar: PillarConfig):
        super().__init__()
        self.linear = nn.Linear(NUM_FEATURES, pillar.features, bias=False)
        self.norm = nn.BatchNorm1d(pillar.features, eps=BN_EPS)

    def forward(self, points: torch.Tensor, t: Dict[str, torch.Tensor],
                vox: VoxelConfig) -> torch.Tensor:
        """points [Pts, 4], the tables -> the canvas [C, grid_x, grid_y]."""
        P, N = t["table"].shape
        live = t["table"] >= 0                                  # [P, N]
        pts = points[t["table"].clamp(min=0).long()]            # [P, N, 4]
        pts = torch.where(live[..., None], pts, 0.0)
        cnt = live.sum(1, keepdim=True).clamp(min=1).to(torch.float32)
        mean = pts[..., :3].sum(1, keepdim=True) / cnt[..., None]
        centre = ((t["coords"].to(torch.float32) + 0.5) * vox.voxel_size
                  + torch.tensor([vox.x_min, vox.y_min],
                                 device=points.device))[:, None, :]
        feats = torch.cat([pts, pts[..., :3] - mean, pts[..., :2] - centre],
                          dim=-1)
        feats = torch.where(live[..., None], feats, 0.0)       # padding: 0
        h = self.norm(self.linear(feats).reshape(P * N, -1)).reshape(P, N, -1)
        best = F.relu(h).amax(1)                                # [P, C]
        canvas = torch.zeros((best.shape[1], vox.grid_x, vox.grid_y),
                             device=points.device)
        keep = t["mask"]
        ix, iy = t["coords"][keep, 0].long(), t["coords"][keep, 1].long()
        canvas[:, ix, iy] = best[keep].t()
        return canvas


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, quant: str):
        super().__init__()
        self.quant = quant
        self.conv = nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight
        if self.quant == "fp8":
            x, w = fake_fp8(x), fake_fp8(w)
        y = F.conv2d(x, w, stride=self.conv.stride, padding=1)
        return F.relu(self.bn(y))


class UpBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, quant: str):
        super().__init__()
        self.quant = quant
        self.deconv = nn.ConvTranspose2d(cin, cout, stride, stride,
                                         bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.deconv.weight
        if self.quant == "fp8":
            x, w = fake_fp8(x), fake_fp8(w)
        y = F.conv_transpose2d(x, w, stride=self.deconv.stride)
        return F.relu(self.bn(y))


class PillarBackbone(nn.Module):
    def __init__(self, pillar: PillarConfig, quant: str):
        super().__init__()
        self.blocks = nn.ModuleList()
        cin = pillar.features
        for layers, c in zip(pillar.block_layers, pillar.block_channels):
            self.blocks.append(nn.ModuleList(
                [ConvBNReLU(cin if i == 0 else c, c, 2 if i == 0 else 1,
                            quant) for i in range(layers)]))
            cin = c
        self.ups = nn.ModuleList(
            [UpBNReLU(c, 2 * pillar.features, s, quant) for c, s in
             zip(pillar.block_channels, pillar.up_strides)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        for block, up in zip(self.blocks, self.ups):
            for layer in block:
                x = layer(x)
            ups.append(up(x))
        return torch.cat(ups, dim=1)


class Head(nn.Module):
    def __init__(self, cfg: Config, cin: int):
        super().__init__()
        A = cfg.anchors_per_loc
        self.cls = nn.Conv2d(cin, A, 1)
        self.reg = nn.Conv2d(cin, A * 7, 1)
        self.dir = nn.Conv2d(cin, A * 2, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k)(x).permute(0, 2, 3, 1)
                for k in ("cls", "reg", "dir")}


class PointPillars(nn.Module):
    """One cropped cloud and its tables -> the NHWC head maps [1, H, W, k]."""

    def __init__(self, spec: Spec, quant: str = "off"):
        super().__init__()
        if not spec.detector.head.use_direction_classifier or \
                spec.detector.head.num_convs:
            raise ValueError("the reference head is 1x1 convs with a "
                             "direction classifier")
        self.spec = spec
        self.pfn = PillarFeatureNet(spec.pillar)
        self.backbone = PillarBackbone(spec.pillar, quant)
        self.head = Head(spec.detector, 2 * spec.pillar.features
                         * len(spec.pillar.up_strides))

    def forward(self, points: torch.Tensor, tables: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        canvas = self.pfn(points, tables, self.spec.voxel)
        return self.head(self.backbone(canvas[None]))


def tables_to(tables: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in tables.items()}
