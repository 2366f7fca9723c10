"""PointPillars (Lang et al., CVPR 2019, arXiv:1812.05784): the KITTI car
network of sec. 2-3 on the port's serving path.

batch -> pillars (`ops.pillars.pillarize`, on the device) -> the pillar
feature net fused with its scatter onto the [B, 432, 496, 64] canvas
(`ops.pillars.pfn_scatter`) -> three blocks of 3x3 conv + BatchNorm +
ReLU (4, 6, 6 layers at 64 / 128 / 256 channels, the first of each at
stride 2) -> three transposed convs (kernel = stride 1, 2, 4) + BatchNorm
+ ReLU to 128 channels each, concatenated to 384 -> the SSD-style 1x1
head (`DetectionHead` with no convs) at stride 2.

The detector takes the batch dict that `ContFuseDetector` takes (it
reads `points` and `point_mask`) and gives the same NHWC `cls` / `reg` /
`dir` maps, so `make_inference_fn` serves it. The voxel grid, the anchor,
the head and its stride are a `Config`; what only a pillar network has
(P, N, C, the blocks, the upsampling) is its own `PillarConfig`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dcf_torch.config import (AnchorConfig, BackboneConfig, Config,
                              HeadConfig, VoxelConfig)
from dcf_torch.data.synthetic import Frame
from dcf_torch.data.voxelize import crop_and_pad
from dcf_torch.device import resolve_device
from dcf_torch.models.head import PRIOR_BIAS, DetectionHead
from dcf_torch.ops.pillars import NUM_FEATURES, pfn_scatter, pillarize
from dcf_torch.utils import trace

# the paper's Car anchor (sec. 3): w 1.6, l 3.9, h 1.5 m, z centre -1 m
PP_CAR_ANCHOR = AnchorConfig("Car", (3.9, 1.6, 1.5), -1.0,
                             matched_threshold=0.6, unmatched_threshold=0.45)


BN_EPS = 1e-3        # every BatchNorm's, as the authors' released network


@dataclasses.dataclass(frozen=True)
class PillarConfig:
    """What only a pillar network has: at most `max_pillars` (P) non-empty
    pillars of at most `max_points` (N) points, C = `features` channels
    out of the PFN, the blocks' depths (block i has C * 2**i channels and
    starts at stride 2) and the upsamplings' strides (each to 2C
    channels), as the paper's Block(S, L, F) and Up(S_in, S_out, F)."""

    max_pillars: int = 12000
    max_points: int = 100
    features: int = 64
    block_layers: Tuple[int, ...] = (4, 6, 6)
    up_strides: Tuple[int, ...] = (1, 2, 4)

    @property
    def block_channels(self) -> Tuple[int, ...]:
        return tuple(self.features * 2 ** i
                     for i in range(len(self.block_layers)))

    @property
    def out_channels(self) -> int:
        """The concatenated map's channels: 2C per upsampling."""
        return 2 * self.features * len(self.up_strides)


def pointpillars_config() -> Config:
    """The KITTI car network's grid, anchor and head: 0.16 m pillars over
    [0, 69.12) x [-39.68, 39.68) x [-3, 1) m (a 432 x 496 canvas; the
    authors' released KITTI range, since the paper's 70.4 x 80 m gives
    440 x 500, which the stride-8 block cannot divide), one Car anchor at
    two rotations, the head at stride 2 on the 384 concatenated channels,
    rotated NMS at IoU 0.5."""
    return Config(
        voxel=VoxelConfig(x_min=0.0, x_max=69.12, y_min=-39.68, y_max=39.68,
                          z_min=-3.0, z_max=1.0, voxel_size=0.16,
                          z_slice_size=4.0, max_points=24576),
        backbone=BackboneConfig(head_stride=2, fpn_channels=384),
        head=HeadConfig(num_convs=0, nms_iou_threshold=0.5),
        anchors=(PP_CAR_ANCHOR,), with_camera=False, with_fusion=False)


def from_dict(data: Dict) -> Tuple[Config, PillarConfig]:
    """The two configurations from one dict: `Config`'s fields and
    `pillars` (the benchmark's configuration files hold them so)."""
    rest = {k: v for k, v in data.items() if k != "pillars"}
    pillar = {k: tuple(v) if isinstance(v, list) else v
              for k, v in data["pillars"].items()}
    return Config.from_json(json.dumps(rest)), PillarConfig(**pillar)


def pillar_example(frame: Frame, cfg: Config) -> Dict[str, np.ndarray]:
    """A frame's example for a pillar network: `frame_to_example`'s crop
    (the same spans) without the image, which nothing reads."""
    with trace.span("preprocess", frame=frame.frame_id):
        with trace.span("preprocess.crop"):
            points, mask = crop_and_pad(frame.points, cfg.voxel)
    return {"points": points, "point_mask": mask}


class PillarFeatureNet(nn.Module):
    """The pillar encoder: pillarization, then the PFN (a 9 -> C linear
    layer without bias and its BatchNorm, eps 1e-3, folded together for
    the kernel) with its scatter onto a zeroed canvas."""

    def __init__(self, vox: VoxelConfig, pillar: PillarConfig):
        super().__init__()
        self.vox, self.pillar = vox, pillar
        self.linear = nn.Linear(NUM_FEATURES, pillar.features, bias=False)
        self.norm = nn.BatchNorm1d(pillar.features, eps=BN_EPS)

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weight [9, C], bias [C]) float32: the linear layer with the
        BatchNorm's running statistics and affine folded in."""
        n = self.norm
        scale = n.weight / torch.sqrt(n.running_var + n.eps)
        return ((self.linear.weight * scale[:, None]).t().contiguous(),
                n.bias - n.running_mean * scale)

    def forward(self, points: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """[B, Pts, 4] points, [B, Pts] mask -> the [B, grid_x, grid_y, C]
        canvas in `dtype`."""
        vox, pc = self.vox, self.pillar
        with trace.span("forward.pillarize"):
            pillars = pillarize(points, mask, vox, pc.max_pillars,
                                pc.max_points)
            if trace.active():
                st = pillars.stats.to(torch.int64)
                trace.count_device("pillars.kept",
                                   st[:, 2].clamp(max=pc.max_pillars))
                trace.count_device("pillars.dropped",
                                   (st[:, 2] - pc.max_pillars).clamp(min=0))
                trace.count_device("pillars.points_in_roi", st[:, 0])
                trace.count_device("pillars.points_dropped",
                                   st[:, 0] - st[:, 1])
        with trace.span("forward.pfn"):
            weight, bias = self.folded()
            canvas = torch.zeros((points.shape[0], vox.grid_x, vox.grid_y,
                                  pc.features), dtype=dtype,
                                 device=points.device)
            return pfn_scatter(points, pillars, weight, bias, vox, canvas)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    y = x.permute(0, 3, 1, 2)
    # NCHW on the CPU, as `layers.ConvNorm` does: PyTorch's channels-last
    # CPU kernels are the less exact and the less safe ones
    return y.contiguous() if y.device.type == "cpu" else y


def _bn_relu(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm (float32 statistics and affine, the input's
    dtype out) and relu of an NCHW tensor, back to NHWC."""
    y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     False, 0.0, bn.eps)
    return F.relu(y).permute(0, 2, 3, 1)


class ConvBNReLU(nn.Module):
    """3x3 conv (no bias, zero padding 1) -> BatchNorm -> ReLU, NHWC, in
    the input's dtype."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(_nchw(x), self.conv.weight.to(x.dtype),
                     stride=self.stride, padding=1)
        return _bn_relu(y, self.bn)


class UpBNReLU(nn.Module):
    """Transposed conv with kernel = stride (no bias) -> BatchNorm ->
    ReLU, NHWC, in the input's dtype."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.deconv = nn.ConvTranspose2d(cin, cout, stride, stride,
                                         bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(_nchw(x), self.deconv.weight.to(x.dtype),
                               stride=self.stride)
        return _bn_relu(y, self.bn)


class PillarBackbone(nn.Module):
    """The blocks and the upsampling, NHWC: canvas -> the concatenated
    [B, grid_x / 2, grid_y / 2, 2C * len(up_strides)] map."""

    def __init__(self, pillar: PillarConfig):
        super().__init__()
        self.blocks = nn.ModuleList()
        cin = pillar.features
        for layers, c in zip(pillar.block_layers, pillar.block_channels):
            self.blocks.append(nn.ModuleList(
                [ConvBNReLU(cin if i == 0 else c, c, 2 if i == 0 else 1)
                 for i in range(layers)]))
            cin = c
        self.ups = nn.ModuleList(
            [UpBNReLU(c, 2 * pillar.features, s) for c, s in
             zip(pillar.block_channels, pillar.up_strides)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ups = []
        for block, up in zip(self.blocks, self.ups):
            for layer in block:
                x = layer(x)
            ups.append(up(x))
        return torch.cat(ups, dim=-1)


class PointPillarsDetector(nn.Module):
    """batch dict -> {"cls", "reg", "dir"} NHWC prediction maps at
    `cfg.backbone.head_stride` (2): the batch keys it reads are
    `points` [B, Pts, 4] and `point_mask` [B, Pts]."""

    def __init__(self, cfg: Config, pillar: PillarConfig = PillarConfig()):
        super().__init__()
        if cfg.backbone.quant_mode != "off":
            raise ValueError(f"PointPillarsDetector: quant_mode "
                             f"{cfg.backbone.quant_mode!r}; the pillar "
                             f"network has no int8 mode")
        strides = 2 ** len(pillar.block_layers)
        if cfg.voxel.grid_x % strides or cfg.voxel.grid_y % strides:
            raise ValueError(f"PointPillarsDetector: the {cfg.voxel.grid_x}"
                             f" x {cfg.voxel.grid_y} canvas is not divisible "
                             f"by the blocks' stride {strides}")
        if pillar.out_channels != cfg.backbone.fpn_channels:
            raise ValueError("PointPillarsDetector: backbone.fpn_channels "
                             "must be 2C per upsampling")
        self.cfg, self.pillar = cfg, pillar
        self.pfn = PillarFeatureNet(cfg.voxel, pillar)
        self.backbone = PillarBackbone(pillar)
        self.head = DetectionHead(cfg, cfg.backbone.fpn_channels)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        x = self.pfn(batch["points"], batch["point_mask"],
                     getattr(torch, self.cfg.backbone.dtype))
        with trace.span("forward.pp_backbone"):
            x = self.backbone(x)
        with trace.span("forward.head"):
            return self.head(x)


def init_pointpillars(cfg: Config, generator: torch.Generator,
                      pillar: PillarConfig = PillarConfig(), device="cuda"
                      ) -> PointPillarsDetector:
    """A `PointPillarsDetector` on `device` with seeded random weights:
    He-normal convs, transposed convs and PFN (the layers feed a ReLU),
    lecun-normal head convs with zero biases and the class-logit bias at
    the 0.01 prior, BatchNorm affine 1 / 0 and running statistics 0 / 1.
    `generator` is a CPU `torch.Generator`."""
    model = PointPillarsDetector(cfg, pillar)
    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d,
                                   nn.Linear)):
                w = module.weight
                if isinstance(module, nn.ConvTranspose2d):
                    fan = w.shape[0]          # kernel = stride: one tap
                else:
                    fan = w[0].numel()
                gain = 1.0 if name.startswith("head.") else 2.0
                w.normal_(0.0, (gain / fan) ** 0.5, generator=generator)
                if getattr(module, "bias", None) is not None:
                    module.bias.fill_(PRIOR_BIAS if name.endswith("cls")
                                      else 0.0)
    return model.to(resolve_device(device)).eval()
