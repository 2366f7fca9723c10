"""The ContFuse detector, mirroring `dcf.models.detector.ContFuseDetector`.

batch -> pseudo-image (space-to-depth(2) raster) -> BEV stages, each
followed by a continuous-fusion layer at its stride (paper fig. 3), with
the image ResNet pyramid beside them -> FPN -> head maps.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dcf_torch.config import Config
from dcf_torch.data.preprocess import image_stride_for
from dcf_torch.data.voxelize import rasterize_bev_s2d
from dcf_torch.models.bev_backbone import BEVFPN
from dcf_torch.models.fusion import ContinuousFusionLayer
from dcf_torch.models.head import DetectionHead
from dcf_torch.models.layers import BasicBlock
from dcf_torch.models.resnet import ImageBackbone


class ContFuseDetector(nn.Module):
    """batch dict -> {"cls", "reg", "dir"} NHWC prediction maps.

    Batch keys (torch tensors, the layout of
    `dcf_torch.data.preprocess.frame_to_example`, stacked):
      points [B, P, 4], point_mask [B, P]        (always)
      image [B, H/4, W/4, 48] or [B, H, W, 3]     (with_camera)
      points_uvz [B, P, 3], fusion_rank [B, S, P] (with_fusion; points
        sorted fine-grid row-major on the host)
    """

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        bb = cfg.backbone
        if cfg.with_camera:
            self.image_backbone = ImageBackbone(bb)
        cin = 4 * cfg.voxel.bev_channels
        stride, channels = 1, {}
        for stage, c in enumerate(bb.bev_stage_channels):
            s0 = stage == 0
            for b in range(bb.bev_blocks_per_stage[stage]):
                first = b == 0
                block = BasicBlock(cin, c, stride=2 if first and not s0 else 1,
                                   entry_kernel=2 if first and s0 else 3,
                                   quant=bb.quant_mode)
                self.add_module(f"bev_stage{stage}_block{b}", block)
                cin = c
            stride *= 2
            channels[stride] = c
            if cfg.with_fusion and stride in bb.fusion_strides:
                istride = image_stride_for(stride)
                level = {4: 0, 8: 1, 16: 2, 32: 3}[istride]
                self.add_module(f"fusion_s{stride}", ContinuousFusionLayer(
                    cfg, bb.image_stage_channels[level], c, stride, istride))
        self.fpn = BEVFPN(bb, channels)
        self.head = DetectionHead(cfg, bb.fpn_channels)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        bb = cfg.backbone
        dtype = getattr(torch, bb.dtype)
        x = rasterize_bev_s2d(batch["points"], batch["point_mask"],
                              cfg.voxel, dtype)
        img_feats = (self.image_backbone(batch["image"])
                     if cfg.with_camera else None)

        feats: Dict[int, torch.Tensor] = {}
        stride = 1
        for stage in range(len(bb.bev_stage_channels)):
            for b in range(bb.bev_blocks_per_stage[stage]):
                x = getattr(self, f"bev_stage{stage}_block{b}")(x)
            stride *= 2
            if cfg.with_fusion and stride in bb.fusion_strides:
                si = bb.fusion_strides.index(stride)
                fused = getattr(self, f"fusion_s{stride}")(
                    batch["points"], batch["points_uvz"],
                    batch["fusion_rank"][:, si],
                    img_feats[image_stride_for(stride)])
                x = x + fused.to(dtype)
            feats[stride] = x
        return self.head(self.fpn(feats))
