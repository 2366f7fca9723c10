"""Image-stream ResNet backbone, mirroring `dcf.models.resnet`.

ResNet-18-shaped by default, with a patchify stem (space-to-depth(4) +
1x1 ConvNorm == one 4x4 / stride-4 conv). Returns the feature pyramid
at image strides 4/8/16/32 that the fusion layers sample from.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dcf_torch.config import BackboneConfig
from dcf_torch.models.layers import BasicBlock, ConvNorm
from dcf_torch.utils.graphs import EAGER


class ImageBackbone(nn.Module):
    """NHWC image -> {stride: NHWC features}."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        self.cfg = cfg
        chans = cfg.image_stage_channels
        q = cfg.quant_mode
        self.ConvNorm_0 = ConvNorm(48, chans[0], 1, 1, quant=q)
        bi, cin = 0, chans[0]
        for stage, c in enumerate(chans):
            for b in range(cfg.image_blocks_per_stage[stage]):
                stride = 2 if (stage > 0 and b == 0) else 1
                self.add_module(f"BasicBlock_{bi}",
                                BasicBlock(cin, c, stride, quant=q))
                bi, cin = bi + 1, c

    def forward(self, image: torch.Tensor, seg=EAGER
                ) -> Dict[int, torch.Tensor]:
        """image: [B, H, W, 3] in [0, 1] (H, W multiples of 4), or the
        host's space-to-depth(4) layout [B, H/4, W/4, 48]. `seg` runs the
        backbone as one segment of a graphed forward
        (`dcf_torch.utils.graphs`; a plain call by default)."""
        return seg.run("image_backbone", self._pyramid, image)

    def _pyramid(self, image: torch.Tensor) -> Dict[int, torch.Tensor]:
        cfg = self.cfg
        x = image.to(getattr(torch, cfg.dtype))
        B, H, W, C = x.shape
        if C == 3:
            x = (x.reshape(B, H // 4, 4, W // 4, 4, C)
                 .permute(0, 1, 3, 2, 4, 5).reshape(B, H // 4, W // 4, 48))
        elif C != 48:
            raise ValueError(f"image must have 3 or 48 channels, got {C}")
        x = self.ConvNorm_0(x)
        feats: Dict[int, torch.Tensor] = {}
        stride, bi = 4, 0
        for stage in range(len(cfg.image_stage_channels)):
            for _ in range(cfg.image_blocks_per_stage[stage]):
                x = getattr(self, f"BasicBlock_{bi}")(x)
                bi += 1
            if stage > 0:
                stride *= 2
            feats[stride] = x
        return feats
