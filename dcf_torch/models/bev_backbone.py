"""BEV top-down FPN, mirroring `dcf.models.bev_backbone`: merges the
multi-scale BEV features down to the detection-head stride."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dcf_torch.config import BackboneConfig
from dcf_torch.models.layers import ConvNorm, upsample2x


class BEVFPN(nn.Module):
    """Top-down merge of {stride: NHWC features} to head_stride."""

    def __init__(self, cfg: BackboneConfig, in_channels: Dict[int, int]):
        super().__init__()
        self.cfg = cfg
        self.strides = sorted(in_channels)
        top = max(self.strides)
        f, q = cfg.fpn_channels, cfg.quant_mode
        self.ConvNorm_0 = ConvNorm(in_channels[top], f, 1, 1, act=False,
                                   quant=q)
        ci, stride = 1, top
        while stride > cfg.head_stride:
            stride //= 2
            self.add_module(f"ConvNorm_{ci}",
                            ConvNorm(in_channels[stride], f, 1, 1, act=False,
                                     quant=q))
            ci += 1
        self.add_module(f"ConvNorm_{ci}", ConvNorm(f, f, 3, 1, quant=q))
        self.num_convs = ci + 1

    def forward(self, feats: Dict[int, torch.Tensor]) -> torch.Tensor:
        stride = max(self.strides)
        y = self.ConvNorm_0(feats[stride])
        ci = 1
        while stride > self.cfg.head_stride:
            stride //= 2
            y = upsample2x(y) + getattr(self, f"ConvNorm_{ci}")(feats[stride])
            ci += 1
        return getattr(self, f"ConvNorm_{ci}")(y)
