"""The ContFuse detector, mirroring `dcf.models.detector.ContFuseDetector`.

batch -> pseudo-image (space-to-depth(2) raster) -> BEV stages, each
followed by a continuous-fusion layer at its stride (paper fig. 3), with
the image ResNet pyramid beside them -> FPN -> head maps.

Served on a card (CUDA inputs, autograd not recording, float convs), the
forward replays CUDA graphs (`dcf_torch.utils.graphs`): the raster, the
image backbone, each BEV stage, each fusion layer's work before and
after its kernel, each fusion sum, the FPN and the head are segments;
the fusion kernels launch eagerly between them, and the module calls
(and their hooks) stay module calls, once a forward. Every other call
runs the same forward eagerly.
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
from dcf_torch.models.layers import BasicBlock, ConvNorm
from dcf_torch.models.resnet import ImageBackbone
from dcf_torch.utils import trace
from dcf_torch.utils.graphs import EAGER, GraphCache


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
        self.inputs = ("points", "point_mask") \
            + (("image",) if cfg.with_camera else ()) \
            + (("points_uvz", "fusion_rank") if cfg.with_fusion else ())
        self.graphs = GraphCache()
        self._norms = [m for m in self.modules() if isinstance(m, ConvNorm)]

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        inputs = {k: batch[k] for k in self.inputs}
        if self.replays(inputs):
            return self.graphs(self._forward, inputs)
        return self._forward(inputs, EAGER)

    def replays(self, inputs: Dict[str, torch.Tensor]) -> bool:
        """Whether a call on `inputs` goes through the CUDA graphs: CUDA
        inputs, autograd not recording, and float convs: every ConvNorm
        in quant mode "off" ("int8" is not captured, and "calib", which
        `dcf_torch.quant.calibrate` sets on a float model, updates its
        buffers on every call)."""
        return (inputs["points"].device.type == "cuda"
                and all(m.quant == "off" for m in self._norms)
                and not (torch.is_grad_enabled() and any(
                    p.requires_grad for p in self.parameters())))

    def _apply(self, fn, *args, **kwargs):
        self.graphs.clear()     # the graphs read the parameters where they lay
        return super()._apply(fn, *args, **kwargs)

    def _forward(self, batch: Dict[str, torch.Tensor], seg
                 ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        bb = cfg.backbone
        dtype = getattr(torch, bb.dtype)
        batch = seg.stage(batch)
        with trace.span("forward.raster"):
            x = seg.run("raster", lambda p, m: rasterize_bev_s2d(
                p, m, cfg.voxel, dtype), batch["points"], batch["point_mask"])
        img_feats = None
        if cfg.with_camera:
            with trace.span("forward.image_backbone"):
                img_feats = self.image_backbone(batch["image"], seg)

        feats: Dict[int, torch.Tensor] = {}
        stride = 1
        for stage in range(len(bb.bev_stage_channels)):
            with trace.span(f"forward.bev_stage{stage}"):
                x = seg.run(f"bev_stage{stage}", self._bev_stage(stage), x)
            stride *= 2
            if cfg.with_fusion and stride in bb.fusion_strides:
                si = bb.fusion_strides.index(stride)
                with trace.span(f"forward.fusion_s{stride}"):
                    fused = getattr(self, f"fusion_s{stride}")(
                        batch["points"], batch["points_uvz"],
                        batch["fusion_rank"][:, si],
                        img_feats[image_stride_for(stride)], seg)
                    x = seg.run(f"fusion_s{stride}.sum",
                                lambda a, f: a + f.to(dtype), x, fused)
            feats[stride] = x
        with trace.span("forward.fpn"):
            fpn = seg.run("fpn", self.fpn, feats)
        with trace.span("forward.head"):
            return seg.run("head", self.head, fpn)

    def _bev_stage(self, stage: int):
        n = self.cfg.backbone.bev_blocks_per_stage[stage]
        blocks = [getattr(self, f"bev_stage{stage}_block{b}")
                  for b in range(n)]

        def run(x):
            for block in blocks:
                x = block(x)
            return x
        return run
