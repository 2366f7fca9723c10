"""Continuous fusion layer (paper section 3.2), mirroring the non-Pallas
branch of `dcf.models.fusion.ContinuousFusionLayer`.

Per BEV pixel at one backbone scale: the K nearest lidar points in the
BEV plane, each point's image feature sampled bilinearly where it
projects, the geometric offset (point - pixel centre), a shared MLP and
a masked sum over K. Split as the reference splits it:

  - per point: the image half of the first MLP layer is applied to the
    feature MAP (`img_proj`, a 1x1 linear map, which commutes with the
    bilinear sample), then sampled once per point -> z1 [B, P, hid];
  - per point: binned by the host's per-scale rank (points outside the
    camera frustum or the grid carry rank -1 and never bin);
  - per pixel: KNN + geometric half + relu + K-sum in one kernel
    (`dcf_torch.ops.fusion.fused_fusion`, differentiable: in training its
    backward kernel carries the gradient to `geo_kernel`, `geo_bias` and,
    through z1 and the bilinear sample, to `img_proj` and the image
    backbone);
  - the output layer over the K-sum, with the per-pair bias restored as
    count * bias: `acc[..., :hid] @ Wo + acc[..., hid:] * bo`.

In a graphed forward (`dcf_torch.utils.graphs`) the work before the
kernel and the output layer are two segments; the kernel's launch and
the tracer's device counters stay eager between them.
"""

from __future__ import annotations

import torch
from torch import nn

from dcf_torch.config import Config
from dcf_torch.ops.bilinear import bilinear_sample
from dcf_torch.ops.fusion import fused_fusion, quantize_payload_xyz
from dcf_torch.ops.knn import bin_points_dense_tally, count_bin_drops
from dcf_torch.utils import trace
from dcf_torch.utils.graphs import EAGER


class ContinuousFusionLayer(nn.Module):
    """One fusion layer at a fixed (BEV stride, image stride) pair."""

    def __init__(self, cfg: Config, image_channels: int, out_channels: int,
                 bev_stride: int, image_stride: int):
        super().__init__()
        self.cfg = cfg
        self.bev_stride, self.image_stride = bev_stride, image_stride
        hid = cfg.fusion.hidden_dim
        self.img_proj = nn.Linear(image_channels, hid, bias=False)
        # flax layouts: [4, hid], [hid], [hid, out], [out]
        self.geo_kernel = nn.Parameter(torch.zeros(4, hid))
        self.geo_bias = nn.Parameter(torch.zeros(hid))
        self.out_kernel = nn.Parameter(torch.zeros(hid, out_channels))
        self.out_bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, points: torch.Tensor, uvz: torch.Tensor,
                rank: torch.Tensor, image_feat: torch.Tensor,
                seg=EAGER) -> torch.Tensor:
        """Args:
          points: [B, P, 4] fine-grid-sorted padded lidar points.
          uvz: [B, P, 3] host-projected (u, v, depth).
          rank: [B, P] int32 host rank at this scale (-1 = not binned).
          image_feat: [B, Hi, Wi, C] image features at `image_stride`.
          seg: the runner of the forward's segments
            (`dcf_torch.utils.graphs`; plain calls by default).

        Returns:
          [B, H, W, out_channels] BEV contribution at `bev_stride`, in
          the compute dtype.
        """
        vox, fus = self.cfg.voxel, self.cfg.fusion
        cell = vox.voxel_size * self.bev_stride
        origin = (vox.x_min, vox.y_min)
        name = f"fusion_s{self.bev_stride}"
        data, valid, z1, wgt, inside, kept = seg.run(
            name + ".bins", self._kernel_inputs, points, uvz, rank,
            image_feat)
        count_bin_drops(inside, kept)
        acc = fused_fusion(data, valid, z1, wgt, self.geo_bias, origin, cell,
                           fus.num_neighbors, fus.search_radius_cells)
        trace.count_device("fusion.pairs", acc[..., fus.hidden_dim])
        return seg.run(name + ".out", self._output_layer, acc)

    def _kernel_inputs(self, points, uvz, rank, image_feat):
        """The kernel's inputs (bf16-quantised payload bins, their
        validity, z1 in float32, the geometric kernel [hid, 4]) and the
        binning's masks for its counters."""
        cfg = self.cfg
        vox, fus = cfg.voxel, cfg.fusion
        dtype = getattr(torch, cfg.backbone.dtype)
        H = vox.grid_x // self.bev_stride
        W = vox.grid_y // self.bev_stride
        cell = vox.voxel_size * self.bev_stride
        origin = (vox.x_min, vox.y_min)
        B, P = points.shape[:2]

        z1_map = nn.functional.linear(image_feat.to(dtype),
                                      self.img_proj.weight.to(dtype))
        z1, _ = bilinear_sample(z1_map, uvz[..., :2] / float(self.image_stride))

        gidx = torch.arange(P, dtype=torch.float32, device=points.device)
        payload = torch.cat(
            [points[..., :3], gidx[None, :, None].expand(B, P, 1)], dim=-1)
        bins, inside, kept = bin_points_dense_tally(
            payload, rank >= 0, origin, cell, (H, W), fus.bin_capacity)
        data = quantize_payload_xyz(bins.data, origin, cell)
        return (data, bins.valid, z1.to(torch.float32).contiguous(),
                self.geo_kernel.t().contiguous(), inside, kept)

    def _output_layer(self, acc):
        dtype = getattr(torch, self.cfg.backbone.dtype)
        hid = self.cfg.fusion.hidden_dim
        return (acc[..., :hid].to(dtype) @ self.out_kernel.to(dtype)
                + acc[..., hid:].to(dtype) * self.out_bias.to(dtype))
