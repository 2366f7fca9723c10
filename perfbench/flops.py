"""Analytic FLOP accounting and roofline constants: a frozen copy of
`dcf_torch/utils/flops.py` (commit fab139f), reading the reference's
copy of the configuration, so that the yardstick does not move with the
program.

Computes *model* FLOPs per frame from the Config alone — the useful-math
numerator for MFU (implementation overhead like the fusion kernel's
one-hot selection matmul or padding waste is deliberately NOT counted:
MFU = useful FLOPs / (time x peak), so overhead shows up as lower MFU,
which is the point of the metric).

Counting conventions:
  - a matmul / conv counts 2 * M * N * K (multiply + add);
  - norms / activations / elementwise: ignored (<1% of a conv stack);
  - voxelize scatter, gathers, NMS: 0 FLOPs (bandwidth-bound; see
    `inference_bytes` for the memory-side roofline).

Hardware peaks (NVIDIA H100 SXM data sheet, dense rates at the full
700 W power limit; the port's kernel bounds use the same):
  - 989 TFLOP/s bf16 (tensor cores), 1,979 TOP/s int8,
    67 TFLOP/s float32 outside the tensor cores
  - 3.35 TB/s HBM bandwidth, 80 GB HBM
"""

from __future__ import annotations

from typing import Dict, Tuple

from perfbench.reference.config import Config
from perfbench.reference.data.preprocess import image_stride_for

H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_INT8_OPS = 1979e12
H100_PEAK_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def _conv_flops(h: int, w: int, cin: int, cout: int, k: int) -> int:
    """2*H*W*Cin*Cout*k*k at the OUTPUT resolution (h, w)."""
    return 2 * h * w * cin * cout * k * k


def _basic_block_flops(h: int, w: int, cin: int, cout: int,
                       stride: int) -> int:
    """dcf_torch.models.layers.BasicBlock at output resolution (h, w)."""
    f = _conv_flops(h, w, cin, cout, 3) + _conv_flops(h, w, cout, cout, 3)
    if cin != cout or stride != 1:
        f += _conv_flops(h, w, cin, cout, 1)      # projection shortcut
    return f


def image_backbone_flops(cfg: Config) -> int:
    """dcf_torch.models.resnet.ImageBackbone forward FLOPs for one image."""
    bb = cfg.backbone
    h, w = cfg.image.height, cfg.image.width
    # patchify stem: s2d(4) + 1x1 ConvNorm == 4x4 stride-4 conv
    h, w = h // 4, w // 4
    total = _conv_flops(h, w, 16 * cfg.image.channels,
                        bb.image_stage_channels[0], 1)
    cin = bb.image_stage_channels[0]
    for stage, cout in enumerate(bb.image_stage_channels):
        first_stride = 1 if stage == 0 else 2
        if first_stride == 2:
            h, w = h // 2, w // 2
        total += _basic_block_flops(h, w, cin, cout, first_stride)
        for _ in range(bb.image_blocks_per_stage[stage] - 1):
            total += _basic_block_flops(h, w, cout, cout, 1)
        cin = cout
    return total


def bev_backbone_flops(cfg: Config) -> int:
    """BEV encoder stages (dcf_torch.models.detector) for one frame."""
    bb = cfg.backbone
    h, w = cfg.voxel.grid_x, cfg.voxel.grid_y
    cin = cfg.voxel.bev_channels
    total = 0
    for stage, cout in enumerate(bb.bev_stage_channels):
        h, w = h // 2, w // 2                      # every stage strides 2
        if stage == 0:
            # s2d raster in: kernel-2/stride-1 entry conv on 4*cin
            # channels + 1x1 projection shortcut (dcf_torch.models.detector)
            total += (_conv_flops(h, w, 4 * cin, cout, 2)
                      + _conv_flops(h, w, cout, cout, 3)
                      + _conv_flops(h, w, 4 * cin, cout, 1))
        else:
            total += _basic_block_flops(h, w, cin, cout, 2)
        for _ in range(bb.bev_blocks_per_stage[stage] - 1):
            total += _basic_block_flops(h, w, cout, cout, 1)
        cin = cout
    return total


def fpn_flops(cfg: Config) -> int:
    """dcf_torch.models.bev_backbone.BEVFPN for one frame."""
    bb = cfg.backbone
    H, W = cfg.voxel.grid_x, cfg.voxel.grid_y
    strides = [2 ** (i + 1) for i in range(len(bb.bev_stage_channels))]
    top = max(strides)
    total = _conv_flops(H // top, W // top, bb.bev_stage_channels[-1],
                        bb.fpn_channels, 1)
    stride = top
    while stride > bb.head_stride:
        stride //= 2
        idx = strides.index(stride)
        total += _conv_flops(H // stride, W // stride,
                             bb.bev_stage_channels[idx], bb.fpn_channels, 1)
    hh, ww = H // bb.head_stride, W // bb.head_stride
    total += _conv_flops(hh, ww, bb.fpn_channels, bb.fpn_channels, 3)
    return total


def head_flops(cfg: Config) -> int:
    """dcf_torch.models.head.DetectionHead for one frame."""
    bb = cfg.backbone
    h = cfg.voxel.grid_x // bb.head_stride
    w = cfg.voxel.grid_y // bb.head_stride
    A = cfg.anchors_per_loc
    total = 0
    cin = bb.fpn_channels
    for _ in range(cfg.head.num_convs):
        total += _conv_flops(h, w, cin, cfg.head.head_channels, 3)
        cin = cfg.head.head_channels
    out_ch = A + A * 7 + (A * 2 if cfg.head.use_direction_classifier else 0)
    total += _conv_flops(h, w, cin, out_ch, 1)
    return total


def fusion_flops(cfg: Config) -> int:
    """Continuous-fusion layers (dcf_torch.models.fusion) for one frame.

    Model math only: per-point image-half Dense + bilinear lerp, per
    (pixel, neighbor) geometric half + add + relu, masked K-sum, and the
    output layer. The kernel's one-hot z1-selection matmul and the KNN
    distance cascade are implementation, not model math, and are excluded
    (they depress MFU, as they should); so is the port's KNN selection.
    """
    if not cfg.with_fusion:
        return 0
    fus = cfg.fusion
    bb = cfg.backbone
    P = cfg.voxel.max_points
    hid = fus.hidden_dim
    K = fus.num_neighbors
    total = 0
    for s in bb.fusion_strides:
        img_stride = image_stride_for(s)
        img_idx = {4: 0, 8: 1, 16: 2, 32: 3}[img_stride]
        c_img = bb.image_stage_channels[img_idx]
        H = cfg.voxel.grid_x // s
        W = cfg.voxel.grid_y // s
        total += 8 * P * c_img                  # bilinear: 4 taps x lerp
        total += 2 * P * c_img * hid            # img_proj Dense
        per_pair = 2 * 4 * hid + 2 * hid        # geo half + add + K-sum
        total += H * W * K * per_pair
        stage_strides = [2 ** (i + 1)
                         for i in range(len(bb.bev_stage_channels))]
        out_ch = bb.bev_stage_channels[stage_strides.index(s)]
        total += 2 * H * W * hid * out_ch       # output layer
    return total


def inference_flops_per_frame(cfg: Config) -> Dict[str, int]:
    """Analytic model FLOPs for one end-to-end inference frame."""
    parts = {
        "bev_backbone": bev_backbone_flops(cfg),
        "fpn": fpn_flops(cfg),
        "head": head_flops(cfg),
    }
    if cfg.with_camera:
        parts["image_backbone"] = image_backbone_flops(cfg)
    if cfg.with_fusion:
        parts["fusion"] = fusion_flops(cfg)
    parts["total"] = sum(parts.values())
    return parts


def train_flops_per_frame(cfg: Config) -> int:
    """Forward + backward ~ 3x forward (standard fwd/bwd conv accounting:
    backward computes grads wrt both inputs and weights)."""
    return 3 * inference_flops_per_frame(cfg)["total"]


def mfu(flops_per_item: float, items_per_sec: float,
        peak: float = H100_PEAK_BF16_FLOPS) -> Tuple[float, float]:
    """Returns (achieved_tflops, mfu_fraction)."""
    achieved = flops_per_item * items_per_sec
    return achieved / 1e12, achieved / peak


def inference_bytes_breakdown(cfg: Config) -> Dict[str, int]:
    """Coarse HBM traffic estimate for one inference frame, per named
    contributor (roofline memory side). Convention:
    every ConvNorm reads its input and writes its output once in bf16,
    and the (unfused-at-B>1) GroupNorm re-reads and re-writes its
    output; residual adds re-read one operand. Gathers, scatters, sorts
    and kernel-internal DMA count their touched tables once. This is a
    lower bound on real traffic (XLA materializes some extra copies) --
    good for order-of-magnitude roofline arguments, not for byte-exact
    accounting.

    The entries keep the JAX package's conventions, so both packages give
    the same numbers; two of them count a TPU layout, not the port's:
    "fusion" counts the TPU kernel's plane tables (4 fields of 4 bytes per
    bin slot, `dcf/ops/pallas/fusion_kernel.py`) where the port's kernel
    reads a valid mask and the valid slots' payload; "image_backbone"
    counts the image read in float32 after a host space-to-depth, which
    the port always does (`ImageConfig.host_s2d` is not carried over).
    """
    BPE = 2  # bf16

    def convnorm(h, w, cin, cout):
        conv = (h * w * cin + h * w * cout) * BPE
        gn = 2 * (h * w * cout) * BPE * 2
        return conv + gn

    def block(h, w, cin, cout, stride, entry_kernel=3):
        del entry_kernel  # bytes don't depend on kernel size
        b = convnorm(h * stride, w * stride, cin, cout)  # conv1 at in-res
        b += convnorm(h, w, cout, cout)
        if cin != cout or stride != 1:
            b += convnorm(h * stride, w * stride, cin, cout)
        b += 2 * h * w * cout * BPE                      # residual add
        return b

    bb = cfg.backbone
    out: Dict[str, int] = {}
    # BEV backbone (pseudo-image arrives in s2d(2) layout, bf16)
    h, w = cfg.voxel.grid_x, cfg.voxel.grid_y
    out["raster_write"] = h * w * cfg.voxel.bev_channels * BPE
    bev = 0
    cin = cfg.voxel.bev_channels
    for stage, cout in enumerate(bb.bev_stage_channels):
        h, w = h // 2, w // 2
        if stage == 0:
            # s2d input: stride-1 block on 4*cin channels at h, w
            bev += block(h, w, 4 * cin, cout, 1) + convnorm(h, w, 4 * cin,
                                                            cout)
        else:
            bev += block(h, w, cin, cout, 2)
        for _ in range(bb.bev_blocks_per_stage[stage] - 1):
            bev += block(h, w, cout, cout, 1)
        cin = cout
    out["bev_backbone"] = bev
    # image backbone: f32 image read (s2d on the host) + patchify 1x1
    # ConvNorm at stride 4
    if cfg.with_camera:
        hi, wi = cfg.image.height, cfg.image.width
        img = hi * wi * cfg.image.channels * 4           # input read (f32)
        h, w = hi // 4, wi // 4
        img += convnorm(h, w, 16 * cfg.image.channels,
                        bb.image_stage_channels[0])
        cin = bb.image_stage_channels[0]
        for stage, cout in enumerate(bb.image_stage_channels):
            if stage > 0:
                h, w = h // 2, w // 2
            img += block(h, w, cin, cout, 1 if stage == 0 else 2)
            for _ in range(bb.image_blocks_per_stage[stage] - 1):
                img += block(h, w, cout, cout, 1)
            cin = cout
        out["image_backbone"] = img
    # fusion: bilinear patch gather (4C rows) + z1 table + plane tables
    # (4 planes: validity folds into gidx + 1 -- fusion_kernel._D note)
    if cfg.with_fusion:
        P = cfg.voxel.max_points
        fus = 0
        for s in bb.fusion_strides:
            c_img = bb.image_stage_channels[
                {4: 0, 8: 1, 16: 2, 32: 3}[image_stride_for(s)]]
            H = cfg.voxel.grid_x // s
            W = cfg.voxel.grid_y // s
            hid = cfg.fusion.hidden_dim
            cap = cfg.fusion.bin_capacity
            fus += P * 4 * c_img * BPE                   # patch rows
            fus += 2 * P * hid * BPE                     # z1 write+read
            fus += H * W * cap * 4 * 4                   # planes (4 fields)
            fus += 2 * H * W * (hid + 1) * 4             # acc out + read
        out["fusion"] = fus
    # FPN + head at head stride
    hh = cfg.voxel.grid_x // bb.head_stride
    ww = cfg.voxel.grid_y // bb.head_stride
    head = 4 * hh * ww * bb.fpn_channels * BPE
    head += cfg.head.num_convs * convnorm(hh, ww, bb.fpn_channels,
                                          cfg.head.head_channels)
    head += hh * ww * cfg.anchors_per_loc * 10 * 4       # head maps fp32
    out["fpn_head"] = head
    # voxel sort/scatter: points sorted + scattered
    out["point_io"] = 6 * cfg.voxel.max_points * 4 * 4
    return out


def inference_bytes_per_frame(cfg: Config) -> int:
    """Sum of `inference_bytes_breakdown` (see its conventions)."""
    return sum(inference_bytes_breakdown(cfg).values())
