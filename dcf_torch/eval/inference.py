"""End-to-end inference, the port's serving entry point (mirrors
`dcf.eval.inference.make_inference_fn`).

A numpy batch (`dcf_torch.data.preprocess.frame_to_example`, stacked)
goes in; fixed-size detections come out: the forward, the anchor decode
and the rotated NMS all run on the model's device.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from dcf_torch.config import Config
from dcf_torch.device import resolve_device
from dcf_torch.models.anchors import generate_anchors
from dcf_torch.models.head import decode_and_nms, flatten_predictions
from dcf_torch.utils import trace


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """numpy batch -> torch tensors on `device` (same dtypes)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Detections (or any tensors) to numpy, with one wait for the
    device."""
    with trace.span("to_host"):
        host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
        if any(v.is_cuda for v in out.values()):
            with trace.sync():
                torch.cuda.synchronize()
        return {k: v.numpy() for k, v in host.items()}


def make_inference_fn(cfg: Config, model: torch.nn.Module, device="cuda"
                      ) -> Callable[[Dict[str, np.ndarray]],
                                    Dict[str, torch.Tensor]]:
    """Returns infer(batch) -> {"boxes" [B, D, 7], "scores" [B, D],
    "classes" [B, D], "valid" [B, D]} as tensors on `device`.

    `model` is a detector: a module whose forward takes the batch dict and
    returns the NHWC head maps {"cls" [B, H, W, A], "reg" [B, H, W, 7A],
    "dir" [B, H, W, 2A]} at `cfg.backbone.head_stride` (`ContFuseDetector`,
    `PointPillarsDetector`). It is moved to `device` and put in eval mode;
    the anchors are built once and kept there. An int8 model
    (`quant_config(cfg)`, `dcf_torch.quant`) serves with the calibration
    in its buffers; one that was never calibrated is refused.
    """
    mode = cfg.backbone.quant_mode
    if model.cfg.backbone.quant_mode != mode:
        raise ValueError(f"make_inference_fn: cfg asks for quant_mode "
                         f"{mode!r}, the model was built for "
                         f"{model.cfg.backbone.quant_mode!r}")
    if mode == "int8" and not any(
            bool(b.any()) for n, b in model.named_buffers()
            if n.endswith("in_amax")):
        raise ValueError("make_inference_fn: int8 model without a "
                         "calibration (every in_amax is 0)")
    device = resolve_device(device)
    model = model.to(device).eval()
    anchors, classes, _, _ = generate_anchors(cfg)
    anchors = torch.from_numpy(anchors).to(device)
    classes = torch.from_numpy(classes).to(device)

    @torch.no_grad()
    def infer(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        with trace.span("infer.h2d"):
            batch = batch_to_device(batch, device)
        with trace.span("infer.forward"):
            preds = model(batch)
        with trace.span("infer.decode_nms"):
            return decode_and_nms(flatten_predictions(preds, cfg), anchors,
                                  classes, cfg)

    return infer
