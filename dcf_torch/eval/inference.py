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
from dcf_torch.models.detector import ContFuseDetector
from dcf_torch.models.head import decode_and_nms, flatten_predictions


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """numpy batch -> torch tensors on `device` (same dtypes)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_inference_fn(cfg: Config, model: ContFuseDetector, device="cuda"
                      ) -> Callable[[Dict[str, np.ndarray]],
                                    Dict[str, torch.Tensor]]:
    """Returns infer(batch) -> {"boxes" [B, D, 7], "scores" [B, D],
    "classes" [B, D], "valid" [B, D]} as tensors on `device`.

    `model` is moved to `device` and put in eval mode; the anchors are
    built once and kept there.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    anchors, classes, _, _ = generate_anchors(cfg)
    anchors = torch.from_numpy(anchors).to(device)
    classes = torch.from_numpy(classes).to(device)

    @torch.no_grad()
    def infer(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        preds = model(batch_to_device(batch, device))
        return decode_and_nms(flatten_predictions(preds, cfg), anchors,
                              classes, cfg)

    return infer
