"""int8 post-training quantization (PTQ) serving mode, mirroring
`dcf.quant`.

Every `ConvNorm` conv runs in one of three modes
(`BackboneConfig.quant_mode`): "off" (float), "calib" (float, recording
the running max-abs of each conv input in the ConvNorm's `in_amax`
buffer), "int8" (per-tensor activation and per-output-channel weight
int8, int32 products, exact dequantization; `dcf_torch.ops.int8`).
GroupNorm, the fusion layers and the head's 1x1 output convs stay float.
The float parameters are shared: a float-trained model serves int8 with
its calibration in the buffers and no conversion of its weights.

Flow:
    quant = calibrate(cfg, model, calib_batches)    # {"quant": tree}
    int8 = from_flax({**to_flax(model), **quant}, quant_config(cfg))
    infer = make_inference_fn(quant_config(cfg), int8)

The tree is the JAX package's "quant" collection, so a calibration made
there serves here and the reverse (`dcf_torch.params.quant_from_flax`).
PTQ changes the numbers: hold-out AP has to be measured per checkpoint
before the int8 mode is used.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import numpy as np
import torch

from dcf_torch.config import Config
from dcf_torch.models.detector import ContFuseDetector
from dcf_torch.models.layers import ConvNorm
from dcf_torch.params import quant_to_flax


def quant_config(cfg: Config, mode: str = "int8") -> Config:
    """Config copy with every ConvNorm in `mode`."""
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, quant_mode=mode))


def calibrate(cfg: Config, model: ContFuseDetector,
              batches: Iterable[Dict]) -> Dict:
    """Run calibration batches through `model` with every ConvNorm in
    "calib" mode, under `torch.no_grad()`, and return the {"quant": ...}
    tree of per-conv input max-abs values. The running maxima start from
    0 and stay in the model's `in_amax` buffers; each ConvNorm's mode is
    restored afterwards.

    Args:
      cfg: the model's configuration, in any `quant_mode`.
      model: a `ContFuseDetector` (float weights) built from it.
      batches: batch dicts of numpy arrays or tensors
        (`frame_to_example`, stacked).
    """
    if quant_config(model.cfg, "off") != quant_config(cfg, "off"):
        raise ValueError("calibrate: the model was built from another "
                         "configuration")
    device = next(model.parameters()).device
    norms = [m for m in model.modules() if isinstance(m, ConvNorm)]
    modes = [m.quant for m in norms]
    n = 0
    try:
        for m in norms:
            m.quant = "calib"
            m.in_amax.zero_()
        with torch.no_grad():
            for batch in batches:
                model({k: (torch.from_numpy(np.ascontiguousarray(v))
                           if isinstance(v, np.ndarray) else v).to(device)
                       for k, v in batch.items()})
                n += 1
    finally:
        for m, mode in zip(norms, modes):
            m.quant = mode
    if n == 0:
        raise ValueError("calibrate() needs at least one batch")
    return quant_to_flax(model)
