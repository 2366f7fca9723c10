"""int8 against bf16 selection products: the micro-benchmark kernels of
`dcf_torch/csrc/int8_mma.cu` and their plain version.

Replaces the TPU kernel `scripts/bench_int8_fusion_matmul.py::_kernel`,
which asks whether the fusion layers' one-hot selection products
`slab [HID, CAPR] @ oh[k] [CAPR, W]` run faster in int8 than in bf16.
One program (one CUDA block) computes

    acc = sum over rep < REPS, rr < TH, k < K of s_i @ oh[k],
    i = 1 + rep * TH * K + rr * K + k,

with s_i = int8(int32(slab) * i) (wrapping modulo 256) in int8, and
s_i = bf16(slab * i) in bf16; each product is summed in int32 (int8) or
float32 (bf16), then added into the float32 result [HID, W]. Every
block computes the same result; the block count sets the amount of
work. The plain version does the same loop in float64.
"""

from __future__ import annotations

from typing import Optional

import torch

from dcf_torch.ops import _cuda

# the flagship's finest fusion scale: HID=64, CAPR=512, W=400, K=4, and
# TH=8 rows per program, REPS=4 loops
HID, CAPR, W, K, TH, REPS = 64, 512, 400, 4, 8, 4
PRODUCTS = REPS * TH * K              # 128 products per block


def scaled_slab(slab: torch.Tensor, i: int) -> torch.Tensor:
    """s_i: int8(int32(slab) * i), wrapping, for an int8 slab; bf16(slab *
    i), rounded once (the product of a bf16 value and an integer up to
    256 is exact in float32), for a bf16 slab."""
    if slab.dtype == torch.int8:
        return (slab.to(torch.int32) * i).to(torch.int8)
    return (slab.to(torch.float32) * i).to(torch.bfloat16)


def selection_mma_plain(slab: torch.Tensor, oh: torch.Tensor
                        ) -> torch.Tensor:
    """The products of one block in float64: slab [HID, CAPR] int8 or
    bf16, oh [K, CAPR, W] of the same type with 0/1 entries -> [HID, W]
    float64."""
    acc = torch.zeros((slab.shape[0], oh.shape[2]), dtype=torch.float64,
                      device=slab.device)
    ohd = oh.to(torch.float64)
    i = 1
    for _ in range(REPS):
        for _ in range(TH):
            for k in range(oh.shape[0]):
                acc += scaled_slab(slab, i).to(torch.float64) @ ohd[k]
                i += 1
    return acc


def default_blocks(device) -> int:
    """Two blocks per streaming multiprocessor."""
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def _launch(name: str, slab: torch.Tensor, oh: torch.Tensor,
            blocks: Optional[int]) -> torch.Tensor:
    dtype = {"dcf_selection_mma_int8": torch.int8,
             "dcf_selection_mma_bf16": torch.bfloat16}[name]
    for arg, t, shape in (("slab", slab, (HID, CAPR)),
                          ("oh", oh, (K, CAPR, W))):
        if t.device != slab.device or t.dtype != dtype or \
                tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be a {dtype} {shape} "
                             f"tensor on {slab.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    blocks = default_blocks(slab.device) if blocks is None else int(blocks)
    if blocks < 1:
        raise ValueError(f"{name}: blocks={blocks}")
    slab = slab.contiguous()
    oht = oh.transpose(1, 2).contiguous()            # [K, W, CAPR]
    out = torch.empty((HID, W), dtype=torch.float32, device=slab.device)
    err = getattr(_cuda.library(), name)(
        slab.data_ptr(), oht.data_ptr(), out.data_ptr(), blocks,
        torch.cuda.current_stream(slab.device).cuda_stream)
    _cuda.check(err, name)
    return out


def selection_mma_int8(slab: torch.Tensor, oh: torch.Tensor,
                       blocks: Optional[int] = None) -> torch.Tensor:
    """The int8 products (int8 slab and oh): the CUDA kernel on `blocks`
    blocks (default two per SM) for CUDA tensors, the plain version (as
    float32) for CPU tensors. -> [HID, W] float32."""
    if slab.device.type == "cpu":
        return selection_mma_plain(slab, oh).to(torch.float32)
    if slab.device.type != "cuda":
        raise ValueError(f"selection_mma_int8: no kernel for {slab.device}")
    out = _launch("dcf_selection_mma_int8", slab, oh, blocks)
    selection_mma_int8.launches += 1
    return out


def selection_mma_bf16(slab: torch.Tensor, oh: torch.Tensor,
                       blocks: Optional[int] = None) -> torch.Tensor:
    """The bf16 products (bf16 slab and oh), as `selection_mma_int8`."""
    if slab.device.type == "cpu":
        return selection_mma_plain(slab, oh).to(torch.float32)
    if slab.device.type != "cuda":
        raise ValueError(f"selection_mma_bf16: no kernel for {slab.device}")
    out = _launch("dcf_selection_mma_bf16", slab, oh, blocks)
    selection_mma_bf16.launches += 1
    return out


selection_mma_int8.launches = 0
selection_mma_bf16.launches = 0


F32_UNIT_ROUNDOFF = 2.0 ** -24


def selection_mma_tolerance(slab: torch.Tensor, oh: torch.Tensor
                            ) -> torch.Tensor:
    """Per-element bound on |float32 result - float64 plain result| for
    the bf16 products: each element is a float32 sum of n = n_dot + 128
    terms (the dot of each product over its n_dot nonzero oh entries,
    then the 128 products), which errs by at most (n - 1) u sum|terms|
    in any order with round-to-nearest adds (u = 2^-24), and by at most
    twice that when the tensor cores truncate; the int8 sums are exact."""
    n_dot = int(oh.to(torch.float64).sum(1).max())
    absum = torch.zeros((slab.shape[0], oh.shape[2]), dtype=torch.float64,
                        device=slab.device)
    i = 1
    for _ in range(REPS * TH):
        for k in range(oh.shape[0]):
            absum += scaled_slab(slab, i).to(torch.float64).abs() @ \
                oh[k].to(torch.float64)
            i += 1
    return 2.0 * (n_dot + PRODUCTS) * F32_UNIT_ROUNDOFF * absum
