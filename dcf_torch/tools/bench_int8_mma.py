"""Micro-benchmark of int8 against bf16 selection products on the card:
the port of `scripts/bench_int8_fusion_matmul.py`.

    python -m dcf_torch.tools.bench_int8_mma [--blocks N] [--seed S]

Runs both kernels of `dcf_torch/csrc/int8_mma.cu` (wgmma fed by TMA) on
N programs (default two per SM; every program computes one TPU
program's [64, 400] result; a persistent grid of at most one CTA per SM
walks over them),
holds each to its plain version (float64 arithmetic of the same loop:
int8 exact, bf16 within `selection_mma_tolerance`), and prints the
card's name and power limit, each kernel's device time (a CUDA graph of
back-to-back calls between CUDA events), its TF/s or TOP/s and its
bound (the products over the card's dense tensor peak), the int8 / bf16
speedup, and the time of the same products through `torch._int_mm`
(int8) and `torch.matmul` (bf16), one call per product over all blocks'
rows. The last line is the results as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

from dcf_torch.ops import int8_mma as M
from dcf_torch.utils.flops import H100_PEAK_BF16_FLOPS, H100_PEAK_INT8_OPS
from dcf_torch.utils.timing import cuda_ms, graph_ms


def make_inputs(device, seed: int = 0, density: float = 1.0 / M.CAPR):
    """The TPU benchmark's operands, made with numpy from `seed`: slab
    normal * 8 (int8: truncated toward zero, as JAX's astype; bf16:
    rounded), oh 0/1 with P(1) = `density` (the benchmark's 1 / CAPR).
    Returns {"int8": (slab, oh), "bf16": (slab, oh)} on `device`."""
    rng = np.random.default_rng(seed)
    normal = (rng.normal(size=(M.HID, M.CAPR)) * 8).astype(np.float32)
    oh = (rng.uniform(size=(M.K, M.CAPR, M.W)) < density).astype(np.int8)
    slab8 = np.trunc(np.clip(normal, -128, 127)).astype(np.int8)
    return {"int8": (torch.from_numpy(slab8).to(device),
                     torch.from_numpy(oh).to(device)),
            "bf16": (torch.from_numpy(normal).to(device, torch.bfloat16),
                     torch.from_numpy(oh).to(device, torch.bfloat16))}


def check(kind: str, slab, oh, blocks: int) -> float:
    """One kernel call against the plain version; returns max |err|.
    Raises if int8 is not exact or bf16 leaves its bound."""
    fn = {"int8": M.selection_mma_int8, "bf16": M.selection_mma_bf16}[kind]
    got = fn(slab, oh, blocks).to(torch.float64)
    want = M.selection_mma_plain(slab, oh)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if kind == "int8":
        bad = err > 0
    else:
        bad = err > M.selection_mma_tolerance(slab, oh)
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"selection_mma_{kind}: {int(bad.sum())} of "
                           f"{got.numel()} elements off the plain version, "
                           f"max|err| {err.max().item()}")
    return err.max().item()


def library_ms(kind: str, slab, oh, blocks: int) -> float:
    """The same products through one PyTorch call each: all blocks' rows
    at once ([blocks * 64, 512] @ [512, 400]), 128 calls, in a CUDA
    graph. s_1..s_4 stand for all 128 scaled slabs (a dense product's
    time does not depend on its values)."""
    a = [M.scaled_slab(slab, 1 + k).repeat(blocks, 1).contiguous()
         for k in range(M.K)]
    mm = torch._int_mm if kind == "int8" else torch.matmul

    def products():
        for _ in range(M.REPS * M.TH):
            for k in range(M.K):
                mm(a[k], oh[k])
    return graph_ms(products, reps=1, replays=3)


def run(device="cuda", blocks: Optional[int] = None, seed: int = 0
        ) -> Dict:
    """Check, time and rate both kernels; returns the numbers."""
    device = torch.device(device)
    blocks = M.default_blocks(device) if blocks is None else blocks
    ops = 2.0 * M.HID * M.CAPR * M.W * M.PRODUCTS * blocks
    dense = make_inputs(device, seed + 1, density=0.02)
    out = {"blocks": blocks, "ops": ops}
    for kind, peak in (("int8", H100_PEAK_INT8_OPS),
                       ("bf16", H100_PEAK_BF16_FLOPS)):
        slab, oh = make_inputs(device, seed)[kind]
        err = max(check(kind, slab, oh, blocks),
                  check(kind, *dense[kind], 1))
        fn = {"int8": M.selection_mma_int8,
              "bf16": M.selection_mma_bf16}[kind]
        ms = graph_ms(lambda: fn(slab, oh, blocks), reps=5, replays=3)
        out[kind] = {
            "ms": ms, "rate": ops / ms / 1e9, "bound_ms": ops / peak * 1e3,
            "max_abs_err": err,
            "plain_ms": cuda_ms(lambda: M.selection_mma_plain(slab, oh), 1),
            "library_ms": library_ms(kind, slab, oh, blocks)}
    out["speedup"] = out["bf16"]["ms"] / out["int8"]["ms"]
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=None,
                    help="programs per launch (default: two per SM)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_int8_mma: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card()}", flush=True)
    r = run("cuda", args.blocks, args.seed)
    print(f"{r['blocks']} programs, {r['ops']:.4g} operations per launch",
          flush=True)
    for kind, unit in (("bf16", "TF/s"), ("int8", "TOP/s")):
        k = r[kind]
        print(f"{kind}: kernel {k['ms']:.4f} ms ({k['rate']:.1f} "
              f"{unit}), bound {k['bound_ms']:.4f} ms, library "
              f"{k['library_ms']:.4f} ms, plain (one block) "
              f"{k['plain_ms']:.3f} ms, max|err| {k['max_abs_err']:.3g}",
              flush=True)
    print(f"int8 / bf16 speedup {r['speedup']:.3f}x", flush=True)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
