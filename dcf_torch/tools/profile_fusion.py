"""Where the fusion forward kernel's time goes, on the card.

    python -m dcf_torch.tools.profile_fusion      # from the repository root

No `ncu` runs where the card is, so this tool builds a second copy of
`dcf_torch/csrc/fusion_fwd.cu` with `clock64()` stamps at the kernel's
phase boundaries (halo staged, phase 1 done, phase 2 done, rows stored)
into `dcf_torch/_build/`, and runs both copies on chip_smoke.py's four
scales of one full-size frame, at every lane count the kernel takes:
per (scale, lanes) the repo kernel's device ms (CUDA graph), whether its
output is bit-equal to the plain version, and the mean SM cycles per
block of each phase (thread 0's stamps; blocks that share an SM share
its issue slots, so a phase's cycles include its neighbours' work). The
launch shape the wrapper picks is marked. Last line: the numbers as JSON.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from dcf_torch.ops import _cuda, fusion
from dcf_torch.utils.timing import graph_ms

PHASES = ("halo", "phase1", "phase2", "store")
# (anchor in fusion_fwd.cu, stamp inserted after it)
_STAMPS = (
    ("  const int tid = threadIdx.x;\n",
     "  long long tt[5];\n  tt[0] = clock64();\n"),
    ('  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
     "  __syncthreads();\n", "  tt[1] = clock64();\n"),
    ("  __syncthreads();   // the halo is dead from here: phase 2 stages "
     "over it\n", "  tt[2] = clock64();\n"),
    ('  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
     "  __syncthreads();\n", "  tt[3] = clock64();\n"))
_END = ("  if (bulk) {   // the stage must outlive the copies' reads\n")


def stamped_source(src: str) -> str:
    """fusion_fwd.cu with the phase stamps and a reader of them."""
    for anchor, stamp in _STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"profile_fusion: anchor not found once: "
                               f"{anchor!r}")
        src = src.replace(anchor, anchor + stamp)
    if src.count(_END) != 1:
        raise RuntimeError("profile_fusion: end anchor not found once")
    src = src.replace(_END, (
        "  __syncthreads();\n  tt[4] = clock64();\n"
        "  if (tid == 0) {\n"
        "    const int bl = (blockIdx.z * gridDim.y + blockIdx.y) * "
        "gridDim.x + blockIdx.x;\n"
        "    if (bl < kStampBlocks)\n"
        "      for (int q = 0; q < 4; ++q) "
        "g_stamps[bl * 4 + q] = tt[q + 1] - tt[q];\n  }\n") + _END)
    src = src.replace("namespace {\n", (
        "constexpr int kStampBlocks = 1 << 16;\n"
        "__device__ long long g_stamps[kStampBlocks * 4];\n"
        "namespace {\n"), 1)
    return src + ('\nextern "C" int dcf_fusion_stamps(void* host, int n) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_stamps, "
                  "n * sizeof(long long));\n}\n")


def build_stamped() -> ctypes.CDLL:
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_cuda.BUILD_DIR, "fusion_fwd_stamped.cu")
    so = os.path.join(_cuda.BUILD_DIR, "libfusion_fwd_stamped.so")
    with open(os.path.join(_cuda.CSRC, "fusion_fwd.cu")) as f:
        src = stamped_source(f.read())
    with open(cu, "w") as f:
        f.write(src)
    flags = [f for f in _cuda.COMPILE_FLAGS if f != "-c"]
    subprocess.run([_cuda._nvcc(), *flags, "-shared", "-o", so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.dcf_fusion_fwd.argtypes = list(_cuda._SIGNATURES["dcf_fusion_fwd"])
    lib.dcf_fusion_fwd.restype = ctypes.c_int
    return lib


def _launch(lib, args, lanes: int, out) -> None:
    data, valid, z1, wgt, bg, origin, cell, k, r = args
    B, H, W, C, _ = data.shape
    P, hid = z1.shape[1:]
    th, tw = fusion.FWD_TILES[lanes]
    err = lib.dcf_fusion_fwd(
        data.data_ptr(), valid.data_ptr(), z1.data_ptr(), wgt.data_ptr(),
        bg.data_ptr(), out.data_ptr(), None, None, B, H, W, C, P, hid, k, r,
        lanes, th, tw, ctypes.c_float(origin[0]), ctypes.c_float(origin[1]),
        ctypes.c_float(cell), torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "fusion_fwd (stamped)")


def run(device="cuda"):
    import chip_smoke
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.preprocess import frame_to_example
    from dcf_torch.data.synthetic import make_varied_frame
    device = torch.device(device)
    stamped = build_stamped()
    cfg = multi_scale_config()
    example = frame_to_example(make_varied_frame(seed=3), cfg)
    rows = []
    for s, args in chip_smoke.fusion_inputs(cfg, example, device,
                                            np.random.default_rng(0)):
        want = fusion.fused_fusion_plain(*args)
        B, H, W = args[0].shape[:3]
        auto = fusion.fusion_launch_shape(B, H, W, _cuda.sm_count(device))[0]
        for lanes, (th, tw) in fusion.FWD_TILES.items():
            got = fusion._forward(*args, stash=False, lanes=lanes)
            ms = graph_ms(lambda: fusion._forward(*args, stash=False,
                                                  lanes=lanes))
            out = torch.empty_like(want)
            _launch(stamped, args, lanes, out)
            torch.cuda.synchronize()
            blocks = B * -(-H // th) * -(-W // tw)
            buf = (ctypes.c_longlong * (4 * blocks))()
            _cuda.check(stamped.dcf_fusion_stamps(buf, 4 * blocks), "stamps")
            cyc = np.array(buf[:], dtype=np.float64).reshape(blocks, 4)
            rows.append({"stride": s, "pixels": B * H * W, "lanes": lanes,
                         "tile": [th, tw], "blocks": blocks,
                         "chosen": lanes == auto, "ms": ms,
                         "bit_equal": bool(torch.equal(got, want)
                                           and torch.equal(out, want)),
                         "cycles": dict(zip(PHASES, cyc.mean(0).tolist()))})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_fusion: no CUDA device", file=sys.stderr)
        return 1
    from dcf_torch.tools.bench_int8_mma import card
    print(f"card: {card()}", flush=True)
    rows = run()
    for r in rows:
        c = r["cycles"]
        print(f"s{r['stride']} {r['pixels']} px, {r['lanes']} lanes, tiles "
              f"{r['tile'][0]}x{r['tile'][1]} ({r['blocks']} blocks)"
              f"{' [chosen]' if r['chosen'] else ''}: {r['ms']:.4f} ms, "
              f"{'bit-equal' if r['bit_equal'] else 'DIFFERS'}, cycles per "
              f"block halo {c['halo']:.0f} / phase 1 {c['phase1']:.0f} / "
              f"phase 2 {c['phase2']:.0f} / store {c['store']:.0f}",
              flush=True)
    print(json.dumps(rows), flush=True)
    return 0 if all(r["bit_equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
