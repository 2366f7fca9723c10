"""The clip kernel against its register-list variant, on the card.

    python -m dcf_torch.tools.profile_clip        # from the repository root

`dcf_torch/csrc/clip.cu` keeps each pair's vertex lists in per-thread
columns of shared memory; `dcf_torch/csrc/variants/clip_registers.cu`
is the same clip with the lists in register arrays, written by
compile-time-indexed selects. This tool builds the variant beside the
kernel library and runs both on chip_smoke.py's 196,608 box pairs. Per
kernel: how many pairs differ from the plain version at all, device ms
(CUDA graph; three readings, the kernels in turn), and from
`cuobjdump -sass` its instruction count, the local-memory accesses
(STL, LDL) and the largest opcode families. Last line: the numbers as
JSON.
"""

from __future__ import annotations

import json
import sys

import torch

from dcf_torch.ops import _cuda
from dcf_torch.tools import sass_summary
from dcf_torch.utils.timing import graph_ms

N_PAIRS = 3 * 256 * 256          # the NMS pairs of one frame


def run(device="cuda"):
    import chip_smoke
    from dcf_torch.ops.clip import rotated_intersection_area_pairs_plain
    device = torch.device(device)
    variant = _cuda.build_copy("variants/clip_registers.cu",
                               "clip_registers", lambda src: src)
    kernels = {"clip.cu (shared memory)": (_cuda.library(),
                                           _cuda.LIB_PATH),
               "clip_registers.cu": (variant, variant._name)}
    a, b = chip_smoke.clip_pairs(device, N_PAIRS)
    want = rotated_intersection_area_pairs_plain(a, b)
    out = torch.empty_like(want)
    rows = {}

    def launch(lib):
        _cuda.check(lib.dcf_clip_pairs(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), N_PAIRS,
            torch.cuda.current_stream().cuda_stream), "dcf_clip_pairs")
    for name, (lib, path) in kernels.items():
        out.fill_(float("nan"))
        launch(lib)
        torch.cuda.synchronize()
        ops = next(sass_summary.opcodes(block)
                   for kernel, block in sass_summary.kernels_sass(path)
                   if "clip_pairs" in kernel)
        rows[name] = {"differing": int((out != want).sum()), "ms": [],
                      "instructions": sum(ops.values()),
                      "local": ops["STL"] + ops["LDL"],
                      "top": ops.most_common(6)}
    for _ in range(3):
        for name, (lib, _) in kernels.items():
            rows[name]["ms"].append(graph_ms(lambda: launch(lib)))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_clip: no CUDA device", file=sys.stderr)
        return 1
    from dcf_torch.tools.bench_int8_mma import card
    print(f"card: {card()}", flush=True)
    rows = run()
    for name, r in rows.items():
        print(f"{name}: {N_PAIRS} pairs, {r['differing']} differ from the "
              f"plain version; ms {', '.join(f'{m:.5f}' for m in r['ms'])};"
              f" {r['instructions']} SASS instructions, {r['local']} STL / "
              f"LDL, most: {r['top']}", flush=True)
    print(json.dumps(rows), flush=True)
    return 0 if all(r["differing"] == 0 for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
