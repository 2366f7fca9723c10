"""Where the KNN selection kernel's time goes, on the card.

    python -m dcf_torch.tools.profile_knn         # from the repository root

No `ncu` runs where the card is, so this tool builds a second copy of
`dcf_torch/csrc/knn.cu` with `clock64()` stamps at the kernel's phase
boundaries (halo staged; selection done; lanes merged; rows stored) into
`dcf_torch/_build/`, and runs both copies on chip_smoke.py's KNN cases
(the four scales of one full-size frame and the tie lattice), at every
lane count whose tile fits in shared memory: per (case, lanes) the repo
kernel's device ms (CUDA graph), whether its output and the stamped
copy's equal the plain version's, and the mean SM cycles per block of
each phase, with the mean and the slowest block's total (thread 0's
stamps; the stamped copy adds a block barrier before the merge and
after it, so "selection" is the block's slowest lane and "merge" its
slowest warp; blocks that share an SM share its issue slots, so a
phase's cycles include its neighbours' work). The launch shape the
wrapper picks is marked. Last line: the numbers as JSON.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from dcf_torch.ops import _cuda, knn
from dcf_torch.tools import stamps
from dcf_torch.utils.timing import graph_ms

PHASES = ("halo", "selection", "merge", "write_out")
STAMP_BLOCKS = 1 << 16
_MERGE = "  dcf::merge_lanes<K>(bk, L);\n"
# (anchor in knn.cu, stamp, inserted after it)
_INSERTS = (
    ("  const int tid = threadIdx.x;\n",
     "  long long tt[5];\n  tt[0] = clock64();\n", True),
    ('  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n'
     "  __syncthreads();\n", "  tt[1] = clock64();\n", True),
    (_MERGE, "  __syncthreads();\n  tt[2] = clock64();\n", False),
    (_MERGE, "  __syncthreads();\n  tt[3] = clock64();\n", True),
    ('    asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: '
     '"memory");\n', stamps.block_record(4), True))


def build_stamped() -> ctypes.CDLL:
    """knn.cu with the phase stamps, built beside the library."""
    return stamps.build("knn.cu", "knn_stamped", STAMP_BLOCKS, len(PHASES),
                        _INSERTS)


def _launch(lib, bins, origin, cell, k, r, lanes, outs) -> None:
    B, H, W, C, D = bins.data.shape
    th, tw = knn.KNN_TILES[lanes]
    nbr, ok, d2 = outs
    err = lib.dcf_knn_select(
        bins.data.data_ptr(), bins.valid.data_ptr(), nbr.data_ptr(),
        ok.data_ptr(), d2.data_ptr(), B, H, W, C, D, k, r, lanes, th, tw,
        ctypes.c_float(origin[0]), ctypes.c_float(origin[1]),
        ctypes.c_float(cell), torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "knn_select (stamped)")


def run(device="cuda"):
    import chip_smoke
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.preprocess import frame_to_example
    from dcf_torch.data.synthetic import make_varied_frame
    device = torch.device(device)
    stamped = build_stamped()
    cfg = multi_scale_config()
    k, r = cfg.fusion.num_neighbors, cfg.fusion.search_radius_cells
    example = frame_to_example(make_varied_frame(seed=3), cfg)
    sms = _cuda.sm_count(device)
    rows = []
    for name, bins, origin, cell in chip_smoke.knn_cases(cfg, example,
                                                         device):
        want = knn.knn_select_plain(bins, origin, cell, k, r)
        B, H, W, C, D = bins.data.shape
        auto = knn.knn_launch_shape(B, H, W, C, D, k, r, sms)[0]
        for lanes, (th, tw) in knn.KNN_TILES.items():
            if knn.knn_smem_bytes(th, tw, C, D, k, r) > knn.SMEM_BYTES:
                continue
            got = knn._select(bins, origin, cell, k, r, lanes=lanes)
            ms = graph_ms(lambda: knn._select(bins, origin, cell, k, r,
                                              lanes=lanes))
            outs = tuple(torch.empty_like(t) for t in want)
            _launch(stamped, bins, origin, cell, k, r, lanes, outs)
            torch.cuda.synchronize()
            blocks = B * -(-H // th) * -(-W // tw)
            cyc = stamps.read(stamped, blocks, len(PHASES))
            rows.append({"case": name, "pixels": B * H * W, "lanes": lanes,
                         "tile": [th, tw], "blocks": blocks,
                         "chosen": lanes == auto, "ms": ms,
                         "bit_equal": chip_smoke.knn_agree(got, want)[0]
                         and chip_smoke.knn_agree(outs, want)[0],
                         "cycles": dict(zip(PHASES, cyc.mean(0).tolist())),
                         "slowest_block_cycles": float(cyc.sum(1).max()),
                         "mean_block_cycles": float(cyc.sum(1).mean())})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_knn: no CUDA device", file=sys.stderr)
        return 1
    from dcf_torch.tools.bench_int8_mma import card
    print(f"card: {card()}", flush=True)
    rows = run()
    for r in rows:
        c = r["cycles"]
        print(f"{r['case']} {r['pixels']} px, {r['lanes']} lanes, tiles "
              f"{r['tile'][0]}x{r['tile'][1]} ({r['blocks']} blocks)"
              f"{' [chosen]' if r['chosen'] else ''}: {r['ms']:.4f} ms, "
              f"{'bit-equal' if r['bit_equal'] else 'DIFFERS'}, cycles per "
              f"block halo {c['halo']:.0f} / selection {c['selection']:.0f}"
              f" / merge {c['merge']:.0f} / write-out {c['write_out']:.0f};"
              f" a block's total: mean {r['mean_block_cycles']:.0f}, slowest "
              f"{r['slowest_block_cycles']:.0f}", flush=True)
    print(json.dumps(rows), flush=True)
    return 0 if all(r["bit_equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
