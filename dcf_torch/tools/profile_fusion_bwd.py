"""Where the fusion backward kernel's time goes, on the card.

    python -m dcf_torch.tools.profile_fusion_bwd   # from the repository root

No `ncu` runs where the card is, so this tool builds a second copy of
`dcf_torch/csrc/fusion_bwd.cu` with `clock64()` stamps at the gather's
phase boundaries into `dcf_torch/_build/`, and runs it on chip_smoke.py's
four scales of one full-size frame with a seeded cotangent. Per scale:
the repo kernel's device ms (CUDA graph: the zero fill of its counts,
fill, gather, combine, as the wrapper runs them), the fill (with the
zero fill) and combine kernels' alone, whether the stamped copy's
outputs equal the repo kernel's, and the mean SM cycles per warp of each phase of the gather (a warp's stamps;
warps that share an SM share its instruction slots, so a phase's
cycles include its neighbours' work), with the mean and the slowest
warp's total. Last line: the numbers as JSON.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from dcf_torch.ops import _cuda, fusion
from dcf_torch.utils.timing import graph_ms

# per warp: setup (weights loaded, the fill waited for), counts (the chunk's counts loaded),
# first (the first bucket requested), zeros (rows of unselected points
# stored), bucket (a bucket in and sorted), rows (dacc rows in, pairs
# summed), next (d_z1 row stored, the next bucket requested), tail (the
# block's tree and partial)
PHASES = ("setup", "counts", "first", "zeros", "bucket", "rows", "next",
          "tail")
NPH = len(PHASES)
_STAMP = "DCF_STAMP({});\n"
# (anchor in fusion_bwd.cu, phase whose stamp goes after it)
_AFTER = (
    ("  const int tw = gridDim.x * NW;\n", 0),
    ("    unsigned todo = __ballot_sync(kAll, my_n > 0);\n", 1),
    ("    if (todo) fetch(todo, jc, n, e, g, zr);\n", 2),
    ("    s_g[rank] = g;\n  }\n  __syncwarp();\n", 4),
    ("      for (int j = 0; j < CH; ++j) zr[j] = zn[j];\n", 6))
_BEFORE = (
    ("    while (todo) {\n", 3),
    ("  __syncwarp();\n}\n\n// CH channels per lane", 5))
_START = "  float w[CH][4], bc[CH], part[CH][5];\n"
_END = "    partials[e * gridDim.x + blockIdx.x] = s_red[e];\n  }\n"
_PRELUDE = """
constexpr int kProfWarps = 1 << 14;
constexpr int kPhases = %d;
__device__ unsigned long long g_prof[kProfWarps * kPhases];
__shared__ unsigned long long prof_t[32];
__shared__ unsigned long long prof_acc[32][kPhases];
#define DCF_STAMP(k)                                                   \\
  do {                                                                 \\
    if ((threadIdx.x & 31) == 0) {                                     \\
      const unsigned long long now = clock64();                        \\
      prof_acc[threadIdx.x >> 5][k] += now - prof_t[threadIdx.x >> 5]; \\
      prof_t[threadIdx.x >> 5] = now;                                  \\
    }                                                                  \\
    __syncwarp();                                                      \\
  } while (0)
""" % NPH
_EXPORTS = """
extern "C" int dcf_fusion_bwd_prof(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_prof,
                                   n * sizeof(unsigned long long));
}

extern "C" int dcf_fusion_bwd_fill_only(const void* sel, const void* geo,
                                        void* cnt, void* lists, void* feats,
                                        int npix, int hw, int K, int P,
                                        void* stream) {
  fusion_bwd_fill<<<(npix * K + kFillThreads - 1) / kFillThreads,
                    kFillThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sel), static_cast<const float4*>(geo),
      static_cast<int*>(cnt), static_cast<int*>(lists),
      static_cast<float4*>(feats), npix, hw, K, P);
  return (int)cudaGetLastError();
}

extern "C" int dcf_fusion_bwd_combine_only(const void* partials, void* dwgt,
                                           void* dbg, int G, int hid5,
                                           void* stream) {
  fusion_bwd_combine<<<(hid5 * 32 + kCombineThreads - 1) / kCombineThreads,
                       kCombineThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<float*>(dwgt),
      static_cast<float*>(dbg), G, hid5);
  return (int)cudaGetLastError();
}
"""


def stamped_source(src: str) -> str:
    """fusion_bwd.cu with the phase stamps and readers of them."""
    for anchor, k in _AFTER:
        src = _cuda.insert_at(src, anchor, _STAMP.format(k))
    for anchor, k in _BEFORE:
        src = _cuda.insert_at(src, anchor, _STAMP.format(k), after=False)
    src = _cuda.insert_at(src, _START, (
        "  if ((threadIdx.x & 31) == 0) {\n"
        "    prof_t[threadIdx.x >> 5] = clock64();\n"
        "    for (int q = 0; q < kPhases; ++q) "
        "prof_acc[threadIdx.x >> 5][q] = 0;\n  }\n"))
    src = _cuda.insert_at(src, _END, (
        _STAMP.format(NPH - 1)
        + "  if ((threadIdx.x & 31) == 0) {\n"
        "    const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;\n"
        "    if (gw < kProfWarps)\n"
        "      for (int q = 0; q < kPhases; ++q)\n"
        "        g_prof[gw * kPhases + q] = prof_acc[threadIdx.x >> 5][q];\n"
        "  }\n"))
    src = src.replace("namespace {\n", _PRELUDE + "namespace {\n", 1)
    return src + _EXPORTS


def build_stamped() -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    return _cuda.build_copy(
        "fusion_bwd.cu", "fusion_bwd_stamped", stamped_source,
        {"dcf_fusion_bwd_fill_only": (P, P, P, P, P, I, I, I, I, P),
         "dcf_fusion_bwd_combine_only": (P, P, P, I, I, P),
         "dcf_fusion_bwd_prof": (P, I)})


def run(device="cuda"):
    import chip_smoke
    from dcf_torch.config import multi_scale_config
    from dcf_torch.data.preprocess import frame_to_example
    from dcf_torch.data.synthetic import make_varied_frame
    device = torch.device(device)
    stamped = build_stamped()
    cfg = multi_scale_config()
    example = frame_to_example(make_varied_frame(seed=3), cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for s, args in chip_smoke.fusion_inputs(cfg, example, device,
                                            np.random.default_rng(0)):
        _, stash = fusion._forward(*args, stash=True)
        z1, wgt, bg = args[2:5]
        B, H, W = args[0].shape[:3]
        P, hid = z1.shape[1:]
        dout = torch.randn((B, H, W, hid + 1), generator=gen, device=device)
        dacc = dout[..., :hid]
        want = fusion.fused_fusion_bwd(stash, z1, wgt, bg, dacc)
        scratch, blocks = fusion.fusion_bwd_scratch(B, P, hid, device)
        cnt = scratch[0]
        outs = tuple(torch.empty_like(t) for t in want)

        def launch(lib=None):  # from zeroed counts, as the wrapper runs it
            cnt.zero_()
            fusion._launch_bwd(stash, z1, wgt, bg, dacc, outs, scratch,
                               blocks, lib)
        ms = graph_ms(launch)
        sel, geo = stash

        def fill():
            cnt.zero_()
            _cuda.check(stamped.dcf_fusion_bwd_fill_only(
                sel.data_ptr(), geo.data_ptr(), cnt.data_ptr(),
                scratch[1].data_ptr(), scratch[2].data_ptr(), B * H * W,
                H * W, sel.shape[-1], P,
                torch.cuda.current_stream().cuda_stream), "fill")

        def combine():
            _cuda.check(stamped.dcf_fusion_bwd_combine_only(
                scratch[3].data_ptr(), outs[1].data_ptr(),
                outs[2].data_ptr(), blocks, hid * 5,
                torch.cuda.current_stream().cuda_stream), "combine")
        fill_ms = graph_ms(fill)
        combine_ms = graph_ms(combine)
        launch(stamped)
        torch.cuda.synchronize()
        got = outs
        nthreads = 1024 if hid <= 64 else 512 if hid <= 128 else 256
        warps = blocks * nthreads // 32
        buf = (ctypes.c_ulonglong * (NPH * warps))()
        _cuda.check(stamped.dcf_fusion_bwd_prof(buf, NPH * warps), "prof")
        cyc = np.array(buf[:], dtype=np.float64).reshape(warps, NPH)
        rows.append({"stride": s, "pixels": B * H * W,
                     "pairs": int((sel >= 0).sum()), "ms": ms,
                     "fill_ms": fill_ms, "combine_ms": combine_ms,
                     "equal": all(torch.equal(a, b)
                                  for a, b in zip(got, want)),
                     "cycles": dict(zip(PHASES, cyc.mean(0).tolist())),
                     "slowest_warp_cycles": float(cyc.sum(1).max()),
                     "mean_warp_cycles": float(cyc.sum(1).mean())})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_fusion_bwd: no CUDA device", file=sys.stderr)
        return 1
    from dcf_torch.tools.bench_int8_mma import card
    print(f"card: {card()}", flush=True)
    rows = run()
    for r in rows:
        c = r["cycles"]
        print(f"s{r['stride']} {r['pixels']} px, {r['pairs']} pairs: "
              f"{r['ms']:.4f} ms (fill {r['fill_ms']:.4f} ms, combine "
              f"{r['combine_ms']:.4f} ms), "
              f"{'equal' if r['equal'] else 'DIFFERS'}; mean cycles per warp "
              + ", ".join(f"{k} {v:.0f}" for k, v in c.items())
              + f"; a warp's total: mean {r['mean_warp_cycles']:.0f}, "
              f"slowest {r['slowest_warp_cycles']:.0f}", flush=True)
    print(json.dumps(rows), flush=True)
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
