"""The benchmark of the ContFuse port (`dcf_torch`) on NVIDIA GPUs.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of `BENCHMARK.json` on this machine's card: set-up (inputs
and weights from the seed, warm-up), a window of `--seconds`, then the
comparison of what the window produced with the plain reference of the
configuration's model family (`perfbench/families/`). Prints the compared
numbers with their limits as the last lines of standard error and one JSON
object as the last line of standard output: the end-to-end metrics with
`--trace 0`, the per-layer metrics (and the profiled sub-window's
breakdown) with `--trace 1`.
Exits non-zero, with no result, without enough CUDA cards, or if JAX or
the JAX package was loaded.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative integer")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    import torch
    from perfbench import harness, registry
    bench = registry.load_benchmark(ROOT)
    chips = registry.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = harness.execute(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda")
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
