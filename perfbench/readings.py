"""Readings that the limits of `correct` are set from, many seeds in one
process (not run by the benchmark's own runs):

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control N] [--fault NAME] [--seconds 2]

Per seed one JSON line with the compared numbers of the program as the
cell runs it (the lower readings) or, with `--fault`, of the program with
a fault of `faults.py` planted. On the first N seeds (`--control N`) the
line also holds the control's numbers on the same frames or batches: the
reference with its convs rounded through float8 put in the program's
place (the model family's `control`).
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from perfbench import faults, harness, registry
    bench = registry.load_benchmark(ROOT)
    try:
        cell = registry.cell(bench, args.workload)
    except KeyError:                    # a cell left out: <config>.<mix>
        name, mix = args.workload.split(".", 1)
        cell = {"config": name, "traffic": mix}
    config = registry.config(cell["config"])
    family = registry.family(config["family"])
    traffic = registry.traffic(cell["traffic"])
    mode = traffic["mode"]
    mod = harness.mode_module(mode)
    fault = None
    if args.fault:
        fault = (faults.SERVE if mode == "serve" else faults.TRAIN)[args.fault]
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmpdir:
            env = harness.Env(family=family,
                              config_json=json.dumps(config["config"]),
                              traffic=traffic, seed=seed,
                              seconds=args.seconds, trace=False,
                              device=device, tmpdir=tmpdir, fault=fault)
            out = mod.run(env)
            numbers = family.compare(mode, out, device)
            numbers.update(family.look(mode, out))
            line = {"workload": args.workload, "seed": seed,
                    "fault": args.fault, "numbers": numbers,
                    "e2e": out["e2e"]}
            if n < args.control:
                line["control"] = family.control(mode, out, device)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del out
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
