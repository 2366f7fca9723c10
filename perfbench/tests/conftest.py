"""A tiny copy of the benchmark for CPU tests: the cell files of
`perfbench/` plus a tiny configuration and tiny mixes, in a temporary
directory that `harness.execute(..., base=...)` reads."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

GEN = {"objects": [1, 4], "ground_points": [1000, 3000],
       "points_per_object": [120, 400], "sweep_points": 20000}


@pytest.fixture(scope="session")
def tiny_base(tmp_path_factory):
    """(base directory, BENCHMARK dict) with the cells `tiny.serve` and
    `tiny.train`: `tiny_config()` under the limits of `contfuse-ms`."""
    from perfbench.reference.config import tiny_config
    base = tmp_path_factory.mktemp("bench")
    src = os.path.join(ROOT, "perfbench")
    for d in ("configs", "traffic", "metrics", "families"):
        shutil.copytree(os.path.join(src, d), base / d)
    with open(base / "configs" / "contfuse-ms.json") as f:
        full = json.load(f)
    # the full size's limits, which readings at this size on the CPU
    # bear out: head_err, bf16 0.025-0.069 (16 seeds), the float8 control
    # 0.27-0.42 (8 seeds); fwd_err, bf16 0.022-0.030, the float8 control
    # 0.23-0.33 (seeds 9-14, batch 4)
    limits = full["limits"]
    tiny = dict(full, config=json.loads(tiny_config().to_json()),
                limits=limits)
    (base / "configs" / "tiny.json").write_text(json.dumps(tiny))
    (base / "traffic" / "tserve.json").write_text(json.dumps(
        {"mode": "serve", "batch": 1, "pool": 4, "generator": GEN,
         "warmup_frames": 1, "check_frames": 2, "profile_s": 0.5}))
    (base / "traffic" / "ttrain.json").write_text(json.dumps(
        {"mode": "train", "batch": 4, "pool": 8, "generator": GEN,
         "warmup_steps": 3, "check_steps": 3, "profile_s": 0.5}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] += [
        {"name": "tiny.serve", "config": "tiny", "traffic": "tserve",
         "chips": 1, "why": "CPU test"},
        {"name": "tiny.train", "config": "tiny", "traffic": "ttrain",
         "chips": 1, "why": "CPU test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            serve = any("serve" in w for w in m["workloads"])
            m["workloads"].append("tiny.serve" if serve else "tiny.train")
    return str(base), bench
