"""The result line's schema, and the command's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import ROOT


def _check_schema(result, trace):
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(result)
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool)
    assert result["attempted"] > 0 and result["failed"] == 0
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_serve_line(tiny_base):
    base, bench = tiny_base
    r = harness.execute(bench, "tiny.serve", 2 ** 31 + 17, 1.0, False,
                        "cpu", base=base)
    _check_schema(r, False)
    assert set(r["metrics"]) == {"frame_ms_p50", "frame_ms_p95", "setup_s"}
    assert r["correct"], r["checks"]


def test_train_line(tiny_base):
    base, bench = tiny_base
    r = harness.execute(bench, "tiny.train", 11, 1.0, False,
                        "cpu", base=base)
    _check_schema(r, False)
    assert set(r["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert r["correct"], r["checks"]


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", "contfuse-ms.serve-b1", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bare_checkout_refused(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/ (no program)
    gives no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "contfuse-ms.serve-b1", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
