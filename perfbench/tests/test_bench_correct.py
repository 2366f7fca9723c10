"""`correct` at a small size on the CPU: the control (the reference with
its convs rounded through float8, in the program's place) fails the
cell's limits, and so does every fault of `faults.py` planted under the
timed path, while the program as the cell runs it passes."""

import json
import tempfile

import pytest
import torch

from perfbench import faults, harness, registry

contfuse = registry.family("contfuse")


def _numbers(base, bench, cell, seed, **kw):
    c = registry.cell(bench, cell)
    config = registry.config(c["config"], base)
    traffic = registry.traffic(c["traffic"], base)
    mod = harness.mode_module(traffic["mode"])
    with tempfile.TemporaryDirectory() as tmpdir:
        env = harness.Env(family=registry.family(config["family"], base),
                          config_json=json.dumps(config["config"]),
                          traffic=traffic, seed=seed, seconds=0.5,
                          trace=False, device=torch.device("cpu"),
                          tmpdir=tmpdir, **kw)
        out = mod.run(env)
        return (out, env.family.compare(traffic["mode"], out,
                                        torch.device("cpu")), config)


def _fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


def test_serve_control_fails(tiny_base):
    base, bench = tiny_base
    for seed in (5, 2 ** 31 + 3):
        out, ok, config = _numbers(base, bench, "tiny.serve", seed)
        ctl = contfuse.serve_compare(out, torch.device("cpu"), control=True)
        lim = config["limits"]["serve"]
        assert not _fails(ok, lim), ok
        assert _fails(ctl, lim), ctl


@pytest.mark.parametrize("seed", [11, 13])
def test_train_control_fails(tiny_base, seed):
    """The float8 control fails on the first step's head maps."""
    base, bench = tiny_base
    out, ok, config = _numbers(base, bench, "tiny.train", seed)
    lim = config["limits"]["train"]
    assert not _fails(ok, lim), ok
    batches = contfuse.replay_batches(out["ref_cfg"], out["pool_ref"], 3)
    ref = contfuse.reference_steps(out["ref_cfg"], out["weights"], batches,
                                   torch.device("cpu"))
    low = contfuse.reference_steps(out["ref_cfg"], out["weights"], batches,
                                   torch.device("cpu"), quant="fp8")
    assert _fails({"batch_diff": 0.0,
                   **contfuse.compare_numbers(low, ref)}, lim)


@pytest.mark.parametrize("cell, fault", [
    ("tiny.serve", faults.altered_answer),
    ("tiny.train", faults.half_batch),
    ("tiny.train", faults.state_unchanged)])
def test_fault_makes_correct_false(tiny_base, cell, fault):
    base, bench = tiny_base
    r = harness.execute(bench, cell, 77, 0.5, False, "cpu", base=base,
                        fault=fault)
    assert r["correct"] is False, r["checks"]
