"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

`execute` drives a run on any device, so the tests can drive it on the
CPU; `run.py` is the command, which insists on a card."""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
from typing import Any, Callable, Dict, Optional

import torch

from perfbench import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "dcf")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`dcf_torch` is not `dcf`)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in modules}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Env:
    """What a run needs: the cell's model family (its module) and
    configuration, its mix, the seed and window, and hooks for the
    tests."""

    family: Any
    config_json: str
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmpdir: str
    fault: Optional[Callable] = None
    setup_s: float = 0.0

    def mark_window_start(self) -> None:
        self.setup_s = process_age_s()


def mode_module(mode: str):
    if mode == "serve":
        from perfbench import serve
        return serve
    if mode == "train":
        from perfbench import train
        return train
    raise ValueError(f"unknown traffic mode {mode!r}")


def limits(config: Dict, mode: str) -> Dict[str, float]:
    return config["limits"][mode]


def execute(bench: Dict, cell_name: str, seed: int, seconds: float,
            trace: bool, device, base: str = registry.HERE,
            fault: Optional[Callable] = None) -> Dict:
    """Run `cell_name` and return the result object (printed by
    `run.py` as the last line)."""
    cell = registry.cell(bench, cell_name)
    config = registry.config(cell["config"], base)
    family = registry.family(config.get("family"), base)
    traffic = registry.traffic(cell["traffic"], base)
    mod = mode_module(traffic["mode"])
    device = torch.device(device)
    with tempfile.TemporaryDirectory() as tmpdir:
        env = Env(family=family, config_json=json.dumps(config["config"]),
                  traffic=traffic, seed=seed, seconds=seconds, trace=trace,
                  device=device, tmpdir=tmpdir, fault=fault)
        out = mod.run(env)
        numbers = family.compare(traffic["mode"], out, device)
    lim = limits(config, traffic["mode"])
    checks = {k: {"value": numbers[k], "limit": lim[k]} for k in lim}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        ctx = Context(out, traffic, config, family)
        for m in registry.per_layer(bench, cell_name):
            value = registry.metric_reader(m["name"], base).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in registry.end_to_end(bench, cell_name):
            value = (env.setup_s if m["name"] == "setup_s"
                     else out["e2e"][m["name"]])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(device, out["memory_peak"])}
    if "window_steps" in out:
        result["window_steps"] = out["window_steps"]
    if trace and out["profile"] is not None:
        p = out["profile"]
        result["device"]["busy_s"] = p["busy_s"]
        result["device"]["window_s"] = p["window_s"]
        result["breakdown"] = {"device_ops": p["device_ops"],
                               "idle_gaps": p["idle_gaps"]}
    result["checks"] = checks
    return result


def device_info(device, memory_peak: int) -> Dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1,
                "memory_peak_bytes": memory_peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": memory_peak}


class Context:
    """What a per-layer metric reader reads: the run's spans, its
    profiled sub-window and op ranges, the model family, and the
    configuration (the family's reference copy, for the frozen
    arithmetic)."""

    def __init__(self, out: Dict, traffic: Dict, config: Dict, family):
        self.spans = out["spans"]
        self.profile = out["profile"]
        self.ranges = out["ranges"]
        self.traffic = traffic
        self.family = family
        self.cfg = family.reference_config(json.dumps(config["config"]))

    def flops_per_frame(self) -> float:
        """Model FLOPs of one frame of this cell's mode (the family's
        frozen count)."""
        return self.family.flops_per_frame(self.cfg, self.traffic["mode"])

    def device_ms_per(self, name: str, per: str) -> Optional[float]:
        """Mean device ms of span `name` per frame or step, or None."""
        ms = self.spans["device_ms"].get(name)
        if not ms:
            return None
        return sum(ms) / self.spans[per]

    def host_ms_per(self, name: str, per: str) -> Optional[float]:
        s = self.spans["host_s"].get(name)
        if not s:
            return None
        return sum(s) * 1e3 / self.spans[per]
