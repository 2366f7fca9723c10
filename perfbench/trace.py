"""The profiled sub-window: `torch.profiler` over the last seconds of a
traced run, reduced from its Chrome trace to the device's busy time, the
device time of named op ranges, and the breakdown.

An op range is a `record_function("bench.<op>")` opened by a wrapper on
the program's module attribute; a device operation belongs to the range
whose interval, on the launching thread, holds its launch (the runtime
call with the same correlation id). So a range's time is that of the
op's work, whatever kernels implement it.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class OpRanges:
    """Wrappers that put a program op in a named profiler range while the
    profiler runs, and add up the bytes its inputs and outputs need
    (`nbytes(args, out)` returns a device or host number)."""

    def __init__(self):
        self.active = False
        self.bytes: Dict[str, List] = defaultdict(list)

    def wrap(self, fn: Callable, name: str,
             nbytes: Optional[Callable] = None) -> Callable:
        def wrapped(*a, **k):
            if not self.active:
                return fn(*a, **k)
            with torch.profiler.record_function("bench." + name):
                out = fn(*a, **k)
            if nbytes is not None:
                self.bytes[name].append(nbytes(a, out))
            return out
        wrapped.__dict__.update(fn.__dict__)   # e.g. a launch counter
        return wrapped

    def total_bytes(self, name: str) -> float:
        return float(sum(float(b) for b in self.bytes[name]))


class Profile:
    """A profiler session over the sub-window, and its reduction."""

    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self.prof = None
        self.t0 = self.t1 = 0.0

    @staticmethod
    def warm(device) -> None:
        """Start and stop the profiler once, so that its first start
        (CUPTI's set-up) falls in set-up, not in the window."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(8, device=device).sum().item()

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def reduce(self) -> Dict:
        """{window_s, busy_s, range_s: {name: s}, device_ops, idle_gaps}."""
        path = os.path.join(self.tmpdir, "bench_trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        return reduce_events(events, self.window_s)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events: List[Dict], window_s: float) -> Dict:
    """Reduce Chrome trace events (timestamps in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    ranges = [e for e in xs if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("bench.")]
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in device])
    starts: Dict = defaultdict(list)
    for r in sorted(ranges, key=lambda r: r["ts"]):
        starts[r["tid"]].append(r)
    keys = {tid: [r["ts"] for r in rs] for tid, rs in starts.items()}
    range_s: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e["name"]] += e["dur"] * 1e-6
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None or launch["tid"] not in starts:
            continue
        i = bisect.bisect_right(keys[launch["tid"]], launch["ts"]) - 1
        if i >= 0:
            r = starts[launch["tid"]][i]
            if launch["ts"] <= r["ts"] + r["dur"]:
                range_s[r["name"][len("bench."):]] += e["dur"] * 1e-6
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    gaps = sorted(((start - end, end) for (_, end), (start, _)
                   in zip(busy, busy[1:])), reverse=True)[:10]
    idle = []
    for length, end in gaps:
        covering = [h for h in host if h["ts"] <= end < h["ts"] + h["dur"]]
        label = (min(covering, key=lambda h: h["dur"])["name"]
                 if covering else "host: no op")
        idle.append([label[:200], length * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "range_s": dict(range_s),
            "device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": idle}
