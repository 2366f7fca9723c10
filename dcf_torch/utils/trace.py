"""The port's tracer: named spans and counters recorded inside the program,
where the work happens.

    from dcf_torch.utils import trace

    with trace.span("preprocess", frame=frame_id):    # name, attributes
        with trace.span("preprocess.crop"):           # child span
            ...
    trace.count("nms.rounds")                          # host counter
    trace.count_device("fusion.pairs", t)              # sum of t, on t's device
    with trace.sync():                                 # host blocked on the device
        bool(live.any())                               # (a span; counts host_syncs)

It records while it is enabled (`enable()`, the CLIs' `--trace PATH`) and
while a `torch.profiler` session records in this process, so a profile
of any run carries the program's ranges and the records hold the
profiled window. Under any profiler session the program therefore does
the tracer's work too: its ranges, its clock reads and the device
counters' sums (about a dozen small kernels a served frame). Nothing
resets the records when a session starts: a process profiled twice
holds both sessions' records until `reset()`. Otherwise it is off:
`span` and `sync` return one shared no-op context and `count` /
`count_device` return at once, with no clock read, no `record_function`
and no device work.

A span records its name, start and end, its parent (the span open on
the same thread when it opened), its thread, on a thread other than the
main one the thread's CPU time inside it (which leaves out waits, for
the interpreter lock among them: how many of the loader's workers run at
once; the main thread's serving path does without the two clock reads,
which cost ~6 µs each on the card's host), and its attributes: the
request id where the caller knows one (the training step; the batch's
epoch and number and the example's dataset index in the loader; the
frame's `frame_id` in preprocessing). On the main thread, while a
profiler records, it also opens `record_function("dcf.<name>")`, so the
range sits in the profiler's trace on the trace's own clock (without a
profiler the range would cost ~15 µs and reach no one). `torch.profiler` keeps no range opened
on another thread (the loader's workers), so times are kept on the
monotonic clock with one (monotonic, Unix) anchor taken when the tracer
is made, enabled or reset: `snapshot` and `export_chrome` give them in
Unix microseconds, which is the clock of the profiler's Chrome trace once
its `baseTimeNanoseconds` is added.

`count_device` adds into a float64 accumulator on the tensor's device
without a host sync; the accumulators are read once, by `snapshot`.
Records are kept in memory, at most `capacity` of them; the buffer
counts those it had to drop. Per name, the count and the total duration
of every closed span are kept too, dropped ones included. All of it is
safe to call from several threads (the loader's workers).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable

import torch
# its `_is_profiler_enabled` is torch's process-wide flag: a Python global,
# true on every thread while a profiler session records
import torch.autograd.profiler as _PROFILER

DEFAULT_CAPACITY = 200_000


class _NoOp:
    """The shared context returned while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoOp()


class _Span:
    __slots__ = ("tracer", "name", "attrs", "id", "parent", "t0", "c0",
                 "rf")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(tr._ids)
        stack.append(self.id)
        main = threading.get_ident() == tr._main
        self.c0 = None if main else time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if main and _PROFILER._is_profiler_enabled:
            self.rf = torch.profiler.record_function("dcf." + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        cpu = None if self.c0 is None else time.thread_time_ns() - self.c0
        self.tracer._stack().pop()
        self.tracer._close(self, t1, cpu)
        return False


class Tracer:
    """Spans and counters of one process (the module's `TRACER`)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self.on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._main = threading.main_thread().ident
        self._ids = itertools.count(1)
        self.reset()

    def active(self) -> bool:
        return self.on or _PROFILER._is_profiler_enabled

    def enable(self, on: bool = True) -> None:
        """Record (or stop recording) outside profiler sessions too; the
        clock anchor is taken again."""
        self._anchor()
        self.on = on

    def reset(self) -> None:
        """Drop every record, counter and accumulator; a new anchor."""
        with self._lock:
            self._records = []
            self._dropped = 0
            self._totals: Dict[str, list] = {}
            self._counters: Dict[str, float] = {}
            self._device: Dict[str, torch.Tensor] = {}
        self._anchor()

    def _anchor(self) -> None:
        mono = time.perf_counter_ns()
        unix = time.time_ns()
        self._anchor_ns = (mono + time.perf_counter_ns()) // 2, unix

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs):
        """A span of `name` (a context manager); the shared no-op when
        off."""
        if not (self.on or _PROFILER._is_profiler_enabled):
            return NOOP
        return _Span(self, name, attrs)

    def sync(self, **attrs):
        """A span named `sync`: the host blocked on the device. Each adds
        one to the counter `host_syncs`."""
        if not (self.on or _PROFILER._is_profiler_enabled):
            return NOOP
        self.count("host_syncs")
        return _Span(self, "sync", attrs)

    def _close(self, sp: _Span, t1: int, cpu) -> None:
        dur = t1 - sp.t0
        rec = (sp.id, sp.parent, sp.name, sp.t0, dur, cpu,
               threading.get_ident(), threading.current_thread().name,
               sp.attrs)
        with self._lock:
            tot = self._totals.get(sp.name)
            if tot is None:
                self._totals[sp.name] = [1, dur]
            else:
                tot[0] += 1
                tot[1] += dur
            if len(self._records) < self.capacity:
                self._records.append(rec)
            else:
                self._dropped += 1

    def count(self, name: str, n: float = 1) -> None:
        if not (self.on or _PROFILER._is_profiler_enabled):
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def count_device(self, name: str, tensor: torch.Tensor) -> None:
        """Add `tensor`'s sum to the accumulator `name` on its device,
        with no host sync."""
        if not (self.on or _PROFILER._is_profiler_enabled):
            return
        s = tensor.detach().sum(dtype=torch.float64)
        with self._lock:
            acc = self._device.get(name)
            if acc is None:
                self._device[name] = s
            else:
                acc.add_(s)

    def totals(self) -> Dict[str, tuple]:
        """{name: (spans closed, their total ns)}, dropped ones included."""
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self._totals.items()}

    def mean_ms_since(self, names: Iterable[str], last: Dict) -> Dict:
        """Mean ms of each of `names` over its spans closed since the
        previous call with the same `last` (a dict this call updates),
        for each name that closed any."""
        now = self.totals()
        out = {}
        for name in names:
            n, ns = now.get(name, (0, 0))
            n0, ns0 = last.get(name, (0, 0))
            if n > n0:
                out[name] = (ns - ns0) / (n - n0) * 1e-6
            last[name] = (n, ns)
        return out

    def _unix_us(self, t_ns: int) -> float:
        mono, unix = self._anchor_ns
        return (t_ns - mono + unix) / 1e3

    def snapshot(self) -> Dict:
        """The records and counters: {"spans": [{"id", "parent", "name",
        "ts_us" (Unix), "dur_us", "cpu_us" (a worker thread's CPU time
        inside the span; None on the main thread), "tid", "thread",
        "attrs"}], "counters":
        {name: value} (the device accumulators read here, one sync),
        "dropped": records dropped, "totals": {name: [count, ms]}}."""
        with self._lock:
            records = list(self._records)
            counters = dict(self._counters)
            device = dict(self._device)
            dropped = self._dropped
            totals = {k: [v[0], v[1] * 1e-6] for k, v in self._totals.items()}
        counters.update({k: float(v) for k, v in device.items()})
        spans = [{"id": i, "parent": p, "name": n, "ts_us": self._unix_us(t0),
                  "dur_us": d / 1e3,
                  "cpu_us": None if c is None else c / 1e3, "tid": tid,
                  "thread": tname, "attrs": dict(a)}
                 for i, p, n, t0, d, c, tid, tname, a in records]
        return {"spans": spans, "counters": counters, "dropped": dropped,
                "totals": totals}

    def export_chrome(self, path: str) -> None:
        """Write the records as a Chrome trace (timestamps in Unix µs;
        counters as counter events at the last span's end)."""
        snap = self.snapshot()
        pid = os.getpid()
        events = []
        threads = {}
        for s in snap["spans"]:
            threads[s["tid"]] = s["thread"]
            events.append({"ph": "X", "cat": "dcf", "name": s["name"],
                           "ts": s["ts_us"], "dur": s["dur_us"],
                           "pid": pid, "tid": s["tid"],
                           "args": dict(s["attrs"], id=s["id"],
                                        parent=s["parent"],
                                        cpu_us=s["cpu_us"])})
        end = max((s["ts_us"] + s["dur_us"] for s in snap["spans"]),
                  default=time.time_ns() / 1e3)
        for name, value in sorted(snap["counters"].items()):
            events.append({"ph": "C", "name": name, "ts": end, "pid": pid,
                           "args": {name: value}})
        for tid, tname in threads.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"clock": "unix_us",
                                     "dropped": snap["dropped"]}}, f)


TRACER = Tracer()

# the process's tracer, called through the module
span = TRACER.span          # span(name, **attrs): a context manager
sync = TRACER.sync          # a "sync" span; each adds one to host_syncs
count = TRACER.count
count_device = TRACER.count_device
active = TRACER.active      # a caller that must compute what it counts asks
enable = TRACER.enable
reset = TRACER.reset
snapshot = TRACER.snapshot
export_chrome = TRACER.export_chrome
