"""The program's own spans and counters (`dcf_torch.utils.trace`), for the
per-layer metrics that read them.

The tracer records while `torch.profiler` records, so in a `--trace 1` run
its records are those of the profiled sub-window (the window's last
`profile_s` seconds), whole frames in serving. Only what the profiler
leaves as it is may be read from them: counters and the host
preprocessing's spans, which read the same in the sub-window as over the
whole window unprofiled; not the spans around launches, syncs or copies,
which the profiler slows. A program without the tracer, or a run that
recorded nothing, gives None to every reader."""

from __future__ import annotations

from typing import Dict, List, Optional


def records(ctx) -> Optional[Dict]:
    """The tracer's snapshot (taken once per run and kept on `ctx`), or
    None."""
    if not hasattr(ctx, "program_trace"):
        try:
            from dcf_torch.utils import trace
        except ImportError:
            snap = None
        else:
            snap = trace.snapshot()
            if not snap["spans"]:
                snap = None
        ctx.program_trace = snap
    return ctx.program_trace


def spans(snap: Dict, name: str) -> List[Dict]:
    return [s for s in snap["spans"] if s["name"] == name]


def ms_per(ctx, name: str, per: str) -> Optional[float]:
    """Host ms of the spans `name` per span `per` (a frame's
    `infer.forward`, a step's `loop.step`), or None."""
    snap = records(ctx)
    if snap is None:
        return None
    got, n = spans(snap, name), len(spans(snap, per))
    if not got or not n:
        return None
    return sum(s["dur_us"] for s in got) * 1e-3 / n


def count_per(ctx, counter: str, per: str) -> Optional[float]:
    """A counter over the number of spans `per`; 0 where the counter never
    moved; None without records."""
    snap = records(ctx)
    if snap is None:
        return None
    n = len(spans(snap, per))
    if not n:
        return None
    return snap["counters"].get(counter, 0.0) / n

