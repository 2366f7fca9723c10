"""Training cells: a model family's training loop (`families/<family>.py`)
over a pool of generated frames, and the comparison of its first steps
with the family's plain reference.

The window opens at the first pass boundary over the pool after
`warmup_steps` steps: the loader starts each pass from an empty queue, so
no batch made during set-up is counted in the window; the step at which it
opened is recorded. It closes at the first step that ends `--seconds`
after the open. Both ends are at a device sync. Set-up is the loop's own
start and the steps before the window.
"""

from __future__ import annotations

import gc
from typing import Dict

import torch

from perfbench import registry
from perfbench import spans as spans_mod
from perfbench import trace as trace_mod
from perfbench import traffic_gen


MIX_KEYS = ("mode", "batch", "pool", "generator", "warmup_steps",
            "check_steps", "profile_s")


def check_mix(t: Dict) -> None:
    """A training mix has just the keys `run` reads."""
    registry.check_keys(t, MIX_KEYS, "train mix")


class _WindowClosed(Exception):
    pass


def run(env) -> Dict:
    t = env.traffic
    check_mix(t)
    per_pass = t["pool"] // t["batch"]
    pool_ref = traffic_gen.make_pool(t["generator"], t["pool"], env.seed)
    prog = env.family.Training(env, pool_ref)
    sp = spans_mod.Spans(device_spans=env.trace)
    ranges = trace_mod.OpRanges()
    prof = trace_mod.Profile(env.tmpdir) if env.trace else None
    rec = {"step": 0, "open": False}
    sync = (torch.cuda.synchronize if env.device.type == "cuda"
            else (lambda: None))

    def wrap_step(step):
        if env.fault is not None:
            step = env.fault(step)
        return sp.wrap(step, "step")

    def wrap_batches(stream):
        try:
            while True:
                t0 = spans_mod.host_clock()
                batch = next(stream)
                if rec["open"]:
                    sp.add_host("loader_wait", spans_mod.host_clock() - t0)
                yield batch
        finally:
            stream.close()

    def on_step(step):
        rec["step"] = step
        if not rec["open"]:
            if step >= t["warmup_steps"] and step % per_pass == 0:
                sync()
                sp.events.clear()
                rec["t_start"] = spans_mod.host_clock()
                rec["step_start"] = step
                rec["open"] = True
                env.mark_window_start()
            return
        elapsed = spans_mod.host_clock() - rec["t_start"]
        if elapsed >= env.seconds:
            sync()
            rec["t_end"] = spans_mod.host_clock()
            rec["steps"] = step - rec["step_start"]
            rec["open"] = False
            raise _WindowClosed
        if prof is not None and not ranges.active and \
                elapsed >= env.seconds - t["profile_s"]:
            prof.start()
            ranges.active = True
            rec["prof_step"] = step

    profile = None
    try:
        if env.trace:
            prog.trace(ranges)
            trace_mod.Profile.warm(env.device)
        try:
            prog.run(on_step, wrap_batches, wrap_step)
        except _WindowClosed:
            pass
        if prof is not None and ranges.active:
            prof.stop()
            ranges.active = False
            profile = prof.reduce()
            profile["frames"] = (rec["step"] - rec["prof_step"]) * t["batch"]
        device_ms = sp.device_ms() if env.trace else {}
        memory_peak = (torch.cuda.max_memory_allocated(env.device)
                       if env.device.type == "cuda" else 0)
    finally:
        prog.close()
        sp.close()
    out = prog.outputs()
    del prog
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    window_s = rec["t_end"] - rec["t_start"]
    frames = rec["steps"] * t["batch"]
    out.update({"e2e": {"train_frames_per_s": frames / window_s},
                "attempted": rec["steps"], "failed": 0, "window_s": window_s,
                "window_steps": [rec["step_start"], rec["step"]],
                "memory_peak": memory_peak,
                "spans": {"device_ms": device_ms, "host_s": dict(sp.host),
                          "steps": rec["steps"], "frames": frames},
                "profile": profile, "ranges": ranges})
    return out
