"""Serving cells: one closed-loop stream of raw frames through a model
family's serving path (`families/<family>.py`), and the comparison with
its plain reference.

A frame's latency runs from handing over the raw frame (sweep, image,
calibration in memory) to its detections on the host: the family's
`prepare` (host preprocessing) and `infer` (the forward, decode and NMS,
and the copy of the detections to the host). The next frame is sent when
the last detections are back.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from perfbench import registry
from perfbench import spans as spans_mod
from perfbench import trace as trace_mod
from perfbench import traffic_gen


MIX_KEYS = ("mode", "batch", "pool", "generator", "warmup_frames",
            "check_frames", "profile_s")


def check_mix(t: Dict) -> None:
    """A serving mix has just the keys `run` reads, and batch 1: one
    closed-loop stream at B=1 is all that `run` serves."""
    registry.check_keys(t, MIX_KEYS, "serve mix")
    if t["batch"] != 1:
        raise ValueError(f"serve mix: batch {t['batch']}; run serves one "
                         f"closed-loop stream at batch 1")


def roi_points(frame, vox) -> int:
    p = frame.points
    return int(((p[:, 0] >= vox.x_min) & (p[:, 0] < vox.x_max)
                & (p[:, 1] >= vox.y_min) & (p[:, 1] < vox.y_max)
                & (p[:, 2] >= vox.z_min) & (p[:, 2] < vox.z_max)).sum())


def check_set(pool_ref, vox, n: int, seed: int) -> List[int]:
    """Pool slots whose served frames are compared: drawn from the seed,
    with the frame of the most points in the ROI `vox` among them."""
    largest = max(range(len(pool_ref)),
                  key=lambda j: roi_points(pool_ref[j], vox))
    rng = np.random.default_rng([11, seed])
    others = [j for j in rng.permutation(len(pool_ref)) if j != largest]
    return sorted([largest] + [int(j) for j in others[:n - 1]])


def run(env) -> Dict:
    """Set up, warm up, serve for `env.seconds`, and return what the run
    measured and captured (program state freed)."""
    t = env.traffic
    check_mix(t)
    pool_ref = traffic_gen.make_pool(t["generator"], t["pool"], env.seed)
    prog = env.family.Serving(env, pool_ref)
    pool = prog.frames
    checked = set(check_set(pool_ref, prog.roi, t["check_frames"], env.seed))
    sp = spans_mod.Spans(device_spans=env.trace)
    ranges = trace_mod.OpRanges()
    captured: Dict[int, Dict] = {}
    sync = (torch.cuda.synchronize if env.device.type == "cuda"
            else (lambda: None))

    def serve(frame):
        t0 = spans_mod.host_clock()
        ex, batch = prog.prepare(frame)
        t1 = spans_mod.host_clock()
        dets = prog.infer(batch)
        return ex, dets, t1 - t0, spans_mod.host_clock() - t0

    try:
        if env.trace:
            prog.trace(sp, ranges)
            trace_mod.Profile.warm(env.device)
        for i in range(t["warmup_frames"]):
            serve(pool[i % len(pool)])
        sync()
        sp.events.clear()
        sp.host.clear()
        prof = trace_mod.Profile(env.tmpdir) if env.trace else None
        latency = []
        t_start = spans_mod.host_clock()
        env.mark_window_start()
        i = 0
        while True:
            j = i % len(pool)
            prog.capture = j in checked and j not in captured
            ex, dets, prep_s, frame_s = serve(pool[j])
            if prog.capture:
                captured[j] = {"example": ex, "maps": prog.take_maps(),
                               "dets": dets}
            latency.append(frame_s)
            sp.add_host("preprocess", prep_s)
            now = spans_mod.host_clock()
            i += 1
            if now - t_start >= env.seconds:
                break
            if prof is not None and not ranges.active and \
                    now - t_start >= env.seconds - t["profile_s"]:
                prof.start()
                ranges.active = True
                n_before = i
        window_s = spans_mod.host_clock() - t_start
        profile = None
        if prof is not None and ranges.active:
            prof.stop()
            ranges.active = False
            profile = prof.reduce()
            profile["frames"] = i - n_before
        device_ms = sp.device_ms() if env.trace else {}
        for j in sorted(checked - set(captured)):
            # a window shorter than one pass over the pool (CPU tests):
            # the checked frames it missed are served after it, untimed
            prog.capture = True
            ex, dets, _, _ = serve(pool[j])
            captured[j] = {"example": ex, "maps": prog.take_maps(),
                           "dets": dets}
        memory_peak = (torch.cuda.max_memory_allocated(env.device)
                       if env.device.type == "cuda" else 0)
    finally:
        prog.close()
        sp.close()
    weights, ref_cfg = prog.weights, prog.ref_cfg
    del prog
    gc.collect()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    lat_ms = np.asarray(latency) * 1e3
    e2e = {"frame_ms_p50": float(np.percentile(lat_ms, 50)),
           "frame_ms_p95": float(np.percentile(lat_ms, 95))}
    return {"e2e": e2e, "attempted": i, "failed": 0,
            "window_s": window_s, "memory_peak": memory_peak,
            "spans": {"device_ms": device_ms, "host_s": dict(sp.host),
                      "frames": i},
            "profile": profile, "ranges": ranges,
            "captured": captured, "pool_ref": pool_ref, "weights": weights,
            "ref_cfg": ref_cfg}
