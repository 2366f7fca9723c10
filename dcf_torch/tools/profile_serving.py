"""Where the time of a served frame goes on the card.

    python -m dcf_torch.tools.profile_serving [--frames 8]

Serves synthetic frames at batch 1 through the entry point
`make_inference_fn` (`multi_scale_config()` at full width, bf16, seeded
random weights) and reports, on the card:
  - host p50 / p95 ms per frame, with no profiler and no span events;
  - per-stage device spans (CUDA events around the raster, the image
    backbone, each BEV stage, each fusion layer, FPN + head, decode +
    NMS), mean ms per frame;
  - the top kernels by device time (torch.profiler) and the device's
    busy share: the kernels' device time over the unprofiled wall time
    of the same frames (the profiler slows the host, so its own window
    would understate the share).
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import numpy as np
import torch

from dcf_torch.config import multi_scale_config
from dcf_torch.data.preprocess import frame_to_example, stack_examples
from dcf_torch.data.synthetic import make_varied_frame
from dcf_torch.eval import inference
from dcf_torch.params import init_params


def _span_hooks(model, spans):
    """CUDA events on entry/exit of every top-level child module; the
    span from the detector's entry to its first child's is the raster."""
    def entry(_m, _a):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans["raster"].append([ev, None])
    model.register_forward_pre_hook(entry)

    def pre(name):
        def hook(_m, _a):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if spans["raster"][-1][1] is None:
                spans["raster"][-1][1] = ev
            spans[name].append([ev, None])
        return hook

    def post(name):
        def hook(_m, _a, _o):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name][-1][1] = ev
        return hook
    for name, child in model.named_children():
        child.register_forward_pre_hook(pre(name))
        child.register_forward_hook(post(name))


def _timed(fn, name, spans):
    def wrapped(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **k)
        end.record()
        spans[name].append([start, end])
        return out
    return wrapped


def _run(infer, batches):
    """Host ms per frame, each frame ended by a device sync."""
    host = []
    for batch in batches:
        t = time.perf_counter()
        infer(batch)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    return host


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA device")
    cfg = multi_scale_config()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    infer = inference.make_inference_fn(cfg, model, device="cuda")
    batches = [stack_examples([frame_to_example(make_varied_frame(seed=s),
                                                cfg)])
               for s in range(args.frames + 1)]
    frames = batches[:-1]

    infer(batches[-1])                                   # warm-up
    torch.cuda.synchronize()
    host = _run(infer, frames)                           # unprofiled
    n = len(host)
    print(f"card: {torch.cuda.get_device_name(0)}; {n} frames; host p50 "
          f"{np.percentile(host, 50):.3f} ms, p95 "
          f"{np.percentile(host, 95):.3f} ms (no profiler)")

    spans = defaultdict(list)
    _span_hooks(model, spans)
    inference.decode_and_nms = _timed(inference.decode_and_nms,
                                      "decode_nms", spans)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = _run(infer, frames)
    print("device spans, mean ms per frame (CUDA events):")
    for name, evs in spans.items():
        ms = sum(s.elapsed_time(e) for s, e in evs) / n
        print(f"  {name:24s} {ms:9.3f}")

    kernels = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] += evt.device_time_total / 1e3   # ms
    busy = sum(kernels.values())
    print(f"device busy {busy / n:.3f} ms per frame of {sum(host) / n:.3f} "
          f"ms wall without the profiler: busy share "
          f"{busy / sum(host):.3f} (the profiled frames took "
          f"{sum(profiled) / n:.3f} ms each)")
    print("top kernels by device time, ms per frame:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms / n:9.4f}  {name[:110]}")


if __name__ == "__main__":
    main()
