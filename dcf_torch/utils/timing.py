"""Device timings on the card with CUDA events: `graph_ms` takes the
host's cost per launch out of the reading, `cuda_ms` keeps it in."""

from __future__ import annotations

import torch


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` back-to-back calls after 2 warm-up
    calls, CUDA events around them: the host's cost per call is in the
    reading wherever it exceeds the device's."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device ms per call of `fn`, the host out of the reading:
    `reps` calls captured in one CUDA graph, replayed `replays` times
    between CUDA events after a warm-up call and a warm-up replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)
