"""Spans recorded from the benchmark's own files, around calls into the
program's layers: CUDA events on module entry and exit (module hooks) and
around wrapped module attributes, after `dcf_torch/tools/
profile_serving.py`'s `_span_hooks` and `_timed` (commit fab139f); host
clock spans for host work. Events are kept in memory and read once the
window has closed."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch


class Spans:
    """Per name, a list of [start, end] CUDA events (device spans) or of
    host seconds (host spans)."""

    def __init__(self, device_spans: bool):
        self.device_spans = device_spans
        self.events: Dict[str, List] = defaultdict(list)
        self.host: Dict[str, List[float]] = defaultdict(list)
        self._handles = []

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def module(self, module: torch.nn.Module, name: str) -> None:
        """A device span from `module`'s entry to its exit, per call."""
        if not self.device_spans:
            return

        def pre(_m, _a):
            self.events[name].append([self._event(), None])

        def post(_m, _a, _o):
            self.events[name][-1][1] = self._event()
        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def wrap(self, fn: Callable, name: str) -> Callable:
        """`fn` with a device span around each call."""
        if not self.device_spans:
            return fn

        def wrapped(*a, **k):
            start = self._event()
            out = fn(*a, **k)
            self.events[name].append([start, self._event()])
            return out
        return wrapped

    def add_host(self, name: str, seconds: float) -> None:
        self.host[name].append(seconds)

    def device_ms(self) -> Dict[str, List[float]]:
        """Milliseconds of every device span; synchronizes first."""
        if self.events:
            torch.cuda.synchronize()
        return {n: [s.elapsed_time(e) for s, e in evs]
                for n, evs in self.events.items()}

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def host_clock() -> float:
    return time.perf_counter()
