"""CUDA-graph replay of a forward cut into segments, with eager work between
them.

A forward that launches a few thousand small kernels a call spends its
time on the host issuing them. Captured in CUDA graphs, each run of
launches is issued by one `replay`. The forward is written once, against
a runner of segments (`seg`), and keeps whatever must stay eager between
the segments (a hand-written kernel, the tracer's device counters, module
calls whose hooks must fire once a call):

    def _forward(self, batch, seg):
        batch = seg.stage(batch)                  # the inputs, put in place
        x = seg.run("stem", self._stem, batch["x"])
        y = custom_kernel(x)                      # eager, between segments
        return seg.run("head", self._head, x, y)

`EAGER` runs each segment as a plain call: the forward as written, for
CPU tensors, autograd and every mode that is not replayed. A
`GraphCache` keeps one `Tape` per input signature (each input's name,
shape, dtype and device): the signature's first call runs eagerly, its
second captures each segment in turn (warmed up on a side stream,
captured into the tape's one memory pool, then replayed at once, so the
eager work after it reads real values), and later calls replay them.

Replay semantics: a segment's outputs are the same tensors on every
replay, rewritten in place. The capture reads only tensors the tape owns:
the staged inputs and the segments' outputs (and views of them) as they
are, any other input (an eager op's output) through a copy it makes. On
replay an input that lies where the capture read it is used as it is;
any other (a new call's tensor, an eager op's output) is copied there
first. So the caller's tensors are never written; and the cache clones
what the forward returns, so a caller may keep it while later calls are
served. The graphs read the parameters where they lay at capture:
updates in place reach them, and a module that moves or replaces its
parameters clears its cache.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from dcf_torch.utils import trace


def _leaves(obj) -> List[torch.Tensor]:
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _leaves(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _leaves(o)]
    return []


def _map(f: Callable, obj):
    """A copy of a nest of tuples, lists and dicts with `f` applied to
    every tensor."""
    if isinstance(obj, torch.Tensor):
        return f(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(f, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _map(f, v) for k, v in obj.items()}
    return obj


def _clone(obj):
    return _map(torch.Tensor.clone, obj)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _place(static: torch.Tensor, t: torch.Tensor) -> None:
    """Copy `t` into `static`, where the capture read it, unless it lies
    there already."""
    if t.shape != static.shape or t.dtype != static.dtype:
        raise ValueError(f"graph replay: input {t.dtype} {tuple(t.shape)} "
                         f"where the capture read {static.dtype} "
                         f"{tuple(static.shape)}")
    if t.data_ptr() != static.data_ptr() or t.stride() != static.stride():
        static.copy_(t)


def signature(inputs: Dict[str, torch.Tensor]) -> tuple:
    """The key of a call's graphs: each input's name, shape, dtype and
    device."""
    return tuple((k, tuple(v.shape), v.dtype, v.device)
                 for k, v in sorted(inputs.items()))


class Eager:
    """Runs every segment as a plain call."""

    def stage(self, inputs: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        return inputs

    def run(self, name: str, fn: Callable, *args):
        return fn(*args)


EAGER = Eager()


class CudaGraphs:
    """Captures a tape's segments on one side stream into one memory pool,
    so that each static output can be the next segment's static input."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream()

    def capture(self, fn: Callable, args: tuple):
        """(graph, outputs): `fn(*args)` warmed up on the side stream,
        captured, and replayed once on the current stream."""
        side, main = self.stream, torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn(*args)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=side,
                              capture_error_mode="thread_local"):
            out = fn(*args)
        graph.replay()
        return graph, out

    @staticmethod
    def replay(graph) -> None:
        graph.replay()


class Tape:
    """The segments of one input signature, captured in the order the
    forward reaches them and replayed in it."""

    def __init__(self, backend):
        self.backend = backend
        self.segments: List[tuple] = []   # (name, graph, inputs, outputs)
        self.inputs: Optional[Dict[str, torch.Tensor]] = None
        self.owned = set()                # storages of the tape's tensors
        self.capturing = False
        self.next = 0

    def capture(self, forward: Callable, inputs: Dict[str, torch.Tensor]):
        self.capturing = True
        try:
            out = forward(inputs, self)
        finally:
            self.capturing = False
        return _clone(out)

    def replay(self, forward: Callable, inputs: Dict[str, torch.Tensor]):
        self.next = 0
        out = forward(inputs, self)
        if self.next != len(self.segments):
            raise RuntimeError(f"graph replay reached {self.next} of the "
                               f"{len(self.segments)} captured segments")
        return _clone(out)

    def stage(self, inputs: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        if self.capturing:
            self.inputs = _map(self._own, inputs)
            return self.inputs
        for k, t in inputs.items():
            _place(self.inputs[k], t)
        return self.inputs

    def _own(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of `t` that the tape owns."""
        t = t.clone()
        self.owned.add(_storage(t))
        return t

    def run(self, name: str, fn: Callable, *args):
        if self.capturing:
            args = _map(lambda t: t if _storage(t) in self.owned
                        else self._own(t), args)
            graph, out = self.backend.capture(fn, args)
            self.owned.update(_storage(t) for t in _leaves(out))
            self.segments.append((name, graph, _leaves(args), out))
            return out
        if self.next >= len(self.segments) or \
                self.segments[self.next][0] != name:
            raise RuntimeError(f"graph replay reached segment {name!r} where "
                               f"the capture had another")
        _, graph, static, out = self.segments[self.next]
        self.next += 1
        for s, t in zip(static, _leaves(args)):
            _place(s, t)
        self.backend.replay(graph)
        return out


class GraphCache:
    """A forward's tapes by input signature. Counts the tracer's
    `graph.captures` and `graph.forwards` (calls served by replay)."""

    def __init__(self, backend: Callable = CudaGraphs):
        self.backend = backend
        self.tapes: Dict[tuple, Optional[Tape]] = {}

    def __call__(self, forward: Callable, inputs: Dict[str, torch.Tensor]):
        """`forward(inputs, seg)`: eager on the signature's first call,
        captured on its second, replayed after; what it returns is cloned
        whenever graphs ran it."""
        key = signature(inputs)
        if key not in self.tapes:
            self.tapes[key] = None
            return forward(inputs, EAGER)
        tape = self.tapes[key]
        if tape is None:
            tape = Tape(self.backend())
            out = tape.capture(forward, inputs)
            self.tapes[key] = tape
            trace.count("graph.captures")
            return out
        out = tape.replay(forward, inputs)
        trace.count("graph.forwards")
        return out

    def clear(self) -> None:
        self.tapes.clear()

    def __deepcopy__(self, memo) -> "GraphCache":
        return GraphCache(self.backend)
