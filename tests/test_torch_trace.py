"""The port's tracer (`dcf_torch.utils.trace`), the spans and counters
the program records with it, and the benchmark's readers of them, on the
CPU."""

import json
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from dcf_torch.config import tiny_config
from dcf_torch.data.augment import GTDatabase
from dcf_torch.data.preprocess import frame_to_example, stack_examples
from dcf_torch.data.synthetic import SyntheticDataset
from dcf_torch.ops.knn import bin_points_dense
from dcf_torch.ops.nms import rotated_nms_parallel
from dcf_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture
def tracer_on():
    """The process's tracer, emptied and enabled; off and empty after."""
    trace.reset()
    trace.enable()
    try:
        yield trace.TRACER
    finally:
        trace.enable(False)
        trace.reset()


def _names(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


# --- off --------------------------------------------------------------


class _Forbidden:
    """Stands in for a module whose every attribute use is a failure."""

    def __init__(self, what):
        self.what = what

    def __getattr__(self, name):
        raise AssertionError(f"{self.what}.{name} used while off")


def test_off_is_the_shared_noop():
    trace.reset()
    assert not trace.active()
    assert trace.span("x", a=1) is trace.NOOP
    assert trace.sync() is trace.NOOP
    with trace.span("x"):
        trace.count("c", 3)
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}


def test_off_reads_no_clock_opens_no_range_launches_nothing(monkeypatch):
    """With the tracer off, the instrumented serving path reads no clock
    of the tracer's, opens no `record_function` and computes nothing for
    a device counter."""
    trace.reset()
    monkeypatch.setattr(trace, "time", _Forbidden("time"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        _Forbidden("record_function"))
    cfg = tiny_config()
    frame = SyntheticDataset(1, varied=True)[0]
    stack_examples([frame_to_example(frame, cfg)])
    iou = torch.eye(4)
    rotated_nms_parallel(iou, torch.arange(4.0), torch.ones(4, dtype=bool),
                         0.5, 4)

    class Probe:
        def detach(self):
            raise AssertionError("device counter computed while off")
    trace.count_device("x", Probe())
    trace.count("x")
    with trace.sync():
        pass
    assert trace.snapshot()["counters"] == {}


# --- on ---------------------------------------------------------------


def test_nesting_parents_and_attrs():
    tr = trace.Tracer()
    tr.enable()
    with tr.span("a", frame="000001") as a:
        with tr.span("a.b") as b:
            with tr.span("a.b.c"):
                pass
        with tr.span("a.d"):
            pass
    snap = tr.snapshot()
    by = {s["name"]: s for s in snap["spans"]}
    assert by["a"]["parent"] is None and by["a"]["id"] == a.id
    assert by["a.b"]["parent"] == a.id and by["a.b"]["id"] == b.id
    assert by["a.b.c"]["parent"] == b.id
    assert by["a.d"]["parent"] == a.id
    assert by["a"]["attrs"] == {"frame": "000001"}
    outer, inner = by["a"], by["a.b.c"]
    assert outer["ts_us"] <= inner["ts_us"]
    assert (inner["ts_us"] + inner["dur_us"]
            <= outer["ts_us"] + outer["dur_us"] + 1e-3)
    # the main thread's spans read no CPU clock
    assert all(s["thread"] == "MainThread" and s["cpu_us"] is None
               for s in snap["spans"])


def test_four_threads_at_once():
    tr = trace.Tracer()
    tr.enable()
    n = 300
    start = threading.Barrier(4)

    def work(k):
        start.wait(timeout=30)
        for i in range(n):
            with tr.span("outer", worker=k, i=i):
                with tr.span("inner"):
                    tr.count("c")
                    tr.count_device("d", torch.ones(2))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = tr.snapshot()
    assert snap["counters"] == {"c": 4 * n, "d": 8.0 * n}
    outer = {s["id"]: s for s in _names(snap, "outer")}
    inner = _names(snap, "inner")
    assert len(outer) == len(inner) == 4 * n
    assert len({s["id"] for s in snap["spans"]}) == 8 * n
    for s in inner:                      # parent: its own thread's outer
        assert outer[s["parent"]]["tid"] == s["tid"]
    assert len({s["tid"] for s in inner}) == 4
    assert all(0 <= s["cpu_us"] for s in inner)
    assert snap["totals"]["outer"][0] == 4 * n


def test_bounded_buffer_counts_drops():
    tr = trace.Tracer(capacity=5)
    tr.enable()
    for i in range(8):
        with tr.span("s", i=i):
            pass
    snap = tr.snapshot()
    assert [s["attrs"]["i"] for s in snap["spans"]] == [0, 1, 2, 3, 4]
    assert snap["dropped"] == 3
    assert snap["totals"]["s"][0] == 8
    tr.reset()
    assert tr.snapshot()["dropped"] == 0 and tr.snapshot()["spans"] == []


def test_mean_ms_since():
    tr = trace.Tracer()
    tr.enable()
    last = {}
    for _ in range(3):
        with tr.span("a"):
            pass
    first = tr.mean_ms_since(("a", "b"), last)
    assert set(first) == {"a"} and first["a"] >= 0
    assert tr.mean_ms_since(("a", "b"), last) == {}
    with tr.span("b"):
        pass
    assert set(tr.mean_ms_since(("a", "b"), last)) == {"b"}


def test_export_chrome(tmp_path):
    tr = trace.Tracer()
    tr.enable()
    with tr.span("a", step=3):
        tr.count("c", 2)
    path = str(tmp_path / "t.json")
    tr.export_chrome(path)
    with open(path) as f:
        data = json.load(f)
    xs = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["a"]
    assert xs[0]["args"]["step"] == 3
    snap = tr.snapshot()
    assert xs[0]["ts"] == pytest.approx(snap["spans"][0]["ts_us"])
    assert [e["args"] for e in data["traceEvents"] if e["ph"] == "C"] == \
        [{"c": 2}]
    assert data["otherData"] == {"clock": "unix_us", "dropped": 0}


def test_main_thread_span_sits_on_the_profilers_clock(tmp_path):
    """Under a profiler (the tracer not enabled: it follows the profiler)
    a main-thread span is also the profiler's `dcf.<name>` range, and
    lands within 1 ms of it once the trace's base time is added; a span
    on another thread is recorded, with no range."""
    trace.reset()

    def other():
        with trace.span("worker"):
            pass
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for i in range(3):
                with trace.span("probe", i=i):
                    torch.ones(1000).sum()
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
        assert not trace.active()
        path = str(tmp_path / "prof.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
        snap = trace.snapshot()
    finally:
        trace.reset()
    base = data["baseTimeNanoseconds"] / 1e3
    ranges = [e for e in data["traceEvents"]
              if e.get("name") == "dcf.probe" and e.get("ph") == "X"]
    spans = _names(snap, "probe")
    assert len(ranges) == len(spans) == 3
    for r, s in zip(sorted(ranges, key=lambda e: e["ts"]), spans):
        assert abs(r["ts"] + base - s["ts_us"]) < 1000
        assert abs(r["ts"] + r["dur"] + base
                   - (s["ts_us"] + s["dur_us"])) < 1000
    assert len(_names(snap, "worker")) == 1
    assert not any(e.get("name") == "dcf.worker"
                   for e in data["traceEvents"])


# --- the program's counters -------------------------------------------


def _greedy_rounds(iou, scores, valid, thr):
    """Rounds of `rotated_nms_parallel`'s loop and the boxes it keeps, in
    plain Python."""
    K = len(scores)
    order = sorted(range(K), key=lambda i: (-scores[i], i))
    rank = {i: r for r, i in enumerate(order)}
    live = {i for i in range(K) if valid[i]}
    keep, rounds = set(), 0
    while live:
        rounds += 1
        top = {i for i in live if not any(
            iou[i][j] > thr and rank[j] < rank[i] for j in live)}
        keep |= top
        live -= top | {i for i in live
                       if any(iou[i][j] > thr for j in top)}
    return rounds, keep


@pytest.mark.parametrize("chain", [1, 3, 6])
def test_nms_rounds_and_host_syncs(tracer_on, chain):
    """A chain of valid boxes each overlapping the next, in descending
    score, then invalid ones: every round keeps one box and suppresses
    the next."""
    K = 12
    iou = np.zeros((K, K), np.float32)
    for i in range(2 * chain - 1):
        iou[i, i + 1] = iou[i + 1, i] = 0.8
    np.fill_diagonal(iou, 1.0)
    scores = np.linspace(1.0, 0.1, K).astype(np.float32)
    valid = np.arange(K) < 2 * chain
    idx, keep = rotated_nms_parallel(
        torch.from_numpy(iou), torch.from_numpy(scores),
        torch.from_numpy(valid), 0.5, K)
    rounds, kept = _greedy_rounds(iou, scores, valid, 0.5)
    assert rounds == chain and kept == set(range(0, 2 * chain, 2))
    assert set(idx[keep].tolist()) == kept
    snap = trace.snapshot()
    assert snap["counters"]["nms.rounds"] == rounds
    assert snap["counters"]["host_syncs"] == rounds + 1
    assert len(_names(snap, "sync")) == rounds + 1


def test_fusion_bin_dropped(tracer_on):
    """One bin filled past `bin_capacity`, others under it, and points
    invalid or off the grid: the device counters against numpy."""
    rng = np.random.default_rng(5)
    cap, H, W = 4, 6, 5
    xy = [(2.5, 1.5)] * 11 + [(0.5, 0.5)] * 3 + [(5.5, 4.5)] * 5
    xy += [(-1.0, 2.0), (7.0, 1.0)]                  # off the grid
    pts = np.asarray(xy, np.float32)
    pts = np.concatenate([pts + rng.uniform(-0.4, 0.4, pts.shape)
                          .astype(np.float32),
                          rng.normal(size=(len(pts), 2)).astype(np.float32)],
                         axis=1)
    mask = np.ones(len(pts), bool)
    mask[[3, 15]] = False
    bin_points_dense(torch.from_numpy(pts)[None],
                     torch.from_numpy(mask)[None], (0.0, 0.0), 1.0,
                     (H, W), cap)
    ix = np.floor(pts[:, 0]).astype(int)
    iy = np.floor(pts[:, 1]).astype(int)
    ok = mask & (ix >= 0) & (ix < H) & (iy >= 0) & (iy < W)
    per_cell = np.bincount(ix[ok] * W + iy[ok], minlength=H * W)
    counters = trace.snapshot()["counters"]
    assert counters["fusion.bin_eligible"] == ok.sum() == 17
    assert counters["fusion.bin_dropped"] == \
        np.maximum(per_cell - cap, 0).sum() == 6


def test_frame_spans_and_fusion_pairs(tracer_on):
    """A served tiny frame: `preprocess` and its children under it with
    the frame's id, the forward's spans under `infer.forward`, and a
    count of fusion pairs."""
    from dcf_torch.eval.inference import make_inference_fn, to_host
    from dcf_torch.params import init_params
    cfg = tiny_config()
    frame = SyntheticDataset(1, varied=True)[0]
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    infer = make_inference_fn(cfg, model, device="cpu")
    to_host(infer(stack_examples([frame_to_example(frame, cfg)])))
    snap = trace.snapshot()
    (pre,) = _names(snap, "preprocess")
    assert pre["attrs"] == {"frame": frame.frame_id}
    for child in ("crop", "sort", "image", "fusion_arrays"):
        (s,) = _names(snap, "preprocess." + child)
        assert s["parent"] == pre["id"]
    (fwd,) = _names(snap, "infer.forward")
    stages = [s["name"] for s in snap["spans"] if s["parent"] == fwd["id"]]
    assert stages[0] == "forward.raster" and stages[-1] == "forward.head"
    assert sum(n.startswith("forward.fusion_s") for n in stages) == \
        len(cfg.backbone.fusion_strides)
    assert snap["counters"]["fusion.pairs"] > 0
    assert snap["counters"]["fusion.bin_eligible"] >= \
        snap["counters"]["fusion.bin_dropped"]


def test_train_records_each_step_and_example(tracer_on, tmp_path):
    from dcf_torch.train.loop import train
    cfg = tiny_config()
    dataset = SyntheticDataset(4, varied=True)
    gt_db = GTDatabase.build([dataset[i] for i in range(len(dataset))])
    train(cfg, dataset, str(tmp_path), device="cpu", gt_db=gt_db,
          num_steps=3)
    snap = trace.snapshot()
    for name in ("loop.h2d", "loop.step"):
        assert sorted(s["attrs"]["step"] for s in _names(snap, name)) == \
            [1, 2, 3]
    assert sorted(s["attrs"]["step"]
                  for s in _names(snap, "loop.wait_batch")) == [0, 1, 2, 3]
    examples = _names(snap, "loader.example")
    keys = [(s["attrs"]["epoch"], s["attrs"]["index"]) for s in examples]
    assert len(set(keys)) == len(keys)
    assert len(examples) == \
        cfg.train.batch_size * len(_names(snap, "preprocess.stack"))
    assert len(_names(snap, "augment")) == len(examples)
    for s in examples:
        assert s["thread"] != "MainThread"
    with open(tmp_path / "metrics.jsonl") as f:
        line = json.loads(f.readlines()[-1])
    for name in ("loop.wait_batch", "loop.h2d", "augment", "loader.example"):
        assert line[name + "_ms"] >= 0


def test_cli_demo_trace(tmp_path):
    from dcf_torch.cli import demo
    path = str(tmp_path / "demo.json")
    try:
        demo.main(["--config", "tiny", "--device", "cpu", "--trace", path])
    finally:
        trace.enable(False)
        trace.reset()
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"preprocess", "infer.forward", "to_host", "nms.rounds",
            "host_syncs"} <= names


# --- the benchmark's readers ------------------------------------------


def _span(name, dur_ms):
    return {"id": 0, "parent": None, "name": name, "ts_us": 0.0,
            "dur_us": dur_ms * 1e3, "cpu_us": None, "tid": 1,
            "thread": "t", "attrs": {}}


SERVE = {"spans": [_span("infer.forward", 4.0), _span("infer.forward", 6.0),
                   _span("preprocess.crop", 1.0), _span("preprocess.crop", 2.0),
                   _span("preprocess.image", 3.0),
                   _span("preprocess.image", 5.0),
                   _span("infer.h2d", 0.5), _span("sync", 1.0)],
         "counters": {"nms.rounds": 7.0, "fusion.bin_eligible": 400.0,
                      "fusion.bin_dropped": 30.0},
         "dropped": 0, "totals": {}}

READINGS = [
    ("crop_ms.serve", 1.5),
    ("image_prep_ms.serve", 4.0),
    ("nms_rounds.serve", 3.5),
    ("fusion_bin_drop.serve", 7.5),
]
# the cells each reader finds its span or counter in: the host crop and
# NMS serve both families, the image and the fusion bins only ContFuse
READ_IN = {
    "crop_ms.serve": ["contfuse-ms.serve-b1", "pointpillars-car.serve-b1"],
    "image_prep_ms.serve": ["contfuse-ms.serve-b1"],
    "nms_rounds.serve": ["contfuse-ms.serve-b1", "pointpillars-car.serve-b1"],
    "fusion_bin_drop.serve": ["contfuse-ms.serve-b1"],
}


def _reader(name):
    from perfbench import registry
    return registry.metric_reader(name)


def _ctx(snap=None):
    ctx = types.SimpleNamespace()
    if snap is not None:
        ctx.program_trace = snap
    return ctx


@pytest.mark.parametrize("name, want", READINGS)
def test_reader_reads_a_snapshot(name, want):
    assert _reader(name).read(_ctx(SERVE)) == pytest.approx(want)


@pytest.mark.parametrize("name", [r[0] for r in READINGS])
def test_reader_none_without_records(name, monkeypatch):
    trace.reset()
    reader = _reader(name)
    assert reader.read(_ctx()) is None
    # a program without the tracer (a parent commit)
    import dcf_torch.utils
    monkeypatch.delattr(dcf_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "dcf_torch.utils.trace", None)
    assert reader.read(_ctx()) is None


def test_readers_are_in_the_benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, _ in READINGS:
        m = per_layer[name]
        reader = _reader(name)
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == \
            (m["layer"], m["unit"], m["moves"])
        assert m["workloads"] == READ_IN[name]
