"""The graphed serving forward (`dcf_torch.utils.graphs`) on the CPU.

CUDA graphs run only on the card (tests/test_torch_cuda.py holds the
replay there to the eager forward bit for bit). Here a stand-in backend,
`Rerun`, plays the graph: its capture runs the segment, its replay runs
the segment again on the tensors the capture read and writes the results
into the tensors the capture returned, which is what a replay does. So
the segmentation, the signature cache, the copies into the captured
inputs, the clones of what the forward returns and the counters are
tested here on `tiny_config`; which calls take the eager path is tested
on the rule itself.
"""

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dcf_torch.config import tiny_config
from dcf_torch.data.preprocess import frame_to_example, stack_examples
from dcf_torch.data.synthetic import make_varied_frame
from dcf_torch.eval.inference import batch_to_device
from dcf_torch.models.detector import ContFuseDetector
from dcf_torch.models.layers import ConvNorm
from dcf_torch.ops import knn
from dcf_torch.params import init_params
from dcf_torch.utils import graphs, trace

torch.set_num_threads(1)


class Rerun:
    """A CUDA graph's stand-in on the CPU."""

    def capture(self, fn, args):
        out = fn(*args)
        return (fn, args, out), out

    @staticmethod
    def replay(graph):
        fn, args, out = graph
        for s, t in zip(graphs._leaves(out), graphs._leaves(fn(*args))):
            s.copy_(t)


def _cfg(with_fusion=True):
    cfg = tiny_config(with_fusion)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype="float32"))


@pytest.fixture(scope="module")
def frames():
    """tiny_config in float32, seeded weights, and six frames at B=1 as
    host arrays."""
    cfg = _cfg()
    model = init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu").eval()
    return model, [stack_examples([frame_to_example(
        make_varied_frame(seed=s), cfg)]) for s in range(6)]


@pytest.fixture
def served(frames):
    """The model and the six frames as tensors of this test's own (on
    the CPU `batch_to_device` shares the host arrays' memory)."""
    model, host = frames
    return model, [{k: v.clone() for k, v in batch_to_device(
        b, "cpu").items()} for b in host]


def _inputs(model, batch):
    return {k: batch[k] for k in model.inputs}


@pytest.fixture
def tracer():
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.enable(False)
        trace.reset()


def _counters():
    return trace.snapshot()["counters"]


# --- which calls replay ---------------------------------------------------

CUDA_POINTS = {"points": SimpleNamespace(device=torch.device("cuda"))}


@pytest.mark.parametrize("case, replays", [
    ("served on the card", True),
    ("grad enabled, no parameter requires grad", True),
    ("CPU tensors", False),
    ("autograd recording", False),
    ("quant int8", False),
    ("quant calib", False),
    ("a float model calibrating", False),
])
def test_replay_rule(case, replays):
    """Only CUDA inputs, with autograd not recording and float convs, go
    through the graphs; the rule reads only what the call shows (the
    inputs' device, autograd's state, the ConvNorms' quant modes, which
    calibration switches on a float model)."""
    cfg = _cfg()
    if case.startswith("quant"):
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, quant_mode=case.split()[1]))
    with torch.device("meta"):
        model = ContFuseDetector(cfg)
    inputs = CUDA_POINTS
    if case == "CPU tensors":
        inputs = {"points": torch.zeros(1, 4, 4)}
    if case == "grad enabled, no parameter requires grad":
        model.requires_grad_(False)
    if case == "a float model calibrating":      # as quant.calibrate does
        for m in model.modules():
            if isinstance(m, ConvNorm):
                m.quant = "calib"
    grad = case in ("autograd recording",
                    "grad enabled, no parameter requires grad")
    with torch.set_grad_enabled(grad):
        assert model.replays(inputs) is replays


def test_cpu_forward_stays_eager(served, tracer):
    """A CPU call runs the forward as written: no tape, no counter."""
    model, batches = served
    with torch.no_grad():
        for b in batches[:3]:
            model(b)
    assert model.graphs.tapes == {}
    c = _counters()
    assert "graph.captures" not in c and "graph.forwards" not in c


# --- the signature cache --------------------------------------------------


def test_signature_cache_counts_calls():
    """A signature's first call runs eagerly, its second captures, later
    ones replay; a new shape is a new entry, a seen one none."""
    def forward(inputs, seg):
        x = seg.stage(inputs)["x"]
        return {"y": seg.run("double", lambda a: 2 * a, x)}

    cache = graphs.GraphCache(Rerun)
    modes = []
    for n in (3, 3, 3, 4, 3, 4, 4):
        before = {k: v for k, v in cache.tapes.items()}
        out = cache(forward, {"x": torch.arange(n, dtype=torch.float32)})
        assert torch.equal(out["y"], 2 * torch.arange(n,
                                                      dtype=torch.float32))
        key = graphs.signature({"x": torch.zeros(n)})
        modes.append("eager" if key not in before else
                     "capture" if before[key] is None else "replay")
    assert modes == ["eager", "capture", "replay", "eager", "replay",
                     "capture", "replay"]
    assert len(cache.tapes) == 2


def test_replay_checks_its_inputs_and_segments():
    """A replay refuses an input of another shape where the capture read
    one, and a forward that reaches another segment than the capture
    had."""
    def forward(inputs, seg):
        x = seg.stage(inputs)["x"]
        return seg.run("a", lambda a: a + 1, x)

    tape = graphs.Tape(Rerun())
    tape.capture(forward, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="capture read"):
        tape.replay(forward, {"x": torch.zeros(4)})

    def other(inputs, seg):
        return seg.run("b", lambda a: a + 1, seg.stage(inputs)["x"])
    with pytest.raises(RuntimeError, match="segment 'b'"):
        tape.replay(other, {"x": torch.zeros(3)})


def test_model_moves_clear_its_graphs(served):
    """Moving a model (or casting it) drops its graphs, which read the
    old parameters; a copy starts with none."""
    model, batches = served
    model = copy.deepcopy(model)
    model.graphs = graphs.GraphCache(Rerun)
    with torch.no_grad():
        for b in batches[:2]:
            model.graphs(model._forward, _inputs(model, b))
    assert len(model.graphs.tapes) == 1
    assert copy.deepcopy(model).graphs.tapes == {}
    model.to("cpu")
    assert model.graphs.tapes == {}


# --- the segmented forward ------------------------------------------------


def test_segmented_forward_equals_eager(served, tracer):
    """Frame by frame, the forward run segment by segment (eager, then
    captured, then replayed on other frames) equals the whole eager
    forward bit for bit, with 20 segments in the capture's order; the
    maps returned are read after every frame was served, so a map that
    aliased the replayed outputs would hold the last frame's."""
    model, batches = served
    cache = graphs.GraphCache(Rerun)
    with torch.no_grad():
        want = [model(b) for b in batches]
        got = [cache(model._forward, _inputs(model, b)) for b in batches]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k
    (tape,) = cache.tapes.values()
    names = [s[0] for s in tape.segments]
    fusion = [f"fusion_s{s}.{part}" for s in (2, 4, 8, 16)
              for part in ("bins", "out", "sum")]
    assert names == (["raster", "image_backbone", "bev_stage0"]
                     + fusion[:3] + ["bev_stage1"] + fusion[3:6]
                     + ["bev_stage2"] + fusion[6:9] + ["bev_stage3"]
                     + fusion[9:] + ["fpn", "head"])
    c = _counters()
    assert c["graph.captures"] == 1
    assert c["graph.forwards"] == len(batches) - 2


def test_replay_never_writes_the_callers_tensors(served):
    """The capture reads its own copies of the inputs: the tensors of the
    captured call (and of every later one) are left as they were, and
    serving that call's frame again after others gives its own maps."""
    model, batches = served
    cache = graphs.GraphCache(Rerun)
    inputs = [_inputs(model, b) for b in batches]
    kept = [{k: v.clone() for k, v in x.items()} for x in inputs]
    with torch.no_grad():
        for x in inputs + inputs[1:2]:
            got = cache(model._forward, x)
        want = model(batches[1])
    for x, k in zip(inputs, kept):
        assert all(torch.equal(x[n], k[n]) for n in k)
    assert all(torch.equal(got[n], want[n]) for n in want)


def test_segmented_forward_without_camera(tracer):
    """The LiDAR-only detector (no image, no fusion) segments too:
    raster, four stages, FPN, head."""
    cfg = _cfg(with_fusion=False)
    cfg = dataclasses.replace(cfg, with_camera=False, with_fusion=False)
    model = init_params(cfg, torch.Generator().manual_seed(1),
                        device="cpu").eval()
    batches = [batch_to_device(stack_examples([frame_to_example(
        make_varied_frame(seed=s), cfg)]), "cpu") for s in range(4)]
    cache = graphs.GraphCache(Rerun)
    with torch.no_grad():
        for b in batches:
            got = cache(model._forward, _inputs(model, b))
            want = model(b)
            assert all(torch.equal(got[k], want[k]) for k in want)
    (tape,) = cache.tapes.values()
    assert [s[0] for s in tape.segments] == [
        "raster", "bev_stage0", "bev_stage1", "bev_stage2", "bev_stage3",
        "fpn", "head"]


@pytest.mark.parametrize("tracing_from", ["before capture", "after capture"])
def test_counters_through_segments(served, tracing_from):
    """The fusion layers' device counters read the same from the
    segments' outputs, whether the tracer was on at capture or turned on
    after it, as from the eager forward on the same frames."""
    model, batches = served
    names = ("fusion.bin_eligible", "fusion.bin_dropped", "fusion.pairs")
    cache = graphs.GraphCache(Rerun)
    counted = batches if tracing_from == "before capture" else batches[2:]

    def counters(run, frames):
        trace.reset()
        trace.enable()
        try:
            with torch.no_grad():
                for b in frames:
                    run(b)
            c = _counters()
        finally:
            trace.enable(False)
            trace.reset()
        return {k: c[k] for k in names}

    def graphed(b):
        return cache(model._forward, _inputs(model, b))
    want = counters(model, counted)
    if tracing_from == "after capture":
        with torch.no_grad():
            for b in batches[:2]:
                graphed(b)
    assert counters(graphed, counted) == want
    assert want["fusion.bin_eligible"] > want["fusion.bin_dropped"] > 0


def test_bin_counts_match_their_definition(tracer):
    """`count_bin_drops` on `bin_points_dense_tally`'s masks counts the
    valid points inside the grid and, of those, the ones beyond a cell's
    capacity in arrival order; `bin_points_dense` counts the same and
    returns the same bins."""
    rng = np.random.default_rng(5)
    B, P, H, W, cap = 2, 600, 6, 7, 3
    pts = np.zeros((B, P, 4), np.float32)
    pts[..., 0] = rng.uniform(-1, H + 1, (B, P))
    pts[..., 1] = rng.uniform(-1, W + 1, (B, P))
    pts[..., 3] = np.arange(P)
    mask = rng.uniform(size=(B, P)) < 0.8
    points, m = torch.from_numpy(pts), torch.from_numpy(mask)

    bins, inside, kept = knn.bin_points_dense_tally(points, m, (0.0, 0.0),
                                                    1.0, (H, W), cap)
    knn.count_bin_drops(inside, kept)
    c1 = _counters()
    trace.reset()
    trace.enable()
    inline = knn.bin_points_dense(points, m, (0.0, 0.0), 1.0, (H, W), cap)
    c2 = _counters()
    assert torch.equal(inline.data, bins.data)
    assert torch.equal(inline.valid, bins.valid)

    ix, iy = np.floor(pts[..., 0]), np.floor(pts[..., 1])
    ok = mask & (ix >= 0) & (ix < H) & (iy >= 0) & (iy < W)
    dropped = 0
    for b in range(B):
        seen = {}
        for p in range(P):
            if ok[b, p]:
                cell = (ix[b, p], iy[b, p])
                seen[cell] = seen.get(cell, 0) + 1
                dropped += seen[cell] > cap
    want = {"fusion.bin_eligible": float(ok.sum()),
            "fusion.bin_dropped": float(dropped)}
    for c in (c1, c2):
        assert {k: c[k] for k in want} == want
    assert int(bins.valid.sum()) == ok.sum() - dropped
