"""PointPillars on the port's serving path, held to the plain reference
(`perfbench/reference_pointpillars/`) at a small size on the CPU: a
64 x 64 canvas of 0.64 m pillars, P = 256 pillars of N = 16 points, the
published channel widths, seeded weights with BatchNorm statistics far
from 0 / 1 (`perfbench/families/pointpillars.py`). On the CPU the
program runs the kernels' plain versions (`dcf_torch/ops/pillars.py`);
tests/test_torch_cuda.py holds the kernels to them on the card.

Tolerances: pillarization is integer work and must agree exactly. The
forward in float32 differs from the reference's by summation order only
(the mean's sum, the folded BatchNorm, the conv algorithms): 1e-4 of a
map's standard deviation. The detections must equal the reference's
decode and NMS of the program's own maps exactly."""

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from dcf_torch.models import pointpillars as ppm
from dcf_torch.ops import pillars as pops
from dcf_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench import faults, harness, registry, serve  # noqa: E402
from perfbench import reference_pointpillars as ref  # noqa: E402
from perfbench import traffic_gen  # noqa: E402

GEN = {"objects": [1, 4], "ground_points": [1000, 3000],
       "points_per_object": [120, 400], "sweep_points": 20000}
FAMILY = registry.family("pointpillars")


def small_dict(dtype="float32"):
    """The benchmark's configuration at the tests' size."""
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "pointpillars-car.json")) as f:
        d = json.load(f)["config"]
    d["voxel"].update(x_max=40.96, y_min=-20.48, y_max=20.48,
                      voxel_size=0.64, max_points=4096)
    d["pillars"].update(max_pillars=256, max_points=16)
    d["backbone"]["dtype"] = dtype
    return d


def small_config():
    return ppm.from_dict(small_dict())


@pytest.fixture(scope="module")
def pool():
    return traffic_gen.make_pool(GEN, 4, 11)


def test_benchmark_runs_the_papers_config():
    """The configuration file is `pointpillars_config()` with the paper's
    `PillarConfig`: nothing cut."""
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "pointpillars-car.json")) as f:
        data = json.load(f)
    assert data["reduced"] == []
    cfg, pc = ppm.from_dict(data["config"])
    assert cfg == ppm.pointpillars_config() and pc == ppm.PillarConfig()
    assert (cfg.voxel.grid_x, cfg.voxel.grid_y) == (432, 496)
    spec = FAMILY.reference_config(json.dumps(data["config"]))
    parts = FAMILY.inference_flops_per_frame(spec)
    assert parts["total"] / 1e9 == pytest.approx(67.59, abs=0.01)
    assert parts["pfn"] / 1e9 == pytest.approx(1.38, abs=0.01)


def _cloud(seed, n=3000, crowd=0):
    cfg, pc = small_config()
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.uniform(-1.0, 42.0, n)
    pts[:, 1] = rng.uniform(-21.0, 21.0, n)
    pts[:, 2] = rng.uniform(-3.5, 1.5, n)
    pts[:, 3] = rng.uniform(0.0, 1.0, n)
    pts[:crowd, :2] = rng.uniform(5.0, 5.5, (crowd, 2))   # a few cells
    mask = rng.uniform(size=n) < 0.9
    return pts, mask, cfg, pc


@pytest.mark.parametrize("seed, n, crowd, P, N", [
    (0, 3000, 0, 256, 16),      # the pillar cap binds
    (1, 3000, 400, 256, 16),    # both caps bind
    (2, 300, 200, 256, 16),     # the slot cap binds alone
    (3, 300, 0, 256, 16),       # neither
    (4, 0, 0, 256, 16)])        # an empty cloud
def test_pillarize_matches_reference(seed, n, crowd, P, N):
    pts, mask, cfg, pc = _cloud(seed, n, crowd)
    spec = ref.Spec(ref.Config.from_json(cfg.to_json()),
                    ref.PillarConfig(max_pillars=P, max_points=N))
    want = ref.pillarize(pts, mask, spec)
    got = pops.pillarize(torch.from_numpy(pts[None]),
                         torch.from_numpy(mask[None]), cfg.voxel, P, N)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(), want[f],
                                      err_msg=f)
    total, inroi, placed = want["stats"][2], want["stats"][0], \
        want["stats"][1]
    if seed == 0:
        assert total > P
    if seed in (1, 2):
        assert want["counts"].max() == N and placed < inroi
    if seed == 1:
        assert total > P


def test_pfn_max_takes_padded_slots():
    """A pillar of one point takes relu(bias) (its empty slots' value)
    into its max; a full pillar of N points does not."""
    cfg, pc = small_config()
    vox, N = cfg.voxel, pc.max_points
    pts = np.zeros((1, N + 1, 4), np.float32)
    pts[0, 0] = [1.0, 0.1, 0.5, 0.5]              # alone in its pillar
    pts[0, 1:] = [[10.1, 0.2, 0.3, 0.3]] * N      # N points in another
    t = pops.pillarize(torch.from_numpy(pts), torch.ones(1, N + 1, dtype=bool),
                       vox, pc.max_pillars, N)
    assert t.counts[0, :2].tolist() == [1, N]
    C = 64
    w = torch.zeros(9, C)
    w[:4] = -torch.linspace(0.01, 0.2, C)     # x, y, z, r >= 0: y <= bias
    b = torch.linspace(0.5, 2.0, C)
    canvas = pops.pfn_scatter(torch.from_numpy(pts), t, w, b, vox,
                              torch.zeros(1, vox.grid_x, vox.grid_y, C))
    one = canvas[0, t.coords[0, 0, 0], t.coords[0, 0, 1]]
    full = canvas[0, t.coords[0, 1, 0], t.coords[0, 1, 1]]
    torch.testing.assert_close(one, b, rtol=0, atol=0)
    want = torch.relu(torch.from_numpy(pts[0, 1, :4]) @ w[:4] + b)
    torch.testing.assert_close(full, want, rtol=1e-6, atol=1e-6)
    assert (full < b).any()


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_forward_matches_reference(pool, seed):
    """Head maps in float32 against the reference on the same weights,
    each cloud's pillar tables exactly."""
    cfg, pc = small_config()
    spec = FAMILY.reference_config(json.dumps(small_dict()))
    w = FAMILY.make_weights(spec, seed, "cpu", pool[0])
    model = FAMILY.load(ppm.PointPillarsDetector(cfg, pc), w).eval()
    want = FAMILY.load(ref.PointPillars(spec), w).eval()
    for frame in pool[1:]:
        ex = ref.example(frame, spec)
        tables = ref.pillarize(ex["points"], ex["point_mask"], spec)
        batch = {k: torch.from_numpy(v[None]) for k, v in ex.items()}
        with torch.no_grad():
            got = model(batch)
            maps = want(batch["points"][0], ref.tables_to(tables, "cpu"))
        for k, v in maps.items():
            assert FAMILY.rel_err(got[k], v) < 1e-4, k


def _small_base(tmp):
    """A copy of the benchmark with the cell `pp.serve`: the configuration
    at the tests' size (bf16, as the cell runs) and a 4-frame mix."""
    import shutil
    for d in ("configs", "traffic", "metrics", "families"):
        shutil.copytree(os.path.join(ROOT, "perfbench", d),
                        os.path.join(tmp, d))
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "pointpillars-car.json")) as f:
        full = json.load(f)
    with open(os.path.join(tmp, "configs", "pp.json"), "w") as f:
        json.dump(dict(full, config=small_dict("bfloat16")), f)
    with open(os.path.join(tmp, "traffic", "tserve.json"), "w") as f:
        json.dump({"mode": "serve", "batch": 1, "pool": 4, "generator": GEN,
                   "warmup_frames": 1, "check_frames": 2,
                   "profile_s": 0.5}, f)
    bench = registry.load_benchmark(ROOT)
    bench["workloads"].append({"name": "pp.serve", "config": "pp",
                               "traffic": "tserve", "chips": 1, "why": "t"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "pointpillars-car.serve-b1" in m["workloads"]:
            m["workloads"].append("pp.serve")
    return bench


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_cell_correct_and_control_fails(tmp_path, seed):
    """The benchmark's own comparison at the tests' size: the served
    detections equal the reference's decode and NMS of the program's maps,
    the tables and example equal the reference's, the bf16 head maps are
    within the limit and the float8 control is not."""
    bench = _small_base(str(tmp_path))
    config = registry.config("pp", str(tmp_path))
    env = harness.Env(family=FAMILY, config_json=json.dumps(config["config"]),
                      traffic=registry.traffic("tserve", str(tmp_path)),
                      seed=seed, seconds=0.5, trace=False,
                      device=torch.device("cpu"),
                      tmpdir=str(tmp_path))
    out = serve.run(env)
    ok = FAMILY.compare("serve", out, torch.device("cpu"))
    lim = config["limits"]["serve"]
    assert ok["pillar_diff"] == 0 and ok["dets_diff"] == 0, ok
    assert ok["head_err"] < lim["head_err"], ok
    ctl = FAMILY.control("serve", out, torch.device("cpu"))
    assert ctl["head_err"] > lim["head_err"], ctl
    r = harness.execute(bench, "pp.serve", seed, 0.5, False, "cpu",
                        base=str(tmp_path), fault=faults.altered_answer)
    assert r["correct"] is False and r["checks"]["dets_diff"]["value"] > 0
    assert set(r["metrics"]) == {"frame_ms_p50", "frame_ms_p95", "setup_s"}


def test_serving_adds_no_host_sync(pool):
    """Through `make_inference_fn`, the forward's only host syncs are NMS
    rounds' tests; the pillar counters are recorded on the device."""
    from dcf_torch.data.preprocess import stack_examples
    from dcf_torch.eval.inference import make_inference_fn, to_host
    cfg, pc = small_config()
    model = ppm.init_pointpillars(cfg, torch.Generator().manual_seed(0), pc,
                                  device="cpu")
    infer = make_inference_fn(cfg, model, device="cpu")
    frame = FAMILY.program_frame(pool[1])
    trace.reset()
    trace.enable()
    try:
        ex = ppm.pillar_example(frame, cfg)
        out = to_host(infer(stack_examples([ex])))
        snap = trace.snapshot()
    finally:
        trace.enable(False)
        trace.reset()
    c = snap["counters"]
    assert c["host_syncs"] == c["nms.rounds"] + 1
    assert c["pillars.points_in_roi"] == int(ex["point_mask"].sum())
    assert c["pillars.kept"] + c["pillars.dropped"] > 0
    names = {s["name"] for s in snap["spans"]}
    assert {"forward.pillarize", "forward.pfn", "forward.pp_backbone",
            "forward.head", "preprocess.crop"} <= names
    assert out["valid"].shape == (1, cfg.head.nms_max_per_class)


def test_int8_refused():
    from dcf_torch.quant import quant_config
    cfg, pc = small_config()
    with pytest.raises(ValueError, match="int8"):
        ppm.PointPillarsDetector(quant_config(cfg), pc)


def test_cli_serves_evaluates_and_refuses_training(monkeypatch, capsys):
    """`cli.demo` and `cli.evaluate --config pointpillars` serve the pillar
    network (here at the tests' size); `cli.train` refuses it by name."""
    from dcf_torch.cli import common, demo, evaluate
    from dcf_torch.cli import train as cli_train
    small = small_config()
    entry = common.CONFIGS["pointpillars"]
    monkeypatch.setitem(common.CONFIGS, "pointpillars", dataclasses.replace(
        entry, make=lambda: small[0],
        build=lambda cfg, g, device: entry.build(cfg, g, small[1], device)))
    demo.main(["--config", "pointpillars", "--device", "cpu"])
    assert "detections" in capsys.readouterr().out
    with tempfile.TemporaryDirectory() as res:
        evaluate.main(["--config", "pointpillars", "--synthetic", "2",
                       "--device", "cpu", "--num-points", "0",
                       "--results-dir", res])
        assert len(os.listdir(res)) == 2
    assert "Car_3d_moderate" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        cli_train.main(["--config", "pointpillars", "--synthetic", "1",
                        "--device", "cpu", "--steps", "1"])
    assert e.value.code == 2
    assert "BatchNorm in training mode" in capsys.readouterr().err


def test_smoke_clouds_bind_both_caps():
    """chip_smoke.py's phase 16 holds the kernels to their plain versions
    on its clouds at the network's shapes: the largest serving frame and
    the spread cloud overflow the pillar cap, the heaped one the slot
    cap, and the byte counts it bounds them by are those of the
    benchmark's roofline readers."""
    import chip_smoke
    from perfbench.families.pointpillars import pfn_bytes, pillarize_bytes
    cfg, pc = ppm.pointpillars_config(), ppm.PillarConfig()
    P, N = pc.max_pillars, pc.max_points
    stats = {}
    for name, pts, mask in chip_smoke.pp_clouds(cfg):
        assert pts.shape == (1, cfg.voxel.max_points, 4)
        args = (pts, mask, cfg.voxel, P, N)
        t = pops.pillarize_plain(*args)
        stats[name] = t.stats[0].tolist() + [int((t.counts == N).sum())]
        canvas = torch.zeros(1, 1, 1, pc.features)
        assert pillarize_bytes(args, t) > 0
        assert pfn_bytes((pts, t, torch.zeros(9, pc.features),
                          torch.zeros(pc.features), cfg.voxel, canvas),
                         canvas) > 0
    big = stats[f"{chip_smoke.PP_GROUND[-1]} ground"]
    assert big[2] > P and big[0] > big[1]
    assert stats["spread"][2] > P
    assert stats["heaped"][2] <= P and stats["heaped"][3] > 0
    assert stats["heaped"][0] > stats["heaped"][1]
