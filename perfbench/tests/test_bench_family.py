"""A model family is new files only: a copy of `perfbench/` takes a
minimal family of its own (a one-conv BEV detector, its plain reference,
its configuration and two mixes) and runs both modes with every file it
had before unchanged; a configuration that names no family's module is
refused."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from perfbench import harness, registry
from perfbench.tests.conftest import GEN, ROOT

REFERENCE = '''
"""The one-conv BEV detector in plain float32 PyTorch: a two-channel BEV
raster (points per cell, the highest point above the floor) -> one 3x3
conv -> a score map and a two-channel offset map; the detections are the
top-k cells by score; training minimizes the score map's binary cross
entropy against the cells that hold a box centre, by plain SGD."""

import numpy as np
import torch
from torch import nn


class Config:
    def __init__(self, d):
        (self.x_min, self.x_max, self.y_min, self.y_max, self.z_min,
         self.z_max) = d["roi"]
        self.cell, self.top_k, self.lr = d["cell"], d["top_k"], d["lr"]
        self.H = int(round((self.x_max - self.x_min) / self.cell))
        self.W = int(round((self.y_max - self.y_min) / self.cell))


def cells(xyz, c):
    """Flat cell index of the points inside the ROI, and the mask."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    keep = ((x >= c.x_min) & (x < c.x_max) & (y >= c.y_min)
            & (y < c.y_max) & (z >= c.z_min) & (z < c.z_max))
    ix = torch.floor((x - c.x_min) / c.cell).long().clamp(0, c.H - 1)
    iy = torch.floor((y - c.y_min) / c.cell).long().clamp(0, c.W - 1)
    return ix * c.W + iy, keep


def raster(points: np.ndarray, c) -> torch.Tensor:
    p = torch.from_numpy(points[:, :3])
    idx, keep = cells(p, c)
    idx, z = idx[keep], p[keep, 2] - c.z_min
    count = torch.zeros(c.H * c.W).index_add_(0, idx, torch.ones(len(idx)))
    top = torch.zeros(c.H * c.W).scatter_reduce_(0, idx, z, "amax")
    return torch.stack([count, top]).view(2, c.H, c.W)


def target(boxes: np.ndarray, c) -> torch.Tensor:
    t = torch.zeros(c.H * c.W)
    if len(boxes):
        b = torch.from_numpy(boxes[:, :3].astype(np.float32))
        idx, keep = cells(b, c)
        t[idx[keep]] = 1.0
    return t.view(1, c.H, c.W)


class OneConv(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(2, 3, 3, padding=1)

    def forward(self, x):
        y = self.conv(x)
        return {"score": y[:, :1], "offset": y[:, 1:]}


def detect(maps, c):
    scores, idx = maps["score"].flatten(1).topk(c.top_k, dim=1)
    return {"idx": idx, "scores": scores}


def loss(maps, tgt):
    return nn.functional.binary_cross_entropy_with_logits(maps["score"], tgt)


def sgd_steps(c, weights, batches):
    """Losses of the steps over `batches` ((rasters, targets) each) and
    the per-leaf norms of the parameters' change after them."""
    model = OneConv(c)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    losses = []
    for x, t in batches:
        model.zero_grad()
        value = loss(model(x), t)
        value.backward()
        losses.append(float(value))
        with torch.no_grad():
            for p in model.parameters():
                p -= c.lr * p.grad
    change = [float((p.detach() - weights[n]).norm())
              for n, p in model.named_parameters()]
    return losses, change
'''

FAMILY = '''
"""A one-conv BEV detector: the program is numpy rasters, `F.conv2d` and
a hand-written SGD loop; its reference is `perfbench/onebev_ref/`."""

import itertools
import json

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import onebev_ref as ref
from perfbench import weights as weights_mod


def reference_config(config_json):
    return ref.Config(json.loads(config_json))


def flops_per_frame(c, mode):
    f = 2 * c.H * c.W * 3 * 2 * 9
    return f if mode == "serve" else 3 * f


def leaf_init(module, leaf, name, shape):
    fan = weights_mod.dense_fan_in(module, leaf, shape)
    return ("normal", fan) if fan else ("const", 0.0)


def make_weights(c, seed, device):
    with torch.device("meta"):
        meta = ref.OneConv(c)
    return weights_mod.make_weights(meta, seed, device, leaf_init)


def _cells(xyz, c):
    """The program's cell index of the points inside the ROI (numpy)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    keep = ((x >= c.x_min) & (x < c.x_max) & (y >= c.y_min)
            & (y < c.y_max) & (z >= c.z_min) & (z < c.z_max))
    ix = np.clip(np.floor((x[keep] - np.float32(c.x_min))
                          / np.float32(c.cell)).astype(np.int64), 0, c.H - 1)
    iy = np.clip(np.floor((y[keep] - np.float32(c.y_min))
                          / np.float32(c.cell)).astype(np.int64), 0, c.W - 1)
    return ix * c.W + iy, keep


def raster(points, c):
    idx, keep = _cells(points, c)
    out = np.zeros((2, c.H * c.W), np.float32)
    np.add.at(out[0], idx, 1.0)
    np.maximum.at(out[1], idx, points[keep, 2] - np.float32(c.z_min))
    return out.reshape(2, c.H, c.W)


def target(boxes, c):
    out = np.zeros(c.H * c.W, np.float32)
    out[_cells(boxes[:, :3].astype(np.float32), c)[0]] = 1.0
    return out.reshape(1, c.H, c.W)


def forward(w, x):
    y = F.conv2d(x, w["conv.weight"], w["conv.bias"], padding=1)
    return {"score": y[:, :1], "offset": y[:, 1:]}


class Serving:
    def __init__(self, env, pool_ref):
        self.ref_cfg = c = reference_config(env.config_json)
        self.roi = c
        self.frames = [f.points.copy() for f in pool_ref]
        self.weights = make_weights(c, env.seed, env.device)
        self.capture, self._maps = False, None

    def prepare(self, points):
        ex = {"raster": raster(points, self.ref_cfg)}
        return ex, torch.from_numpy(ex["raster"][None])

    @torch.no_grad()
    def infer(self, batch):
        maps = forward(self.weights, batch)
        if self.capture:
            self._maps = maps
        s, i = maps["score"].flatten(1).topk(self.ref_cfg.top_k, dim=1)
        return {"idx": i.numpy(), "scores": s.numpy()}

    def take_maps(self):
        maps, self._maps = self._maps, None
        return maps

    def trace(self, sp, ranges):
        pass

    def close(self):
        pass


def serve_compare(run_out, device, control=False):
    c, w = run_out["ref_cfg"], run_out["weights"]
    model = ref.OneConv(c)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    raster_diff, head_err, dets_diff = 0, 0.0, 0
    with torch.no_grad():
        for j, cap in sorted(run_out["captured"].items()):
            x = ref.raster(run_out["pool_ref"][j].points, c)
            raster_diff += int((torch.from_numpy(cap["example"]["raster"])
                                != x).sum())
            maps = model(x[None])
            for k, v in maps.items():
                err = (cap["maps"][k] - v).pow(2).mean().sqrt() / v.std()
                head_err = max(head_err, float(err))
            want = ref.detect(cap["maps"], c)
            dets_diff += int((torch.from_numpy(cap["dets"]["idx"])
                              != want["idx"]).sum())
    return {"raster_diff": float(raster_diff), "head_err": head_err,
            "dets_diff": float(dets_diff)}


def _plan(n_frames, batch, seed):
    for epoch in itertools.count():
        order = np.random.default_rng([seed, epoch]).permutation(n_frames)
        for s in range(0, n_frames, batch):
            yield order[s:s + batch]


class Training:
    def __init__(self, env, pool_ref):
        self.ref_cfg = reference_config(env.config_json)
        self.env, self.pool_ref = env, pool_ref
        self.weights = make_weights(self.ref_cfg, env.seed, env.device)
        self.n = env.traffic["check_steps"]
        self.rec = {"losses": [], "plans": []}

    def trace(self, ranges):
        pass

    def run(self, on_step, wrap_batches, wrap_step):
        c, t, rec = self.ref_cfg, self.env.traffic, self.rec
        w = {k: v.clone().requires_grad_() for k, v in self.weights.items()}

        def stream():
            for idx in _plan(len(self.pool_ref), t["batch"], self.env.seed):
                frames = [self.pool_ref[i] for i in idx]
                x = np.stack([raster(f.points, c) for f in frames])
                tg = np.stack([target(f.boxes, c) for f in frames])
                yield idx, torch.from_numpy(x), torch.from_numpy(tg)

        def step(state, batch):
            idx, x, tg = batch
            loss = F.binary_cross_entropy_with_logits(
                forward(state, x)["score"], tg)
            grads = torch.autograd.grad(loss, list(state.values()))
            with torch.no_grad():
                for p, g in zip(state.values(), grads):
                    p -= c.lr * g
            if len(rec["losses"]) < self.n:
                rec["losses"].append(float(loss))
                rec["plans"].append(idx)
            if len(rec["losses"]) == self.n and "change" not in rec:
                rec["change"] = [float((state[k].detach() - v).norm())
                                 for k, v in self.weights.items()]
            return state

        batches, step = wrap_batches(stream()), wrap_step(step)
        try:
            for k in itertools.count(1):
                w = step(w, next(batches))
                on_step(k)
        finally:
            batches.close()

    def close(self):
        pass

    def outputs(self):
        return {"losses": self.rec["losses"], "change": self.rec["change"],
                "plans": self.rec["plans"], "pool_ref": self.pool_ref,
                "weights": self.weights, "ref_cfg": self.ref_cfg}


def train_compare(run_out, device):
    c, pool = run_out["ref_cfg"], run_out["pool_ref"]
    batches = [(torch.stack([ref.raster(pool[i].points, c) for i in idx]),
                torch.stack([ref.target(pool[i].boxes, c) for i in idx]))
               for idx in run_out["plans"]]
    losses, change = ref.sgd_steps(c, run_out["weights"], batches)
    gap = max(abs(a - b) / abs(b) for a, b in zip(run_out["losses"], losses))
    change_gap = max(abs(a - b) / max(b, 1e-30)
                     for a, b in zip(run_out["change"], change))
    return {"loss_gap": gap, "change_gap": change_gap}


def compare(mode, run_out, device):
    if mode == "serve":
        return serve_compare(run_out, device)
    return train_compare(run_out, device)
'''

CONFIG = {"family": "onebev",
          "source": "a test's minimal detector: one 3x3 conv on a BEV raster",
          "reduced": [], "assumed": {},
          "config": {"roi": [0.0, 25.6, -12.8, 12.8, -3.0, 1.0],
                     "cell": 0.4, "top_k": 8, "lr": 0.05},
          "limits": {"serve": {"raster_diff": 0.0, "head_err": 1e-5,
                               "dets_diff": 0.0},
                     "train": {"loss_gap": 1e-5, "change_gap": 1e-4}}}

RUN = '''
import json, sys
sys.path.insert(0, %(root)r)
from perfbench import harness, registry
bench = json.load(open(%(bench)r))
for cell in ("onebev.serve", "onebev.train"):
    r = harness.execute(bench, cell, 2 ** 31 + 5, 1.0, False, "cpu",
                        base=registry.HERE)
    print(json.dumps(r))
'''


def _digests(top):
    out = {}
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _bench_with(cells):
    """BENCHMARK.json with `cells` added, each reporting the end-to-end
    metrics of the committed cells of its mode."""
    bench = registry.load_benchmark(ROOT)
    mode_of = {w["name"]: registry.traffic(w["traffic"])["mode"]
               for w in bench["workloads"]}
    for name, config, mix, mode in cells:
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU test"})
        for m in bench["end_to_end"]:
            if any(mode_of.get(w) == mode for w in m.get("workloads", [])):
                m["workloads"].append(name)
    return bench


def test_new_family_is_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    bench_dir = root / "perfbench"
    shutil.copytree(os.path.join(ROOT, "perfbench"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench_dir)
    (bench_dir / "onebev_ref").mkdir()
    (bench_dir / "onebev_ref" / "__init__.py").write_text(
        textwrap.dedent(REFERENCE))
    (bench_dir / "families" / "onebev.py").write_text(
        textwrap.dedent(FAMILY))
    (bench_dir / "configs" / "onebev-tiny.json").write_text(
        json.dumps(CONFIG))
    (bench_dir / "traffic" / "onebev-serve.json").write_text(json.dumps(
        {"mode": "serve", "batch": 1, "pool": 4, "generator": GEN,
         "warmup_frames": 1, "check_frames": 2, "profile_s": 0.5}))
    (bench_dir / "traffic" / "onebev-train.json").write_text(json.dumps(
        {"mode": "train", "batch": 2, "pool": 6, "generator": GEN,
         "warmup_steps": 2, "check_steps": 3, "profile_s": 0.5}))
    bench = _bench_with([
        ("onebev.serve", "onebev-tiny", "onebev-serve", "serve"),
        ("onebev.train", "onebev-tiny", "onebev-train", "train")])
    (root / "bench.json").write_text(json.dumps(bench))
    for name in ("onebev_ref/__init__.py", "families/onebev.py"):
        tree = ast.parse((bench_dir / name).read_text())
        tops = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
        tops |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert not tops & (set(harness.FORBIDDEN) | {"dcf_torch"}), name
    out = subprocess.run(
        [sys.executable, "-c", RUN % {"root": str(root),
                                      "bench": str(root / "bench.json")}],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    serve, train = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert serve["correct"], serve["checks"]
    assert set(serve["checks"]) == {"raster_diff", "head_err", "dets_diff"}
    assert set(serve["metrics"]) == {"frame_ms_p50", "frame_ms_p95",
                                     "setup_s"}
    assert train["correct"], train["checks"]
    assert set(train["metrics"]) == {"train_frames_per_s", "setup_s"}
    # the window opens at a pass boundary of the pool (3 steps each)
    first, last = train["window_steps"]
    assert first >= 2 and first % 3 == 0 and last > first
    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before


def test_unknown_family_refused(tiny_base, tmp_path):
    base, bench = tiny_base
    for d in ("configs", "traffic", "families"):
        shutil.copytree(os.path.join(base, d), tmp_path / d)
    with open(tmp_path / "configs" / "tiny.json") as f:
        data = json.load(f)
    (tmp_path / "configs" / "tiny.json").write_text(
        json.dumps(dict(data, family="pointpillars")))
    with pytest.raises(ValueError, match=r"'contfuse'"):
        harness.execute(bench, "tiny.serve", 1, 0.5, False, "cpu",
                        base=str(tmp_path))
    assert registry.families(str(tmp_path)) == ["contfuse"]
