"""The port's data parallel (`dcf_torch.parallel.mesh`, the loop's
process shards, the step's reduction) and its debug step, on the CPU.

Two gloo ranks in subprocesses train 3 steps at a per-process batch of
1, one frame each, and must end where the port's single-process run at
the same global batch of 2 ends (the counterpart of
tests/test_multihost.py:44). The two frames hold 3 and 1 boxes, so the
ranks' num_pos differ and the test holds the global normalization: a
rank that divided by its own num_pos would take another step.

Tolerances: the ranks end bit-equal to each other (they apply one
reduced gradient to one broadcast state). Against the single-process
run, the sums reach the gradient in another order (per-rank sums added,
then divided, against the gradient of the normalized loss):
  - each step's logged loss and grad_norm within rtol 2e-5 (measured:
    2e-6), num_pos equal. These hold the normalization: dividing each
    rank's gradient by its own num_pos and averaging gives a grad_norm
    23-35% off on these frames;
  - the parameters and the EMA within atol 3e-4, as
    tests/test_multihost.py holds the JAX package's, with at most 0.1%
    of the elements more than 1e-6 apart. AdamW's normalized update
    turns float32 noise on elements whose gradient is near its eps into
    steps of up to the learning rate (65 of 140,260 elements of the image
    stem, up to 9.9e-5, measured), and it hides a gradient's scale: the
    per-rank normalization above still moves every element by less than
    3e-4, but 86% of them by more than 1e-6.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import dcf.train.loop as jloop
from dcf_torch.cli import train as cli_train
from dcf_torch.eval.inference import batch_to_device
from dcf_torch.data.preprocess import frame_to_example, stack_examples
from dcf_torch.models.anchors import anchor_pack
from dcf_torch.parallel import mesh
from dcf_torch.params import init_params
from dcf_torch.train.loop import _ProcessShard, train
from dcf_torch.train.state import create_train_state
from dcf_torch.train.step import build_loss_sums_fn, make_train_step
from torch_dp_worker import STEPS, Frames, dp_config, dp_frames

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
ATOL = 3e-4
NEAR, NEAR_SHARE = 1e-6, 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", port, str(tmp / f"rank{r}"),
         str(tmp)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-4000:]
        assert f"rank {r} done" in out
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    return tmp, ranks


@pytest.fixture(scope="module")
def single_process(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("sp")
    state = train(dp_config(2), Frames(dp_frames()), str(workdir),
                  device="cpu", num_steps=STEPS)
    return workdir, state


def _metrics(workdir):
    with open(workdir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_ranks_see_different_num_pos():
    cfg = dp_config(1)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sums_fn = build_loss_sums_fn(cfg, model)
    pack = anchor_pack(cfg, "cpu")
    num_pos = []
    with torch.no_grad():
        for frame in dp_frames():
            batch = batch_to_device(stack_examples(
                [frame_to_example(frame, cfg)]), "cpu")
            num_pos.append(float(sums_fn(batch, pack)[1]["num_pos"]))
    assert num_pos[0] != num_pos[1] and min(num_pos) > 0, num_pos


def test_two_ranks_end_identical(two_ranks):
    _, (r0, r1) = two_ranks
    assert r0["step"] == r1["step"] == STEPS
    for tree in ("params", "ema"):
        for name in r0[tree]:
            assert torch.equal(r0[tree][name], r1[tree][name]), (tree, name)


def test_two_ranks_log_the_global_batch(two_ranks, single_process):
    tmp, _ = two_ranks
    got, want = _metrics(tmp / "rank0"), _metrics(single_process[0])
    assert [m["step"] for m in got] == [m["step"] for m in want] \
        == list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        assert g["num_pos"] == w["num_pos"]
        for k in ("loss", "loss_cls", "loss_reg", "loss_dir", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, err_msg=k)


@pytest.mark.parametrize("tree", ["params", "ema"])
def test_two_ranks_match_single_process(two_ranks, single_process, tree):
    _, (r0, _) = two_ranks
    state = single_process[1]
    want = (dict(state.model.named_parameters()) if tree == "params"
            else state.ema)
    n = near = 0
    for name, got in r0[tree].items():
        w = want[name].detach().numpy()
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=name)
        n += w.size
        near += int((np.abs(got.numpy() - w) > NEAR).sum())
    assert near <= NEAR_SHARE * n, (near, n)


def test_only_rank0_writes(two_ranks):
    tmp, _ = two_ranks
    ckpts = os.listdir(tmp / "rank0" / "checkpoints")
    assert f"ckpt_{STEPS:08d}.pt" in ckpts, ckpts
    with open(tmp / "rank0" / "metrics.jsonl") as f:
        assert len(f.readlines()) == STEPS
    assert not (tmp / "rank1").exists()


@pytest.mark.parametrize("n,count", [(5, 2), (7, 3), (2, 3), (1, 2), (8, 4)])
def test_process_shard_matches_jax(n, count):
    for p in range(count):
        got, want = _ProcessShard(range(n), p, count), \
            jloop._ProcessShard(range(n), p, count)
        assert len(got) == len(want) >= 1
        assert [got[i] for i in range(3 * len(got))] == \
            [want[i] for i in range(3 * len(want))]


def test_data_shards_must_equal_processes(tmp_path):
    with pytest.raises(ValueError, match="data-shards 2 with 1 process"):
        cli_train.main(["--config", "tiny", "--synthetic", "2", "--steps",
                        "1", "--data-shards", "2", "--workdir",
                        str(tmp_path), "--device", "cpu"])
    assert not os.listdir(tmp_path)


def test_single_process_without_coordinator(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.initialize_distributed() is False
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    with pytest.raises(ValueError, match="process id"):
        mesh.initialize_distributed("localhost:1", 2)


# ---------------------------------------------------------- the debug step

def _step(debug, nan_leaf=None):
    cfg = dataclasses.replace(dp_config(2), train=dataclasses.replace(
        dp_config(2).train, ema_decay=0.0))
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = create_train_state(cfg, model)
    if nan_leaf is not None:
        dict(model.named_parameters())[nan_leaf].register_hook(
            lambda g: torch.full_like(g, float("nan")))
    batch = batch_to_device(stack_examples(
        [frame_to_example(f, cfg) for f in dp_frames()]), "cpu")
    step = make_train_step(cfg, model, "cpu", debug=debug)
    state, metrics = step(state, batch, anchor_pack(cfg, "cpu"))
    return state, metrics


def test_debug_step_equals_plain_step():
    (a, ma), (b, mb) = _step(False), _step(True)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("leaf", ["head.cls.weight", "fusion_s4.geo_kernel"])
def test_debug_step_names_the_nan_gradient(leaf):
    with pytest.raises(FloatingPointError,
                       match=f"gradient of {leaf} is not finite"):
        _step(True, nan_leaf=leaf)
