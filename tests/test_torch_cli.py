"""The port's CLI workflow on the CPU, as tests/test_cli.py runs the JAX
package's: a KITTI tree on disk (3 frames, written by the port), the
gt-sampling database, training with it, resuming, evaluation with KITTI
result files, and the demo, all through the entry points' `main()` with
`--device cpu`; and `--device cuda` raising where there is no card.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from dcf_torch.cli import build_gt_db, demo, evaluate, train
from dcf_torch.data.augment import GTDatabase
from dcf_torch.data.synthetic import write_kitti_tree
from dcf_torch.train import checkpoint as ckpt

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "kitti")
    write_kitti_tree(root, num_frames=3, split="train")
    # a val split over two of the frames (ids only; the reader re-parses)
    with open(os.path.join(root, "ImageSets", "val.txt"), "w") as f:
        f.write("000000\n000001\n")
    paths = {"root": root, "db": str(tmp / "gt_db.pkl"),
             "workdir": str(tmp / "run"), "results": str(tmp / "results")}
    data = ["--data-root", root]
    out = {"paths": paths}
    out["db"] = _run(build_gt_db.main, data + ["--out", paths["db"],
                                               "--min-points", "1"] + CPU)
    train_args = ["--config", "tiny", "--workdir", paths["workdir"],
                  "--gt-db", paths["db"]] + data + CPU
    out["train"] = _run(train.main, train_args + ["--steps", "1"])
    ckpt_dir = os.path.join(paths["workdir"], "checkpoints")
    out["first"] = sorted(os.listdir(ckpt_dir))
    out["resume"] = _run(train.main, train_args + ["--steps", "2",
                                                   "--resume"])
    out["latest"] = ckpt.latest_checkpoint(ckpt_dir)
    out["evaluate"] = _run(evaluate.main, [
        "--workdir", paths["workdir"], "--split", "val", "--results-dir",
        paths["results"], "--num-points", "0", "--batch-size", "1"]
        + data + CPU)
    out["demo"] = _run(demo.main, ["--config", "tiny"] + CPU)
    return out


def test_build_gt_db(flow):
    db = GTDatabase.load(flow["paths"]["db"])
    assert set(db.db) == {"Car", "Pedestrian", "Cyclist"}
    assert all(len(v) == 3 for v in db.db.values())     # one each a frame
    assert flow["db"].startswith(f"wrote {flow['paths']['db']}")


def test_train_then_resume(flow):
    assert flow["first"] == ["ckpt_00000001.pt", "config.json"]
    assert "resumed from" in flow["resume"] and "at step 1" in flow["resume"]
    assert flow["latest"].endswith("ckpt_00000002.pt")
    with open(os.path.join(flow["paths"]["workdir"], "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2]


def test_evaluate_writes_ap_and_results(flow):
    out = flow["evaluate"]
    assert out.startswith(f"evaluating {flow['latest']}")
    results = json.loads(out[out.index("{"):])
    assert set(results) == {f"{c}_{m}_{d}"
                            for c in ("Car", "Pedestrian", "Cyclist")
                            for m in ("3d", "bev")
                            for d in ("easy", "moderate", "hard")}
    assert all(0.0 <= v <= 1.0 for v in results.values())
    res = flow["paths"]["results"]
    assert sorted(os.listdir(res)) == ["000000.txt", "000001.txt"]
    n = 0
    for name in os.listdir(res):
        with open(os.path.join(res, name)) as f:
            for line in f:
                assert len(line.split()) == 16     # KITTI result format
                n += 1
    assert n > 0


def test_demo_prints_detections(flow):
    lines = flow["demo"].splitlines()
    assert lines[0].startswith("frame 000000:") and "3 gt boxes" in lines[0]
    assert len(lines) > 1 and "score=" in lines[1]


@pytest.mark.parametrize("main,argv", [
    (build_gt_db.main, ["--synthetic", "1", "--out", "unused.pkl"]),
    (train.main, ["--config", "tiny", "--synthetic", "2", "--steps", "1"]),
    (evaluate.main, ["--workdir", "unused", "--synthetic", "1"]),
    (demo.main, ["--config", "tiny"])],
    ids=["build_gt_db", "train", "evaluate", "demo"])
def test_cuda_without_a_card_raises(main, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv + ["--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)                                  # cuda is the default
    assert os.listdir(tmp_path) == []               # nothing was written
