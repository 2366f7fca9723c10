"""The contfuse family gives the numbers the harness gave before the
families were split out (commit ff1f54b, the tiny cells of `conftest.py`,
`harness.execute` with a 0.5 s window on the CPU): the same checks, the
same end-to-end metric keys. The counts are exact; the float readings
are held to 1e-5 of their value, since two runs of one tree on the CPU
already differ by up to 1e-6 in `change_gap` (the order of the threads'
sums in the backward)."""

import pytest

from perfbench import harness

PARENT = {
    ("tiny.serve", 5): {"prep_diff": 0.0, "head_err": 0.02862928080244503,
                        "dets_diff": 0.0},
    ("tiny.serve", 2 ** 31 + 3): {"prep_diff": 0.0,
                                  "head_err": 0.026720543308517863,
                                  "dets_diff": 0.0},
    ("tiny.train", 5): {"batch_diff": 0.0, "pos_diff": 0.0,
                        "fwd_err": 0.024160350572650292,
                        "change_gap": 0.07097623539632512},
    ("tiny.train", 2 ** 31 + 3): {"batch_diff": 0.0, "pos_diff": 0.0,
                                  "fwd_err": 0.02418476660276909,
                                  "change_gap": 0.07940197161854073},
}
METRICS = {"tiny.serve": {"frame_ms_p50", "frame_ms_p95", "setup_s"},
           "tiny.train": {"train_frames_per_s", "setup_s"}}
EXACT = ("prep_diff", "dets_diff", "batch_diff", "pos_diff")


@pytest.mark.parametrize("cell, seed", sorted(PARENT))
def test_checks_equal_the_parents(tiny_base, cell, seed):
    base, bench = tiny_base
    r = harness.execute(bench, cell, seed, 0.5, False, "cpu", base=base)
    got = {k: v["value"] for k, v in r["checks"].items()}
    want = PARENT[(cell, seed)]
    assert set(got) == set(want)
    for k, v in want.items():
        if k in EXACT:
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-5), k
    assert set(r["metrics"]) == METRICS[cell]
