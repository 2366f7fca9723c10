"""BENCHMARK.json against the contract, and discovery by name."""

import json
import os

import pytest

from perfbench import registry
from perfbench.tests.conftest import ROOT


@pytest.fixture(scope="module")
def bench():
    return registry.load_benchmark(ROOT)


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(set(names)) == len(names)
    for e in bench[kind]:
        registry.check_name(e["name"])
        if "unit" in e:
            registry.check_unit(e["unit"])
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


@pytest.mark.parametrize("bad", ["", ".x", "-x", "a b", "a,b", "a/b",
                                 "µs", "x" * 65])
def test_bad_names_refused(bad):
    with pytest.raises(ValueError):
        registry.check_name(bad)


@pytest.mark.parametrize("bad", ["", "tokens per second", "µs",
                                 "x" * 17])
def test_bad_units_refused(bad):
    with pytest.raises(ValueError):
        registry.check_unit(bad)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in registry.end_to_end(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = registry.per_layer(bench, w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in e2e
        assert w["chips"] == 1
        assert registry.config(w["config"])["config"]
        assert registry.traffic(w["traffic"])["mode"] in ("serve", "train")


def test_configs_files(bench):
    for c in bench["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        data = registry.config(c["name"])
        assert data["reduced"] == c["reduced"] == []
        assert set(data["limits"]) == {"serve", "train"}


def test_metric_readers_match(bench):
    for m in bench["per_layer"]:
        reader = registry.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == \
            (m["layer"], m["unit"], m["moves"])
        assert callable(reader.read)


def test_discovery_of_new_files(tmp_path, bench):
    """A configuration, a mix and a metric added as new files are found by
    name, with no edit to a file that is there."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "new-cfg.json").write_text(
        json.dumps({"config": {"with_fusion": False}, "limits": {}}))
    (tmp_path / "traffic" / "new-mix.json").write_text(
        json.dumps({"mode": "serve", "pool": 2}))
    (tmp_path / "metrics" / "new_metric.serve.py").write_text(
        "LAYER = 'device'\nUNIT = '%'\nMOVES = 'frame_ms_p50'\n"
        "def read(ctx):\n    return 42.0\n")
    assert registry.config("new-cfg", str(tmp_path))["config"] == \
        {"with_fusion": False}
    assert registry.traffic("new-mix", str(tmp_path))["pool"] == 2
    assert registry.metric_reader("new_metric.serve",
                                  str(tmp_path)).read(None) == 42.0
    extra = dict(bench, workloads=bench["workloads"] + [
        {"name": "new-cfg.new-mix", "config": "new-cfg",
         "traffic": "new-mix", "chips": 1, "why": "t"}],
        per_layer=bench["per_layer"] + [
        {"name": "new_metric.serve", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "frame_ms_p50", "workloads": ["new-cfg.new-mix"]}])
    assert [m["name"] for m in registry.per_layer(extra, "new-cfg.new-mix")
            ] == ["new_metric.serve"]


@pytest.mark.parametrize("kind, data", [
    ("configs", {"config": {}, "limits": {}, "factory": "x"}),
    ("serve", {"mode": "serve", "batch": 1, "streams": 1}),
    ("serve", {"mode": "serve", "batch": 1, "loop": "closed"}),
    ("serve", {"mode": "serve", "batch": 8}),
    ("train", {"mode": "train", "batch": 8, "loop": "train.loop.train"})])
def test_unread_keys_refused(tmp_path, kind, data):
    """A key that nothing reads, or a batch that serving does not run, is
    refused rather than run as another cell under the file's name."""
    from perfbench import serve, train
    with pytest.raises(ValueError):
        if kind == "configs":
            (tmp_path / "configs").mkdir()
            (tmp_path / "configs" / "c.json").write_text(json.dumps(data))
            registry.config("c", str(tmp_path))
        else:
            (serve if kind == "serve" else train).check_mix(data)


def test_committed_mixes_are_read_whole(bench):
    from perfbench import harness
    for w in bench["workloads"]:
        mix = registry.traffic(w["traffic"])
        harness.mode_module(mix["mode"]).check_mix(mix)
