"""Finds a cell's configuration, traffic mix and per-layer metric readers
by the names in `BENCHMARK.json`, and checks the names' character rules.

Layout (a later cell, mix, metric or model family is a new file, never an
edit):
  perfbench/configs/<config>.json   one configuration each; its `family`
                                    names the module that runs it
  perfbench/traffic/<mix>.json      one traffic mix each
  perfbench/metrics/<metric>.py     one per-layer metric reader each
  perfbench/families/<family>.py    one model family each (the program's
                                    and the reference's side of a cell;
                                    interface in `families/__init__.py`)
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}: 1-64 of letters, digits, "
                         f"'_', '.', '-', not starting with '.' or '-'")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise ValueError(f"bad unit {unit!r}")
    return unit


def check_keys(data: Dict, keys, what: str) -> None:
    """Refuses a file with keys that nothing reads: an option that does
    nothing would run a new cell as another and report it by its name."""
    extra = sorted(set(data) - set(keys))
    if extra:
        raise ValueError(f"{what}: unread keys {extra}; read are "
                         f"{sorted(keys)}")


CONFIG_KEYS = ("family", "source", "reduced", "assumed", "config", "limits")


def load_benchmark(root: str) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(base: str, kind: str, name: str) -> Dict:
    path = os.path.join(base, kind, check_name(name) + ".json")
    with open(path) as f:
        return json.load(f)


def config(name: str, base: str = HERE) -> Dict:
    """The configuration file `configs/<name>.json`: the model family that
    runs it (`family`), its configuration as run (`config`), the limits of
    `correct` by mode (`limits`), and for the reader its `source`,
    `reduced` and `assumed`."""
    data = _json(base, "configs", name)
    check_keys(data, CONFIG_KEYS, f"configs/{name}.json")
    return data


def traffic(name: str, base: str = HERE) -> Dict:
    """The traffic mix `traffic/<name>.json`."""
    return _json(base, "traffic", name)


def _module(base: str, kind: str, name: str):
    path = os.path.join(base, kind, check_name(name) + ".py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: str = HERE):
    """The module `metrics/<name>.py`: LAYER, UNIT, MOVES and
    read(ctx) -> float or None."""
    return _module(base, "metrics", name)


def families(base: str = HERE) -> List[str]:
    """The model families that have a module under `families/`."""
    return sorted(f[:-3] for f in os.listdir(os.path.join(base, "families"))
                  if f.endswith(".py") and not f.startswith("_"))


def family(name: str, base: str = HERE):
    """The module `families/<name>.py` (the interface is in
    `families/__init__.py`); refuses a name that has none."""
    known = families(base)
    if name not in known:
        raise ValueError(f"no model family {name!r}: the families are "
                         f"{known} (perfbench/families/<family>.py)")
    return _module(base, "families", name)


def _applies(metric: Dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: Dict, cell_name: str) -> List[Dict]:
    """The end-to-end metrics that `cell_name` reports."""
    return [m for m in bench["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics that `cell_name` reports: those that list it,
    or that list no cells and move an end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
