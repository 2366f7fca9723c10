"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole (`dcf_torch` is not `dcf`)."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "perfbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_or_dcf_anywhere():
    for path in _sources(BENCH):
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        assert "dcf_torch" not in set(_imports(path)), path


@pytest.mark.parametrize("modules, found", [
    (["dcf_torch", "dcf_torch.ops"], []),
    (["dcf", "os"], ["dcf"]),
    (["dcf.models.head"], ["dcf"]),
    (["jax._src.core", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen", "jax_ish"], ["flax"])])
def test_forbidden_compares_whole_names(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_a_run_loads_neither():
    """Importing everything a run imports, the port included, loads no
    forbidden module (in a fresh interpreter)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.serve, perfbench.train, perfbench.readings\n"
            "import perfbench.harness as h, perfbench.registry as r\n"
            "r.family('contfuse')\n"
            "import dcf_torch.train.loop, dcf_torch.eval.inference\n"
            "import dcf_torch.quant\n"
            "print(h.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", ["serve.py", "train.py"])
def test_modes_name_no_family(name):
    """The modes keep what every detector shares: they import nothing of
    the program or of a family's reference, and name no ContFuse part."""
    path = os.path.join(BENCH, name)
    assert not {"dcf_torch", "dcf"} & set(_imports(path))
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert not node.module.startswith("perfbench.reference"), path
            assert "reference" not in [a.name for a in node.names], path
    text = open(path).read().lower()
    for word in ("contfuse", "fusion", "image_backbone", "clip"):
        assert word not in text, (name, word)
