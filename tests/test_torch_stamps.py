"""The profile tools' stamped copies of the kernels, as text on the CPU.

`profile_fusion`, `profile_fusion_bwd` and `profile_knn` build copies of
`dcf_torch/csrc/fusion_fwd.cu`, `fusion_bwd.cu` and `knn.cu` with
`clock64()` stamps inserted at anchors (`dcf_torch/tools/stamps.py`).
The copies compile only on the card; here each tool's inserts must still
find every anchor exactly once in the current source, and the copy must
carry the stamp buffer and its reader.
"""

import os

import pytest
import torch

from dcf_torch.ops import _cuda
from dcf_torch.tools import (profile_fusion, profile_fusion_bwd, profile_knn,
                             stamps)

torch.set_num_threads(1)

TOOLS = {"fusion_fwd.cu": profile_fusion, "fusion_bwd.cu": profile_fusion_bwd,
         "knn.cu": profile_knn}


@pytest.mark.parametrize("source", list(TOOLS))
def test_stamped_source_applies(source, monkeypatch):
    tool = TOOLS[source]
    built = {}

    def fake_build_copy(src_name, name, transform, signatures=None):
        with open(os.path.join(_cuda.CSRC, src_name)) as f:
            built[name] = (src_name, transform(f.read()), signatures)
        return None

    monkeypatch.setattr(_cuda, "build_copy", fake_build_copy)
    tool.build_stamped()
    (src_name, text, signatures), = built.values()
    assert src_name == source
    assert text.count("__device__ unsigned long long g_stamps[") == 1
    assert text.count('extern "C" int dcf_read_stamps(') == 1
    assert "dcf_read_stamps" in signatures
    assert text.count("clock64()") >= 2
    assert text.index("kStampRows") < text.index("namespace {\n")


def test_insert_needs_one_anchor():
    with pytest.raises(RuntimeError):
        stamps.stamped_source("namespace {\n}\n", 1, 1,
                              [("missing\n", "x", True)])
    with pytest.raises(RuntimeError):
        stamps.stamped_source("a\na\nnamespace {\n}\n", 1, 1,
                              [("a\n", "x", True)])
