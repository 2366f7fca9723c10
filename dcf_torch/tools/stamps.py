"""Stamped copies of a kernel: `clock64()` readings at its phase
boundaries, for the profile tools (no `ncu` runs where the card is).

A tool names a source of `dcf_torch/csrc/`, the text to insert after or
before anchors in it (each anchor must occur exactly once), and the
shape of its stamp buffer: `rows` (blocks or warps) x `phases` cycle
counts in the device array `g_stamps`, which the inserted text fills.
`build` compiles the copy beside the kernel library
(`_cuda.build_copy`) with the reader `dcf_read_stamps`; `read` brings
the buffer to the host after a launch.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, Optional, Tuple

import numpy as np

from dcf_torch.ops import _cuda

# (anchor, text, True to insert after the anchor / False before it)
Insert = Tuple[str, str, bool]

_BUFFER = """constexpr int kStampRows = %d;
constexpr int kPhases = %d;
__device__ unsigned long long g_stamps[kStampRows * kPhases];
"""
_READER = """
extern "C" int dcf_read_stamps(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps,
                                   n * sizeof(unsigned long long));
}
"""


def block_record(n: int) -> str:
    """Kernel text that takes the last of n + 1 stamps `tt` after a block
    barrier, and has thread 0 store the block's n phase lengths (row:
    the block's linear index)."""
    return (f"  __syncthreads();\n  tt[{n}] = clock64();\n"
            "  if (threadIdx.x == 0) {\n"
            "    const int bl = (blockIdx.z * gridDim.y + blockIdx.y) * "
            "gridDim.x + blockIdx.x;\n"
            "    if (bl < kStampRows)\n"
            "      for (int q = 0; q < kPhases; ++q)\n"
            "        g_stamps[bl * kPhases + q] = tt[q + 1] - tt[q];\n"
            "  }\n")


def stamped_source(src: str, rows: int, phases: int,
                   inserts: Iterable[Insert], prelude: str = "",
                   exports: str = "") -> str:
    """`src` with the inserts made, the stamp buffer and `prelude` ahead
    of its anonymous namespace, and the reader and `exports` at its
    end."""
    for anchor, text, after in inserts:
        src = _cuda.insert_at(src, anchor, text, after)
    src = _cuda.insert_at(src, "namespace {\n",
                          _BUFFER % (rows, phases) + prelude, after=False)
    return src + _READER + exports


def build(source: str, name: str, rows: int, phases: int,
          inserts: Iterable[Insert], prelude: str = "", exports: str = "",
          signatures: Optional[dict] = None) -> ctypes.CDLL:
    """The stamped copy of `csrc/<source>`, built as `lib<name>.so` and
    loaded, with the C signatures of `signatures` and of the reader."""
    inserts = tuple(inserts)
    return _cuda.build_copy(
        source, name,
        lambda src: stamped_source(src, rows, phases, inserts, prelude,
                                   exports),
        {"dcf_read_stamps": (ctypes.c_void_p, ctypes.c_int),
         **(signatures or {})})


def read(lib: ctypes.CDLL, rows: int, phases: int) -> np.ndarray:
    """The first `rows` x `phases` entries of the stamp buffer, float64."""
    buf = (ctypes.c_ulonglong * (rows * phases))()
    _cuda.check(lib.dcf_read_stamps(buf, rows * phases), "dcf_read_stamps")
    return np.array(buf[:], dtype=np.float64).reshape(rows, phases)
