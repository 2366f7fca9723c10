"""Build and load the port's CUDA kernels.

All `dcf_torch/csrc/*.cu` sources are compiled by ONE `nvcc` call for
`sm_90a` into a shared library with a plain C interface (no PyTorch
headers: a few seconds instead of minutes), written to
`dcf_torch/_build/` and loaded with ctypes at first use. The library is
rebuilt when a source is newer than it. Each C entry point launches on
the stream it is given and returns `cudaGetLastError()`; `check` turns
a non-zero code into an exception.

`--fmad=false` keeps nvcc from contracting a multiply and an add into
one FMA: the kernels then round every operation as PyTorch's eager
elementwise ops do, so they agree with their plain versions bit for bit
wherever the order of operations is the same.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libdcf_torch_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argument types (all return int, a cudaError_t)
_SIGNATURES = {
    # data, valid, z1, wgt, bg, out, B, H, W, C, P, hid, K, r,
    # origin_x, origin_y, cell, stream
    "dcf_fusion_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _I, _F, _F, _F, _P),
    # boxes_a, boxes_b, out, n, stream
    "dcf_clip_pairs": (_P, _P, _P, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def build(verbose: bool = False) -> str:
    """Compile every source into LIB_PATH (atomically). Returns nvcc's
    output (with `-Xptxas -v` when verbose: registers, spills)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
    return res.stdout + res.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.dcf_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dcf_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if err != 0:
        what = library().dcf_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {what}")
