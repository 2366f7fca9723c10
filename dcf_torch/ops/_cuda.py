"""Build and load the port's CUDA kernels.

Every `dcf_torch/csrc/*.cu` source is compiled for `sm_90a` by its own
`nvcc` process, all started together, and one more `nvcc` call links the
objects into a shared library with a plain C interface (no PyTorch
headers: seconds instead of minutes), written to `dcf_torch/_build/`
and loaded with ctypes at first use. The library is
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "--fmad=false",
                              "-Xcompiler", "-fPIC", "-c")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argument types (all return int, a cudaError_t)
_SIGNATURES = {
    # data, valid, z1, wgt, bg, out, stash_sel, stash_geo (both null when
    # serving), B, H, W, C, P, hid, K, r, lanes, tile_h, tile_w,
    # origin_x, origin_y, cell, stream
    "dcf_fusion_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _F, _F, _F, _P),
    # sel, geo, z1, wgt, bg, dacc, dacc row stride, dz1, dwgt, dbg,
    # scratch (cnt, lists, feats, partials), B, H, W, K, P, hid, blocks,
    # stream
    "dcf_fusion_bwd": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                       _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # boxes_a, boxes_b, out, n, stream
    "dcf_clip_pairs": (_P, _P, _P, _I, _P),
    # data, valid, nbr, ok, dist2, B, H, W, C, D, K, r, lanes, tile_h,
    # tile_w, origin_x, origin_y, cell, stream
    "dcf_knn_select": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _F, _F, _F, _P),
    # slab, oh transposed, out, blocks, stream
    "dcf_selection_mma_int8": (_P, _P, _P, _I, _P),
    "dcf_selection_mma_bf16": (_P, _P, _P, _I, _P),
    # points, mask, first, scratch, coords, counts, pmask, table, stats,
    # B, n, gx, gy, P, N, x_min, y_min, z_min, z_max, inv, stream
    "dcf_pillarize": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _F, _F, _F, _F, _F, _P),
    # points, table, counts, pmask, coords, weight, bias, canvas, out_bf16,
    # B, n, P, N, C, gx, gy, x_min, y_min, voxel_size, stream
    "dcf_pfn_scatter": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _F, _F, _F, _P),
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


def _run(procs, cmds):
    """Wait for every process; raise with the output of the first that
    failed. Returns the processes' joined output."""
    outs = [p.communicate() for p in procs]
    for p, cmd, (out, err) in zip(procs, cmds, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}\n{err}")
    return "".join(out + err for out, err in outs)


def build(verbose: bool = False) -> str:
    """Compile every source into LIB_PATH (atomically): one nvcc process
    per source, all at once, then one link. Returns nvcc's output (with
    `-Xptxas -v` when verbose: registers, spills)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    extra = ["-Xptxas", "-v"] if verbose else []
    objs, cmds = [], []
    for src in sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        cmds.append([nvcc, *extra, *COMPILE_FLAGS, "-o", obj, src])
    try:
        log = _run([subprocess.Popen(c, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                    for c in cmds], cmds)
        tmp = f"{LIB_PATH}.{tag}"
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
        log += _run([subprocess.Popen(link, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)],
                    [link])
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return log


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


def insert_at(src: str, anchor: str, text: str, after: bool = True) -> str:
    """`src` with `text` inserted after (or before) `anchor`, which must
    occur exactly once: the edits that tools make to a copy of a source."""
    if src.count(anchor) != 1:
        raise RuntimeError(f"anchor not found exactly once: {anchor!r}")
    return src.replace(anchor, anchor + text if after else text + anchor)


def build_copy(source: str, name: str, transform,
               signatures: Optional[dict] = None) -> ctypes.CDLL:
    """Build `transform(text of csrc/<source>)` alone into
    `BUILD_DIR/lib<name>.so` and load it, with the C signatures of the
    library's entry points that it defines and `signatures` (name ->
    argument types, returning int) set: a variant of one kernel beside
    the library, for tools that stamp or time it. Its includes resolve
    against `csrc/`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    with open(os.path.join(CSRC, source)) as f:
        text = transform(f.read())
    with open(cu, "w") as f:
        f.write(text)
    flags = [f for f in COMPILE_FLAGS if f != "-c"] + ["-I", CSRC]
    subprocess.run([_nvcc(), *flags, "-shared", "-o", so, cu], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    for fn_name, argtypes in {**_SIGNATURES, **(signatures or {})}.items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def sm_count(device) -> int:
    """The number of streaming multiprocessors of a CUDA device."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if err != 0:
        what = library().dcf_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {what}")
