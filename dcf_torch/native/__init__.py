"""The port's compiled host core (`kitti_io.cpp`), built with `g++` and
loaded with ctypes.

At first use the source is compiled into `dcf_torch/_build/` under a name
stamped with a hash of the source, the flags, the compiler's version line
and the machine, so a library built for another CPU or from another
source is never loaded; the build writes a temporary file and renames it,
so processes that build at once do not clash. The flags keep `g++` from
fusing a multiply and an add (`-ffp-contract=off`) and from tuning for the
building CPU (no `-march=native`). A missing compiler, a failed build or a
failed load raises `RuntimeError`: nothing falls back to numpy quietly.

The library is loaded with `ctypes.CDLL`, so every call releases the GIL
and the loader's threads run in parallel. Each wrapper below names the
numpy function that is its plain version; the tests hold every entry
point to it bit for bit (the IoUs within 1e-9).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "kitti_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX = "g++"
FLAGS = ("-std=c++17", "-O3", "-ffp-contract=off", "-shared", "-fPIC")

_P, _I64, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# C signatures: name -> (return type, argument types)
_SIGNATURES = {
    # pts, n, roi, max_points, stride, out, mask
    "dcf_crop_pad": (ctypes.c_int, (_P, _I64, _P, _I64, _I64, _P, _P)),
    # boxes_a, n, boxes_b, m, out
    "dcf_rotated_iou_bev": (None, (_P, _I64, _P, _I64, _P)),
    "dcf_iou_3d": (None, (_P, _I64, _P, _I64, _P)),
    # xyz, n, boxes, cs, m, any_box, out
    "dcf_points_in_boxes3d": (None, (_P, _I64, _P, _P, _I64, _I64, _P)),
    # overlaps, n_det, n_gt, scores, ignored_gt, ignored_det, dc, n_dc,
    # min_overlap, thresholds, n_thresh, gt_alphas, dt_alphas, tp, fp,
    # fn, sim
    "dcf_eval_statistics": (None, (_P, _I64, _I64, _P, _P, _P, _P, _I64,
                                   _D, _P, _I64, _P, _P, _P, _P, _P, _P)),
    # pts, mask, uvz, P, strides, S, x_min, y_min, voxel, grid_x, grid_y,
    # img_h, img_w, ranks
    "dcf_fusion_ranks": (None, (_P, _P, _P, _I64, _P, _I64, _D, _D, _D,
                                _I64, _I64, _I64, _I64, _P)),
    # uvw, P, uvz
    "dcf_uvw_to_uvz": (None, (_P, _I64, _P)),
    # img, h2, w2, H, W, out
    "dcf_image_s2d_u8": (None, (_P, _I64, _I64, _I64, _I64, _P)),
    # img, h, w, h2, w2, H, W, out
    "dcf_image_resize_s2d_u8": (None, (_P, _I64, _I64, _I64, _I64, _I64,
                                       _I64, _P)),
    # pts, mask, P, x_min, y_min, voxel, fine, grid_x, grid_y, out, out_mask
    "dcf_sort_points_fine": (None, (_P, _P, _I64, _D, _D, _D, _I64, _I64,
                                    _I64, _P, _P)),
    # raw, height, rowbytes, bpp, out
    "dcf_png_unfilter": (ctypes.c_int, (_P, _I64, _I64, _I64, _P)),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def compiler_version(cxx: Optional[str] = None) -> str:
    """The first line of `<cxx> --version`; RuntimeError without it."""
    cxx = cxx or CXX
    try:
        res = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60)
    except OSError as e:
        raise RuntimeError(f"host compiler {cxx!r} not found: {e}; the "
                           f"port's host core is built with it") from None
    if res.returncode != 0 or not res.stdout.strip():
        raise RuntimeError(f"{cxx} --version failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    return res.stdout.strip().splitlines()[0]


def library_path(cxx: Optional[str] = None,
                 flags: Optional[Sequence[str]] = None) -> str:
    """Where the library built from SOURCE with `cxx` and `flags` lives:
    its name carries a hash of the source, the flags, the compiler's
    version line and the machine."""
    cxx = cxx or CXX
    flags = FLAGS if flags is None else tuple(flags)
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    for part in (" ".join(flags), compiler_version(cxx), platform.machine()):
        h.update(b"\0" + part.encode())
    name = f"libdcf_torch_host_{h.hexdigest()[:16]}.so"
    return os.path.join(BUILD_DIR, name)


def build(cxx: Optional[str] = None,
          flags: Optional[Sequence[str]] = None) -> str:
    """Compile SOURCE into `library_path(cxx, flags)` (to a temporary name,
    then renamed) and return the path. Raises RuntimeError with the
    compiler's output when it fails."""
    cxx = cxx or CXX
    flags = FLAGS if flags is None else tuple(flags)
    path = library_path(cxx, flags)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *flags, "-o", tmp, SOURCE]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"host compiler {cxx!r} not found: {e}") from None
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{cxx} failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded host core, built first if its stamped file is missing."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"cannot load the host core {path} "
                                   f"(built by {CXX}): {e}") from None
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _lib = lib
        return _lib


def _c(a: np.ndarray, dtype, shape: Optional[Tuple] = None) -> np.ndarray:
    """`a` as a C-contiguous array of `dtype`; with `shape` (None for any
    length on that axis), raises ValueError unless it has that shape."""
    a = np.ascontiguousarray(a, dtype)
    if shape is not None and (a.ndim != len(shape) or any(
            n is not None and d != n for d, n in zip(a.shape, shape))):
        raise ValueError(f"expected an array of shape {shape}, got "
                         f"{a.shape}")
    return a


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data


def crop_pad(points: np.ndarray, roi: Sequence[float], max_points: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """ROI crop + pad of `points [N, C>=3]`: (out [max_points, 4] f32,
    mask [max_points] bool), the kept points first in their order
    (plain: `data.voxelize.crop_and_pad_plain` without subsampling)."""
    pts = _c(points, np.float32, (None, None))
    if pts.shape[1] < 3:
        raise ValueError(f"crop_pad takes [N, >=3] points, got {pts.shape}")
    roi_arr = _c(roi, np.float64, (6,))
    out = np.empty((max_points, 4), np.float32)
    mask = np.empty((max_points,), np.uint8)
    library().dcf_crop_pad(_ptr(pts), pts.shape[0], _ptr(roi_arr),
                           max_points, pts.shape[1], _ptr(out), _ptr(mask))
    return out, mask.view(bool)


def image_resize_s2d(image: np.ndarray, h2: int, w2: int, H: int, W: int
                     ) -> np.ndarray:
    """uint8 `image [h, w, 3]` resized to [h2, w2] (OpenCV's INTER_LINEAR
    arithmetic), letterboxed into [H, W] over 255 and space-to-depth(4)'d:
    [H/4, W/4, 48] f32 (plain: `data.preprocess.resize_bilinear`, the
    letterbox of `prepare_image`, then `s2d_image`)."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"image_resize_s2d takes uint8 [h, w, 3], got "
                         f"{img.dtype} {img.shape}")
    if H % 4 or W % 4 or H <= 0 or W <= 0 or h2 <= 0 or w2 <= 0:
        raise ValueError(f"resize to {h2}x{w2} in a letterbox of {H}x{W}: "
                         f"sizes must be positive, the letterbox a "
                         f"multiple of 4")
    img = _c(img, np.uint8)
    h, w = img.shape[:2]
    out = np.empty((H // 4, W // 4, 48), np.float32)
    library().dcf_image_resize_s2d_u8(_ptr(img), h, w, int(h2), int(w2),
                                      int(H), int(W), _ptr(out))
    return out


def sort_points_fine(points: np.ndarray, mask: np.ndarray, x_min: float,
                     y_min: float, voxel_size: float, fine: int,
                     grid_x: int, grid_y: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Stable fine-grid row-major counting sort of the padded cloud
    (plain: `data.preprocess.sort_points_host_plain`)."""
    pts = _c(points, np.float32, (None, 4))
    P = pts.shape[0]
    m = _c(mask, np.uint8, (P,))
    out = np.empty_like(pts)
    om = np.empty((P,), np.uint8)
    library().dcf_sort_points_fine(
        _ptr(pts), _ptr(m), P, float(x_min), float(y_min),
        float(voxel_size), int(fine), int(grid_x), int(grid_y), _ptr(out),
        _ptr(om))
    return out, om.view(bool)


def uvw_to_uvz(uvw: np.ndarray) -> np.ndarray:
    """Perspective divide of `uvw [P, 3]` f32 -> (u, v, depth) (plain:
    `data.preprocess.uvw_to_uvz_plain`)."""
    w = _c(uvw, np.float32, (None, 3))
    out = np.empty_like(w)
    library().dcf_uvw_to_uvz(_ptr(w), w.shape[0], _ptr(out))
    return out


def fusion_ranks(points: np.ndarray, mask: np.ndarray, uvz: np.ndarray,
                 strides: Sequence[int], x_min: float, y_min: float,
                 voxel_size: float, grid_x: int, grid_y: int, img_h: int,
                 img_w: int) -> np.ndarray:
    """Per-scale in-cell ranks by arrival order, [S, P] int32, -1 where a
    point is invalid for the scale (plain:
    `data.preprocess.fusion_ranks_plain`)."""
    pts = _c(points, np.float32, (None, 4))
    P = pts.shape[0]
    m = _c(mask, np.uint8, (P,))
    u = _c(uvz, np.float32, (P, 3))
    s = _c(strides, np.int32, (None,))
    ranks = np.empty((len(s), P), np.int32)
    library().dcf_fusion_ranks(
        _ptr(pts), _ptr(m), _ptr(u), P, _ptr(s), len(s), float(x_min),
        float(y_min), float(voxel_size), int(grid_x), int(grid_y),
        int(img_h), int(img_w), _ptr(ranks))
    return ranks


def _pairwise(name: str, width: int, boxes_a, boxes_b) -> np.ndarray:
    a = _c(boxes_a, np.float64, (None, width))
    b = _c(boxes_b, np.float64, (None, width))
    out = np.empty((len(a), len(b)), np.float64)
    getattr(library(), name)(_ptr(a), len(a), _ptr(b), len(b), _ptr(out))
    return out


def rotated_iou_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise rotated BEV IoU, [N, 5] x [M, 5] (x, y, dx, dy, yaw) ->
    [N, M] float64 (plain: `geometry.np_boxes.rotated_iou_bev`)."""
    return _pairwise("dcf_rotated_iou_bev", 5, boxes_a, boxes_b)


def iou_3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise 3D IoU of box7s, [N, 7] x [M, 7] -> [N, M] float64 (plain:
    `geometry.np_boxes.iou_3d`)."""
    return _pairwise("dcf_iou_3d", 7, boxes_a, boxes_b)


def points_in_boxes3d(points: np.ndarray, boxes7: np.ndarray,
                      any_box: bool = False) -> np.ndarray:
    """Whether each of `points [N, >=3]` lies inside each rotated box of
    `boxes7 [M, 7]` (x, y, z, dx, dy, dz, yaw): [N, M] bool, or with
    `any_box` [N] bool, inside any box (plain:
    `geometry.np_boxes.points_in_boxes3d`, then `.any(axis=1)`). The cos
    and sin of each yaw are numpy's, taken as the plain version takes
    them; points widen to float64 as its comparisons widen them."""
    pts = np.asarray(points)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"points_in_boxes3d takes [N, >=3] points, got "
                         f"{pts.shape}")
    xyz = _c(pts[:, :3], np.float64)
    boxes = _c(np.reshape(boxes7, (-1, 7)), np.float64)
    # the yaws in the plain version's layout (a column of an [M, 5] copy):
    # numpy may take another cos or sin loop, SIMD or scalar, for a stride
    yaw = boxes[:, [0, 1, 3, 4, 6]][:, 4]
    cs =_c(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1), np.float64)
    n, m = len(xyz), len(boxes)
    out = np.empty((n,) if any_box else (n, m), np.uint8)
    library().dcf_points_in_boxes3d(_ptr(xyz), n, _ptr(boxes), _ptr(cs), m,
                                    int(bool(any_box)), _ptr(out))
    return out.view(bool)


def eval_statistics(overlaps, dt_scores, ignored_gt, ignored_det,
                    dc_overlap, min_overlap: float, thresholds,
                    gt_alphas=None, dt_alphas=None):
    """The devkit's matching statistics of one frame at every threshold:
    (tp, fp, fn, sim), each [len(thresholds)] (plain:
    `eval.kitti_eval._frame_statistics`, once per threshold). Without
    alphas, or without DontCare columns, the C side gets null pointers."""
    thresholds = _c(thresholds, np.float64, (None,))
    scores = _c(dt_scores, np.float64, (None,))
    ig_gt = _c(ignored_gt, np.int32, (None,))
    n_det, n_gt = len(scores), len(ig_gt)
    ig_det = _c(ignored_det, np.int32, (n_det,))
    overlaps = _c(np.reshape(overlaps, (n_det, n_gt)), np.float64)
    dc, n_dc = None, 0
    if dc_overlap is not None and dc_overlap.size:
        dc = _c(dc_overlap, np.float64, (n_det, None))
        n_dc = dc.shape[1]
    ga = da = None
    if gt_alphas is not None and dt_alphas is not None:
        ga = _c(gt_alphas, np.float64, (n_gt,))
        da = _c(dt_alphas, np.float64, (n_det,))
    t = len(thresholds)
    tp, fp, fn = (np.zeros(t, np.int32) for _ in range(3))
    sim = np.zeros(t, np.float64)
    library().dcf_eval_statistics(
        _ptr(overlaps), n_det, n_gt, _ptr(scores), _ptr(ig_gt),
        _ptr(ig_det), _ptr(dc), n_dc, float(min_overlap), _ptr(thresholds),
        t, _ptr(ga), _ptr(da), _ptr(tp), _ptr(fp), _ptr(fn), _ptr(sim))
    return tp, fp, fn, sim


def png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of `rows [H, 1 + rowbytes]` uint8 (each row
    its filter byte, then its bytes) at `bpp` bytes per pixel: [H,
    rowbytes] uint8 (plain: `data.png._unfilter`)."""
    raw = _c(rows, np.uint8, (None, None))
    H, stride = raw.shape
    if not 1 <= bpp <= 8 or (stride - 1) % bpp:
        raise ValueError(f"PNG rows of {stride} bytes at {bpp} bytes per "
                         f"pixel")
    out = np.empty((H, stride - 1), np.uint8)
    if library().dcf_png_unfilter(_ptr(raw), H, stride - 1, int(bpp),
                                  _ptr(out)) != 0:
        raise ValueError(f"PNG row filter {int(raw[:, 0].max())} is not 0-4")
    return out
