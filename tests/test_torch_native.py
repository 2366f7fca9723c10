"""The port's compiled host core (`dcf_torch.native`) against its plain
numpy versions and against the JAX package's C++ core (`dcf.native`).

Every entry point is bit-equal to its plain version and to `dcf.native`'s
counterpart, except the rotated IoUs: they are bit-equal to `dcf.native`
(the same arithmetic) and within 1e-9 of the port's numpy
(`geometry.np_boxes`, whose clipping orders its float64 operations
otherwise). The build: its stamped name, and a failed build raises.
"""

import ctypes
import dataclasses
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

import dcf.config as jcfg
import dcf.data.preprocess as jpre
import dcf.data.voxelize as jvox
import dcf_torch.config as tcfg
import dcf_torch.data.preprocess as tpre
import dcf_torch.data.synthetic as tsyn
import dcf_torch.data.voxelize as tvox
import jax_native_lib
from dcf import native as jnative
from dcf_torch import native
from dcf_torch.data import png
from dcf_torch.eval import kitti_eval as tke
from dcf_torch.geometry import np_boxes

torch.set_num_threads(1)

CONFIGS = ["tiny_config", "multi_scale_config"]


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    """`dcf.native`'s library, built and loaded whole before any test
    compares with it (`jax_native_lib`)."""
    jax_native_lib.load()


def _frame(seed):
    return tsyn.make_varied_frame(seed=seed)


def _cropped(cfg, seed):
    f = _frame(seed)
    pts, mask = tvox.crop_and_pad_plain(f.points, cfg.voxel)
    return f, pts, mask


# ---- crop and pad ----

@pytest.mark.parametrize("cfg_name", CONFIGS)
@pytest.mark.parametrize("seed", [0, 3])
def test_crop_pad(cfg_name, seed):
    vox = getattr(tcfg, cfg_name)().voxel
    points = _frame(seed).points
    roi = (vox.x_min, vox.x_max, vox.y_min, vox.y_max, vox.z_min, vox.z_max)
    for cap in (vox.max_points, 1 << 17, 100):
        out, mask = native.crop_pad(points, roi, cap)
        j_out, j_mask = jnative.crop_pad(points, roi, cap)
        np.testing.assert_array_equal(out, j_out)
        np.testing.assert_array_equal(mask, j_mask)
        if not mask.all():                   # no overflow: plain agrees
            p_out, p_mask = tvox.crop_and_pad_plain(
                points, dataclasses.replace(vox, max_points=cap))
            np.testing.assert_array_equal(out, p_out)
            np.testing.assert_array_equal(mask, p_mask)
    assert not native.crop_pad(points, roi, 1 << 17)[1].all()
    assert native.crop_pad(points, roi, 100)[1].all()


@pytest.mark.parametrize("max_points,shuffle", [(24576, False), (300, False),
                                                (24576, True)])
def test_crop_and_pad_matches_jax(max_points, shuffle):
    """The entry point, compiled or (overflow, shuffle) numpy, against the
    JAX package's."""
    vox = dataclasses.replace(tcfg.multi_scale_config().voxel,
                              max_points=max_points)
    jvox_cfg = dataclasses.replace(jcfg.multi_scale_config().voxel,
                                   max_points=max_points)
    points = _frame(1).points
    got = tvox.crop_and_pad(points, vox, shuffle=shuffle, seed=5)
    want = jvox.crop_and_pad(points, jvox_cfg, shuffle=shuffle, seed=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- image ----

@pytest.mark.parametrize("h,w,h2,w2,H,W", [
    (375, 1242, 377, 1248, 384, 1248),      # KITTI into multi_scale_config
    (375, 1242, 96, 318, 96, 320),          # KITTI into tiny_config
    (37, 51, 80, 111, 64, 100),             # up, letterbox cuts rows
    (90, 70, 41, 29, 44, 40),               # down, s2d tail columns
    (33, 47, 33, 47, 36, 44),               # no resize: dcf_image_s2d_u8
    (20, 31, 20, 31, 16, 28),               # no resize, letterbox cuts
])
def test_image_resize_s2d(h, w, h2, w2, H, W):
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    got = native.image_resize_s2d(img, h2, w2, H, W)
    resized = (img if (h2, w2) == (h, w)
               else tpre.resize_bilinear(img, w2, h2))
    full = np.zeros((H, W, 3), np.float32)
    hc, wc = min(h2, H), min(w2, W)
    full[:hc, :wc] = resized[:hc, :wc].astype(np.float32) / 255.0
    np.testing.assert_array_equal(got, tpre.s2d_image(full))
    cv = (img if (h2, w2) == (h, w)
          else cv2.resize(img, (w2, h2), interpolation=cv2.INTER_LINEAR))
    np.testing.assert_array_equal(got, jnative.image_s2d_u8(cv, H, W))


@pytest.mark.parametrize("cfg_name", CONFIGS)
def test_prepare_image_s2d(cfg_name):
    cfg = getattr(tcfg, cfg_name)()
    image = _frame(4).image
    got, scale = tpre.prepare_image_s2d(image, cfg)
    full, want_scale = tpre.prepare_image(image, cfg)
    assert scale == want_scale
    np.testing.assert_array_equal(got, tpre.s2d_image(full))
    j, j_scale = jpre.prepare_image_s2d(image, getattr(jcfg, cfg_name)())
    assert j_scale == scale
    np.testing.assert_array_equal(got, j)


def test_image_resize_s2d_refuses_other_images():
    with pytest.raises(ValueError, match="uint8"):
        native.image_resize_s2d(np.zeros((8, 8, 3), np.float32), 8, 8, 8, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        native.image_resize_s2d(np.zeros((8, 8, 3), np.uint8), 8, 8, 8, 6)


@pytest.mark.parametrize("call", [
    lambda: native.crop_pad(np.zeros((5, 2), np.float32), (0,) * 6, 8),
    lambda: native.crop_pad(np.zeros((5, 4), np.float32), (0,) * 5, 8),
    lambda: native.sort_points_fine(np.zeros((5, 3), np.float32),
                                    np.ones(5, bool), 0, 0, 1, 1, 4, 4),
    lambda: native.sort_points_fine(np.zeros((5, 4), np.float32),
                                    np.ones(4, bool), 0, 0, 1, 1, 4, 4),
    lambda: native.uvw_to_uvz(np.zeros((5, 4), np.float32)),
    lambda: native.fusion_ranks(np.zeros((5, 4), np.float32),
                                np.ones(5, bool), np.zeros((4, 3)), [2],
                                0, 0, 1, 4, 4, 8, 8),
    lambda: native.iou_3d(np.zeros((2, 5)), np.zeros((2, 7))),
    lambda: native.points_in_boxes3d(np.zeros((5, 2)), np.zeros((1, 7))),
    lambda: native.eval_statistics(np.zeros((3, 2)), np.zeros(3),
                                   np.zeros(2), np.zeros(2), None, 0.5,
                                   [0.5]),
    lambda: native.eval_statistics(np.zeros((3, 2)), np.zeros(3),
                                   np.zeros(2), np.zeros(3), None, 0.5,
                                   [0.5], np.zeros(2), np.zeros(2)),
    lambda: native.png_unfilter(np.zeros((2, 8), np.uint8), 3),
    lambda: native.image_resize_s2d(np.zeros((8, 8, 3), np.uint8), 0, 8,
                                    8, 8),
])
def test_wrappers_refuse_wrong_shapes(call):
    """Sizes are checked in Python before a pointer reaches the C side."""
    with pytest.raises(ValueError):
        call()


# ---- fine-grid sort, projection, ranks ----

@pytest.mark.parametrize("cfg_name", CONFIGS)
@pytest.mark.parametrize("seed", [0, 5])
def test_sort_points_fine(cfg_name, seed):
    cfg = getattr(tcfg, cfg_name)()
    _, pts, mask = _cropped(cfg, seed)
    got = tpre.sort_points_host(pts, mask, cfg)
    want = tpre.sort_points_host_plain(pts, mask, cfg)
    vox, fine = cfg.voxel, min(cfg.backbone.fusion_strides)
    j = jnative.sort_points_fine(pts, mask, vox.x_min, vox.y_min,
                                 vox.voxel_size, fine, vox.grid_x, vox.grid_y)
    for g, w, jj in zip(got, want, j):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, jj)


def test_uvw_to_uvz():
    rng = np.random.default_rng(7)
    uvw = rng.normal(0, 50, (4000, 3)).astype(np.float32)
    uvw[::7, 2] = 0.0                              # sign 0
    uvw[1::7, 2] = rng.uniform(-1e-6, 1e-6, len(uvw[1::7]))   # den clamp
    got = native.uvw_to_uvz(uvw)
    np.testing.assert_array_equal(got, tpre.uvw_to_uvz_plain(uvw))
    np.testing.assert_array_equal(got, jnative.uvw_to_uvz(uvw))


@pytest.mark.parametrize("cfg_name", CONFIGS)
@pytest.mark.parametrize("seed", [1, 6])
def test_fusion_host_arrays(cfg_name, seed):
    """Compiled divide and ranks against the plain version, and the ranks
    against `dcf.native.fusion_ranks(...)[0]`."""
    cfg = getattr(tcfg, cfg_name)()
    f, pts, mask = _cropped(cfg, seed)
    pts, mask = tpre.sort_points_host(pts, mask, cfg)
    v2i = f.calib.velo_to_image_matrix.astype(np.float32)
    v2i[:2] *= tpre._fit_size(f.image.shape, cfg)[2]
    got = tpre.fusion_host_arrays(pts, mask, v2i, cfg)
    want = tpre.fusion_host_arrays_plain(pts, mask, v2i, cfg)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got["fusion_rank"] >= 0).sum() > 0
    vox = cfg.voxel
    jcf = getattr(jcfg, cfg_name)()
    from dcf.models.fusion import fusion_row_cum_len
    j = jnative.fusion_ranks(pts, mask, got["points_uvz"],
                             cfg.backbone.fusion_strides, vox.x_min,
                             vox.y_min, vox.voxel_size, vox.grid_x,
                             vox.grid_y, cfg.image.height, cfg.image.width,
                             fusion_row_cum_len(jcf))
    np.testing.assert_array_equal(got["fusion_rank"], j[0])


# ---- points inside boxes (gt-sampling) ----

def _sweep(seed, total=120_000):
    """A `make_varied_frame` sweep padded to `total` points as the
    benchmark's traffic pads one (thirds behind the vehicle, beyond the
    ROI and above it), then shuffled."""
    f = _frame(seed)
    rng = np.random.default_rng([11, seed])
    n = total - len(f.points)
    k = [n // 3, n // 3, n - 2 * (n // 3)]
    pad = np.concatenate([
        rng.uniform([-70.0, -40.0, -2.5], [-0.5, 40.0, 0.5], (k[0], 3)),
        rng.uniform([71.0, -60.0, -2.5], [120.0, 60.0, 0.5], (k[1], 3)),
        rng.uniform([0.5, -39.0, 1.2], [69.0, 39.0, 3.0], (k[2], 3))])
    pad = np.concatenate([pad, rng.uniform(0, 1, (n, 1))], -1)
    pts = np.concatenate([f.points, pad.astype(np.float32)])
    return dataclasses.replace(f, points=pts[rng.permutation(len(pts))])


def _on_faces_and_corners(boxes7, per_box=400, seed=0):
    """float32 points placed on each box's faces, edges and corners (the
    local coordinates +-h or on the slab's planes, rotated and rounded to
    float32), and a hair inside and outside them."""
    rng = np.random.default_rng(seed)
    out = []
    for x, y, z, dx, dy, dz, yaw in np.asarray(boxes7, np.float64):
        h = np.array([dx, dy, dz]) * 0.5
        loc = rng.uniform(-1, 1, (per_box, 3)) * h
        axis = rng.integers(0, 3, per_box)
        loc[np.arange(per_box), axis] = np.sign(
            rng.uniform(-1, 1, per_box)) * h[axis]
        loc[: per_box // 4] = (np.sign(rng.uniform(-1, 1, (per_box // 4, 3)))
                               * h)                          # corners
        loc *= rng.choice([1.0, 1 - 1e-7, 1 + 1e-7], (per_box, 1))
        c, s = np.cos(yaw), np.sin(yaw)
        out.append(np.stack([x + c * loc[:, 0] - s * loc[:, 1],
                             y + s * loc[:, 0] + c * loc[:, 1],
                             z + loc[:, 2]], -1))
    pts = np.concatenate(out).astype(np.float32)
    return np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], -1)


def _pib_case(name):
    """(points [N, 4] f32, boxes [M, 7] f32) of one case."""
    rng = np.random.default_rng(7)
    if name.startswith("random"):
        m = int(name.split("-")[1])
        return _sweep(3).points, _boxes7(rng, m).astype(np.float32)
    if name == "faces":
        boxes = np.array([(10, 5, -1, 4, 2, 1.5, 0),
                          (20.5, -3.25, -0.75, 3.9, 1.6, 1.56, 0.3),
                          (7, 7, -1.2, 0.8, 0.6, 1.7, -2.2)],
                         np.float32)
        boxes = np.concatenate([boxes, _boxes7(rng, 5).astype(np.float32)])
        return _on_faces_and_corners(boxes), boxes
    if name == "yaws":
        yaws = [0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi]
        yaws += [np.nextafter(np.float32(a), d) for a in yaws
                 for d in (np.float32(-4), np.float32(4))]
        boxes = np.array([(3 * i, -2.0 * i, -1.0, 4.0, 1.5, 1.5, a)
                          for i, a in enumerate(yaws)], np.float32)
        return _on_faces_and_corners(boxes, seed=1), boxes
    if name == "rounding":
        # float64: box j's corner is where the plain version's rounding
        # puts point j, so any other rounding of the rotation misses it
        n = 300
        pts = np.concatenate([rng.uniform(-40, 40, (n, 2)),
                              rng.uniform(-2, 0, (n, 1)), np.zeros((n, 1))],
                             -1)
        boxes = np.zeros((n, 7))
        boxes[:, :2] = pts[:, :2] + rng.uniform(-3, 3, (n, 2))
        boxes[:, 2], boxes[:, 5] = -1.0, 4.0
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
        rel = pts[:, :2] - boxes[:, :2]
        c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
        boxes[:, 3] = 2 * np.abs(rel[:, 0] * c + rel[:, 1] * s)
        boxes[:, 4] = 2 * np.abs(-rel[:, 0] * s + rel[:, 1] * c)
        return pts, boxes
    if name == "zero-size":
        boxes = np.array([(1, 2, -1, 0, 0, 0, 0.4),
                          (4, 4, -1, 0, 2, 1, 0),
                          (6, 6, -1, 2, 2, 0, 1.1),
                          (8, 8, -1, 3, 1, 1, 0)], np.float32)
        pts = np.array([[1, 2, -1, 0], [4, 4, -1, 0], [4, 4.5, -0.8, 0],
                        [6, 6, -1, 0], [6.5, 6, -1, 0], [8, 8, -1, 0]],
                       np.float32)
        return pts, boxes
    if name == "non-finite":
        boxes = np.array([(0, 0, 0, 2, 2, 2, 0),
                          (5, 0, 0, np.inf, 2, 2, 0),
                          (0, 5, 0, 2, np.nan, 2, 0),
                          (9, 9, 0, 2, 2, 2, np.nan)], np.float32)
        pts = np.array([[0, 0, 0, 0], [np.nan, 0, 0, 0], [0, 0, np.nan, 0],
                        [np.inf, 0, 0, 0], [50, 0, 0, 0], [5, 0.5, 0.5, 0],
                        [0, 5, 0, 0], [9, 9, 0, 0]], np.float32)
        return pts, boxes
    if name == "empty-points":
        return np.zeros((0, 4), np.float32), _boxes7(rng, 3)
    raise KeyError(name)


@pytest.mark.parametrize("case", ["random-0", "random-1", "random-30",
                                  "faces", "yaws", "rounding", "zero-size",
                                  "non-finite", "empty-points"])
def test_points_in_boxes3d(case):
    """The compiled test, for every pair and as the union over boxes, bit
    for bit against `np_boxes.points_in_boxes3d`."""
    points, boxes = _pib_case(case)
    with np.errstate(invalid="ignore"):
        want = np_boxes.points_in_boxes3d(points[:, :3], boxes)
    got = native.points_in_boxes3d(points[:, :3], boxes)
    assert got.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    got_any = native.points_in_boxes3d(points, boxes, any_box=True)
    np.testing.assert_array_equal(got_any, want.any(axis=1))
    if case in ("faces", "yaws"):            # both answers on the faces
        assert 0.2 < want.any(axis=1).mean() < 0.95
    if case == "random-30":
        assert want.any(axis=1).sum() > 100
    if case == "rounding":                   # every point in its own box
        assert want[np.arange(len(want)), np.arange(len(want))].all()


def test_points_in_boxes3d_gt_sampling_matches_plain(monkeypatch):
    """`GTDatabase.build` and `gt_sample_frame` with the compiled test give
    the databases and frames of the plain numpy test, array for array, on
    120,000-point sweeps at two seeds."""
    import dcf_torch.data.augment as taug

    def plain(points, boxes7, any_box=False):
        inside = np_boxes.points_in_boxes3d(points, boxes7)
        return inside.any(axis=1) if any_box else inside

    aug = tcfg.lidar_only_config().augment
    for seed in (0, 1):
        pool = [_sweep(100 * seed + i) for i in range(6)]
        frames = [_sweep(100 * seed + 50 + i) for i in range(3)]
        results = []
        for fn in (native.points_in_boxes3d, plain):
            monkeypatch.setattr(native, "points_in_boxes3d", fn)
            db = taug.GTDatabase.build(pool)
            out = [taug.gt_sample_frame(f, db, aug,
                                        np.random.default_rng([seed, i]))
                   for i, f in enumerate(frames)]
            results.append((db, out))
        (db, out), (db_p, out_p) = results
        assert list(db.db) == list(db_p.db)
        for name in db.db:
            assert len(db.db[name]) == len(db_p.db[name])
            for e, e_p in zip(db.db[name], db_p.db[name]):
                assert set(e) == set(e_p)
                for key in e:
                    np.testing.assert_array_equal(e[key], e_p[key])
        for f, f_p, src in zip(out, out_p, frames):
            assert len(f.boxes) > len(src.boxes)      # it pasted some
            assert len(f.points) != len(src.points)
            for field in ("points", "image", "boxes", "labels", "difficulty",
                          "truncated", "occluded", "alpha", "bbox2d"):
                np.testing.assert_array_equal(getattr(f, field),
                                              getattr(f_p, field),
                                              err_msg=field)
            assert f.names == f_p.names


# ---- evaluation ----

def _boxes7(rng, n):
    return np.stack([rng.uniform(0, 12, n), rng.uniform(-6, 6, n),
                     rng.uniform(-1.5, -0.5, n), rng.uniform(0.5, 4.5, n),
                     rng.uniform(0.4, 2.0, n), rng.uniform(1.0, 2.0, n),
                     rng.uniform(-np.pi, np.pi, n)], -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ious(seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes7(rng, 40), _boxes7(rng, 30)
    b[:5] = a[:5]                                   # identical pairs
    b[5, 6] = a[5, 6] + np.pi / 2                   # rotated copy
    bev_a, bev_b = a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]]
    bev = native.rotated_iou_bev(bev_a, bev_b)
    iou = native.iou_3d(a, b)
    assert (bev > 0).sum() > 30 and (iou > 0).sum() > 30
    np.testing.assert_array_equal(bev, jnative.rotated_iou_bev(bev_a, bev_b))
    np.testing.assert_array_equal(iou, jnative.iou_3d(a, b))
    np.testing.assert_allclose(bev, np_boxes.rotated_iou_bev(bev_a, bev_b),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(iou, np_boxes.iou_3d(a, b), rtol=0, atol=1e-9)
    assert native.iou_3d(a[:0], b).shape == (0, 30)


@pytest.mark.parametrize("alphas", [True, False])
@pytest.mark.parametrize("dontcare", [True, False])
def test_eval_statistics(alphas, dontcare):
    """All thresholds in one call against `_frame_statistics` at each, and
    against `dcf.native.eval_statistics`; without alphas or DontCare
    columns the C side gets null pointers."""
    rng = np.random.default_rng(2 * alphas + dontcare)
    for _ in range(30):
        d, g = (int(v) for v in rng.integers(0, 15, 2))
        overlaps = rng.uniform(0, 1, (d, g))
        scores = rng.uniform(0, 1, d)
        ig_gt = rng.choice([-1, 0, 1], g).astype(np.int64)
        ig_det = rng.choice([-1, 0, 1], d).astype(np.int64)
        dc = (rng.uniform(0, 1, (d, int(rng.integers(0, 3))))
              if dontcare else None)
        ga, da = ((rng.uniform(-3, 3, g), rng.uniform(-3, 3, d))
                  if alphas else (None, None))
        thresholds = np.sort(rng.uniform(0, 1, 6))[::-1]
        got = native.eval_statistics(overlaps, scores, ig_gt, ig_det, dc,
                                     0.5, thresholds, ga, da)
        want = jnative.eval_statistics(overlaps, scores, ig_gt, ig_det, dc,
                                       0.5, thresholds, gt_alphas=ga,
                                       dt_alphas=da)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
        for i, thr in enumerate(thresholds):
            plain = tke._frame_statistics(overlaps, scores, ig_gt, ig_det,
                                          dc, 0.5, thr, gt_alphas=ga,
                                          dt_alphas=da)
            assert plain == (got[0][i], got[1][i], got[2][i], got[3][i])


# ---- PNG row filters ----

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(pix, ftypes):
    """[H, 1 + W*C] filtered rows of uint8 `pix [H, W, C]`."""
    H, W, C = pix.shape
    x = pix.reshape(H, W * C).astype(np.int32)
    a = np.zeros_like(x)
    a[:, C:] = x[:, :-C]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, C:] = x[:-1, :-C]
    preds = (0 * x, a, b, (a + b) >> 1, _paeth(a, b, c))
    rows = np.stack([(x[r] - preds[t][r]) % 256 for r, t in
                     enumerate(ftypes)]).astype(np.uint8)
    return np.concatenate([np.asarray(ftypes, np.uint8)[:, None], rows], 1)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_png_unfilter(bpp, ftype):
    rng = np.random.default_rng(bpp * 10 + (5 if ftype == "mixed" else ftype))
    H, W = 13, 29
    pix = rng.integers(0, 256, (H, W, bpp), np.uint8)
    pix[: H // 2] //= 8                           # small values beside noise
    ftypes = (rng.integers(0, 5, H) if ftype == "mixed" else [ftype] * H)
    rows = _filter(pix, ftypes)
    got = native.png_unfilter(rows, bpp).reshape(H, W, bpp)
    np.testing.assert_array_equal(got, pix)
    plain = png._unfilter(rows[:, 1:].reshape(H, W, bpp), rows[:, 0])
    np.testing.assert_array_equal(got, plain)


def test_png_unfilter_one_pixel_rows_and_bad_filter():
    pix = np.arange(6, dtype=np.uint8).reshape(6, 1, 1) * 40
    rows = _filter(pix, [4, 3, 2, 1, 0, 4])
    np.testing.assert_array_equal(
        native.png_unfilter(rows, 1).reshape(6, 1, 1), pix)
    rows[2, 0] = 5
    with pytest.raises(ValueError, match="filter 5"):
        native.png_unfilter(rows, 1)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decode_kitti_sized_png(ftype):
    """A 375x1242 RGB file, every row with one filter: compiled and plain
    decodes equal to the pixels."""
    image = tsyn.make_frame(seed=2).image
    data = (png._SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 1242, 375, 8, 2,
                                              0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(
                _filter(image, [ftype] * 375).tobytes(), 1))
            + png._chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode_png(data), image)
    np.testing.assert_array_equal(png.decode_png_plain(data), image)


# ---- the build ----

def test_library_is_loaded_with_cdll():
    """CDLL (not PyDLL): each call releases the GIL."""
    lib = native.library()
    assert type(lib) is ctypes.CDLL
    assert lib._name == native.library_path()


def test_stamped_name_follows_flags_and_source(tmp_path, monkeypatch):
    base = native.library_path()
    assert base.startswith(native.BUILD_DIR)
    assert native.library_path(flags=native.FLAGS) == base
    assert native.library_path(flags=native.FLAGS + ("-g",)) != base
    assert native.library_path(flags=("-O2",) + native.FLAGS[1:]) != base
    assert "-ffp-contract=off" in native.FLAGS
    assert not any(f.startswith("-march") for f in native.FLAGS)
    src = tmp_path / "kitti_io.cpp"
    src.write_bytes(open(native.SOURCE, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    assert native.library_path() != base


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.library()
    with pytest.raises(RuntimeError, match="no-such-g"):
        tpre.prepare_image_s2d(_frame(0).image, tcfg.tiny_config())
    assert list(tmp_path.iterdir()) == []


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no-such-flag") as err:
        native.build(flags=native.FLAGS + ("-fno-such-flag",))
    assert "g++" in str(err.value)
    assert list(tmp_path.iterdir()) == []          # no temporary left
