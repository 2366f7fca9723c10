"""The PyTorch port's host path and BEV raster against the JAX package's.

Frames, calibration, anchors, crop/pad, the fine-grid sort and the
fusion projection/ranks are numpy in both packages with the same
formulas, so they must be bit-equal. The image resize stands in for
OpenCV's INTER_LINEAR (the port does not import cv2): it rounds a float
result where OpenCV uses 11-bit fixed point, so uint8 pixels may differ
by one level and no more. The raster is a torch scatter against a jnp
scatter: bit-equal in float32 (occupancy is exactly 0/1, and every cell
adds its intensities in point order in both).
"""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcf.config as jcfg
import dcf.data.preprocess as jpre
import dcf.data.synthetic as jsyn
import dcf.data.voxelize as jvox
import dcf.models.anchors as janc
import dcf_torch.config as tcfg
import dcf_torch.data.preprocess as tpre
import dcf_torch.data.synthetic as tsyn
import dcf_torch.data.voxelize as tvox
import dcf_torch.models.anchors as tanc

torch.set_num_threads(1)

FRAMES = [("make_frame", 0), ("make_frame", 3), ("make_varied_frame", 0),
          ("make_varied_frame", 1), ("make_varied_frame", 2)]


def _frames(fn, seed):
    return getattr(jsyn, fn)(seed=seed), getattr(tsyn, fn)(seed=seed)


@pytest.mark.parametrize("fn,seed", FRAMES)
def test_frames_bit_equal(fn, seed):
    a, b = _frames(fn, seed)
    for key in ("points", "image", "boxes", "labels", "difficulty", "bbox2d"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key),
                                      err_msg=key)
    assert a.names == b.names
    np.testing.assert_array_equal(a.calib.velo_to_image_matrix,
                                  b.calib.velo_to_image_matrix)


def test_calibration_transforms_equal():
    a, b = _frames("make_frame", 0)
    pts = a.points[:100, :3].astype(np.float64)
    np.testing.assert_array_equal(a.calib.velo_to_image(pts),
                                  b.calib.velo_to_image(pts))
    np.testing.assert_array_equal(a.calib.rect_to_velo(pts),
                                  b.calib.rect_to_velo(pts))
    np.testing.assert_array_equal(
        a.calib.flip_horizontal(1242).velo_to_image_matrix,
        b.calib.flip_horizontal(1242).velo_to_image_matrix)


@pytest.mark.parametrize("name", ["lidar_only_config", "camera_config",
                                  "fusion_single_scale_config",
                                  "multi_scale_config", "tiny_config"])
def test_config_fields_match(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)

    def common(a, b, path=""):
        for k, v in b.items():
            if isinstance(v, dict):
                common(a[k], v, path + k + ".")
            else:
                assert a[k] == v, path + k
    common(jd, td)
    assert tcfg.Config.from_json(t.to_json()) == t


@pytest.mark.parametrize("name", ["lidar_only_config", "multi_scale_config",
                                  "tiny_config"])
def test_anchors_equal(name):
    for a, b in zip(janc.generate_anchors(getattr(jcfg, name)()),
                    tanc.generate_anchors(getattr(tcfg, name)())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_points,shuffle", [(2048, False), (500, False),
                                                (2048, True)])
def test_crop_and_pad_equal(max_points, shuffle):
    frame = jsyn.make_frame(seed=1)
    j = jvox.crop_and_pad(frame.points, dataclasses.replace(
        jcfg.tiny_config().voxel, max_points=max_points), shuffle, seed=4)
    t = tvox.crop_and_pad(frame.points, dataclasses.replace(
        tcfg.tiny_config().voxel, max_points=max_points), shuffle, seed=4)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)


def _tiny_points(seed):
    frame = jsyn.make_varied_frame(seed=seed)
    return jvox.crop_and_pad(frame.points, jcfg.tiny_config().voxel), frame


@pytest.mark.parametrize("seed", [0, 5])
def test_sort_points_host_equal(seed):
    (pts, mask), _ = _tiny_points(seed)
    j = jpre.sort_points_host(pts, mask, jcfg.tiny_config())
    t = tpre.sort_points_host(pts, mask, tcfg.tiny_config())
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 5])
def test_fusion_host_arrays_equal(seed):
    (pts, mask), frame = _tiny_points(seed)
    pts, mask = tpre.sort_points_host(pts, mask, tcfg.tiny_config())
    v2i = frame.calib.velo_to_image_matrix.copy()
    v2i[:2] *= min(96 / 375, 320 / 1242)      # KITTI frame -> tiny image
    j = jpre.fusion_host_arrays(pts, mask, v2i, jcfg.tiny_config())
    t = tpre.fusion_host_arrays(pts, mask, v2i, tcfg.tiny_config())
    for key in ("points_uvz", "fusion_rank"):
        np.testing.assert_array_equal(j[key], t[key], err_msg=key)
    assert (t["fusion_rank"] >= 0).sum() > 0


@pytest.mark.parametrize("size", [(1248, 377), (320, 96), (900, 300),
                                  (2000, 604)])
def test_resize_within_one_level_of_cv2(size):
    image = tsyn.make_frame(seed=0).image
    want = cv2.resize(image, size, interpolation=cv2.INTER_LINEAR)
    got = tpre.resize_bilinear(image, *size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("cfg_name,fn,seed", [
    ("tiny_config", "make_frame", 0), ("tiny_config", "make_varied_frame", 4),
    ("multi_scale_config", "make_varied_frame", 2)])
def test_frame_to_example_matches(cfg_name, fn, seed):
    """Every key bit-equal but the image, which inherits the resize's one
    uint8 level (1/255 after normalisation)."""
    jf, tf = _frames(fn, seed)
    j = jpre.frame_to_example(jf, getattr(jcfg, cfg_name)())
    t = tpre.frame_to_example(tf, getattr(tcfg, cfg_name)())
    assert set(t) == set(j) - {"fusion_row_cum"}
    for key in t:
        if key == "image":
            assert t[key].shape == j[key].shape
            np.testing.assert_allclose(t[key], j[key], rtol=0,
                                       atol=1.0001 / 255)
        else:
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rasterize_bev_s2d_equal(dtype):
    cfg_j, cfg_t = jcfg.tiny_config(), tcfg.tiny_config()
    batch = jpre.stack_examples([
        jpre.frame_to_example(jsyn.make_varied_frame(seed=s), cfg_j)
        for s in (1, 2)])
    want = np.asarray(jvox.rasterize_bev_batch(
        jnp.asarray(batch["points"]), jnp.asarray(batch["point_mask"]),
        cfg_j.voxel, dtype=getattr(jnp, dtype), s2d=True), np.float32)
    got = tvox.rasterize_bev_s2d(
        torch.from_numpy(batch["points"]),
        torch.from_numpy(batch["point_mask"]), cfg_t.voxel,
        getattr(torch, dtype)).to(torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got[..., :-1].max() == 1.0
