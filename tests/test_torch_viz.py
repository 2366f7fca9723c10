"""`dcf_torch.utils.viz` and `cli.demo --viz` on the CPU: the drawings'
geometry (box edges on the pixels the JAX package's corner functions
put them, the BEV axes as `dcf/utils/viz.py` sets them: x forward up, y
left to the left), the score alpha, and PNGs that round-trip through
`dcf_torch.data.png.decode_png`. Pixel equality with matplotlib or
OpenCV is not a goal.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcf.geometry.boxes import boxes3d_corners as jax_corners3d
from dcf.geometry.np_boxes import box_corners_bev as jax_corners_bev
from dcf_torch.cli import demo
from dcf_torch.config import tiny_config
from dcf_torch.data.png import decode_png, read_png
from dcf_torch.data.synthetic import default_calib, make_frame
from dcf_torch.utils import viz

torch.set_num_threads(1)
VOX = tiny_config().voxel          # x 0..25.6, y -12.8..12.8
PPM = 10.0
GREEN, RED = np.array(viz.GT_RGB), np.array(viz.DET_RGB)


def _is(img, r, c, rgb):
    return np.array_equal(img[r, c], rgb)


def test_axes_orientation():
    pts = np.array([[25.0, 12.0, 0, 0], [0.5, -12.0, 0, 0],
                    [30.0, 0.0, 0, 0]], np.float32)   # the last is outside
    img = viz.draw_bev(None, pts, VOX, px_per_m=PPM)
    assert img.shape == (256, 256, 3)
    gray = np.argwhere((img == viz.POINT_RGB).all(-1)).tolist()
    assert gray == [[6, 8], [251, 248]]    # forward is up, left is left


def test_axis_aligned_box_edges():
    box = np.array([[20.0, 5.0, -1.0, 4.0, 2.0, 1.5, 0.0]])
    img = viz.draw_bev(None, np.zeros((0, 4), np.float32), VOX,
                       gt_boxes=box, px_per_m=PPM)
    # x in [18, 22] -> rows 36..76; y in [4, 6] -> cols 68..88
    for r in range(36, 77):
        assert _is(img, r, 68, GREEN) and _is(img, r, 88, GREEN), r
    for c in range(68, 89):
        assert _is(img, 36, c, GREEN) and _is(img, 76, c, GREEN), c
    assert (img[37:76, 69:88] == 255).all()        # inside stays white
    assert int((img != 255).any(-1).sum()) == 2 * 41 + 2 * 19


@pytest.mark.parametrize("seed", range(4))
def test_rotated_box_corners_and_edges(seed):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform([5, -8, -1], [20, 8, 0], (3, 3)),
                            rng.uniform([1, 0.6, 1], [4, 2, 2], (3, 3)),
                            rng.uniform(-np.pi, np.pi, (3, 1))], axis=1)
    img = viz.draw_bev(None, np.zeros((0, 4), np.float32), VOX,
                       det_boxes=boxes, det_scores=np.ones(3), px_per_m=PPM)
    corners = jax_corners_bev(boxes[:, [0, 1, 3, 4, 6]])      # [3, 4, 2]
    rc = np.stack([(VOX.x_max - corners[..., 0]) * PPM,
                   (VOX.y_max - corners[..., 1]) * PPM], -1)
    for poly in rc:
        for i in range(4):
            a, b = poly[i], poly[(i + 1) % 4]
            for t in np.linspace(0, 1, 9):          # along each edge
                r, c = np.floor(a + t * (b - a)).astype(int)
                near = img[max(r - 1, 0):r + 2, max(c - 1, 0):c + 2]
                assert (near == RED).all(-1).any(), (r, c)
            r, c = np.floor(a).astype(int)
            assert _is(img, r, c, RED)


def test_detection_alpha_follows_score():
    # the edge at x = 12 lies on row 136, y in [-1, 1] on cols 118..138
    box = np.array([[10.0, 0.0, -1.0, 4.0, 2.0, 1.5, 0.0]])
    for score in (0.0, 0.5, 1.0):
        img = viz.draw_bev(None, np.zeros((0, 4), np.float32), VOX,
                           det_boxes=box, det_scores=[score], px_per_m=PPM)
        a = 0.3 + 0.7 * score
        want = np.rint((1 - a) * 255 + a * RED).astype(np.uint8)
        assert np.array_equal(img[136, 125], want), score


def test_png_round_trip(tmp_path):
    frame = make_frame()
    path = str(tmp_path / "bev.png")
    img = viz.draw_bev(path, frame.points, VOX, gt_boxes=frame.boxes,
                       det_boxes=frame.boxes[:1], det_scores=[0.9],
                       px_per_m=PPM)
    with open(path, "rb") as f:
        assert np.array_equal(decode_png(f.read()), img)
    path = str(tmp_path / "cam.png")
    cam = viz.draw_image_with_boxes(path, frame.image, frame.boxes,
                                    frame.calib)
    assert np.array_equal(read_png(path), cam)
    assert cam.shape == frame.image.shape


def test_image_boxes_on_projected_corners():
    calib = default_calib()
    img0 = np.zeros((375, 1242, 3), np.uint8)
    ahead = np.array([[15.0, 2.0, -0.9, 3.9, 1.6, 1.56, 0.3]], np.float32)
    behind = np.array([[-15.0, 2.0, -0.9, 3.9, 1.6, 1.56, 0.3]], np.float32)
    img = viz.draw_image_with_boxes(None, img0, ahead, calib, (255, 64, 64))
    uvz = calib.velo_to_image(np.asarray(jax_corners3d(jnp.asarray(ahead)))[0])
    uv = uvz[:, :2].astype(int)
    for u, v in uv:
        assert _is(img, v, u, (255, 64, 64)), (u, v)
    for a, b in viz.BOX_EDGES:                  # each edge's midpoint
        u, v = (uv[a] + uv[b]) // 2
        near = img[v - 1:v + 2, u - 1:u + 2]
        assert (near == (255, 64, 64)).all(-1).any(), (a, b)
    assert np.array_equal(
        viz.draw_image_with_boxes(None, img0, behind, calib), img0)


def test_demo_viz(tmp_path):
    path = str(tmp_path / "demo.png")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        demo.main(["--config", "tiny", "--device", "cpu", "--viz", path])
    assert f"wrote {path}" in out.getvalue()
    img = read_png(path)
    assert img.shape == (256, 256, 3)
    assert (img == GREEN).all(-1).any()        # the frame's gt boxes
