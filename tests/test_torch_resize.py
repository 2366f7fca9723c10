"""The port's uint8 image resize against OpenCV's `INTER_LINEAR`, byte for
byte, and the image of `frame_to_example` against the JAX package's,
bit for bit.

`resize_bilinear` replicates OpenCV's 11-bit fixed-point arithmetic in
numpy (the plain version); `native.image_resize_s2d` compiles the same
arithmetic fused with the normalize, letterbox and space-to-depth(4)
steps, and is what `frame_to_example` runs. The JAX package resizes with
`cv2.resize`, so a KITTI frame (375x1242, letterboxed into 1248x377 for
`multi_scale_config`) gives both packages the same image.
"""

import cv2
import numpy as np
import pytest
import torch

import dcf.config as jcfg
import dcf.data.preprocess as jpre
import dcf.data.synthetic as jsyn
import dcf_torch.config as tcfg
import dcf_torch.data.preprocess as tpre
import dcf_torch.data.synthetic as tsyn
from dcf_torch import native

torch.set_num_threads(1)

KITTI = tsyn.make_frame(seed=0).image          # 375x1242x3 uint8


def _random_cases():
    """20 seeded (source, width, height): 10 scaling up, 10 down."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(20):
        h, w = (int(v) for v in rng.integers(5, 200, 2))
        f = rng.uniform(1.05, 3.5) if i < 10 else rng.uniform(0.1, 0.95)
        g = f * rng.uniform(0.8, 1.25)
        out.append(((h, w), max(1, round(w * f)), max(1, round(h * g))))
    return out


CASES = ([("kitti", w, h) for w, h in ((1248, 377), (320, 96), (900, 300),
                                      (2000, 604), (1241, 374), (77, 33))]
         + _random_cases())


def _source(src):
    if src == "kitti":
        return KITTI
    h, w = src
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    img[: h // 3] //= 16               # flat runs beside noise
    return img


@pytest.mark.parametrize("src,width,height", CASES)
def test_resize_equals_cv2(src, width, height):
    image = _source(src)
    want = cv2.resize(image, (width, height), interpolation=cv2.INTER_LINEAR)
    got = tpre.resize_bilinear(image, width, height)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,width,height", CASES)
def test_compiled_resize_s2d_equals_cv2(src, width, height):
    """The compiled fused pass over the letterbox that holds the whole
    resized image, against cv2's pixels / 255 in s2d(4) layout."""
    image = _source(src)
    want = cv2.resize(image, (width, height), interpolation=cv2.INTER_LINEAR)
    H, W = -(-height // 4) * 4 + 4, -(-width // 4) * 4
    full = np.zeros((H, W, 3), np.float32)
    full[:height, :width] = want.astype(np.float32) / 255.0
    got = native.image_resize_s2d(image, height, width, H, W)
    np.testing.assert_array_equal(got, tpre.s2d_image(full))


@pytest.mark.parametrize("fn,seed", [("make_frame", 0), ("make_frame", 3),
                                     ("make_varied_frame", 2)])
def test_frame_to_example_image_bit_equal_to_jax(fn, seed):
    """`multi_scale_config` letterboxes a 375x1242 frame into 1248x377: the
    image (and every other key) bit-equal to the JAX package's."""
    jf, tf = getattr(jsyn, fn)(seed=seed), getattr(tsyn, fn)(seed=seed)
    assert tf.image.shape == (375, 1242, 3)
    j = jpre.frame_to_example(jf, jcfg.multi_scale_config())
    t = tpre.frame_to_example(tf, tcfg.multi_scale_config())
    assert t["image"].shape == (96, 312, 48)
    np.testing.assert_array_equal(t["image"], j["image"])
    for key in set(t) - {"image"}:
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
