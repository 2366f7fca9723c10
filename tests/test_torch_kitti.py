"""The port's KITTI files against the JAX package's and PIL's.

- `dcf_torch.data.png` decodes what PIL decodes, pixel for pixel, as
  `Image.open(...).convert("RGB")` gives it: hand-built files with every
  row filter (None, Sub, Up, Average, Paeth), colour types 0 / 2 / 4 / 6,
  odd widths and several IDAT chunks, and files PIL writes; its encoder's
  files decode to the same pixels in PIL; 16-bit, interlaced and palette
  files are refused with a ValueError that names them.
- A tree written by the JAX `write_kitti_tree` and one written by the
  port's: the `.bin`, calib and label files byte-equal, and the port's
  `KittiDataset` equal to the JAX reader bit for bit on both trees.
- `write_kitti_result` writes the JAX package's bytes.
"""

import filecmp
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dcf.data import kitti as jkitti
from dcf.data import synthetic as jsyn
from dcf_torch.data import kitti as tkitti
from dcf_torch.data import png
from dcf_torch.data import synthetic as tsyn

CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_rows(pix, ftypes):
    """The PNG row filters applied byte by byte, as an encoder does:
    pix uint8 [H, W, C], one filter type per row."""
    H, W, C = pix.shape
    rows = pix.reshape(H, W * C).astype(int)
    out = []
    for r in range(H):
        ft = ftypes[r]
        line = [ft]
        for i in range(W * C):
            a = rows[r, i - C] if i >= C else 0
            b = rows[r - 1, i] if r else 0
            c = rows[r - 1, i - C] if r and i >= C else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ft]
            line.append((rows[r, i] - pred) % 256)
        out.append(bytes(line))
    return b"".join(out)


def _png_bytes(pix, colour, ftypes, n_idat=1, depth=8, interlace=0,
               plte=None):
    H, W = pix.shape[:2]
    data = zlib.compress(_filter_rows(pix, ftypes))
    cuts = np.linspace(0, len(data), n_idat + 1).astype(int)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour, 0,
                                       0, interlace))
    if plte is not None:
        body += _chunk(b"PLTE", plte)
    for a, b in zip(cuts[:-1], cuts[1:]):
        body += _chunk(b"IDAT", data[a:b])
    return b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b"")


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


@pytest.mark.parametrize("colour", [0, 2, 4, 6])
@pytest.mark.parametrize("width,height,n_idat", [(1, 5, 1), (7, 10, 3),
                                                 (13, 6, 2), (32, 11, 4)])
def test_decode_every_filter_matches_pil(colour, width, height, n_idat):
    rng = np.random.default_rng(width * 10 + colour)
    pix = rng.integers(0, 256, (height, width, CHANNELS[colour]), np.uint8)
    pix[: height // 2] //= 8          # runs of small values beside noise
    ftypes = [r % 5 for r in range(height)]        # None .. Paeth
    data = _png_bytes(pix, colour, ftypes, n_idat=n_idat)
    got = png.decode_png(data)
    want = _pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == (height, width, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decode_one_filter_throughout_matches_pil(ftype):
    rng = np.random.default_rng(ftype)
    pix = rng.integers(0, 256, (9, 17, 3), np.uint8)
    data = _png_bytes(pix, 2, [ftype] * 9, n_idat=2)
    np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))
    np.testing.assert_array_equal(png.decode_png(data), pix)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_decode_pil_written_files(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    n = len(mode)
    yy, xx = np.mgrid[0:37, 0:61]
    smooth = np.stack([(xx * 4 + yy * k) % 256 for k in range(1, n + 1)], -1)
    pix = (smooth + rng.integers(0, 6, smooth.shape)).astype(np.uint8)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(pix[..., 0] if n == 1 else pix).save(path)
    with Image.open(path) as im:
        assert im.mode == mode
        want = np.asarray(im.convert("RGB"), np.uint8)
    np.testing.assert_array_equal(png.read_png(path), want)


def test_encoder_round_trips_through_pil(tmp_path):
    image = tsyn.make_frame(seed=1).image
    path = str(tmp_path / "frame.png")
    png.write_png(path, image)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), image)
    np.testing.assert_array_equal(png.read_png(path), image)


def test_refuses_16_bit(tmp_path):
    path = str(tmp_path / "deep.png")
    Image.fromarray(np.arange(24, dtype=np.uint16).reshape(4, 6)
                    * 2000).save(path)
    with Image.open(path) as im:
        assert im.mode.startswith("I")
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png(path)


def test_refuses_interlaced():
    pix = np.zeros((4, 4, 3), np.uint8)
    data = _png_bytes(pix, 2, [0] * 4, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(data)


def test_refuses_palette(tmp_path):
    path = str(tmp_path / "pal.png")
    Image.fromarray(np.arange(20, dtype=np.uint8).reshape(4, 5)).convert(
        "P").save(path)
    with Image.open(path) as im:
        assert im.mode == "P"
    with pytest.raises(ValueError, match="palette"):
        png.read_png(path)


def test_refuses_corrupt_chunk():
    data = bytearray(png.encode_png(np.zeros((3, 3, 3), np.uint8)))
    data[40] ^= 0xFF                  # inside IDAT: the CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    j, t = str(root / "jax"), str(root / "port")
    ids = jsyn.write_kitti_tree(j, num_frames=3, split="train")
    assert tsyn.write_kitti_tree(t, num_frames=3, split="train") == ids
    return j, t


def test_trees_write_the_same_bytes(trees):
    j, t = trees
    for kind in ("velodyne", "calib", "label_2"):
        names = sorted(os.listdir(os.path.join(j, "training", kind)))
        assert names == sorted(os.listdir(os.path.join(t, "training", kind)))
        for name in names:
            assert filecmp.cmp(os.path.join(j, "training", kind, name),
                               os.path.join(t, "training", kind, name),
                               shallow=False), (kind, name)
    assert filecmp.cmp(os.path.join(j, "ImageSets", "train.txt"),
                       os.path.join(t, "ImageSets", "train.txt"),
                       shallow=False)


FIELDS = ("points", "image", "boxes", "labels", "difficulty", "truncated",
          "occluded", "alpha", "bbox2d")


@pytest.mark.parametrize("which", ["jax", "port"])
def test_reader_matches_jax_reader(trees, which):
    root = trees[0] if which == "jax" else trees[1]
    want_ds = jkitti.KittiDataset(root, split="train")
    got_ds = tkitti.KittiDataset(root, split="train")
    assert got_ds.frame_ids == want_ds.frame_ids and len(got_ds) == 3
    for i in range(len(want_ds)):
        want, got = want_ds[i], got_ds[i]
        assert got.frame_id == want.frame_id and got.names == want.names
        for name in FIELDS:
            w, g = getattr(want, name), getattr(got, name)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        for name in ("P2", "R0", "V2C"):
            np.testing.assert_array_equal(getattr(got.calib, name),
                                          getattr(want.calib, name))
        assert got.raw_labels.keys() == want.raw_labels.keys()
        for k, w in want.raw_labels.items():
            np.testing.assert_array_equal(np.asarray(got.raw_labels[k]),
                                          np.asarray(w), err_msg=k)
    # the pixels are the generator's in both trees
    np.testing.assert_array_equal(got_ds[0].image,
                                  tsyn.make_frame("000000", seed=0).image)


LABELS = """\
Car 0.00 0 -1.58 587.01 150.33 614.12 200.12 1.65 1.67 3.64 -0.65 1.71 46.70 -1.59
Van 0.12 1 1.85 387.63 181.54 423.81 203.12 1.67 1.87 3.69 -16.53 2.39 58.49 1.57
Pedestrian 0.50 2 0.21 712.40 143.00 810.73 307.92 1.89 0.48 1.20 1.84 1.47 8.41 0.01
Cyclist 0.00 3 -2.01 100.00 150.00 160.00 180.00 1.70 0.60 1.80 -9.20 1.60 20.10 -2.44
DontCare -1 -1 -10 503.89 169.71 590.61 190.13 -1 -1 -1 -1000 -1000 -1000 -10
Person_sitting 0.30 1 0.50 900.00 160.00 950.00 240.00 1.20 0.60 0.90 6.00 1.60 15.00 0.40
"""


def test_label_parse_matches_jax(tmp_path):
    """Every class, DontCare, truncation and occlusion levels, and every
    difficulty bucket, through both packages' parsers."""
    path = str(tmp_path / "000000.txt")
    with open(path, "w") as f:
        f.write(LABELS)
    want = jkitti.parse_label_file(path, jsyn.default_calib())
    got = tkitti.parse_label_file(path, tsyn.default_calib())
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                      err_msg=k)
    assert set(got["difficulty"].tolist()) == {-1, 0, 1, 2}


@pytest.mark.parametrize("image_shape", [None, (375, 1242, 3)])
def test_write_kitti_result_matches_jax(tmp_path, image_shape):
    rng = np.random.default_rng(5)
    n = 40
    boxes = np.stack([rng.uniform(2, 60, n), rng.uniform(-30, 30, n),
                      rng.uniform(-1.5, -0.5, n), rng.uniform(0.5, 4.5, n),
                      rng.uniform(0.4, 2.0, n), rng.uniform(1.4, 1.9, n),
                      rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    names = [jkitti.CLASS_NAMES[c] for c in rng.integers(0, 3, n)]
    want, got = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    jkitti.write_kitti_result(want, names, boxes, scores,
                              jsyn.default_calib(), image_shape=image_shape)
    tkitti.write_kitti_result(got, names, boxes, scores,
                              tsyn.default_calib(), image_shape=image_shape)
    with open(want, "rb") as f, open(got, "rb") as g:
        text = f.read()
        assert g.read() == text
    assert all(len(line.split()) == 16 for line in text.decode().splitlines())
    tkitti.write_kitti_result(got, [], np.zeros((0, 7)), np.zeros(0),
                              tsyn.default_calib())
    with open(got) as g:
        assert g.read() == ""
