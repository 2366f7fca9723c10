"""PNG files on the host with the standard library's `zlib`, numpy and
the compiled row unfilter of `dcf_torch.native`: the port's stand-in for
PIL, which the card's machine does not have.

`read_png` decodes 8-bit, non-interlaced files of colour types 0, 2, 4
and 6 (gray, RGB, gray + alpha, RGBA) to `uint8 [H, W, 3]` RGB, as
PIL's `Image.open(path).convert("RGB")` does: gray is repeated over the
three channels and alpha is dropped. Any other file (16-bit or 1/2/4-bit
samples, interlaced, palette) is refused with a `ValueError` that names
what is not supported. `write_png` encodes `uint8 [H, W, 3]` RGB.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from dcf_torch import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (8-bit: bytes per pixel)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                 6: "RGBA"}


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG file without IEND")


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the per-row filters of `raw [H, W, C]` (filter bytes removed),
    `ftype [H]` in 0-4 (None, Sub, Up, Average, Paeth): the plain version
    of the compiled row unfilter (`native.png_unfilter`) that
    `decode_png` runs.

    A byte depends on its left neighbour (a), the byte above (b) and the
    one above-left (c), so the pixels of one anti-diagonal y + x = t are
    independent given the earlier ones: the loop runs over the H + W - 1
    anti-diagonals, each one vector operation over all rows whatever
    their filters. The planes are skewed so that a diagonal is one
    contiguous slice: pixel (y, x) lives at `s[y + x + 2, y + 1]`, with
    zeros above row 0 and left of column 0 (the spec's values outside
    the image); cells left of column 0 get raw 0 and zero neighbours, so
    they stay 0, and cells right of column W - 1 are never a neighbour of
    a pixel."""
    H, W, C = raw.shape
    y, x = np.mgrid[0:H, 0:W]
    skew = np.zeros((H + W - 1, H, C), np.int16)
    skew[y + x, y] = raw
    s = np.zeros((H + W + 1, H + 1, C), np.int16)
    f = ftype.astype(np.int16)[:, None]
    use_a, use_b = (f == 1).astype(np.int16), (f == 2).astype(np.int16)
    use_avg, use_paeth = (f == 3).astype(np.int16), (f == 4).astype(np.int16)
    for t in range(H + W - 1):
        a, b, c = s[t + 1, 1:], s[t + 1, :-1], s[t, :-1]
        # |p - a|, |p - b|, |p - c| for the spec's p = a + b - c
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = (use_a * a + use_b * b + use_avg * ((a + b) >> 1)
                + use_paeth * paeth)
        s[t + 2, 1:] = (skew[t] + pred) & 0xFF
    return s[y + x + 2, y + 1].astype(np.uint8)


def _filtered_rows(data: bytes):
    """The checked, inflated rows of a PNG file: (rows [H, 1 + W * C]
    uint8, each a filter byte in 0-4 and the row's bytes, W, C)."""
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            if len(payload) != 13:
                raise ValueError(f"PNG IHDR of {len(payload)} bytes")
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind not in (b"PLTE", b"IEND") and kind[:1].isupper():
            raise ValueError(f"unsupported critical PNG chunk {kind!r}")
    if header is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    width, height, depth, colour, comp, filt, interlace = header
    if colour not in _CHANNELS:
        name = _COLOUR_NAMES.get(colour, f"type {colour}")
        raise ValueError(f"unsupported PNG colour type: {name} "
                         f"(read gray, RGB, gray+alpha, RGBA)")
    if depth != 8:
        name = "16-bit" if depth == 16 else f"{depth}-bit"
        raise ValueError(f"unsupported PNG bit depth: {name} samples "
                         f"(read 8-bit only)")
    if interlace != 0:
        raise ValueError("unsupported PNG: interlaced (Adam7)")
    if comp != 0 or filt != 0:
        raise ValueError(f"unsupported PNG compression {comp} / filter "
                         f"method {filt}")
    if width == 0 or height == 0:
        raise ValueError(f"PNG of {width}x{height} pixels")
    C = _CHANNELS[colour]
    stride = 1 + width * C
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * stride:
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{height * stride}")
    raw = raw.reshape(height, stride)
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"PNG row filter {int(ftype.max())} is not 0-4")
    return raw, width, C


def _rgb(pix: np.ndarray) -> np.ndarray:
    if pix.shape[2] <= 2:           # gray (+ alpha): repeat the gray
        return np.repeat(pix[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pix[..., :3])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB (see the module docstring); the
    row filters are undone by the compiled `native.png_unfilter`."""
    rows, width, C = _filtered_rows(data)
    return _rgb(native.png_unfilter(rows, C).reshape(len(rows), width, C))


def decode_png_plain(data: bytes) -> np.ndarray:
    """`decode_png` with the numpy wavefront `_unfilter`, its plain
    version."""
    rows, width, C = _filtered_rows(data)
    return _rgb(_unfilter(rows[:, 1:].reshape(len(rows), width, C),
                          rows[:, 0]))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> PNG bytes: 8-bit RGB, every row with the
    Sub filter (each byte minus the one a pixel to its left), one IDAT."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 [H, W, 3], got "
                         f"{image.dtype} {image.shape}")
    H, W, _ = image.shape
    rows = image.reshape(H, W * 3)
    sub = rows.copy()
    sub[:, 3:] -= rows[:, :-3]                  # uint8: modulo 256
    raw = np.concatenate([np.ones((H, 1), np.uint8), sub], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))
