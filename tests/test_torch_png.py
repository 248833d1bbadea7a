"""The port's PNG reader (vis/png.py::read_png) against imageio.

Every case is written to a file and read by both: read_png must return
what ``imageio.v3.imread`` returns, the same dtype, shape and values.
Files come from imageio and Pillow where they write the case (imageio's
bool masks are 1-bit grey, Pillow's palette, grey + alpha and 16-bit
files; both pick row filters per row), and from ``make_png`` below for
the rest: every bit depth of every colour type, Adam7 interlacing, tRNS
chunks, image data split over IDAT chunks and rows filtered with chosen
filter types (all Paeth, all Average, or the five in turn). The header
checks raise with the file's name.
"""

import struct
import warnings
import zlib

import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from deblur4dgs_tpu_torch.vis.png import read_png

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))  # x0, y0, dx, dy
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack(samples, depth):
    """Rows of samples (h, w, c) packed at ``depth`` bits, big-endian."""
    h, w, c = samples.shape
    flat = samples.reshape(h, w * c).astype(np.uint32)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = -(-(w * c) // per)
    pad = np.zeros((h, n * per), np.uint32)
    pad[:, : w * c] = flat
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint32)
    return (pad.reshape(h, n, per) << shifts).sum(-1).astype(np.uint8)


def _filter(raw, bpp, types):
    """Filtered rows (h, 1 + n) of bytes (h, n); row y takes filter
    types[y % len(types)] (the byte-by-byte definitions of the standard)."""
    h, n = raw.shape
    out = np.zeros((h, n + 1), np.uint8)
    prior = np.zeros(n, np.int32)
    for y in range(h):
        t = types[y % len(types)]
        r = raw[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), r])[:n]
        c = np.concatenate([np.zeros(bpp, np.int32), prior])[:n]
        b = prior
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0 * r, a, b, (a + b) // 2, paeth][t]
        out[y, 0] = t
        out[y, 1:] = (r - pred) & 255
        prior = r
    return out


def make_png(samples, depth, ctype, interlace=0, palette=None, trns=None,
             types=(0, 1, 2, 3, 4), idat_parts=2):
    """A PNG file of samples (h, w[, c]) (palette indices for colour type
    3) at any bit depth, plain or Adam7-interlaced."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            raw += _filter(_pack(sub, depth), bpp, types).tobytes()
    data = zlib.compress(raw)
    parts = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))]
    if palette is not None:
        parts.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        parts.append(_chunk(b"tRNS", trns))
    step = -(-len(data) // idat_parts)
    parts += [_chunk(b"IDAT", data[i : i + step])
              for i in range(0, len(data), step)]
    return b"".join(parts + [_chunk(b"IEND", b"")])


def _written(ctype, depth, interlace, trns, types=(0, 1, 2, 3, 4),
             hw=(13, 17), seed=0):
    rng = np.random.default_rng(seed)
    h, w = hw
    c = CHANNELS[ctype]
    if ctype == 3:
        n = min(1 << depth, 7)
        samples = rng.integers(0, n, (h, w))
        pal = rng.integers(0, 256, (n, 3))
        alpha = bytes(rng.integers(0, 256, n - 1).astype(np.uint8))
        return make_png(samples, depth, ctype, interlace, pal,
                        alpha if trns else None, types)
    samples = rng.integers(0, 1 << depth, (h, w, c))
    key = (struct.pack(">" + "H" * c, *map(int, samples[0, 0]))
           if trns else None)  # a colour key: grey and RGB only
    return make_png(samples, depth, ctype, interlace, trns=key, types=types)


WRITER_CASES = [
    (ctype, depth, interlace, False)
    for ctype, depths in {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
                          4: (8, 16), 6: (8, 16)}.items()
    for depth in depths for interlace in (0, 1)
] + [(0, 1, 0, True), (0, 8, 1, True), (0, 16, 0, True), (2, 8, 0, True),
     (2, 16, 1, True), (3, 2, 0, True), (3, 8, 1, True)]


def _check(path):
    with warnings.catch_warnings():
        # Pillow warns when it drops a palette's tRNS alpha
        warnings.simplefilter("ignore", UserWarning)
        want = iio.imread(path)
    got = read_png(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("ctype,depth,interlace,trns", WRITER_CASES)
def test_read_png_equals_imageio(ctype, depth, interlace, trns, tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(_written(ctype, depth, interlace, trns))
    got = _check(path)
    want_dtype = (bool if (ctype, depth) == (0, 1) else
                  np.uint16 if (ctype, depth) == (0, 16) else np.uint8)
    assert got.dtype == want_dtype


@pytest.mark.parametrize("types,hw", [
    ((4,), (48, 64)), ((3,), (31, 5)), ((3, 4, 1, 2, 0), (1, 1)),
    ((1, 2), (7, 300)), ((1, 2, 0, 3, 2, 4, 1, 0, 2, 2, 1, 2, 0), (13, 17))])
@pytest.mark.parametrize("ctype,depth", [(2, 8), (6, 16), (0, 2), (3, 4)])
def test_read_png_row_filters(types, hw, ctype, depth, tmp_path):
    """Rows all Paeth, all Average, mixed, Sub / Up only (the row by row
    path), or Average and Paeth rows between Sub / Up ones (the wavefront
    below a decoded row), in images one pixel or one row wide and up."""
    for interlace in (0, 1):
        path = tmp_path / f"x{interlace}.png"
        path.write_bytes(_written(ctype, depth, interlace, False, types, hw,
                                  seed=1))
        _check(path)


def _imageio_and_pillow_files(d):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    rgb[:, 20:] = rgb[:, :1]  # flat runs: the encoder mixes row filters
    files = {
        "bool_mask": rng.uniform(size=(40, 56)) < 0.4,  # 1-bit grey
        "grey": rgb[..., 0],
        "rgb": rgb,
        "rgba": np.concatenate([rgb, rgb[..., :1]], -1),
        "grey16": rng.integers(0, 1 << 16, (40, 56)).astype(np.uint16),
    }
    for name, img in files.items():
        iio.imwrite(d / f"{name}.png", img)
    Image.fromarray(rgb).quantize(12).save(d / "palette.png")
    q = Image.fromarray(rgb).quantize(5)
    q.info["transparency"] = 2
    q.save(d / "palette_trns.png", transparency=2)
    Image.fromarray(rgb[..., :2].copy(), "LA").save(d / "grey_alpha.png")
    Image.fromarray(rgb).convert("1").save(d / "pil_1bit.png")
    return sorted(p.stem for p in d.iterdir())


FILE_NAMES = ["bool_mask", "grey", "grey16", "grey_alpha", "palette",
              "palette_trns", "pil_1bit", "rgb", "rgba"]


@pytest.mark.parametrize("name", FILE_NAMES)
def test_read_png_reads_imageio_and_pillow_files(name, tmp_path):
    assert _imageio_and_pillow_files(tmp_path) == FILE_NAMES
    got = _check(tmp_path / f"{name}.png")
    if name == "bool_mask":
        assert got.dtype == bool and got.shape == (40, 56)


@pytest.mark.parametrize("header,match", [
    ((4, 3, 3, 0, 0, 0, 0), "bit depth 3"),
    ((4, 3, 8, 5, 0, 0, 0), "colour type 5"),
    ((4, 3, 16, 3, 0, 0, 0), "bit depth 16, colour type 3"),
    ((4, 3, 8, 2, 0, 0, 2), "interlace 2"),
    ((4, 3, 8, 2, 1, 0, 0), "compression 1"),
])
def test_read_png_refuses_what_the_standard_does_not_define(
        header, match, tmp_path):
    path = tmp_path / "bad.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + _chunk(b"IHDR", struct.pack(">IIBBBBB", *header))
                     + _chunk(b"IDAT", zlib.compress(b"\0" * 64))
                     + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=match) as err:
        read_png(str(path))
    assert "bad.png" in str(err.value)


def test_read_png_refuses_bad_data_and_palettes(tmp_path):
    good = _written(3, 8, 0, False)
    path = tmp_path / "p.png"
    path.write_bytes(good.replace(b"PLTE", b"pLTE"))  # no PLTE chunk left
    with pytest.raises(ValueError, match="PLTE"):
        read_png(str(path))
    rows = zlib.compress(b"\0" + b"\7" * 4)  # index 7 of a 2-entry palette
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 1, 8, 3, 0,
                                                   0, 0))
                     + _chunk(b"PLTE", bytes(6)) + _chunk(b"IDAT", rows)
                     + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="palette index 7"):
        read_png(str(path))
    path.write_bytes(make_png(np.zeros((3, 4, 3), np.uint8), 8, 2).replace(
        b"IHDR\x00\x00\x00\x04\x00\x00\x00\x03",
        b"IHDR\x00\x00\x00\x04\x00\x00\x00\x05"))  # says 5 rows, holds 3
    with pytest.raises(ValueError, match="expected"):
        read_png(str(path))
    header = struct.pack(">IIBBBBB", 4, 1, 8, 0, 0, 0, 0)
    for data, match in ((zlib.compress(b"\5" + bytes(4)), "filter type 5"),
                        (b"not zlib", "does not inflate")):
        path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                         + _chunk(b"IDAT", data) + _chunk(b"IEND", b""))
        with pytest.raises(ValueError, match=match) as err:
            read_png(str(path))
        assert "p.png" in str(err.value) and "header" in str(err.value)
