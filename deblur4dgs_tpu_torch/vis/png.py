"""PNG files through the standard library alone (zlib, struct).

The port's way to keep the reference's on-disk results where imageio is
not installed: the JAX package writes its validation and test renders as
8-bit PNGs (deblur4dgs_tpu/eval/validator.py::Validator._save) and reads
them back for the metrics stage (deblur4dgs_tpu/pipeline.py::
compute_scene_metrics). No counterpart module in the JAX package.

``write_png`` writes 8-bit grey, RGB or RGBA images, every row with
filter 0 (None). ``read_png`` reads 8-bit grey, grey + alpha, RGB and
RGBA images, non-interlaced, with any of the five row filters, so it reads
what imageio or PIL write.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit samples)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray):
    """Write a uint8 image (H, W), (H, W, 1), (H, W, 3) or (H, W, 4)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 pixels, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype = 0
        img = img[..., None]
    elif img.ndim == 3 and img.shape[-1] in (3, 4):
        ctype = 2 if img.shape[-1] == 3 else 6
    else:
        raise ValueError(f"write_png: unsupported shape {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(img).reshape(h, -1)],
        axis=1)  # filter byte 0 before every row
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def _paeth_row(line: bytearray, prior: bytes, bpp: int):
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prior: bytes, bpp: int):
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{h * (stride + 1)}")
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(data[y, 0]), data[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum of each byte of a pixel
            cur = np.cumsum(line.reshape(w, bpp).astype(np.int64), axis=0)
            cur = (cur & 0xFF).astype(np.uint8).reshape(stride)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: sequential within a row
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(
                buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """A uint8 array (H, W) for grey, else (H, W, C) with C 2, 3 or 4."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace}); "
                         "read_png reads 8-bit grey / grey-alpha / RGB / "
                         "RGBA, non-interlaced")
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch)
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img
