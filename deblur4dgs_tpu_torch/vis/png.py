"""PNG files through the standard library alone (zlib, struct).

The port's way to keep the reference's on-disk results where imageio is
not installed: the JAX package writes its validation and test renders as
8-bit PNGs (deblur4dgs_tpu/eval/validator.py::Validator._save) and reads
them back for the metrics stage (deblur4dgs_tpu/pipeline.py::
compute_scene_metrics). No counterpart module in the JAX package.

``write_png`` writes 8-bit grey, RGB or RGBA images, every row with
filter 0 (None); ``encode_png`` returns the same bytes (the viewer's
frames). ``read_png`` reads 8-bit grey, grey + alpha, RGB and RGBA images,
non-interlaced, with any of the five row filters, so it reads what
imageio or PIL write. ``write_apng`` / ``read_apng`` write and read
animated PNGs (the port's videos: the JAX package writes mp4 or gif
through imageio): whole frames, each replacing the one before, looping
forever; a plain PNG reader shows the first frame.
"""

from __future__ import annotations

import struct
import zlib
from fractions import Fraction

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit samples)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _image_rows(img: np.ndarray) -> tuple[bytes, bytes]:
    """(IHDR payload, filtered rows) of a uint8 image (H, W), (H, W, 1),
    (H, W, 3) or (H, W, 4); every row with filter 0."""
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
    return struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0), rows.tobytes()


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of a uint8 image (see write_png) as bytes."""
    header, rows = _image_rows(img)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray):
    """Write a uint8 image (H, W), (H, W, 1), (H, W, 3) or (H, W, 4)."""
    blob = encode_png(img)
    with open(path, "wb") as f:
        f.write(blob)


def write_apng(path: str, frames: np.ndarray, fps: float = 10.0):
    """Write uint8 frames (N, H, W[, C]) as an animated PNG at ``fps``
    (each frame shown 1/fps s, looping forever)."""
    frames = np.asarray(frames)
    if frames.ndim < 3 or frames.shape[0] == 0:
        raise ValueError(f"write_apng: no frames in shape {frames.shape}")
    delay = Fraction(1.0 / fps).limit_denominator(0xFFFF)
    num, den = delay.numerator, delay.denominator
    if not (0 < num <= 0xFFFF):
        raise ValueError(f"write_apng: fps {fps} gives no 16-bit delay")
    header, _ = _image_rows(frames[0])
    w, h = struct.unpack(">II", header[:8])
    parts = [_SIGNATURE, _chunk(b"IHDR", header),
             _chunk(b"acTL", struct.pack(">II", len(frames), 0))]
    seq = 0
    for i, frame in enumerate(frames):
        fh, rows = _image_rows(frame)
        if fh != header:
            raise ValueError(f"write_apng: frame {i} differs in shape")
        # fcTL: sequence, size, offset (0, 0), delay, dispose none, blend
        # source (the frame replaces the canvas)
        parts.append(_chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, num, den, 0, 0)))
        seq += 1
        data = zlib.compress(rows)
        if i == 0:
            parts.append(_chunk(b"IDAT", data))
        else:
            parts.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    parts.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(parts))


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


def _chunks(path: str):
    """(kind, payload) of every chunk of a PNG file, up to IEND."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        yield kind, blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            break


def _decode(path: str, header, data: bytes) -> np.ndarray:
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace}); "
                         "read_png reads 8-bit grey / grey-alpha / RGB / "
                         "RGBA, non-interlaced")
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(data), h, w, ch).reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_png(path: str) -> np.ndarray:
    """A uint8 array (H, W) for grey, else (H, W, C) with C 2, 3 or 4. Of
    an animated PNG, the default image (its IDAT chunks)."""
    header, idat = None, []
    for kind, data in _chunks(path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    return _decode(path, header, b"".join(idat))


def read_apng(path: str) -> tuple[np.ndarray, list[float]]:
    """Frames (N, H, W[, C]) uint8 and each frame's delay in seconds of an
    animated PNG whose frames each cover the whole image and replace the
    canvas (what write_apng writes)."""
    header, frames, delays, cur = None, [], [], None
    for kind, data in _chunks(path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"fcTL":
            if cur is not None:
                frames.append(b"".join(cur))
            (_, w, h, x, y, num, den, _, blend) = struct.unpack(
                ">IIIIIHHBB", data)
            if header is None or (w, h, x, y, blend) != (
                    header[0], header[1], 0, 0, 0):
                raise ValueError(f"{path}: read_apng reads whole-frame "
                                 "frames that replace the canvas")
            delays.append(num / (den or 100))  # a zero den means 1/100 s
            cur = []
        elif kind == b"IDAT" and cur is not None:  # else: not a frame
            cur.append(data)
        elif kind == b"fdAT":
            cur.append(data[4:])  # after its sequence number
    if cur is not None:
        frames.append(b"".join(cur))
    if not frames:
        raise ValueError(f"{path}: no animation frames")
    return np.stack([_decode(path, header, f) for f in frames]), delays
