"""PNG files through the standard library alone (zlib, struct).

The port's way to keep the reference's on-disk results where imageio is
not installed: the JAX package writes its validation and test renders as
8-bit PNGs (deblur4dgs_tpu/eval/validator.py::Validator._save) and reads
them back for the metrics stage (deblur4dgs_tpu/pipeline.py::
compute_scene_metrics). No counterpart module in the JAX package.

``write_png`` writes 8-bit grey, RGB or RGBA images, every row with
filter 0 (None); ``encode_png`` returns the same bytes (the viewer's
frames). ``read_png`` reads every PNG the standard defines (bit depths 1
to 16, grey, RGB, palette, grey + alpha and RGBA, Adam7 interlacing, the
five row filters) into what ``imageio.v3.imread`` returns for it, so
``data/stereo.py`` reads a scene's frames and masks on a machine without
imageio. ``write_apng`` / ``read_apng`` write and read
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
# colour type -> samples per pixel, and the bit depths it allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: first column and row, column and row steps
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _unfilter_wavefront(line: np.ndarray, types: np.ndarray, bpp: int,
                        prior: np.ndarray | None) -> np.ndarray:
    """Undo the filters of rows (h, n) below the row ``prior`` (None: the
    image's first row) whose types include Average or Paeth.

    Filter unit (y, x), ``bpp`` bytes, depends on (y, x-1), (y-1, x) and
    (y-1, x-1) alone, so every unit of an anti-diagonal k = x + y is undone
    at once from the two diagonals before it, each row with its own filter
    type: h + n / bpp - 1 vector steps instead of h * n byte steps. ``r``
    holds diagonal k at r[k + 2] and row y at r[:, y + 1]; r[:, 0] is the
    prior row, and a unit left of a row's start stays 0."""
    h, n = line.shape
    m = n // bpp
    ys, xs = np.arange(h)[:, None], np.arange(m)[None, :]
    f = np.zeros((m + h - 1, h + 1, bpp), np.int16)
    f[ys + xs, ys + 1] = line.reshape(h, m, bpp)
    r = np.zeros((m + h + 1, h + 1, bpp), np.int16)
    if prior is not None:
        r[1 : m + 1, 0] = prior.reshape(m, bpp)
    t = types[:, None]
    sub, up, avg, paeth = t == 1, t == 2, t == 3, t == 4
    for k in range(m + h - 1):
        lo, hi = max(0, k - m + 1), min(h, k + 1)  # rows on diagonal k
        a = r[k + 1, lo + 1 : hi + 1]  # left
        b = r[k + 1, lo:hi]  # up
        c = r[k, lo:hi]  # up-left
        bc, ac = b - c, a - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(paeth[lo:hi], pred, np.where(
            avg[lo:hi], (a + b) >> 1, np.where(
                up[lo:hi], b, np.where(sub[lo:hi], a, 0))))
        r[k + 2, lo + 1 : hi + 1] = (f[k, lo + 1 : hi + 1] + pred) & 0xFF
    return r[ys + xs + 2, ys + 1].astype(np.uint8).reshape(h, n)


def _unfilter(data: np.ndarray, bpp: int) -> np.ndarray:
    """The bytes (h, n) of one image or Adam7 pass from its filtered rows
    (h, 1 + n), each led by its filter type; ``bpp`` bytes per filter unit
    (one pixel, or one byte below 8 bits per pixel). Rows from the first
    Average or Paeth row to the last go through the wavefront, the others
    one vector operation each."""
    types, line = data[:, 0], data[:, 1:]
    h, n = line.shape
    out = np.empty((h, n), np.uint8)
    hard = np.nonzero(types >= 3)[0]
    y0, y1 = (int(hard[0]), int(hard[-1]) + 1) if hard.size else (h, h)

    def rows(lo, hi):
        prior = out[lo - 1] if lo else np.zeros(n, np.uint8)
        for y in range(lo, hi):
            if types[y] == 0:
                out[y] = line[y]
            elif types[y] == 1:  # Sub: running sum of each byte of a unit
                out[y] = np.cumsum(line[y].reshape(-1, bpp), axis=0,
                                   dtype=np.uint8).reshape(n)
            else:  # Up
                out[y] = line[y] + prior
            prior = out[y]

    rows(0, y0)
    if y0 < y1:
        out[y0:y1] = _unfilter_wavefront(line[y0:y1], types[y0:y1], bpp,
                                         out[y0 - 1] if y0 else None)
    rows(y1, h)
    return out


def _unpack(rows: np.ndarray, count: int, depth: int) -> np.ndarray:
    """The first ``count`` samples of each row of packed bytes (h, n)."""
    if depth == 16:
        return np.ascontiguousarray(rows).view(">u2")[:, :count].astype(
            np.uint16)
    if depth == 8:
        return rows[:, :count]
    per = 8 // depth  # samples per byte, most significant first
    shifts = (8 - depth * np.arange(1, per + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :count]


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


def _decode(path: str, header, data: bytes, plte=None) -> np.ndarray:
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if (depth not in _DEPTHS.get(ctype, ()) or comp != 0 or filt != 0
            or interlace not in (0, 1) or w == 0 or h == 0):
        raise ValueError(
            f"{path}: unsupported PNG header (width {w}, height {h}, bit "
            f"depth {depth}, colour type {ctype}, compression {comp}, filter "
            f"{filt}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(data), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: image data does not inflate ({e}; "
                         f"header {header})") from None
    samples = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:  # a pass with no pixels has no rows
            continue
        stride = -(-(pw * ch * depth) // 8)
        rows = raw[pos : pos + ph * (stride + 1)]
        pos += ph * (stride + 1)
        if rows.size != ph * (stride + 1):
            break
        rows = rows.reshape(ph, stride + 1)
        if rows[:, 0].max() > 4:
            raise ValueError(f"{path}: unknown row filter type "
                             f"{rows[:, 0].max()} (header {header})")
        rows = _unfilter(rows, max(1, ch * depth // 8))
        samples[y0::dy, x0::dx] = _unpack(rows, pw * ch, depth).reshape(
            ph, pw, ch)
    if pos != raw.size:
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected "
                         f"{pos} (header {header})")
    if ctype == 3:
        pal = np.frombuffer(plte or b"", np.uint8)
        if pal.size == 0 or pal.size % 3:
            raise ValueError(f"{path}: colour type 3 needs a PLTE chunk of "
                             f"RGB triples, got {pal.size} bytes")
        pal = pal.reshape(-1, 3)
        if int(samples.max()) >= len(pal):
            raise ValueError(f"{path}: palette index {int(samples.max())} "
                             f"beyond the {len(pal)} entries of PLTE")
        return pal[samples[..., 0]]
    if ctype == 0:
        grey = samples[..., 0]
        if depth == 1:
            return grey.astype(bool)
        if depth < 8:  # scaled to 0..255, as Pillow's L mode holds them
            return grey * np.uint8(255 // ((1 << depth) - 1))
        return grey
    if depth == 16:  # Pillow keeps the high byte of 16-bit colour samples
        samples = (samples >> 8).astype(np.uint8)
        if ctype == 4:  # and reads 16-bit grey + alpha as RGBA
            return samples[..., [0, 0, 0, 1]]
    return samples


def read_png(path: str) -> np.ndarray:
    """What ``imageio.v3.imread`` (through Pillow) returns for a PNG: the
    default image of an animated PNG, Adam7 interlacing undone.

    ===========  ========  ============================================
    colour type  depth     result
    ===========  ========  ============================================
    0 grey       1         bool (H, W)
    0 grey       2, 4      uint8 (H, W), scaled to 0..255
    0 grey       8 / 16    uint8 / uint16 (H, W)
    2 RGB        8, 16     uint8 (H, W, 3) (16: the high bytes)
    3 palette    1-8       uint8 (H, W, 3), the PLTE colours
    4 grey + a   8 / 16    uint8 (H, W, 2) / (H, W, 4) as RGBA
    6 RGBA       8, 16     uint8 (H, W, 4) (16: the high bytes)
    ===========  ========  ============================================

    A tRNS chunk changes nothing: imageio converts a palette image to its
    palette's RGB and drops the transparency. A file outside the PNG
    standard raises ValueError naming the file and the header."""
    header, plte, idat = None, None, []
    for kind, data in _chunks(path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            plte = data
        elif kind == b"IDAT":
            idat.append(data)
    return _decode(path, header, b"".join(idat), plte)


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
