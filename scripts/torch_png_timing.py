"""Host time of the port's PNG reader on 1280x720 RGB frames.

    python3 scripts/torch_png_timing.py [--repeats 5]

Writes a seeded 1280x720 RGB frame (smooth gradients plus noise) as PNGs
whose rows all use one filter type (None, Sub, Up, Average, Paeth), then
times ``deblur4dgs_tpu_torch.vis.png.read_png`` on each (median of the
repeats, host clock) and checks that it returns the frame. Prints one
JSON object: seconds per filter type. The package is imported from the
current directory, so running this file from another checkout's root
(``cd <checkout> && python3 <this file>``) times that checkout's reader.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}


def frame(w=1280, h=720, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 0.15 + y * 0.1, x * 0.05 + 40, y * 0.3], -1)
    return ((img + rng.integers(0, 12, img.shape)) % 256).astype(np.uint8)


def encode(img: np.ndarray, ftype: int) -> bytes:
    """An 8-bit RGB PNG of ``img`` with every row filtered by ``ftype``
    (the predictors read unfiltered bytes, so filtering is vectorised)."""
    h, w, _ = img.shape
    raw = img.reshape(h, w * 3).astype(np.int32)
    a = np.pad(raw, ((0, 0), (3, 0)))[:, :-3]  # left
    b = np.pad(raw, ((1, 0), (0, 0)))[:-1]  # up
    c = np.pad(raw, ((1, 0), (3, 0)))[:-1, :-3]  # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = [0 * raw, a, b, (a + b) // 2, paeth][ftype]
    rows = np.concatenate([np.full((h, 1), ftype), (raw - pred) & 255], 1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes()))
            + chunk(b"IEND", b""))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    from deblur4dgs_tpu_torch.vis.png import read_png

    img = frame()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, ftype in FILTERS.items():
            path = os.path.join(d, f"{name}.png")
            with open(path, "wb") as f:
                f.write(encode(img, ftype))
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                back = read_png(path)
                times.append(time.perf_counter() - t0)
            if not np.array_equal(back, img):
                raise SystemExit(f"read_png differs from the frame ({name})")
            out[name] = statistics.median(times)
    print(json.dumps({"read_png_s": out, "wh": [1280, 720],
                      "repeats": args.repeats}))


if __name__ == "__main__":
    main()
