"""ctypes bindings for the native COLMAP reader (native/colmap_reader.cpp).

PyTorch-package copy of deblur4dgs_tpu/data/native_colmap.py. It builds
the shared library on first use with g++ into build/native/ (git-ignored;
the source in native/ is shared with the JAX package and nothing is
written next to it) and exposes the same Camera/Image containers as
data/colmap.py. A host-side reader, not a device kernel: when the
toolchain or the library is unavailable, get_lib returns None and the
readers fall back to the pure-Python parser, as the reference does.
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import subprocess

import numpy as np

from deblur4dgs_tpu_torch.data import colmap as pycolmap

_REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
_SRC = osp.join(_REPO, "native", "colmap_reader.cpp")
_LIB = osp.join(_REPO, "build", "native", "libcolmap_reader.so")

_lib = None


def _build() -> bool:
    try:
        os.makedirs(osp.dirname(_LIB), exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", _LIB, _SRC],
            check=True, capture_output=True,
        )
        return True
    except Exception:
        return False


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not osp.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        if not _build():
            return None
    lib = ctypes.CDLL(_LIB)
    i64 = ctypes.c_int64
    p = ctypes.POINTER
    lib.read_cameras_bin.restype = i64
    lib.read_cameras_bin.argtypes = [
        ctypes.c_char_p, i64, p(ctypes.c_int32), p(ctypes.c_int32),
        p(ctypes.c_int64), p(ctypes.c_int64), p(ctypes.c_double),
    ]
    lib.read_images_bin.restype = i64
    lib.read_images_bin.argtypes = [
        ctypes.c_char_p, i64, p(ctypes.c_int32), p(ctypes.c_double),
        p(ctypes.c_double), p(ctypes.c_int32), ctypes.c_char_p, i64,
    ]
    lib.read_points3d_bin.restype = i64
    lib.read_points3d_bin.argtypes = [
        ctypes.c_char_p, i64, p(ctypes.c_int64), p(ctypes.c_double),
        p(ctypes.c_uint8), p(ctypes.c_double),
    ]
    _lib = lib
    return lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


_MODEL_NAMES = {i: name for i, (name, _) in pycolmap.CAMERA_MODELS.items()}


def read_cameras_binary(path: str, max_n: int = 4096):
    lib = get_lib()
    if lib is None:
        return pycolmap.read_cameras_binary(path)
    ids = np.zeros(max_n, np.int32)
    models = np.zeros(max_n, np.int32)
    ws = np.zeros(max_n, np.int64)
    hs = np.zeros(max_n, np.int64)
    params = np.zeros((max_n, 12), np.float64)
    n = lib.read_cameras_bin(
        path.encode(), max_n, _ptr(ids, ctypes.c_int32),
        _ptr(models, ctypes.c_int32), _ptr(ws, ctypes.c_int64),
        _ptr(hs, ctypes.c_int64), _ptr(params, ctypes.c_double),
    )
    if n < 0:
        return pycolmap.read_cameras_binary(path)
    out = {}
    for i in range(n):
        name, npar = pycolmap.CAMERA_MODELS[int(models[i])]
        out[int(ids[i])] = pycolmap.Camera(
            int(ids[i]), name, int(ws[i]), int(hs[i]),
            params[i, :npar].copy(),
        )
    return out


def read_images_binary(path: str, max_n: int = 65536):
    lib = get_lib()
    if lib is None:
        return pycolmap.read_images_binary(path)
    ids = np.zeros(max_n, np.int32)
    qvecs = np.zeros((max_n, 4), np.float64)
    tvecs = np.zeros((max_n, 3), np.float64)
    cam_ids = np.zeros(max_n, np.int32)
    names_buf = ctypes.create_string_buffer(max_n * 256)
    n = lib.read_images_bin(
        path.encode(), max_n, _ptr(ids, ctypes.c_int32),
        _ptr(qvecs, ctypes.c_double), _ptr(tvecs, ctypes.c_double),
        _ptr(cam_ids, ctypes.c_int32), names_buf, max_n * 256,
    )
    if n < 0:
        return pycolmap.read_images_binary(path)
    names = names_buf.raw.split(b"\x00")[:n]
    out = {}
    for i in range(n):
        out[int(ids[i])] = pycolmap.Image(
            int(ids[i]), qvecs[i].copy(), tvecs[i].copy(), int(cam_ids[i]),
            names[i].decode(), np.zeros((0, 2)), np.zeros((0,), np.int64),
        )
    return out


def read_points3d_binary(path: str, max_n: int = 10_000_000):
    lib = get_lib()
    if lib is None:
        return pycolmap.read_points3d_binary(path)
    ids = np.zeros(max_n, np.int64)
    xyz = np.zeros((max_n, 3), np.float64)
    rgb = np.zeros((max_n, 3), np.uint8)
    errors = np.zeros(max_n, np.float64)
    n = lib.read_points3d_bin(
        path.encode(), max_n, _ptr(ids, ctypes.c_int64),
        _ptr(xyz, ctypes.c_double), _ptr(rgb, ctypes.c_uint8),
        _ptr(errors, ctypes.c_double),
    )
    if n < 0:
        return pycolmap.read_points3d_binary(path)
    return xyz[:n].copy(), rgb[:n].copy(), errors[:n].copy(), ids[:n].copy()
