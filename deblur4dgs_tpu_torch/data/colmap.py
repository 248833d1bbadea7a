"""COLMAP model reader: the port's own copy of deblur4dgs_tpu/data/colmap.py.

Parses the standard COLMAP sparse-reconstruction formats (cameras/images/
points3D in .bin or .txt) and exposes the same high-level accessor the
datasets use: per-image intrinsics K and world->camera extrinsics. Written
against the public COLMAP format specification; pure numpy/struct.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        p = self.params
        if self.model == "SIMPLE_PINHOLE" or self.model.startswith("SIMPLE_RADIAL") or self.model == "FOV":
            f, cx, cy = p[0], p[1], p[2]
            fx = fy = f
        elif self.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV", "THIN_PRISM_FISHEYE", "RADIAL"):
            if self.model == "RADIAL":
                fx = fy = p[0]
                cx, cy = p[1], p[2]
            else:
                fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        else:
            raise ValueError(f"unsupported camera model {self.model}")
        return np.array(
            [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64
        )


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # wxyz
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray

    @property
    def w2c(self) -> np.ndarray:
        R = qvec_to_rotmat(self.qvec)
        m = np.eye(4)
        m[:3, :3] = R
        m[:3, 3] = self.tvec
        return m


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1], R[0, 0] + R[1, 1] + R[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


def _read(fid, fmt):
    return struct.unpack(fmt, fid.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cams[cid] = Camera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * npts), dtype=np.float64
            ).reshape(npts, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].copy().view(np.int64).astype(np.int64)
            # point ids are stored as int64 in the last 8 bytes of each
            # 24-byte record; reinterpret properly:
            raw = np.frombuffer(
                np.ascontiguousarray(data).tobytes(), dtype=np.uint8
            ).reshape(npts, 24) if npts else np.zeros((0, 24), np.uint8)
            ids = (
                raw[:, 16:24].copy().view(np.int64).reshape(-1)
                if npts
                else np.zeros((0,), np.int64)
            )
            images[iid] = Image(
                iid, qvec, tvec, cam_id, name.decode(), xys, ids
            )
    return images


def read_points3d_binary(path: str):
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.zeros((n, 3))
        rgb = np.zeros((n, 3), np.uint8)
        errors = np.zeros(n)
        ids = np.zeros(n, np.int64)
        for i in range(n):
            pid = _read(f, "<Q")[0]
            xyz[i] = _read(f, "<3d")
            rgb[i] = _read(f, "<3B")
            errors[i] = _read(f, "<d")[0]
            (tl,) = _read(f, "<Q")
            f.read(8 * tl)  # (image_id, point2D_idx) pairs
            ids[i] = pid
    return xyz, rgb, errors, ids


def read_cameras_text(path: str) -> dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            cid, model = int(el[0]), el[1]
            cams[cid] = Camera(
                cid, model, int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]),
            )
    return cams


def read_images_text(path: str) -> dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [
            ln for ln in f if not ln.startswith("#") and ln.strip()
        ]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        iid = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        cam_id = int(el[8])
        name = el[9]
        pts = lines[i + 1].split()
        xys = np.array(
            [[float(pts[j]), float(pts[j + 1])] for j in range(0, len(pts), 3)]
        ) if pts else np.zeros((0, 2))
        ids = np.array(
            [int(pts[j + 2]) for j in range(0, len(pts), 3)], np.int64
        ) if pts else np.zeros((0,), np.int64)
        images[iid] = Image(iid, qvec, tvec, cam_id, name, xys, ids)
    return images


def load_model(sparse_dir: str) -> tuple[dict[int, Camera], dict[int, Image]]:
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        return (
            read_cameras_binary(os.path.join(sparse_dir, "cameras.bin")),
            read_images_binary(os.path.join(sparse_dir, "images.bin")),
        )
    return (
        read_cameras_text(os.path.join(sparse_dir, "cameras.txt")),
        read_images_text(os.path.join(sparse_dir, "images.txt")),
    )


def get_colmap_camera_params(sparse_dir: str, img_files: list[str]):
    """Per-image (K (4, 4-padded 3x3), w2c (4, 4)) keyed by file name order
    (colmap.py:10-45 analog). Returns (Ks (N, 3, 3), w2cs (N, 4, 4))."""
    cameras, images = load_model(sparse_dir)
    by_name = {im.name: im for im in images.values()}
    Ks, w2cs = [], []
    for name in img_files:
        im = by_name[name]
        cam = cameras[im.camera_id]
        Ks.append(cam.K)
        w2cs.append(im.w2c)
    return np.stack(Ks).astype(np.float32), np.stack(w2cs).astype(np.float32)
