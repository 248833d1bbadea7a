"""Visualization helpers: depth colormaps, 2D track drawing, video writing.

PyTorch port of deblur4dgs_tpu/vis/utils.py. These run on the host on
numpy arrays, as the reference's do; matplotlib, cv2 and imageio are
imported where they are used.
"""

from __future__ import annotations

import numpy as np


def apply_depth_colormap(
    depth: np.ndarray, acc: np.ndarray | None = None,
    near: float | None = None, far: float | None = None,
) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) turbo-colormapped float in [0, 1]."""
    import matplotlib

    d = np.asarray(depth, np.float32)
    if near is None:
        near = float(np.quantile(d, 0.01))
    if far is None:
        far = float(np.quantile(d, 0.99))
    x = np.clip((d - near) / max(far - near, 1e-6), 0, 1)
    rgb = matplotlib.colormaps["turbo"](x)[..., :3]
    if acc is not None:
        rgb = rgb * np.asarray(acc)[..., None]
    return rgb.astype(np.float32)


def draw_tracks_2d(
    img: np.ndarray, tracks_2d: np.ndarray, track_point_size: int = 2,
    num_trail: int = 8,
) -> np.ndarray:
    """Overlay track trails. img: (H, W, 3) [0,1]; tracks_2d: (P, T, 2),
    drawn up to the last timestep with rainbow colors per track."""
    import cv2
    import matplotlib

    canvas = (np.asarray(img) * 255).astype(np.uint8).copy()
    P, T = tracks_2d.shape[:2]
    colors = (matplotlib.colormaps["hsv"](np.linspace(0, 1, P))[:, :3]
              * 255).astype(np.uint8)
    t0 = max(T - num_trail, 0)
    for p in range(P):
        c = tuple(int(v) for v in colors[p])
        pts = tracks_2d[p, t0:].astype(np.int32)
        for a, b in zip(pts[:-1], pts[1:]):
            cv2.line(canvas, tuple(a), tuple(b), c, 1, cv2.LINE_AA)
        cv2.circle(canvas, tuple(pts[-1]), track_point_size, c, -1,
                   cv2.LINE_AA)
    return canvas.astype(np.float32) / 255.0


def make_video_divisible(video: np.ndarray, block: int = 16) -> np.ndarray:
    """Crop (T, H, W, C) so H, W are codec-friendly multiples."""
    H, W = video.shape[1:3]
    return video[:, : H - H % block or H, : W - W % block or W]


def save_video(path: str, frames: np.ndarray, fps: float = 10.0) -> str:
    """frames: (T, H, W, 3) float [0,1] or uint8. Returns the written path
    (a .gif when imageio has no mp4 backend)."""
    import imageio.v3 as iio

    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    frames = make_video_divisible(frames)
    try:
        iio.imwrite(path, frames, fps=fps)
        return path
    except (OSError, ValueError):
        gif = path.rsplit(".", 1)[0] + ".gif"
        iio.imwrite(gif, frames, duration=1000.0 / fps, loop=0)
        return gif
