"""Port vs reference: the host-side visualization helpers (vis/utils.py) on
numpy alone, and the animated PNG of vis/png.py.

  * the turbo colormap (apply_depth_colormap: the port's copy of
    matplotlib's 256-entry table, looked up as matplotlib does) and the
    hsv colours of the track overlay (the segment map sampled as
    matplotlib samples it) against matplotlib, to 1e-6 (measured: equal);
  * draw_tracks_2d against the JAX package's cv2 drawing (cv2.line and
    cv2.circle with LINE_AA). The port draws its own anti-aliased lines and
    discs, whose cross-section is fitted to cv2's but whose coverage
    rounds differently, so pixels are not equal. The bar
    (assert_tracks_drawn_alike): the pixels either drawing changes lie
    within one pixel of the pixels the other changes (so no stroke is
    missing, shifted or extra), the mean |port - cv2| over the changed
    pixels is at most TRACK_MEAN_STROKE (measured 0.020-0.030 on these
    cases, a difference of a few levels of 255 along the strokes) and over
    the whole image at most TRACK_MEAN_IMAGE (measured 0.004-0.015), and
    the last track's disc centre holds its hsv colour exactly in both;
  * save_video: an animated PNG at <stem>.png that read_apng and Pillow
    both read back as the N frames, with the frame delay of the fps;
    make_video_divisible's crop applied as in the reference.
"""

import os

import matplotlib
import numpy as np
import pytest
from PIL import Image
from scipy.ndimage import binary_dilation

from deblur4dgs_tpu.vis import utils as jvis
from deblur4dgs_tpu_torch.vis import png
from deblur4dgs_tpu_torch.vis import utils as tvis
from tests.test_torch_models import torch_single_thread  # noqa: F401

TRACK_MEAN_STROKE = 0.05
TRACK_MEAN_IMAGE = 0.02


def undrawn(img):
    """The canvas draw_tracks_2d starts from: img quantized to 8 bits, as a
    float in [0, 1]."""
    return (np.asarray(img) * 255).astype(np.uint8).astype(np.float32) / 255


def assert_tracks_drawn_alike(port, ref, base):
    """The bar of draw_tracks_2d against cv2 (module docstring). port, ref:
    the two (H, W, 3) float outputs over the same canvas, base (undrawn)."""
    changed_p = (port != base).any(-1)
    changed_r = (ref != base).any(-1)
    assert changed_r.any()
    ring = np.ones((3, 3), bool)
    assert not (changed_p & ~binary_dilation(changed_r, ring)).any()
    assert not (changed_r & ~binary_dilation(changed_p, ring)).any()
    diff = np.abs(port - ref)
    assert diff[changed_p | changed_r].mean() <= TRACK_MEAN_STROKE
    assert diff.mean() <= TRACK_MEAN_IMAGE


def test_turbo_and_hsv_tables_match_matplotlib():
    x = np.linspace(0, 1, 1001)
    np.testing.assert_allclose(tvis._lookup(tvis._TURBO, x),
                               matplotlib.colormaps["turbo"](x)[:, :3],
                               atol=1e-6, rtol=0)
    for n in (1, 2, 5, 10, 37, 256):
        x = np.linspace(0, 1, n)
        np.testing.assert_allclose(tvis._lookup(tvis._HSV, x),
                                   matplotlib.colormaps["hsv"](x)[:, :3],
                                   atol=1e-6, rtol=0)
    x32 = np.random.default_rng(0).uniform(0, 1, 500).astype(np.float32)
    np.testing.assert_allclose(tvis._lookup(tvis._TURBO, x32),
                               matplotlib.colormaps["turbo"](x32)[:, :3],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("near_far", [None, (0.5, 4.0)])
def test_apply_depth_colormap_with_nan(near_far):
    rng = np.random.default_rng(3)
    depth = rng.uniform(1, 5, (20, 30)).astype(np.float32)
    acc = rng.uniform(0, 1, (20, 30)).astype(np.float32)
    kw = {} if near_far is None else dict(near=near_far[0], far=near_far[1])
    if near_far is not None:
        depth[3, 4] = np.nan  # matplotlib's "bad" colour: black
    np.testing.assert_allclose(tvis.apply_depth_colormap(depth, acc, **kw),
                               jvis.apply_depth_colormap(depth, acc, **kw),
                               atol=1e-6, rtol=0)


def _walks(seed, P, T, W, H):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(0, 3, (P, T, 2)), axis=1)
            + np.array([W / 2, H / 2])).astype(np.float32)


@pytest.mark.parametrize("case", ["walks", "walks_flat", "long", "offimage"])
def test_draw_tracks_against_cv2(case):
    rng = np.random.default_rng(11)
    H, W = 48, 64
    img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    if case == "walks":
        tracks = _walks(1, 10, 12, W, H)
    elif case == "walks_flat":
        img = np.full((H, W, 3), 0.3, np.float32)
        tracks = _walks(2, 10, 12, W, H)
    elif case == "long":
        tracks = rng.uniform(0, [W, H], (5, 12, 2)).astype(np.float32)
    else:  # trails leaving the image on every side
        tracks = rng.uniform(-30, [W + 30, H + 30], (6, 9, 2)).astype(
            np.float32)
    port = tvis.draw_tracks_2d(img, tracks)
    ref = jvis.draw_tracks_2d(img, tracks)
    assert port.dtype == ref.dtype == np.float32
    assert_tracks_drawn_alike(port, ref, undrawn(img))
    x, y = tracks[-1, -1].astype(np.int32)
    if 0 <= x < W and 0 <= y < H:
        colour = (np.asarray(matplotlib.colormaps["hsv"](1.0))[:3] * 255
                  ).astype(np.uint8).astype(np.float32) / 255
        np.testing.assert_array_equal(port[y, x], colour)
        np.testing.assert_array_equal(ref[y, x], colour)


@pytest.mark.parametrize("dtype", ["float", "uint8"])
def test_save_video_apng(tmp_path, dtype):
    rng = np.random.default_rng(5)
    frames = rng.uniform(size=(4, 37, 50, 3)).astype(np.float32)
    if dtype == "uint8":
        frames = (frames * 255).astype(np.uint8)
    path = tvis.save_video(str(tmp_path / "rgb_3.mp4"), frames, fps=12.5)
    assert path == str(tmp_path / "rgb_3.png") and os.path.isfile(path)
    want = frames if dtype == "uint8" else (
        np.clip(frames, 0, 1) * 255).astype(np.uint8)
    want = jvis.make_video_divisible(want)
    assert want.shape == (4, 32, 48, 3)
    got, delays = png.read_apng(path)
    np.testing.assert_array_equal(got, want)
    assert delays == pytest.approx([0.08] * 4, rel=1e-6)
    np.testing.assert_array_equal(png.read_png(path), want[0])
    with Image.open(path) as im:
        assert im.n_frames == 4 and im.is_animated
        seen = []
        for i in range(im.n_frames):
            im.seek(i)
            seen.append(np.asarray(im.convert("RGB")))
            assert im.info["duration"] == pytest.approx(80.0)
    np.testing.assert_array_equal(np.stack(seen), want)


def test_apng_of_grey_and_rgba_frames(tmp_path):
    rng = np.random.default_rng(6)
    for shape in ((3, 9, 7), (2, 9, 7, 4)):
        frames = rng.integers(0, 256, shape, dtype=np.uint8)
        p = str(tmp_path / f"a{len(shape)}.png")
        png.write_apng(p, frames, fps=30.0)
        got, delays = png.read_apng(p)
        np.testing.assert_array_equal(got, frames)
        assert delays == pytest.approx([1 / 30] * shape[0])
    with pytest.raises(ValueError):
        png.write_apng(str(tmp_path / "bad.png"),
                       np.zeros((2, 4, 4, 2), np.uint8))
