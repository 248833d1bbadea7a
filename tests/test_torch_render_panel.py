"""Port vs reference: keyframed camera paths (vis/render_panel.py).

Three seeded keyframes (cameras orbiting a point, fov and time varying) go
to both packages' interpolate_camera_path: clamped and looped, tension 0
(Catmull-Rom) and 0.5, with and without times, frame counts below and
above the segment count; one keyframe. Bars: the w2c matrices within
W2C_ATOL (float32 quaternion logs / exps and 4x4 inverses in two
libraries; measured at most 7.2e-7), fov and time within 1e-5 (measured
1.2e-7 and 9.5e-7), the frame allocation equal; the path passes through every
keyframe (1e-5). render_camera_path with a stub callback that records its
(camera, size, time) calls: the same calls as the JAX package's (c2w
1e-5, times equal after rounding and clamping), the frames stacked in
order, and the video an animated PNG of those frames.
"""

import numpy as np
import pytest

from deblur4dgs_tpu.vis import render_panel as jrp
from deblur4dgs_tpu_torch.vis import png
from deblur4dgs_tpu_torch.vis import render_panel as trp
from tests.test_torch_models import torch_single_thread  # noqa: F401
from tests.test_torch_trajectories import _look

W2C_ATOL = 1e-5


def keyframes(pkg, n=3, times=True, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = 0.5 * i + rng.uniform(-0.1, 0.1)
        eye = np.array([2.5 * np.sin(a), rng.uniform(-0.3, 0.3),
                        -2.5 * np.cos(a)])
        c2w = np.linalg.inv(_look(eye, rng.normal(0, 0.05, 3)))
        out.append(pkg.Keyframe(
            c2w=c2w.astype(np.float32), fov=float(rng.uniform(0.8, 1.2)),
            time=float(2 * i + rng.integers(0, 2)) if times else None))
    return out


@pytest.mark.parametrize("loop,tension,times,num_frames", [
    (False, 0.0, True, 10), (True, 0.5, False, 10), (True, 0.5, True, 2)])
def test_interpolate_camera_path(loop, tension, times, num_frames):
    jw, jf, jtimes = jrp.interpolate_camera_path(
        keyframes(jrp, times=times), num_frames, loop=loop, tension=tension)
    tw, tf, ttimes = trp.interpolate_camera_path(
        keyframes(trp, times=times), num_frames, loop=loop, tension=tension)
    assert tw.shape == jw.shape and tf.shape == jf.shape
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=W2C_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
    if times:
        np.testing.assert_allclose(ttimes.numpy(), np.asarray(jtimes),
                                   atol=1e-5)
    else:
        assert ttimes is None and jtimes is None
    if num_frames >= 3:  # every segment has frames: keyframe 0 opens it
        kf = keyframes(trp, times=times)
        np.testing.assert_allclose(np.linalg.inv(tw[0].numpy()), kf[0].c2w,
                                   atol=1e-5)
        if not loop:
            np.testing.assert_allclose(np.linalg.inv(tw[-1].numpy()),
                                       kf[-1].c2w, atol=1e-5)


def test_one_keyframe():
    jw, jf, jt = jrp.interpolate_camera_path(keyframes(jrp, n=1), 5)
    tw, tf, tt = trp.interpolate_camera_path(keyframes(trp, n=1), 5)
    assert tw.shape == (5, 4, 4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=W2C_ATOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    with pytest.raises(ValueError):
        trp.interpolate_camera_path([], 5)


class Recorder:
    """A render callback that records its calls and returns a frame that
    encodes the call's index and time."""

    def __init__(self):
        self.calls = []

    def __call__(self, cam, wh, t):
        self.calls.append((np.asarray(cam.c2w), cam.fov, cam.aspect, wh, t))
        W, H = wh
        img = np.zeros((H, W, 3), np.uint8)
        img[..., 0] = len(self.calls)
        img[..., 1] = 255 if t is None else t
        return img


@pytest.mark.parametrize("times", [True, False])
def test_render_camera_path(tmp_path, times):
    rec_j, rec_t = Recorder(), Recorder()
    kw = dict(loop=True, tension=0.2, num_scene_frames=5, fps=20.0)
    jframes, jvideo = jrp.render_camera_path(
        rec_j, keyframes(jrp, times=times), (32, 16), 11, **kw)
    tframes, tvideo = trp.render_camera_path(
        rec_t, keyframes(trp, times=times), (32, 16), 11,
        out_path=str(tmp_path / "path_0.mp4"), **kw)
    assert jvideo is None and tvideo == str(tmp_path / "path_0.png")
    assert len(rec_t.calls) == len(rec_j.calls) == 11
    for (tc, tfov, ta, twh, tt_), (jc, jfov, ja, jwh, jt_) in zip(
            rec_t.calls, rec_j.calls):
        np.testing.assert_allclose(tc, jc, atol=1e-5)
        assert abs(tfov - jfov) <= 1e-5 and ta == ja and twh == jwh
        assert tt_ == jt_
        assert tt_ is None or 0 <= tt_ <= 4
    np.testing.assert_array_equal(tframes, np.asarray(jframes))
    assert tframes.shape == (11, 16, 32, 3)
    video, delays = png.read_apng(tvideo)
    np.testing.assert_array_equal(video, tframes)
    assert delays == pytest.approx([0.05] * 11)
