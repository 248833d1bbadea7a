"""Port vs reference: the viewer (vis/renderer.py, vis/viewer.py) and the
CLI's ``view`` / ``render-path``.

One seeded 48x32 scene (120 fg with 4 motion bases, 180 bg, 8 frames)
goes to both packages (convert.scene_from_numpy). The JAX Renderer runs
its Pallas kernels in interpret mode (its default use_pallas=True), with
its render jitted, the port its K5 twin on the CPU.

  * Renderer.render_fn, posed (t = 5), canonical (t = None) and with the
    track overlay: the uint8 frames equal the JAX package's (measured:
    equal); the cached fg tracks within 1e-5 (measured 2.4e-7); the
    overlay, which the port draws with numpy and the JAX package with cv2,
    under tests/test_torch_vis_utils.py's drawing bar;
  * the HTTP endpoints of a DynamicViewer on port 0: the page, /render
    (PNG frames equal to render_fn's, posed, canonical and with tracks),
    /keyframe, /keyframes, /path_cameras (equal to
    interpolate_camera_path), /render_path (an animated PNG under
    work_dir/camera_paths whose frames equal render_camera_path's),
    /keyframe_clear and an unknown route (404);
  * a TrainingViewer on a TrainLoop (tests/test_torch_loop.py's stage-1
    loop at 64x48, 4 steps with a densify + cull and an opacity reset)
    while a client thread POSTs renders: the TrainState equals the loop's
    without a viewer, bit for bit; a paused viewer holds the step back;
  * the CLI: ``view``'s arguments, ``view --device cpu`` serving the
    checkpoint's scene, and ``render-path --device cpu`` from a checkpoint
    the port wrote, of the whole clip and of a phase-B window's shape
    (bases over the window's frames, the exposure model over the clip's):
    the video's frames equal render_camera_path over the same scene
    (whose render_fn the first case holds to the JAX package's).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.models import scene as jscene
from deblur4dgs_tpu.vis import renderer as jren
from deblur4dgs_tpu_torch import cli
from deblur4dgs_tpu_torch import configs as tcfg
from deblur4dgs_tpu_torch.convert import (
    scene_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from deblur4dgs_tpu_torch.train import trainer as TT
from deblur4dgs_tpu_torch.train.checkpoints import save_checkpoint
from deblur4dgs_tpu_torch.vis import png
from deblur4dgs_tpu_torch.vis import render_panel as trp
from deblur4dgs_tpu_torch.vis import renderer as tren
from deblur4dgs_tpu_torch.vis import viewer as tview
from tests.test_torch_loop import (
    LOOP_FRAMES,
    STEPS,
    batch_np,
    initial_arrays,
    port_loop,
)
from tests.test_torch_models import (
    NUM_FRAMES,
    jax_scene,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_vis_utils import assert_tracks_drawn_alike

W, H = 48, 32
KW = dict(num_exposure=3, cap=256)
N_FG, N_BG, N_BASES = 120, 180, 4
C2W = np.eye(4, dtype=np.float32)
C2W[:3, 3] = (0.05, -0.02, 1.0)  # the scene's means lie at z 2-3


@pytest.fixture(scope="module")
def arrays():
    return scene_arrays(seed=21, n_fg=N_FG, n_bg=N_BG, k_bases=N_BASES)


@pytest.fixture(scope="module")
def renderers(arrays):
    """(JAX, port) Renderers of the scene. The JAX Renderer's render and
    track poses run jitted, each compiled once (op by op they compile
    every op for itself); they are restored after the module."""
    orig = jren.render, jscene.compute_poses_fg
    jren.render = jax.jit(orig[0], static_argnums=(1, 4), static_argnames=(
        "mode", "stage", "num_exposure", "cap", "use_pallas"))
    jscene.compute_poses_fg = jax.jit(orig[1])
    yield (jren.Renderer(jax_scene(arrays), NUM_FRAMES, **KW),
           tren.Renderer(scene_from_numpy(arrays, device="cpu"),
                         NUM_FRAMES, **KW))
    jren.render, jscene.compute_poses_fg = orig


def cam(pkg, c2w=C2W, fov=np.pi / 3):
    return pkg.CameraState(fov=fov, aspect=W / H, c2w=c2w)


@pytest.mark.parametrize("case", ["posed", "canonical", "tracks"])
def test_render_fn_matches_reference(renderers, case):
    jr, tr = renderers
    t = None if case == "canonical" else 5
    tracks = case == "tracks"
    j = jr.render_fn(cam(jren), (W, H), t, render_tracks=tracks)
    p = tr.render_fn(cam(tren), (W, H), t, render_tracks=tracks)
    assert p.shape == (H, W, 3) and p.dtype == np.uint8
    if not tracks:
        np.testing.assert_array_equal(p, j)
        assert 20 < p.mean() < 235  # the scene fills part of the frame
        return
    np.testing.assert_allclose(tr._fg_tracks(), jr._fg_tracks(), atol=1e-5)
    plain = tr.render_fn(cam(tren), (W, H), t)
    f32 = np.float32
    assert_tracks_drawn_alike(p.astype(f32) / 255, j.astype(f32) / 255,
                              plain.astype(f32) / 255)


def _post(base, route, body):
    req = urllib.request.Request(base + route, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers.get("Content-Type"), r.read()


def _png(blob, tmp_path):
    p = tmp_path / "frame.png"
    p.write_bytes(blob)
    return png.read_png(str(p))


def test_http_endpoints(renderers, tmp_path):
    tr = renderers[1]
    v = tview.DynamicViewer(tr.render_fn, NUM_FRAMES, img_wh=(W, H), port=0,
                            work_dir=str(tmp_path))
    v.serve_forever(background=True)
    try:
        base = f"http://127.0.0.1:{v.port}"
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            page = r.read().decode()
        assert "max=7" in page and "width=48 height=32" in page
        for body, t, tracks in (({"t": 5}, 5, False),
                                ({"t": 5, "canonical": True}, None, False),
                                ({"t": 5, "tracks": True}, 5, True)):
            ctype, blob = _post(base, "/render",
                                {"c2w": C2W.tolist(), **body})
            assert ctype == "image/png"
            np.testing.assert_array_equal(
                _png(blob, tmp_path),
                tr.render_fn(cam(tren), (W, H), t, render_tracks=tracks))
        rng = np.random.default_rng(3)
        for i in range(3):
            c2w = C2W.copy()
            c2w[:3, 3] += rng.normal(0, 0.05, 3)
            _, blob = _post(base, "/keyframe", {"c2w": c2w.tolist(),
                                                "fov": 1.0, "time": 2 * i})
            assert json.loads(blob) == {"num": i + 1}
        with urllib.request.urlopen(base + "/keyframes", timeout=60) as r:
            kfs = json.loads(r.read())
        assert kfs["num"] == 3 and [k["time"] for k in kfs["keyframes"]] == \
            [0.0, 2.0, 4.0]
        _, blob = _post(base, "/path_cameras", {"num_frames": 7,
                                                "tension": 0.1})
        got = json.loads(blob)
        w2cs, fovs, times = trp.interpolate_camera_path(v.keyframes, 7,
                                                        tension=0.1)
        np.testing.assert_allclose(got["c2ws"],
                                   np.linalg.inv(w2cs.numpy()), atol=1e-6)
        np.testing.assert_allclose(got["fovs"], fovs.numpy(), atol=1e-7)
        np.testing.assert_allclose(got["times"], times.numpy(), atol=1e-6)
        _, blob = _post(base, "/render_path", {"num_frames": 5, "fps": 10})
        got = json.loads(blob)
        assert got["num_frames"] == 5
        assert got["video"] == str(tmp_path / "camera_paths" / "path_0.png")
        frames, _ = png.read_apng(got["video"])
        want, _ = trp.render_camera_path(tr.render_fn, v.keyframes, (W, H),
                                         5, num_scene_frames=NUM_FRAMES)
        np.testing.assert_array_equal(frames, want)
        _, blob = _post(base, "/keyframe_clear", {})
        assert json.loads(blob) == {"num": 0}
        _, blob = _post(base, "/render_path", {"num_frames": 5})
        assert "error" in json.loads(blob)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/nope", {})
        assert e.value.code == 404
    finally:
        v.close()


def test_training_viewer_loop_is_bit_exact(tmp_path):
    arrays = initial_arrays()
    tb = TT.FrameBatch(*map(torch.as_tensor, batch_np()))

    def run(viewer, name):
        loop = port_loop(train_state_from_numpy(arrays, device="cpu"),
                         tmp_path / name, viewer=viewer)
        for _ in range(STEPS):
            loop.train_step(tb, None, None, None)
        return loop, train_state_to_numpy(loop.state)

    _, plain = run(None, "plain")
    v = tview.TrainingViewer(LOOP_FRAMES, img_wh=(W, H), port=0, **KW)
    v.serve_forever(background=True)
    stop, frames, errors = threading.Event(), [], []

    def client():
        base = f"http://127.0.0.1:{v.port}"
        try:
            while not stop.is_set():
                frames.append(_png(_post(base, "/render", {
                    "c2w": C2W.tolist(), "t": 0, "tracks": True})[1],
                    tmp_path))
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    th = threading.Thread(target=client)
    th.start()
    try:
        # paused: the first step waits until the status flips back
        v.state.status = "paused"
        timer = threading.Timer(0.3, setattr, (v.state, "status",
                                               "training"))
        timer.start()
        tic = time.time()
        loop, viewed = run(v, "viewed")
        assert time.time() - tic >= 0.3
    finally:
        stop.set()
        th.join(timeout=120)
        v.close()
    assert not th.is_alive() and not errors, errors
    assert frames and all(f.shape == (H, W, 3) for f in frames)
    assert v._renderer.scene is loop.state.scene
    assert v.num_frames == LOOP_FRAMES
    assert v.state.num_train_rays_per_sec > 0
    assert set(viewed) == set(plain)
    for k in plain:
        np.testing.assert_array_equal(viewed[k], plain[k], err_msg=k)


@pytest.fixture(scope="module")
def checkpoints(arrays, tmp_path_factory):
    """Port checkpoints (save_checkpoint of a TrainState) of the test scene
    ('clip': bases and exposure model over the 8 frames) and of a phase-B
    window's shape ('window': bases over 5 frames beside the clip's
    exposure model, as initialize_scene builds a window from stage 1):
    kind -> (path, arrays, frames)."""
    window = dict(arrays)
    for k in ("bases.rots", "bases.transls"):
        window[k] = np.ascontiguousarray(arrays[k][:, :5])
    out = {}
    for kind, arr, T in (("clip", arrays, NUM_FRAMES), ("window", window, 5)):
        path = tmp_path_factory.mktemp(kind) / "ckpts" / "win_0005" / "last"
        state = TT.init_train_state(scene_from_numpy(arr, device="cpu"),
                                    tcfg.SceneLRConfig(),
                                    tcfg.OptimizerConfig())
        save_checkpoint(str(path), state, epoch=3)
        out[kind] = (str(path), arr, T)
    return out


def ckpt_args(path, num_frames=NUM_FRAMES):
    return ["--checkpoint", path, "--num-frames", str(num_frames),
            "--num-fg", str(N_FG), "--num-bg", str(N_BG),
            "--num-motion-bases", str(N_BASES)]


def test_view_arguments():
    args = cli.build_parser().parse_args(["view"] + ckpt_args("c"))
    assert (args.port, args.device, args.num_frames, args.num_fg,
            args.num_bg, args.num_motion_bases) == (8890, "cuda", 8, 120,
                                                    180, 4)
    args = cli.build_parser().parse_args(
        ["view", "--port", "0", "--device", "cpu"] + ckpt_args("c"))
    assert (args.port, args.device) == (0, "cpu")
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["view", "--checkpoint", "c"])


def test_view_serves_the_checkpoint(checkpoints, renderers, monkeypatch):
    served = []
    monkeypatch.setattr(tview.DynamicViewer, "serve_forever",
                        lambda self, background=True: served.append(
                            (self, background)))
    cli.main(["view", "--device", "cpu", "--port", "0"]
             + ckpt_args(checkpoints["clip"][0]))
    (v, background), = served
    assert background is False and v.num_frames == NUM_FRAMES
    np.testing.assert_array_equal(
        v.render_fn(cam(tren), (W, H), 5),
        renderers[1].render_fn(cam(tren), (W, H), 5))


@pytest.mark.parametrize("kind", ["clip", "window"])
def test_render_path_cli(checkpoints, tmp_path, capsys, kind):
    path, arr, T = checkpoints[kind]
    rng = np.random.default_rng(9)
    kf_json = []
    for i in range(3):
        c2w = C2W.copy()
        c2w[:3, 3] += rng.normal(0, 0.05, 3)
        kf_json.append({"c2w": c2w.tolist(), "fov": 1.0 + 0.05 * i,
                        "time": 2 * i})
    kf_path = tmp_path / "kf.json"
    kf_path.write_text(json.dumps(kf_json))
    cli.main(["render-path", "--keyframes", str(kf_path), "--out",
              str(tmp_path / "path.mp4"), "--path-frames", "6", "--width",
              str(W), "--height", str(H), "--fps", "12", "--device", "cpu"]
             + ckpt_args(path, T))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"video": str(tmp_path / "path.png"), "frames": 6}
    frames, delays = png.read_apng(out["video"])
    assert frames.shape == (6, H, W, 3)
    assert delays == pytest.approx([1 / 12] * 6)
    kfs = [trp.Keyframe(c2w=np.asarray(k["c2w"], np.float32), fov=k["fov"],
                        time=k["time"]) for k in kf_json]
    renderer = tren.Renderer(scene_from_numpy(arr, device="cpu"), T, **KW)
    want, _ = trp.render_camera_path(renderer.render_fn, kfs, (W, H), 6,
                                     num_scene_frames=T)
    np.testing.assert_array_equal(frames, want)
