"""Port vs reference: the staged pipeline (pipeline.py).

The 48x32 synthetic scene of tests/test_pipeline_fidelity.py (8 frames,
60 fg + 150 bg ground-truth Gaussians, 3 blur samples, 40 tracks) and its
tiny_cfg (40 fg / 100 bg, 2 bases, S = 3, cap 256, 30 initial-optim
iterations, 6 pose iterations), with 3 steps per stage: no density event
fires (warm-up 2, control every 4). Both packages read one dataset: the
port generates the scene and its dataset (data/synthetic.py, held to the
JAX package's generator by tests/test_torch_synthetic.py; ~1 s here
against ~15 s through the JAX oracle), whose arrays go into the JAX
package's adapter unchanged, and each use gets fresh adapters, so their
random draws run in step. The
JAX side runs with use_pallas=False (the JAX suite's own way of running
the pipeline on the CPU, as tests/test_torch_loop.py does), the port with
device="cpu" (the kernels' plain twins).

Bars and measured values:
  * compute_sharpness_scores, adaptive_slides, val_partition, render_x4
    and the capacity rounding: equal;
  * initialize_scene (the port's init_move_model and Procrustes fit
    monkeypatched to return the JAX package's, converted; the tracks
    carry 0.02 of noise, as tests/test_torch_init.py's): capacities, alive
    masks and the MoveModel equal; bg and the rest 1e-5 abs; the tensors
    of the 30 initial-optim iterations (fg means and coefficients, bases)
    within INIT_REL of their max, and each moved by at least INIT_MOVED
    of its max from where the JAX package's optimisation started;
  * train_static_stage, then train_dynamic_stage with reg_imgs (stage 1's
    renders plus noise) and a batch4_provider, each started in both
    packages from one converted scene: every Gaussian and basis parameter
    within Adam's step bound (2 * steps * lr) of the JAX package's, and
    each tensor's movement within MOVE_REL of the JAX package's movement
    (zero where it is zero), quaternions aside (the bootstrap's Gaussians
    are isotropic: their rotation gradients are rounding noise); the
    MoveModel's groups are not compared (MultiSteps hold their updates
    for 25 steps);
  * render_sharp_frames (bg only, and the full scene downsampled x4) 1e-5
    abs (measured 1.2e-7);
  * run_testing_windows' metrics: PSNR rel 1e-5 (measured 8.7e-8), SSIM
    SSIM_PNG_ATOL abs (measured 1.0e-5: see SSIM_PNG_ATOL);
  * compute_scene_metrics over the JAX run's PNG directory (win_* dirs,
    written by imageio) and over a flat directory with a gt directory:
    PSNR rel 1e-6, SSIM SSIM_PNG_ATOL abs;
  * port alone: a killed static stage, resumed from its in-stage
    checkpoint, equals an uninterrupted one bit for bit; a finished stage
    is restored, not retrained; stage 2 leaves static_scene's tensors
    unchanged (the stage-entry clone) while training its own bg.
"""

import copy
import dataclasses
import os
import shutil
from pathlib import Path

import imageio.v3 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu import pipeline as JPL
from deblur4dgs_tpu.configs import OptimizerConfig as JOptimizerConfig
from deblur4dgs_tpu.configs import RenderConfig as JRenderConfig
from deblur4dgs_tpu.data import synthetic as js
from deblur4dgs_tpu.models.gaussians import Gaussians as JGaussians
from deblur4dgs_tpu.models.motion_bases import MotionBases as JMotionBases
from deblur4dgs_tpu.train import init as JI
from deblur4dgs_tpu_torch import configs as tcfg
from deblur4dgs_tpu_torch import pipeline as TPL
from deblur4dgs_tpu_torch.convert import scene_from_numpy, scene_to_numpy
from deblur4dgs_tpu_torch.data import synthetic as ts
from deblur4dgs_tpu_torch.data.observations import TrackObservations
from deblur4dgs_tpu_torch.models.motion_bases import MotionBases
from deblur4dgs_tpu_torch.train.init import round_capacity
from deblur4dgs_tpu_torch.train.optimizers import param_label
from tests.test_torch_models import jax_to_numpy
from tests.test_torch_models import torch_single_thread  # noqa: F401
from tests.test_torch_train_step import _group_lr

STEPS = 3  # per stage (1 epoch)
# SSIM of the saved renders: in their flat white background
# E[x^2] - E[x]^2 is rounding noise clamped at 0, which moves SSIM by
# ~1e-5 in either package (measured 1.1e-5 on every frame, same sign)
SSIM_PNG_ATOL = 2e-5
# Stage parameters: |moved_port - moved_jax| / |moved_jax| per tensor (a
# wrong frame, target or branch gives ~1); measured at most 1.0e-2 (the
# static stage's bg quaternions, whose gradients on isotropic Gaussians
# are rounding noise: 1e-7 of noise on the means moves them as much)
MOVE_REL = 5e-2
# Initial optimisation from the same Procrustes fit: max |port - jax|
# over the tensor's max, tests/test_torch_init.py's OPT_REL for
# run_initial_optim (measured at most 1.1e-6, bases.transls); each
# tensor's largest movement from its start must reach INIT_MOVED of its
# max (measured 1.3e-2 fg.motion_coefs, 2.0e-2 fg.means, 8.3e-2
# bases.rots, 0.21 bases.transls), so a skipped optimisation fails
INIT_REL = 1e-4
INIT_MOVED = 5e-3
WINDOWS = {"0": [0, 1, 2, 3, 4], "1": [3, 4, 5, 6, 7]}


def cfgs(work_dir, **kw):
    """(JAX, port) PipelineConfigs: tiny_cfg of test_pipeline_fidelity."""
    common = dict(num_fg=40, num_bg=100, num_motion_bases=2,
                  static_epochs=1, dynamic_epochs=1, steps_per_epoch=STEPS,
                  initial_optim_iters=30, pose_opt_iters=6,
                  validate_every=1000, save_videos_every=0)
    common.update(kw)
    j = JPL.PipelineConfig(
        work_dir=str(work_dir / "jax"),
        render=JRenderConfig(num_exposure=3, tile_cap=256, use_pallas=False),
        optim=JOptimizerConfig(warmup_steps=2, control_every=4), **common)
    t = TPL.PipelineConfig(
        work_dir=str(work_dir / "torch"),
        render=tcfg.RenderConfig(num_exposure=3, tile_cap=256),
        optim=tcfg.OptimizerConfig(warmup_steps=2, control_every=4),
        device="cpu", **common)
    return j, t


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x.detach().cpu().numpy())


def jax_synthetic_scene(tscene):
    """The JAX package's SyntheticScene holding the port scene's arrays."""
    def gauss(g):
        return JGaussians(*(_j(getattr(g, f)) for f in (
            "means", "quats", "scales", "colors", "opacities",
            "motion_coefs", "alive")))

    return js.SyntheticScene(
        fg=gauss(tscene.fg), bg=gauss(tscene.bg),
        bases=JMotionBases(_j(tscene.bases.rots), _j(tscene.bases.transls)),
        w2cs=_j(tscene.w2cs), Ks=_j(tscene.Ks), img_wh=tuple(tscene.img_wh),
        exposure=float(tscene.exposure), exp_deltas=_j(tscene.exp_deltas))


@pytest.fixture(scope="module")
def data():
    tscene = ts.make_scene(seed=0, num_fg=60, num_bg=150, num_frames=8,
                           img_wh=(48, 32), device="cpu")
    tdata = ts.generate_dataset(tscene, num_blur_samples=3, num_tracks=40)
    # 0.02 of noise on the 3D tracks (tests/test_torch_init.py's
    # `occlude`): the exact tracks fit the motion bases to rounding level,
    # where the initial optimisation's L1 gradient signs are noise in
    # either package
    noise = np.random.default_rng(5).normal(size=tdata.tracks_3d.shape)
    tdata = tdata._replace(tracks_3d=(
        tdata.tracks_3d + 0.02 * noise).astype(np.float32))
    jdata = js.SyntheticDataset(**{k: jnp.asarray(getattr(tdata, k))
                                   for k in ts.SyntheticDataset._fields})
    return jax_synthetic_scene(tscene), jdata, tscene, tdata


def adapters(data, split="train"):
    """Fresh (JAX, port) adapters over the same arrays."""
    jscene, jdata, tscene, tdata = data
    return (js.SyntheticSceneAdapter(jscene, jdata, split=split),
            ts.SyntheticSceneAdapter(tscene, tdata, split=split))


def to_port(jscene):
    return scene_from_numpy(jax_to_numpy(jscene), device="cpu")


def assert_moves_agree(tscene, jscene, start, lr_cfg):
    """Every Gaussian and basis parameter: within Adam's step bound of the
    JAX package's (2 * steps * lr), and its movement from ``start`` (numpy
    by JAX key) within MOVE_REL of the JAX package's, exactly zero where
    the JAX package's is."""
    jp, tp = jax_to_numpy(jscene), scene_to_numpy(tscene)
    moved = 0
    for name, _ in tscene.named_parameters():
        label = param_label(name)
        if label.startswith("move."):
            continue
        lr = _group_lr(lr_cfg, label)
        assert np.abs(tp[name] - jp[name]).max() <= 2 * STEPS * lr, name
        if name.endswith("quats"):
            # the bootstrap's Gaussians are isotropic (one knn scale on
            # every axis): rotating them changes no render, so these
            # gradients are rounding noise that Adam scales up to +-lr
            continue
        dj = jp[name] - start[name]
        dt = tp[name] - start[name]
        n = float(np.linalg.norm(dj))
        if n == 0.0:
            assert not dt.any(), name
            continue
        assert np.linalg.norm(dt - dj) <= MOVE_REL * n, name
        moved += 1
    return moved


def test_helpers_exact(data):
    ja, ta = adapters(data)
    sj = JPL.compute_sharpness_scores(np.asarray(ja.imgs),
                                      np.asarray(ja.masks))
    st = TPL.compute_sharpness_scores(np.asarray(ta.imgs),
                                      np.asarray(ta.masks))
    np.testing.assert_array_equal(st, sj)
    rng = np.random.default_rng(0)
    for T in (5, 8, 13, 24, 26):
        scores = rng.uniform(1, 9, T)
        for n in (1, max(-(-T // 5), 1)):
            js_, jd = JPL.adaptive_slides(scores, num_windows=n)
            ts_, td = TPL.adaptive_slides(scores, num_windows=n)
            assert js_ == ts_
            assert set(jd) == set(td)
            for k in jd:
                np.testing.assert_array_equal(td[k], jd[k])
    for V, n, T in ((48, 5, 24), (8, 2, 8), (46, 5, 23), (52, 6, 26)):
        assert TPL.val_partition(V, n, T) == JPL.val_partition(V, n, T)
    for n in (0, 1, 255, 256, 257, 80000, 150001):
        assert round_capacity(n) == JPL._round_capacity(n)
    for cap, x4 in ((256, None), (1024, None), (2048, None), (512, 700)):
        jc, tc = cfgs(Path("unused"), tile_cap_x4=x4)
        jc = dataclasses.replace(jc, render=dataclasses.replace(
            jc.render, tile_cap=cap))
        tc = dataclasses.replace(tc, render=dataclasses.replace(
            tc.render, tile_cap=cap))
        assert tc.render_x4().tile_cap == jc.render_x4().tile_cap


@pytest.fixture(scope="module")
def init(data, tmp_path_factory):
    """Both packages' initialize_scene on one adapter. The port's
    Procrustes fit and MoveModel are the JAX package's, converted (the
    fit is held on its own in tests/test_torch_init.py), so the initial
    optimisation starts from the same bases and coefficients in both.
    Also returns where the JAX package's optimisation started (the
    tensors run_initial_optim received)."""
    tmp = tmp_path_factory.mktemp("init")
    jc, tc = cfgs(tmp)
    ja, ta = adapters(data)
    seen = {}
    j_fit, j_opt = JI.init_motion_params_with_procrustes, JI.run_initial_optim

    def fit(*a, **k):
        seen["fit"] = j_fit(*a, **k)
        return seen["fit"]

    def opt(fg, bases, *a, **k):
        seen["start"] = {"fg.means": fg.means,
                         "fg.motion_coefs": fg.motion_coefs,
                         "bases.rots": bases.rots,
                         "bases.transls": bases.transls}
        return j_opt(fg, bases, *a, **k)

    JI.init_motion_params_with_procrustes, JI.run_initial_optim = fit, opt
    try:
        jscene, jscale = JPL.initialize_scene(ja, jc)
    finally:
        JI.init_motion_params_with_procrustes = j_fit
        JI.run_initial_optim = j_opt
    jmove = to_port(jscene).move
    jb, jco, jtr = seen["fit"]

    def port_fit(*a, **k):
        return (MotionBases(_t(jb.rots), _t(jb.transls)), _t(jco),
                TrackObservations(*(_t(x) for x in jtr)))

    orig = TPL.init_move_model, TPL.I.init_motion_params_with_procrustes
    TPL.init_move_model = lambda *a, **k: copy.deepcopy(jmove)
    TPL.I.init_motion_params_with_procrustes = port_fit
    try:
        tscene, tscale = TPL.initialize_scene(ta, tc)
    finally:
        TPL.init_move_model, TPL.I.init_motion_params_with_procrustes = orig
    start = {k: np.asarray(v) for k, v in seen["start"].items()}
    return jscene, jscale, tscene, tscale, start


def test_initialize_scene(init):
    jscene, jscale, tscene, tscale, start = init
    assert tscale == pytest.approx(jscale, rel=1e-6)
    jn, tn = jax_to_numpy(jscene), scene_to_numpy(tscene)
    assert set(jn) == set(tn)
    for k in jn:
        assert tn[k].shape == jn[k].shape, k
        if k.endswith("alive") or k.startswith("move."):
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
        elif k in start:
            n = start[k].shape[0]  # the optimised rows (fg: before padding)
            scale = float(np.abs(jn[k][:n]).max())
            moved = float(np.abs(jn[k][:n] - start[k]).max())
            assert moved >= INIT_MOVED * scale, (k, moved / scale)
            np.testing.assert_allclose(tn[k] / scale, jn[k] / scale,
                                       atol=INIT_REL, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(tn[k], jn[k], atol=1e-5, err_msg=k)
    assert tscene.num_fg == 256 and tscene.num_bg == 256


@pytest.fixture(scope="module")
def stages(data, init, tmp_path_factory):
    """Both packages' stage 1 and stage 2 from one converted scene each;
    the render_sharp_frames of both on stage 1's scene; the testing stage
    over two windows of stage 2's scene."""
    tmp = tmp_path_factory.mktemp("stages")
    jc, tc = cfgs(tmp)
    jscene0, bg_scale = init[:2]
    ja, ta = adapters(data)
    j_static = JPL.train_static_stage(ja, jscene0, jc, bg_scale)
    t_static = TPL.train_static_stage(ta, to_port(jscene0), tc, bg_scale)

    t_on_j = to_port(j_static)
    reg_j = JPL.render_sharp_frames(j_static, ja, jc, bg_only=True)
    reg_t = TPL.render_sharp_frames(t_on_j, ta, tc, bg_only=True)
    ja, ta = adapters(data)
    jscene1, _ = JPL.initialize_scene(ja, jc, static_scene=j_static)
    rng = np.random.default_rng(4)
    guide = rng.uniform(0, 1, (8, 8, 12, 3)).astype(np.float32)
    # the static-reg targets: stage 1's renders, which the lifted bg
    # reproduces to rounding level (L1 gradient signs would be noise in
    # either package and Adam would move every bg parameter by +-lr), plus
    # 0.05 of noise
    reg = (reg_j + 0.05 * rng.normal(size=reg_j.shape)).astype(np.float32)
    ja, ta = adapters(data)
    j_dyn = JPL.train_dynamic_stage(
        ja, jscene1, jc, bg_scale, reg_imgs=reg, tag="dyn",
        batch4_provider=lambda i: jnp.asarray(guide[i])[None])
    t_dyn = TPL.train_dynamic_stage(
        ta, to_port(jscene1), tc, bg_scale, reg_imgs=reg, tag="dyn",
        batch4_provider=lambda i: torch.as_tensor(guide[i])[None])
    x4_j = JPL.render_sharp_frames(j_dyn, ja, jc, downsample=4)
    x4_t = TPL.render_sharp_frames(to_port(j_dyn), ta, tc, downsample=4)

    ja, ta = adapters(data, "val")
    t_dyn_on_j = to_port(j_dyn)
    jm = JPL.run_testing_windows(
        ja, {w: (j_dyn, f) for w, f in WINDOWS.items()}, jc,
        train_num_frames=8)
    tm = TPL.run_testing_windows(
        ta, {w: (t_dyn_on_j, f) for w, f in WINDOWS.items()}, tc,
        train_num_frames=8)
    return dict(jc=jc, tc=tc, j_static=j_static, t_static=t_static,
                starts=(jax_to_numpy(jscene0), jax_to_numpy(jscene1)),
                reg=(reg_j, reg_t), x4=(x4_j, x4_t), j_dyn=j_dyn,
                t_dyn=t_dyn, metrics=(jm, tm), bg_scale=bg_scale)


def test_static_stage(stages):
    s = stages
    moved = assert_moves_agree(s["t_static"], s["j_static"], s["starts"][0],
                               tcfg.SceneLRConfig())
    assert moved == 4  # the bg alone trains in stage 1 (quats aside)


def test_dynamic_stage(stages):
    s = stages
    moved = assert_moves_agree(s["t_dyn"], s["j_dyn"], s["starts"][1],
                               tcfg.SceneLRConfig())
    assert moved >= 10  # fg, bg and bases


def test_render_sharp_frames(stages):
    for j, t in (stages["reg"], stages["x4"]):
        assert t.shape == j.shape and t.dtype == np.float32
        np.testing.assert_allclose(t, j, atol=1e-5)
    assert stages["x4"][1].shape == (8, 8, 12, 3)


def test_run_testing_windows(stages):
    jm, tm = stages["metrics"]
    assert set(tm) == set(jm)
    for k in jm:
        if "psnr" in k:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(tm[k], float(jm[k]),
                                       atol=SSIM_PNG_ATOL, err_msg=k)
    for c in (stages["jc"], stages["tc"]):
        for w in ("win_0005", "win_0308"):
            d = os.path.join(c.work_dir, "results", w, "rgb_test_optim")
            assert len(os.listdir(d)) == 2 * 5 if w == "win_0005" else 2 * 3


def test_compute_scene_metrics(stages, tmp_path):
    results = os.path.join(stages["jc"].work_dir, "results")
    j = JPL.compute_scene_metrics(results)
    t = TPL.compute_scene_metrics(results, device="cpu")
    assert set(t) == set(j) == {"psnr", "ssim"}
    np.testing.assert_allclose(t["psnr"], j["psnr"], rtol=1e-6)
    np.testing.assert_allclose(t["ssim"], j["ssim"], atol=SSIM_PNG_ATOL)
    rng = np.random.default_rng(1)
    rdir, gdir = tmp_path / "r", tmp_path / "g"
    os.makedirs(rdir)
    os.makedirs(gdir)
    for i in range(5):
        a = (rng.uniform(0, 1, (16, 24, 3)) * 255).astype(np.uint8)
        iio.imwrite(rdir / f"{i:05d}.png", a)
        iio.imwrite(gdir / f"{i:05d}.png", np.clip(
            a.astype(int) + rng.integers(-20, 20, a.shape), 0, 255).astype(
                np.uint8))
    j = JPL.compute_scene_metrics(str(rdir), str(gdir))
    t = TPL.compute_scene_metrics(str(rdir), str(gdir), device="cpu")
    np.testing.assert_allclose(t["psnr"], j["psnr"], rtol=1e-6)
    np.testing.assert_allclose(t["ssim"], j["ssim"], atol=SSIM_PNG_ATOL)


def test_static_scene_unchanged_by_stage2(data, stages, tmp_path):
    s = stages
    _, tc = cfgs(tmp_path)
    static = s["t_static"]
    before = {k: v.clone() for k, v in static.state_dict().items()}
    _, ta = adapters(data)
    lifted, _ = TPL.initialize_scene(ta, tc, static_scene=static)
    assert lifted.bg is static.bg  # the handoff shares stage 1's modules
    out = TPL.train_dynamic_stage(ta, lifted, tc, s["bg_scale"],
                                  reg_imgs=s["reg"][1], tag="lifted")
    for k, v in static.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(out.bg.means, static.bg.means)
    assert lifted.bg is static.bg


def test_resume_and_skip(data, init, tmp_path):
    """Port alone: 4 epochs of 2 steps straight, against 2 epochs with a
    checkpoint every 2 steps, the stage checkpoint removed (a kill), then
    4 epochs resumed from step 4: bit for bit (control events at steps 4
    and 8 included). A second call restores the finished stage."""
    _, bg_scale, tscene0 = init[:3]
    kw = dict(static_epochs=4, steps_per_epoch=2)
    _, full = cfgs(tmp_path / "full", **kw)
    ta = adapters(data)[1]
    ref = TPL.train_static_stage(ta, tscene0, full, bg_scale)
    _, half = cfgs(tmp_path / "resumed", static_epochs=2, steps_per_epoch=2,
                   checkpoint_every=2)
    TPL.train_static_stage(adapters(data)[1], tscene0, half, bg_scale)
    shutil.rmtree(os.path.join(half.work_dir, "ckpts"))
    _, resumed = cfgs(tmp_path / "resumed", checkpoint_every=2, **kw)
    res = TPL.train_static_stage(adapters(data)[1], tscene0, resumed,
                                 bg_scale)
    a, b = scene_to_numpy(ref), scene_to_numpy(res)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert not np.array_equal(a["bg.means"],
                              scene_to_numpy(tscene0)["bg.means"])

    calls = []
    orig = TPL.TrainLoop.train_step
    TPL.TrainLoop.train_step = lambda self, *a: calls.append(1)
    try:
        again = TPL.train_static_stage(adapters(data)[1], tscene0, full,
                                       bg_scale)
    finally:
        TPL.TrainLoop.train_step = orig
    assert not calls
    c = scene_to_numpy(again)
    for k in a:
        np.testing.assert_array_equal(c[k], a[k], err_msg=k)
