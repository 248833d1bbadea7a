"""Port vs reference: the training loop (train/loop.py) and checkpoints.

  * TrainLoop against the reference's TrainLoop for 4 stage-1 steps at
    64x48 (the static branch's three bg-only windows), both started from
    one converted TrainState at step 2, with a control cadence that runs
    a densify + cull (step 4) and an opacity reset (step 6). The
    reference's step runs through its plain XLA compositor (use_pallas=
    False, the JAX suite's own way of running the loop on the CPU,
    tests/test_loop_lifecycle.py). Bars: the loss after every step rtol
    1e-5 (tests/test_torch_train_full.py's bar); alive masks, visibility
    counts and optimizer counters exactly equal after every event; Adam
    moments zero at every (re)allocated slot in both; at the end every
    parameter within test_torch_train_full's Adam step bounds (1e-5 +
    1e-3 * steps * lr where the second moment carries signal, 2 * steps *
    lr elsewhere; slots (re)allocated during the run 7 * steps * lr, see
    test_loop_parameters_and_moments) and the moments within 1e-3 of
    their max;
  * the NaN trap and finish() cases of tests/test_loop_lifecycle.py, and a
    writer that only has add_scalar;
  * the checkpoint round trip (bit-exact) and a step-exact resume: k steps,
    save, load into template_state, m more steps equal k + m steps run
    straight, bit for bit;
  * lift_static_stage and template_state against the reference.
"""

from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.configs import LossesConfig as JLossesConfig
from deblur4dgs_tpu.configs import OptimizerConfig as JOptimizerConfig
from deblur4dgs_tpu.configs import RenderConfig as JRenderConfig
from deblur4dgs_tpu.configs import SceneLRConfig as JSceneLRConfig
from deblur4dgs_tpu.train import checkpoints as jck
from deblur4dgs_tpu.train import loop as jloop
from deblur4dgs_tpu.train import trainer as JT
from deblur4dgs_tpu.train.optimizers import make_optimizer as j_make_opt
from deblur4dgs_tpu_torch import configs as tcfg
from deblur4dgs_tpu_torch.convert import (
    scene_from_numpy,
    scene_to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from deblur4dgs_tpu_torch.train import checkpoints as tck
from deblur4dgs_tpu_torch.train import loop as tloop
from deblur4dgs_tpu_torch.train import trainer as TT
from deblur4dgs_tpu_torch.train.optimizers import make_optimizer as t_make_opt
from deblur4dgs_tpu_torch.train.optimizers import param_label
from tests.test_torch_dense import K48, H48, W48
from tests.test_torch_density import jax_state_from_numpy, jax_state_to_numpy
from tests.test_torch_models import (
    NUM_FRAMES,
    jax_scene,
    jax_to_numpy,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_train_full import frames
from tests.test_torch_train_step import _group_lr

S = 3
CAP = 256
STEPS = 4
START = 2  # the converted state's step: the loops run steps 3-6
# control every 2 steps after step 1; with num_window_frames 1: densify
# when step % 6 > 1, cull when step % 6 > 3, reset when step % 6 == 0
OCFG = dict(warmup_steps=1, control_every=2, reset_opacity_every_n_controls=3,
            densify_xys_grad_threshold=2e-5)
LOOP_FRAMES = 1


def batch_np(seed=3):
    return frames(np.random.default_rng(seed), [4, 5, 6], W48, H48, K48)


def initial_arrays():
    """A converted TrainState: the scene with a third of each part dead."""
    scene = scene_arrays(seed=17)
    rng = np.random.default_rng(17)
    for part in ("fg", "bg"):
        n = scene[f"{part}.alive"].shape[0]
        scene[f"{part}.alive"] = (rng.uniform(size=n) > 0.33).astype(
            np.float32)
    state = TT.init_train_state(scene_from_numpy(scene, device="cpu"),
                                tcfg.SceneLRConfig(), tcfg.OptimizerConfig())
    state.step = START
    return train_state_to_numpy(state)


def port_loop(state, tmp, **kw):
    ocfg = tcfg.OptimizerConfig(**OCFG)
    return tloop.TrainLoop(
        state, t_make_opt(state.scene, tcfg.SceneLRConfig(), ocfg),
        tcfg.LossesConfig(), tcfg.RenderConfig(num_exposure=S, tile_cap=CAP),
        ocfg, LOOP_FRAMES, str(tmp), "first", has_static=True,
        has_dynamic=False, has_reg=False, **{"checkpoint_every": 0, **kw})


class Writer:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loops")
    arrays = initial_arrays()
    bs = batch_np()
    jstate = jax_state_from_numpy(arrays)
    jocfg = JOptimizerConfig(**OCFG)
    jl = jloop.TrainLoop(
        jstate, j_make_opt(jstate.scene, JSceneLRConfig(), jocfg),
        JLossesConfig(), JRenderConfig(num_exposure=S, tile_cap=CAP,
                                       use_pallas=False),
        jocfg, LOOP_FRAMES, str(tmp / "jax"), "first", has_static=True,
        has_dynamic=False, has_reg=False, checkpoint_every=0, log_every=2)
    writer = Writer()
    tl = port_loop(train_state_from_numpy(arrays, device="cpu"), tmp / "t",
                   log_every=2, writer=writer)
    jb = JT.FrameBatch(*map(jnp.asarray, bs))
    tb = TT.FrameBatch(*map(torch.as_tensor, bs))
    per_step = []
    for _ in range(STEPS):
        jloss = float(jl.train_step(jb, None, None, None))
        tloss = float(tl.train_step(tb, None, None, None))
        per_step.append((jloss, tloss, jax_state_to_numpy(jl.state),
                         train_state_to_numpy(tl.state)))
    return arrays, jl, tl, per_step, writer


def test_loop_against_reference(loops):
    arrays, jl, tl, per_step, _ = loops
    n_fg = tl.state.scene.num_fg
    alive0 = np.concatenate([arrays["scene/fg.alive"],
                             arrays["scene/bg.alive"]])
    events = 0
    for step, (jloss, tloss, ja, ta) in enumerate(per_step, START + 1):
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5,
                                   err_msg=f"step {step}")
        for k in ("scene/fg.alive", "scene/bg.alive", "stats/vis_count",
                  "step"):
            np.testing.assert_array_equal(ta[k], ja[k],
                                          err_msg=f"step {step} {k}")
        for k in ja:
            if k.endswith(("/count", "_step")):
                np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
        alive = np.concatenate([ta["scene/fg.alive"], ta["scene/bg.alive"]])
        if step % 2 == 0:  # a control event zeroed the stats
            events += 1
            assert float(np.abs(ta["stats/grad_norm_acc"]).max()) == 0.0
        new = (alive > 0) & (alive0 == 0)
        for label in ("bg.means", "bg.scales"):
            for kind in ("mu", "nu"):
                for m in (ta, ja):
                    mom = np.asarray(m[f"opt/{label}/{kind}/{label}"])
                    if step == 4:  # the densify event
                        assert float(np.abs(mom[new[n_fg:]]).max(
                            initial=0)) == 0.0, (step, label, kind)
        alive0 = alive
    assert events == 2
    # the events changed the scene: slots were born, culled and reset
    first, last = per_step[0][3], per_step[-1][3]
    assert not np.array_equal(first["scene/bg.alive"], last["scene/bg.alive"])
    assert not np.array_equal(per_step[1][3]["scene/bg.alive"],
                              per_step[0][3]["scene/bg.alive"])
    np.testing.assert_array_equal(
        per_step[-1][3]["opt/bg.opacities/mu/bg.opacities"], 0.0)


def test_loop_parameters_and_moments(loops):
    """Slots (re)allocated during the run restart Adam from zero moments
    at the group's count (no bias correction), so their first updates are
    up to (1 - b1) / sqrt(1 - b2) ~ 3.2 lr each and swing with the ratio
    of two or three gradients: they are held to 7 * steps * lr, and their
    moments (zero right after the event in both packages, checked by
    test_loop_against_reference) are not compared."""
    arrays, jl, tl, per_step, _ = loops
    ja, ta = per_step[-1][2], per_step[-1][3]
    lr_cfg = JSceneLRConfig()
    reborn = {part: np.zeros_like(arrays[f"scene/{part}.alive"], bool)
              for part in ("fg", "bg")}
    after = per_step[4 - START - 1][2]  # after the densify at step 4
    for part in reborn:
        mu = after[f"opt/{part}.means/mu/{part}.means"]
        reborn[part] |= np.all(mu == 0, axis=1) & (
            after[f"scene/{part}.alive"] > 0)
    assert reborn["bg"].any()
    for name, _ in tl.state.scene.named_parameters():
        label = param_label(name)
        if label.startswith("move."):
            continue
        key = name  # Gaussian / basis names are their JAX keys
        lr = _group_lr(lr_cfg, label)
        nu = ja[f"opt/{label}/nu/{key}"]
        signal = np.sqrt(nu) >= 1e-3 * np.sqrt(nu).max()
        part = label.split(".")[0]
        new = np.zeros(nu.shape, bool)
        if part in reborn:
            new = np.broadcast_to(
                reborn[part].reshape((-1,) + (1,) * (nu.ndim - 1)), nu.shape)
        diff = np.abs(ta[f"scene/{key}"] - ja[f"scene/{key}"])
        assert diff[new].max(initial=0) <= 7 * STEPS * lr, name
        assert diff[signal & ~new].max(initial=0) <= \
            1e-5 + 1e-3 * STEPS * lr, name
        assert diff[~signal & ~new].max(initial=0) <= 2 * STEPS * lr, name
        for kind in ("mu", "nu"):
            r = ja[f"opt/{label}/{kind}/{key}"]
            scale = float(np.abs(r).max()) + 1e-30
            np.testing.assert_allclose(ta[f"opt/{label}/{kind}/{key}"][~new]
                                       / scale, r[~new] / scale, atol=1e-3,
                                       rtol=0,
                                       err_msg=f"{name} {kind}")


def test_writer_and_finish(loops, capsys):
    _, _, tl, _, writer = loops
    assert [s for s, _ in writer.scalars["train/loss"]] == [4, 6]
    for tag in ("train/num_rays_per_sec", "train/num_fg_alive",
                "train/num_bg_alive", "train/static/rgb_loss"):
        assert len(writer.scalars[tag]) == 2, tag
    assert writer.scalars["train/num_bg_alive"][-1][1] == float(
        tl.state.scene.bg.num_alive())
    assert isinstance(tl.losses, deque) and tl.losses.maxlen is not None
    tl.finish()
    out = capsys.readouterr().out
    assert "tile_overflow" in out and "static=" in out


def test_nan_trap_at_log_cadence(tmp_path):
    loop = object.__new__(tloop.TrainLoop)
    loop.__dict__.update(
        state=None, losses=deque(maxlen=16), _last_aux=None, global_step=0,
        log_every=2, writer=None, checkpoint_every=0, _rss_every=0,
        work_dir=str(tmp_path), ocfg=tcfg.OptimizerConfig(),
        num_window_frames=8, epoch=0,
        step_fn=lambda s, *a: (s, torch.tensor(float("nan")), {}))
    loop.train_step(None, None, None, None)  # step 1: not a log step
    with pytest.raises(FloatingPointError, match="step 2"):
        loop.train_step(None, None, None, None)


def test_finish_traps_final_nan(tmp_path):
    loop = object.__new__(tloop.TrainLoop)
    loop.losses = deque([torch.tensor(1.0), torch.tensor(float("nan"))])
    loop._last_aux = None
    loop.global_step = 7
    loop.work_dir = str(tmp_path)
    with pytest.raises(FloatingPointError):
        loop.finish()


def test_finish_noop_when_empty(tmp_path):
    loop = object.__new__(tloop.TrainLoop)
    loop.losses = deque()
    loop._last_aux = None
    loop.global_step = 0
    loop.work_dir = str(tmp_path)
    loop.finish()


def test_checkpoint_round_trip_and_resume(tmp_path):
    """k=2 steps, checkpoint (the loop's own cadence), load into a
    template, m=2 more steps == 4 straight steps, bit for bit (steps 3-6,
    control events at steps 4 and 6)."""
    arrays = initial_arrays()
    tb = TT.FrameBatch(*map(torch.as_tensor, batch_np(5)))
    straight = port_loop(train_state_from_numpy(arrays, device="cpu"),
                         tmp_path / "a")
    for _ in range(4):
        straight.train_step(tb, None, None, None)
    first = port_loop(train_state_from_numpy(arrays, device="cpu"),
                      tmp_path / "b", checkpoint_every=2)
    first.epoch = 3
    for _ in range(2):
        first.train_step(tb, None, None, None)
    path = tmp_path / "b" / "checkpoints" / "last"
    saved = train_state_to_numpy(first.state)
    n_fg, n_bg = first.state.scene.num_fg, first.state.scene.num_bg
    template = tck.template_state(n_fg, n_bg, 4, NUM_FRAMES, device="cpu")
    state, epoch = tck.load_checkpoint(str(path), template)
    assert state is template and epoch == 3 and state.step == START + 2
    loaded = train_state_to_numpy(state)
    assert set(loaded) == set(saved)
    for k in saved:
        np.testing.assert_array_equal(loaded[k], saved[k], err_msg=k)
    resumed = port_loop(state, tmp_path / "c")
    assert resumed.global_step == START + 2
    for _ in range(2):
        resumed.train_step(tb, None, None, None)
    a, b = train_state_to_numpy(straight.state), train_state_to_numpy(
        resumed.state)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    with pytest.raises(ValueError):
        tck.load_checkpoint(str(path), tck.template_state(
            n_fg + 256, n_bg, 4, NUM_FRAMES, device="cpu"))


def test_template_state_and_lift_static_stage():
    jt = jck.template_state(256, 512, 4, NUM_FRAMES)
    tt = tck.template_state(256, 512, 4, NUM_FRAMES, device="cpu")
    ja, ta = jax_state_to_numpy(jt), train_state_to_numpy(tt)
    assert set(ja) == set(ta)
    for k in ja:
        assert ta[k].shape == np.asarray(ja[k]).shape, k
        if not k.startswith("scene/move."):
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    fresh = scene_arrays(seed=1, T=6)
    static = scene_arrays(seed=2, T=NUM_FRAMES)
    for a, b in ((fresh, static), (fresh, scene_arrays(seed=3, T=6))):
        j = jck.lift_static_stage(jax_scene(a), jax_scene(b))
        t = tck.lift_static_stage(scene_from_numpy(a, device="cpu"),
                                  scene_from_numpy(b, device="cpu"))
        jn, tn = jax_to_numpy(j), scene_to_numpy(t)
        assert set(jn) == set(tn)
        for k in jn:
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
