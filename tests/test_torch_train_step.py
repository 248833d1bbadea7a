"""Port vs reference: three dynamic train steps.

128x128 frame (64 tiles: the bucketed window path), 300 Gaussians, S=3
sub-frames, tile cap 256, epoch 25 (> 20: the pose-net gate is open), both
packages starting from identical parameters. The JAX step runs as its
suite runs it on the CPU (Pallas K1 in interpret mode, backward via K3).

Compared after every step: the loss and every aux value (rtol 1e-5: same
float32 math, sums in another order). After step 3: DensityStats (visibility
counts and radii equal; accumulated gradient norms rtol 1e-4), the Adam
moments of every group (atol 1e-3 of the tensor's max |moment|), the
MultiSteps mean gradient and mini-step counter of the two MoveModel groups
(still accumulating at step 3, so those parameters must be unchanged), and
every parameter.

Parameter tolerance. An Adam step moves a parameter by about lr * m/sqrt(v)
whatever the gradient's size, so where the true gradient is zero (a
quaternion's radial direction, the null directions of a 6D rotation, a
Gaussian no pixel sees) float32 roundoff in either package decides the
sign of a full lr-sized step. Elements whose second moment is above 1e-6 of
the tensor's max (real gradient signal) must agree to 1e-5 + 1e-3 * (3 lr);
the rest only to Adam's own step bound 2 * 3 * lr. At these sizes no tile
holds more than one 128-Gaussian chunk, so the early-stop rule never
differs between the packages here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.configs import (
    LossesConfig,
    OptimizerConfig,
    RenderConfig,
    SceneLRConfig,
)
from deblur4dgs_tpu.train import trainer as JT
from deblur4dgs_tpu.train.optimizers import make_optimizer as j_make_opt
from deblur4dgs_tpu_torch import configs as tcfg
from deblur4dgs_tpu_torch.convert import jax_key, scene_from_numpy, scene_to_numpy
from deblur4dgs_tpu_torch.train import trainer as TT
from deblur4dgs_tpu_torch.train.optimizers import make_optimizer as t_make_opt
from deblur4dgs_tpu_torch.train.optimizers import param_label
from tests.test_torch_models import (
    K128,
    NUM_FRAMES,
    compile_once,
    jax_scene,
    jax_to_numpy,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)

W = H = 128
S = 3
CAP = 256
NQ = 64  # track query pixels
STEPS = 3


def batch_arrays(seed=0):
    rng = np.random.default_rng(seed)
    eye = np.eye(4, dtype=np.float32)
    frame = (
        np.array([5], np.int32), eye[None], K128[None],
        rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32),
        (rng.uniform(size=(1, H, W)) < 0.3).astype(np.float32),
        np.ones((1, H, W), np.float32),
        rng.uniform(2, 8, (1, H, W)).astype(np.float32),
    )
    tracks = (
        np.stack([rng.integers(0, W, NQ), rng.integers(0, H, NQ)],
                 -1).astype(np.float32),
        np.array([4, 6], np.int32), np.tile(eye, (2, 1, 1)),
        np.tile(K128, (2, 1, 1)),
        rng.uniform(0, W, (2, NQ, 2)).astype(np.float32),
        np.ones((2, NQ), np.float32),
        rng.uniform(0.5, 1.0, (2, NQ)).astype(np.float32),
        rng.uniform(2, 8, (2, NQ)).astype(np.float32),
    )
    return frame, tracks


@pytest.fixture(scope="module")
def runs():
    arrays = scene_arrays(seed=11)
    frame, tracks = batch_arrays(1)
    lr, ocfg, lcfg = SceneLRConfig(), OptimizerConfig(), LossesConfig()

    js = jax_scene(arrays)
    jstate = JT.init_train_state(js, lr, ocfg)
    jstep = JT.make_train_step(
        j_make_opt(js, lr, ocfg), lcfg,
        RenderConfig(num_exposure=S, tile_cap=CAP), "second", NUM_FRAMES,
        has_static=False, has_dynamic=True, has_reg=False,
    )
    jb = JT.FrameBatch(*map(jnp.asarray, frame))
    jtr = JT.TrackBatch(*map(jnp.asarray, tracks))

    ts = scene_from_numpy(arrays, device="cpu")
    tstate = TT.init_train_state(ts, tcfg.SceneLRConfig(),
                                 tcfg.OptimizerConfig())
    tstep = TT.make_train_step(
        t_make_opt(ts, tcfg.SceneLRConfig(), tcfg.OptimizerConfig()),
        tcfg.LossesConfig(),
        tcfg.RenderConfig(num_exposure=S, tile_cap=CAP), "second",
        NUM_FRAMES, has_static=False, has_dynamic=True, has_reg=False,
    )
    tb = TT.FrameBatch(*map(torch.as_tensor, frame))
    ttr = TT.TrackBatch(*map(torch.as_tensor, tracks))

    per_step = []
    jstep = compile_once(jstep, jstate, jnp.asarray(25), None, jb, jtr,
                         None, None)
    for _ in range(STEPS):
        jstate, jl, ja = jstep(jstate, jnp.asarray(25), None, jb, jtr, None,
                               None)
        tstate, tl, ta = tstep(tstate, 25, None, tb, ttr, None, None)
        per_step.append((float(jl), float(tl),
                         {k: np.asarray(v) for k, v in ja["dynamic"].items()},
                         {k: v.numpy() for k, v in ta["dynamic"].items()}))
    return arrays, jstate, tstate, per_step, lr


def test_loss_and_aux_every_step(runs):
    _, _, _, per_step, _ = runs
    for step, (jl, tl, ja, ta) in enumerate(per_step):
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {step}")
        assert set(ja) == set(ta)
        for k in ja:
            if k == "radii":
                np.testing.assert_array_equal(ta[k], ja[k])
            else:
                np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {step} {k}")


def test_density_stats(runs):
    _, jstate, tstate, _, _ = runs
    js, tst = jstate.stats, tstate.stats
    np.testing.assert_array_equal(tst.vis_count.numpy(), js.vis_count)
    np.testing.assert_array_equal(tst.max_radii.numpy(), js.max_radii)
    np.testing.assert_allclose(tst.grad_norm_acc.numpy(), js.grad_norm_acc,
                               rtol=1e-4, atol=1e-6)
    assert float(tst.grad_norm_acc.max()) > 0
    assert int(jstate.step) == tstate.step == STEPS


def _jax_group_state(jstate, label):
    return jstate.opt_state.inner_states[label].inner_state


def test_adam_moments(runs):
    _, jstate, tstate, _, _ = runs
    for name, p in tstate.scene.named_parameters():
        label = param_label(name)
        if label.startswith("move."):
            continue
        key, _ = jax_key(name)
        adam = _jax_group_state(jstate, label)[0]
        gs = tstate.opt_state[label]
        assert gs.count == int(adam.count) == STEPS
        for mom, ref in (("mu", adam.mu), ("nu", adam.nu)):
            r = jax_to_numpy(ref)[key]
            a = getattr(gs, mom)[name].numpy()
            scale = float(np.abs(r).max()) + 1e-30
            np.testing.assert_allclose(a / scale, r / scale, atol=1e-3,
                                       rtol=0, err_msg=f"{name} {mom}")


def test_multisteps_accumulation(runs):
    arrays, jstate, tstate, _, _ = runs
    for label in ("move.pose", "move.time"):
        ms = _jax_group_state(jstate, label)
        gs = tstate.opt_state[label]
        assert gs.mini_step == int(ms.mini_step) == STEPS
        assert gs.gradient_step == int(ms.gradient_step) == 0
        acc = jax_to_numpy(ms.acc_grads)
        for name, g in gs.acc_grads.items():
            key, transposed = jax_key(name)
            a = g.numpy().T if transposed else g.numpy()
            scale = float(np.abs(acc[key]).max()) + 1e-30
            np.testing.assert_allclose(a / scale, acc[key] / scale, atol=1e-3,
                                       rtol=0, err_msg=name)
            assert float(np.abs(acc[key]).max()) > 0, name
    # zero updates while accumulating: MoveModel parameters unchanged
    after = scene_to_numpy(tstate.scene)
    for k, v in after.items():
        if k.startswith("move."):
            np.testing.assert_array_equal(v, arrays[k], err_msg=k)


def _group_lr(lr_cfg, label):
    part, fld = label.split(".")
    if part == "motion_bases":
        return getattr(lr_cfg.motion_bases, fld)
    return getattr(getattr(lr_cfg, part), fld)


def test_parameters_after_three_steps(runs):
    arrays, jstate, tstate, _, lr_cfg = runs
    jp = jax_to_numpy(jstate.scene)
    tp = scene_to_numpy(tstate.scene)
    assert set(jp) == set(tp)
    for name, _ in tstate.scene.named_parameters():
        label = param_label(name)
        key, _ = jax_key(name)
        if label.startswith("move."):
            continue
        lr = _group_lr(lr_cfg, label)
        nu = jax_to_numpy(_jax_group_state(jstate, label)[0].nu)[key]
        signal = np.sqrt(nu) >= 1e-3 * np.sqrt(nu).max()
        diff = np.abs(tp[key] - jp[key])
        assert np.abs(jp[key] - arrays[key]).max() > 0, f"{name} never moved"
        assert diff[signal].max(initial=0) <= 1e-5 + 1e-3 * STEPS * lr, name
        assert diff[~signal].max(initial=0) <= 2 * STEPS * lr, name
    for k in ("fg.alive", "bg.alive"):
        np.testing.assert_array_equal(tp[k], arrays[k])
