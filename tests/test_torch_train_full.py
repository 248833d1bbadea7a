"""Port vs reference: the pipeline's two train steps.

  * stage 2 — ``has_static, has_dynamic, has_reg, has_batch4`` (the static
    branch's three bg-only windows, the dynamic window with tracks and the
    multires guide, the static-reg branch's sharp 'mid' render through the
    dense compositor K5): 128x128 (the bucketed window path), 300
    Gaussians, S=3, tile cap 256;
  * stage 1 — ``has_static`` alone, stage "first": 64x48 (12 tiles, the
    split compositor K4).

Two steps each at epoch 25 (> 20: the pose-net gate and the multires
guide's gate are open), both packages starting from identical parameters;
the JAX steps run as their suite runs them on the CPU (Pallas kernels in
interpret mode). The bars are tests/test_torch_train_step.py's: loss and
every aux value rtol 1e-5 after every step; then DensityStats (counts and
radii equal, gradient norms rtol 1e-4), Adam moments (1e-3 of the tensor's
max |moment|), the MultiSteps accumulators of the MoveModel groups, and
every parameter (1e-5 + 1e-3 * steps * lr where the second moment carries
signal, Adam's step bound 2 * steps * lr elsewhere; see that file).
"""

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
from tests.test_torch_dense import K48
from tests.test_torch_models import (
    K128,
    NUM_FRAMES,
    jax_scene,
    jax_to_numpy,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_train_step import _group_lr, _jax_group_state

S = 3
CAP = 256
NQ = 64  # track query pixels
STEPS = 2
EPOCH = 25

RUNS = {
    "stage2_128": dict(wh=(128, 128), K=K128, stage="second",
                       has_static=True, has_dynamic=True, has_reg=True,
                       has_batch4=True),
    "stage1_64x48": dict(wh=(64, 48), K=K48, stage="first",
                         has_static=True, has_dynamic=False, has_reg=False),
}


def frames(rng, ts, W, H, K):
    """A FrameBatch of len(ts) frames as numpy arrays: cameras a little
    apart so the static branch's windows differ, and a rectangular fg mask
    (the bg-only branches supervise outside its 9x9 dilation; a scattered
    random mask would dilate to the whole image and leave them nothing)."""
    B = len(ts)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    w2cs[:, 0, 3] = 0.02 * (np.arange(B) - B // 2)
    masks = np.zeros((B, H, W), np.float32)
    for b in range(B):
        y0, x0 = rng.integers(0, H // 2), rng.integers(0, W // 2)
        masks[b, y0 : y0 + H // 4, x0 : x0 + W // 4] = 1.0
    return (
        np.asarray(ts, np.int32), w2cs, np.tile(K, (B, 1, 1)),
        rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32), masks,
        np.ones((B, H, W), np.float32),
        rng.uniform(2, 8, (B, H, W)).astype(np.float32),
    )


def step_inputs(cfg, seed=3):
    """(static, dynamic, tracks, reg, batch4) numpy inputs; None where the
    step has no such branch."""
    W, H = cfg["wh"]
    K = cfg["K"]
    rng = np.random.default_rng(seed)
    static = frames(rng, [4, 5, 6], W, H, K)
    if not cfg["has_dynamic"]:
        return static, None, None, None, None
    dyn = frames(rng, [5], W, H, K)
    eye = np.eye(4, dtype=np.float32)
    tracks = (
        np.stack([rng.integers(0, W, NQ), rng.integers(0, H, NQ)],
                 -1).astype(np.float32),
        np.array([4, 6], np.int32), np.tile(eye, (2, 1, 1)),
        np.tile(K, (2, 1, 1)),
        rng.uniform(0, W, (2, NQ, 2)).astype(np.float32),
        np.ones((2, NQ), np.float32),
        rng.uniform(0.5, 1.0, (2, NQ)).astype(np.float32),
        rng.uniform(2, 8, (2, NQ)).astype(np.float32),
    )
    reg = dyn[:3] + (rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32),) + \
        dyn[4:]
    batch4 = rng.uniform(0, 1, (1, H // 4, W // 4, 3)).astype(np.float32)
    return static, dyn, tracks, reg, batch4


def _wrap(kind, arrays, conv):
    return None if arrays is None else kind(*map(conv, arrays))


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request):
    cfg = RUNS[request.param]
    flags = {k: cfg.get(k, False)
             for k in ("has_static", "has_dynamic", "has_reg", "has_batch4")}
    arrays = scene_arrays(seed=13)
    static, dyn, tracks, reg, batch4 = step_inputs(cfg)
    lr, ocfg, lcfg = SceneLRConfig(), OptimizerConfig(), LossesConfig()

    js = jax_scene(arrays)
    jstate = JT.init_train_state(js, lr, ocfg)
    jstep = JT.make_train_step(
        j_make_opt(js, lr, ocfg), lcfg,
        RenderConfig(num_exposure=S, tile_cap=CAP), cfg["stage"], NUM_FRAMES,
        **flags,
    )
    jin = (_wrap(JT.FrameBatch, static, jnp.asarray),
           _wrap(JT.FrameBatch, dyn, jnp.asarray),
           _wrap(JT.TrackBatch, tracks, jnp.asarray),
           _wrap(JT.FrameBatch, reg, jnp.asarray),
           None if batch4 is None else jnp.asarray(batch4))

    ts = scene_from_numpy(arrays, device="cpu")
    tstate = TT.init_train_state(ts, tcfg.SceneLRConfig(),
                                 tcfg.OptimizerConfig())
    tstep = TT.make_train_step(
        t_make_opt(ts, tcfg.SceneLRConfig(), tcfg.OptimizerConfig()),
        tcfg.LossesConfig(), tcfg.RenderConfig(num_exposure=S, tile_cap=CAP),
        cfg["stage"], NUM_FRAMES, **flags,
    )
    tin = (_wrap(TT.FrameBatch, static, torch.as_tensor),
           _wrap(TT.FrameBatch, dyn, torch.as_tensor),
           _wrap(TT.TrackBatch, tracks, torch.as_tensor),
           _wrap(TT.FrameBatch, reg, torch.as_tensor),
           None if batch4 is None else torch.as_tensor(batch4))

    per_step = []
    for _ in range(STEPS):
        jstate, jl, ja = jstep(jstate, jnp.asarray(EPOCH), *jin)
        tstate, tl, ta = tstep(tstate, EPOCH, *tin)
        per_step.append((
            float(jl), float(tl),
            {b: {k: np.asarray(v) for k, v in a.items()}
             for b, a in ja.items()},
            {b: {k: v.numpy() for k, v in a.items()} for b, a in ta.items()},
        ))
    return cfg, arrays, jstate, tstate, per_step, lr


def test_loss_and_aux_every_step(runs):
    cfg, _, _, _, per_step, _ = runs
    branches = {b for b, f in (("static", "has_static"),
                               ("dynamic", "has_dynamic"),
                               ("reg", "has_reg")) if cfg.get(f)}
    for step, (jl, tl, ja, ta) in enumerate(per_step):
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {step}")
        assert set(ja) == set(ta) == branches
        for b in ja:
            assert set(ja[b]) == set(ta[b]), b
            for k in ja[b]:
                msg = f"step {step} {b}.{k}"
                if k == "radii":
                    np.testing.assert_array_equal(ta[b][k], ja[b][k], msg)
                else:
                    np.testing.assert_allclose(ta[b][k], ja[b][k], rtol=1e-5,
                                               atol=1e-7, err_msg=msg)


def test_density_stats(runs):
    _, _, jstate, tstate, _, _ = runs
    js, tst = jstate.stats, tstate.stats
    np.testing.assert_array_equal(tst.vis_count.numpy(), js.vis_count)
    np.testing.assert_array_equal(tst.max_radii.numpy(), js.max_radii)
    np.testing.assert_allclose(tst.grad_norm_acc.numpy(), js.grad_norm_acc,
                               rtol=1e-4, atol=1e-6)
    # every branch combination here takes its stats from a bg-only branch
    n_fg = tstate.scene.num_fg
    assert float(tst.grad_norm_acc[n_fg:].max()) > 0
    assert float(tst.grad_norm_acc[:n_fg].abs().max()) == 0.0
    assert int(jstate.step) == tstate.step == STEPS


def test_adam_moments(runs):
    _, _, jstate, tstate, _, _ = runs
    for name, _ in tstate.scene.named_parameters():
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
    cfg, arrays, jstate, tstate, _, _ = runs
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
        # stage "first" fixes the exposure time (delta_t = 0): no time grads
        moved = cfg["stage"] == "second" or label == "move.pose"
        assert (max(float(np.abs(v).max()) for v in acc.values()) > 0) \
            == moved, label
    after = scene_to_numpy(tstate.scene)
    for k, v in after.items():
        if k.startswith("move."):
            np.testing.assert_array_equal(v, arrays[k], err_msg=k)


def test_parameters_after_steps(runs):
    cfg, arrays, jstate, tstate, _, lr_cfg = runs
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
        # stage 1 trains the background alone: the rest gets no gradient
        trained = cfg["has_dynamic"] or name.startswith("bg.")
        assert (np.abs(jp[key] - arrays[key]).max() > 0) == trained, name
        assert diff[signal].max(initial=0) <= 1e-5 + 1e-3 * STEPS * lr, name
        assert diff[~signal].max(initial=0) <= 2 * STEPS * lr, name
    for k in ("fg.alive", "bg.alive"):
        np.testing.assert_array_equal(tp[k], arrays[k])
