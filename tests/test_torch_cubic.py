"""Port vs reference: the 'cubic' camera (RenderConfig.camera_mode).

  * ops/lie.py::se3_cubic_bspline on seeded control poses (4 knots; a batch
    of 3 random knot sets and the duplicated-knot set the camera uses) at
    9 positions in [0, 1]: values within 1e-6, and the gradient of a
    seeded weighted sum to the knots' se(3) vectors within 1e-5 of its
    max; the duplicated set's ends at (5 p0 + p1) / 6 and (p0 + 5 p1) / 6
    (the reference docstring's caveat);
  * models/move_model.py::exposure_samples(camera_mode="cubic") at S = 11
    on a MoveModel with small random heads (the zero-init heads would
    give identity poses): poses within 1e-6, times within 2e-7 relative
    (an ulp: two libraries' linspace), deltaT within 1e-7; the mid sample
    is the SE(3) midpoint of the endpoint poses (S odd), the cubic poses
    differ from the linear ones, and the 'mid' / 'start' / 'end' modes
    are the window's samples;
  * one dynamic train step at 48x32 (the split compositor's union path,
    S = 3) with camera_mode="cubic" in both packages from one scene: the
    loss and every aux value rtol 1e-5 (tests/test_torch_train_full.py's
    bar); the port's loss with camera_mode="linear" differs (the branch
    is taken).
"""

import dataclasses

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
from deblur4dgs_tpu.models import move_model as jmm
from deblur4dgs_tpu.ops import lie as jlie
from deblur4dgs_tpu.train import trainer as JT
from deblur4dgs_tpu.train.optimizers import make_optimizer as j_make_opt
from deblur4dgs_tpu_torch import configs as tcfg
from deblur4dgs_tpu_torch.convert import scene_from_numpy
from deblur4dgs_tpu_torch.models import move_model as tmm
from deblur4dgs_tpu_torch.ops import lie as tlie
from deblur4dgs_tpu_torch.train import trainer as TT
from deblur4dgs_tpu_torch.train.optimizers import make_optimizer as t_make_opt
from tests.test_torch_dense import K48
from tests.test_torch_models import (
    NUM_FRAMES,
    compile_once,
    jax_scene,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_train_full import _wrap, step_inputs

U9 = np.linspace(0.0, 1.0, 9).astype(np.float32)


def knot_vectors(seed=0):
    """(4, 4, 6) se(3) vectors of 4 knot sets: 3 random ones, and the
    duplicated-knot set [a, a, b, b] the camera builds."""
    rng = np.random.default_rng(seed)
    xi = (0.3 * rng.normal(size=(3, 4, 6))).astype(np.float32)
    return np.concatenate([xi, xi[:1, [0, 0, 1, 1]]])


def test_se3_cubic_bspline_values_and_grads():
    xi = knot_vectors()
    w = np.random.default_rng(1).normal(
        size=xi.shape[:1] + (9, 3, 4)).astype(np.float32)
    u = np.ascontiguousarray(np.broadcast_to(U9, (xi.shape[0], 9)))

    @jax.jit
    def jf(x):
        v = jlie.se3_cubic_bspline(jlie.se3_exp(x), jnp.asarray(u))
        return jnp.sum(v * w), v

    (_, jv), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(xi))
    jv, jg = np.asarray(jv), np.asarray(jg)
    tx = torch.tensor(xi, requires_grad=True)
    tv = tlie.se3_cubic_bspline(tlie.se3_exp(tx), torch.as_tensor(u))
    (tv * torch.as_tensor(w)).sum().backward()
    assert tv.shape == (xi.shape[0], 9, 3, 4)
    np.testing.assert_allclose(tv.detach().numpy(), jv, atol=1e-6, rtol=0)
    scale = float(np.abs(jg).max())
    np.testing.assert_allclose(tx.grad.numpy() / scale, jg / scale,
                               atol=1e-5, rtol=0)
    # the duplicated knots: the ends sit at (5 p0 + p1) / 6, (p0 + 5 p1) / 6
    p = tlie.se3_exp(torch.as_tensor(xi[3, 1:3])).detach().numpy()
    t = tv.detach().numpy()[3, :, :, 3]
    np.testing.assert_allclose(t[0], (5 * p[0, :, 3] + p[1, :, 3]) / 6,
                               atol=1e-6)
    np.testing.assert_allclose(t[-1], (p[0, :, 3] + 5 * p[1, :, 3]) / 6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def scenes():
    arrays = scene_arrays(seed=19)
    return arrays, jax_scene(arrays), scene_from_numpy(arrays, device="cpu")


def test_exposure_samples_cubic(scenes):
    _, js, ts = scenes
    S = 11
    rng = np.random.default_rng(S)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = rng.normal(0, 0.2, 3)
    j = jax.jit(jmm.exposure_samples, static_argnums=(3,),
                static_argnames=("camera_mode",))(
        js.move, jnp.asarray(w2c), 4, S, camera_mode="cubic")
    with torch.no_grad():
        t = tmm.exposure_samples(ts.move, torch.as_tensor(w2c), 4, S,
                                 camera_mode="cubic")
        lin = tmm.exposure_samples(ts.move, torch.as_tensor(w2c), 4, S)
        d0, d1 = tmm.predict_deltas(ts.move, torch.as_tensor(w2c))
        mid = tlie.se3_lerp(tlie.se3_exp(d0), tlie.se3_exp(d1),
                            torch.tensor([0.5]))[0]
    assert t.poses.shape == (S, 3, 4)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.times.numpy(), np.asarray(j.times),
                               rtol=2e-7, atol=0)
    np.testing.assert_allclose(float(t.delta_t), float(j.delta_t), atol=1e-7)
    np.testing.assert_allclose(t.poses[S // 2].numpy(), mid.numpy(),
                               atol=1e-6)
    assert float((t.poses - lin.poses).abs().max()) > 1e-4
    # the one-sample modes slice the window as the JAX package's do
    for mode, i in (("mid", S // 2), ("start", 0), ("end", S - 1)):
        with torch.no_grad():
            tm_ = tmm.exposure_samples(ts.move, torch.as_tensor(w2c), 4, S,
                                       mode=mode, camera_mode="cubic")
        np.testing.assert_allclose(tm_.poses.numpy(),
                                   np.asarray(j.poses)[i : i + 1],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(tm_.times.numpy(),
                                   np.asarray(j.times)[i : i + 1],
                                   rtol=2e-7, atol=0)


def test_dynamic_step_cubic_48x32(scenes):
    arrays, js, _ = scenes
    cfg = dict(wh=(48, 32), K=K48, has_dynamic=True)
    _, dyn, tracks, _, _ = step_inputs(cfg, seed=5)
    flags = dict(has_static=False, has_dynamic=True, has_reg=False)
    lr, ocfg = SceneLRConfig(), OptimizerConfig()
    jstep = JT.make_train_step(
        j_make_opt(js, lr, ocfg), LossesConfig(),
        RenderConfig(num_exposure=3, tile_cap=256, use_pallas=False,
                     camera_mode="cubic"),
        "second", NUM_FRAMES, **flags)
    jargs = (JT.init_train_state(js, lr, ocfg), jnp.asarray(25), None,
             _wrap(JT.FrameBatch, dyn, jnp.asarray),
             _wrap(JT.TrackBatch, tracks, jnp.asarray), None, None)
    _, jl, ja = compile_once(jstep, *jargs)(*jargs)
    rcfg = tcfg.RenderConfig(num_exposure=3, tile_cap=256,
                             camera_mode="cubic")
    out = {}
    for name, rc in (("cubic", rcfg),
                     ("linear", dataclasses.replace(rcfg,
                                                    camera_mode="linear"))):
        ts = scene_from_numpy(arrays, device="cpu")
        tstep = TT.make_train_step(
            t_make_opt(ts, tcfg.SceneLRConfig(), tcfg.OptimizerConfig()),
            tcfg.LossesConfig(), rc, "second", NUM_FRAMES, **flags)
        _, tl, ta = tstep(
            TT.init_train_state(ts, tcfg.SceneLRConfig(),
                                tcfg.OptimizerConfig()), 25, None,
            _wrap(TT.FrameBatch, dyn, torch.as_tensor),
            _wrap(TT.TrackBatch, tracks, torch.as_tensor), None, None)
        out[name] = (float(tl), ta)
    tl, ta = out["cubic"]
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    assert set(ta) == set(ja) == {"dynamic"}
    assert set(ta["dynamic"]) == set(ja["dynamic"])
    for k, v in ja["dynamic"].items():
        if k == "radii":
            np.testing.assert_array_equal(ta["dynamic"][k].numpy(),
                                          np.asarray(v))
        else:
            np.testing.assert_allclose(ta["dynamic"][k].numpy(),
                                       np.asarray(v), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert abs(tl - out["linear"][0]) > 1e-6 * abs(tl)
