"""Port vs reference: density control (train/density.py) and the TrainState
conversion both packages start from.

Random states are made with numpy from a seed: a scene with dead slots, a
few tiny Gaussians (dup candidates) among the large ones (split
candidates), too few free slots in fg (so candidates are dropped), random
Adam moments, MultiSteps accumulators and DensityStats. Both packages get
the same arrays (convert.train_state_from_numpy on the port's side, the
helpers below on the reference's). Bars: integer outputs, alive masks and
the new-slot mask exactly equal; float parameters and moments within
1e-6 (the same float32 arithmetic; log(1.6) subtracted in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deblur4dgs_tpu.configs import OptimizerConfig as JOptimizerConfig
from deblur4dgs_tpu.configs import SceneLRConfig as JSceneLRConfig
from deblur4dgs_tpu.train import density as jd
from deblur4dgs_tpu.train import trainer as JT
from deblur4dgs_tpu_torch import configs as tcfg
from deblur4dgs_tpu_torch.convert import (
    scene_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from deblur4dgs_tpu_torch.train import density as td
from deblur4dgs_tpu_torch.train.trainer import init_train_state
from tests.test_torch_models import (
    jax_scene,
    jax_to_numpy,
    keystr,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)

FLOAT_ATOL = 1e-6


# ---------------------------------------------------------------------------
# The reference's TrainState <-> the flat numpy layout of convert.py
# ---------------------------------------------------------------------------


def _label_states(jstate):
    """label -> (adam state, chain states with a count, MultiSteps state or
    None) of the reference's optax multi_transform."""
    out = {}
    for label, masked in jstate.opt_state.inner_states.items():
        st = masked.inner_state
        if label == "frozen":
            continue
        ms = st if isinstance(st, optax.MultiStepsState) else None
        chain = ms.inner_opt_state if ms is not None else st
        out[label] = (chain[0], chain, ms)
    return out


def jax_state_to_numpy(jstate) -> dict:
    out = {f"scene/{k}": v for k, v in jax_to_numpy(jstate.scene).items()}
    for label, (adam, _, ms) in _label_states(jstate).items():
        out[f"opt/{label}/count"] = np.asarray(adam.count, np.int32)
        for kind, tree in (("mu", adam.mu), ("nu", adam.nu)):
            for k, v in jax_to_numpy(tree).items():
                out[f"opt/{label}/{kind}/{k}"] = v
        steps = (0, 0) if ms is None else (ms.mini_step, ms.gradient_step)
        out[f"opt/{label}/mini_step"] = np.asarray(steps[0], np.int32)
        out[f"opt/{label}/gradient_step"] = np.asarray(steps[1], np.int32)
        if ms is not None:
            for k, v in jax_to_numpy(ms.acc_grads).items():
                out[f"opt/{label}/acc_grads/{k}"] = v
    for name, x in jstate.stats._asdict().items():
        out[f"stats/{name}"] = np.asarray(x)
    out["step"] = np.asarray(jstate.step, np.int32)
    return out


def jax_state_from_numpy(arrays: dict):
    """The reference TrainState holding ``arrays`` (init_train_state's
    structure for the scene they describe)."""
    scene = jax_scene({k[6:]: v for k, v in arrays.items()
                       if k.startswith("scene/")})
    template = JT.init_train_state(scene, JSceneLRConfig(),
                                   JOptimizerConfig())
    inner = dict(template.opt_state.inner_states)

    def fill(tree, label, kind):
        return jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(arrays[f"opt/{label}/{kind}/{keystr(p)}"]),
            tree)

    for label, (adam, chain, ms) in _label_states(template).items():
        count = arrays[f"opt/{label}/count"]
        new_chain = tuple(  # one buffer each: the JAX step donates them
            s._replace(count=jnp.array(count, jnp.int32))
            if "count" in s._fields else s for s in chain)
        new_chain = (new_chain[0]._replace(mu=fill(adam.mu, label, "mu"),
                                           nu=fill(adam.nu, label, "nu")),
                     ) + new_chain[1:]
        if ms is None:
            st = new_chain
        else:
            st = ms._replace(
                mini_step=jnp.asarray(arrays[f"opt/{label}/mini_step"],
                                      jnp.int32),
                gradient_step=jnp.asarray(
                    arrays[f"opt/{label}/gradient_step"], jnp.int32),
                inner_opt_state=new_chain,
                acc_grads=fill(ms.acc_grads, label, "acc_grads"))
        inner[label] = inner[label]._replace(inner_state=st)
    stats = JT.DensityStats(*(jnp.asarray(arrays[f"stats/{f}"])
                              for f in JT.DensityStats._fields))
    return template._replace(
        opt_state=template.opt_state._replace(inner_states=inner),
        stats=stats, step=jnp.asarray(arrays["step"], jnp.int32))


# ---------------------------------------------------------------------------
# Random states
# ---------------------------------------------------------------------------


def random_state_arrays(seed, n_fg=160, n_bg=200, fg_dead=0.15,
                        bg_dead=0.5):
    """A TrainState's arrays: dead slots, tiny (dup) and large (split)
    Gaussians, random moments, accumulators and stats."""
    rng = np.random.default_rng(seed)
    scene = scene_arrays(seed=seed, n_fg=n_fg, n_bg=n_bg)
    for part, n, dead in (("fg", n_fg, fg_dead), ("bg", n_bg, bg_dead)):
        scene[f"{part}.alive"] = (rng.uniform(size=n) >= dead).astype(
            np.float32)
        tiny = rng.uniform(size=n) < 0.4
        scene[f"{part}.scales"][tiny] = np.log(0.004)
        big = rng.uniform(size=n) < 0.1
        scene[f"{part}.scales"][big] = np.log(0.8)
        scene[f"{part}.opacities"] = rng.normal(0.0, 2.5, n).astype(
            np.float32)
    state = init_train_state(scene_from_numpy(scene, device="cpu"),
                             tcfg.SceneLRConfig(), tcfg.OptimizerConfig())
    arrays = train_state_to_numpy(state)
    for k, v in arrays.items():
        if k.endswith("/count") or (k.startswith("opt/move.")
                                    and k.endswith("_step")):
            # MultiSteps counters exist only in the move.* groups
            arrays[k] = np.asarray(rng.integers(1, 20), np.int32)
        elif k.startswith("opt/") and "/nu/" in k:
            arrays[k] = rng.uniform(0, 1e-4, v.shape).astype(np.float32)
        elif k.startswith("opt/") and ("/mu/" in k or "/acc_grads/" in k):
            arrays[k] = rng.normal(0, 1e-3, v.shape).astype(np.float32)
    n = n_fg + n_bg
    vis = rng.integers(0, 6, n).astype(np.int32)
    arrays["stats/vis_count"] = vis
    arrays["stats/grad_norm_acc"] = (
        rng.uniform(0, 5e-4, n) * np.maximum(vis, 1)).astype(np.float32)
    arrays["stats/max_radii"] = rng.uniform(0, 0.2, n).astype(np.float32)
    arrays["step"] = np.asarray(700, np.int32)
    return arrays


@pytest.fixture(scope="module")
def base_arrays():
    return random_state_arrays(0)


def both_states(arrays):
    return (jax_state_from_numpy(arrays),
            train_state_from_numpy(arrays, device="cpu"))


def assert_states_match(jstate, tstate):
    ja, ta = jax_state_to_numpy(jstate), train_state_to_numpy(tstate)
    assert set(ja) == set(ta)
    for k in ja:
        a, b = ta[k], np.asarray(ja[k])
        if k.endswith("alive") or not np.issubdtype(b.dtype, np.floating):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, atol=FLOAT_ATOL, rtol=0,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def test_state_conversion_round_trip(base_arrays):
    jstate, tstate = both_states(base_arrays)
    ja, ta = jax_state_to_numpy(jstate), train_state_to_numpy(tstate)
    assert set(ja) == set(ta) == set(base_arrays)
    for k in ja:
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]), err_msg=k)
        np.testing.assert_array_equal(ta[k], base_arrays[k], err_msg=k)


@pytest.mark.parametrize("use_screen", [False, True])
@pytest.mark.parametrize("part", ["fg", "bg"])
def test_densify_group(base_arrays, part, use_screen):
    jstate, tstate = both_states(base_arrays)
    n_fg = tstate.scene.num_fg
    sl = slice(0, n_fg) if part == "fg" else slice(n_fg, None)
    cfg_j, cfg_t = JOptimizerConfig(), tcfg.OptimizerConfig()
    js = jstate.stats
    jg_avg = js.grad_norm_acc / jnp.maximum(js.vis_count, 1)
    ts = tstate.stats
    tg_avg = ts.grad_norm_acc / torch.clamp(ts.vis_count, min=1)
    jgauss, jrep = jd.densify_group(getattr(jstate.scene, part), jg_avg[sl],
                                    js.max_radii[sl], cfg_j, use_screen)
    tgauss = getattr(tstate.scene, part)
    out, trep = td.densify_group(tgauss, tg_avg[sl], ts.max_radii[sl], cfg_t,
                                 use_screen)
    assert out is tgauss  # in place
    for f in ("num_split", "num_dup", "num_dropped", "num_culled"):
        assert int(getattr(trep, f)) == int(getattr(jrep, f)), f
    assert int(trep.num_split) > 0 and int(trep.num_dup) > 0
    if part == "fg":
        assert int(trep.num_dropped) > 0  # capacity ran out
    np.testing.assert_array_equal(trep.new_slot_mask.numpy(),
                                  jrep.new_slot_mask)
    for f in ("means", "quats", "scales", "colors", "opacities",
              "motion_coefs", "alive"):
        a = getattr(tgauss, f)
        if a is None:
            assert getattr(jgauss, f) is None
            continue
        np.testing.assert_allclose(a.detach().numpy(), getattr(jgauss, f),
                                   atol=FLOAT_ATOL, rtol=0, err_msg=f)


@pytest.mark.parametrize("use_scale,use_screen",
                         [(False, False), (True, False), (True, True)])
def test_cull_and_reset(base_arrays, use_scale, use_screen):
    jstate, tstate = both_states(base_arrays)
    cfg_j, cfg_t = JOptimizerConfig(), tcfg.OptimizerConfig()
    n_fg = tstate.scene.num_fg
    jb, jn = jd.cull_group(jstate.scene.bg, jstate.stats.max_radii[n_fg:],
                           cfg_j, 0.7, use_scale, use_screen)
    tb, tn = td.cull_group(tstate.scene.bg, tstate.stats.max_radii[n_fg:],
                           cfg_t, 0.7, use_scale, use_screen)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tb.alive.numpy(), jb.alive)
    jr = jd.reset_opacities_group(jstate.scene.fg, cfg_j)
    tr_ = td.reset_opacities_group(tstate.scene.fg, cfg_t)
    np.testing.assert_array_equal(tr_.opacities.detach().numpy(),
                                  jr.opacities)


def test_moment_surgery(base_arrays):
    jstate, tstate = both_states(base_arrays)
    mask = (np.random.default_rng(3).uniform(size=tstate.scene.num_fg)
            < 0.3).astype(np.float32)
    jo = jd.reset_moments_at_slots(jstate.opt_state, "fg", jnp.asarray(mask))
    td.reset_moments_at_slots(tstate.opt_state, "fg", torch.as_tensor(mask))
    jo = jd.reset_moments_full(jo, "bg.opacities")
    td.reset_moments_full(tstate.opt_state, "bg.opacities")
    jstate = jstate._replace(opt_state=jo)
    assert_states_match(jstate, tstate)
    mu = tstate.opt_state["fg.means"].mu["fg.means"]
    assert float(mu[mask > 0].abs().max()) == 0.0
    assert float(mu[mask == 0].abs().max()) > 0.0
    assert float(tstate.opt_state["bg.opacities"].nu["bg.opacities"]
                 .abs().max()) == 0.0
    assert tstate.opt_state["bg.opacities"].count == int(
        base_arrays["opt/bg.opacities/count"])


FLAG_CASES = {
    "densify": dict(do_densify=True, do_cull=False, do_reset=False,
                    use_screen=True),
    "densify_cull": dict(do_densify=True, do_cull=True, do_reset=False,
                         use_screen=False, cull_use_scale=True),
    "cull_reset": dict(do_densify=False, do_cull=True, do_reset=True,
                       use_screen=True),
    "all": dict(do_densify=True, do_cull=True, do_reset=True,
                use_screen=True, cull_use_scale=True),
    "all_only_fg": dict(do_densify=True, do_cull=True, do_reset=True,
                        use_screen=True, only_fg=True),
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_apply_density_control(base_arrays, case):
    flags = dict(FLAG_CASES[case])
    only_fg = flags.pop("only_fg", False)
    jstate, tstate = both_states(base_arrays)
    kw = dict(num_frames=8, only_fg=only_fg, bg_scene_scale=0.6, **flags)
    jstate = jd.apply_density_control(jstate, JOptimizerConfig(), **kw)
    out = td.apply_density_control(tstate, tcfg.OptimizerConfig(), **kw)
    assert out is tstate
    assert_states_match(jstate, tstate)
    for x in tstate.stats:
        assert float(x.abs().max()) == 0
    before = base_arrays["scene/fg.alive"]
    assert not np.array_equal(tstate.scene.fg.alive.numpy(), before)


def test_control_flags():
    for cfg_kw in ({}, dict(control_every=5, warmup_steps=3,
                            reset_opacity_every_n_controls=3,
                            stop_densify_steps=40)):
        cj, ct = JOptimizerConfig(**cfg_kw), tcfg.OptimizerConfig(**cfg_kw)
        for step in list(range(0, 60)) + [3000, 3100, 4000, 4100]:
            assert td.control_flags(ct, step, 8) == jd.control_flags(
                cj, step, 8), (cfg_kw, step)
