"""Port vs reference: the multi-device paths of render and the train step on
two gloo ranks (separate processes, one thread each, launched by
tests/test_torch_mesh.py::start_ranks).

The scene of tests/test_tile_sharding.py (160x128 = 80 tiles, the bucketed
window path; 50 fg + 80 bg Gaussians, identity motion bases), S = 3 (2 + 1
sub-frames on two ranks), cap 256; its MoveModel heads get small random
last layers (tests/test_torch_models.py::scene_arrays) so that the
exposure poses, and the pose-continuity term, carry gradient, and its
Gaussians anisotropic scales (its isotropic ones leave the quaternions an
analytic gradient of zero, which both packages compute as rounding noise).
The same numpy inputs go to:

  * the ranks: render(tile_mesh=) and render(subframe_sharding=) with the
    gradient of tests/test_tile_sharding.py's loss, a sharp 'mid' render
    under subframe_sharding (S = 1: rank 1 holds no sub-frame), the static
    branch's gradient under subframe_sharding, and the three-branch
    stage-2 step (epoch 25) in both modes;
  * a third process: the port's unsharded render and step (tile_mesh's
    counterpart) and the same calls on a one-process mesh
    (subframe_sharding's counterpart: each sub-frame binned on its own,
    the mask's max with the cotangent split over ties; its depth order
    differs from the shared binning's, so its colours do too);
  * this process, meanwhile, the JAX package on a two-device
    mesh of its virtual CPU devices: render(tile_mesh=) (K1 and K3 in
    interpret mode under shard_map), render(subframe_sharding=) and the
    subframe-sharded step, these two with use_pallas=False (plain XLA; at
    this size no tile holds more than one 128-Gaussian chunk, so the
    kernels' early stop never fires and both compute one function, as in
    tests/test_torch_train_full.py).

Bars. Against JAX, the port's: 2e-4 abs on render values, 5e-3 of a
leaf's max |g| on gradients, and for the step tests/test_torch_train_full.
py's (loss and aux rtol 1e-5, radii equal, parameters 1e-5 + 1e-3 * lr
where Adam's second moment carries signal, 2 * lr elsewhere). Sharded
against unsharded, the JAX suite's (tests/test_tile_sharding.py): 1e-5 abs
on values, 2e-4 of max |g|, loss rtol 1e-4, parameters 5e-4 of the leaf's
max |param|, equal visibility counts. The two ranks' TrainStates are equal
bit for bit. The pose-continuity term (replicated: it never touches a
sharded tensor) counts once: the sharded static branch's MoveModel
gradient is within 1% of the continuity term's own gradient of the
one-rank gradient (counting it twice would put them that term apart).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from deblur4dgs_tpu.configs import (
    LossesConfig,
    OptimizerConfig,
    RenderConfig,
    SceneLRConfig,
)
from deblur4dgs_tpu.models.scene import render as j_render
from deblur4dgs_tpu.train import trainer as JT
from deblur4dgs_tpu.train.optimizers import make_optimizer as j_make_opt
from deblur4dgs_tpu_torch import configs as tcfg
from deblur4dgs_tpu_torch.convert import (
    jax_key,
    scene_from_numpy,
    train_state_to_numpy,
)
from deblur4dgs_tpu_torch.models.scene import render as t_render
from deblur4dgs_tpu_torch.parallel import mesh as M
from deblur4dgs_tpu_torch.train import trainer as TT
from deblur4dgs_tpu_torch.train.optimizers import make_optimizer as t_make_opt
from deblur4dgs_tpu_torch.train.optimizers import param_label
from tests.test_tile_sharding import EYE4, H, K, W, _train_inputs, make_scene
from tests.test_torch_mesh import init_rank, start_ranks, wait_ranks
from tests.test_torch_models import (
    compile_once,
    jax_scene,
    jax_to_numpy,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_train_step import _group_lr, _jax_group_state

S = 3
CAP = 256
EPOCH = 25
OUT_KEYS = ("img", "acc", "mask", "depth", "pred_sharp_img")
MODES = ("tile", "sub")


# ---------------------------------------------------------------------------
# The port's side (in the ranks and in this process)
# ---------------------------------------------------------------------------


def _shard_kw(mode, mesh):
    """render / make_train_step keywords of a mode on ``mesh`` (None: the
    unsharded call)."""
    if mesh is None:
        return {}
    if mode == "tile":
        return {"tile_mesh": mesh._replace(axis="tile")}
    return {"subframe_sharding": M.subframe_sharding(mesh)}


def _batches(data):
    t = lambda k: torch.as_tensor(data[k])
    fb = lambda n: TT.FrameBatch(*(t(f"{n}/{f}")
                                   for f in TT.FrameBatch._fields))
    tracks = TT.TrackBatch(*(t(f"tracks/{f}") for f in TT.TrackBatch._fields))
    return fb("static"), fb("dyn"), tracks, fb("reg")


def _scene(data):
    return scene_from_numpy({k[6:]: data[k] for k in data.files
                             if k.startswith("scene/")}, device="cpu")


def _grads(scene):
    return {n: p.grad.clone() for n, p in scene.named_parameters()
            if p.grad is not None}


def port_render(data, mode="blury", **kw):
    """Render outputs and the gradients of tests/test_tile_sharding.py's
    loss: {name: array}."""
    scene = _scene(data)
    out = t_render(scene, 3, torch.eye(4), torch.tensor(np.asarray(K)),
                   (W, H), mode=mode, stage="second", return_mask=True,
                   return_depth=mode == "blury", num_exposure=S, cap=CAP,
                   **kw)
    loss = (out["img"] - 0.5).abs().mean() + out["acc"].mean()
    loss.backward()
    res = {f"out/{k}": out[k].detach() for k in OUT_KEYS if k in out}
    res.update({f"grad/{n}": g for n, g in _grads(scene).items()})
    return res


def port_static_grads(data, **kw):
    """MoveModel gradients of the static branch (B = 3: pose continuity
    on)."""
    scene = _scene(data)
    static = _batches(data)[0]
    loss, _ = TT.compute_static_losses(
        scene, static, None, tcfg.LossesConfig(),
        tcfg.RenderConfig(num_exposure=S, tile_cap=CAP), "second", **kw)
    loss.backward()
    return {f"grad/{n}": g for n, g in _grads(scene).items()
            if n.startswith("move.")}


def port_cont_grads(data):
    """MoveModel gradients of the pose-continuity term alone."""
    scene = _scene(data)
    _, aux = TT.compute_static_losses(
        scene, _batches(data)[0], None, tcfg.LossesConfig(),
        tcfg.RenderConfig(num_exposure=S, tile_cap=CAP), "second")
    aux["pose_cont"].backward()
    return {f"grad/{n}": g for n, g in _grads(scene).items()
            if n.startswith("move.")}


def port_step(data, **kw):
    """One three-branch stage-2 step: the new TrainState (flat), the loss
    and the aux values."""
    scene = _scene(data)
    lr, ocfg = tcfg.SceneLRConfig(), tcfg.OptimizerConfig()
    state = TT.init_train_state(scene, lr, ocfg)
    step = TT.make_train_step(
        t_make_opt(scene, lr, ocfg), tcfg.LossesConfig(),
        tcfg.RenderConfig(num_exposure=S, tile_cap=CAP), "second", 8,
        has_static=True, has_dynamic=True, has_reg=True, **kw)
    static, dyn, tracks, reg = _batches(data)
    state, loss, aux = step(state, EPOCH, static, dyn, tracks, reg, None)
    res = {f"state/{k}": v for k, v in train_state_to_numpy(state).items()}
    res["loss"] = loss
    res.update({f"aux/{b}.{k}": v for b, a in aux.items()
                for k, v in a.items()})
    return res


def port_all(data, mesh, modes=MODES):
    """The port's computations of ``modes`` on ``mesh``: a rank's, or the
    references (unsharded: ``mesh`` None; one rank: a mesh of size 1)."""
    res = {}
    for mode in modes:
        kw = _shard_kw(mode, mesh)
        res.update({f"render_{mode}/{k}": v
                    for k, v in port_render(data, **kw).items()})
        res.update({f"step_{mode}/{k}": v
                    for k, v in port_step(data, **kw).items()})
    if "sub" in modes:
        kw = _shard_kw("sub", mesh)
        res.update({f"mid_sub/{k}": v for k, v in
                    port_render(data, mode="mid", **kw).items()})
        res.update({f"static_sub/{k}": v for k, v in
                    port_static_grads(data, **kw).items()})
    return {k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
            for k, v in res.items()}


def sharding_rank(out_dir):
    mesh = init_rank()
    data = np.load(f"{out_dir}/inputs.npz")
    np.savez(f"{out_dir}/rank{mesh.rank}.npz", **port_all(data, mesh))
    M.dist.destroy_process_group()


def sharding_refs(out_dir):
    """The port's references, in a process of their own: tile_mesh's the
    unsharded calls, subframe_sharding's the same calls on a one-process
    mesh; and the pose-continuity term's gradient."""
    torch.set_num_threads(1)
    data = np.load(f"{out_dir}/inputs.npz")
    res = port_all(data, None, ("tile",))
    res.update(port_all(data, M.make_mesh(device="cpu"), ("sub",)))
    res.update({f"cont/{k}": v.numpy()
                for k, v in port_cont_grads(data).items()})
    np.savez(f"{out_dir}/refs.npz", **res)


# ---------------------------------------------------------------------------
# Inputs, the references and the ranks' results
# ---------------------------------------------------------------------------


def _inputs():
    """The numpy inputs (scene by JAX pytree path, batches) and the JAX
    batches."""
    arrays = jax_to_numpy(make_scene())
    arrays.update({k: v for k, v in scene_arrays(seed=3).items()
                   if k.startswith("move.")})
    rng = np.random.default_rng(11)
    for part in ("fg", "bg"):
        n = arrays[f"{part}.scales"].shape[0]
        arrays[f"{part}.scales"] = rng.uniform(
            np.log(0.05), np.log(0.1), (n, 3)).astype(np.float32)
    fb, tracks = _train_inputs()
    jb = {"static": fb(3), "dyn": fb(1), "reg": fb(2)}
    data = {f"scene/{k}": v for k, v in arrays.items()}
    for name, b in list(jb.items()) + [("tracks", tracks)]:
        data.update({f"{name}/{f}": np.asarray(v)
                     for f, v in b._asdict().items()})
    return arrays, data, jb, tracks


def _jax_refs(arrays, jb, tracks):
    """The JAX package's calls on a two-device mesh, compiled in threads
    (XLA compiles with the interpreter lock released)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("tile",))
    sub = NamedSharding(mesh, PartitionSpec("tile"))

    def render_ref(kw):
        def loss(s):
            out = j_render(s, 3, EYE4, K, (W, H), mode="blury",
                           stage="second", return_mask=True,
                           return_depth=True, num_exposure=S, cap=CAP, **kw)
            l = jnp.mean(jnp.abs(out["img"] - 0.5)) + jnp.mean(out["acc"])
            return l, {k: out[k] for k in OUT_KEYS}

        scene = jax_scene(arrays)
        fn = compile_once(jax.jit(jax.value_and_grad(loss, has_aux=True)),
                          scene)
        (_, out), g = fn(scene)
        return {k: np.asarray(v) for k, v in out.items()}, jax_to_numpy(g)

    def step_ref():
        scene = jax_scene(arrays)
        lr, ocfg = SceneLRConfig(), OptimizerConfig()
        state = JT.init_train_state(scene, lr, ocfg)
        step = JT.make_train_step(
            j_make_opt(scene, lr, ocfg), LossesConfig(),
            RenderConfig(num_exposure=S, tile_cap=CAP, use_pallas=False),
            "second", 8, has_static=True, has_dynamic=True, has_reg=True,
            subframe_sharding=sub)
        args = (state, jnp.asarray(EPOCH), jb["static"], jb["dyn"], tracks,
                jb["reg"], None)
        state, loss, aux = compile_once(step, *args)(*args)
        return state, float(loss), {
            b: {k: np.asarray(v) for k, v in a.items()}
            for b, a in aux.items()}

    with ThreadPoolExecutor(3) as ex:
        futs = {"render_tile": ex.submit(render_ref, dict(tile_mesh=mesh)),
                "render_sub": ex.submit(render_ref, dict(
                    subframe_sharding=sub, use_pallas=False)),
                "step_sub": ex.submit(step_ref)}
        return {k: f.result() for k, f in futs.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks and the port's references run in processes of their own
    while this one computes the JAX package's calls."""
    out_dir = tmp_path_factory.mktemp("sharding")
    arrays, data, jb, tracks = _inputs()
    np.savez(out_dir / "inputs.npz", **data)
    procs = start_ranks("tests.test_torch_sharding:sharding_rank", out_dir)
    procs += start_ranks("tests.test_torch_sharding:sharding_refs", out_dir,
                         world=1)
    try:
        refs = _jax_refs(arrays, jb, tracks)
    finally:
        wait_ranks(procs)
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in (0, 1)]
    unsharded = dict(np.load(out_dir / "refs.npz"))
    return arrays, refs, unsharded, ranks, _section(unsharded, "cont")


def _section(res, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _assert_grads(port, ref_by_key, rel, label):
    """Port gradients (by torch name) against reference ones (by JAX key),
    each leaf to ``rel`` of its max |g|."""
    assert port, label
    for name, g in port.items():
        key, transposed = jax_key(name)
        ref = ref_by_key[key]
        g = g.T if transposed else g
        scale = float(np.abs(ref).max()) + 1e-8
        np.testing.assert_allclose(g / scale, ref / scale, atol=rel, rtol=0,
                                   err_msg=f"{label} {name}")


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_render_matches_jax(results, mode):
    _, refs, _, ranks, _ = results
    out, grads = refs[f"render_{mode}"]
    port = _section(ranks[0], f"render_{mode}")
    for k in OUT_KEYS:
        np.testing.assert_allclose(port[f"out/{k}"], out[k], atol=2e-4,
                                   rtol=0, err_msg=k)
    _assert_grads(_section(port, "grad"), grads, 5e-3, mode)


@pytest.mark.parametrize("what", ["render_tile", "render_sub", "mid_sub"])
def test_render_matches_unsharded(results, what):
    _, _, unsharded, ranks, _ = results
    port, ref = _section(ranks[0], what), _section(unsharded, what)
    outs = [k for k in port if k.startswith("out/")]
    assert len(outs) >= 4
    for k in outs:
        np.testing.assert_allclose(port[k], ref[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    _assert_grads(_section(port, "grad"), {
        jax_key(n)[0]: (g.T if jax_key(n)[1] else g)
        for n, g in _section(ref, "grad").items()}, 2e-4, what)


def test_step_matches_jax(results):
    """The subframe-sharded step against the JAX package's."""
    arrays, refs, _, ranks, _ = results
    jstate, jloss, jaux = refs["step_sub"]
    port = _section(ranks[0], "step_sub")
    np.testing.assert_allclose(port["loss"], jloss, rtol=1e-5)
    for b, a in jaux.items():
        for k, ref in a.items():
            v = port[f"aux/{b}.{k}"]
            if k == "radii":
                np.testing.assert_array_equal(v, ref, err_msg=f"{b}.{k}")
            elif k != "tile_overflow":  # NaN on this path in both
                np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-7,
                                           err_msg=f"{b}.{k}")
    assert np.isnan(port["aux/dynamic.tile_overflow"])
    jp = jax_to_numpy(jstate.scene)
    lr_cfg = tcfg.SceneLRConfig()
    for name in (n for n in _param_names(arrays)
                 if not param_label(n).startswith("move.")):
        key, _ = jax_key(name)
        lr = _group_lr(lr_cfg, param_label(name))
        nu = jax_to_numpy(_jax_group_state(jstate, param_label(name))[0].nu)[
            key]
        signal = np.sqrt(nu) >= 1e-3 * np.sqrt(nu).max()
        diff = np.abs(port[f"state/scene/{key}"] - jp[key])
        assert diff[signal].max(initial=0) <= 1e-5 + 1e-3 * lr, name
        assert diff[~signal].max(initial=0) <= 2 * lr, name
    np.testing.assert_array_equal(port["state/stats/vis_count"],
                                  np.asarray(jstate.stats.vis_count))


def _param_names(arrays):
    scene = scene_from_numpy(arrays, device="cpu")
    return [n for n, _ in scene.named_parameters()]


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_unsharded(results, mode):
    _, _, unsharded, ranks, _ = results
    port, ref = (_section(r, f"step_{mode}") for r in (ranks[0], unsharded))
    assert np.isfinite(ref["loss"])
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-4)
    params = [k for k in ref if k.startswith("state/scene/")]
    assert len(params) > 20
    for k in params:
        scale = float(np.abs(ref[k]).max()) + 1e-8
        np.testing.assert_allclose(port[k] / scale, ref[k] / scale,
                                   atol=5e-4, rtol=0, err_msg=k)
    np.testing.assert_array_equal(port["state/stats/vis_count"],
                                  ref["state/stats/vis_count"])


def test_ranks_hold_equal_states(results):
    """Every rank ends every sharded call with the same values, bit for
    bit: the TrainStates after both steps, the renders, the gradients."""
    _, _, _, (r0, r1), _ = results
    assert set(r0) == set(r1)
    assert sum(k.startswith("step_tile/state/") for k in r0) > 40
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_replicated_term_counts_once(results):
    """The sharded static branch's MoveModel gradient equals the one-rank
    one; the pose-continuity term alone moves it by far more than the
    difference (a gradient all-reduce after backward would add that term's
    gradient once more)."""
    _, _, unsharded, ranks, cont = results
    port = _section(ranks[0], "static_sub")
    ref = _section(unsharded, "static_sub")
    assert set(port) == set(ref) and len(port) >= 10
    cont_max = max(float(np.abs(g).max()) for g in cont.values())
    assert cont_max > 1e-3
    worst = max(float(np.abs(port[k] - ref[k]).max()) for k in ref)
    assert worst <= 0.01 * cont_max, (worst, cont_max)
