"""Port vs reference: models (gaussians, motion bases, move model, scene
poses), EWA projection, and the numpy round trip of a SceneModel.

Inputs come from numpy with a seed and go to both packages (the JAX scene
is flattened to its pytree-path dict, the port builds its modules with
convert.scene_from_numpy). Values and gradients agree to atol 1e-5 (same
float32 formulas evaluated in another order).

The scene helpers here are shared by the other tests/test_torch_*.py files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.models import scene as jscene
from deblur4dgs_tpu.models.gaussians import Gaussians as JGaussians
from deblur4dgs_tpu.models.motion_bases import MotionBases as JMotionBases
from deblur4dgs_tpu.models.motion_bases import compute_transforms as j_ct
from deblur4dgs_tpu.models.move_model import MoveModel as JMoveModel
from deblur4dgs_tpu.models.move_model import exposure_samples as j_es
from deblur4dgs_tpu.ops import lie as jlie
from deblur4dgs_tpu.ops.projection import project as j_project
from deblur4dgs_tpu_torch.convert import jax_key, scene_from_numpy, scene_to_numpy
from deblur4dgs_tpu_torch.models import scene as tscene
from deblur4dgs_tpu_torch.models.motion_bases import compute_transforms as t_ct
from deblur4dgs_tpu_torch.models.move_model import exposure_samples as t_es
from deblur4dgs_tpu_torch.models.move_model import init_move_model
from deblur4dgs_tpu_torch.ops.projection import project as t_project

ATOL = 1e-5
NUM_FRAMES = 8
W128 = H128 = 128
K128 = np.array([[110.0, 0, 64], [0, 110.0, 64], [0, 0, 1]], np.float32)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def torch_single_thread():
    """Single-threaded PyTorch while a port test module runs: the suite runs
    several workers on a few cores, and PyTorch's intra-op pool would
    oversubscribe them. Restored afterwards. Imported by the other
    tests/test_torch_*.py modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def keystr(path) -> str:
    """JAX pytree path -> 'fg.means' / 'move.trunk.3.w' style key."""
    parts = []
    for k in path:
        for attr in ("name", "idx", "key"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return ".".join(parts)


def jax_to_numpy(tree) -> dict:
    return {keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def scene_arrays(seed=0, n_fg=120, n_bg=180, k_bases=4, T=NUM_FRAMES):
    """Seeded numpy arrays of a small scene, keyed by JAX pytree path
    (anisotropic scales so quaternion gradients carry signal)."""
    rng = np.random.default_rng(seed)
    out = {}
    for part, n in (("fg", n_fg), ("bg", n_bg)):
        means = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
        means[:, 2] += 2.5
        out[f"{part}.means"] = means
        out[f"{part}.quats"] = rng.normal(size=(n, 4)).astype(np.float32)
        out[f"{part}.scales"] = rng.uniform(
            np.log(0.02), np.log(0.09), (n, 3)).astype(np.float32)
        out[f"{part}.colors"] = rng.normal(size=(n, 3)).astype(np.float32)
        out[f"{part}.opacities"] = rng.uniform(0.0, 3.0, n).astype(np.float32)
        if part == "fg":
            out["fg.motion_coefs"] = rng.normal(
                size=(n, k_bases)).astype(np.float32)
        out[f"{part}.alive"] = np.ones((n,), np.float32)
    out["bases.rots"] = np.tile(
        np.array([1.0, 0, 0, 0, 1, 0], np.float32), (k_bases, T, 1)
    ) + 0.05 * rng.normal(size=(k_bases, T, 6)).astype(np.float32)
    out["bases.transls"] = 0.05 * rng.normal(
        size=(k_bases, T, 3)).astype(np.float32)
    # MoveModel: small random heads (the zero-init heads would make every
    # residual pose the identity and hide the pose path)
    dims = {"trunk": [66, 64, 64, 64, 64, 64], "head_start": [64, 64, 6],
            "head_end": [64, 64, 6]}
    for name, ds in dims.items():
        for i, (a, b) in enumerate(zip(ds[:-1], ds[1:])):
            bound = 1.0 / np.sqrt(a)
            scale = 0.02 if (name != "trunk" and i == len(ds) - 2) else 1.0
            out[f"move.{name}.{i}.w"] = (
                rng.uniform(-bound, bound, (a, b)) * scale).astype(np.float32)
            out[f"move.{name}.{i}.b"] = (
                rng.uniform(-bound, bound, (b,)) * scale).astype(np.float32)
    out["move.time_params"] = np.full((T,), 0.5, np.float32)
    return out


def jax_scene(arrays) -> jscene.SceneModel:
    """The reference SceneModel holding the same arrays."""
    a = {k: jnp.asarray(v) for k, v in arrays.items()}

    def gauss(part):
        return JGaussians(
            means=a[f"{part}.means"], quats=a[f"{part}.quats"],
            scales=a[f"{part}.scales"], colors=a[f"{part}.colors"],
            opacities=a[f"{part}.opacities"],
            motion_coefs=a.get(f"{part}.motion_coefs"),
            alive=a.get(f"{part}.alive"),
        )

    def mlp(name):
        out, i = [], 0
        while f"move.{name}.{i}.w" in a:
            out.append({"w": a[f"move.{name}.{i}.w"],
                        "b": a[f"move.{name}.{i}.b"]})
            i += 1
        return out

    return jscene.SceneModel(
        fg=gauss("fg"), bg=gauss("bg"),
        bases=JMotionBases(rots=a["bases.rots"], transls=a["bases.transls"]),
        move=JMoveModel(trunk=mlp("trunk"), head_start=mlp("head_start"),
                        head_end=mlp("head_end"),
                        time_params=a["move.time_params"]),
    )


def assert_grads_match(jgrads, tscene_, atol, rel=False):
    """Compare a JAX gradient pytree (flattened by path) with the .grad of
    the port's named parameters (MLP weights transposed)."""
    jg = jax_to_numpy(jgrads)
    for name, p in tscene_.named_parameters():
        key, transposed = jax_key(name)
        g = np.zeros(p.shape, np.float32) if p.grad is None else \
            p.grad.numpy()
        g = g.T if transposed else g
        ref = jg[key]
        scale = (float(np.abs(ref).max()) + 1e-12) if rel else 1.0
        np.testing.assert_allclose(g / scale, ref / scale, atol=atol, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


class TestConvert:
    def test_roundtrip_matches_jax_flattening(self):
        arrays = scene_arrays(1)
        flat = jax_to_numpy(jax_scene(arrays))
        ts = scene_from_numpy(flat, device="cpu")
        back = scene_to_numpy(ts)
        assert set(back) == set(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
        w = ts.move.trunk[3].weight.detach().numpy()
        np.testing.assert_array_equal(w, flat["move.trunk.3.w"].T)

    def test_optional_leaves_absent(self):
        arrays = scene_arrays(2)
        del arrays["fg.alive"]
        ts = scene_from_numpy(arrays, device="cpu")
        assert ts.fg.alive is None and ts.bg.alive is not None
        assert bool(ts.fg.get_alive().all())
        assert "fg.alive" not in scene_to_numpy(ts)


class TestGaussians:
    def test_activations(self):
        arrays = scene_arrays(3)
        js = jax_scene(arrays)
        ts = scene_from_numpy(arrays, device="cpu")
        for fn in ("get_quats", "get_scales", "get_colors", "get_opacities",
                   "get_coefs", "get_alive"):
            np.testing.assert_allclose(
                getattr(ts.fg, fn)().detach().numpy(),
                np.asarray(getattr(js.fg, fn)()), atol=ATOL, rtol=0,
                err_msg=fn,
            )


class TestMotion:
    @pytest.mark.parametrize("ts_", [[0.0, 2.5, 7.0], [3.25]])
    def test_compute_transforms(self, ts_):
        arrays = scene_arrays(4)
        js = jax_scene(arrays)
        ts = scene_from_numpy(arrays, device="cpu")
        times = np.asarray(ts_, np.float32)
        w = np.random.default_rng(0).normal(
            size=(120, len(ts_), 3, 4)).astype(np.float32)

        def jf(bases, coefs):
            return jnp.sum(j_ct(bases, jnp.asarray(times), coefs) * w)

        jval = j_ct(js.bases, jnp.asarray(times), js.fg.get_coefs())
        tval = t_ct(ts.bases, torch.as_tensor(times), ts.fg.get_coefs())
        np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval),
                                   atol=ATOL, rtol=0)
        jg = jax.jit(jax.grad(lambda s: jf(s.bases, s.fg.get_coefs())))(js)
        (tval * torch.as_tensor(w)).sum().backward()
        assert_grads_match(jg, ts, ATOL)

    def test_compute_poses_all(self):
        arrays = scene_arrays(5)
        js = jax_scene(arrays)
        ts = scene_from_numpy(arrays, device="cpu")
        times = np.array([1.5, 4.0], np.float32)
        rng = np.random.default_rng(1)
        wm = rng.normal(size=(300, 2, 3)).astype(np.float32)
        wq = rng.normal(size=(300, 2, 4)).astype(np.float32)

        def jf(s):
            m, q = jscene.compute_poses_all(s, jnp.asarray(times))
            return jnp.sum(m * wm) + jnp.sum(q * wq), (m, q)

        jg, (jm, jq) = jax.jit(jax.grad(jf, has_aux=True))(js)
        tm, tq = tscene.compute_poses_all(ts, torch.as_tensor(times))
        np.testing.assert_allclose(tm.detach().numpy(), jm, atol=ATOL, rtol=0)
        np.testing.assert_allclose(tq.detach().numpy(), jq, atol=ATOL, rtol=0)
        ((tm * torch.as_tensor(wm)).sum()
         + (tq * torch.as_tensor(wq)).sum()).backward()
        assert_grads_match(jg, ts, 2 * ATOL)


class TestMoveModel:
    @pytest.mark.parametrize("t,stage", [(3.0, "second"), (0.0, "second"),
                                         (5.0, "first")])
    def test_exposure_samples(self, t, stage):
        arrays = scene_arrays(6)
        arrays["move.time_params"] = np.linspace(
            0.05, 1.2, NUM_FRAMES).astype(np.float32)
        js = jax_scene(arrays)
        ts = scene_from_numpy(arrays, device="cpu")
        rng = np.random.default_rng(2)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.3])))
        w2c[:3, 3] = [0.2, -0.1, 0.5]
        wp = rng.normal(size=(7, 3, 4)).astype(np.float32)
        wt = rng.normal(size=(7,)).astype(np.float32)

        def jf(move):
            out = j_es(move, jnp.asarray(w2c), t, 7, stage=stage)
            return (jnp.sum(out.poses * wp) + jnp.sum(out.times * wt)
                    + out.delta_t), out

        jg, jo = jax.jit(jax.grad(jf, has_aux=True))(js.move)
        to = t_es(ts.move, torch.as_tensor(w2c), t, 7, stage=stage)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=ATOL, rtol=0)
        ((to.poses * torch.as_tensor(wp)).sum()
         + (to.times * torch.as_tensor(wt)).sum() + to.delta_t).backward()
        jfull = jax.tree.map(jnp.zeros_like, js)._replace(move=jg)
        assert_grads_match(jfull, ts, 2 * ATOL)

    def test_modes_slice(self):
        ts = scene_from_numpy(scene_arrays(7), device="cpu")
        full = t_es(ts.move, torch.eye(4), 3.0, 5)
        mid = t_es(ts.move, torch.eye(4), 3.0, 5, mode="mid")
        assert torch.equal(mid.poses[0], full.poses[2])
        with pytest.raises(NotImplementedError):
            t_es(ts.move, torch.eye(4), 3.0, 5, camera_mode="cubic")

    def test_init_move_model_shapes(self):
        m = init_move_model(torch.Generator().manual_seed(0), num_frames=6,
                            device="cpu")
        assert m.trunk[0].weight.shape == (64, 66)
        assert float(m.head_end[1].weight.detach().abs().max()) == 0.0
        p = t_es(m, torch.eye(4), 2.0, 3).poses
        np.testing.assert_allclose(p[:, :, :3].detach().numpy(),
                                   np.broadcast_to(np.eye(3), (3, 3, 3)),
                                   atol=1e-6)


class TestProjection:
    def test_project_values_and_grads(self):
        rng = np.random.default_rng(9)
        G = 200
        means = rng.uniform(-1.0, 1.0, (G, 3)).astype(np.float32)
        means[:, 2] = rng.uniform(-0.5, 4.0, G)  # some behind the camera
        quats = rng.normal(size=(G, 4)).astype(np.float32)
        scales = rng.uniform(0.01, 0.2, (G, 3)).astype(np.float32)
        view = np.eye(4, dtype=np.float32)
        view[:3, 3] = [0.1, -0.05, 0.3]
        aux = rng.uniform(size=G) > 0.1
        w = [rng.normal(size=s).astype(np.float32)
             for s in ((G, 2), (G, 3), (G,))]

        def jf(m, q, s):
            p = j_project(m, q, s, jnp.asarray(view), jnp.asarray(K128),
                          (W128, H128), aux_mask=jnp.asarray(aux))
            return (jnp.sum(p.means2d * w[0]) + jnp.sum(p.conics * w[1])
                    + jnp.sum(p.depths * w[2])), p

        args = [jnp.asarray(x) for x in (means, quats, scales)]
        jg, jp = jax.jit(jax.grad(jf, argnums=(0, 1, 2), has_aux=True))(*args)
        targs = [torch.tensor(x, requires_grad=True)
                 for x in (means, quats, scales)]
        tp = t_project(*targs, torch.as_tensor(view), torch.as_tensor(K128),
                       (W128, H128), aux_mask=torch.as_tensor(aux))
        for name in ("means2d", "depths", "radii", "valid"):
            np.testing.assert_allclose(
                getattr(tp, name).detach().numpy(),
                np.asarray(getattr(jp, name)), atol=ATOL, rtol=1e-6,
                err_msg=name,
            )
        np.testing.assert_allclose(tp.conics.detach().numpy(), jp.conics,
                                   rtol=2e-5, atol=ATOL)
        (((tp.means2d * torch.as_tensor(w[0])).sum())
         + (tp.conics * torch.as_tensor(w[1])).sum()
         + (tp.depths * torch.as_tensor(w[2])).sum()).backward()
        for t_in, g in zip(targs, jg):
            g = np.asarray(g)
            scale = float(np.abs(g).max())
            np.testing.assert_allclose(t_in.grad.numpy() / scale, g / scale,
                                       atol=ATOL, rtol=0)

    def test_batched_over_subframes(self):
        rng = np.random.default_rng(10)
        means = torch.as_tensor(rng.uniform(-1, 1, (3, 50, 3))
                                .astype(np.float32)) + torch.tensor([0, 0, 3.0])
        quats = torch.as_tensor(rng.normal(size=(3, 50, 4)).astype(np.float32))
        scales = torch.full((50, 3), 0.05)
        kw = dict(viewmat=torch.eye(4), K=torch.as_tensor(K128),
                  img_wh=(W128, H128))
        batched = t_project(means, quats, scales, **kw)
        for s in range(3):
            one = t_project(means[s], quats[s], scales, **kw)
            for a, b in zip(one, batched):
                assert torch.equal(a, b[s])
