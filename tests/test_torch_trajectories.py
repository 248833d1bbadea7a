"""Port vs reference: the novel-view camera paths (utils/trajectories.py).

Seeded numpy cameras (looking at a point near the origin from ~3 units)
go to both packages. Bars: get_avg_w2c, get_lookat_w2cs and the arc,
lemniscate, spiral and wander paths within PATH_ATOL of the JAX package's
w2c matrices (float32 inverses and cross products of two libraries;
measured at most 7.2e-7); get_lookat (a 3x3 least-squares solve) within
LOOKAT_ATOL (measured 4.5e-8); each path's rotations orthonormal to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.utils import trajectories as jt
from deblur4dgs_tpu_torch.utils import trajectories as tt
from tests.test_torch_models import torch_single_thread  # noqa: F401

PATH_ATOL = 1e-5
LOOKAT_ATOL = 1e-5


def _look(eye, target, up=(0.0, -1.0, 0.0)):
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([r, d, f], 1)
    c2w[:3, 3] = eye
    return np.linalg.inv(c2w).astype(np.float32)


@pytest.fixture(scope="module")
def cams():
    rng = np.random.default_rng(4)
    target = rng.normal(0, 0.1, 3)
    eyes = np.stack([3.0 * np.array([np.sin(a), 0.2 * np.cos(3 * a),
                                     -np.cos(a)])
                     for a in rng.uniform(-0.6, 0.6, 7)])
    w2cs = np.stack([_look(e, target) for e in eyes])
    up = np.array([0.0, -1.0, 0.0], np.float32)
    return w2cs, target.astype(np.float32), up


def both(fn_name, *args, **kw):
    """The JAX function (jitted once, its numbers static, where it traces:
    get_wander_w2cs reads its camera on the host) and the port's on the
    same inputs: (jax, port) numpy results."""
    jfn = getattr(jt, fn_name)
    if fn_name != "get_wander_w2cs":
        static = [k for k, v in kw.items() if not isinstance(v, np.ndarray)]
        jfn = jax.jit(jfn, static_argnames=static)
    j = jfn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args), **kw)
    t = getattr(tt, fn_name)(*(torch.as_tensor(a)
                               if isinstance(a, np.ndarray) else a
                               for a in args), **kw)
    return np.asarray(j), t.numpy()


def _assert_poses(t, j):
    assert t.shape == j.shape and t.dtype == np.float32
    np.testing.assert_allclose(t, j, atol=PATH_ATOL, rtol=0)
    R = np.linalg.inv(t)[..., :3, :3]
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


def test_avg_w2c(cams):
    w2cs = cams[0]
    j, t = both("get_avg_w2c", w2cs)
    _assert_poses(t, j)


def test_lookat(cams):
    w2cs, target, _ = cams
    c2ws = np.linalg.inv(w2cs)
    j, t = both("get_lookat", c2ws[:, :3, 3], c2ws[:, :3, 2])
    assert t.shape == (3,)
    np.testing.assert_allclose(t, j, atol=LOOKAT_ATOL, rtol=0)
    np.testing.assert_allclose(t, target, atol=1e-4)  # rays meet there


def test_lookat_w2cs(cams):
    w2cs, target, up = cams
    pos = np.linalg.inv(w2cs)[:, :3, 3].astype(np.float32)
    j, t = both("get_lookat_w2cs", pos, target, up)
    _assert_poses(t, j)


@pytest.mark.parametrize("name,kw", [
    ("get_arc_w2cs", dict(degree=40.0)),
    ("get_lemniscate_w2cs", dict(degree=30.0)),
    ("get_spiral_w2cs", dict(rads=0.3, zrate=0.5, rots=2)),
    ("get_spiral_w2cs", dict(rads=np.array([0.2, 0.1, 0.05], np.float32),
                             zrate=0.5, rots=1)),
])
def test_paths(cams, name, kw):
    w2cs, target, up = cams
    ref = w2cs[2]
    j, t = both(name, ref, target, up, num_frames=17, **kw)
    assert t.shape == (17, 4, 4)
    _assert_poses(t, j)


def test_wander(cams):
    j, t = both("get_wander_w2cs", cams[0][3], 400.0, 9, max_disp=30.0)
    assert t.shape == (9, 4, 4)
    _assert_poses(t, j)
