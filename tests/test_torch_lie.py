"""Port vs reference: ops/lie.py and utils/mlp.py (values and gradients).

The same numpy inputs (seeded) go through the JAX function and its PyTorch
port; values and the gradient of a random linear functional of the output
must agree to atol 1e-5 (float32 evaluation of the same formulas in
another order), including the singular points theta = 0 and theta = pi
that the double-where guards protect.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.ops import lie as jlie
from deblur4dgs_tpu.utils import mlp as jmlp
from deblur4dgs_tpu_torch.ops import lie as tlie
from deblur4dgs_tpu_torch.utils import mlp as tmlp
from tests.test_torch_models import torch_single_thread  # noqa: F401

ATOL = 1e-5


def check_fn(jfn, tfn, *inputs, atol=ATOL, seed=0, finite=True):
    """Compare values and input-gradients of sum(w * fn(*inputs)); NaNs
    must sit at the same positions (assert_allclose's equal_nan)."""
    inputs = [np.asarray(x, np.float32) for x in inputs]
    yj = np.asarray(jax.jit(jfn)(*map(jnp.asarray, inputs)))
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    yt = tfn(*tin)
    np.testing.assert_allclose(yt.detach().numpy(), yj, atol=atol, rtol=0)
    w = np.random.default_rng(seed).normal(size=yj.shape).astype(np.float32)
    gj = jax.jit(jax.grad(
        lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(inputs)))
    ))(*map(jnp.asarray, inputs))
    (yt * torch.as_tensor(w)).sum().backward()
    for a, b in zip(tin, gj):
        if finite:
            assert np.all(np.isfinite(a.grad.numpy()))
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=atol,
                                   rtol=0)


def rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape) * scale


def rotvec(angle, axis=(0.3, -0.5, 0.8)):
    a = np.asarray(axis, np.float64)
    return (a / np.linalg.norm(a) * angle).astype(np.float32)


def rmat(angle, axis=(0.3, -0.5, 0.8)):
    return np.asarray(jlie.so3_exp(jnp.asarray(rotvec(angle, axis))))


def pose(seed, angle=None):
    R = rmat(angle if angle is not None else 1.1 + 0.1 * seed)
    t = rand((3,), seed)
    return np.concatenate([R, t[:, None]], 1).astype(np.float32)


UNARY = [
    "quat_normalize", "quat_to_rmat", "quat_exp", "quat_log", "so3_exp",
    "cont_6d_to_rmat", "se3_exp", "skew", "taylor_A", "taylor_B", "taylor_C",
]
INPUT_DIMS = {
    "quat_normalize": 4, "quat_to_rmat": 4, "quat_log": 4, "quat_exp": 3,
    "so3_exp": 3, "cont_6d_to_rmat": 6, "se3_exp": 6, "skew": 3,
    "taylor_A": None, "taylor_B": None, "taylor_C": None,
}


class TestUnary:
    @pytest.mark.parametrize("name", UNARY)
    def test_random_batch(self, name):
        d = INPUT_DIMS[name]
        x = rand((7,) if d is None else (7, d), seed=UNARY.index(name))
        if d is None:
            # scalar sinc-family inputs: keep |x| off (1e-3, 0.5), where the
            # exact forms lose most digits to fp32 cancellation in both
            # packages (probed separately in test_taylor_at_zero)
            x = np.sign(x) * (0.5 + np.abs(x))
        if name == "quat_log":
            x = x / np.linalg.norm(x, axis=-1, keepdims=True)
        check_fn(getattr(jlie, name), getattr(tlie, name), x)

    @pytest.mark.parametrize("name", ["taylor_A", "taylor_B", "taylor_C"])
    def test_taylor_at_zero(self, name):
        # Taylor branch below |x| = 1e-3; just above it the exact forms lose
        # most digits to fp32 cancellation in both packages, so the probes
        # skip (1e-3, 0.1)
        x = np.array([0.0, 1e-4, -5e-4, 0.2, 0.5], np.float32)
        check_fn(getattr(jlie, name), getattr(tlie, name), x)

    @pytest.mark.parametrize("fn", ["quat_exp", "so3_exp", "se3_exp"])
    def test_exp_at_zero(self, fn):
        d = 6 if fn == "se3_exp" else 3
        check_fn(getattr(jlie, fn), getattr(tlie, fn), np.zeros((2, d)))

    def test_quat_log_identity(self):
        q = np.array([[1.0, 0, 0, 0], [1.0, 1e-7, 0, 0]], np.float32)
        check_fn(jlie.quat_log, tlie.quat_log, q)


class TestRotations:
    @pytest.mark.parametrize(
        "angle", [0.0, 1e-5, 0.7, np.pi - 1e-2, np.pi - 1e-4, np.pi]
    )
    def test_rmat_to_quat_and_so3_log(self, angle):
        R = rmat(angle)[None]
        check_fn(jlie.rmat_to_quat, tlie.rmat_to_quat, R)
        # At exactly pi the reference's so3_log gradient is NaN: quat_log's
        # Taylor branch evaluates 1/w^3 at w ~ 1e-7 and the where() masks
        # only its value. The port reproduces that (same NaN positions).
        check_fn(jlie.so3_log, tlie.so3_log, R, atol=3e-5,
                 finite=angle != np.pi)

    def test_so3_log_batch(self):
        R = np.stack([rmat(a, axis) for a, axis in
                      [(0.3, (1, 0, 0)), (2.0, (0, 1, 1)), (3.0, (1, 2, 3))]])
        check_fn(jlie.so3_log, tlie.so3_log, R)

    def test_quat_mul(self):
        check_fn(jlie.quat_mul, tlie.quat_mul, rand((5, 4), 1),
                 rand((5, 4), 2))


class TestSE3:
    @pytest.mark.parametrize("angle", [0.0, 0.4, 2.5])
    def test_se3_log(self, angle):
        check_fn(jlie.se3_log, tlie.se3_log, pose(0, angle)[None])

    def test_se3_V_and_inv(self):
        w = np.concatenate([rand((4, 3), 3), np.zeros((1, 3))])
        check_fn(jlie._se3_V, tlie._se3_V, w)
        check_fn(jlie._se3_V_inv, tlie._se3_V_inv, w)

    def test_pose_apply(self):
        check_fn(jlie.pose_apply, tlie.pose_apply, pose(1)[None],
                 rand((6, 3), 4))

    @pytest.mark.parametrize("same", [False, True])
    def test_se3_lerp(self, same):
        p0 = pose(2)
        p1 = p0 if same else pose(5, angle=0.3)
        u = np.linspace(0, 1, 11)
        check_fn(jlie.se3_lerp, tlie.se3_lerp, p0, p1, u)

    def test_safe_norm_zero(self):
        x = np.array([[0.0, 0, 0], [3.0, 4.0, 0]], np.float32)
        check_fn(jlie._safe_norm, tlie._safe_norm, x)


class TestMLP:
    def test_posenc(self):
        check_fn(lambda x: jmlp.posenc(x, 5), lambda x: tmlp.posenc(x, 5),
                 rand((3, 6), 7))

    def test_mlp_matches_with_transposed_weights(self):
        rng = np.random.default_rng(8)
        dims = [66, 64, 64, 6]
        ws = [rng.normal(size=(a, b)).astype(np.float32) * 0.2
              for a, b in zip(dims[:-1], dims[1:])]
        bs = [rng.normal(size=(b,)).astype(np.float32) * 0.1 for b in dims[1:]]
        x = rng.normal(size=(4, 66)).astype(np.float32)

        def jfn(x, *wb):
            params = [{"w": w, "b": b} for w, b in zip(wb[0::2], wb[1::2])]
            return jmlp.mlp(params, x)

        def tfn(x, *wb):
            out = x
            layers = tmlp.init_mlp(torch.Generator().manual_seed(0), dims,
                                   device="cpu")
            for i, lin in enumerate(layers):
                out = torch.nn.functional.linear(out, wb[2 * i].T,
                                                 wb[2 * i + 1])
                if i < len(layers) - 1:
                    out = torch.nn.functional.leaky_relu(out, 0.01)
            return out

        flat = [v for pair in zip(ws, bs) for v in pair]
        check_fn(jfn, tfn, x, *flat, atol=2e-5)
        # and the port's own mlp() on nn.Linear layers holding w.T
        layers = tmlp.init_mlp(torch.Generator().manual_seed(0), dims,
                               device="cpu")
        with torch.no_grad():
            for lin, w, b in zip(layers, ws, bs):
                lin.weight.copy_(torch.as_tensor(w.T))
                lin.bias.copy_(torch.as_tensor(b))
        y = tmlp.mlp(layers, torch.as_tensor(x)).detach().numpy()
        np.testing.assert_allclose(
            y, np.asarray(jfn(jnp.asarray(x), *map(jnp.asarray, flat))),
            atol=2e-5, rtol=0,
        )

    def test_init_mlp_bounds_and_zero_last(self):
        layers = tmlp.init_mlp(torch.Generator().manual_seed(3), [66, 64, 6],
                               zero_last=True, device="cpu")
        w0 = layers[0].weight.detach()
        assert w0.shape == (64, 66)
        assert float(w0.abs().max()) <= 1.0 / np.sqrt(66)
        assert float(layers[1].weight.detach().abs().max()) == 0.0
        again = tmlp.init_mlp(torch.Generator().manual_seed(3), [66, 64, 6],
                              device="cpu")
        assert torch.equal(again[0].weight, layers[0].weight)
