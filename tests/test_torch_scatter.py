"""Port vs reference: the scatter-output window compositor K6 (D4_SCATTER=1).

The port's K6 twins (what composite_buckets_scatter runs on CPU tensors)
against the JAX package's composite_buckets_scatter as its own suite runs
it on the CPU: the forward in Pallas interpret mode, the custom VJP
through the S-split backward K3 on each bucket's gathered rows
(rasterize.py:1652-1659). Then render(mode="blury") at 128x128 on the
bucketed path with ``_USE_SCATTER`` monkeypatched on in both packages, and
the port's scatter path against its own gather path.

Bars: against the reference, the window tests' forward 2e-4 abs and
gradients 5e-3 of max |g| (float32 reassociation and the port's per
(row, sub-frame) stop rule, see tests/test_torch_rasterize.py); depth
outputs 10x the forward bar (depth units up to ~9). Scatter against
gather in the port: atol 1e-6 forward and rtol 1e-5 / atol 1e-7 for the
gradients, tests/test_bucketing.py:148-162's bars (the same twins on the
same rows; only the row order of the reductions' inputs differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.models import scene as jscene
from deblur4dgs_tpu.ops import rasterize as jr
from deblur4dgs_tpu_torch.convert import scene_from_numpy
from deblur4dgs_tpu_torch.models import scene as tscene
from deblur4dgs_tpu_torch.ops import rasterize as tr
from tests.test_torch_models import (
    K128,
    assert_grads_match,
    jax_scene,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_rasterize import FD, FS, NCHAN, TILES_X, assert_rel

FWD_ATOL = 2e-4
GRAD_REL = 5e-3
T_IMG = 12  # a 4 x 3 tile image
S = 3


def bucket(rng, sids, n_real, cap):
    """One bucket of random window inputs whose row t holds Gaussians
    around image tile sids[t]; rows >= n_real are pad rows (count 0, sid
    T_IMG), as tiling.bucket_tiles_from_runs and the sid padding make them.
    Row 1 is empty; rows 2-3 hold opaque Gaussians and saturate early."""
    Tb = len(sids)
    dyn = np.zeros((Tb, S, FD, cap), np.float32)
    tx = (np.minimum(sids, T_IMG - 1) % TILES_X) * 16.0
    ty = (np.minimum(sids, T_IMG - 1) // TILES_X) * 16.0
    bx = tx[:, None] + rng.uniform(-4, 20, (Tb, cap))
    by = ty[:, None] + rng.uniform(-4, 20, (Tb, cap))
    for s in range(S):
        dyn[:, s, 0] = bx + 0.5 * s + rng.uniform(-1, 1, (Tb, cap))
        dyn[:, s, 1] = by + rng.uniform(-1, 1, (Tb, cap))
        dyn[:, s, 2] = rng.uniform(0.02, 0.2, (Tb, cap))
        dyn[:, s, 3] = rng.uniform(-0.01, 0.01, (Tb, cap))
        dyn[:, s, 4] = rng.uniform(0.02, 0.2, (Tb, cap))
        dyn[:, s, 5] = 30.0
        dyn[:, s, 6] = rng.uniform(1.0, 9.0, (Tb, cap))
    st = rng.uniform(0.05, 0.7, (Tb, FS, cap)).astype(np.float32)
    dyn[2:4, :, 2:5] *= 0.05
    st[2:4, 0] = 0.98
    counts = rng.integers(1, cap + 1, Tb).astype(np.int32)
    counts[1] = 0
    counts[n_real:] = 0
    live = (np.arange(cap)[None] < counts[:, None]).astype(np.float32)
    return (dyn * live[:, None, None], st * live[:, None], counts,
            np.asarray(sids, np.int32))


def random_buckets(seed):
    """Two buckets partitioning the 12 image tiles: 7 real rows + 1 pad
    (cap 256), 5 real rows + 3 pads (cap 128)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(T_IMG)
    return [
        bucket(rng, list(perm[:7]) + [T_IMG], 7, 256),
        bucket(rng, list(perm[7:]) + [T_IMG] * 3, 5, 128),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_k6_twins_against_reference(seed):
    bks = random_buckets(seed)
    rng = np.random.default_rng(100 + seed)
    wa = rng.normal(size=(T_IMG, S, NCHAN, 256)).astype(np.float32)
    wt = rng.normal(size=(T_IMG, S, 256)).astype(np.float32)
    counts = [b[2] for b in bks]
    sids = [b[3] for b in bks]

    def jloss(dyns, sts):
        acc, tf = jr.composite_buckets_scatter(
            dyns, sts, tuple(map(jnp.asarray, counts)),
            tuple(map(jnp.asarray, sids)), T_IMG, TILES_X, NCHAN, True)
        return (jnp.sum(acc[:T_IMG] * wa) + jnp.sum(tf[:T_IMG] * wt),
                (acc, tf))

    (jgd, jgs), (ja, jtf) = jax.grad(jloss, argnums=(0, 1), has_aux=True)(
        tuple(jnp.asarray(b[0]) for b in bks),
        tuple(jnp.asarray(b[1]) for b in bks))

    dyns = [torch.tensor(b[0], requires_grad=True) for b in bks]
    sts = [torch.tensor(b[1], requires_grad=True) for b in bks]
    ta, ttf = tr.composite_buckets_scatter(
        dyns, sts, [torch.as_tensor(c) for c in counts],
        [torch.as_tensor(i) for i in sids], T_IMG, TILES_X, NCHAN, True)
    assert ta.shape == (T_IMG + 1, S, NCHAN, 256)
    assert ttf.shape == (T_IMG + 1, S, 256)
    np.testing.assert_allclose(ta[:T_IMG].detach().numpy(), ja[:T_IMG],
                               atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(ttf[:T_IMG].detach().numpy(), jtf[:T_IMG],
                               atol=FWD_ATOL, rtol=0)
    # the trash row holds what a count-0 row composites
    np.testing.assert_array_equal(ta[T_IMG].detach().numpy(), 0.0)
    np.testing.assert_array_equal(ttf[T_IMG].detach().numpy(), 1.0)
    ((ta[:T_IMG] * torch.as_tensor(wa)).sum()
     + (ttf[:T_IMG] * torch.as_tensor(wt)).sum()).backward()
    for b in range(2):
        assert_rel(dyns[b].grad.numpy(), jgd[b], GRAD_REL, f"gdyn {b}")
        assert_rel(sts[b].grad.numpy(), jgs[b], GRAD_REL, f"gst {b}")
        pad = counts[b] == 0
        assert float(dyns[b].grad[pad].abs().max()) == 0.0
        assert float(sts[b].grad[pad].abs().max()) == 0.0


def test_k6_twin_writes_only_its_rows():
    """One bucket's twin leaves the other rows of the shared buffer as they
    were, and its backward equals the window twin on the gathered rows."""
    bks = random_buckets(3)
    dyn, st, counts, sids = map(torch.as_tensor, bks[1])
    acc = torch.full((T_IMG + 1, S, NCHAN, 256), -7.0)
    tf = torch.full((T_IMG + 1, S, 256), -7.0)
    tr.composite_window_scatter_plain(dyn, st, counts, sids, acc, tf,
                                      TILES_X, NCHAN, True)
    mine = torch.zeros(T_IMG + 1, dtype=torch.bool)
    mine[sids.long()] = True
    assert bool((acc[~mine] == -7.0).all()) and bool((tf[~mine] == -7.0).all())
    wa, wt = tr.composite_window_plain(dyn, st, counts, sids, TILES_X, NCHAN,
                                       True)
    np.testing.assert_array_equal(acc[sids.long()[:5]].numpy(),
                                  wa[:5].numpy())
    g = torch.Generator().manual_seed(0)
    gacc = torch.randn(acc.shape, generator=g)
    gt = torch.randn(tf.shape, generator=g)
    got = tr.composite_window_scatter_bwd_plain(
        dyn, st, counts, sids, acc, tf, gacc, gt, TILES_X, NCHAN, True)
    rows = sids.long()
    want = tr.composite_window_bwd_plain(
        dyn, st, counts, sids, acc[rows], tf[rows], gacc[rows], gt[rows],
        TILES_X, NCHAN, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


RENDER_KW = dict(mode="blury", num_exposure=3, cap=256, bucketed=True,
                 return_mask=True, return_depth=True, bg_color=1.0)
OUT_KEYS = ("img", "acc", "mask", "depth", "exposure_imgs", "exposure_masks",
            "pred_sharp_img")
LOSS_KEYS = ("img", "mask", "depth", "exposure_imgs")
VIEW = np.eye(4, dtype=np.float32)
VIEW[:3, 3] = [0.05, -0.02, 0.1]


def port_render(monkeypatch, arrays, use_scatter, ws):
    monkeypatch.setattr(tr, "_USE_SCATTER", use_scatter)
    ts = scene_from_numpy(arrays, device="cpu")
    out = tscene.render(ts, torch.tensor(3.0), torch.as_tensor(VIEW),
                        torch.as_tensor(K128), (128, 128), **RENDER_KW)
    sum((out[k] * torch.as_tensor(ws[k])).sum() for k in LOSS_KEYS
        ).backward()
    return ts, out


def loss_weights():
    rng = np.random.default_rng(4)
    shapes = {"img": (128, 128, 3), "mask": (128, 128, 1),
              "depth": (128, 128, 1), "exposure_imgs": (S, 128, 128, 3)}
    return {k: rng.normal(size=v).astype(np.float32)
            for k, v in shapes.items()}


def test_render_scatter_against_reference(monkeypatch):
    arrays = scene_arrays(seed=23)
    ws = loss_weights()
    monkeypatch.setattr(jr, "_USE_SCATTER", True)

    def jloss(s):
        o = jscene.render(s, 3.0, jnp.asarray(VIEW), jnp.asarray(K128),
                          (128, 128), **RENDER_KW)
        return sum(jnp.sum(o[k] * ws[k]) for k in LOSS_KEYS), o

    jg, jo = jax.jit(jax.grad(jloss, has_aux=True))(jax_scene(arrays))
    tr.LAUNCHES["window_scatter_fwd"] = 0
    ts, tout = port_render(monkeypatch, arrays, True, ws)
    assert tr.LAUNCHES["window_scatter_fwd"] == 0  # CPU tensors: twins
    for k in OUT_KEYS:
        a, b = tout[k].detach().numpy(), np.asarray(jo[k])
        assert a.shape == b.shape, k
        atol = FWD_ATOL * (10 if k == "depth" else 1)
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(tout["radii"].detach().numpy(),
                                  jo["radii"])
    assert float(tout["tile_overflow"]) == float(jo["tile_overflow"])
    assert float(ts.fg.means.grad.abs().max()) > 0
    assert_grads_match(jg, ts, GRAD_REL, rel=True)


def test_port_scatter_matches_gather(monkeypatch):
    arrays = scene_arrays(seed=29)
    ws = loss_weights()
    sa, a = port_render(monkeypatch, arrays, True, ws)
    sb, b = port_render(monkeypatch, arrays, False, ws)
    for k in OUT_KEYS:
        np.testing.assert_allclose(a[k].detach().numpy(),
                                   b[k].detach().numpy(), atol=1e-6,
                                   err_msg=k)
    for (name, pa), (_, pb) in zip(sa.named_parameters(),
                                   sb.named_parameters()):
        if pb.grad is None:
            assert pa.grad is None, name
            continue
        np.testing.assert_allclose(pa.grad.numpy(), pb.grad.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
