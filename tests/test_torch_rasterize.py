"""Port vs reference: the exposure-window compositor.

The port's plain twins (what composite_tiles_window runs on CPU tensors)
against the JAX package's composite_tiles_window as its own suite runs it
on the CPU: the fused forward K1 in Pallas interpret mode and the backward
through the S-split kernel K3 (rasterize.py:1353-1359). Bars are the JAX
suite's own (tests/test_window_kernel.py): forward atol 2e-4, gradients
atol 5e-3 of max |g| — they cover float32 reassociation and the early-stop
tail (the port stops each (row, sub-frame) on its own; K1/K3 stop the
whole window, so a sub-frame whose pixels all fell below T = 1e-4 keeps
compositing there, adding < 1e-4 per pixel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.ops import rasterize as jr
from deblur4dgs_tpu.ops import tiling as jt
from deblur4dgs_tpu.ops.projection import Projected as JProjected
from deblur4dgs_tpu_torch.ops import rasterize as tr
from deblur4dgs_tpu_torch.ops import tiling as tt
from deblur4dgs_tpu_torch.ops.projection import Projected as TProjected
from tests.test_torch_models import compile_once
from tests.test_torch_models import torch_single_thread  # noqa: F401
from tests.test_torch_tiling import random_window

TILES_X = 4
NCHAN = 5  # rgb + mask + depth
FD = 7
FS = 1 + NCHAN - 1
FWD_ATOL = 2e-4
GRAD_ATOL = 5e-3  # relative to max |g|


def make_data(seed, S, n_tiles=8, cap=8 * 128, lo=1, hi=2 * 128,
              dense=False):
    """The input maker of tests/test_window_kernel.py with S a parameter.
    Up to 256 Gaussians per row as there, in 1024-slot rows (the
    reference's interpret-mode kernels unroll fewer rows per block at a
    larger capacity, so they compile faster); ``dense`` packs opaque
    Gaussians so rows saturate early."""
    rng = np.random.default_rng(seed)
    Tp = -(-n_tiles // 8) * 8
    ids = rng.permutation(np.arange(max(n_tiles, 12)))[:Tp].astype(np.int32)
    dyn = np.zeros((Tp, S, FD, cap), np.float32)
    txs = (ids % TILES_X) * 16
    tys = (ids // TILES_X) * 16
    base_x = txs[:, None] + rng.uniform(-4, 20, (Tp, cap))
    base_y = tys[:, None] + rng.uniform(-4, 20, (Tp, cap))
    for s in range(S):
        dyn[:, s, 0] = base_x + rng.uniform(-1, 1, (Tp, cap))
        dyn[:, s, 1] = base_y + rng.uniform(-1, 1, (Tp, cap))
        dyn[:, s, 2] = rng.uniform(0.02, 0.2, (Tp, cap))
        dyn[:, s, 3] = rng.uniform(-0.01, 0.01, (Tp, cap))
        dyn[:, s, 4] = rng.uniform(0.02, 0.2, (Tp, cap))
        dyn[:, s, 5] = 30.0
        dyn[:, s, 6] = rng.uniform(1.0, 9.0, (Tp, cap))
    st = rng.uniform(0.05, 0.7, (Tp, FS, cap)).astype(np.float32)
    if dense:
        dyn[:, :, 2] *= 0.05  # wide Gaussians
        dyn[:, :, 4] *= 0.05
        st[:, 0] = rng.uniform(0.9, 0.99, (Tp, cap))
    counts = rng.integers(lo, hi + 1, (Tp,)).astype(np.int32)
    counts[1] = 0  # an empty row
    slot = np.arange(cap)[None, :]
    live = (slot < counts[:, None]).astype(np.float32)
    dyn *= live[:, None, None, :]
    st *= live[:, None, :]
    return dyn, st, counts, ids


def port_window(dyn, st, counts, ids, requires_grad=False):
    d = torch.tensor(dyn, requires_grad=requires_grad)
    s = torch.tensor(st, requires_grad=requires_grad)
    out = tr.composite_tiles_window(d, s, torch.as_tensor(counts),
                                    torch.as_tensor(ids), TILES_X, NCHAN, True)
    return (d, s), out


def assert_rel(a, b, atol=GRAD_ATOL, msg=""):
    b = np.asarray(b)
    scale = float(np.abs(b).max()) + 1e-6
    np.testing.assert_allclose(np.asarray(a) / scale, b / scale, atol=atol,
                               rtol=0, err_msg=msg)


@pytest.mark.parametrize("S", [3, 7])  # 7 > BWD_S_SPLIT: K3's split sum
@pytest.mark.parametrize("dense", [False, True])
def test_window_forward_and_grads(S, dense):
    dyn, st, counts, ids = make_data(S + 10 * dense, S, dense=dense)
    rng = np.random.default_rng(S)
    T = dyn.shape[0]
    wa = rng.normal(size=(T, S, NCHAN, 256)).astype(np.float32)
    wt = rng.normal(size=(T, S, 256)).astype(np.float32)

    def loss(dd, ss):
        acc, tf = jr.composite_tiles_window(
            dd, ss, jnp.asarray(counts), jnp.asarray(ids), TILES_X, NCHAN, True)
        return jnp.sum(acc * wa) + jnp.sum(tf * wt), (acc, tf)

    # eager grad: the reference's jitted forward/backward compile once per
    # shape and are reused by the other parameter sets
    (gd, gs), (ja, jtf) = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(dyn), jnp.asarray(st))
    (d, s), (ta, ttf) = port_window(dyn, st, counts, ids, requires_grad=True)
    np.testing.assert_allclose(ta.detach().numpy(), ja, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(ttf.detach().numpy(), jtf, atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(ta[1].detach().numpy(), 0.0)  # empty row
    np.testing.assert_array_equal(ttf[1].detach().numpy(), 1.0)
    ((ta * torch.as_tensor(wa)).sum() + (ttf * torch.as_tensor(wt)).sum()
     ).backward()
    assert_rel(d.grad.numpy(), gd, msg="gdyn")
    assert_rel(s.grad.numpy(), gs, msg="gst")
    # radius row gets zero gradient; pad slots past counts too
    assert float(d.grad[:, :, 5].abs().max()) == 0.0
    past = np.arange(dyn.shape[-1])[None, :] >= counts[:, None]
    past = np.broadcast_to(past[:, None, None, :], d.grad.shape)
    assert float(np.abs(d.grad.numpy()[past]).max()) == 0.0


def test_stop_rule_per_subframe():
    """A sub-frame that saturates stops on its own chunk; the others keep
    compositing (and the twins' backward stops at the same chunk)."""
    S, cap = 2, 3 * 128
    dyn, st, counts, ids = make_data(5, S, cap=cap, lo=cap, hi=cap)
    dyn[:, 0, 2:5] *= 0.01  # sub-frame 0: very wide, opaque
    dyn[:, 1, 2:5] *= 50.0  # sub-frame 1: point-like, leaves pixels open
    st[:, 0] = 0.99
    (d, s), (acc, tf) = port_window(dyn, st, counts, ids, requires_grad=True)
    rows = counts > 0
    assert float(tf[rows, 0].detach().max()) < tr.EARLY_STOP_T
    (acc.sum() + tf.sum()).backward()
    # sub-frame 0 stopped after the first chunk: no gradient beyond it
    assert float(d.grad[:, 0, :, 128:].abs().max()) == 0.0
    assert float(d.grad[rows, 1, :, 128:].abs().max()) > 0.0


def test_window_buckets_against_reference():
    """composite_window_buckets at 128x128 (bucketed path: 64 tiles):
    outputs and gradients w.r.t. the packed payload."""
    arrs = random_window(7, 2, 300, 128, 128)
    S, G = arrs[2].shape
    img_wh, cap = (128, 128), 256
    jp = JProjected(*map(jnp.asarray, arrs))
    tp = TProjected(*map(torch.as_tensor, arrs))
    runs_j = jt.bin_gaussians_union_runs(jp, img_wh, cap)
    runs_t = tt.bin_gaussians_union_runs(tp, img_wh, cap)
    spec = jt.default_bucket_spec(64, cap)
    bj = jt.bucket_tiles_from_runs(runs_j[0], runs_j[1], runs_j[3], G, spec)
    bt = tt.bucket_tiles_from_runs(runs_t[0], runs_t[1], runs_t[3], G, spec)
    rng = np.random.default_rng(8)
    op = rng.uniform(0.2, 0.95, G).astype(np.float32)
    ch = np.concatenate([rng.uniform(size=(G, 3)), np.ones((G, 1)),
                         rng.normal(size=(G, 6))], 1).astype(np.float32)
    nchan = ch.shape[1] + 1
    bg = np.concatenate([[1.0, 1.0, 1.0], np.zeros(nchan - 3)]).astype(
        np.float32)
    kw = dict(include_depth=True, mask_channel=3, stack_subframes=True,
              stack_mask=True)

    def j_out(tbl):
        lists = [jt.pack_window_fused(gi, tbl, S, 7) for gi in bj.gather_idx]
        return jr.composite_window_buckets(
            bj, [p[1] for p in lists], [p[0] for p in lists],
            jnp.asarray(bg), img_wh, **kw)

    jtbl = jnp.concatenate(
        [jt.packed_dyn_table(jp, runs_j[4], True),
         jt.packed_static_table(jnp.asarray(op), jnp.asarray(ch), runs_j[4])],
        axis=1)
    ttbl = torch.cat(
        [tt.packed_dyn_table(tp, runs_t[4], True),
         tt.packed_static_table(torch.as_tensor(op), torch.as_tensor(ch),
                                runs_t[4])], dim=1).requires_grad_(True)
    lists = [tt.pack_window_fused(gi, ttbl, S, 7) for gi in bt.gather_idx]
    tout = tr.composite_window_buckets(
        bt, [p[1] for p in lists], [p[0] for p in lists],
        torch.as_tensor(bg), img_wh, **kw)
    keys = ["sum_img", "sum_alpha", "max_mask", "min_depth", "rgb_stack",
            "alpha_stack", "mask_stack"]
    ws = {k: np.random.default_rng(len(k)).normal(
        size=tout[k].shape).astype(np.float32) for k in keys}

    def jloss(tbl):
        o = j_out(tbl)
        return sum(jnp.sum(o[k] * ws[k]) for k in keys), o

    gj, jout = compile_once(jax.jit(jax.grad(jloss, has_aux=True)),
                            jtbl)(jtbl)
    for k in keys:
        a, b = tout[k].detach().numpy(), np.asarray(jout[k])
        assert a.shape == b.shape, k
        # min_depth is accum/alpha (~depth units up to 9): relative bar
        atol = FWD_ATOL * (10 if k == "min_depth" else 1)
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)
    sum((tout[k] * torch.as_tensor(ws[k])).sum() for k in keys).backward()
    assert_rel(ttbl.grad.numpy(), gj, msg="table grad")


def test_untile_cmajor_matches():
    rng = np.random.default_rng(11)
    acc = rng.normal(size=(6, 5, 256)).astype(np.float32)
    tf = rng.normal(size=(6, 256)).astype(np.float32)
    a = jr.untile_cmajor(jnp.asarray(acc), jnp.asarray(tf), (40, 30), (3, 2),
                         5)
    b = tr.untile_cmajor(torch.as_tensor(acc), torch.as_tensor(tf), (40, 30),
                         (3, 2), 5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
