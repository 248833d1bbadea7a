"""Port vs reference: dense binning, the dense compositor K5, the one-view
rasterizer and the sharp S=1 render.

The same numpy inputs (seeded) go to both packages. The JAX side runs as
its own suite runs it on the CPU: the Pallas kernels of composite_tiles in
interpret mode, gradients through jax.vjp / jax.grad.

Bars. Integer binning outputs and gathered payloads: equal. K5's twin:
forward max abs <= 1e-5 and every gradient <= 1e-4 of its max |g| (both
sides stop each tile at the same chunk; what differs is float32
reassociation and the reference's exp(cumsum(log1p)) transmittance against
the port's running product). rasterize / render: forward 2e-4 abs and
gradients 5e-3 of max |g| (the window tests' bars: one more gather and its
scatter-add between the compositor and the parameters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.models import scene as jscene
from deblur4dgs_tpu.ops import rasterize as jr
from deblur4dgs_tpu.ops import tiling as jt
from deblur4dgs_tpu.ops.projection import Projected as JProjected
from deblur4dgs_tpu.train import losses as JL
from deblur4dgs_tpu_torch.convert import scene_from_numpy
from deblur4dgs_tpu_torch.models import scene as tscene
from deblur4dgs_tpu_torch.ops import rasterize as tr
from deblur4dgs_tpu_torch.ops import tiling as tt
from deblur4dgs_tpu_torch.ops.projection import Projected as TProjected
from deblur4dgs_tpu_torch.train import losses as TL
from tests.test_torch_models import (
    compile_once,
    assert_grads_match,
    jax_scene,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_tiling import random_window, tied_window

TILES_X = 4
K5_FWD_ATOL = 1e-5
K5_GRAD_REL = 1e-4
FWD_ATOL = 2e-4
GRAD_REL = 5e-3
W48, H48 = 64, 48  # 4 x 3 tiles, padded to 16 rows
K48 = np.array([[55.0, 0, 32], [0, 55.0, 24], [0, 0, 1]], np.float32)


def assert_rel(a, b, rel, msg=""):
    b = np.asarray(b)
    scale = float(np.abs(b).max()) + 1e-12
    np.testing.assert_allclose(np.asarray(a) / scale, b / scale, atol=rel,
                               rtol=0, err_msg=msg)


def one_view(arrs):
    return tuple(x[0] for x in arrs)


BIN_CASES = {
    "random_128": (lambda: one_view(random_window(0, 1, 400, 128, 128)),
                   (128, 128), 256),
    "overflow_128": (lambda: one_view(random_window(2, 1, 1500, 128, 128)),
                     (128, 128), 128),
    "tied_320x160": (lambda: one_view(tied_window(1, 320, 160)), (320, 160),
                     256),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_pairs_and_pack_equal(case):
    make, img_wh, cap = BIN_CASES[case]
    arrs = make()
    jp = JProjected(*map(jnp.asarray, arrs))
    tp = TProjected(*map(torch.as_tensor, arrs))
    jb = jt.bin_gaussians_pairs(jp, img_wh, cap)
    tb = tt.bin_gaussians_pairs(tp, img_wh, cap)
    for name, a, b in zip(("gather_idx", "counts", "raw", "order"), jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    if case == "overflow_128":
        assert int((tb[2] > cap).sum()) > 0  # dropped pairs really exist
    G = arrs[2].shape[0]
    rng = np.random.default_rng(1)
    op = rng.uniform(size=G).astype(np.float32)
    ch = rng.normal(size=(G, 4)).astype(np.float32)
    jpk = jt.pack_and_gather(jp, jnp.asarray(op), jnp.asarray(ch), img_wh,
                             cap=cap)
    tpk = tt.pack_and_gather(tp, torch.as_tensor(op), torch.as_tensor(ch),
                             img_wh, cap=cap)
    assert tpk.tiles_xy == jpk.tiles_xy
    assert tpk.tile_data.is_contiguous()
    for name in ("tile_data", "counts", "gather_idx", "order", "raw_counts"):
        np.testing.assert_array_equal(np.asarray(getattr(jpk, name)),
                                      getattr(tpk, name).numpy(),
                                      err_msg=name)


def make_dense(seed, nchan, n_tiles=16, cap=256, dense=False):
    """Random K5 inputs: row t holds Gaussians around image tile t (4 tiles
    wide); up to two chunks per row; row 1 is empty; ``dense`` packs wide
    opaque Gaussians so rows saturate in their first chunk."""
    rng = np.random.default_rng(seed)
    data = np.zeros((n_tiles, 7 + nchan, cap), np.float32)
    t = np.arange(n_tiles)
    data[:, 0] = (t % TILES_X)[:, None] * 16 + rng.uniform(-4, 20,
                                                           (n_tiles, cap))
    data[:, 1] = (t // TILES_X)[:, None] * 16 + rng.uniform(-4, 20,
                                                            (n_tiles, cap))
    data[:, 2] = rng.uniform(0.02, 0.2, (n_tiles, cap))
    data[:, 3] = rng.uniform(-0.01, 0.01, (n_tiles, cap))
    data[:, 4] = rng.uniform(0.02, 0.2, (n_tiles, cap))
    data[:, 5] = rng.uniform(0.05, 0.7, (n_tiles, cap))
    data[:, 6] = 30.0
    data[:, 7:] = rng.uniform(0, 1, (n_tiles, nchan, cap))
    if dense:
        data[:, 2:5] *= 0.05
        data[:, 5] = rng.uniform(0.9, 0.99, (n_tiles, cap))
    counts = rng.integers(1, cap + 1, n_tiles).astype(np.int32)
    counts[1] = 0
    data *= (np.arange(cap)[None, :] < counts[:, None])[:, None, :]
    return data, counts


@pytest.mark.parametrize("nchan", [4, 5])
@pytest.mark.parametrize("dense", [False, True])
def test_k5_twin_against_reference(nchan, dense):
    data, counts = make_dense(nchan + 10 * dense, nchan, dense=dense)
    rng = np.random.default_rng(nchan)
    T = data.shape[0]
    wa = rng.normal(size=(T, 256, nchan)).astype(np.float32)
    wt = rng.normal(size=(T, 256, 1)).astype(np.float32)
    (ja, jtf), vjp = jax.vjp(
        lambda d: jr.composite_tiles(d, jnp.asarray(counts), TILES_X, nchan),
        jnp.asarray(data))
    (jg,) = vjp((jnp.asarray(wa), jnp.asarray(wt)))

    d = torch.tensor(data, requires_grad=True)
    ta, ttf = tr.composite_tiles(d, torch.as_tensor(counts), TILES_X, nchan)
    assert ta.shape == (T, 256, nchan) and ttf.shape == (T, 256, 1)
    np.testing.assert_allclose(ta.detach().numpy(), ja, atol=K5_FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(ttf.detach().numpy(), jtf, atol=K5_FWD_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(ttf[1].detach().numpy(), 1.0)  # empty row
    if dense:
        assert float(ttf.detach()[counts > 0].max()) < tr.EARLY_STOP_T
    ((ta * torch.as_tensor(wa)).sum() + (ttf * torch.as_tensor(wt)).sum()
     ).backward()
    g, jg = d.grad.numpy(), np.asarray(jg)
    for row, name in enumerate(("mx", "my", "a", "b", "c", "op")):
        assert_rel(g[:, row], jg[:, row], K5_GRAD_REL, name)
    assert_rel(g[:, 7:], jg[:, 7:], K5_GRAD_REL, "channels")
    assert float(np.abs(g[:, 6]).max()) == 0.0  # radius: no gradient
    past = np.arange(data.shape[-1])[None, :] >= counts[:, None]
    assert float(np.abs(np.moveaxis(g, 1, 2)[past]).max()) == 0.0
    if dense:  # stopped after the first chunk: no gradient beyond it
        assert float(np.abs(g[..., 128:]).max()) == 0.0


def test_rasterize_against_reference():
    arrs = one_view(random_window(4, 1, 200, W48, H48))
    G = arrs[2].shape[0]
    rng = np.random.default_rng(5)
    op = rng.uniform(0.2, 0.95, G).astype(np.float32)
    ch = rng.uniform(0, 1, (G, 4)).astype(np.float32)
    bg = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    w_img = rng.normal(size=(H48, W48, 4)).astype(np.float32)
    w_a = rng.normal(size=(H48, W48)).astype(np.float32)

    def jloss(m2, con, o, c):
        p = JProjected(m2, con, *map(jnp.asarray, arrs[2:]))
        img, alpha, _ = jr.rasterize(p, o, c, jnp.asarray(bg), (W48, H48),
                                     cap=256)
        return jnp.sum(img * w_img) + jnp.sum(alpha * w_a), (img, alpha)

    jin = [jnp.asarray(x) for x in (arrs[0], arrs[1], op, ch)]
    jg, (jimg, jalpha) = jax.grad(jloss, argnums=(0, 1, 2, 3),
                                  has_aux=True)(*jin)
    tin = [torch.tensor(x, requires_grad=True)
           for x in (arrs[0], arrs[1], op, ch)]
    tp = TProjected(tin[0], tin[1], *map(torch.as_tensor, arrs[2:]))
    img, alpha, binning = tr.rasterize(tp, tin[2], tin[3],
                                       torch.as_tensor(bg), (W48, H48),
                                       cap=256)
    assert binning.idx.shape == (16, 256)  # table rows by index: no payload
    assert binning.slot_map.shape == (G, 32)
    np.testing.assert_allclose(img.detach().numpy(), jimg, atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(alpha.detach().numpy(), jalpha, atol=FWD_ATOL,
                               rtol=0)
    ((img * torch.as_tensor(w_img)).sum()
     + (alpha * torch.as_tensor(w_a)).sum()).backward()
    for x, g, name in zip(tin, jg, ("means2d", "conics", "opacities",
                                    "channels")):
        assert_rel(x.grad.numpy(), g, GRAD_REL, name)


RENDER_CASES = {
    # the static-reg branch's render: bg only, rgb + mask (D = 4)
    "mid_bg": dict(mode="mid", bg_only=True, return_mask=True),
    # all Gaussians, rgb + mask + expected depth (D = 5). ('end' is the
    # same path; there the head_start gradient is zero but for roundoff,
    # which no relative bar can compare.)
    "start_all": dict(mode="start", return_mask=True, return_depth=True),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_sharp_against_reference(case):
    kw = dict(RENDER_CASES[case], num_exposure=3, cap=256, bg_color=1.0)
    arrays = scene_arrays(seed=21)
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.05, -0.02, 0.1]
    keys = ["img", "acc", "mask"] + (["depth"] if "return_depth" in kw
                                     else [])
    rng = np.random.default_rng(3)

    def jout(s):
        return jscene.render(s, 3.0, jnp.asarray(view), jnp.asarray(K48),
                             (W48, H48), **kw)

    ts = scene_from_numpy(arrays, device="cpu")
    tout = tscene.render(ts, torch.tensor(3.0), torch.as_tensor(view),
                         torch.as_tensor(K48), (W48, H48), **kw)
    ws = {k: rng.normal(size=tout[k].shape).astype(np.float32) for k in keys}

    def jloss(s):
        o = jout(s)
        return sum(jnp.sum(o[k] * ws[k]) for k in keys), o

    js = jax_scene(arrays)
    jg, jo = compile_once(jax.jit(jax.grad(jloss, has_aux=True)), js)(js)
    for k in keys + ["pred_sharp_img", "exposure_imgs", "exposure_alphas",
                     "poses", "times"]:
        a, b = tout[k].detach().numpy(), np.asarray(jo[k])
        assert a.shape == b.shape, k
        atol = FWD_ATOL * (10 if k == "depth" else 1)  # depth units ~ 3
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(tout["radii"].detach().numpy(), jo["radii"])
    assert tout["radii"].shape[0] == 1
    assert np.isnan(float(tout["tile_overflow"]))
    assert np.isnan(float(jo["tile_overflow"]))
    sum((tout[k] * torch.as_tensor(ws[k])).sum() for k in keys).backward()
    assert_grads_match(jg, ts, GRAD_REL, rel=True)


@pytest.mark.parametrize("chans", [0, 2])
def test_gradient_loss_against_reference(chans):
    rng = np.random.default_rng(chans)
    shape = (24, 32) + ((chans,) if chans else ())
    pred = rng.normal(size=shape).astype(np.float32)
    gt = rng.normal(size=shape).astype(np.float32)
    mask = rng.uniform(size=(24, 32)) > 0.3
    jv, jg = jax.value_and_grad(
        lambda p: JL.compute_gradient_loss(p, jnp.asarray(gt),
                                           jnp.asarray(mask), quantile=0.95)
    )(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    tv = TL.compute_gradient_loss(p, torch.as_tensor(gt),
                                  torch.as_tensor(mask), quantile=0.95)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), jg, atol=1e-7, rtol=1e-5)
