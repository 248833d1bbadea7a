"""Port vs reference: the small-image window path — dense exposure-shared
binning (bin_gaussians_union), its payload gathers (pack_static,
pack_dyn_all), the split compositor K4 and render(mode="blury") on images
under 64 tiles or with bucketed=False.

The JAX side runs as its suite runs it on the CPU (K4 in Pallas interpret
mode, gradients through jax.vjp / jax.grad). Bars: integer lists and
gathered payloads equal; K4's twin (the window twin at S = 1) forward max
abs 1e-5 and gradients 1e-4 of max |g| (K4 and the twin both stop per tile
row); render forward 2e-4 abs, gradients 5e-3 of max |g| (the window
tests' bars).
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
from deblur4dgs_tpu_torch.convert import scene_from_numpy
from deblur4dgs_tpu_torch.models import scene as tscene
from deblur4dgs_tpu_torch.ops import rasterize as tr
from deblur4dgs_tpu_torch.ops import tiling as tt
from deblur4dgs_tpu_torch.ops.projection import Projected as TProjected
from tests.test_torch_dense import K48, H48, W48, assert_rel
from tests.test_torch_models import (
    compile_once,
    K128,
    assert_grads_match,
    jax_scene,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_rasterize import NCHAN, TILES_X, make_data
from tests.test_torch_tiling import random_window, tied_window

K4_FWD_ATOL = 1e-5
K4_GRAD_REL = 1e-4
FWD_ATOL = 2e-4
GRAD_REL = 5e-3

UNION_CASES = {
    "random_64x48": (lambda: random_window(3, 3, 300, W48, H48), (W48, H48),
                     256, 32),
    "random_128_mt8": (lambda: random_window(1, 3, 400, 128, 128),
                       (128, 128), 128, 8),
    "tied_320x160": (lambda: tied_window(3, 320, 160), (320, 160), 256, 32),
}


@pytest.mark.parametrize("case", list(UNION_CASES))
def test_union_lists_and_packing_equal(case):
    make, img_wh, cap, mt = UNION_CASES[case]
    arrs = make()
    jp = JProjected(*map(jnp.asarray, arrs))
    tp = TProjected(*map(torch.as_tensor, arrs))
    jb = jt.bin_gaussians_union(jp, img_wh, cap, max_tiles_per_gauss=mt)
    tb = tt.bin_gaussians_union(tp, img_wh, cap, max_tiles_per_gauss=mt)
    for name, a, b in zip(("gather_idx", "counts", "raw", "order"), jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    S, G = arrs[2].shape
    rng = np.random.default_rng(2)
    op = rng.uniform(size=G).astype(np.float32)
    ch = rng.normal(size=(G, 5)).astype(np.float32)
    js = jt.pack_static(jnp.asarray(op), jnp.asarray(ch), jb[0], jb[3])
    ts = tt.pack_static(torch.as_tensor(op), torch.as_tensor(ch), tb[0], tb[3])
    assert ts.is_contiguous() and ts.shape[0] % 8 == 0
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    for depth in (True, False):
        jd = jt.pack_dyn_all(jp, jb[0], jb[3], depth)
        td = tt.pack_dyn_all(tp, tb[0], tb[3], depth)
        assert all(td[s].is_contiguous() for s in range(S))
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())


@pytest.mark.parametrize("dense", [False, True])
def test_k4_twin_against_reference(dense):
    dyn, st, counts, ids = make_data(20 + dense, 1, dense=dense)
    dyn = dyn[:, 0]  # one sub-frame: (T, Fd, cap)
    rng = np.random.default_rng(dense)
    T = dyn.shape[0]
    wa = rng.normal(size=(T, NCHAN, 256)).astype(np.float32)
    wt = rng.normal(size=(T, 256)).astype(np.float32)
    (ja, jtf), vjp = jax.vjp(
        lambda d, s: jr.composite_tiles_split(
            d, s, jnp.asarray(counts), jnp.asarray(ids), TILES_X, NCHAN,
            True),
        jnp.asarray(dyn), jnp.asarray(st))
    jgd, jgs = vjp((jnp.asarray(wa), jnp.asarray(wt)))

    d = torch.tensor(dyn, requires_grad=True)
    s = torch.tensor(st, requires_grad=True)
    ta, ttf = tr.composite_tiles_split(d, s, torch.as_tensor(counts),
                                       torch.as_tensor(ids), TILES_X, NCHAN,
                                       True)
    assert ta.shape == (T, NCHAN, 256) and ttf.shape == (T, 256)
    np.testing.assert_allclose(ta.detach().numpy(), ja, atol=K4_FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(ttf.detach().numpy(), jtf, atol=K4_FWD_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(ttf[1].detach().numpy(), 1.0)  # empty row
    ((ta * torch.as_tensor(wa)).sum() + (ttf * torch.as_tensor(wt)).sum()
     ).backward()
    gd, jgd = d.grad.numpy(), np.asarray(jgd)
    for row, name in enumerate(("mx", "my", "a", "b", "c")):
        assert_rel(gd[:, row], jgd[:, row], K4_GRAD_REL, name)
    assert_rel(gd[:, 6], jgd[:, 6], K4_GRAD_REL, "depth")
    assert float(np.abs(gd[:, 5]).max()) == 0.0  # radius: no gradient
    assert_rel(s.grad.numpy(), jgs, K4_GRAD_REL, "static rows")


RENDER_CASES = {
    # the dynamic branch's window at 64x48 (under 64 tiles): all Gaussians,
    # rgb + mask + 2x3 track channels + depth (nchan 11)
    "dynamic_64x48": ((W48, H48), K48, True, dict(return_mask=True,
                                                  return_depth=True)),
    # the static branch's window with bucketed=False at 128x128
    "static_unbucketed_128": ((128, 128), K128, False, dict(
        bg_only=True, return_mask=True, return_depth=True, bucketed=False)),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_split_window_against_reference(case):
    img_wh, K, tracks, extra = RENDER_CASES[case]
    kw = dict(extra, mode="blury", num_exposure=3, cap=256, bg_color=1.0)
    if tracks:
        kw.update(target_ts=np.array([2.0, 4.0], np.float32),
                  target_w2cs=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)))
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    arrays = scene_arrays(seed=23)
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.05, -0.02, 0.1]
    keys = ["img", "acc", "mask", "depth"] + (["tracks_3d"] if tracks
                                              else [])
    ts = scene_from_numpy(arrays, device="cpu")
    tout = tscene.render(ts, torch.tensor(3.0), torch.as_tensor(view),
                         torch.as_tensor(K), img_wh, **tkw)
    rng = np.random.default_rng(4)
    ws = {k: rng.normal(size=tout[k].shape).astype(np.float32) for k in keys}

    def jloss(s):
        o = jscene.render(s, 3.0, jnp.asarray(view), jnp.asarray(K), img_wh,
                          **jkw)
        return sum(jnp.sum(o[k] * ws[k]) for k in keys), o

    js = jax_scene(arrays)
    jg, jo = compile_once(jax.jit(jax.grad(jloss, has_aux=True)), js)(js)
    for k in keys + ["pred_sharp_img", "exposure_imgs", "exposure_alphas",
                     "exposure_masks"]:
        a, b = tout[k].detach().numpy(), np.asarray(jo[k])
        assert a.shape == b.shape, k
        atol = FWD_ATOL * (10 if k == "depth" else 1)  # depth units ~ 3
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(tout["radii"].detach().numpy(),
                                  jo["radii"])
    assert float(tout["tile_overflow"]) == float(jo["tile_overflow"])
    sum((tout[k] * torch.as_tensor(ws[k])).sum() for k in keys).backward()
    assert_grads_match(jg, ts, GRAD_REL, rel=True)
