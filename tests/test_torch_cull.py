"""The window kernels' per-warp cull, stated on the CPU (ops/rasterize.py::
warp_reach), against the per-pair alpha of the plain twins and of the JAX
reference.

The CUDA kernels (csrc/window_composite.cu) walk, per warp of 32 pixels,
only the Gaussians whose box test |px - mx| <= r, |py - my| <= r holds at
the warp's 8x4 block's pixel centre nearest the mean. These tests hold the
CPU statement of that test to two properties, exactly (no tolerance):
  * it never marks a warp unreached where alpha finds a live pixel of the
    warp (the twins' _alpha_chunk; the reference's _alpha_from_split), so
    the cull drops no pair that changes T or a sum;
  * it is the box test itself: reached iff some pixel of the warp passes
    the box test with the same float32 rounding.
Hypothesis draws means placed so that |px - mx| or |py - my| equals r at a
warp's nearest centre, r = 0 and r far beyond the tile, means straddling
warp boundaries, +-0.0 and large finite values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deblur4dgs_tpu.ops import rasterize as jr
from deblur4dgs_tpu_torch.ops import rasterize as tr
from tests.test_torch_models import torch_single_thread  # noqa: F401

TILES_X = 5
N_TILES = 15
EXTREMES = [0.0, -0.0, 1e30, -1e30, 3.4e38, -3.4e38, 1e-30, -1e-30]


def box_tiles(tile):
    """Pixel-centre ranges of the 8 warps of `tile`: (xlo, ylo) (NWARPS,)."""
    w = np.arange(tr.NWARPS)
    xlo = (tile % TILES_X) * 16 + (w % 2) * tr.WARP_W + 0.5
    ylo = (tile // TILES_X) * 16 + (w // 2) * tr.WARP_H + 0.5
    return xlo, ylo


@st.composite
def gaussian(draw, tile):
    """One Gaussian's (mx, my, r, a, b, c, op) around `tile`'s warps."""
    r = draw(st.one_of(
        st.sampled_from([0.0, 0.5, 1.0, 3.0, 7.0, 1e6, 3.4e38]),
        st.integers(0, 40).map(float),
        st.floats(0.0, 50.0, width=32),
    ))
    xlo, ylo = box_tiles(tile)
    w = draw(st.integers(0, tr.NWARPS - 1))

    def coord(lo, extent):
        edge = lo + draw(st.sampled_from([0.0, extent - 1.0]))
        return draw(st.one_of(
            # |centre - mean| == r at the warp's nearest centre, or one ulp
            # inside / outside
            st.sampled_from([-1.0, 1.0]).map(lambda s: np.float32(edge + s * r)),
            st.sampled_from([-1.0, 1.0]).map(
                lambda s: np.nextafter(np.float32(edge + s * r),
                                       np.float32(s * np.inf))),
            st.sampled_from([-1.0, 1.0]).map(
                lambda s: np.nextafter(np.float32(edge + s * r),
                                       np.float32(-s * np.inf))),
            # on and near the warp boundaries (integers) and pixel centres
            st.integers(-2, 2).map(lambda k: np.float32(lo - 0.5 + k)),
            st.integers(-2, 2).map(
                lambda k: np.float32(lo - 0.5 + extent + k)),
            st.floats(lo - 40.0, lo + 40.0, width=32),
            st.sampled_from(EXTREMES),
        ))

    mx = coord(xlo[w], tr.WARP_W)
    my = coord(ylo[w], tr.WARP_H)
    wide = draw(st.booleans())  # flat Gaussians: live wherever in the box
    if wide:
        a, b, c = 0.0, 0.0, draw(st.sampled_from([0.0, 1e-6]))
    else:
        a = draw(st.floats(0.0, 2.0, width=32))
        c = draw(st.floats(0.0, 2.0, width=32))
        b = draw(st.floats(-0.5, 0.5, width=32))
    op = draw(st.sampled_from([0.9, 0.5, 1.0 / 255.0, 0.999]))
    return [float(mx), float(my), a, b, c, r, op]


@st.composite
def bucket(draw):
    tile = draw(st.integers(0, N_TILES - 1))
    gs = draw(st.lists(gaussian(tile), min_size=1, max_size=24))
    return tile, np.asarray(gs, np.float32)


def cull_and_alpha(tile, gs):
    """warp_reach (NWARPS, C) and the twins' live and box masks (P, C) for
    the Gaussians gs (C, 7) of image tile `tile` (one row, one sub-frame)."""
    C = gs.shape[0]
    dyn = torch.as_tensor(gs[:, :6].T.copy())[None, None]  # (1, 1, 6, C)
    op = torch.as_tensor(gs[:, 6])[None, None, None, :]
    ids = torch.tensor([tile], dtype=torch.int32)
    reach = tr.warp_reach(dyn, ids, TILES_X)[0, 0]
    px, py = tr._pixel_centres(ids, TILES_X)
    in_count = torch.ones((1, 1, 1, C), dtype=torch.bool)
    alpha, dx, dy, _ = tr._alpha_chunk(dyn, op, px, py, in_count)
    r = dyn[:, :, 5, None, :]
    inbox = (dx.abs() <= r) & (dy.abs() <= r)
    return reach, (alpha > 0)[0, 0], inbox[0, 0]


WARP_MAJOR = torch.argsort(tr.warp_of_pixel(), stable=True)


def per_warp_any(mask):
    """(P, C) pixel mask -> (NWARPS, C): any pixel of each warp."""
    return mask[WARP_MAJOR].reshape(tr.NWARPS, 32, -1).any(1)


def test_warp_map_is_8x4_blocks():
    wop = tr.warp_of_pixel().reshape(16, 16)
    for w in range(tr.NWARPS):
        ys, xs = np.nonzero(wop.numpy() == w)
        assert len(ys) == 32
        assert xs.min() == (w % 2) * 8 and xs.max() == xs.min() + 7
        assert ys.min() == (w // 2) * 4 and ys.max() == ys.min() + 3


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(bucket())
def test_cull_never_drops_a_live_pair_and_is_the_box_test(case):
    tile, gs = case
    reach, live, inbox = cull_and_alpha(tile, gs)
    live_w, box_w = per_warp_any(live), per_warp_any(inbox)
    dropped = live_w & ~reach
    assert not bool(dropped.any()), (
        f"live pair culled: warps/Gaussians {dropped.nonzero().tolist()}")
    assert torch.equal(reach, box_w)


def test_edge_cases_are_exact():
    """Hand-placed means: |dx| == r at the nearest centre is reached (and
    live for a flat Gaussian), one ulp beyond is not; r = 0 on a centre."""
    tile = 7
    xlo, ylo = box_tiles(tile)
    y_mid = ylo[0] + 1.0  # a centre row of warps 0 and 1
    gs = []
    for r in (0.0, 1.0, 3.0, 13.0):
        right = np.float32(xlo[0] + 7.0 + r)  # |xhi(w0) - mx| == r
        beyond = np.nextafter(right, np.float32(np.inf))
        gs += [[right, y_mid, 0, 0, 0, r, 0.9],
               [beyond, y_mid, 0, 0, 0, r, 0.9]]
    reach, live, _ = cull_and_alpha(tile, np.asarray(gs, np.float32))
    live_w = per_warp_any(live)
    for i in range(0, len(gs), 2):
        assert bool(reach[0, i]) and bool(live_w[0, i])  # edge: reached
        assert not bool(reach[0, i + 1]) and not bool(live_w[0, i + 1])


@pytest.mark.parametrize("seed", [0, 1])
def test_cull_holds_against_the_reference_alpha(seed):
    """Random window Gaussians around the tiles (as the kernels' buckets
    hold them): every pixel the JAX reference's _alpha_from_split finds live
    lies in a warp the cull reaches."""
    rng = np.random.default_rng(seed)
    T, C = 6, 128
    ids = rng.permutation(N_TILES)[:T].astype(np.int32)
    dyn = np.zeros((T, 1, 6, C), np.float32)
    dyn[:, 0, 0] = (ids % TILES_X)[:, None] * 16 + rng.uniform(-6, 22, (T, C))
    dyn[:, 0, 1] = (ids // TILES_X)[:, None] * 16 + rng.uniform(-6, 22, (T, C))
    dyn[:, 0, 2] = rng.uniform(0.02, 0.5, (T, C))
    dyn[:, 0, 3] = rng.uniform(-0.01, 0.01, (T, C))
    dyn[:, 0, 4] = rng.uniform(0.02, 0.5, (T, C))
    dyn[:, 0, 5] = rng.integers(0, 30, (T, C))
    op = rng.uniform(0.05, 0.99, (T, C)).astype(np.float32)
    reach = tr.warp_reach(torch.as_tensor(dyn), torch.as_tensor(ids),
                          TILES_X)[:, 0]
    wop = tr.warp_of_pixel().numpy()
    culled = 0
    for t in range(T):
        p = np.arange(256)
        px = ((ids[t] % TILES_X) * 16 + p % 16 + 0.5).astype(np.float32)
        py = ((ids[t] // TILES_X) * 16 + p // 16 + 0.5).astype(np.float32)
        alpha, _, _, _ = jr._alpha_from_split(
            jnp.asarray(dyn[t, 0]), jnp.asarray(op[t][None]),
            jnp.asarray(px[:, None]), jnp.asarray(py[:, None]))
        live = np.asarray(alpha) > 0  # (P, C)
        for w in range(tr.NWARPS):
            live_w = live[wop == w].any(0)
            assert not (live_w & ~reach[t, w].numpy()).any()
        culled += int((~reach[t]).sum())
    assert culled > 0  # the cull does remove (warp, Gaussian) iterations
