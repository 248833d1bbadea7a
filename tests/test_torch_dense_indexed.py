"""Port vs reference: the indexed dense compositor (K5 reading a
per-Gaussian table by index), its binning's inverse slot map, and the
per-Gaussian gradient reduction.

The same numpy inputs (seeded) go to both packages. The JAX side runs as
its own suite runs it on the CPU: the reference packs the dense payload
with deblur4dgs_tpu.ops.tiling.pack_with_binning and composites it with the
Pallas kernels of composite_tiles in interpret mode; gradients through
jax.vjp. The port builds no payload: bin_indexed + dense_table + the twins
of the indexed kernels (CPU tensors), gradients summed per Gaussian through
the slot map.

Bars. Integer maps: equal to a brute-force inverse built from the pairs.
Twin vs reference: forward max abs <= 1e-5, every gradient <= 1e-4 of its
max |g| (K5's bars in tests/test_torch_dense.py: same stop chunks, float32
reassociation). rasterize: forward 2e-4 abs and gradients 5e-3 of max |g|
(tests/test_torch_dense.py's rasterize bars). The port-only checks are
exact up to float32 summation order (1e-6 of max |g|).
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
from tests.test_torch_dense import assert_rel
from tests.test_torch_models import torch_single_thread  # noqa: F401
from tests.test_torch_tiling import random_window

TWIN_FWD_ATOL = 1e-5
TWIN_GRAD_REL = 1e-4
FWD_ATOL = 2e-4
GRAD_REL = 5e-3
W48, H48 = 64, 48  # 4 x 3 tiles, padded to 16 rows
TILE = 16


def one_view(arrs):
    return tuple(x[0] for x in arrs)


def pair_tiles(means2d, radii, valid, depths, img_wh, MT):
    """The pair expansion of bin_gaussians_pairs, restated in numpy: per
    depth rank r (stable sort of valid depths) its MT pairs' tiles, -1 where
    the pair has none (outside the span or an invalid Gaussian)."""
    tiles_x, tiles_y = -(-img_wh[0] // TILE), -(-img_wh[1] // TILE)
    order = np.argsort(np.where(valid, depths, np.inf), kind="stable")
    mx, my = means2d[order, 0], means2d[order, 1]
    r, ok = radii[order], valid[order]

    def tile_of(x, n):
        return np.clip(np.floor(x / np.float32(TILE)), 0, n - 1).astype(int)

    tx0, tx1 = tile_of(mx - r, tiles_x), tile_of(mx + r, tiles_x)
    ty0, ty1 = tile_of(my - r, tiles_y), tile_of(my + r, tiles_y)
    out = np.full((len(order), MT), -1)
    for k in np.nonzero(ok)[0]:
        w = min(tx1[k] - tx0[k] + 1, MT)
        h = min(ty1[k] - ty0[k] + 1, max(MT // max(w, 1), 1))
        txc = np.clip(int(mx[k] / np.float32(TILE)), 0, tiles_x - 1)
        tyc = np.clip(int(my[k] / np.float32(TILE)), 0, tiles_y - 1)
        x0 = min(max(txc - w // 2, tx0[k]), tx1[k] - w + 1)
        y0 = min(max(tyc - h // 2, ty0[k]), ty1[k] - h + 1)
        for j in range(w * h):
            out[k, j] = (y0 + j // w) * tiles_x + x0 + j % w
    return out, order


SLOT_CASES = {
    # 5 + ~10% invalid Gaussians (random_window), every tile under cap
    "random_128": (lambda: one_view(random_window(0, 1, 400, 128, 128)),
                   (128, 128), 256, 32),
    # tiles over cap: pairs dropped for capacity
    "overflow_128": (lambda: one_view(random_window(2, 1, 1500, 128, 128)),
                     (128, 128), 128, 32),
    # spans wider than MT: pairs dropped for the span truncation
    "mt8_96x64": (lambda: one_view(random_window(3, 1, 300, 96, 64)),
                  (96, 64), 128, 8),
}


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_slot_of_pair_inverts_gather_idx(case):
    make, img_wh, cap, MT = SLOT_CASES[case]
    means2d, conics, depths, radii, valid = make()
    tp = TProjected(*map(torch.as_tensor, (means2d, conics, depths, radii,
                                           valid)))
    gi, counts, raw, order, slot_of_pair = tt.bin_gaussians_pairs(
        tp, img_wh, cap, MT)
    gi, counts, raw = gi.numpy(), counts.numpy(), raw.numpy()
    tiles, order_np = pair_tiles(means2d, radii, valid, depths, img_wh, MT)
    np.testing.assert_array_equal(order.numpy(), order_np)
    pos = {(t, int(gi[t, p])): p for t in range(gi.shape[0])
           for p in range(counts[t])}
    want = np.full(tiles.shape, -1)
    for (k, j), t in np.ndenumerate(tiles):
        if t < 0:
            continue
        if (t, k) in pos:
            want[k, j] = t * cap + pos[t, k]
        else:  # dropped only where the tile overflowed
            assert raw[t] > cap, (k, j, t)
    got = slot_of_pair.numpy()
    assert got.dtype == np.int32 and got.shape == tiles.shape
    np.testing.assert_array_equal(got, want)
    kept = got[got >= 0]  # every listed slot named exactly once
    assert len(np.unique(kept)) == len(kept) == int(counts.sum())
    assert (got[~valid[order_np]] == -1).all()
    if case == "overflow_128":
        assert int((raw > cap).sum()) > 0
    if case == "mt8_96x64":
        assert int(((tiles >= 0).sum(1) == MT).sum()) > 0


def test_bin_indexed_maps():
    """bin_indexed's idx = order[gather_idx] (sentinel G kept) and its slot
    map is slot_of_pair by Gaussian, dropped pairs on the sink slot."""
    means2d, conics, depths, radii, valid = one_view(
        random_window(2, 1, 1500, 128, 128))
    tp = TProjected(*map(torch.as_tensor, (means2d, conics, depths, radii,
                                           valid)))
    b = tt.bin_indexed(tp, (128, 128), cap=128)
    gi, _, _, order, sop = tt.bin_gaussians_pairs(tp, (128, 128), 128)
    G = len(depths)
    ext = np.append(order.numpy(), G)
    np.testing.assert_array_equal(b.idx.numpy(), ext[b.gather_idx.numpy()])
    assert b.idx.dtype == torch.int32 and b.idx.shape == (64, 128)
    sink = b.idx.numel()
    want = np.where(sop.numpy() >= 0, sop.numpy(), sink)
    np.testing.assert_array_equal(b.slot_map.numpy()[order.numpy()], want)


@pytest.fixture(scope="module", params=[4, 5])
def k5_case(request):
    """One view at 64x48 (D = 4: the static-reg render's rgb + mask; D = 5
    with depth), the reference's payload and composite_tiles (value and
    VJP w.r.t. means2d, conics, opacities, channels), and the port's inputs."""
    nchan = request.param
    arrs = one_view(random_window(10 + nchan, 1, 300, W48, H48))
    G = arrs[2].shape[0]
    rng = np.random.default_rng(nchan)
    op = rng.uniform(0.2, 0.95, G).astype(np.float32)
    ch = rng.uniform(0, 1, (G, nchan)).astype(np.float32)
    cap = 128
    tiles_xy = (-(-W48 // TILE), -(-H48 // TILE))
    jp0 = JProjected(*map(jnp.asarray, arrs))
    gi, counts, raw, order = jt.bin_gaussians_pairs(jp0, (W48, H48), cap)
    Tp = -(-gi.shape[0] // 8) * 8
    wa = rng.normal(size=(Tp, 256, nchan)).astype(np.float32)
    wt = rng.normal(size=(Tp, 256, 1)).astype(np.float32)

    def jfwd(m2, con, o, c):
        p = JProjected(m2, con, *map(jnp.asarray, arrs[2:]))
        b = jt.pack_with_binning(p, o, c, gi, counts, raw, order, tiles_xy)
        return jr.composite_tiles(b.tile_data, b.counts, tiles_xy[0], nchan)

    jin = [jnp.asarray(x) for x in (arrs[0], arrs[1], op, ch)]
    (ja, jtf), vjp = jax.vjp(jfwd, *jin)
    jg = vjp((jnp.asarray(wa), jnp.asarray(wt)))
    return dict(arrs=arrs, op=op, ch=ch, cap=cap, nchan=nchan, wa=wa, wt=wt,
                ja=np.asarray(ja), jtf=np.asarray(jtf),
                jg=[np.asarray(g) for g in jg], counts=np.asarray(counts))


def port_inputs(case, requires_grad=False):
    arrs = case["arrs"]
    leaves = [torch.tensor(x, requires_grad=requires_grad)
              for x in (arrs[0], arrs[1], case["op"], case["ch"])]
    tp = TProjected(leaves[0], leaves[1], *map(torch.as_tensor, arrs[2:]))
    binning = tt.bin_indexed(tp, (W48, H48), case["cap"])
    table = tt.dense_table(tp, leaves[2], leaves[3])
    return leaves, binning, table


def test_indexed_twin_forward_against_reference(k5_case):
    _, b, table = port_inputs(k5_case)
    nchan = k5_case["nchan"]
    assert table.shape == (301, tt.dense_row_floats(nchan))
    acc, tf = tr.composite_dense_plain(table, b.idx, b.counts,
                                       b.tiles_xy[0], nchan)
    n = len(k5_case["counts"])
    np.testing.assert_array_equal(b.counts.numpy()[:n], k5_case["counts"])
    np.testing.assert_allclose(acc.numpy(), k5_case["ja"],
                               atol=TWIN_FWD_ATOL, rtol=0)
    np.testing.assert_allclose(tf.numpy(), k5_case["jtf"],
                               atol=TWIN_FWD_ATOL, rtol=0)


def test_indexed_twin_grads_against_reference(k5_case):
    leaves, b, table = port_inputs(k5_case, requires_grad=True)
    acc, tf = tr.composite_indexed(table, b.idx, b.counts, b.slot_map,
                                   b.tiles_xy[0], k5_case["nchan"])
    ((acc * torch.as_tensor(k5_case["wa"])).sum()
     + (tf * torch.as_tensor(k5_case["wt"])).sum()).backward()
    for x, g, name in zip(leaves, k5_case["jg"],
                          ("means2d", "conics", "opacities", "channels")):
        assert float(np.abs(g).max()) > 0, name
        assert_rel(x.grad.numpy(), g, TWIN_GRAD_REL, name)


def test_rasterize_overflow_against_reference():
    """rasterize with tiles over cap, invalid Gaussians and depth (D = 5)
    against the reference rasterize."""
    arrs = one_view(random_window(8, 1, 700, W48, H48))
    G = arrs[2].shape[0]
    rng = np.random.default_rng(9)
    op = rng.uniform(0.05, 0.6, G).astype(np.float32)
    ch = rng.uniform(0, 1, (G, 5)).astype(np.float32)
    bg = np.array([1.0, 1.0, 1.0, 0.0, 0.0], np.float32)
    w_img = rng.normal(size=(H48, W48, 5)).astype(np.float32)
    w_a = rng.normal(size=(H48, W48)).astype(np.float32)

    def jloss(m2, con, o, c):
        p = JProjected(m2, con, *map(jnp.asarray, arrs[2:]))
        img, alpha, b = jr.rasterize(p, o, c, jnp.asarray(bg), (W48, H48),
                                     cap=128)
        return (jnp.sum(img * w_img) + jnp.sum(alpha * w_a),
                (img, alpha, b.raw_counts))

    jin = [jnp.asarray(x) for x in (arrs[0], arrs[1], op, ch)]
    jg, (jimg, jalpha, raw) = jax.grad(jloss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(*jin)
    assert int((np.asarray(raw) > 128).sum()) > 0  # tiles over cap
    tin = [torch.tensor(x, requires_grad=True)
           for x in (arrs[0], arrs[1], op, ch)]
    tp = TProjected(tin[0], tin[1], *map(torch.as_tensor, arrs[2:]))
    img, alpha, _ = tr.rasterize(tp, tin[2], tin[3], torch.as_tensor(bg),
                                 (W48, H48), cap=128)
    np.testing.assert_allclose(img.detach().numpy(), jimg, atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(alpha.detach().numpy(), jalpha, atol=FWD_ATOL,
                               rtol=0)
    ((img * torch.as_tensor(w_img)).sum()
     + (alpha * torch.as_tensor(w_a)).sum()).backward()
    for x, g, name in zip(tin, jg, ("means2d", "conics", "opacities",
                                    "channels")):
        assert_rel(x.grad.numpy(), g, GRAD_REL, name)


def test_dense_table_grad_sums_slots():
    """dense_table_grad against a loop: each Gaussian's slots summed, the
    sink never read (NaN here), the sentinel row zero."""
    rng = np.random.default_rng(0)
    n, Fp, G, MT = 40, 12, 15, 4
    gslot = rng.normal(size=(n + 1, Fp)).astype(np.float32)
    gslot[n] = np.nan
    slot_map = rng.integers(0, n + 1, (G, MT)).astype(np.int32)
    slot_map[3] = n  # every pair dropped
    got = tr.dense_table_grad(torch.as_tensor(gslot),
                              torch.as_tensor(slot_map)).numpy()
    want = np.zeros((G + 1, Fp), np.float32)
    for g in range(G):
        for j in range(MT):
            if slot_map[g, j] != n:
                want[g] += gslot[slot_map[g, j]]
    assert got.shape == (G + 1, Fp)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_indexed_duplicates_match_dense_payload():
    """One Gaussian in several tile rows: the indexed twin equals the
    dense-layout compositor (composite_tiles) on the gathered payload,
    forward and backward, with the table's gradient the sum of the
    payload's gradients over each Gaussian's slots."""
    rng = np.random.default_rng(4)
    T, cap, G, nchan, tiles_x = 8, 128, 120, 4, 4
    t_of = rng.integers(0, T, G)
    table = np.zeros((G + 1, tt.dense_row_floats(nchan)), np.float32)
    table[:G, 0] = (t_of % tiles_x) * 16 + rng.uniform(-6, 22, G)
    table[:G, 1] = (t_of // tiles_x) * 16 + rng.uniform(-6, 22, G)
    table[:G, 2:5] = rng.uniform([0.02, -0.01, 0.02], [0.2, 0.01, 0.2],
                                 (G, 3))
    table[:G, 5] = rng.uniform(0.1, 0.8, G)
    table[:G, 6] = 24.0
    table[:G, 7 : 7 + nchan] = rng.normal(size=(G, nchan))
    counts = rng.integers(1, 90, T).astype(np.int32)
    counts[2] = 0
    idx = np.full((T, cap), G, np.int32)
    slots = [[] for _ in range(G)]
    for t in range(T):
        rows = np.sort(rng.choice(G, counts[t], replace=False))
        idx[t, : counts[t]] = rows
        for j, g in enumerate(rows):
            slots[g].append(t * cap + j)
    MT = max(map(len, slots))
    assert MT > 1  # duplicates across rows
    slot_map = np.full((G, MT), T * cap, np.int32)
    for g, s in enumerate(slots):
        slot_map[g, : len(s)] = s
    wa = torch.as_tensor(rng.normal(size=(T, 256, nchan)).astype(np.float32))
    wt = torch.as_tensor(rng.normal(size=(T, 256, 1)).astype(np.float32))

    tab = torch.tensor(table, requires_grad=True)
    acc, tf = tr.composite_indexed(tab, torch.as_tensor(idx),
                                   torch.as_tensor(counts),
                                   torch.as_tensor(slot_map), tiles_x, nchan)
    ((acc * wa).sum() + (tf * wt).sum()).backward()
    data = torch.tensor(np.moveaxis(table[idx][..., : 7 + nchan], 1, 2),
                        requires_grad=True)
    dacc, dtf = tr.composite_tiles(data, torch.as_tensor(counts), tiles_x,
                                   nchan)
    ((dacc * wa).sum() + (dtf * wt).sum()).backward()
    np.testing.assert_allclose(acc.detach().numpy(), dacc.detach().numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tf.detach().numpy(), dtf.detach().numpy(),
                               atol=1e-6, rtol=0)
    gd = np.moveaxis(data.grad.numpy(), 1, 2)  # (T, cap, 7 + D)
    want = np.zeros((G + 1, table.shape[1]), np.float32)
    for t in range(T):
        for j in range(counts[t]):
            want[idx[t, j], : 7 + nchan] += gd[t, j]
    assert_rel(tab.grad.numpy(), want, 1e-6, "table")
    assert float(np.abs(tab.grad.numpy()[:, 6]).max()) == 0.0  # radius
    assert float(np.abs(tab.grad.numpy()[G]).max()) == 0.0  # sentinel
