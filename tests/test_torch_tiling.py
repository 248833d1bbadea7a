"""Port vs reference: exposure-shared binning, count-sorted buckets, packing.

The same projected window (numpy, seeded) goes to both packages. Every
integer output must be EQUAL: the depth order, the sorted pair runs, the
per-tile counts, every bucket's tile ids / counts / gather indices, and the
capacity-truncation statistic tile_overflow. The gathered payload tables
are pure gathers of identical inputs, so they are equal too.

Two layouts: a random 128x128 window, and a 320x160 grid layout where most
tiles share an occupancy count and many Gaussians share a depth — the
stable sorts (depth order, bucket order by -count) must break those ties
by index exactly as jnp.argsort does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.ops import tiling as jt
from deblur4dgs_tpu.ops.projection import Projected as JProjected
from deblur4dgs_tpu_torch.ops import tiling as tt
from deblur4dgs_tpu_torch.ops.projection import Projected as TProjected
from tests.test_torch_models import torch_single_thread  # noqa: F401


def random_window(seed, S, G, W, H):
    rng = np.random.default_rng(seed)
    base = rng.uniform([-10, -10], [W + 10, H + 10], (G, 2))
    means2d = base[None] + rng.normal(scale=2.0, size=(S, G, 2))
    conics = np.stack([rng.uniform(0.02, 0.3, (S, G)),
                       rng.uniform(-0.01, 0.01, (S, G)),
                       rng.uniform(0.02, 0.3, (S, G))], -1)
    depths = rng.uniform(1.0, 6.0, G)[None] + rng.normal(scale=0.05,
                                                         size=(S, G))
    radii = np.ceil(rng.uniform(1.0, 40.0, (S, G)))
    valid = rng.uniform(size=(S, G)) > 0.1
    valid[:, :5] = False  # some Gaussians invalid in every sub-frame
    radii = np.where(valid, radii, 0.0)
    return (means2d.astype(np.float32), conics.astype(np.float32),
            depths.astype(np.float32), radii.astype(np.float32), valid)


def tied_window(S, W, H):
    """Gaussians on a regular grid: equal radii, depths from a few levels,
    so many tiles share occupancy counts and many Gaussians share a key."""
    xs, ys = np.meshgrid(np.arange(8.0, W, 16.0), np.arange(8.0, H, 16.0))
    pts = np.stack([xs.ravel(), ys.ravel()], -1)
    pts = np.concatenate([pts, pts + 3.0, pts[::3] - 2.0])
    G = pts.shape[0]
    means2d = np.broadcast_to(pts, (S, G, 2)).copy()
    means2d[:, :, 0] += np.arange(S)[:, None] * 0.5
    conics = np.broadcast_to([0.1, 0.0, 0.1], (S, G, 3)).copy()
    depths = np.broadcast_to(1.0 + (np.arange(G) % 4) * 0.5, (S, G)).copy()
    radii = np.full((S, G), 9.0)
    valid = np.ones((S, G), bool)
    return (means2d.astype(np.float32), conics.astype(np.float32),
            depths.astype(np.float32), radii.astype(np.float32), valid)


CASES = {
    "random_128": (lambda: random_window(0, 3, 400, 128, 128), (128, 128),
                   256, 32),
    "random_128_mt8": (lambda: random_window(1, 3, 400, 128, 128),
                       (128, 128), 128, 8),
    "tied_320x160": (lambda: tied_window(3, 320, 160), (320, 160), 256, 32),
}


def both(case):
    make, img_wh, cap, mt = CASES[case]
    arrs = make()
    jp = JProjected(*map(jnp.asarray, arrs))
    tp = TProjected(*map(torch.as_tensor, arrs))
    jr = jt.bin_gaussians_union_runs(jp, img_wh, cap, max_tiles_per_gauss=mt)
    tr = tt.bin_gaussians_union_runs(tp, img_wh, cap, max_tiles_per_gauss=mt)
    return arrs, jp, tp, jr, tr, img_wh, cap


def eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=msg)


@pytest.mark.parametrize("case", list(CASES))
def test_runs_equal(case):
    _, _, _, jr, tr, _, _ = both(case)
    for name, a, b in zip(("rank_sorted", "starts", "counts", "raw", "order"),
                          jr, tr):
        eq(a, b, name)


@pytest.mark.parametrize("case", list(CASES))
def test_buckets_and_overflow_equal(case):
    _, jp, tp, jr, tr, img_wh, cap = both(case)
    tx, ty = jt.num_tiles(img_wh)
    assert tt.num_tiles(img_wh) == (tx, ty)
    spec = jt.default_bucket_spec(tx * ty, cap)
    assert tt.default_bucket_spec(tx * ty, cap) == spec
    G = jp.depths.shape[1]
    jb = jt.bucket_tiles_from_runs(jr[0], jr[1], jr[3], G, spec)
    tb = tt.bucket_tiles_from_runs(tr[0], tr[1], tr[3], G, spec)
    assert tuple(jb.caps) == tuple(tb.caps)
    assert tuple(jb.sizes) == tuple(tb.sizes)
    for b in range(len(spec)):
        eq(jb.tile_ids[b], tb.tile_ids[b], f"tile_ids[{b}]")
        eq(jb.counts[b], tb.counts[b], f"counts[{b}]")
        eq(jb.gather_idx[b], tb.gather_idx[b], f"gather_idx[{b}]")
    # tile_overflow exactly as scene.render computes it
    j_kept = sum(jnp.sum(c) for c in jb.counts)
    j_over = 1.0 - j_kept.astype(jnp.float32) / jnp.maximum(
        jnp.sum(jr[3]), 1).astype(jnp.float32)
    t_kept = sum(c.sum() for c in tb.counts)
    t_over = 1.0 - t_kept.float() / torch.clamp(tr[3].sum(), min=1).float()
    assert float(j_over) == float(t_over)
    if case == "tied_320x160":
        # the layout really is tie-heavy
        raw = tr[3].numpy()
        assert np.unique(raw).size < raw.size // 4


@pytest.mark.parametrize("case", ["random_128", "tied_320x160"])
def test_packing_equal(case):
    arrs, jp, tp, jr, tr, img_wh, cap = both(case)
    S, G = arrs[2].shape
    rng = np.random.default_rng(3)
    op = rng.uniform(size=G).astype(np.float32)
    ch = rng.normal(size=(G, 6)).astype(np.float32)
    spec = jt.default_bucket_spec(np.prod(jt.num_tiles(img_wh)), cap)
    jb = jt.bucket_tiles_from_runs(jr[0], jr[1], jr[3], G, spec)
    tb = tt.bucket_tiles_from_runs(tr[0], tr[1], tr[3], G, spec)
    for depth in (True, False):
        jtbl = jnp.concatenate(
            [jt.packed_dyn_table(jp, jr[4], depth),
             jt.packed_static_table(jnp.asarray(op), jnp.asarray(ch), jr[4])],
            axis=1)
        ttbl = torch.cat(
            [tt.packed_dyn_table(tp, tr[4], depth),
             tt.packed_static_table(torch.as_tensor(op), torch.as_tensor(ch),
                                    tr[4])], dim=1)
        eq(jtbl, ttbl, "table")
        Fd = 7 if depth else 6
        for b in range(len(spec)):
            jd, js = jt.pack_window_fused(jb.gather_idx[b], jtbl, S, Fd)
            td, ts = tt.pack_window_fused(tb.gather_idx[b], ttbl, S, Fd)
            assert td.is_contiguous() and ts.is_contiguous()
            eq(jd, td, f"dyn[{b}]")
            eq(js, ts, f"st[{b}]")


def test_bench_bucket_spec():
    spec = tt.default_bucket_spec(3600, 1024)
    assert spec == ((450, 1024), (450, 512), (900, 256), (1800, 128))
    assert spec == jt.default_bucket_spec(3600, 1024)
    assert [tt.pad_tiles(n) for n, _ in spec] == [456, 456, 904, 1800]
    assert tt.default_bucket_spec(64, 256) == ((8, 256), (56, 128))


def test_pad_rows_are_sentinels():
    _, _, _, _, tr, img_wh, cap = both("random_128")
    G = 400
    spec = ((10, 256), (54, 128))  # 10 and 54 rows pad to 16 and 56
    tb = tt.bucket_tiles_from_runs(tr[0], tr[1], tr[3], G, spec)
    assert [ids.shape[0] for ids in tb.tile_ids] == [16, 56]
    assert int(tb.tile_ids[0][10:].abs().sum()) == 0
    assert int(tb.counts[0][10:].abs().sum()) == 0
    assert bool((tb.gather_idx[0][10:] == G).all())
