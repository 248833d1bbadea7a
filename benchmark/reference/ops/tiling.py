"""Depth sorting + tile binning + count-sorted buckets + payload packing.

PyTorch port of deblur4dgs_tpu/ops/tiling.py. Every integer output (sort order, sorted runs, dense tile lists, bucket tile
ids, counts, gather indices) equals the reference's exactly:
  * both depth-order sorts are stable (``torch.argsort(stable=True)``;
    ``jnp.argsort`` is stable by default), so ties in the depth key and in
    the per-tile occupancy (which decides bucket membership) break by index;
  * the (tile, rank) pair sort uses one int64 key (tile << rank_bits | rank),
    which orders pairs exactly like the reference's fused int32 key or its
    two-key fallback.

Layouts. Dense (the reference compositor K5's input, ``pack_with_binning``):
per tile row (7+D, cap) rows [mx, my, conic_a, conic_b, conic_c, opacity,
radius, channels]. Indexed (the port's K5, ``bin_indexed`` + ``dense_table``):
the same rows once per Gaussian in a (G+1, Fp) table, read through (T, cap)
tile lists of table rows. Split (the window compositor and K4): dyn rows
[mx, my, conic_a, conic_b, conic_c, radius (, depth)] per sub-frame and
static rows [opacity, channels] shared by the window. Slots past a tile's
count hold the zero sentinel row (index G of the packed tables). Every row
gather is ``F.embedding`` with padding_idx=G (see ``pack_window_fused``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from reference.ops.projection import Projected

TILE = 16  # pixels per tile side; P = TILE*TILE = 256 pixels per tile
# Tile rows of every bucket are padded to a multiple of this (the reference
# kernels' block size; kept so bucket shapes match row for row).
TILE_BLOCK = 8


def pad_tiles(n: int, multiple: int = TILE_BLOCK) -> int:
    return -(-n // multiple) * multiple


# Dense payload rows (the F axis of TileBinning.tile_data). The radius rides
# along so the compositor's per-pixel box cutoff makes tile membership exact
# (the zero sentinel row has radius 0 and contributes nothing).
(
    F_MEAN_X,
    F_MEAN_Y,
    F_CONIC_A,
    F_CONIC_B,
    F_CONIC_C,
    F_OPACITY,
    F_RADIUS,
) = range(7)
F_CHANNELS = 7


class TileBinning(NamedTuple):
    tile_data: torch.Tensor  # (Tp, F, CAP) packed per-tile Gaussian params
    counts: torch.Tensor  # (Tp,) int32 Gaussians binned (<= CAP)
    gather_idx: torch.Tensor  # (Tp, CAP) int32 into the depth-sorted arrays
    order: torch.Tensor  # (G,) sort order (sorted -> original index)
    raw_counts: torch.Tensor  # (Tp,) int32 pre-cap intersection counts
    tiles_xy: tuple[int, int]  # (tiles_x, tiles_y)


def num_tiles(img_wh: tuple[int, int]) -> tuple[int, int]:
    W, H = img_wh
    return (-(-W // TILE), -(-H // TILE))


def bin_gaussians(
    proj: Projected,  # one view: (G, ...) arrays
    img_wh: tuple[int, int],
    cap: int = 512,
    tile_batch: int = 256,
):
    """The top-k binning of one view: per tile, the first ``cap``
    Gaussians in depth order whose bounding square overlaps the tile
    rectangle, chosen by a top-k of (G - rank) over the overlap mask (ranks
    are distinct, so the selection is exact and order-preserving); tiles in
    batches of ``tile_batch`` bound the (batch, G) mask.

    Returns (gather_idx (T, cap) into depth-sorted arrays, counts (T,),
    raw_counts (T,), order (G,)); entries past a count are G (the sentinel
    row)."""
    G = proj.depths.shape[0]
    dev = proj.depths.device
    tiles_x, tiles_y = num_tiles(img_wh)
    T = tiles_x * tiles_y
    key = torch.where(proj.valid, proj.depths,
                      torch.full_like(proj.depths, float("inf")))
    order = torch.argsort(key, stable=True)
    mx, my = proj.means2d[order, 0], proj.means2d[order, 1]
    r = proj.radii[order]
    valid = proj.valid[order]
    tids = torch.arange(T, device=dev)
    tx0 = (tids % tiles_x).float() * TILE
    ty0 = (tids // tiles_x).float() * TILE
    score_of_rank = G - torch.arange(G, device=dev)
    idx_l, cnt_l, raw_l = [], [], []
    for b in range(0, T, tile_batch):
        x0 = tx0[b : b + tile_batch, None]
        y0 = ty0[b : b + tile_batch, None]
        inter = ((mx + r > x0) & (mx - r < x0 + TILE) & (my + r > y0)
                 & (my - r < y0 + TILE) & valid)
        raw = inter.sum(1, dtype=torch.int32)
        score = torch.where(inter, score_of_rank, 0)
        if G < cap:  # topk needs k <= the axis size
            score = F.pad(score, (0, cap - G))
        top = torch.topk(score, cap, dim=1).values  # descending: rank order
        idx_l.append(torch.where(top > 0, G - top, G).to(torch.int32))
        cnt_l.append(torch.clamp(raw, max=cap))
        raw_l.append(raw)
    return torch.cat(idx_l), torch.cat(cnt_l), torch.cat(raw_l), order


def _tile_of(x, n):
    return torch.clamp(torch.floor(x / TILE), 0, n - 1).to(torch.int64)


class TileBuckets(NamedTuple):
    """Count-sorted tile buckets: the top occupancy ranks at full capacity,
    the tail at reduced capacity (same front-most-kept truncation)."""

    tile_ids: tuple  # per bucket: (Tb_pad,) int32 image-tile ids
    counts: tuple  # per bucket: (Tb_pad,) int32 capped counts
    gather_idx: tuple  # per bucket: (Tb_pad, cap_b) into sorted arrays
    caps: tuple  # per bucket: int capacity
    sizes: tuple  # per bucket: int unpadded tile count (sum == T)


# Rank fractions and capacity fractions for default_bucket_spec: the top
# 1/8 of tiles by occupancy get the full configured capacity, the next 1/8
# half, the next 1/4 a quarter, and the tail 1/8 (clamped to one CHUNK).
BUCKET_FRACS = ((0.125, 1.0), (0.125, 0.5), (0.25, 0.25), (0.5, 0.125))
MIN_CAP = 128  # == rasterize.CHUNK; capacities must be CHUNK multiples


def default_bucket_spec(T: int, cap: int):
    """Static (n_tiles, cap) bucket spec for T tiles at base capacity cap.

    Sizes sum to exactly T; capacities are CHUNK multiples in [MIN_CAP, cap]
    and non-increasing; equal-capacity neighbours merge.
    """
    spec = []
    left = T
    for i, (ft, fc) in enumerate(BUCKET_FRACS):
        if i == len(BUCKET_FRACS) - 1:
            n = left
        else:
            n = min(left, max(1, round(T * ft)))
        c = min(cap, max(MIN_CAP, int(round(cap * fc / MIN_CAP)) * MIN_CAP))
        if n > 0:
            if spec and spec[-1][1] == c:
                spec[-1] = (spec[-1][0] + n, c)
            else:
                spec.append((n, c))
        left -= n
    return tuple(spec)


def bucket_tiles(
    gather_idx: torch.Tensor,  # (T, CAP) dense tile lists
    counts: torch.Tensor,  # (T,)
    raw_counts: torch.Tensor,  # (T,) pre-cap occupancy (the sort key)
    G: int,
    spec,  # ((n_tiles, cap), ...) static, sizes summing to T
) -> TileBuckets:
    """Split tiles into occupancy-rank buckets from dense tile lists: each
    bucket's lists are the front-most cap_b entries of the full lists, rows
    padded to a TILE_BLOCK multiple (tile id 0, count 0, sentinel G)."""
    dev = raw_counts.device
    order_t = torch.argsort(-raw_counts, stable=True).to(torch.int32)
    ids_l, cnt_l, gi_l, caps, sizes = [], [], [], [], []
    start = 0
    for n, c in spec:
        ids = order_t[start : start + n]
        start += n
        pad = pad_tiles(n) - n
        idl = ids.long()
        gi = gather_idx[idl, :c]
        cnt = torch.clamp(counts[idl], max=c)
        if pad:
            ids = torch.cat([ids, ids.new_zeros((pad,))])
            cnt = torch.cat([cnt, cnt.new_zeros((pad,))])
            gi = torch.cat([gi, gi.new_full((pad, c), G)])
        ids_l.append(ids)
        cnt_l.append(cnt)
        gi_l.append(gi)
        caps.append(c)
        sizes.append(n)
    return TileBuckets(
        tuple(ids_l), tuple(cnt_l), tuple(gi_l), tuple(caps), tuple(sizes)
    )


def _pairs_to_runs(tx0, tx1, ty0, ty1, cx, cy, valid, G, T, tiles_x,
                   tiles_y, MT, cap):
    """Pair-expansion binning up to sorted runs.

    Each depth-sorted Gaussian emits up to MT (tile, rank) pairs over its
    bounding square's tile span (clipped around its centre tile). Returns
    (rank_sorted (E,), tile_sorted (E,), starts (T+1,), counts (T,),
    raw (T,), perm (E,)): tile t's depth-ordered list is
    rank_sorted[starts[t] : starts[t] + raw[t]], and sorted pair e is pair
    perm[e] = rank * MT + j of the (G, MT) expansion.
    """
    dev = tx0.device
    w_span = tx1 - tx0 + 1
    h_span = ty1 - ty0 + 1
    w_eff = torch.clamp(w_span, max=MT)
    h_eff = torch.minimum(
        h_span, torch.clamp(MT // torch.clamp(w_eff, min=1), min=1)
    )
    txc = torch.clamp((cx / TILE).to(torch.int64), 0, tiles_x - 1)
    tyc = torch.clamp((cy / TILE).to(torch.int64), 0, tiles_y - 1)
    tx0e = torch.minimum(torch.maximum(txc - w_eff // 2, tx0), tx1 - w_eff + 1)
    ty0e = torch.minimum(torch.maximum(tyc - h_eff // 2, ty0), ty1 - h_eff + 1)

    j = torch.arange(MT, dtype=torch.int64, device=dev)[None, :]
    # w_eff < 1 only for invalid Gaussians (their pairs are dropped below);
    # the clamp keeps the integer division defined there.
    w_div = torch.clamp(w_eff, min=1)[:, None]
    row = j // w_div
    col = j % w_div
    in_span = (j < (w_eff * h_eff)[:, None]) & valid[:, None]
    tile_id = torch.where(
        in_span, (ty0e[:, None] + row) * tiles_x + (tx0e[:, None] + col),
        torch.full_like(row, T),
    )

    rank = torch.arange(G, dtype=torch.int64, device=dev)[:, None].expand(G, MT)
    rank_bits = int(G).bit_length()
    key = (tile_id.reshape(-1) << rank_bits) | rank.reshape(-1)
    key_sorted, perm = torch.sort(key)
    tile_sorted = key_sorted >> rank_bits
    rank_sorted = key_sorted & ((1 << rank_bits) - 1)

    starts = torch.searchsorted(
        tile_sorted, torch.arange(T + 1, dtype=torch.int64, device=dev)
    )
    raw = (starts[1:] - starts[:-1])[:T]
    counts = torch.clamp(raw, max=cap)
    i32 = torch.int32
    return (rank_sorted.to(i32), tile_sorted.to(i32), starts.to(i32),
            counts.to(i32), raw.to(i32), perm)


def _pairs_to_lists(tx0, tx1, ty0, ty1, cx, cy, valid, G, T, tiles_x,
                    tiles_y, MT, cap):
    """Pair-expansion binning up to the dense (T, cap) tile lists.

    Scatters each sorted pair to (its tile, its position in the tile's
    run). Pairs past a tile's capacity and pairs of no tile all land on
    the discarded row T (duplicates there are harmless: it is dropped).
    Returns (gather_idx (T, cap) int32, counts (T,), raw (T,),
    slot_of_pair (G, MT) int32): the inverse map, tile * cap + pos for the
    pair (rank, j) that landed at gather_idx[tile, pos], -1 for a pair
    that was dropped (no tile, an invalid Gaussian, or pos >= cap).
    """
    rank_sorted, tile_sorted, _, counts, raw, perm = _pairs_to_runs(
        tx0, tx1, ty0, ty1, cx, cy, valid, G, T, tiles_x, tiles_y, MT, cap
    )
    E = tile_sorted.shape[0]
    dev = tile_sorted.device
    idx = torch.arange(E, dtype=torch.int64, device=dev)
    is_start = torch.ones((E,), dtype=torch.bool, device=dev)
    is_start[1:] = tile_sorted[1:] != tile_sorted[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    pos = idx - run_start
    ok = (tile_sorted < T) & (pos < cap)
    slot = torch.where(ok, tile_sorted.long() * cap + pos, T * cap)
    gather_idx = torch.full(((T + 1) * cap,), G, dtype=torch.int32,
                            device=dev)
    gather_idx[slot] = rank_sorted
    slot_of_pair = torch.empty((G * MT,), dtype=torch.int32, device=dev)
    slot_of_pair[perm] = torch.where(ok, slot, -1).to(torch.int32)
    return (gather_idx.view(T + 1, cap)[:T], counts, raw,
            slot_of_pair.view(G, MT))


def bin_gaussians_pairs(
    proj: Projected,  # one view: (G, ...) arrays
    img_wh: tuple[int, int],
    cap: int = 512,
    max_tiles_per_gauss: int = 32,
):
    """Pair-expansion binning of one view: each depth-sorted Gaussian emits
    up to MT (tile, rank) pairs over its bounding square's tile span; one
    sort groups them by tile in depth order.

    Returns (gather_idx (T, cap) into depth-sorted arrays, counts (T,),
    raw_counts (T,), order (G,), slot_of_pair (G, MT) by depth rank; see
    _pairs_to_lists)."""
    G = proj.depths.shape[0]
    tiles_x, tiles_y = num_tiles(img_wh)
    key = torch.where(proj.valid, proj.depths,
                      torch.full_like(proj.depths, float("inf")))
    order = torch.argsort(key, stable=True)
    mx, my = proj.means2d[order, 0], proj.means2d[order, 1]
    r = proj.radii[order]
    tx0, tx1 = _tile_of(mx - r, tiles_x), _tile_of(mx + r, tiles_x)
    ty0, ty1 = _tile_of(my - r, tiles_y), _tile_of(my + r, tiles_y)
    gather_idx, counts, raw, slot_of_pair = _pairs_to_lists(
        tx0, tx1, ty0, ty1, mx, my, proj.valid[order], G, tiles_x * tiles_y,
        tiles_x, tiles_y, max_tiles_per_gauss, cap,
    )
    return gather_idx, counts, raw, order, slot_of_pair


def _union_spans(projs: Projected, img_wh):
    """Per-Gaussian union of the S sub-frame bounding boxes, depth-sorted
    by the front-most depth across the window: the arguments of
    _pairs_to_runs / _pairs_to_lists, and the order."""
    S, G = projs.depths.shape
    tiles_x, tiles_y = num_tiles(img_wh)
    inf = torch.tensor(float("inf"), device=projs.depths.device)

    v = projs.valid
    mx, my, r = projs.means2d[..., 0], projs.means2d[..., 1], projs.radii
    valid_any = v.any(dim=0)
    mx0 = torch.where(v, mx - r, inf).amin(0)
    mx1 = torch.where(v, mx + r, -inf).amax(0)
    my0 = torch.where(v, my - r, inf).amin(0)
    my1 = torch.where(v, my + r, -inf).amax(0)
    depth_key = torch.where(v, projs.depths, inf).amin(0)

    key = torch.where(valid_any, depth_key, inf)
    order = torch.argsort(key, stable=True)
    x0, x1, y0, y1 = mx0[order], mx1[order], my0[order], my1[order]
    args = (
        _tile_of(x0, tiles_x), _tile_of(x1, tiles_x),
        _tile_of(y0, tiles_y), _tile_of(y1, tiles_y),
        0.5 * (x0 + x1), 0.5 * (y0 + y1), valid_any[order],
        G, tiles_x * tiles_y, tiles_x, tiles_y,
    )
    return args, order


def bin_gaussians_union(
    projs: Projected,  # arrays with a leading sub-frame axis (S, G, ...)
    img_wh: tuple[int, int],
    cap: int = 512,
    max_tiles_per_gauss: int = 32,
):
    """Shared binning for an exposure window as dense (T, cap) lists (the
    small-image split path). Returns (gather_idx, counts, raw, order)."""
    args, order = _union_spans(projs, img_wh)
    return _pairs_to_lists(*args, max_tiles_per_gauss, cap)[:3] + (order,)


def bin_gaussians_union_runs(
    projs: Projected,  # arrays with a leading sub-frame axis (S, G, ...)
    img_wh: tuple[int, int],
    cap: int = 512,
    max_tiles_per_gauss: int = 32,
):
    """Shared binning for an exposure window: one sort for all S sub-frames.

    Tile lists come from the union of each Gaussian's per-sub-frame
    bounding boxes (a superset of every sub-frame's exact lists; the
    compositor's per-pixel 3-sigma box makes that exact), ordered by each
    Gaussian's front-most depth across the window.

    Returns (rank_sorted, starts, counts, raw, order), int32 except order
    (int64 permutation, sorted -> original index).
    """
    args, order = _union_spans(projs, img_wh)
    rank_sorted, _, starts, counts, raw, _ = _pairs_to_runs(
        *args, max_tiles_per_gauss, cap
    )
    return rank_sorted, starts, counts, raw, order


def bucket_tiles_from_runs(
    rank_sorted: torch.Tensor,  # (E,)
    starts: torch.Tensor,  # (T+1,)
    raw_counts: torch.Tensor,  # (T,)
    G: int,
    spec,  # ((n_tiles, cap), ...) static, sizes summing to T
    pad_multiple: int = TILE_BLOCK,  # n_ranks * TILE_BLOCK when tile-sharded
) -> TileBuckets:
    """Split tiles into occupancy-rank buckets, reading each bucket's
    (Tb, cap_b) lists straight from the sorted runs. Rows are padded to a
    multiple of ``pad_multiple``; pad rows have tile id 0, count 0 and
    sentinel (G) gather entries."""
    dev = raw_counts.device
    E = rank_sorted.shape[0]
    order_t = torch.argsort(-raw_counts, stable=True).to(torch.int32)
    rank_sorted_l = rank_sorted.long()
    ids_l, cnt_l, gi_l, caps, sizes = [], [], [], [], []
    start = 0
    for n, c in spec:
        ids = order_t[start : start + n]
        start += n
        pad = pad_tiles(n, pad_multiple) - n
        idl = ids.long()
        lane = torch.arange(c, dtype=torch.int64, device=dev)[None, :]
        src = torch.clamp(starts[idl].long()[:, None] + lane, max=E - 1)
        gi = torch.where(
            lane < raw_counts[idl].long()[:, None], rank_sorted_l[src],
            torch.full_like(src, G),
        ).to(torch.int32)
        cnt = torch.clamp(raw_counts[idl], max=c)
        if pad:
            ids = torch.cat([ids, torch.zeros((pad,), dtype=torch.int32,
                                              device=dev)])
            cnt = torch.cat([cnt, torch.zeros((pad,), dtype=torch.int32,
                                              device=dev)])
            gi = torch.cat([gi, torch.full((pad, c), G, dtype=torch.int32,
                                           device=dev)])
        ids_l.append(ids)
        cnt_l.append(cnt)
        gi_l.append(gi)
        caps.append(c)
        sizes.append(n)
    return TileBuckets(
        tuple(ids_l), tuple(cnt_l), tuple(gi_l), tuple(caps), tuple(sizes)
    )


def packed_static_table(
    opacities: torch.Tensor,  # (G,)
    const_channels: torch.Tensor,  # (G, Dc)
    order: torch.Tensor,
) -> torch.Tensor:
    """(G+1, 1+Dc) depth-sorted static rows + zero sentinel row."""
    return _with_sentinel(
        torch.cat([opacities[:, None], const_channels], dim=-1)[order])


def packed_dyn_table(
    projs: Projected,  # arrays with leading sub-frame axis (S, G, ...)
    order: torch.Tensor,
    include_depth: bool,
) -> torch.Tensor:
    """(G+1, S*Fd) depth-sorted per-sub-frame screen rows + sentinel row."""
    S, G = projs.depths.shape
    rows = [projs.means2d, projs.conics, projs.radii[..., None]]
    if include_depth:
        rows.append(projs.depths[..., None])
    packed = torch.cat(rows, dim=-1)  # (S, G, Fd)
    Fd = packed.shape[-1]
    return _with_sentinel(packed.transpose(0, 1).reshape(G, S * Fd)[order])


def _gather_rows(gather_idx: torch.Tensor, table: torch.Tensor):
    """table[gather_idx] for a table whose last row G is the zero sentinel.

    F.embedding with padding_idx=G: the same values, but the backward
    skips the sentinel (a constant zero row) and reduces duplicate indices
    by segments. Most slots are sentinels; advanced indexing's backward
    serializes them (331.917 ms of a 475.536 ms bench step on an H100 80GB
    HBM3 at 700 W, chip_smoke.py; PERF.md)."""
    return F.embedding(gather_idx.long(), table,
                       padding_idx=table.shape[0] - 1)


def _with_sentinel(packed: torch.Tensor) -> torch.Tensor:
    return torch.cat([packed, packed.new_zeros((1, packed.shape[-1]))], 0)


def _pad_rows(x, fill):
    """Pad dim 0 to a TILE_BLOCK multiple with ``fill``."""
    pad = pad_tiles(x.shape[0]) - x.shape[0]
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def _pad_lists(gather_idx, counts, raw, G):
    """Pad tile rows to a TILE_BLOCK multiple (sentinel entries)."""
    return _pad_rows(gather_idx, G), _pad_rows(counts, 0), _pad_rows(raw, 0)


def pack_with_binning(
    proj: Projected,
    opacities: torch.Tensor,  # (G,)
    channels: torch.Tensor,  # (G, D)
    gather_idx: torch.Tensor,  # (T or Tp, CAP) into `order`-sorted arrays
    counts: torch.Tensor,
    raw_counts: torch.Tensor,
    order: torch.Tensor,
    tiles_xy: tuple[int, int],
) -> TileBinning:
    """Gather one view's dense payload (Tp, 7+D, CAP) through tile lists."""
    G = proj.depths.shape[0]
    gather_idx, counts, raw_counts = _pad_lists(
        gather_idx, counts, raw_counts, G
    )
    packed = torch.cat(
        [proj.means2d, proj.conics, opacities[:, None], proj.radii[:, None],
         channels], dim=-1,
    )[order]
    tile_data = _gather_rows(gather_idx, _with_sentinel(packed))
    return TileBinning(tile_data.transpose(-1, -2).contiguous(), counts,
                       gather_idx, order, raw_counts, tiles_xy)


class IndexedBinning(NamedTuple):
    """One view's tile lists as rows of its per-Gaussian table (dense_table),
    the input of the indexed dense compositor (ops/rasterize.py::
    composite_indexed)."""

    idx: torch.Tensor  # (Tp, CAP) int32 table rows (Gaussian index; G pads)
    counts: torch.Tensor  # (Tp,) int32 Gaussians binned (<= CAP)
    # (G, MT) int32 per Gaussian (its own order): the slot t * CAP + pos of
    # each of its pairs, Tp * CAP (the per-slot gradient's sink row) where
    # the pair was dropped
    slot_map: torch.Tensor
    gather_idx: torch.Tensor  # (Tp, CAP) int32 into the depth-sorted arrays
    order: torch.Tensor  # (G,) sort order (sorted -> original index)
    raw_counts: torch.Tensor  # (Tp,) int32 pre-cap intersection counts
    tiles_xy: tuple[int, int]


def bin_indexed(
    proj: Projected,
    img_wh: tuple[int, int],
    cap: int = 512,
    max_tiles_per_gauss: int = 32,
) -> IndexedBinning:
    """bin_gaussians_pairs with its lists as table rows: idx = order[
    gather_idx] (the sentinel G stays G), rows padded to TILE_BLOCK, and the
    inverse slot map by Gaussian. No payload is gathered."""
    G = proj.depths.shape[0]
    gather_idx, counts, raw, order, slot_of_pair = bin_gaussians_pairs(
        proj, img_wh, cap, max_tiles_per_gauss
    )
    gather_idx, counts, raw = _pad_lists(gather_idx, counts, raw, G)
    rows = torch.cat([order, order.new_full((1,), G)])
    idx = rows[gather_idx.long()].to(torch.int32)
    sink = gather_idx.numel()
    slot_map = torch.empty_like(slot_of_pair)
    slot_map[order] = torch.where(slot_of_pair >= 0, slot_of_pair, sink)
    return IndexedBinning(idx, counts, slot_map, gather_idx, order, raw,
                          num_tiles(img_wh))


def dense_row_floats(nchan: int) -> int:
    """Columns of a dense_table row: 7 + nchan rounded up to a multiple of
    4, so that a row loads as float4s."""
    return -(-(F_CHANNELS + nchan) // 4) * 4


def dense_table(
    proj: Projected,
    opacities: torch.Tensor,  # (G,)
    channels: torch.Tensor,  # (G, D)
) -> torch.Tensor:
    """(G+1, Fp) per-Gaussian rows [mx, my, conic_a, conic_b, conic_c,
    opacity, radius, channels, 0 ...] in the Gaussians' own order (no
    depth sort), Fp = dense_row_floats(D), and the zero sentinel row G."""
    D = channels.shape[1]
    rows = torch.cat([proj.means2d, proj.conics, opacities[:, None],
                      proj.radii[:, None], channels], dim=-1)
    return F.pad(rows, (0, dense_row_floats(D) - F_CHANNELS - D, 0, 1))


def pack_and_gather(
    proj: Projected,
    opacities: torch.Tensor,  # (G,)
    channels: torch.Tensor,  # (G, D)
    img_wh: tuple[int, int],
    cap: int = 512,
) -> TileBinning:
    """Full binning of one view (default MT = 32, as the reference calls
    bin_gaussians_pairs) and the dense payload gather."""
    gather_idx, counts, raw_counts, order, _ = bin_gaussians_pairs(
        proj, img_wh, cap
    )
    return pack_with_binning(
        proj, opacities, channels, gather_idx, counts, raw_counts, order,
        num_tiles(img_wh),
    )


def pack_static(
    opacities: torch.Tensor,  # (G,)
    const_channels: torch.Tensor,  # (G, Dc) sub-frame-independent payload
    gather_idx: torch.Tensor,
    order: torch.Tensor,
) -> torch.Tensor:
    """(Tp, 1 + Dc, CAP) static rows, gathered once per exposure window."""
    G = opacities.shape[0]
    out = _gather_rows(_pad_rows(gather_idx, G),
                       packed_static_table(opacities, const_channels, order))
    return out.transpose(-1, -2).contiguous()


def pack_dyn_all(
    projs: Projected,  # arrays with leading sub-frame axis (S, G, ...)
    gather_idx: torch.Tensor,
    order: torch.Tensor,
    include_depth: bool,
) -> torch.Tensor:
    """(S, Tp, 6(+1), CAP): every sub-frame's screen rows in ONE gather
    (the exposure-shared lists are the same for all S); each [s] slice is
    contiguous, as the split compositor takes it."""
    S, G = projs.depths.shape
    gather_idx = _pad_rows(gather_idx, G)
    Tp, cap = gather_idx.shape
    packed = packed_dyn_table(projs, order, include_depth)
    out = _gather_rows(gather_idx, packed)  # (Tp, CAP, S*Fd)
    out = out.reshape(Tp, cap, S, -1).permute(2, 0, 3, 1)
    return out.contiguous()


def pack_dyn(
    proj: Projected,  # one view
    gather_idx: torch.Tensor,
    order: torch.Tensor,
    include_depth: bool,
) -> torch.Tensor:
    """(Tp, 6(+1), CAP): one sub-frame's screen rows."""
    G = proj.depths.shape[0]
    rows = [proj.means2d, proj.conics, proj.radii[:, None]]
    if include_depth:
        rows.append(proj.depths[:, None])
    packed = _with_sentinel(torch.cat(rows, dim=-1)[order])
    out = _gather_rows(_pad_rows(gather_idx, G), packed)
    return out.transpose(-1, -2).contiguous()


def pack_dyn_fused(
    projs: Projected,  # arrays with leading sub-frame axis (S, G, ...)
    gather_idx: torch.Tensor,
    order: torch.Tensor,
    include_depth: bool,
) -> torch.Tensor:
    """(Tp, S, 6(+1), CAP): pack_dyn_all in the window compositor's layout
    (the sub-frame axis inside the tile axis), one gather."""
    S, G = projs.depths.shape
    gather_idx = _pad_rows(gather_idx, G)
    Tp, cap = gather_idx.shape
    out = _gather_rows(gather_idx, packed_dyn_table(projs, order,
                                                    include_depth))
    return out.reshape(Tp, cap, S, -1).permute(0, 2, 3, 1).contiguous()


def pack_window_fused(
    gather_idx: torch.Tensor,  # (Tb, cap_b) one bucket's tile lists
    table: torch.Tensor,  # (G+1, S*Fd + 1 + Dc) combined dyn+static table
    S: int,
    Fd: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ONE row gather per bucket -> (dyn (Tb, S, Fd, cap), st (Tb, Fs, cap)),
    both contiguous (the compositor kernels take dense layouts)."""
    Tp, cap = gather_idx.shape
    assert Tp % TILE_BLOCK == 0, "bucket rows are padded to TILE_BLOCK"
    out = _gather_rows(gather_idx, table)
    dyn = out[..., : S * Fd].reshape(Tp, cap, S, Fd).permute(0, 2, 3, 1)
    st = out[..., S * Fd :].transpose(-1, -2)
    return dyn.contiguous(), st.contiguous()
