"""Depth sorting + exposure-shared tile binning + count-sorted buckets.

PyTorch port of the window path of deblur4dgs_tpu/ops/tiling.py. Every
integer output (sort order, sorted runs, bucket tile ids, counts, gather
indices) equals the reference's exactly:
  * both depth-order sorts are stable (``torch.argsort(stable=True)``;
    ``jnp.argsort`` is stable by default), so ties in the depth key and in
    the per-tile occupancy (which decides bucket membership) break by index;
  * the (tile, rank) pair sort uses one int64 key (tile << rank_bits | rank),
    which orders pairs exactly like the reference's fused int32 key or its
    two-key fallback.

Layout (the window compositor's input): per bucket, dyn (Tb, S, Fd, cap)
rows [mx, my, conic_a, conic_b, conic_c, radius (, depth)] and static
(Tb, 1+Dc, cap) rows [opacity, channels]. Slots past a tile's count hold
the zero sentinel row (index G of the packed tables).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from deblur4dgs_tpu_torch.ops.projection import Projected

TILE = 16  # pixels per tile side; P = TILE*TILE = 256 pixels per tile
# Tile rows of every bucket are padded to a multiple of this (the reference
# kernels' block size; kept so bucket shapes match row for row).
TILE_BLOCK = 8


def pad_tiles(n: int) -> int:
    return -(-n // TILE_BLOCK) * TILE_BLOCK


def num_tiles(img_wh: tuple[int, int]) -> tuple[int, int]:
    W, H = img_wh
    return (-(-W // TILE), -(-H // TILE))


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


def _pairs_to_runs(tx0, tx1, ty0, ty1, cx, cy, valid, G, T, tiles_x,
                   tiles_y, MT, cap):
    """Pair-expansion binning up to sorted runs.

    Each depth-sorted Gaussian emits up to MT (tile, rank) pairs over its
    bounding square's tile span (clipped around its centre tile). Returns
    (rank_sorted (E,), tile_sorted (E,), starts (T+1,), counts (T,),
    raw (T,)): tile t's depth-ordered list is
    rank_sorted[starts[t] : starts[t] + raw[t]].
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
    key_sorted, _ = torch.sort(key)
    tile_sorted = key_sorted >> rank_bits
    rank_sorted = key_sorted & ((1 << rank_bits) - 1)

    starts = torch.searchsorted(
        tile_sorted, torch.arange(T + 1, dtype=torch.int64, device=dev)
    )
    raw = (starts[1:] - starts[:-1])[:T]
    counts = torch.clamp(raw, max=cap)
    i32 = torch.int32
    return (rank_sorted.to(i32), tile_sorted.to(i32), starts.to(i32),
            counts.to(i32), raw.to(i32))


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
    S, G = projs.depths.shape
    tiles_x, tiles_y = num_tiles(img_wh)
    T = tiles_x * tiles_y
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
    valid = valid_any[order]

    def tile_of(x, n):
        return torch.clamp(torch.floor(x / TILE), 0, n - 1).to(torch.int64)

    tx0, tx1 = tile_of(x0, tiles_x), tile_of(x1, tiles_x)
    ty0, ty1 = tile_of(y0, tiles_y), tile_of(y1, tiles_y)
    cx = 0.5 * (x0 + x1)
    cy = 0.5 * (y0 + y1)
    rank_sorted, _, starts, counts, raw = _pairs_to_runs(
        tx0, tx1, ty0, ty1, cx, cy, valid, G, T, tiles_x, tiles_y,
        max_tiles_per_gauss, cap,
    )
    return rank_sorted, starts, counts, raw, order


def bucket_tiles_from_runs(
    rank_sorted: torch.Tensor,  # (E,)
    starts: torch.Tensor,  # (T+1,)
    raw_counts: torch.Tensor,  # (T,)
    G: int,
    spec,  # ((n_tiles, cap), ...) static, sizes summing to T
) -> TileBuckets:
    """Split tiles into occupancy-rank buckets, reading each bucket's
    (Tb, cap_b) lists straight from the sorted runs. Rows are padded to a
    TILE_BLOCK multiple; pad rows have tile id 0, count 0 and sentinel (G)
    gather entries."""
    dev = raw_counts.device
    E = rank_sorted.shape[0]
    order_t = torch.argsort(-raw_counts, stable=True).to(torch.int32)
    rank_sorted_l = rank_sorted.long()
    ids_l, cnt_l, gi_l, caps, sizes = [], [], [], [], []
    start = 0
    for n, c in spec:
        ids = order_t[start : start + n]
        start += n
        pad = pad_tiles(n) - n
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
    packed = torch.cat([opacities[:, None], const_channels], dim=-1)[order]
    return torch.cat([packed, packed.new_zeros((1, packed.shape[-1]))], dim=0)


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
    packed = packed.transpose(0, 1).reshape(G, S * Fd)[order]
    return torch.cat([packed, packed.new_zeros((1, S * Fd))], dim=0)


def pack_window_fused(
    gather_idx: torch.Tensor,  # (Tb, cap_b) one bucket's tile lists
    table: torch.Tensor,  # (G+1, S*Fd + 1 + Dc) combined dyn+static table
    S: int,
    Fd: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ONE row gather per bucket -> (dyn (Tb, S, Fd, cap), st (Tb, Fs, cap)),
    both contiguous (the compositor kernels take dense layouts).

    The gather is F.embedding with the sentinel row G as padding_idx: the
    same values as ``table[gather_idx]``, but the backward skips the
    sentinel (a constant zero row) and reduces duplicate indices by
    segments. Most slots are sentinels; advanced indexing's backward
    serializes them (331.917 ms of a 475.536 ms bench step on an H100 —
    PERF.md, PR 1).
    """
    Tp, cap = gather_idx.shape
    assert Tp % TILE_BLOCK == 0, "bucket rows are padded to TILE_BLOCK"
    G = table.shape[0] - 1
    out = F.embedding(gather_idx.long(), table, padding_idx=G)
    dyn = out[..., : S * Fd].reshape(Tp, cap, S, Fd).permute(0, 2, 3, 1)
    st = out[..., S * Fd :].transpose(-1, -2)
    return dyn.contiguous(), st.contiguous()
