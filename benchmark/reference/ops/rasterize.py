"""Tile compositors: the plain PyTorch twins of the port's kernels.

PyTorch port of deblur4dgs_tpu/ops/rasterize.py. One tile row is image
tile ``tile_ids[t]`` (16x16 = P pixels, centres at +0.5) with ``counts[t]``
depth-ordered Gaussians, composited front to back:

    alpha = min(op * exp(-sigma), 0.999)   where the pixel is inside the
            3-sigma box, sigma >= 0 and op * exp(-sigma) >= 1/255, else 0
    sigma = 0.5 * (a dx^2 + c dy^2) + b dx dy
    accum += alpha * T * channels;  T *= (1 - alpha)

The backward recomputes alpha and T in forward order and takes suffix
sums as Total - prefix from the forward outputs (accum, tfin): no
per-Gaussian residuals are stored and nothing is divided by a small T.

Four compositors share that math and one stop rule:
  * window (K1, K2/K3): dyn (T, S, Fd, cap) + static (T, 1+Dc, cap) for
    all S exposure sub-frames of a bucket row, channel-major outputs;
  * split (K4): one sub-frame of the same layout, (T, Fd, cap); it runs
    the window kernels at S = 1 (K4 is K1/K2 with one sub-frame);
  * dense (K5): per image-tile row t, the table rows idx[t, :counts[t]]
    of one per-Gaussian table (G+1, Fp) with rows [mx, my, a, b, c, op, r,
    channels] (the reference gathers them into a (T, 7+D, cap) payload
    first); pixel-major outputs. Its backward writes a gradient per slot
    and sums each Gaussian's slots through the binning's inverse slot map
    (dense_table_grad).

Early-stop rule (shared by the CUDA kernels and the plain twins): the
Gaussians are walked in chunks of CHUNK = 128; before each chunk, the
(tile row, sub-frame) pair stops if every one of its P pixels has
T < EARLY_STOP_T. Forward and backward therefore stop at the same chunk.
This is K2's, K4's and K5's rule; the reference's fused forward K1 and
S-split backward K3 stop the whole window at once, which differs only by
contributions of a sub-frame after its own T fell below 1e-4 (less than
1e-4 of a channel unit per pixel).

Here every compositor runs its plain twin, on any device. The dense and
split twins are the window twin on views of their inputs (the same
per-pair math).

The reference's plain compositors without the early stop (its XLA path,
use_pallas=False: ``_composite_xla``, ``_composite_split_xla``,
``_composite_window_xla``) are ``composite_{dense,split,window}_nostop``:
plain torch on any device, every slot of every row composited, autograd
through the transmittance's log-space cumsum, tiles in chunks (each
recomputed in the backward) so that a 720p window never holds its whole
(T, S, P, cap) alpha.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from reference.ops.tiling import (
    F_CHANNELS,
    F_OPACITY,
    F_RADIUS,
    TILE,
    _pad_rows,
    bin_indexed,
    dense_row_floats,
    dense_table,
    num_tiles,
    pack_and_gather,
)

ALPHA_CLAMP = 0.999
ALPHA_CUTOFF = 1.0 / 255.0
# Chunk-level early termination threshold (gsplat's per-pixel forward
# early stop uses 1e-4; dropped contributions are < 1e-4 of a color unit).
EARLY_STOP_T = 1e-4
CHUNK = 128  # Gaussians per chunk (the stop rule's granularity)
P = TILE * TILE  # pixels per tile
MAX_DENSE_CHANNELS = 16  # the dense kernels' register accumulators


# ---------------------------------------------------------------------------
# Plain PyTorch twins (CPU path; the on-card reference for the kernels)
# ---------------------------------------------------------------------------


def _pixel_centres(tile_ids, tiles_x):
    """(T,) tile ids -> px, py (T, 1, P, 1) pixel centres."""
    t = tile_ids.long()
    pid = torch.arange(P, device=tile_ids.device)
    tx = (t % tiles_x).float()[:, None] * TILE
    ty = (t // tiles_x).float()[:, None] * TILE
    px = tx + (pid % TILE).float()[None, :] + 0.5
    py = ty + (pid // TILE).float()[None, :] + 0.5
    return px[:, None, :, None], py[:, None, :, None]


def _alpha_chunk(d, op, px, py, in_count):
    """d (T, S, Fd, C) dyn rows, op (T, 1, 1, C), px/py (T, 1, P, 1),
    in_count (T, S, 1, C) bool (slot < count and the row is running).

    Returns alpha, dx, dy, active, each (T, S, P, C)."""
    mx, my, ca, cb, cc, r = (d[:, :, i, None, :] for i in range(6))
    dx = px - mx
    dy = py - my
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    alpha_raw = op * torch.exp(-torch.clamp(sigma, min=0.0))
    inbox = (torch.abs(dx) <= r) & (torch.abs(dy) <= r)
    live = inbox & (sigma >= 0.0) & (alpha_raw >= ALPHA_CUTOFF) & in_count
    active = live & (alpha_raw < ALPHA_CLAMP)
    alpha = torch.where(live, torch.clamp(alpha_raw, max=ALPHA_CLAMP),
                        torch.zeros_like(alpha_raw))
    return alpha, dx, dy, active


def _chunk_channels(d, s_chunk, n_static, depth_in_dyn):
    """(T, S, nchan, C): shared static channels (+ per-sub-frame depth)."""
    S = d.shape[1]
    ch = s_chunk[:, None, 1 : 1 + n_static, :].expand(-1, S, -1, -1)
    if depth_in_dyn:
        ch = torch.cat([ch, d[:, :, 6:7, :]], dim=2)
    return ch


def _exclusive_transmittance(Tc, one_minus):
    """T before each Gaussian of the chunk: Tc * prod_{j<g} (1 - alpha_j)."""
    ex = torch.cumprod(one_minus, dim=-1)
    ex = torch.cat([torch.ones_like(ex[..., :1]), ex[..., :-1]], dim=-1)
    return Tc[..., None] * ex


def _running(ci, nchunks, Tc):
    """(T, S) bool: rows/sub-frames that composite chunk ci (stop rule)."""
    return (ci < nchunks)[:, None] & (Tc.amax(dim=-1) >= EARLY_STOP_T)


def composite_window_plain(dyn, st, counts, tile_ids, tiles_x, nchan,
                           depth_in_dyn, return_work=False):
    """Plain twin of the window forward kernel.

    dyn (T, S, Fd, cap), st (T, 1+Dc, cap), counts/tile_ids (T,) int32 ->
    accum (T, S, nchan, P), tfin (T, S, P). Vectorized over rows and
    sub-frames, a Python loop over chunks, with the kernel's stop rule.

    ``return_work`` adds a dict of what the kernels' loops do on this data
    (for bounds): ``pairs`` (pixel, Gaussian) evaluations up to each
    (row, s)'s stop chunk and count, ``live`` pairs that composite, and
    ``slots`` (T, S), the payload slots each (row, s) walks.
    """
    pairs = live = 0
    T, S, Fd, cap = dyn.shape
    slots = torch.zeros((T, S), dtype=torch.int64, device=dyn.device)
    n_static = nchan - (1 if depth_in_dyn else 0)
    px, py = _pixel_centres(tile_ids, tiles_x)
    counts = counts.long()
    nchunks = (counts + CHUNK - 1) // CHUNK
    Tc = dyn.new_ones((T, S, P))
    accum = dyn.new_zeros((T, S, nchan, P))
    lane = torch.arange(CHUNK, device=dyn.device)
    for ci in range(cap // CHUNK):
        run = _running(ci, nchunks, Tc)
        if not bool(run.any()):
            break
        sl = slice(ci * CHUNK, (ci + 1) * CHUNK)
        d, s_chunk = dyn[..., sl], st[..., sl]
        in_count = ((ci * CHUNK + lane)[None, :] < counts[:, None])
        in_count = (in_count[:, None, :] & run[..., None])[:, :, None, :]
        alpha, _, _, _ = _alpha_chunk(d, s_chunk[:, None, 0:1, :], px, py,
                                      in_count)
        one_minus = 1.0 - alpha
        Tg = _exclusive_transmittance(Tc, one_minus)
        w = alpha * Tg
        ch = _chunk_channels(d, s_chunk, n_static, depth_in_dyn)
        accum = accum + torch.einsum("tscg,tspg->tscp", ch, w)
        Tc = Tg[..., -1] * one_minus[..., -1]
        if return_work:
            slots += in_count[:, :, 0].sum(-1)
            pairs += int(in_count.sum()) * P
            live += int((alpha > 0).sum())
    if return_work:
        return accum, Tc, {"pairs": pairs, "live": live, "slots": slots}
    return accum, Tc


def composite_window_bwd_plain(dyn, st, counts, tile_ids, accum, tfin, gacc,
                               gt, tiles_x, nchan, depth_in_dyn):
    """Plain twin of the window backward kernel.

    Returns gdyn (T, S, Fd, cap) rows [g_mx, g_my, g_a, g_b, g_c, 0
    (, g_depth)] and gst (T, 1+Dc, cap) rows [g_op, g_chans] summed over S.
    """
    T, S, Fd, cap = dyn.shape
    n_static = nchan - (1 if depth_in_dyn else 0)
    px, py = _pixel_centres(tile_ids, tiles_x)
    counts = counts.long()
    nchunks = (counts + CHUNK - 1) // CHUNK
    total = torch.sum(accum * gacc, dim=2)  # (T, S, P)
    gt_term = gt * tfin
    Tc = dyn.new_ones((T, S, P))
    prefix = dyn.new_zeros((T, S, P))
    gdyn = torch.zeros_like(dyn)
    gst = torch.zeros_like(st)
    lane = torch.arange(CHUNK, device=dyn.device)
    for ci in range(cap // CHUNK):
        run = _running(ci, nchunks, Tc)
        if not bool(run.any()):
            break
        sl = slice(ci * CHUNK, (ci + 1) * CHUNK)
        d, s_chunk = dyn[..., sl], st[..., sl]
        op = s_chunk[:, None, 0:1, :]
        in_count = ((ci * CHUNK + lane)[None, :] < counts[:, None])
        in_count = (in_count[:, None, :] & run[..., None])[:, :, None, :]
        alpha, dx, dy, active = _alpha_chunk(d, op, px, py, in_count)
        one_minus = 1.0 - alpha
        Tg = _exclusive_transmittance(Tc, one_minus)
        w = alpha * Tg
        ch = _chunk_channels(d, s_chunk, n_static, depth_in_dyn)
        sdot = torch.einsum("tscp,tscg->tspg", gacc, ch)
        prefix_incl = prefix[..., None] + torch.cumsum(w * sdot, dim=-1)
        suffix = total[..., None] - prefix_incl
        g_alpha = Tg * sdot - (suffix + gt_term[..., None]) / one_minus
        g_alpha = torch.where(active, g_alpha, torch.zeros_like(g_alpha))
        g_sigma = -alpha * g_alpha
        ca, cb, cc = (d[:, :, i, None, :] for i in (2, 3, 4))
        g_op = torch.where(
            active, alpha / torch.clamp(op, min=1e-12) * g_alpha,
            torch.zeros_like(g_alpha),
        ).sum(2)
        rows = [
            (-(ca * dx + cb * dy) * g_sigma).sum(2),
            (-(cc * dy + cb * dx) * g_sigma).sum(2),
            (0.5 * dx * dx * g_sigma).sum(2),
            (dx * dy * g_sigma).sum(2),
            (0.5 * dy * dy * g_sigma).sum(2),
        ]
        g_ch = torch.einsum("tscp,tspg->tscg", gacc, w)  # (T, S, nchan, C)
        for i, g in enumerate(rows):
            gdyn[:, :, i, sl] = g
        if depth_in_dyn:
            gdyn[:, :, 6, sl] = g_ch[:, :, n_static]
        gst[:, 0, sl] += g_op.sum(1)
        gst[:, 1:, sl] += g_ch[:, :, :n_static].sum(1)
        Tc = Tg[..., -1] * one_minus[..., -1]
        prefix = prefix_incl[..., -1]
    return gdyn, gst


def composite_split_plain(dyn, st, counts, tile_ids, tiles_x, nchan,
                          depth_in_dyn, return_work=False):
    """Plain twin of the split forward (K4): the window twin at S = 1.
    dyn (T, Fd, cap) -> accum (T, nchan, P), tfin (T, P)."""
    out = composite_window_plain(dyn[:, None], st, counts, tile_ids, tiles_x,
                                 nchan, depth_in_dyn, return_work)
    return (out[0][:, 0], out[1][:, 0]) + tuple(out[2:])


def composite_split_bwd_plain(dyn, st, counts, tile_ids, accum, tfin, gacc,
                              gt, tiles_x, nchan, depth_in_dyn):
    """Plain twin of the split backward: gdyn (T, Fd, cap), gst."""
    gdyn, gst = composite_window_bwd_plain(
        dyn[:, None], st, counts, tile_ids, accum[:, None], tfin[:, None],
        gacc[:, None], gt[:, None], tiles_x, nchan, depth_in_dyn,
    )
    return gdyn[:, 0], gst


_DENSE_DYN_ROWS = [0, 1, 2, 3, 4, F_RADIUS]  # -> [mx, my, a, b, c, r]


def _dense_as_window(table, idx, nchan):
    """An indexed dense call as the window twin's inputs at S = 1: the
    table rows gathered into K5's dense layout, dyn (T, 1, 6, cap), st
    (T, 1+D, cap) = [op, channels], tile ids = row index."""
    T = idx.shape[0]
    rows = table[:, [*_DENSE_DYN_ROWS, F_OPACITY,
                     *range(F_CHANNELS, F_CHANNELS + nchan)]]
    data = rows[idx.long()].permute(0, 2, 1)  # (T, 7 + D, cap)
    dyn = data[:, :6][:, None]
    ids = torch.arange(T, dtype=torch.int32, device=idx.device)
    return dyn, data[:, 6:], ids


def composite_dense_plain(table, idx, counts, tiles_x, nchan,
                          return_work=False):
    """Plain twin of the dense forward (K5, rasterize.py:160).

    table (G+1, Fp), idx (T, cap), counts (T,) int32 -> accum (T, P, D),
    tfin (T, P, 1) (pixel-major, as K5 writes them)."""
    dyn, st, ids = _dense_as_window(table, idx, nchan)
    out = composite_window_plain(dyn, st, counts, ids, tiles_x, nchan, False,
                                 return_work)
    return (out[0][:, 0].transpose(1, 2).contiguous(),
            out[1][:, 0, :, None].contiguous()) + tuple(out[2:])


def composite_dense_bwd_plain(table, idx, counts, accum, tfin, gacc, gt,
                              tiles_x, nchan):
    """Plain twin of the dense backward (K5, rasterize.py:207-299).

    Returns gslot (T * cap + 1, Fp): per slot t * cap + j the row [g_mx,
    g_my, g_a, g_b, g_c, g_op, 0, g_channels, 0 ...], zero past the slot's
    stop chunk and count; the last row is the sink that dropped pairs name
    (dense_table_grad never reads it)."""
    dyn, st, ids = _dense_as_window(table, idx, nchan)
    cmaj = lambda x: x.transpose(1, 2)[:, None]  # (T, P, D) -> (T, 1, D, P)
    gdyn, gst = composite_window_bwd_plain(
        dyn, st, counts, ids, cmaj(accum), tfin[:, None, :, 0], cmaj(gacc),
        gt[:, None, :, 0], tiles_x, nchan, False,
    )
    T, cap = idx.shape
    gslot = table.new_zeros((T * cap + 1, table.shape[1]))
    g = gslot[:-1].view(T, cap, -1)
    g[..., :F_OPACITY] = gdyn[:, 0, :5].transpose(1, 2)
    g[..., F_OPACITY] = gst[:, 0]
    g[..., F_CHANNELS : F_CHANNELS + nchan] = gst[:, 1:].transpose(1, 2)
    return gslot


# ---------------------------------------------------------------------------
# The reference's plain compositors without the early stop (use_pallas=False)
# ---------------------------------------------------------------------------

NOSTOP_CHUNK_ELEMS = 1 << 24  # (tile, s, pixel, slot) entries per tile chunk


def _window_nostop_rows(dyn, st, tile_ids, tiles_x, nchan, depth_in_dyn):
    """The no-stop window composite of a few rows: every slot, front to
    back, T from the log-space cumsum as the reference computes it."""
    n_static = nchan - (1 if depth_in_dyn else 0)
    px, py = _pixel_centres(tile_ids, tiles_x)
    alpha, _, _, _ = _alpha_chunk(dyn, st[:, None, 0:1, :], px, py, True)
    l1m = torch.log1p(-alpha)
    cum = torch.cumsum(l1m, dim=-1)
    w = alpha * torch.exp(cum - l1m)
    ch = _chunk_channels(dyn, st, n_static, depth_in_dyn)
    return torch.einsum("tscg,tspg->tscp", ch, w), torch.exp(cum[..., -1])


def composite_window_nostop(dyn, st, counts, tile_ids, tiles_x, nchan,
                            depth_in_dyn):
    """The reference's _composite_window_xla (rasterize.py:1469): dyn
    (T, S, Fd, cap), st (T, 1+Dc, cap) -> accum (T, S, nchan, P), tfin
    (T, S, P) without the early stop; ``counts`` are unused (slots past a
    count hold the sentinel row, which contributes nothing)."""
    T, S, _, cap = dyn.shape
    rows = max(1, NOSTOP_CHUNK_ELEMS // (S * P * cap))
    grad = torch.is_grad_enabled() and (dyn.requires_grad or
                                        st.requires_grad)
    outs = []
    for a in range(0, T, rows):
        args = (dyn[a : a + rows], st[a : a + rows], tile_ids[a : a + rows],
                tiles_x, nchan, depth_in_dyn)
        outs.append(torch.utils.checkpoint.checkpoint(
            _window_nostop_rows, *args, use_reentrant=False) if grad
            else _window_nostop_rows(*args))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def composite_split_nostop(dyn, st, counts, tile_ids, tiles_x, nchan,
                           depth_in_dyn):
    """The reference's _composite_split_xla (rasterize.py:795): one
    sub-frame (T, Fd, cap) -> accum (T, nchan, P), tfin (T, P)."""
    acc, tf = composite_window_nostop(dyn[:, None], st, counts, tile_ids,
                                      tiles_x, nchan, depth_in_dyn)
    return acc[:, 0], tf[:, 0]


def composite_dense_nostop(tile_data, counts, tiles_x, nchan):
    """The reference's _composite_xla (rasterize.py:383) on its dense
    payload (T, 7+D, cap) -> accum (T, P, D), tfin (T, P, 1); row t is
    image tile t."""
    T = tile_data.shape[0]
    dyn = tile_data[:, _DENSE_DYN_ROWS]
    st = tile_data[:, [F_OPACITY, *range(F_CHANNELS, F_CHANNELS + nchan)]]
    ids = torch.arange(T, dtype=torch.int32, device=tile_data.device)
    acc, tf = composite_split_nostop(dyn, st, counts, ids, tiles_x, nchan,
                                     False)
    return acc.transpose(1, 2), tf[..., None]


# name: (forward twin, backward twin)
_COMPOSITORS = {
    "window": (composite_window_plain, composite_window_bwd_plain),
    "split": (composite_split_plain, composite_split_bwd_plain),
    "dense": (composite_dense_plain, composite_dense_bwd_plain),
}


class _Composite(torch.autograd.Function):
    """The twins' forward and backward as one autograd node.

    ``args`` are the compositor's arguments: its tensors first (the
    ``n_diff`` differentiable payloads, then counts / tile ids), then its
    static ints and flags."""

    @staticmethod
    def forward(ctx, kind, n_diff, *args):
        accum, tfin = _COMPOSITORS[kind][0](*args)
        n_t = sum(torch.is_tensor(a) for a in args)
        ctx.save_for_backward(*args[:n_t], accum, tfin)
        ctx.kind, ctx.n_diff, ctx.cfg = kind, n_diff, args[n_t:]
        return accum, tfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gacc, gt):
        *ins, accum, tfin = ctx.saved_tensors
        gacc = torch.zeros_like(accum) if gacc is None else gacc.contiguous()
        gt = torch.zeros_like(tfin) if gt is None else gt.contiguous()
        grads = _COMPOSITORS[ctx.kind][1](*ins, accum, tfin, gacc, gt, *ctx.cfg)
        if torch.is_tensor(grads):
            grads = (grads,)
        n_rest = len(ins) + len(ctx.cfg) - ctx.n_diff
        return (None, None, *grads, *([None] * n_rest))


def composite_tiles_window(dyn, st, counts, tile_ids, tiles_x, nchan,
                           depth_in_dyn):
    """Exposure-window compositor with a custom backward.

    dyn (T, S, Fd, cap) carries every sub-frame's screen rows; st
    (T, 1+Dc, cap) is the window-shared static payload. Returns accum
    (T, S, nchan, P), tfin (T, S, P). The static-payload gradient is summed
    over sub-frames.
    """
    return _Composite.apply("window", 2, dyn, st, counts, tile_ids, tiles_x,
                            nchan, bool(depth_in_dyn))


def composite_tiles_split(dyn, st, counts, tile_ids, tiles_x, nchan,
                          depth_in_dyn):
    """Split-payload compositor of one sub-frame (K4) with a custom
    backward: dyn (T, Fd, cap), st (T, 1+Dc, cap) -> channel-major accum
    (T, nchan, P), tfin (T, P)."""
    return _Composite.apply("split", 2, dyn, st, counts, tile_ids, tiles_x,
                            nchan, bool(depth_in_dyn))


def dense_table_grad(gslot, slot_map):
    """The table's gradient (G+1, Fp) from the per-slot gradient gslot
    (T * cap + 1, Fp): row g sums the rows gslot[slot_map[g, j]] in j order,
    skipping the sink T * cap that dropped pairs name; the sentinel row G
    gets zero. One embedding_bag (a gather and a sum per bag, no atomics:
    deterministic). A gather of the sink row for every dropped pair (most of
    the G x MT entries) and a sum over MT took 1.2 ms on the bench call, the
    one hot row serializing the gather; the bag skips it."""
    g = F.embedding_bag(slot_map, gslot, mode="sum",
                        padding_idx=gslot.shape[0] - 1)
    return F.pad(g, (0, 0, 0, 1))


class _CompositeIndexed(torch.autograd.Function):
    """The dense compositor (K5) on table rows by index (its twins); the
    backward's per-slot gradient is summed per Gaussian by
    dense_table_grad."""

    @staticmethod
    def forward(ctx, table, idx, counts, slot_map, tiles_x, nchan):
        accum, tfin = _COMPOSITORS["dense"][0](
            table, idx, counts, tiles_x, nchan)
        ctx.save_for_backward(table, idx, counts, slot_map, accum, tfin)
        ctx.cfg = (tiles_x, nchan)
        return accum, tfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gacc, gt):
        table, idx, counts, slot_map, accum, tfin = ctx.saved_tensors
        gacc = torch.zeros_like(accum) if gacc is None else gacc.contiguous()
        gt = torch.zeros_like(tfin) if gt is None else gt.contiguous()
        gslot = _COMPOSITORS["dense"][1](
            table, idx, counts, accum, tfin, gacc, gt, *ctx.cfg)
        return dense_table_grad(gslot, slot_map), None, None, None, None, None


def composite_indexed(table, idx, counts, slot_map, tiles_x, nchan):
    """Indexed dense compositor (K5) with a custom backward: table (G+1, Fp)
    from tiling.dense_table, idx (T, cap) int32 table rows, counts (T,),
    slot_map (G, MT) (tiling.IndexedBinning) -> accum (T, P, D), tfin
    (T, P, 1). Row t is image tile t."""
    return _CompositeIndexed.apply(table, idx, counts, slot_map, tiles_x,
                                   nchan)


def composite_tiles(tile_data, counts, tiles_x, nchan):
    """Dense compositor (K5) on the reference's dense payload: (T, 7+D,
    CAP), (T,) -> accum (T, P, D), tfin (T, P, 1). Row t is image tile t.
    Runs composite_indexed with every slot as its own table row (identity
    index)."""
    T, nf, cap = tile_data.shape
    n = T * cap
    table = F.pad(tile_data.transpose(1, 2).reshape(n, nf),
                  (0, dense_row_floats(nchan) - nf, 0, 1))
    dev = tile_data.device
    slot = torch.arange(n, dtype=torch.int32, device=dev)
    live = torch.arange(cap, device=dev) < counts[:, None]
    slot_map = torch.where(live.view(n), slot, n)[:, None]
    return composite_indexed(table, slot.view(T, cap), counts, slot_map,
                             tiles_x, nchan)


# ---------------------------------------------------------------------------
# Public rasterization API (one view)
# ---------------------------------------------------------------------------


def untile(accum, tfin, img_wh, tiles_xy, nchan):
    """Pixel-major untile: (T, P, D), (T, P, 1) -> (H, W, D), (H, W)."""
    W, H = img_wh
    tiles_x, tiles_y = tiles_xy
    img = accum.reshape(tiles_y, tiles_x, TILE, TILE, nchan)
    img = img.permute(0, 2, 1, 3, 4).reshape(
        tiles_y * TILE, tiles_x * TILE, nchan
    )
    tf = tfin.reshape(tiles_y, tiles_x, TILE, TILE)
    tf = tf.permute(0, 2, 1, 3).reshape(tiles_y * TILE, tiles_x * TILE)
    return img[:H, :W], tf[:H, :W]


def untile_cmajor(accum, tfin, img_wh, tiles_xy, nchan):
    """Channel-major untile: (T, D, P), (T, P) -> (H, W, D), (H, W)."""
    W, H = img_wh
    tiles_x, tiles_y = tiles_xy
    img = accum.reshape(tiles_y, tiles_x, nchan, TILE, TILE)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        tiles_y * TILE, tiles_x * TILE, nchan
    )
    tf = tfin.reshape(tiles_y, tiles_x, TILE, TILE)
    tf = tf.permute(0, 2, 1, 3).reshape(tiles_y * TILE, tiles_x * TILE)
    return img[:H, :W], tf[:H, :W]


def rasterize(
    proj,  # ops.projection.Projected of one view
    opacities: torch.Tensor,  # (G,)
    channels: torch.Tensor,  # (G, D)
    background: torch.Tensor,  # (D,)
    img_wh: tuple[int, int],
    cap: int = 512,
    use_pallas: bool = True,
):
    """Full tile rasterization of one view: bin -> composite (K5, reading
    the per-Gaussian table by index) -> untile. ``use_pallas=False``: the
    reference's dense payload (pack_and_gather) through its plain
    compositor without the early stop (composite_dense_nostop).

    Returns (img (H, W, D) with the background blended by the final
    transmittance, alpha = 1 - T_fin (H, W), binning (IndexedBinning; a
    TileBinning with use_pallas=False))."""
    nchan = channels.shape[-1]
    if use_pallas:
        binning = bin_indexed(proj, img_wh, cap)
        accum, tfin = composite_indexed(
            dense_table(proj, opacities, channels), binning.idx,
            binning.counts, binning.slot_map, binning.tiles_xy[0], nchan)
    else:
        binning = pack_and_gather(proj, opacities, channels, img_wh, cap)
        accum, tfin = composite_dense_nostop(
            binning.tile_data, binning.counts, binning.tiles_xy[0], nchan)
    tiles_x, tiles_y = binning.tiles_xy
    T = tiles_x * tiles_y  # drop TILE_BLOCK padding rows
    img, tf = untile(accum[:T], tfin[:T], img_wh, binning.tiles_xy, nchan)
    img = img + tf[..., None] * background[None, None, :]
    return img, 1.0 - tf, binning


def rasterize_split(
    st_data: torch.Tensor,  # (Tp, 1+Dc, CAP) window-shared static payload
    dyn_data: torch.Tensor,  # (Tp, Fd, CAP) one sub-frame of pack_dyn_all
    counts: torch.Tensor,  # (T,) int32 of the shared binning
    background: torch.Tensor,  # (nchan,)
    img_wh: tuple[int, int],
    include_depth: bool,
    use_pallas: bool = True,
):
    """Exposure-shared rasterization of one sub-frame (split payload, K4;
    with use_pallas=False the plain compositor without the early stop).

    Returns (img (H, W, nchan), alpha (H, W))."""
    tiles_x, tiles_y = num_tiles(img_wh)
    T = tiles_x * tiles_y
    nchan = st_data.shape[1] - 1 + (1 if include_depth else 0)
    counts = _pad_rows(counts, 0)
    tile_ids = torch.arange(counts.shape[0], dtype=torch.int32,
                            device=counts.device)
    split = composite_tiles_split if use_pallas else composite_split_nostop
    accum, tfin = split(dyn_data, st_data, counts, tile_ids, tiles_x, nchan,
                        include_depth)
    img, tf = untile_cmajor(accum[:T], tfin[:T], img_wh, (tiles_x, tiles_y),
                            nchan)
    img = img + tf[..., None] * background[None, None, :]
    return img, 1.0 - tf


def rasterize_split_buckets(
    buckets,  # tiling.TileBuckets
    st_list,  # per bucket: (Tb_pad, 1+Dc, cap_b) static payload
    dyn_list,  # per bucket: (Tb_pad, Fd, cap_b) this sub-frame's dyn rows
    background: torch.Tensor,  # (nchan,)
    img_wh: tuple[int, int],
    include_depth: bool,
    use_pallas: bool = True,
):
    """One sub-frame through count-sorted tile buckets (the reference's
    per-sub-frame bucketed path, rasterize.py:902): each bucket composites
    its rows at its own capacity (K4, the window kernels at S = 1, with the
    bucket's tile ids; or the plain compositor without the early stop), and
    its real rows land at their image tiles of one (T, nchan, P) grid.

    Returns (img (H, W, nchan), alpha (H, W))."""
    tiles_x, tiles_y = num_tiles(img_wh)
    T = tiles_x * tiles_y
    nchan = st_list[0].shape[1] - 1 + (1 if include_depth else 0)
    split = composite_tiles_split if use_pallas else composite_split_nostop
    dev = background.device
    accum = torch.zeros((T, nchan, P), device=dev)
    tfin = torch.ones((T, P), device=dev)
    for st, dyn, cnt, ids, size in zip(st_list, dyn_list, buckets.counts,
                                       buckets.tile_ids, buckets.sizes):
        acc, tf = split(dyn, st, cnt, ids, tiles_x, nchan, include_depth)
        rows = (ids[:size].long(),)
        accum = accum.index_put(rows, acc[:size])
        tfin = tfin.index_put(rows, tf[:size])
    img, tf = untile_cmajor(accum, tfin, img_wh, (tiles_x, tiles_y), nchan)
    img = img + tf[..., None] * background[None, None, :]
    return img, 1.0 - tf


# ---------------------------------------------------------------------------
# Bucketed window compositing (host side)
# ---------------------------------------------------------------------------


def composite_window_buckets(
    buckets,  # tiling.TileBuckets
    st_list,  # per bucket: (Tb_pad, 1+Dc, cap_b) static payload
    dyn_lists,  # per bucket: (Tb_pad, S, Fd, cap_b) fused-layout dyn rows
    background: torch.Tensor,  # (nchan,)
    img_wh: tuple[int, int],
    include_depth: bool,
    mask_channel: int | None = None,
    use_pallas: bool = True,
    stack_subframes: bool = True,
    stack_mask: bool = False,
):
    """Composite a full exposure window in tile space, one untile per window.

    Every bucket runs ONE compositor call covering all S sub-frames; the
    exposure reductions (sum over sub-frames; max of the mask channel; min
    of per-sub-frame expected depth) are taken on the (Tb, S, nchan, P)
    outputs in tile space, and one inverse-permutation row gather + untile
    reassembles the window;
    ``use_pallas=False`` runs the plain compositor without the early stop
    (composite_window_nostop).

    Returns dict: sum_img (H, W, nchan) (background blended), sum_alpha
    (H, W), max_mask (H, W, 1) | None, min_depth (H, W, 1) | None,
    rgb_stack (S', H, W, 3), alpha_stack (S', H, W), mask_stack
    (S', H, W, 1) | None, where S' = S, or 1 (the mid sub-frame) when
    stack_subframes=False.
    """
    tiles_x, tiles_y = num_tiles(img_wh)
    T = tiles_x * tiles_y
    S = dyn_lists[0].shape[1]
    nb = len(st_list)
    nchan = st_list[0].shape[1] - 1 + (1 if include_depth else 0)
    s_keep = list(range(S)) if stack_subframes else [S // 2]
    if stack_mask:
        assert mask_channel is not None
    ncs = 4 + (1 if stack_mask else 0)  # per-sub-frame slab channels
    bg = background[None, None, :3, None]

    packed_b = []
    for b in range(nb):
        args = (dyn_lists[b], st_list[b], buckets.counts[b],
                buckets.tile_ids[b], tiles_x, nchan, include_depth)
        if use_pallas:
            acc, tf = composite_tiles_window(*args)
        else:
            acc, tf = composite_window_nostop(*args)
        n = buckets.sizes[b]
        packed_b.append(_window_packed_channels(
            acc[:n], tf[:n], bg, mask_channel, include_depth, s_keep,
            stack_mask,
        ))

    # Invert the bucket permutation once: every image tile lives in exactly
    # one bucket row (pad rows are excluded by [:n]).
    ids_cat = torch.cat(
        [ids[:n] for ids, n in zip(buckets.tile_ids, buckets.sizes)]
    ).long()
    inv = torch.zeros((T,), dtype=torch.int64, device=ids_cat.device)
    inv[ids_cat] = torch.arange(T, device=ids_cat.device)
    packed = torch.cat(packed_b, dim=0)[inv]  # (T, C, P)
    return _window_outputs_from_packed(
        packed, background, img_wh, (tiles_x, tiles_y), nchan,
        mask_channel, include_depth, s_keep, ncs, S, stack_mask,
    )


def _window_packed_channels(acc, tf, bg, mask_channel, include_depth, s_keep,
                            stack_mask):
    """acc (R, S, nchan, P), tf (R, S, P) -> one wide channel axis
    (R, C, P):
      [0:nchan]     sum over sub-frames of composited channels
      [nchan]       sum over sub-frames of transmittance
      [+1 if mask]  max over sub-frames of the mask channel
      [+1 if depth] min over sub-frames of expected depth
      [ncs*S']      per-sub-frame (rgb + transmittance (+ mask)) slabs"""
    S = acc.shape[1]
    tf1 = tf[:, :, None, :]  # (R, S, 1, P)
    parts = [acc.sum(1), tf1.sum(1)]
    if mask_channel is not None:
        parts.append(acc[:, :, mask_channel : mask_channel + 1].amax(1))
    if include_depth:
        d = acc[:, :, -1:, :] / torch.clamp(1.0 - tf1, min=1e-10)
        parts.append(d.amin(1))
    acc_k = acc[:, s_keep] if len(s_keep) != S else acc
    tf1_k = tf1[:, s_keep] if len(s_keep) != S else tf1
    slab = [acc_k[:, :, :3, :] + tf1_k * bg, tf1_k]
    if stack_mask:
        slab.append(acc_k[:, :, mask_channel : mask_channel + 1, :])
    slab = torch.cat(slab, dim=2)  # (R, S', ncs, P)
    parts.append(slab.reshape(slab.shape[0], -1, P))
    return torch.cat(parts, dim=1)


def _window_outputs_from_packed(
    packed, background, img_wh, tiles_xy, nchan, mask_channel,
    include_depth, s_keep, ncs, S, stack_mask,
):
    """Untile the (T, C, P) packed window channels into the output dict."""
    C = packed.shape[1]
    img_all, _ = untile_cmajor(packed, packed[:, 0], img_wh, tiles_xy, C)
    H, Wd = img_all.shape[:2]
    sum_img = (
        img_all[..., :nchan]
        + img_all[..., nchan : nchan + 1] * background[None, None, :]
    )
    out = {
        "sum_img": sum_img,
        "sum_alpha": float(S) - img_all[..., nchan],
        "max_mask": None,
        "min_depth": None,
    }
    off = nchan + 1
    if mask_channel is not None:
        out["max_mask"] = img_all[..., off : off + 1]
        off += 1
    if include_depth:
        out["min_depth"] = img_all[..., off : off + 1]
        off += 1
    Sk = len(s_keep)
    slab = img_all[..., off : off + ncs * Sk].reshape(H, Wd, Sk, ncs)
    out["rgb_stack"] = torch.movedim(slab[..., :3], 2, 0)
    out["alpha_stack"] = 1.0 - torch.movedim(slab[..., 3], 2, 0)
    out["mask_stack"] = (
        torch.movedim(slab[..., 4:5], 2, 0) if stack_mask else None
    )
    return out
