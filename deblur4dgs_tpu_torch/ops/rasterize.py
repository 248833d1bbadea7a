"""Tile compositors: CUDA kernels + their plain PyTorch twins.

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
  * window scatter (K6, behind D4_SCATTER=1): the window kernels with the
    outputs of bucket row t at image-tile row sids[t] of one shared
    (T_img + 1, ...) buffer for all buckets (row T_img takes the pad rows);
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

On CUDA tensors the compositors launch the kernels in csrc/ (built by
ops/cuda_build.py) or raise; on CPU tensors they run the twins. There is
no fallback from one to the other. The dense and split twins are the
window twin on views of their inputs (the same per-pair math).
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from deblur4dgs_tpu_torch.ops.tiling import (
    F_CHANNELS,
    F_OPACITY,
    F_RADIUS,
    TILE,
    _pad_rows,
    bin_indexed,
    dense_row_floats,
    dense_table,
    num_tiles,
)

ALPHA_CLAMP = 0.999
ALPHA_CUTOFF = 1.0 / 255.0
# Chunk-level early termination threshold (gsplat's per-pixel forward
# early stop uses 1e-4; dropped contributions are < 1e-4 of a color unit).
EARLY_STOP_T = 1e-4
CHUNK = 128  # Gaussians per chunk (the stop rule's granularity)
P = TILE * TILE  # pixels per tile
MAX_DENSE_CHANNELS = 16  # the dense kernels' register accumulators
# Scatter-output window path (K6), read at import as the reference does
# (deblur4dgs_tpu/ops/rasterize.py:52); tests monkeypatch it.
_USE_SCATTER = os.environ.get("D4_SCATTER", "0") != "0"

# Launch counts of the CUDA kernels, incremented only where a kernel is
# launched (CPU twins and kernel-vs-twin checks through the twins never
# count). chip_smoke.py zeroes them before driving a path.
LAUNCHES = {"window_fwd": 0, "window_bwd": 0, "window_scatter_fwd": 0,
            "window_scatter_bwd": 0, "split_fwd": 0, "split_bwd": 0,
            "dense_fwd": 0, "dense_bwd": 0}


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


WARP_W, WARP_H = 8, 4  # the window kernels' pixel block of one warp
NWARPS = P // (WARP_W * WARP_H)


def warp_of_pixel(device=None):
    """(P,) the warp of each pixel p = y * TILE + x in the window kernels
    (csrc/composite_common.cuh::warp_block_pixel): warp w covers the 8x4
    block (w % 2, w // 2) of the tile."""
    p = torch.arange(P, device=device)
    return (p // TILE // WARP_H) * (TILE // WARP_W) + (p % TILE) // WARP_W


def warp_reach(dyn, tile_ids, tiles_x):
    """The window kernels' per-warp cull (csrc/composite_common.cuh::
    warp_reaches), stated on the CPU; the twins do not use it, they
    evaluate every pair.

    dyn (T, S, >=6, C) rows [mx, my, a, b, c, r, ...], tile_ids (T,) ->
    (T, S, NWARPS, C) bool: whether alpha_at's box |px - mx| <= r,
    |py - my| <= r holds at some pixel centre of warp w's block, tested at
    the block's centre nearest the mean with the same float32 rounding. A
    False means every pixel of that warp finds the pair dead."""
    t = tile_ids.long()
    w = torch.arange(NWARPS, device=dyn.device)
    xlo = ((t % tiles_x) * TILE)[:, None] + (w % 2) * WARP_W
    ylo = ((t // tiles_x) * TILE)[:, None] + (w // 2) * WARP_H
    xlo = (xlo.float() + 0.5)[:, None, :, None]  # (T, 1, NWARPS, 1)
    ylo = (ylo.float() + 0.5)[:, None, :, None]
    mx, my, r = (dyn[:, :, i, None, :] for i in (0, 1, 5))
    cx = torch.minimum(torch.maximum(torch.floor(mx) + 0.5, xlo),
                       xlo + (WARP_W - 1))
    cy = torch.minimum(torch.maximum(torch.floor(my) + 0.5, ylo),
                       ylo + (WARP_H - 1))
    return ((cx - mx).abs() <= r) & ((cy - my).abs() <= r)


def composite_window_scatter_plain(dyn, st, counts, sids, accum, tfin,
                                   tiles_x, nchan, depth_in_dyn,
                                   return_work=False):
    """Plain twin of the scatter forward (K6): the window twin on the
    bucket with tile ids ``sids``, its rows written in place at rows
    ``sids`` of the shared accum (T_img+1, S, nchan, P) / tfin
    (T_img+1, S, P). Returns (accum, tfin) (+ work, see the window twin)."""
    out = composite_window_plain(dyn, st, counts, sids, tiles_x, nchan,
                                 depth_in_dyn, return_work)
    rows = sids.long()
    accum[rows] = out[0]
    tfin[rows] = out[1]
    return (accum, tfin) + tuple(out[2:])


def composite_window_scatter_bwd_plain(dyn, st, counts, sids, accum, tfin,
                                       gacc, gt, tiles_x, nchan,
                                       depth_in_dyn):
    """Plain twin of the scatter backward (K6): gather the bucket's rows of
    the shared residual and cotangent buffers and run the window twin, as
    the reference's interpret path does (rasterize.py:1652-1659)."""
    rows = sids.long()
    return composite_window_bwd_plain(
        dyn, st, counts, sids, accum[rows], tfin[rows], gacc[rows], gt[rows],
        tiles_x, nchan, depth_in_dyn,
    )


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
# CUDA kernel wrappers (ctypes; see ops/cuda_build.py)
# ---------------------------------------------------------------------------


def _check(x, name, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_cuda(x):
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {x.device}")


def _launch(dev, name, *args):
    """Call the C entry ``d4gs_<name>`` on the current stream of ``dev``
    (tensors passed as pointers); raise if the launch failed."""
    from deblur4dgs_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    cargs = [ctypes.c_void_p(a.data_ptr()) if torch.is_tensor(a) else a
             for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"d4gs_{name}")(*cargs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{cuda_build.error_string(err)}")


def _check_window_inputs(dyn, st, counts, tile_ids, nchan, depth_in_dyn):
    T, S, Fd, cap = dyn.shape
    dev = dyn.device
    if Fd != 6 + int(bool(depth_in_dyn)):
        raise ValueError(f"dyn has {Fd} rows, expected "
                         f"{6 + int(bool(depth_in_dyn))}")
    if cap % CHUNK:
        raise ValueError(f"capacity {cap} is not a multiple of {CHUNK}")
    Fs = 1 + nchan - int(bool(depth_in_dyn))
    _check(dyn, "dyn", torch.float32, (T, S, Fd, cap), dev)
    _check(st, "st", torch.float32, (T, Fs, cap), dev)
    _check(counts, "counts", torch.int32, (T,), dev)
    _check(tile_ids, "tile_ids", torch.int32, (T,), dev)
    return T, S, Fd, Fs, cap


def _window_fwd(dyn, st, counts, tile_ids, tiles_x, nchan, depth_in_dyn,
                key, out=None):
    """Launch the window forward; ``out`` = the shared (accum, tfin) of the
    scatter path (K6: tile_ids are the rows to write) or None for fresh
    bucket-ordered outputs."""
    _require_cuda(dyn)
    T, S, Fd, Fs, cap = _check_window_inputs(
        dyn, st, counts, tile_ids, nchan, depth_in_dyn
    )
    if out is None:
        accum = dyn.new_empty((T, S, nchan, P))
        tfin = dyn.new_empty((T, S, P))
    else:
        accum, tfin = out
        _check_scatter_buffers(accum, tfin, S, nchan, dyn.device, "")
    _launch(dyn.device, "window_fwd" if out is None else "window_scatter_fwd",
            tile_ids, counts, dyn, st, accum, tfin, T, S, Fd, Fs, cap, nchan,
            int(bool(depth_in_dyn)), tiles_x)
    LAUNCHES[key] += 1
    return accum, tfin


def _window_bwd(dyn, st, counts, tile_ids, accum, tfin, gacc, gt, tiles_x,
                nchan, depth_in_dyn, key, scatter=False):
    """Launch the window backward; ``scatter``: accum / tfin / gacc / gt
    are the shared (T_img + 1, ...) buffers of K6, read at rows
    tile_ids[t]. The kernel writes gst per (row, sub-frame); it is summed
    over S here in a fixed order (deterministic: no atomics)."""
    _require_cuda(dyn)
    T, S, Fd, Fs, cap = _check_window_inputs(
        dyn, st, counts, tile_ids, nchan, depth_in_dyn
    )
    dev = dyn.device
    if scatter:
        _check_scatter_buffers(accum, tfin, S, nchan, dev, "")
        _check_scatter_buffers(gacc, gt, S, nchan, dev, "cotangent of ")
    else:
        _check(accum, "accum", torch.float32, (T, S, nchan, P), dev)
        _check(tfin, "tfin", torch.float32, (T, S, P), dev)
        _check(gacc, "gacc", torch.float32, (T, S, nchan, P), dev)
        _check(gt, "gt", torch.float32, (T, S, P), dev)
    gdyn = torch.empty_like(dyn)
    gst_s = dyn.new_empty((T, S, Fs, cap))  # per sub-frame, written whole
    _launch(dev, "window_scatter_bwd" if scatter else "window_bwd", tile_ids,
            counts, dyn, st, accum, tfin, gacc, gt, gdyn, gst_s, T, S, Fd, Fs,
            cap, nchan, int(bool(depth_in_dyn)), tiles_x)
    LAUNCHES[key] += 1
    return gdyn, gst_s.sum(1)


def _check_scatter_buffers(accum, tfin, S, nchan, dev, label):
    T_img = accum.shape[0] - 1
    _check(accum, f"{label}accum", torch.float32, (T_img + 1, S, nchan, P),
           dev)
    _check(tfin, f"{label}tfin", torch.float32, (T_img + 1, S, P), dev)
    return T_img


def window_fwd_cuda(dyn, st, counts, tile_ids, tiles_x, nchan, depth_in_dyn):
    """Launch the window forward kernel (replaces the TPU kernel K1,
    deblur4dgs_tpu/ops/rasterize.py::_fwd_kernel_window)."""
    return _window_fwd(dyn, st, counts, tile_ids, tiles_x, nchan,
                       depth_in_dyn, "window_fwd")


def window_bwd_cuda(dyn, st, counts, tile_ids, accum, tfin, gacc, gt,
                    tiles_x, nchan, depth_in_dyn):
    """Launch the window backward kernel (replaces the TPU kernels K2,
    _bwd_kernel_window_sgrid, and K3, _bwd_kernel_window)."""
    return _window_bwd(dyn, st, counts, tile_ids, accum, tfin, gacc, gt,
                       tiles_x, nchan, depth_in_dyn, "window_bwd")


def window_scatter_fwd_cuda(dyn, st, counts, sids, accum, tfin, tiles_x,
                            nchan, depth_in_dyn):
    """Launch the scatter forward (replaces the TPU kernel K6,
    deblur4dgs_tpu/ops/rasterize.py::_fwd_kernel_window_scatter): the window
    forward kernel with bucket row t written at row sids[t] of the shared
    accum (T_img+1, S, nchan, P) / tfin (T_img+1, S, P), in place. Pad rows
    carry sid T_img (the trash row) and count 0. Returns (accum, tfin)."""
    return _window_fwd(dyn, st, counts, sids, tiles_x, nchan, depth_in_dyn,
                       "window_scatter_fwd", out=(accum, tfin))


def window_scatter_bwd_cuda(dyn, st, counts, sids, accum, tfin, gacc, gt,
                            tiles_x, nchan, depth_in_dyn):
    """Launch the scatter backward (K6's backward, the window backward
    kernel reading accum / tfin / gacc / gt at rows sids[t] of the shared
    buffers): bucket-ordered gdyn (T, S, Fd, cap), gst (T, 1+Dc, cap)."""
    return _window_bwd(dyn, st, counts, sids, accum, tfin, gacc, gt, tiles_x,
                       nchan, depth_in_dyn, "window_scatter_bwd",
                       scatter=True)


def split_fwd_cuda(dyn, st, counts, tile_ids, tiles_x, nchan, depth_in_dyn):
    """The split forward K4 (deblur4dgs_tpu/ops/rasterize.py::
    _fwd_kernel_split) as the window forward kernel at S = 1.

    K4 is K1 with one sub-frame in the same layout: its (Tp, Fd, cap) dyn
    rows are a (Tp, 1, Fd, cap) window, and its stop rule per row is the
    window kernel's per (row, s) at S = 1. Views in and out, no copies."""
    _require_cuda(dyn)
    accum, tfin = _window_fwd(dyn[:, None], st, counts, tile_ids, tiles_x,
                              nchan, depth_in_dyn, "split_fwd")
    return accum[:, 0], tfin[:, 0]


def split_bwd_cuda(dyn, st, counts, tile_ids, accum, tfin, gacc, gt,
                   tiles_x, nchan, depth_in_dyn):
    """The split backward K4 (_bwd_kernel_split) as the window backward
    kernel at S = 1 (see split_fwd_cuda): gdyn (Tp, Fd, cap), gst."""
    _require_cuda(dyn)
    gdyn, gst = _window_bwd(dyn[:, None], st, counts, tile_ids,
                            accum[:, None], tfin[:, None], gacc[:, None],
                            gt[:, None], tiles_x, nchan, depth_in_dyn,
                            "split_bwd")
    return gdyn[:, 0], gst


def _check_dense_inputs(table, idx, counts, nchan):
    if not 1 <= nchan <= MAX_DENSE_CHANNELS:
        raise ValueError(f"nchan {nchan} outside [1, {MAX_DENSE_CHANNELS}]")
    T, cap = idx.shape
    if cap % CHUNK:
        raise ValueError(f"capacity {cap} is not a multiple of {CHUNK}")
    Fp = dense_row_floats(nchan)
    dev = table.device
    _check(table, "table", torch.float32, (table.shape[0], Fp), dev)
    if table.data_ptr() % 16:
        raise ValueError("table rows must be 16-byte aligned (float4 loads)")
    _check(idx, "idx", torch.int32, (T, cap), dev)
    _check(counts, "counts", torch.int32, (T,), dev)
    return T, cap, Fp


def dense_fwd_cuda(table, idx, counts, tiles_x, nchan):
    """Launch the dense forward kernel (replaces the TPU kernel K5,
    deblur4dgs_tpu/ops/rasterize.py::_fwd_kernel) on the table rows idx[t,
    :counts[t]] of each image-tile row t. accum (T, P, D), tfin (T, P, 1)."""
    _require_cuda(table)
    T, cap, Fp = _check_dense_inputs(table, idx, counts, nchan)
    accum = table.new_empty((T, P, nchan))
    tfin = table.new_empty((T, P, 1))
    _launch(table.device, "dense_fwd", idx, counts, table, accum, tfin, T,
            cap, Fp, nchan, tiles_x)
    LAUNCHES["dense_fwd"] += 1
    return accum, tfin


def dense_bwd_cuda(table, idx, counts, accum, tfin, gacc, gt, tiles_x,
                   nchan):
    """Launch the dense backward kernel (replaces K5's _bwd_kernel /
    _bwd_one_tile). gslot (T * cap + 1, Fp) as the twin returns it; the
    kernel writes the rows of the slots below each count and leaves the
    others (which no pair names) and the sink row unwritten."""
    _require_cuda(table)
    T, cap, Fp = _check_dense_inputs(table, idx, counts, nchan)
    dev = table.device
    _check(accum, "accum", torch.float32, (T, P, nchan), dev)
    _check(tfin, "tfin", torch.float32, (T, P, 1), dev)
    _check(gacc, "gacc", torch.float32, (T, P, nchan), dev)
    _check(gt, "gt", torch.float32, (T, P, 1), dev)
    gslot = table.new_empty((T * cap + 1, Fp))
    _launch(dev, "dense_bwd", idx, counts, table, accum, tfin, gacc, gt,
            gslot, T, cap, Fp, nchan, tiles_x)
    LAUNCHES["dense_bwd"] += 1
    return gslot


# name: (forward on CUDA, forward twin, backward on CUDA, backward twin)
_COMPOSITORS = {
    "window": (window_fwd_cuda, composite_window_plain, window_bwd_cuda,
               composite_window_bwd_plain),
    # forward: (dyn, st, counts, sids, accum, tfin, ...) writes in place
    "window_scatter": (window_scatter_fwd_cuda, composite_window_scatter_plain,
                       window_scatter_bwd_cuda,
                       composite_window_scatter_bwd_plain),
    "split": (split_fwd_cuda, composite_split_plain, split_bwd_cuda,
              composite_split_bwd_plain),
    "dense": (dense_fwd_cuda, composite_dense_plain, dense_bwd_cuda,
              composite_dense_bwd_plain),
}


class _Composite(torch.autograd.Function):
    """Kernel forward/backward on CUDA tensors, plain twins on CPU ones.

    ``args`` are the compositor's arguments: its tensors first (the
    ``n_diff`` differentiable payloads, then counts / tile ids), then its
    static ints and flags."""

    @staticmethod
    def forward(ctx, kind, n_diff, *args):
        fwd_cuda, fwd_plain, _, _ = _COMPOSITORS[kind]
        accum, tfin = (fwd_cuda if args[0].is_cuda else fwd_plain)(*args)
        n_t = sum(torch.is_tensor(a) for a in args)
        ctx.save_for_backward(*args[:n_t], accum, tfin)
        ctx.kind, ctx.n_diff, ctx.cfg = kind, n_diff, args[n_t:]
        return accum, tfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gacc, gt):
        *ins, accum, tfin = ctx.saved_tensors
        _, _, bwd_cuda, bwd_plain = _COMPOSITORS[ctx.kind]
        gacc = torch.zeros_like(accum) if gacc is None else gacc.contiguous()
        gt = torch.zeros_like(tfin) if gt is None else gt.contiguous()
        fn = bwd_cuda if ins[0].is_cuda else bwd_plain
        grads = fn(*ins, accum, tfin, gacc, gt, *ctx.cfg)
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


class _CompositeScatter(torch.autograd.Function):
    """All buckets of a window into one image-tile-ordered output (K6).

    ``tensors`` are the nb buckets' dyn, then st, counts and sids. The
    forward allocates accum (T_img+1, S, nchan, P) and tfin
    (T_img+1, S, P), fills the trash row T_img with what a count-0 row
    composites (0 and 1), and launches every bucket into them; the
    backward runs every bucket against the shared residual and cotangent
    buffers. Kernels on CUDA tensors, twins on CPU ones."""

    @staticmethod
    def forward(ctx, nb, T_img, tiles_x, nchan, depth_in_dyn, *tensors):
        dyns, sts, counts, sids = (tensors[i * nb : (i + 1) * nb]
                                   for i in range(4))
        fwd_cuda, fwd_plain, _, _ = _COMPOSITORS["window_scatter"]
        S = dyns[0].shape[1]
        accum = dyns[0].new_empty((T_img + 1, S, nchan, P))
        tfin = dyns[0].new_empty((T_img + 1, S, P))
        accum[T_img] = 0.0
        tfin[T_img] = 1.0
        for b in range(nb):
            fn = fwd_cuda if dyns[b].is_cuda else fwd_plain
            fn(dyns[b], sts[b], counts[b], sids[b], accum, tfin, tiles_x,
               nchan, depth_in_dyn)
        ctx.save_for_backward(*tensors, accum, tfin)
        ctx.cfg = (nb, tiles_x, nchan, depth_in_dyn)
        return accum, tfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gacc, gt):
        *ins, accum, tfin = ctx.saved_tensors
        nb, tiles_x, nchan, depth_in_dyn = ctx.cfg
        _, _, bwd_cuda, bwd_plain = _COMPOSITORS["window_scatter"]
        gacc = torch.zeros_like(accum) if gacc is None else gacc.contiguous()
        gt = torch.zeros_like(tfin) if gt is None else gt.contiguous()
        gdyns, gsts = [], []
        for b in range(nb):
            dyn, st, counts, sids = (ins[i * nb + b] for i in range(4))
            fn = bwd_cuda if dyn.is_cuda else bwd_plain
            gdyn, gst = fn(dyn, st, counts, sids, accum, tfin, gacc, gt,
                           tiles_x, nchan, depth_in_dyn)
            gdyns.append(gdyn)
            gsts.append(gst)
        return (None,) * 5 + tuple(gdyns) + tuple(gsts) + (None,) * (2 * nb)


def composite_buckets_scatter(dyn_lists, st_list, counts_list, sids_list,
                              T_img, tiles_x, nchan, depth_in_dyn):
    """All buckets' window compositing into ONE image-tile-ordered output
    (K6; reference rasterize.py:1706-1753). sids_list[b] (Tb,) int32 holds
    each bucket row's image tile, T_img for pad rows. Returns accum
    (T_img+1, S, nchan, P), tfin (T_img+1, S, P); callers slice [:T_img]."""
    nb = len(dyn_lists)
    return _CompositeScatter.apply(
        nb, T_img, tiles_x, nchan, bool(depth_in_dyn), *dyn_lists, *st_list,
        *counts_list, *sids_list,
    )


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
    """The dense compositor (K5) on table rows by index: the kernels on
    CUDA tensors, the twins on CPU ones; the backward's per-slot gradient is
    summed per Gaussian by dense_table_grad."""

    @staticmethod
    def forward(ctx, table, idx, counts, slot_map, tiles_x, nchan):
        fwd_cuda, fwd_plain, _, _ = _COMPOSITORS["dense"]
        accum, tfin = (fwd_cuda if table.is_cuda else fwd_plain)(
            table, idx, counts, tiles_x, nchan)
        ctx.save_for_backward(table, idx, counts, slot_map, accum, tfin)
        ctx.cfg = (tiles_x, nchan)
        return accum, tfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gacc, gt):
        table, idx, counts, slot_map, accum, tfin = ctx.saved_tensors
        _, _, bwd_cuda, bwd_plain = _COMPOSITORS["dense"]
        gacc = torch.zeros_like(accum) if gacc is None else gacc.contiguous()
        gt = torch.zeros_like(tfin) if gt is None else gt.contiguous()
        gslot = (bwd_cuda if table.is_cuda else bwd_plain)(
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
):
    """Full tile rasterization of one view: bin -> composite (K5, reading
    the per-Gaussian table by index) -> untile.

    Returns (img (H, W, D) with the background blended by the final
    transmittance, alpha = 1 - T_fin (H, W), binning (IndexedBinning))."""
    nchan = channels.shape[-1]
    binning = bin_indexed(proj, img_wh, cap)
    tiles_x, tiles_y = binning.tiles_xy
    accum, tfin = composite_indexed(
        dense_table(proj, opacities, channels), binning.idx, binning.counts,
        binning.slot_map, tiles_x, nchan)
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
):
    """Exposure-shared rasterization of one sub-frame (split payload, K4).

    Returns (img (H, W, nchan), alpha (H, W))."""
    tiles_x, tiles_y = num_tiles(img_wh)
    T = tiles_x * tiles_y
    nchan = st_data.shape[1] - 1 + (1 if include_depth else 0)
    counts = _pad_rows(counts, 0)
    tile_ids = torch.arange(counts.shape[0], dtype=torch.int32,
                            device=counts.device)
    accum, tfin = composite_tiles_split(dyn_data, st_data, counts, tile_ids,
                                        tiles_x, nchan, include_depth)
    img, tf = untile_cmajor(accum[:T], tfin[:T], img_wh, (tiles_x, tiles_y),
                            nchan)
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
    tile_mesh=None,
    stack_subframes: bool = True,
    stack_mask: bool = False,
):
    """Composite a full exposure window in tile space, one untile per window.

    Every bucket runs ONE compositor call covering all S sub-frames; the
    exposure reductions (sum over sub-frames; max of the mask channel; min
    of per-sub-frame expected depth) are taken on the (Tb, S, nchan, P)
    outputs in tile space, and one inverse-permutation row gather + untile
    reassembles the window. With ``_USE_SCATTER`` (D4_SCATTER=1) the
    buckets write one image-tile-ordered buffer instead
    (composite_buckets_scatter, K6): no concat and no gather.

    Returns dict: sum_img (H, W, nchan) (background blended), sum_alpha
    (H, W), max_mask (H, W, 1) | None, min_depth (H, W, 1) | None,
    rgb_stack (S', H, W, 3), alpha_stack (S', H, W), mask_stack
    (S', H, W, 1) | None, where S' = S, or 1 (the mid sub-frame) when
    stack_subframes=False.
    """
    if tile_mesh is not None:
        raise NotImplementedError(
            "tile_mesh (compositing sharded over image tiles) comes with the "
            "multi-device port slice"
        )
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

    if _USE_SCATTER:
        # The buckets must partition the image tiles, so that every real
        # row of the shared buffer is written; pad rows go to trash row T.
        if sum(buckets.sizes) != T:
            raise ValueError(f"bucket sizes {buckets.sizes} do not "
                             f"partition the {T} image tiles")
        sids = []
        for ids, n in zip(buckets.tile_ids, buckets.sizes):
            if ids.shape[0] > n:
                ids = torch.cat([ids[:n], ids.new_full((ids.shape[0] - n,),
                                                       T)])
            sids.append(ids)
        acc, tf = composite_buckets_scatter(
            dyn_lists, st_list, buckets.counts, sids, T, tiles_x, nchan,
            include_depth,
        )
        packed = _window_packed_channels(
            acc[:T], tf[:T], bg, mask_channel, include_depth, s_keep,
            stack_mask,
        )
        return _window_outputs_from_packed(
            packed, background, img_wh, (tiles_x, tiles_y), nchan,
            mask_channel, include_depth, s_keep, ncs, S, stack_mask,
        )

    packed_b = []
    for b in range(nb):
        acc, tf = composite_tiles_window(
            dyn_lists[b], st_list[b], buckets.counts[b],
            buckets.tile_ids[b], tiles_x, nchan, include_depth,
        )
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
