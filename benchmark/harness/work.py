"""The work a train step needs, counted from shapes and from the
reference's own binning of the step's inputs: the yardstick of the
roofline and MFU metrics.

Compositing (forward and backward) is counted per call of the window
(K1, K2) and dense (K5) compositors from what the reference's plain twins
walk on the same inputs: the slots before each row's stop chunk, the
(pixel, Gaussian) pairs inside alpha_at's 3-sigma box among them, and the
pairs that composite. The rest of the step (deformation and projection,
the losses with SSIM's 11-tap blurs, PWC-Net's convolutions and
correlations, Adam) is counted from shapes. Recomputation is not counted:
this is what the step needs, not what an implementation spends.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch

TILE, P, NWARPS = 16, 256, 8  # pixels per tile side and tile; 8x4 warps
# Operations per (pixel, Gaussian) pair inside the box: alpha (offsets,
# conic quadratic, exp, cutoff tests). A pair that composites adds
# 2 * nchan + 3 in the forward (weight, channel FMAs, transmittance) and
# 4 * nchan + 36 in the backward (channel grads, prefix / suffix sums,
# alpha, conic, mean and opacity grads, one add per reduced value).
OPS_PAIR = 20
# Finding the pairs inside the box: a box test (two rounded offsets, two
# compares) per walked Gaussian and block of 32 pixels.
OPS_BOX = 4
F32 = 4  # bytes
# Per Gaussian and view, forward: blending K motion bases' 3x4 transforms
# (2 * 12 per basis) and applying one to the mean and the rotation
DEFORM_OPS_BASIS, DEFORM_OPS = 24, 80
# projection: rotation from the quaternion, 3D covariance, the camera
# transform, the Jacobian, 2D covariance, conic and radius
PROJECT_OPS = 250
# Per loss pixel and image: SSIM's five statistics over three channels
# through two 11-tap passes (5 * 3 * 2 * 11 * 2 = 660) and its map (~40);
# a 9x9 dilation of a mask (81); the L1 terms and masks (~20)
SSIM_OPS, DILATE_OPS, L1_OPS = 700, 81, 20
BACKWARD_FACTOR = 3  # forward + backward of a differentiated op
ADAM_OPS = 12  # per parameter element


@dataclass
class CallWork:
    kind: str
    ops: dict  # "fwd" / "bwd" -> operations
    bytes: dict  # "fwd" / "bwd" -> bytes read once and written once


@dataclass
class StepWork:
    calls: list = field(default_factory=list)  # [CallWork]
    other_ops: float = 0.0  # everything but compositing

    def composite_ops(self):
        return sum(c.ops[d] for c in self.calls for d in ("fwd", "bwd"))

    def total_ops(self):
        return self.composite_ops() + self.other_ops

    def composite_least_s(self, bw, peak):
        """The least time of the step's compositor kernels: per call and
        direction, the larger of bytes / bandwidth and ops / peak."""
        return sum(max(c.bytes[d] / bw, c.ops[d] / peak)
                   for c in self.calls for d in ("fwd", "bwd"))


def box_pairs(mx, my, r, tile_ids, tiles_x, slots):
    """(pixel, Gaussian) pairs inside alpha_at's box |px - mx| <= r,
    |py - my| <= r among the slots each (row, s) walks. mx, my, r
    (T, S, cap); slots (T, S). The box is separable: per Gaussian, the
    pixel columns in reach times the rows in reach."""
    t = tile_ids.long()
    x0 = ((t % tiles_x) * TILE).float()[:, None, None] + 0.5
    y0 = ((t // tiles_x) * TILE).float()[:, None, None] + 0.5
    nx = sum(((x0 + i) - mx).abs() <= r for i in range(TILE))
    ny = sum(((y0 + i) - my).abs() <= r for i in range(TILE))
    walked = torch.arange(mx.shape[-1], device=mx.device) < slots[..., None]
    return int((nx * ny * walked).sum())


def call_work(kind, dyn, tile_ids, tiles_x, nchan, payload_floats, work,
              out_floats):
    """One compositor call. ``dyn`` (T, S, >=6, cap) holds rows [mx, my,
    a, b, c, r]; ``payload_floats`` = (per (row, s) and slot, per row and
    slot) floats read; ``work`` the twin's {pairs, live, slots}."""
    slots = work["slots"]
    boxed = box_pairs(dyn[:, :, 0], dyn[:, :, 1], dyn[:, :, 5], tile_ids,
                      tiles_x, slots)
    tests = OPS_BOX * int(slots.sum()) * NWARPS
    live = work["live"]
    per_rs, per_row = payload_floats
    payload = F32 * (float(slots.sum()) * per_rs
                     + float(slots.amax(1).sum()) * per_row)
    out = F32 * out_floats
    return CallWork(
        kind,
        {"fwd": OPS_PAIR * boxed + tests + (2 * nchan + 3) * live,
         "bwd": OPS_PAIR * boxed + tests + (4 * nchan + 36) * live},
        # the backward reads the payload, the outputs and their
        # cotangents, and writes the payload's gradient
        {"fwd": payload + out, "bwd": 2 * payload + 2 * out})


@contextlib.contextmanager
def recording(rasterize):
    """Record the reference compositors' calls (``rasterize`` is the
    reference's ops.rasterize) as CallWork while the block runs."""
    calls = []
    saved = dict(rasterize._COMPOSITORS)

    def window(dyn, st, counts, tile_ids, tiles_x, nchan, depth_in_dyn):
        acc, tf, w = saved["window"][0](dyn, st, counts, tile_ids, tiles_x,
                                        nchan, depth_in_dyn, True)
        T, S, Fd, _ = dyn.shape
        calls.append(call_work("window", dyn, tile_ids, tiles_x, nchan,
                               (Fd, st.shape[1]), w,
                               acc.numel() + tf.numel()))
        return acc, tf

    def dense(table, idx, counts, tiles_x, nchan):
        acc, tf, w = saved["dense"][0](table, idx, counts, tiles_x, nchan,
                                       True)
        dyn, _, ids = rasterize._dense_as_window(table, idx, nchan)
        # a walked slot reads its index and its table row
        calls.append(call_work("dense", dyn, ids, tiles_x, nchan,
                               (table.shape[1] + 1, 0), w,
                               acc.numel() + tf.numel()))
        return acc, tf

    rasterize._COMPOSITORS["window"] = (window, saved["window"][1])
    rasterize._COMPOSITORS["dense"] = (dense, saved["dense"][1])
    try:
        yield calls
    finally:
        rasterize._COMPOSITORS.clear()
        rasterize._COMPOSITORS.update(saved)


def _conv(cin, cout, k, pixels):
    return 2.0 * k * k * cin * cout * pixels


def pwcnet_ops(pw, H, W, pairs):
    """Operations of PWC-Net on ``pairs`` image pairs of (H, W), from the
    configuration's layer widths ``pw``: both pyramids, the cost volumes,
    the decoders from the coarsest level to level 2 with their upsampling
    and warps, and the refiner."""
    m = pw["input_multiple"]
    Hp, Wp = math.ceil(H / m) * m, math.ceil(W / m) * m
    px = lambda level: (Hp >> level) * (Wp >> level)
    ext = pw["extractor"]
    pyramid = sum(_conv(cin, cout, 3, px(i + 1))
                  + 2 * _conv(cout, cout, 3, px(i + 1))
                  for i, (cin, cout) in enumerate(ext))
    n_corr = (2 * pw["corr_radius"] + 1) ** 2
    outs = pw["decoder_convs"]
    feat_out = sum(outs[:-1])
    ops = 2 * pyramid  # per pair: both images
    prev_cur = None
    for level in pw["levels"]:
        C = ext[level - 1][1]
        n = px(level)
        ops += 2.0 * n_corr * C * n  # cost volume: a product and a sum
        cur = n_corr if prev_cur is None else n_corr + C + 4
        if prev_cur is not None:
            n_in = px(level + 1)
            ops += _conv(2, 2, 4, n_in)  # flow upsampling
            ops += _conv(prev_cur + feat_out, 2, 4, n_in)  # feature upsampling
            ops += 8.0 * (C + 1) * n  # bilinear warp of the second features
        cin = cur
        for cout in outs:
            ops += _conv(cin, cout, 3, n)
            cin += cout
        prev_cur = cur
    ops += sum(_conv(cin, cout, 3, px(pw["levels"][-1]))
               for cin, cout, _ in pw["refiner"])
    return pairs * ops


def other_ops(cfg, traffic, n_params):
    """Operations of a step other than compositing and PWC-Net, from
    shapes: deformation and projection of every render, the losses, Adam.
    Forward and backward (BACKWARD_FACTOR) where the step differentiates."""
    W, H = cfg["frame"]["width"], cfg["frame"]["height"]
    S, K = cfg["num_exposure"], cfg["num_motion_bases"]
    n_fg, n_bg = cfg["num_fg"], cfg["num_bg"]
    Bt = traffic["track_targets"]
    br = traffic["branches"]
    fwd = 0.0
    pix = H * W
    if br["has_static"]:  # bg only, S views
        fwd += S * n_bg * PROJECT_OPS + pix * (SSIM_OPS + DILATE_OPS
                                               + 3 * L1_OPS)
    if br["has_dynamic"]:  # every Gaussian, S views, tracks at Bt times
        deform = n_fg * (K * DEFORM_OPS_BASIS + DEFORM_OPS)
        fwd += (S + Bt + 3) * deform + S * (n_fg + n_bg) * PROJECT_OPS
        fwd += pix * (2 * SSIM_OPS + DILATE_OPS + 6 * L1_OPS)
    if br["has_reg"]:  # bg only, one sharp view
        fwd += n_bg * PROJECT_OPS + pix * (SSIM_OPS + DILATE_OPS + L1_OPS)
    return BACKWARD_FACTOR * fwd + ADAM_OPS * n_params


def flow_ops(cfg, traffic):
    """PWC-Net on the step's 2 (S - 1) sub-frame pairs (run without
    gradient) and the differentiated warp of the aligned renders."""
    if not traffic["flow_term"]:
        return 0.0
    W, H = cfg["frame"]["width"], cfg["frame"]["height"]
    pairs = 2 * (cfg["num_exposure"] - 1)
    warp = BACKWARD_FACTOR * 8.0 * 4 * H * W * pairs
    return pwcnet_ops(cfg["pwcnet"], H, W, pairs) + warp
