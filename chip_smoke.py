"""On-GPU smoke run of the PyTorch port (deblur4dgs_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100 / sm_90a) and nvcc. It builds the port's CUDA
kernels from deblur4dgs_tpu_torch/csrc (one nvcc per source, all started
together), then:

  1. prints the card (nvidia-smi name, power limit), torch / CUDA versions,
     the kernel build time + ptxas register and spill report, and for each
     window kernel instance (exact at nchan 5 and 11, generic up to 32) and
     dense kernel instance (exact at D 4 and 5, generic up to 16) its
     registers, local (spill) bytes, shared memory and most resident blocks
     per SM (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMulti-
     processor; also in the kernels line under "instances"); fails if a
     dense instance spills;
  2. holds each kernel against its plain twin on random inputs at capacities
     128, 256, 512 and 1024 (K5 also at the pipeline's 2048 and 4096, at
     D 3, 4 and 5), with an empty row and rows that saturate in
     their first chunk: the window kernels (K1, K2/K3) at S=11, nchan 11
     (the dynamic window) and nchan 5 (the static windows); the dense
     kernels (K5, reading a per-Gaussian table by index) at D=4, D=5 and
     the generic D=3 and 8, with one Gaussian in several rows, sentinel
     tails, counts over the capacity and dropped pairs (indexed_case; the
     backward on the per-slot and on the per-Gaussian gradient, phase a);
     the split path (K4, the window kernels at S=1) at nchan 11 and 5
     (phase b); then the window kernels on edge_bucket inputs built to
     break an inexact per-warp cull (means at exactly r from a warp's
     nearest pixel centre or one ulp beyond, r = 0 and r far beyond the
     tile, means on warp boundaries, counts that are not multiples of 128,
     sub-frames stopping at different chunks) at nchan 11 and 5 through
     K1/K2, K4 and K6, and the generic instance at nchan 3 and 8
     (phase_edge); the dense kernels on the same edge cases at D 4, 5 and
     8, and at caps 2048 and 4096 at D 3, 4 and 5 (phase_edge_dense);
  3. drives the port's dynamic train step at the full bench.py shape
     (1280x720, 40k fg + 60k bg Gaussians, S=11, tile cap 1024; the scene,
     batch and tracks drawn from numpy default_rng(0) exactly as bench.py
     builds them; MoveModel weights from torch.Generator seed 0): one
     warm-up step, then timed steps with the launch counters zeroed just
     before and read just after (4 forward + 4 backward window launches per
     step); holds the window kernels against their twins on that step's
     inputs (first 64 rows of every bucket); then the same step with
     RenderConfig.camera_mode 'cubic' (phase_bench_cubic), timed;
  4. drives the stage-2 step (static + dynamic + static-reg branches and
     the multires guide) at the same shape (phase c): the static batch is
     B=3 frames (ts 4/5/6), the reg batch the dynamic frame with random
     target images, batch4_imgs (1, 180, 320, 3), all drawn from the same
     generator after bench.py's draws (the static and reg batches get a
     rectangular fg mask: bench.py's scattered random mask dilates to the
     whole image and would leave the bg-only branches no gradient). One
     warm-up step, 5 timed steps with counters zeroed (16 window launches
     per direction per step: 4 windows x 4 buckets; 1 dense), a 2-step
     profile (which must show the 16 window gathers' backward and none of
     a dense payload gather), and one step's recorded inputs: the window
     kernels on its 16 calls (first 64 rows of each) and K5 on its whole
     static-reg call (per-slot and per-Gaussian gradient), held against
     their twins and timed with them; the kernels line reports these
     times, and for K5 also the function's: the table build + forward
     kernel, the backward kernel + per-Gaussian reduction. On the same 16
     calls, the share of (warp, Gaussian) iterations the kernels' per-warp
     cull removes (ops/rasterize.py::warp_reach), printed before the
     kernels line;
  5. drives the stage-1 step (the static branch alone, stage 'first') at
     the same shape and static batch: one warm-up step, 5 timed steps,
     3 windows x 4 buckets window launches per direction per step, and a
     2-step profile;
  6. runs two train steps of small scenes on the card and on the CPU (the
     CPU path is the one tests/test_torch_*.py hold against the JAX
     package) and compares losses and aux values (phase d): the dynamic
     step at 128x128; the stage-2 step at 128x128 (windows through K1/K2,
     reg through K5) and at 64x48 (windows through K4, with S x 4 split
     launches per direction per step, reg through K5); the stage-1 step at
     64x48 (S x 3 split launches); the dynamic step at 128x128 with the
     'cubic' camera; K4 is timed and held against its twin on the 64x48
     stage-2 run's inputs;
  7. the scatter-output window compositor K6 (the port's D4_SCATTER
     path, ops/rasterize.py::_USE_SCATTER, set for these phases and
     restored): K6 against its twins on random buckets (caps 128-1024,
     nchan 11 and 5, pad rows on the trash row); the dynamic step with
     the flag off, on, on, off; the stage-2 step through K6 (16 scatter
     launches per direction per step, none of K1/K2) and K6 on one
     step's 16 recorded calls, against its twins and timed (the kernels
     line's K6 times);
  8. the training lifecycle at the bench shape, through K6
     (phase_lifecycle): tracks and static points from the bench scene,
     the port's init on the card (Procrustes for 10 bases x 24 frames,
     1000 initial-optim iterations), padding to the pipeline's
     capacities, a stage-2 TrainLoop of 8 steps whose density control
     densifies and culls three times and resets the opacities once
     (alive counts, new-slot moments, event times printed and checked;
     launch counts exact), and a bit-exact checkpoint round trip;
  9. the 128x128 stage-2 loop with a densify event on the card and on the
     CPU (losses within 1e-5, equal alive masks), and on the card, under
     torch.use_deterministic_algorithms, 2 steps + checkpoint + load + 2
     steps against 4 steps straight, bit for bit;
 10. the validator's pose refinement of a 64x48 seeded scene, 50
     iterations on the card (K5) and on the CPU from the same perturbed
     camera, for two perturbations: every iteration's loss and the
     refined w2c (phase_pose_small_vs_cpu);
 11. the evaluation path at full width (phase_eval): the port's synthetic
     1280x720 dataset (make_scene at the bench's 40k fg + 60k bg, 6
     frames, generate_dataset with 11 blur samples through K5), the
     ground-truth SceneModel, and two val frames validated with cap 1024
     and S=11: validate_frame at the true pose, and
     validate_frame_with_pose_opt for the reference's 500 iterations from
     a perturbed camera (POSE_ROT_Y, POSE_SHIFT) with the port's
     torch-seeded LPIPS; exact K5 launch counts, falling losses, a
     refined PSNR above the start's, finite metrics; K5 (D=3, the generic
     instance) held against its twin and timed on the refinement's first
     call; ms per iteration (CUDA events between the renders), and
     PROF_ITERS iterations under the profiler (20 less 10). Its numbers
     go to a {"eval": {...}} line;
 12. (after the kernel phases of 2) the window kernels at the pipeline's
     capacities and exposure counts (phase_big_caps): caps 2048 and 4096
     (the quality runs' tile_cap, phase A's min(4 * cap, 4096)), S = 3, 5
     and 9, nchan 11 and 5, random (deep rows) and edge_bucket cases, and
     the split path (K4) at the same caps;
 13. the port's CLI end to end at full width (phase_pipeline):
     ``train --synthetic --high-res`` at 1280x720 in-process
     (pipe_args(): the CLI's 40k fg / 100k bg, S = 11, cap 1024 and so
     4096 in phase A, over a synthetic scene of as many Gaussians; depth
     cut by PIPE_CUTS), with the CLI's stage_callback marking each stage's
     end for its wall time and exact launches, and the logged scalars
     (--log-every 1) giving its step times and phase A's tile_overflow; the
     checkpoints, metrics.json, the test PNGs through vis/png.py, and
     stage 1's scene unchanged by stage 2; then a second call on the same
     work dir, which restores every stage, launches no window kernel and
     reproduces metrics.json ({"pipeline": ...} line); the first call
     writes the train videos at the CLI's --save-videos-every (animated
     PNGs under results/videos, checked to decode);
 14. the viewer (phase_viewer) on phase_pipeline's last window
     checkpoint (the CLI's capacities, 1280x720): the CLI's render-path
     over 4 keyframes with times, 24 path frames (an animated PNG that
     decodes to 24 frames; exactly 24 K5 forward launches and no other
     kernel; ms per frame and K5's device time per frame); one path frame
     at 512x288 on the card against the CPU twin (FWD_TOL); a DynamicViewer
     on port 0 whose /render PNGs (posed, canonical, with tracks) equal
     render_fn's frames byte for byte, its request latency; a 64x48
     stage-2 TrainLoop with a TrainingViewer and a client thread POSTing
     renders, equal bit for bit to the loop without a viewer
     ({"viewer": ...} line);
 15. the exposure-consistency term (phase_flow): the torch-seeded PWC-Net
     on a 720p pair, card against CPU (flow, warp, mask); two 64x48
     stage-2 steps with flow_fn, card against CPU; the bench-shape
     stage-2 step with flow_fn, timed beside phase c's, profiled (top
     kernels), and the PWC-Net's forward and correlations alone at its
     shapes ({"flow": ...}).
 16. the plain path (phase_plain_path): render(use_pallas=False), the
     reference's plain compositors without the early stop, against the
     kernels on the card (the bucketed window and the sharp dense render
     at 128x128, the split path at 64x48): values and gradients within
     FWD_TOL / BWD_TOL, no kernel launched on the plain path;
 13b. the user's entry point for a real scene (phase_stereo):
     ``train --data-dir --high-res`` at 1280x720 in-process on a scene
     the phase writes in the Shape-of-Motion layout (phase_pipeline's
     synthetic scene over 16 frames: PNG frames and masks through
     vis/png.py, inverse depths, the 40k tracks split between the 8
     train frames as query frames, 2d_tracks/{a}_{b}.npy for every pair
     of them, COLMAP binaries; the sharp frames in a ground-truth
     directory), every PNG read back equal;
     pipe_args()'s widths and PIPE_CUTS; stage wall times, step medians
     and exact launches per stage (K1, K2/K3 and K5; 16 val frames), the
     checkpoints, the test PNGs, a finite metrics.json; ``metrics
     --gt-dir`` on the card against the CPU (1e-5 relative); then
     sample_initial_bases_centers(mode="hdbscan") on the bench tracks
     (40k x 69) on the card, timed, and card against CPU on 4k of them
     (labels and the mutual-reachability matrix bit for bit) and on 4k
     seeded blob points (labels) ({"stereo": ...} line);
 17. multiple devices (phase_multidevice): the bench-shape stage-2 step
     on several ranks (parallel/mesh.py), each rank a process of this
     script (``--multidevice-rank``): one rank per card over NCCL where
     two or more cards are visible, else two ranks on card 0 over gloo
     (all-reduce of CUDA tensors, all-gather staged through host memory;
     NCCL refuses two ranks on one device); tile_mesh and
     subframe_sharding (6 + 5 sub-frames) each held to its one-rank
     reference, run by a one-rank NCCL job (the unsharded step; the step
     subframe-sharded over one rank): the loss to rel 1e-4, every
     parameter to 5e-4 of its max |param|, the ranks' TrainStates equal
     bit for bit, each rank's launches exact; per-rank step medians and
     the transport ({"multidevice": ...} line).

Bounds count what the run's data needs: of each payload only the slots
walked before each row's stop chunk (for K5: those slots' index entries
and, once, the table rows they name; its backward writes the per-slot
gradient of the slots below each count), and alpha only for the (pixel,
Gaussian) pairs inside alpha_at's box, plus a box test per Gaussian and
block of 32 pixels (OPS_BOX); each kernel's "bound_ms_every_pair" charges
alpha to every pair up to the stop chunks instead.

Prints a {"kernels": [...]} JSON line (each kernel's ``launches`` on
its own driven path, ``launches_pipeline`` in phase_pipeline's first
call, ``launches_stereo`` in phase_stereo's call,
``launches_multidevice_per_rank`` in phase_multidevice's compared
steps and, for K5, ``launches_render_path`` in phase_viewer's
render-path call), the step times, {"eval": ...}, {"pipeline": ...},
{"stereo": ...}, {"viewer": ...}, {"flow": ...} and {"multidevice": ...,
"plain_path": ...} JSON lines, the card line, and last {"ok": true,
"device": {...}}.
Any failed check raises (exit != 0).
Exits non-zero without a result when no CUDA card is visible or when the
package is not next to this file. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Bench shape (bench.py:37-47, 50-147).
W, H = 1280, 720
NUM_FG, NUM_BG = 40_000, 60_000
NUM_EXPOSURE = 11
TILE_CAP = 1024
TILE = 16  # pixels per tile side (the compositors' tiles are 16x16)
NUM_FRAMES = 24
TIMED_STEPS = 5
EPOCH = 25  # > 20: the pose-net gate and the multires guide are on
DEV = "cuda"
# Kernel-vs-twin bars (float32 reassociation: per-pixel sums of up to 1024
# terms in another order; gst summed over S in another order).
FWD_TOL = 2e-4  # max |kernel - twin| / max(1, max |twin|)
BWD_TOL = 2e-3  # max |kernel - twin| / max |twin|
# The 64x48 pose refinement on the card vs the CPU (phase_pose_small_vs_cpu):
# the losses agree to float32 reassociation until Adam's normalised steps
# carry the renders' differences into the pose; near the minimum (a loss of
# ~3.5e-4 from ~2.5e-2) the relative difference grows, so the bar over all
# iterations is absolute. NVIDIA H100 80GB HBM3, 700 W, the same on three
# runs in one call: relative 6.4e-7 / 1.0e-6 at iteration 9, absolute at
# most 1.85e-5 / 3.5e-6 over 50, refined w2c 2.9e-5 / 5.5e-6 apart (the
# two starts of POSE_SMALL_OFFSETS).
POSE_LOSS_REL_EARLY = 1e-5  # per-iteration loss, relative, iterations 0-9
POSE_LOSS_ABS = 5e-5  # per-iteration loss, absolute, all iterations
POSE_W2C_ATOL = 1e-4  # refined w2c
# phase_pipeline's resumed CLI call against its first: the metrics.json
# values (the same checkpoints, data and pose refinement on one card; bit
# for bit on two calls, NVIDIA H100 80GB HBM3, 700 W)
PIPE_RESUME_ATOL = 0.0
# Card rates for bounds (NVIDIA data sheets; dense FP32 outside the tensor
# cores, HBM bandwidth), keyed by a substring of the nvidia-smi name.
CARD_RATES = {  # name key: (bytes/s, fp32 flop/s)
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),  # SXM5 80GB HBM3
}
# Operations per (pixel, Gaussian) pair, counted from the kernels' code
# (the same per-pair code in all of them): alpha evaluation ~20 (offsets,
# conic quadratic, exp, box/cutoff tests); a live pair adds 2*nchan + 3 in
# the forward (weight, channel FMAs, transmittance), 4*nchan + 36 in the
# backward (sdot, channel grads, prefix/suffix, alpha/conic/mean/opacity
# grads, one add per reduced value).
OPS_PAIR = 20
# The least work needs alpha only where alpha_at's box test |px - mx| <= r,
# |py - my| <= r holds: a pair outside it is dead. Finding those pairs takes
# a box test (two rounded offsets, two compares) per Gaussian and block of
# 32 pixels; bound_ms counts that and OPS_PAIR per pair inside the box.
# bound_ms_every_pair counts OPS_PAIR for every pair up to the stop chunks.
OPS_BOX = 4
# Per port kernel: the TPU kernel it replaces (line in
# deblur4dgs_tpu/ops/rasterize.py, function) and its source in the port.
KERNEL_INFO = {
    "window_fwd": (989, "_fwd_kernel_window", "window_composite.cu",
                   "window_fwd_kernel"),
    "window_bwd": (1220, "_bwd_kernel_window_sgrid; also K3 "
                   "_bwd_kernel_window :1049", "window_composite.cu",
                   "window_bwd_kernel"),
    "dense_fwd": (160, "_fwd_kernel", "dense_composite.cu",
                  "dense_fwd_kernel"),
    "dense_bwd": (207, "_bwd_kernel / _bwd_one_tile :221",
                  "dense_composite.cu", "dense_bwd_kernel"),
    "split_fwd": (548, "_fwd_kernel_split", "window_composite.cu",
                  "window_fwd_kernel at S=1"),
    "split_bwd": (608, "_bwd_kernel_split", "window_composite.cu",
                  "window_bwd_kernel at S=1"),
    "window_scatter_fwd": (1561, "_fwd_kernel_window_scatter",
                           "window_composite.cu",
                           "window_fwd_kernel with the row map"),
    "window_scatter_bwd": (1643, "_composite_bwd_window_scatter (the K2 "
                           "body at image rows sids[t])",
                           "window_composite.cu",
                           "window_bwd_kernel with the row map"),
}
# The pipeline's tile capacities beyond the bench's 1024: the quality
# runs' tile_cap (scripts/tpu_quality_regression.py:238) and phase A's
# min(4 * tile_cap, 4096) (pipeline.py:163-167), which the validator and
# the sharp renders inherit.
BIG_CAPS = (2048, 4096)
SCATTER_T_IMG = 256  # image tiles of the random K6 cases' shared buffer
LIFE_BASES = 10  # the lifecycle phase's motion bases (pipeline default)
LIFE_START = 72  # its loop's first step (see phase_lifecycle)
LIFE_STEPS = 8


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def card_rates(name):
    for key, rates in CARD_RATES.items():
        if key in name:
            return rates
    print(f"# unknown card {name!r}: bounds use H100 SXM rates",
          file=sys.stderr)
    return CARD_RATES["H100"]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """cuda_ms with the reps calls queued behind a sleeping kernel, so that
    the card runs their kernels back to back: the device time of fn(),
    without the gaps in which the card waits for the host's launches
    (which dominate calls of a few tens of microseconds). The sleep lasts
    longer than queueing the calls takes (cycles counted at 2 GHz, above
    the card's clock)."""
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def input_bytes(fa, slots):
    """Bytes of a compositor call's inputs ``fa`` that its kernels must
    read: of each float payload (..., F, cap) only the slots walked before
    the stop chunk (``slots`` (T, S) from the twin's work): a per-sub-frame
    payload (T, S, F, cap) per (row, s), a row payload (T, F, cap) once per
    row as far as the row's furthest sub-frame; counts and tile ids whole.
    A row's sentinel tail is never read."""
    per_rs, per_row = float(slots.sum()), float(slots.amax(1).sum())
    total = 0.0
    for x in fa:
        if not torch.is_tensor(x):
            continue
        if x.is_floating_point():
            walked = per_rs if x.dim() == 4 else per_row
            total += walked * x.shape[-2] * x.element_size()
        else:
            total += nbytes(x)
    return total


def zero_launches(tr):
    for k in tr.LAUNCHES:
        tr.LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def random_bucket(seed, T, S, nchan, cap, tiles_x, n_tiles, dev, depth=True):
    """Random window-compositor inputs in the packing layout (slots past a
    row's count are zero sentinel rows). Row 0 is empty; rows 1-8 hold wide
    opaque Gaussians and saturate in their first chunk. ``depth``: the last
    channel is dyn's depth row (else all nchan channels are static)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n_tiles)[:T].astype(np.int32)
    n_static = nchan - int(depth)
    dyn = np.zeros((T, S, 6 + int(depth), cap), np.float32)
    tx = (ids % tiles_x) * 16.0
    ty = (ids // tiles_x) * 16.0
    bx = tx[:, None] + rng.uniform(-4, 20, (T, cap))
    by = ty[:, None] + rng.uniform(-4, 20, (T, cap))
    for s in range(S):
        dyn[:, s, 0] = bx + 0.4 * s + rng.uniform(-1, 1, (T, cap))
        dyn[:, s, 1] = by + rng.uniform(-1, 1, (T, cap))
        dyn[:, s, 2] = rng.uniform(0.02, 0.5, (T, cap))
        dyn[:, s, 3] = rng.uniform(-0.01, 0.01, (T, cap))
        dyn[:, s, 4] = rng.uniform(0.02, 0.5, (T, cap))
        dyn[:, s, 5] = rng.uniform(3, 30, (T, cap)).round()
        if depth:
            dyn[:, s, 6] = rng.uniform(1.0, 9.0, (T, cap))
    st = np.concatenate(
        [rng.uniform(0.05, 0.9, (T, 1, cap)),
         rng.normal(size=(T, n_static, cap))], 1).astype(np.float32)
    dyn[1:9, :, 2:5] *= 0.02
    st[1:9, 0] = 0.98
    counts = rng.integers(1, cap + 1, T).astype(np.int32)
    counts[0] = 0
    counts[1:9] = cap
    live = (np.arange(cap)[None] < counts[:, None]).astype(np.float32)
    dyn *= live[:, None, None]
    st *= live[:, None]
    t = lambda x: torch.as_tensor(x, device=dev)
    return t(dyn), t(st), t(counts), t(ids)


EDGE_COUNTS = (1, 31, 33, 127, 129, 200, 255, 257, 383, 511, 1000, 1024)


def edge_bucket(seed, T, S, nchan, cap, tiles_x, n_tiles, dev):
    """Window inputs built to break an inexact per-warp cull (the kernels'
    warp_reaches): flat Gaussians (alpha = opacity wherever the box test
    holds) whose means sit so that |px - mx| or |py - my| equals r exactly
    at a warp's nearest pixel centre, or one ulp beyond; r = 0 on and off a
    pixel centre; r far beyond the tile; means on warp boundaries (x = 8,
    y = 4k inside the tile); counts that are not multiples of 128 (row 0
    empty). In the odd rows sub-frame s saturates in chunk s % nchunks, so
    the sub-frames stop at different chunks. Last channel = dyn's depth."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n_tiles)[:T].astype(np.int32)
    tx = ((ids % tiles_x) * 16).astype(np.float32)[:, None]
    ty = ((ids // tiles_x) * 16).astype(np.float32)[:, None]
    f32 = np.float32
    dyn = np.zeros((T, S, 7, cap), f32)
    for s in range(S):
        w = rng.integers(0, 8, (T, cap))  # the warp each Gaussian aims at
        xlo = tx + (w % 2) * 8 + 0.5
        ylo = ty + (w // 2) * 4 + 0.5
        r = rng.integers(0, 13, (T, cap)).astype(f32)
        kind = rng.integers(0, 6, (T, cap))
        side = rng.choice([-1.0, 1.0], (T, cap)).astype(f32)
        ulp = rng.random((T, cap)) < 0.3  # one ulp beyond the edge: dead
        x_edge = np.where(side > 0, xlo + 7, xlo) + side * r
        y_edge = np.where(side > 0, ylo + 3, ylo) + side * r
        x_in = xlo + rng.integers(0, 8, (T, cap))
        y_in = ylo + rng.integers(0, 4, (T, cap))
        mx = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                       [x_edge, x_in, x_in + rng.choice([0.0, 0.25], (T, cap)),
                        tx + 8], tx + rng.uniform(-30, 46, (T, cap)))
        my = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                       [y_in, y_edge, y_in, ty + 4 * rng.integers(0, 5, (T, cap))],
                       ty + rng.uniform(-30, 46, (T, cap)))
        mx, my = mx.astype(f32), my.astype(f32)
        mx = np.where(ulp & (kind == 0),
                      np.nextafter(mx, side * f32(np.inf)), mx)
        my = np.where(ulp & (kind == 1),
                      np.nextafter(my, side * f32(np.inf)), my)
        r = np.where(kind == 2, 0.0, np.where(kind == 4, 1e4, r))
        dyn[:, s, 0], dyn[:, s, 1], dyn[:, s, 5] = mx, my, r
        dyn[:, s, 2] = dyn[:, s, 4] = 1e-4  # flat: alpha ~ opacity
        dyn[:, s, 6] = rng.uniform(1.0, 9.0, (T, cap))
    st = np.concatenate([rng.uniform(0.02, 0.12, (T, 1, cap)),
                         rng.normal(size=(T, nchan - 1, cap))], 1).astype(f32)
    nchunks = cap // 128
    ks = [(s % nchunks) * 128 for s in range(S)]
    for t in range(1, T, 2):  # saturators: 32 wide opaque Gaussians at k,
        for k in set(ks):     # dead (r = 0, off-centre) ...
            dyn[t, :, 5, k : k + 32] = 0.0
            dyn[t, :, 0, k : k + 32] = tx[t] - 0.25
            st[t, 0, k : k + 32] = 0.95
        for s, k in enumerate(ks):  # ... except in sub-frame s
            dyn[t, s, 5, k : k + 32] = 1e4
            dyn[t, s, 0, k : k + 32] = tx[t] + 3.0
    counts = np.array([0] + [c for c in EDGE_COUNTS if c <= cap] * T,
                      np.int32)[:T]
    counts[1::2] = cap  # the saturating rows run to their stop chunks
    live = (np.arange(cap)[None] < counts[:, None]).astype(f32)
    dyn *= live[:, None, None]
    st *= live[:, None]
    t_ = lambda x: torch.as_tensor(x, device=dev)
    return t_(dyn), t_(st), t_(counts), t_(ids)


def random_dense(seed, T, nchan, cap, tiles_x):
    """Random dense (K5) rows, numpy: row t holds Gaussians around image
    tile t, (T, 7 + D, cap) rows [mx, my, a, b, c, op, r, channels]. Row 0
    is empty; rows 1-8 hold wide opaque Gaussians and saturate in their
    first chunk; rows 9-12 count cap + 100 (over the capacity, which the
    kernels and twins clamp to)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((T, 7 + nchan, cap), np.float32)
    t = np.arange(T)
    data[:, 0] = (t % tiles_x)[:, None] * 16.0 + rng.uniform(-4, 20, (T, cap))
    data[:, 1] = (t // tiles_x)[:, None] * 16.0 + rng.uniform(-4, 20,
                                                               (T, cap))
    data[:, 2] = rng.uniform(0.02, 0.5, (T, cap))
    data[:, 3] = rng.uniform(-0.01, 0.01, (T, cap))
    data[:, 4] = rng.uniform(0.02, 0.5, (T, cap))
    data[:, 5] = rng.uniform(0.05, 0.9, (T, cap))
    data[:, 6] = rng.uniform(3, 30, (T, cap)).round()
    data[:, 7:] = rng.normal(size=(T, nchan, cap))
    data[1:9, 2:5] *= 0.02
    data[1:9, 5] = 0.98
    counts = rng.integers(1, cap + 1, T).astype(np.int32)
    counts[0] = 0
    counts[1:9] = cap
    counts[9:13] = cap + 100
    data *= (np.arange(cap)[None] < counts[:, None])[:, None]
    return data, counts


def edge_dense(seed, T, nchan, cap, tiles_x):
    """edge_bucket's rows (S = 1, the last channel its depth row) as dense
    (K5) rows, numpy: with n_tiles = T its tile ids are a permutation, so
    sorting the rows by tile id puts image tile t in row t."""
    dyn, st, counts, ids = (x.cpu().numpy() for x in edge_bucket(
        seed, T, 1, nchan, cap, tiles_x, T, "cpu"))
    rows = np.argsort(ids)
    d = dyn[rows, 0]  # (T, 7, cap) [mx, my, a, b, c, r, depth]
    data = np.concatenate([d[:, :5], st[rows, :1], d[:, 5:6], st[rows, 1:],
                           d[:, 6:7]], axis=1)
    return data, counts[rows]


def indexed_case(data, counts, seed, dev, keep_rows=13):
    """A dense (K5) case (numpy rows (T, 7 + D, cap), counts) in the indexed
    form on ``dev``: ((table, idx, counts), slot_map). The table holds every
    slot's row (T * cap rows, padded to Fp columns) and the zero sentinel
    G; a slot below its row's count names its own row, or, for a quarter
    of the slots of the rows from ``keep_rows`` on, the row of a random live
    slot (one Gaussian in several tile rows); slots past the count name the
    sentinel (sentinel tails). Rows no slot names stay in the table.
    slot_map lists each table row's slots in order, the sink slot T * cap
    after them (as a dropped pair names it)."""
    T, F, cap = data.shape
    n = T * cap
    rng = np.random.default_rng(seed)
    live = np.arange(cap)[None] < np.minimum(counts, cap)[:, None]
    src = np.arange(n).reshape(T, cap)
    dup = live & (rng.random((T, cap)) < 0.25)
    dup[:keep_rows] = False
    src[dup] = rng.choice(np.flatnonzero(live), int(dup.sum()))
    idx = np.where(live, src, n).astype(np.int32)
    Fp = -(-F // 4) * 4
    table = np.zeros((n + 1, Fp), np.float32)
    table[:n, :F] = data.transpose(0, 2, 1).reshape(n, F)
    slots = np.flatnonzero(live)  # in slot order
    names = src.reshape(-1)[slots]
    order = np.argsort(names, kind="stable")
    mult = np.bincount(names, minlength=n)
    MT = int(mult.max()) + 1  # at least one sink per row
    first = np.concatenate([[0], np.cumsum(mult)[:-1]])
    slot_map = np.full((n, MT), n, np.int32)
    srt = names[order]
    slot_map[srt, np.arange(len(srt)) - first[srt]] = slots[order]
    t = lambda x: torch.as_tensor(x, device=dev)
    return (t(table), t(idx), t(counts)), t(slot_map)


def rect_masks(rng, B):
    """(B, H, W) fg masks: one (H/4, W/4) rectangle at a random place."""
    m = np.zeros((B, H, W), np.float32)
    for b in range(B):
        y0, x0 = rng.integers(0, H // 2), rng.integers(0, W // 2)
        m[b, y0 : y0 + H // 4, x0 : x0 + W // 4] = 1.0
    return m


# The train steps driven: make_train_step's stage and branch flags.
STEP_KINDS = {
    "dynamic": dict(stage="second", has_dynamic=True),  # bench.py's step
    "stage2": dict(stage="second", has_static=True, has_dynamic=True,
                   has_reg=True, has_batch4=True),  # pipeline.py:500-508
    "stage1": dict(stage="first", has_static=True),  # pipeline.py:435-441
}


def step_args(kind, static, dyn, tracks, reg, b4):
    """The step's batch arguments, None for the branches it lacks."""
    f = STEP_KINDS[kind]
    return (static if f.get("has_static") else None,
            dyn if f.get("has_dynamic") else None,
            tracks if f.get("has_dynamic") else None,
            reg if f.get("has_reg") else None,
            b4 if f.get("has_batch4") else None)


def make_step(kind, scene, T, rcfg, flow_fn=None, **shard):
    """(state, step) of ``kind``; ``shard``: make_train_step's
    subframe_sharding / tile_mesh."""
    from deblur4dgs_tpu_torch.configs import (
        LossesConfig, OptimizerConfig, SceneLRConfig)
    from deblur4dgs_tpu_torch.train.optimizers import make_optimizer
    from deblur4dgs_tpu_torch.train.trainer import (
        init_train_state, make_train_step)

    lr, ocfg = SceneLRConfig(), OptimizerConfig()
    flags = {k: STEP_KINDS[kind].get(k, False)
             for k in ("has_static", "has_dynamic", "has_reg", "has_batch4")}
    stage = STEP_KINDS[kind]["stage"]
    return (init_train_state(scene, lr, ocfg),
            make_train_step(make_optimizer(scene, lr, ocfg), LossesConfig(),
                            rcfg, stage, T, flow_fn=flow_fn, **flags,
                            **shard))


def bench_scene_batches(dev):
    """bench.py's scene, batch and tracks, drawn in the same order, then the
    static batch, the reg batch and the multires guide: (scene, (static,
    dyn, tracks, reg, batch4))."""
    from deblur4dgs_tpu_torch.models.gaussians import Gaussians
    from deblur4dgs_tpu_torch.models.motion_bases import MotionBases
    from deblur4dgs_tpu_torch.models.move_model import init_move_model
    from deblur4dgs_tpu_torch.models.scene import SceneModel
    from deblur4dgs_tpu_torch.train.trainer import FrameBatch, TrackBatch

    rng = np.random.default_rng(0)
    f32 = np.float32
    t = lambda x: torch.as_tensor(np.asarray(x), device=dev)

    def gauss(n, coefs=None, spread=1.0, z=(2.0, 8.0)):
        means = rng.uniform(-spread, spread, (n, 3)).astype(f32)
        means[:, 2] = rng.uniform(*z, n)
        quats = rng.normal(size=(n, 4)).astype(f32)
        scales = rng.uniform(-5.5, -3.5, (n, 3)).astype(f32)
        colors = rng.normal(size=(n, 3)).astype(f32)
        mc = rng.normal(size=(n, 16)).astype(f32) if coefs else None
        return Gaussians(t(means), t(quats), t(scales), t(colors),
                         t(np.full((n,), 1.0, f32)),
                         None if mc is None else t(mc), t(np.ones((n,), f32)))

    T = NUM_FRAMES
    fg = gauss(NUM_FG, coefs=True, spread=0.8, z=(2.0, 5.0))
    bg = gauss(NUM_BG, spread=2.0, z=(3.0, 10.0))
    rots = np.tile(np.array([1.0, 0, 0, 0, 1, 0], f32), (16, T, 1))
    transls = (0.02 * rng.normal(size=(16, T, 3))).astype(f32)
    scene = SceneModel(
        fg=fg, bg=bg, bases=MotionBases(t(rots), t(transls)),
        move=init_move_model(torch.Generator().manual_seed(0), T,
                             device=dev),
    )
    f = 1000.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], f32)
    eye = np.eye(4, dtype=f32)
    batch = FrameBatch(
        ts=t(np.array([5], np.int32)), w2cs=t(eye[None]), Ks=t(K[None]),
        imgs=t(rng.uniform(0, 1, (1, H, W, 3)).astype(f32)),
        masks=t((rng.uniform(size=(1, H, W)) < 0.3).astype(f32)),
        valid_masks=t(np.ones((1, H, W), f32)),
        depths=t(rng.uniform(2, 8, (1, H, W)).astype(f32)),
    )
    P = 256
    tracks = TrackBatch(
        query_tracks_2d=t(np.stack([rng.integers(0, W, P),
                                    rng.integers(0, H, P)], -1).astype(f32)),
        target_ts=t(np.array([4, 6], np.int32)),
        target_w2cs=t(np.tile(eye, (2, 1, 1))),
        target_Ks=t(np.tile(K, (2, 1, 1))),
        target_tracks_2d=t(rng.uniform(0, W, (2, P, 2)).astype(f32)),
        target_visibles=t(np.ones((2, P), f32)),
        target_confidences=t(np.ones((2, P), f32)),
        target_track_depths=t(rng.uniform(2, 8, (2, P)).astype(f32)),
    )
    w2cs = np.tile(eye, (3, 1, 1))
    w2cs[:, 0, 3] = [-0.02, 0.0, 0.02]
    static = FrameBatch(
        ts=t(np.array([4, 5, 6], np.int32)), w2cs=t(w2cs),
        Ks=t(np.tile(K, (3, 1, 1))),
        imgs=t(rng.uniform(0, 1, (3, H, W, 3)).astype(f32)),
        masks=t(rect_masks(rng, 3)), valid_masks=t(np.ones((3, H, W), f32)),
        depths=t(rng.uniform(2, 8, (3, H, W)).astype(f32)),
    )
    reg = batch._replace(
        imgs=t(rng.uniform(0, 1, (1, H, W, 3)).astype(f32)),
        masks=t(rect_masks(rng, 1)))
    b4 = t(rng.uniform(0, 1, (1, H // 4, W // 4, 3)).astype(f32))
    return scene, (static, batch, tracks, reg, b4)


def bench_rcfg(camera_mode="linear"):
    from deblur4dgs_tpu_torch.configs import RenderConfig
    return RenderConfig(num_exposure=NUM_EXPOSURE, tile_cap=TILE_CAP,
                        max_tiles_per_gauss=32, camera_mode=camera_mode)


def bench_state(dev, kind="dynamic", flow_fn=None, camera_mode="linear"):
    """bench.py's scene and batches (bench_scene_batches) and the step of
    ``kind`` (STEP_KINDS) to drive: (state, drive(state) -> (state, loss,
    aux))."""
    scene, batches = bench_scene_batches(dev)
    state, step = make_step(kind, scene, NUM_FRAMES, bench_rcfg(camera_mode),
                            flow_fn)
    args = step_args(kind, *batches)
    return state, lambda s: step(s, EPOCH, *args)


# ---------------------------------------------------------------------------
# Kernel vs twin
# ---------------------------------------------------------------------------


def n_tensors(args):
    return sum(torch.is_tensor(a) for a in args)


@torch.no_grad()
def compare_fwd(tr, kind, args):
    k_fwd, p_fwd, _, _ = tr._COMPOSITORS[kind]
    acc_k, tf_k = k_fwd(*args)
    acc_p, tf_p = p_fwd(*args)
    scale = max(1.0, float(acc_p.abs().max()))
    err = max(float((acc_k - acc_p).abs().max()),
              float((tf_k - tf_p).abs().max()))
    return err, err / scale


@torch.no_grad()
def compare_bwd(tr, kind, args):
    _, _, k_bwd, p_bwd = tr._COMPOSITORS[kind]
    gk, gp = k_bwd(*args), p_bwd(*args)
    gk, gp = (gk,) if torch.is_tensor(gk) else gk, \
        (gp,) if torch.is_tensor(gp) else gp
    err = rel = 0.0
    for k, p in zip(gk, gp):
        e = float((k - p).abs().max())
        err = max(err, e)
        rel = max(rel, e / (float(p.abs().max()) + 1e-30))
    return err, rel


def bwd_args_for(tr, kind, fwd_args, seed):
    """Backward inputs for fwd_args: the twin's forward outputs and random
    cotangents."""
    acc, tf = tr._COMPOSITORS[kind][1](*fwd_args)
    g = torch.Generator(device=acc.device).manual_seed(seed)
    gacc = torch.randn(acc.shape, generator=g, device=acc.device)
    gt = torch.randn(tf.shape, generator=g, device=acc.device)
    n = n_tensors(fwd_args)
    return fwd_args[:n] + (acc, tf, gacc, gt) + fwd_args[n:]


class Errs:
    """Running max of kernel-vs-twin errors per kernel name."""

    def __init__(self):
        self.v = {}

    def add(self, name, err, rel, tol, what):
        check(rel <= tol, f"{name} vs twin ({what}): rel err {rel:.3e}")
        a, r = self.v.get(name, (0.0, 0.0))
        self.v[name] = (max(a, err), max(r, rel))


@torch.no_grad()
def compare_case(tr, errs, kind, label, fargs, seed):
    """One forward / backward comparison of the kernels of ``kind`` with
    their twins (backward on the twin's forward outputs and random
    cotangents), into ``errs``."""
    e, r = compare_fwd(tr, kind, fargs)
    errs.add(f"{kind}_fwd", e, r, FWD_TOL, label)
    e2, r2 = compare_bwd(tr, kind, bwd_args_for(tr, kind, fargs, seed))
    errs.add(f"{kind}_bwd", e2, r2, BWD_TOL, label)
    print(f"# {label} {kind}: forward max abs err {e:.3e} (rel {r:.3e}), "
          f"backward {e2:.3e} (rel to max |g| {r2:.3e})")


@torch.no_grad()
def compare_dense_bwd(tr, ba, slot_map):
    """K5's backward vs its twin on backward args ``ba``: the per-slot
    gradient on the rows the kernel writes (the slots below each row's
    count) and the per-Gaussian gradient
    (dense_table_grad over ``slot_map``). [(abs, rel to the twin's max
    |g|)] for each."""
    _, _, k_bwd, p_bwd = tr._COMPOSITORS["dense"]
    gk, gp = k_bwd(*ba), p_bwd(*ba)
    idx, counts = ba[1], ba[2]
    cap = idx.shape[1]
    lane = torch.arange(cap, device=idx.device)
    written = (lane[None] < counts.clamp(max=cap)[:, None]).reshape(-1)
    out = []
    for k, p in ((gk[:-1][written], gp[:-1][written]),
                 (tr.dense_table_grad(gk, slot_map),
                  tr.dense_table_grad(gp, slot_map))):
        e = float((k - p).abs().max())
        out.append((e, e / (float(p.abs().max()) + 1e-30)))
    return out


@torch.no_grad()
def compare_dense_case(tr, errs, label, case, tiles_x, nchan, seed):
    """K5's kernels vs twins on one indexed_case, the backward on the
    twin's forward outputs and random cotangents, per slot and per
    Gaussian; returns the forward args."""
    (table, idx, counts), slot_map = case
    fa = (table, idx, counts, tiles_x, nchan)
    e, r = compare_fwd(tr, "dense", fa)
    errs.add("dense_fwd", e, r, FWD_TOL, label)
    (es, rs), (eg, rg) = compare_dense_bwd(
        tr, bwd_args_for(tr, "dense", fa, seed), slot_map)
    errs.add("dense_bwd", es, rs, BWD_TOL, f"{label}, per slot")
    errs.add("dense_bwd", eg, rg, BWD_TOL, f"{label}, per Gaussian")
    print(f"# {label} dense: forward max abs err {e:.3e} (rel {r:.3e}), "
          f"backward per slot {es:.3e} (rel to max |g| {rs:.3e}), per "
          f"Gaussian {eg:.3e} (rel {rg:.3e})")
    return fa


@torch.no_grad()
def phase_random_dense(tr, errs, cases):
    """K5 vs its twins on indexed random_dense cases ((label, nchan, seed,
    cap)); rows 1-8 must saturate in their first chunk."""
    for label, nchan, seed, cap in cases:
        case = indexed_case(*random_dense(seed, 64, nchan, cap, 80), seed,
                            DEV)
        fa = compare_dense_case(tr, errs, f"random {label}", case, 80, nchan,
                                seed)
        _, tf = tr._COMPOSITORS["dense"][1](*fa)
        check(float(tf[1:9].max()) < tr.EARLY_STOP_T,
              f"dense {label}: saturating rows did not saturate")
    torch.cuda.synchronize()


@torch.no_grad()
def phase_edge_dense(tr, errs):
    """K5 on edge_dense cases in the indexed form (the per-warp cull's edge
    cases): D 4 and 5 at caps 128, 512, 1024 and the pipeline's 2048 and
    4096, the generic instance at D 3 (the validator's RGB renders) at
    2048 and 4096 and at D 8, cap 1024."""
    for nchan, caps in ((4, (128, 512, 1024) + BIG_CAPS),
                        (5, (128, 512, 1024) + BIG_CAPS), (8, (1024,)),
                        (3, BIG_CAPS)):
        for i, cap in enumerate(caps):
            seed = 300 + 10 * nchan + i
            compare_dense_case(
                tr, errs, f"edge cap={cap} D={nchan}",
                indexed_case(*edge_dense(seed, 48, nchan, cap, 80), seed,
                             DEV), 80, nchan, seed)
    torch.cuda.synchronize()


@torch.no_grad()
def phase_random(tr, errs, kind, cases):
    """Kernels vs twins on random inputs; ``cases``: (label, fwd args)."""
    for i, (label, fargs) in enumerate(cases):
        compare_case(tr, errs, kind, f"random {label}", fargs, i)
        # the early-saturating rows really stopped early
        _, tf = tr._COMPOSITORS[kind][1](*fargs)
        check(float(tf[1:9].max()) < tr.EARLY_STOP_T,
              f"{kind} {label}: saturating rows did not saturate")
    torch.cuda.synchronize()


def scatter_case(seed, nchan, cap, dev, maker=None):
    """K6 inputs: a 64-row bucket of ``maker`` (random_bucket by default)
    over a 256-tile image, its empty row 0 and last 4 rows turned into pad
    rows (count 0, sid T_img), and the shared output buffers (T_img + 1
    rows)."""
    dyn, st, counts, ids = (maker or random_bucket)(
        seed, 64, NUM_EXPOSURE, nchan, cap, 80, SCATTER_T_IMG, dev)
    counts[-4:] = 0
    ids[0] = SCATTER_T_IMG
    ids[-4:] = SCATTER_T_IMG
    acc = torch.zeros((SCATTER_T_IMG + 1, NUM_EXPOSURE, nchan, 256),
                      device=dev)
    tf = torch.ones((SCATTER_T_IMG + 1, NUM_EXPOSURE, 256), device=dev)
    return dyn, st, counts, ids, acc, tf, 80, nchan, True


@torch.no_grad()
def compare_scatter_fwd(tr, fa):
    """K6 forward vs its twin; each writes its own copy of the shared
    buffers (zeros, trash-row fill), compared whole."""
    k_fwd, p_fwd, _, _ = tr._COMPOSITORS["window_scatter"]
    ins, (acc, tf), cfg = fa[:4], fa[4:6], fa[6:]
    a_k, t_k = k_fwd(*ins, torch.zeros_like(acc), torch.ones_like(tf), *cfg)
    a_p, t_p = p_fwd(*ins, torch.zeros_like(acc), torch.ones_like(tf), *cfg)
    scale = max(1.0, float(a_p.abs().max()))
    err = max(float((a_k - a_p).abs().max()), float((t_k - t_p).abs().max()))
    return err, err / scale


@torch.no_grad()
def compare_scatter_case(tr, errs, label, fa, seed):
    """K6 vs its twins on one scatter_case, the backward against the
    twin's forward outputs and random cotangents."""
    e, r = compare_scatter_fwd(tr, fa)
    errs.add("window_scatter_fwd", e, r, FWD_TOL, label)
    acc, tf = tr.composite_window_scatter_plain(*fa)
    g = torch.Generator(device=DEV).manual_seed(seed)
    ba = fa[:4] + (acc, tf, torch.randn(acc.shape, generator=g, device=DEV),
                   torch.randn(tf.shape, generator=g, device=DEV)) + fa[6:]
    e2, r2 = compare_bwd(tr, "window_scatter", ba)
    errs.add("window_scatter_bwd", e2, r2, BWD_TOL, label)
    print(f"# {label} window_scatter: forward max abs err {e:.3e} (rel "
          f"{r:.3e}), backward {e2:.3e} (rel to max |g| {r2:.3e})")


@torch.no_grad()
def phase_random_scatter(tr, errs):
    """K6 vs its twins on random buckets (caps 128-1024, nchan 11 and 5),
    backward against the twin's forward outputs and random cotangents."""
    for nchan in (11, 5):
        for i, cap in enumerate((128, 256, 512, 1024)):
            compare_scatter_case(
                tr, errs, f"random cap={cap} nchan={nchan}",
                scatter_case(60 + i + nchan, nchan, cap, DEV), i)
    torch.cuda.synchronize()


@torch.no_grad()
def phase_edge(tr, errs):
    """The window kernels on edge_bucket inputs, the per-warp cull's edge
    cases: nchan 11 and 5 at caps 128, 512 and 1024, at S=11 (K1/K2), S=1
    (K4 through the split views) and with the row map (K6); then the
    generic instance (nchan 3 without a depth row, nchan 8 with one) on
    random buckets. All against the twins at FWD_TOL / BWD_TOL."""
    for nchan in (11, 5):
        for i, cap in enumerate((128, 512, 1024)):
            seed = 100 + 10 * nchan + i
            label = f"edge cap={cap} nchan={nchan}"
            compare_case(tr, errs, "window", label, edge_bucket(
                seed, 48, NUM_EXPOSURE, nchan, cap, 80, 3600, DEV)
                + (80, nchan, True), seed)
            dyn, st, counts, ids = edge_bucket(seed + 1, 48, 1, nchan, cap,
                                               80, 3600, DEV)
            compare_case(tr, errs, "split", label,
                         (dyn[:, 0], st, counts, ids, 80, nchan, True), seed)
            compare_scatter_case(tr, errs, label, scatter_case(
                seed + 2, nchan, cap, DEV, maker=edge_bucket), seed)
    for nchan, depth in ((3, False), (8, True)):
        for i, cap in enumerate((128, 1024)):
            compare_case(
                tr, errs, "window", f"generic cap={cap} nchan={nchan}",
                random_bucket(200 + nchan + i, 64, NUM_EXPOSURE, nchan, cap,
                              80, 3600, DEV, depth=depth)
                + (80, nchan, depth), i)
    torch.cuda.synchronize()


@contextlib.contextmanager
def recording(tr, kind, first=None):
    """Record the arguments of every kernel call of ``kind``, or of the
    ``first`` ones of each direction (the launches still count: they are
    the driven path's own)."""
    rec = {"fwd": [], "bwd": []}
    orig = tr._COMPOSITORS[kind]

    def wrap(fn, key):
        def f(*a):
            if first is None or len(rec[key]) < first:
                rec[key].append(a)
            return fn(*a)
        return f

    tr._COMPOSITORS[kind] = (wrap(orig[0], "fwd"), orig[1],
                             wrap(orig[2], "bwd"), orig[3])
    try:
        yield rec
    finally:
        tr._COMPOSITORS[kind] = orig


def window_geometry(tr, kind, fa):
    """(dyn (T, S, >=6, cap) rows [mx, my, a, b, c, r, ...], tile ids,
    tiles_x) of a compositor call's forward inputs ``fa``, as the window
    twin sees them."""
    if kind == "dense":
        dyn, _, ids = tr._dense_as_window(fa[0], fa[1], fa[4])
        return dyn, ids, fa[3]
    if kind == "split":
        return fa[0][:, None], fa[3], fa[4]
    if kind == "window_scatter":
        return fa[0], fa[3], fa[6]
    return fa[0], fa[3], fa[4]


def box_pairs(dyn, tile_ids, tiles_x, slots):
    """(pixel, Gaussian) pairs inside alpha_at's box among the slots each
    (row, s) walks (``slots`` (T, S) from the twin's work). The box is
    separable: per Gaussian, the pixel columns in reach times the rows in
    reach, with the kernels' float32 offsets."""
    t = tile_ids.long()
    mx, my, r = dyn[:, :, 0], dyn[:, :, 1], dyn[:, :, 5]  # (T, S, cap)
    x0 = ((t % tiles_x) * TILE).float()[:, None, None] + 0.5
    y0 = ((t // tiles_x) * TILE).float()[:, None, None] + 0.5
    nx = sum(((x0 + i) - mx).abs() <= r for i in range(TILE))
    ny = sum(((y0 + i) - my).abs() <= r for i in range(TILE))
    walked = torch.arange(dyn.shape[-1], device=dyn.device) < slots[..., None]
    return int((nx * ny * walked).sum())


class StepWork:
    """The operations and bytes of a step's compositor calls, summed call
    by call, and the bounds they give (see OPS_PAIR, OPS_BOX)."""

    def __init__(self, tr, kind):
        self.tr, self.kind = tr, kind
        self.n = {"pairs": 0, "boxed": 0, "live": 0}
        self.ops = {(d, c): 0 for d in ("fwd", "bwd") for c in ("box", "all")}
        self.bytes = {"fwd": 0.0, "bwd": 0.0}

    def add(self, fa, nchan, work, by_f, by_b):
        boxed = box_pairs(*window_geometry(self.tr, self.kind, fa),
                          work["slots"])
        tests = OPS_BOX * int(work["slots"].sum()) * self.tr.NWARPS
        for key, v in (("pairs", work["pairs"]), ("boxed", boxed),
                       ("live", work["live"])):
            self.n[key] += v
        for d, per_live in (("fwd", 2 * nchan + 3), ("bwd", 4 * nchan + 36)):
            live_ops = per_live * work["live"]
            self.ops[d, "box"] += OPS_PAIR * boxed + tests + live_ops
            self.ops[d, "all"] += OPS_PAIR * work["pairs"] + live_ops
        self.bytes["fwd"] += by_f
        self.bytes["bwd"] += by_b

    def bounds(self, rates, ms, plain):
        """{d: (bound ms, "bytes" or "operations", bound ms counting alpha
        for every pair)}: max(bytes / HBM rate, ops / FP32 rate)."""
        bw, peak = rates
        out = {}
        for d in ("fwd", "bwd"):
            t_bytes = self.bytes[d] / bw * 1e3
            t_box, t_all = (self.ops[d, c] / peak * 1e3 for c in ("box", "all"))
            out[d] = (max(t_bytes, t_box),
                      "bytes" if t_bytes >= t_box else "operations",
                      max(t_bytes, t_all))
            print(f"# {self.kind} {d}: {self.bytes[d] / 1e9:.3f} GB -> "
                  f"{t_bytes:.4f} ms; {self.ops[d, 'box'] / 1e9:.2f} Gop -> "
                  f"{t_box:.4f} ms ({self.ops[d, 'all'] / 1e9:.2f} Gop with "
                  f"alpha for every pair -> {t_all:.4f} ms); pairs "
                  f"{self.n['pairs']}, in the box {self.n['boxed']}, live "
                  f"{self.n['live']}; kernel {ms[d]:.3f} ms, twin "
                  f"{plain[d]:.3f} ms")
        return out


@torch.no_grad()
def measure(tr, errs, kind, rec, rates, reps=10):
    """Kernels vs twins on a recorded step's inputs (first 64 rows of each
    call), kernel and twin device times per step (all calls of the step),
    and the step's bounds (StepWork) with the pairs and payload slots the
    twin's loops count on this data (bytes: input_bytes, plus the forward
    outputs read back by the backward and every output written whole)."""
    k_fwd, p_fwd, k_bwd, p_bwd = tr._COMPOSITORS[kind]
    cut = lambda a: tuple(x[:64] if torch.is_tensor(x) else x for x in a)
    for i, (fa, ba) in enumerate(zip(rec["fwd"], rec["bwd"])):
        e, r = compare_fwd(tr, kind, cut(fa))
        errs.add(f"{kind}_fwd", e, r, FWD_TOL, f"real call {i}")
        e2, r2 = compare_bwd(tr, kind, cut(ba))
        errs.add(f"{kind}_bwd", e2, r2, BWD_TOL, f"real call {i}")
        print(f"# real {kind} call {i} {tuple(fa[0].shape)}: fwd err "
              f"{e:.3e} (rel {r:.3e}), bwd err {e2:.3e} (rel {r2:.3e})")
    ms = {"fwd": cuda_ms(lambda: [k_fwd(*a) for a in rec["fwd"]], reps),
          "bwd": cuda_ms(lambda: [k_bwd(*a) for a in rec["bwd"]], reps)}
    dev = {d: device_ms(lambda: [k(*a) for a in rec[d]], 3)
           for d, k in (("fwd", k_fwd), ("bwd", k_bwd))}
    plain = {"fwd": cuda_ms(lambda: [p_fwd(*a) for a in rec["fwd"]], 1),
             "bwd": cuda_ms(lambda: [p_bwd(*a) for a in rec["bwd"]], 1)}
    print(f"# {kind} kernels' device time (queued): fwd {dev['fwd']:.4f} "
          f"ms, bwd {dev['bwd']:.4f} ms")
    sw = StepWork(tr, kind)
    for fa, ba in zip(rec["fwd"], rec["bwd"]):
        n = n_tensors(fa)
        acc, tf, work = p_fwd(*fa, return_work=True)
        ins = input_bytes(fa, work["slots"])
        g = k_bwd(*ba)
        sw.add(fa, fa[n + 1], work, ins + nbytes(acc, tf),  # nchan: after tiles_x
               ins + nbytes(*ba[n : n + 4],
                            *((g,) if torch.is_tensor(g) else g)))
    bounds = sw.bounds(rates, ms, plain)
    torch.cuda.synchronize()
    return ms, plain, bounds, dev


@contextlib.contextmanager
def recording_dense_host(tr, first=None):
    """Record the arguments of K5's host-side parts: the table build
    (ops/rasterize.py's dense_table) and the per-Gaussian reduction
    (dense_table_grad), of every call or of the ``first`` ones. Yields
    {"table": [...], "grad": [...], "fns": the unwrapped functions}."""
    rec = {"table": [], "grad": [],
           "fns": (tr.dense_table, tr.dense_table_grad)}

    def wrap(fn, key):
        def f(*a):
            if first is None or len(rec[key]) < first:
                rec[key].append(a)
            return fn(*a)
        return f

    tr.dense_table = wrap(rec["fns"][0], "table")
    tr.dense_table_grad = wrap(rec["fns"][1], "grad")
    try:
        yield rec
    finally:
        tr.dense_table, tr.dense_table_grad = rec["fns"]


def dense_bytes(fa, ba, work):
    """Bytes K5 must move on a call (forward args ``fa``, backward args
    ``ba``): the index entries of the slots walked before each row's stop
    chunk, the table rows they name (once each) and the counts; the forward
    writes accum and tfin; the backward also reads those and the
    cotangents and writes the per-slot gradient of the slots below each
    count. (forward bytes, backward bytes)."""
    table, idx, counts = fa[:3]
    cap, Fp = idx.shape[1], table.shape[1]
    lane = torch.arange(cap, device=idx.device)
    walked = lane[None] < work["slots"][:, :1]
    rows = int(torch.unique(idx[walked]).numel())
    ins = 4 * int(walked.sum()) + 4 * rows * Fp + nbytes(counts)
    written = int(counts.clamp(max=cap).sum())
    return (ins + nbytes(*ba[3:5]),
            ins + nbytes(*ba[3:7]) + 4 * written * Fp)


@torch.no_grad()
def measure_dense(tr, errs, rec, host, rates, reps=10):
    """measure() for K5 on a step's one static-reg call: kernels vs twins on
    the whole call (the backward per slot and per Gaussian, through the
    call's slot map), kernel and twin device times, the function's times
    (the table build + forward kernel; the backward kernel + per-Gaussian
    reduction) and each host part's, and the bound (StepWork, dense_bytes).
    """
    k_fwd, p_fwd, k_bwd, p_bwd = tr._COMPOSITORS["dense"]
    (fa,), (ba,) = rec["fwd"], rec["bwd"]
    (targs,), ((_, slot_map),) = host["table"], host["grad"]
    table_fn, grad_fn = host["fns"]
    e, r = compare_fwd(tr, "dense", fa)
    errs.add("dense_fwd", e, r, FWD_TOL, "real call")
    (es, rs), (eg, rg) = compare_dense_bwd(tr, ba, slot_map)
    errs.add("dense_bwd", es, rs, BWD_TOL, "real call, per slot")
    errs.add("dense_bwd", eg, rg, BWD_TOL, "real call, per Gaussian")
    print(f"# real dense call {tuple(fa[1].shape)} table "
          f"{tuple(fa[0].shape)} slot map {tuple(slot_map.shape)}: fwd err "
          f"{e:.3e} (rel {r:.3e}), bwd per slot {es:.3e} (rel {rs:.3e}), "
          f"per Gaussian {eg:.3e} (rel {rg:.3e})")
    ms = {"fwd": cuda_ms(lambda: k_fwd(*fa), reps),
          "bwd": cuda_ms(lambda: k_bwd(*ba), reps)}
    dev = {"fwd": device_ms(lambda: k_fwd(*fa), reps),
           "bwd": device_ms(lambda: k_bwd(*ba), reps)}
    plain = {"fwd": cuda_ms(lambda: p_fwd(*fa), 1),
             "bwd": cuda_ms(lambda: p_bwd(*ba), 1)}
    gslot = k_bwd(*ba)
    parts = {"table": cuda_ms(lambda: table_fn(*targs), reps),
             "reduce": cuda_ms(lambda: grad_fn(gslot, slot_map), reps)}
    fns = {"fwd": lambda: k_fwd(table_fn(*targs), *fa[1:]),
           "bwd": lambda: grad_fn(k_bwd(*ba), slot_map)}
    fn_ms = {d: cuda_ms(f, reps) for d, f in fns.items()}
    fn_dev = {d: device_ms(f, reps) for d, f in fns.items()}
    acc, tf, work = p_fwd(*fa, return_work=True)
    sw = StepWork(tr, "dense")
    sw.add(fa, fa[4], work, *dense_bytes(fa, ba, work))
    bounds = sw.bounds(rates, ms, plain)
    print(f"# dense kernels' device time (queued): fwd {dev['fwd']:.4f} ms,"
          f" bwd {dev['bwd']:.4f} ms")
    print(f"# dense function: table build + forward kernel {fn_ms['fwd']:.4f}"
          f" ms (table {parts['table']:.4f}; device {fn_dev['fwd']:.4f}), "
          f"backward kernel + per-Gaussian reduction {fn_ms['bwd']:.4f} ms "
          f"(reduction {parts['reduce']:.4f}; device {fn_dev['bwd']:.4f})")
    torch.cuda.synchronize()
    return ms, plain, bounds, dev, fn_ms, parts, fn_dev


@torch.no_grad()
def cull_share(tr, rec):
    """What the window kernels' per-warp cull (ops/rasterize.py::warp_reach)
    does on a step's recorded window calls: the (warp, Gaussian) iterations
    up to each (row, sub-frame)'s stop chunk, and how many the cull keeps."""
    n = {"walked": 0, "reached": 0}
    for fa in rec["fwd"]:
        dyn, _, _, ids, tiles_x = fa[:5]
        _, _, work = tr.composite_window_plain(*fa, return_work=True)
        lane = torch.arange(dyn.shape[-1], device=dyn.device)
        walked = (lane < work["slots"][..., None])[:, :, None, :]
        n["walked"] += int(walked.sum()) * tr.NWARPS
        n["reached"] += int((tr.warp_reach(dyn, ids, tiles_x)
                             & walked).sum())
    n["removed_share"] = 1.0 - n["reached"] / n["walked"]
    return n


@torch.no_grad()
def measure_scatter(tr, errs, rec, rates, reps=10):
    """measure() for K6: its calls' shared buffers are indexed by the row
    map, so the first 64 rows of each call's bucket inputs go against the
    whole buffers. Bytes per call: the bucket's inputs as far as walked,
    and its rows of the outputs (forward) or of the residuals, cotangents
    and gradients (backward)."""
    k_fwd, p_fwd, k_bwd, p_bwd = tr._COMPOSITORS["window_scatter"]
    cut = lambda a: tuple(x[:64] for x in a[:4]) + tuple(a[4:])
    for i, (fa, ba) in enumerate(zip(rec["fwd"], rec["bwd"])):
        e, r = compare_scatter_fwd(tr, cut(fa))
        errs.add("window_scatter_fwd", e, r, FWD_TOL, f"real call {i}")
        e2, r2 = compare_bwd(tr, "window_scatter", cut(ba))
        errs.add("window_scatter_bwd", e2, r2, BWD_TOL, f"real call {i}")
        print(f"# real window_scatter call {i} {tuple(fa[0].shape)}: fwd err "
              f"{e:.3e} (rel {r:.3e}), bwd err {e2:.3e} (rel {r2:.3e})")
    ms = {"fwd": cuda_ms(lambda: [k_fwd(*a) for a in rec["fwd"]], reps),
          "bwd": cuda_ms(lambda: [k_bwd(*a) for a in rec["bwd"]], reps)}
    dev = {d: device_ms(lambda: [k(*a) for a in rec[d]], 3)
           for d, k in (("fwd", k_fwd), ("bwd", k_bwd))}
    plain = {"fwd": cuda_ms(lambda: [p_fwd(*a) for a in rec["fwd"]], 1),
             "bwd": cuda_ms(lambda: [p_bwd(*a) for a in rec["bwd"]], 1)}
    print(f"# window_scatter kernels' device time (queued): fwd "
          f"{dev['fwd']:.4f} ms, bwd {dev['bwd']:.4f} ms")
    sw = StepWork(tr, "window_scatter")
    for fa, ba in zip(rec["fwd"], rec["bwd"]):
        acc, tf, work = tr.composite_window_plain(*fa[:4], *fa[6:],
                                                  return_work=True)
        ins = input_bytes(fa[:4], work["slots"])
        rows = nbytes(acc, tf)  # this bucket's rows of accum and tfin
        sw.add(fa, fa[7], work, ins + rows,
               ins + 2 * rows + nbytes(*k_bwd(*ba)))
    bounds = sw.bounds(rates, ms, plain)
    torch.cuda.synchronize()
    return ms, plain, bounds, dev


@contextlib.contextmanager
def scatter_path(tr, on=True):
    """The port's D4_SCATTER switch, set for the block and restored."""
    old = tr._USE_SCATTER
    tr._USE_SCATTER = on
    try:
        yield
    finally:
        tr._USE_SCATTER = old


# ---------------------------------------------------------------------------
# Train-step phases
# ---------------------------------------------------------------------------


def drive_steps(tr, state, drive, label, expected):
    """One warm-up step, then TIMED_STEPS steps with the launch counters
    zeroed just before and read just after; checks finiteness and that the
    counters read exactly ``expected`` launches per step."""
    t0 = time.time()
    state, loss, aux = drive(state)
    torch.cuda.synchronize()
    overflow = {b: float(a["tile_overflow"]) for b, a in aux.items()
                if "tile_overflow" in a}
    print(f"# {label}: warm-up step {time.time() - t0:.2f} s, loss "
          f"{float(loss):.5f}, tile_overflow {overflow}")
    zero_launches(tr)
    times, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.time()
        state, loss, aux = drive(state)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        losses.append(float(loss))
    launches = dict(tr.LAUNCHES)
    print(f"# {label}: timed steps (s) {[round(x, 6) for x in times]}; "
          f"losses {losses}; launches {launches}")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    for name, p in state.scene.named_parameters():
        check(bool(torch.isfinite(p).all()),
              f"{label}: non-finite parameter {name}")
    for k in tr.LAUNCHES:
        want = expected.get(k, 0) * TIMED_STEPS
        check(launches[k] == want,
              f"{label}: {k} launched {launches[k]} times, expected {want}")
    return state, times, launches


def n_buckets():
    from deblur4dgs_tpu_torch.ops.tiling import default_bucket_spec, num_tiles
    tx, ty = num_tiles((W, H))
    return len(default_bucket_spec(tx * ty, TILE_CAP))


def phase_bench(tr, errs, rates):
    """The dynamic step at the bench shape; window kernels on its inputs."""
    state, drive = bench_state(DEV)
    nb = n_buckets()
    state, times, launches = drive_steps(
        tr, state, drive, "dynamic step",
        {"window_fwd": nb, "window_bwd": nb})
    with recording(tr, "window") as rec:
        state, _, _ = drive(state)
        torch.cuda.synchronize()
    check(len(rec["fwd"]) == nb and len(rec["bwd"]) == nb,
          f"recorded {len(rec['fwd'])}/{len(rec['bwd'])} window calls")
    del state
    torch.cuda.empty_cache()
    return times, launches, measure(tr, errs, "window", rec, rates)


def phase_bench_cubic(tr):
    """The dynamic step at the bench shape with RenderConfig.camera_mode
    'cubic' (the duplicated-knot SE(3) B-spline over the exposure, through
    K1/K2 as the linear camera): one warm-up and TIMED_STEPS timed steps,
    exact window launches."""
    state, drive = bench_state(DEV, camera_mode="cubic")
    nb = n_buckets()
    _, times, _ = drive_steps(tr, state, drive, "dynamic step, cubic camera",
                              {"window_fwd": nb, "window_bwd": nb})
    del state
    torch.cuda.empty_cache()
    return times


def phase_stage2(tr, errs, rates):
    """(c) The stage-2 step at the bench shape, its profile, and the window
    kernels (16 calls: 3 static windows, nchan 5, and the dynamic one,
    nchan 11) and K5 (the static-reg call) on one step's recorded
    inputs."""
    state, drive = bench_state(DEV, "stage2")
    nb = n_buckets()
    state, times, launches = drive_steps(
        tr, state, drive, "stage-2 step",
        {"window_fwd": 4 * nb, "window_bwd": 4 * nb, "dense_fwd": 1,
         "dense_bwd": 1})
    state = phase_profile(state, drive, gathers=4 * nb)
    with recording(tr, "dense") as rec_d, recording(tr, "window") as rec_w, \
            recording_dense_host(tr) as rec_h:
        state, _, _ = drive(state)
        torch.cuda.synchronize()
    for kind, rec, n in (("dense", rec_d, 1), ("window", rec_w, 4 * nb)):
        check(len(rec["fwd"]) == n and len(rec["bwd"]) == n,
              f"recorded {len(rec['fwd'])}/{len(rec['bwd'])} {kind} calls, "
              f"expected {n}")
    check(len(rec_h["table"]) == 1 and len(rec_h["grad"]) == 1,
          f"recorded {len(rec_h['table'])}/{len(rec_h['grad'])} dense table "
          f"builds / reductions, expected 1")
    del state
    torch.cuda.empty_cache()
    cull = cull_share(tr, rec_w)
    return (times, launches, measure(tr, errs, "window", rec_w, rates),
            measure_dense(tr, errs, rec_d, rec_h, rates), cull)


def phase_stage1(tr):
    """The stage-1 step (the static branch alone, stage 'first') at the
    bench shape: 3 bg-only windows x the buckets per direction per step;
    and its profile."""
    state, drive = bench_state(DEV, "stage1")
    nb = n_buckets()
    state, times, launches = drive_steps(
        tr, state, drive, "stage-1 step",
        {"window_fwd": 3 * nb, "window_bwd": 3 * nb})
    state = phase_profile(state, drive, top=8, gathers=3 * nb)
    del state
    torch.cuda.empty_cache()
    return times, launches


def phase_scatter_ab(tr):
    """The dynamic step at the bench shape with the scatter path off, on,
    on, off (one state; TIMED_STEPS steps each): K1/K2 launches with the
    flag off, K6 with it on."""
    state, drive = bench_state(DEV)
    nb = n_buckets()
    times = {}
    for on in (False, True, True, False):
        want = ({"window_scatter_fwd": nb, "window_scatter_bwd": nb} if on
                else {"window_fwd": nb, "window_bwd": nb})
        with scatter_path(tr, on):
            state, t, _ = drive_steps(
                tr, state, drive, f"dynamic step, scatter {'on' if on else 'off'}",
                want)
        times.setdefault(on, []).append(statistics.median(t))
    del state
    torch.cuda.empty_cache()
    return times


def phase_stage2_scatter(tr, errs, rates):
    """The stage-2 step at the bench shape through K6 (16 scatter launches
    per direction per step), and K6 on one step's 16 recorded calls: held
    against its twins, timed, bounded."""
    nb = n_buckets()
    with scatter_path(tr):
        state, drive = bench_state(DEV, "stage2")
        state, times, launches = drive_steps(
            tr, state, drive, "stage-2 step, scatter",
            {"window_scatter_fwd": 4 * nb, "window_scatter_bwd": 4 * nb,
             "dense_fwd": 1, "dense_bwd": 1})
        with recording(tr, "window_scatter") as rec:
            state, _, _ = drive(state)
            torch.cuda.synchronize()
    check(len(rec["fwd"]) == 4 * nb and len(rec["bwd"]) == 4 * nb,
          f"recorded {len(rec['fwd'])}/{len(rec['bwd'])} scatter calls")
    del state
    torch.cuda.empty_cache()
    return times, measure_scatter(tr, errs, rec, rates)


def state_tensors(state, epoch=None) -> dict:
    """Every tensor and counter of a TrainState, by name."""
    out = {f"scene/{k}": v for k, v in state.scene.state_dict().items()}
    for label, gs in state.opt_state.items():
        for k in ("count", "mini_step", "gradient_step"):
            out[f"opt/{label}/{k}"] = getattr(gs, k)
        for kind in ("mu", "nu", "acc_grads"):
            for n, x in getattr(gs, kind).items():
                out[f"opt/{label}/{kind}/{n}"] = x
    out.update({f"stats/{k}": v for k, v in state.stats._asdict().items()})
    out["step"] = state.step
    if epoch is not None:
        out["epoch"] = epoch
    return out


def assert_states_equal(a, b, label):
    check(set(a) == set(b), f"{label}: state keys differ")
    for k in a:
        x, y = a[k], b[k]
        same = (torch.equal(x, y) and x.dtype == y.dtype) \
            if torch.is_tensor(x) else x == y
        check(same, f"{label}: {k} differs")


def phase_lifecycle(tr):
    """The training lifecycle at the bench shape, through K6: observations
    from the bench scene (tracks = its 40k fg Gaussians' world positions
    over the 24 frames, all visible, confidence 1; static points = its 60k
    bg means with seeded unit normals), the port's init on the card
    (Procrustes for 10 bases x 24 frames, 1000 initial-optim iterations),
    padding to the pipeline's capacities (fg x2.0, bg x1.5, rounded up to
    256), a stage-2 TrainLoop of LIFE_STEPS steps with density control,
    and a checkpoint round trip. The loop's state starts at step 72, where
    a resumed stage would: the reference's cull waits for step % (control
    period) > 3 x 24 frames; with control every 2 steps and an opacity
    reset every 40 controls, steps 74, 76 and 78 densify and cull and step
    80 resets the opacities."""
    from deblur4dgs_tpu_torch.configs import (
        LossesConfig, OptimizerConfig, SceneLRConfig)
    from deblur4dgs_tpu_torch.data.observations import StaticObservations
    from deblur4dgs_tpu_torch.models.gaussians import pad_to_capacity
    from deblur4dgs_tpu_torch.models.move_model import init_move_model
    from deblur4dgs_tpu_torch.models.scene import SceneModel
    from deblur4dgs_tpu_torch.train import init as I
    from deblur4dgs_tpu_torch.train.checkpoints import (
        load_checkpoint, save_checkpoint, template_state)
    from deblur4dgs_tpu_torch.train.loop import TrainLoop
    from deblur4dgs_tpu_torch.train.optimizers import make_optimizer
    from deblur4dgs_tpu_torch.train.trainer import init_train_state

    T = NUM_FRAMES
    scene0, batches = bench_scene_batches(DEV)
    tracks = bench_tracks(scene0)
    with torch.no_grad():
        normals = np.random.default_rng(7).normal(size=(NUM_BG, 3))
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
        points = StaticObservations(
            scene0.bg.means.detach().clone(),
            torch.as_tensor(normals, dtype=torch.float32, device=DEV),
            scene0.bg.get_colors())
    K = batches[1].Ks[0]
    Ks, w2cs = K.expand(T, 3, 3), torch.eye(4, device=DEV).expand(T, 4, 4)
    del scene0
    torch.cuda.synchronize()
    t0 = time.time()
    cano_t = int(torch.argmax(tracks.visibles.sum(0)))
    bases, coefs, tracks = I.init_motion_params_with_procrustes(
        tracks, LIFE_BASES, cano_t, seed=0, device=DEV)
    fg = I.init_fg_from_tracks_3d(cano_t, tracks, coefs, seed=0, device=DEV)
    torch.cuda.synchronize()
    t_fit = time.time() - t0
    fg, bases, losses = I.run_initial_optim(fg, bases, tracks, Ks, w2cs,
                                            num_iters=1000, device=DEV)
    torch.cuda.synchronize()
    t_optim = time.time() - t0 - t_fit
    bg, bg_scale = I.init_bg(points, device=DEV)
    fg = pad_to_capacity(fg, I.round_capacity(int(fg.capacity * 2.0)))
    bg = pad_to_capacity(bg, I.round_capacity(int(bg.capacity * 1.5)))
    scene = SceneModel(fg, bg, bases, init_move_model(
        torch.Generator().manual_seed(0), T, device=DEV))
    torch.cuda.synchronize()
    t_init = time.time() - t0
    losses = losses.cpu().numpy()
    print(f"# lifecycle init: {t_init:.3f} s (outlier filter, k-means, "
          f"{LIFE_BASES}x{T} Procrustes fits and fg init {t_fit:.3f} s; "
          f"1000 initial-optim iterations {t_optim:.3f} s); {len(tracks.xyz)}"
          f" tracks kept; optim loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"capacities fg {fg.capacity} bg {bg.capacity}, bg scale "
          f"{bg_scale:.4f}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"initial optim losses {losses[:3]} ... {losses[-3:]}")

    ocfg = OptimizerConfig(warmup_steps=0, control_every=2,
                           reset_opacity_every_n_controls=40)
    lr = SceneLRConfig()
    state = init_train_state(scene, lr, ocfg)
    state.step = LIFE_START
    work = os.path.join(HERE, "build", "chip_smoke")
    loop = TrainLoop(state, make_optimizer(scene, lr, ocfg), LossesConfig(),
                     bench_rcfg(), ocfg, T, work, "second", has_static=True,
                     has_dynamic=True, has_reg=True, has_batch4=True,
                     bg_scene_scale=bg_scale, checkpoint_every=0, log_every=4)
    loop.epoch = EPOCH
    events = []
    control = loop._maybe_control

    def timed_control():
        sc = loop.state.scene
        before = (sc.fg.alive.clone(), sc.bg.alive.clone())
        torch.cuda.synchronize()
        tc = time.time()
        flags = control()
        torch.cuda.synchronize()
        if flags is None:
            return None
        ms = (time.time() - tc) * 1e3
        born = {}
        for part, a0 in zip(("fg", "bg"), before):
            a1 = getattr(loop.state.scene, part).alive
            new = (a1 > 0.5) & (a0 < 0.5)
            born[part] = int(new.sum())
            for label, gs in loop.state.opt_state.items():
                if label.startswith(part + "."):
                    for kind in ("mu", "nu"):
                        for n, x in getattr(gs, kind).items():
                            check(not bool(x[new].any()),
                                  f"step {loop.global_step}: {kind} of {n} "
                                  "not zero at a new slot")
        events.append(dict(
            step=loop.global_step, ms=ms,
            flags={k: v for k, v in flags.items() if v},
            fg_alive=(int(before[0].sum()), int(sc.fg.alive.sum())),
            bg_alive=(int(before[1].sum()), int(sc.bg.alive.sum())),
            born=born))
        return flags

    loop._maybe_control = timed_control
    args = step_args("stage2", *batches)
    with scatter_path(tr):
        zero_launches(tr)
        times, step_losses = [], []
        for _ in range(LIFE_STEPS):
            torch.cuda.synchronize()
            ts_ = time.time()
            loss = loop.train_step(*args)
            torch.cuda.synchronize()
            times.append(time.time() - ts_)
            step_losses.append(float(loss))
        launches = dict(tr.LAUNCHES)
    loop.finish()
    nb = n_buckets()
    print(f"# lifecycle loop: steps {LIFE_START + 1}-{loop.global_step}, "
          f"times (s) {[round(x, 6) for x in times]}; losses {step_losses}; "
          f"launches {launches}")
    for ev in events:
        print(f"# lifecycle control at step {ev['step']}: {ev['flags']}, "
              f"{ev['ms']:.3f} ms; fg alive {ev['fg_alive'][0]} -> "
              f"{ev['fg_alive'][1]}, bg alive {ev['bg_alive'][0]} -> "
              f"{ev['bg_alive'][1]}; new slots {ev['born']}")
    check(all(np.isfinite(step_losses)), f"lifecycle losses {step_losses}")
    want = {"window_scatter_fwd": 4 * nb, "window_scatter_bwd": 4 * nb,
            "dense_fwd": 1, "dense_bwd": 1}
    for k in tr.LAUNCHES:
        check(launches[k] == want.get(k, 0) * LIFE_STEPS,
              f"lifecycle: {k} launched {launches[k]} times, expected "
              f"{want.get(k, 0) * LIFE_STEPS}")
    kinds = [ev["flags"] for ev in events]
    check(any(f.get("do_densify") and f.get("do_cull") for f in kinds)
          and any(f.get("do_reset") for f in kinds),
          f"lifecycle control events {kinds}")
    check(sum(sum(ev["born"].values()) for ev in events) > 0,
          "no slot was allocated by the densify events")

    path = os.path.join(work, "checkpoint_last")
    tc = time.time()
    save_checkpoint(path, loop.state, loop.epoch)
    tmpl = template_state(fg.capacity, bg.capacity, LIFE_BASES, T,
                          device=DEV)
    got, epoch = load_checkpoint(path, tmpl)
    torch.cuda.synchronize()
    t_ckpt = time.time() - tc
    assert_states_equal(state_tensors(loop.state, loop.epoch),
                        state_tensors(got, epoch), "checkpoint round trip")
    size = os.path.getsize(path)
    os.remove(path)
    print(f"# lifecycle checkpoint: {size / 1e6:.1f} MB, save + load "
          f"{t_ckpt:.3f} s, round trip bit-exact")
    step_ms = [t * 1e3 - next((e["ms"] for e in events
                               if e["step"] == LIFE_START + i + 1), 0.0)
               for i, t in enumerate(times)]
    del loop, state, got, tmpl
    torch.cuda.empty_cache()
    return dict(init_s=t_init, fit_s=t_fit, optim_s=t_optim, times=times,
                step_ms=step_ms, events=events, launches=launches)


SMALL_OCFG = dict(warmup_steps=0, control_every=2,
                  reset_opacity_every_n_controls=100,
                  densify_xys_grad_threshold=2e-5)
SMALL_START = 8  # densify when step % 200 > 8 frames: steps 10 and 12


def small_loop(dev, arrays, inputs, work, state=None, viewer=None):
    """A stage-2 TrainLoop of a small scene (small_inputs) on ``dev`` (its
    state starting at step SMALL_START, or ``state``; with ``viewer``
    attached) and its batch arguments."""
    from deblur4dgs_tpu_torch import configs as C
    from deblur4dgs_tpu_torch.convert import scene_from_numpy
    from deblur4dgs_tpu_torch.models.gaussians import pad_to_capacity
    from deblur4dgs_tpu_torch.train import trainer as TT
    from deblur4dgs_tpu_torch.train.loop import TrainLoop
    from deblur4dgs_tpu_torch.train.optimizers import make_optimizer

    ocfg = C.OptimizerConfig(**SMALL_OCFG)
    if state is None:  # 256 slots per part: free slots for the densify
        scene = scene_from_numpy(arrays, device=dev)
        scene.fg = pad_to_capacity(scene.fg, 256)
        scene.bg = pad_to_capacity(scene.bg, 256)
        state = TT.init_train_state(scene, C.SceneLRConfig(), ocfg)
        state.step = SMALL_START
    scene = state.scene
    loop = TrainLoop(state, make_optimizer(scene, C.SceneLRConfig(), ocfg),
                     C.LossesConfig(),
                     C.RenderConfig(num_exposure=3, tile_cap=256), ocfg, 8,
                     work, "second", has_static=True, has_dynamic=True,
                     has_reg=True, has_batch4=True, checkpoint_every=0,
                     viewer=viewer)
    loop.epoch = EPOCH
    kinds = (TT.FrameBatch, TT.FrameBatch, TT.TrackBatch, TT.FrameBatch,
             None)
    conv = lambda x: torch.as_tensor(x, device=dev)
    args = [None if x is None else (conv(x) if k is None else k(*map(conv, x)))
            for k, x in zip(kinds, inputs)]
    return loop, args


def phase_loop_small(tr):
    """The 128x128 stage-2 loop with density control: (1) card vs CPU, 3
    steps with a densify at step 10, losses within the card-vs-CPU bar and
    equal alive masks; (2) on the card, with deterministic algorithms:
    2 steps, save, load into template_state, 2 more == 4 steps straight,
    bit for bit."""
    from deblur4dgs_tpu_torch.train.checkpoints import (
        load_checkpoint, save_checkpoint, template_state)

    arrays, inputs = small_inputs((128, 128), "stage2")
    work = os.path.join(HERE, "build", "chip_smoke")
    out = {}
    for dev in (DEV, "cpu"):
        loop, args = small_loop(dev, arrays, inputs, work)
        losses = [float(loop.train_step(*args)) for _ in range(3)]
        sc = loop.state.scene
        out[dev] = (losses, sc.fg.alive.cpu(), sc.bg.alive.cpu())
    (lc, fc, bc), (lp, fp, bp) = out[DEV], out["cpu"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    print(f"# loop 128x128, card vs CPU over steps 9-11: losses {lc} vs {lp} "
          f"(rel diff {worst:.3e}); alive fg {int(fc.sum())} bg "
          f"{int(bc.sum())} (CPU {int(fp.sum())} / {int(bp.sum())}, "
          f"from {int(arrays['fg.alive'].sum())} / "
          f"{int(arrays['bg.alive'].sum())})")
    check(worst <= 1e-5, f"loop 128x128 card vs CPU loss rel diff {worst:.3e}")
    check(torch.equal(fc, fp) and torch.equal(bc, bp),
          "loop 128x128: alive masks differ between card and CPU")
    check(int(bc.sum()) > int(arrays["bg.alive"].sum()),
          "loop 128x128: the densify event allocated no slot")

    torch.use_deterministic_algorithms(True)
    try:
        straight, args = small_loop(DEV, arrays, inputs, work)
        for _ in range(4):
            straight.train_step(*args)
        first, args = small_loop(DEV, arrays, inputs, work)
        for _ in range(2):
            first.train_step(*args)
        path = os.path.join(work, "checkpoint_resume")
        save_checkpoint(path, first.state, first.epoch)
        sc = first.state.scene
        tmpl = template_state(sc.num_fg, sc.num_bg, sc.bases.num_bases,
                              sc.bases.num_frames, device=DEV)
        state, epoch = load_checkpoint(path, tmpl)
        os.remove(path)
        check(epoch == first.epoch and state.step == SMALL_START + 2,
              f"resume: epoch {epoch}, step {state.step}")
        resumed, args = small_loop(DEV, arrays, inputs, work, state)
        resumed.epoch = epoch
        for _ in range(2):
            resumed.train_step(*args)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert_states_equal(state_tensors(straight.state),
                        state_tensors(resumed.state), "resume 128x128")
    print("# loop 128x128 resume (deterministic algorithms): 2 steps + "
          "checkpoint + 2 steps == 4 steps straight, bit for bit")


def profile_run(run, ops=True):
    """run() under torch.profiler, with the host's aten ops and their input
    shapes if ``ops`` (else the device's events alone, which costs the
    host far less): (profile, its device events, host wall us, device busy
    us: the union of the kernels' time spans)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ops else [])
    torch.cuda.synchronize()
    with profile(activities=acts, record_shapes=ops) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return prof, kernels, wall_us, None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    return prof, kernels, wall_us, busy


def top_kernels(kernels, steps, top, minus=()):
    """The `top` kernels by device time per step over `steps` steps; the
    events of `minus` (a shorter run of the same work) are taken off."""
    by_name = {}
    for sign, evs in ((1, kernels), (-1, minus)):
        for e in evs:
            by_name[e.name] = (by_name.get(e.name, 0)
                               + sign * e.time_range.elapsed_us())
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"#   kernel {us / steps / 1e3:9.3f} ms/step  {name[:90]}")


def phase_profile(state, drive, steps=2, top=15, gathers=None):
    """Device time by kernel and by aten op over `steps` train steps, and
    the device's busy share of the host wall time (torch.profiler). The
    payload gathers' backward (aten::embedding_dense_backward) is printed by
    index shape; there must be ``gathers`` per step (the window buckets'),
    and none of the dense (K5) payload's shape (pad_tiles(T), TILE_CAP),
    which the indexed K5 does not gather."""
    out = [state]

    def run():
        for _ in range(steps):
            out[0], _, _ = drive(out[0])

    prof, kernels, wall_us, busy = profile_run(run)
    state = out[0]
    if not kernels:
        print("# profiler: no device events recorded")
        return state
    print(f"# profile over {steps} steps: wall {wall_us / steps / 1e3:.3f} "
          f"ms/step, device busy {busy / steps / 1e3:.3f} ms/step "
          f"(idle share {1 - busy / wall_us:.3f}), {len(kernels) / steps:.0f} "
          f"kernels/step")
    top_kernels(kernels, steps, top)
    attr = ("self_device_time_total" if hasattr(
        prof.key_averages()[0], "self_device_time_total")
        else "self_cuda_time_total")
    ops = [a for a in prof.key_averages()
           if a.key.startswith("aten::") and getattr(a, attr) > 0]
    for a in sorted(ops, key=lambda a: -getattr(a, attr))[:top]:
        print(f"#   op {getattr(a, attr) / steps / 1e3:9.3f} ms/step "
              f"x{a.count // steps:<5d} {a.key}")
    # the payload gathers' backward, by gather size (the window buckets';
    # the dense K5 payload is no longer gathered)
    from deblur4dgs_tpu_torch.ops.tiling import num_tiles, pad_tiles
    tx, ty = num_tiles((W, H))
    dense_shape = [pad_tiles(tx * ty), TILE_CAP]
    n_gathers = 0
    for a in prof.key_averages(group_by_input_shape=True):
        if a.key == "aten::embedding_dense_backward":
            print(f"#   gather backward {getattr(a, attr) / steps / 1e3:9.3f} "
                  f"ms/step x{a.count // steps:<3d} shapes "
                  f"{a.input_shapes[:2]}")
            n_gathers += a.count // steps
            check(list(a.input_shapes[1]) != dense_shape,
                  f"a gather backward of the dense payload's shape "
                  f"{dense_shape}")
    if gathers is not None:
        check(n_gathers == gathers, f"{n_gathers} gather backward calls per "
              f"step, expected {gathers}")
    return state


def small_inputs(wh, kind):
    """A small seeded scene (numpy arrays by JAX pytree path) and the
    batches of the ``kind`` step (STEP_KINDS) as numpy tuples."""
    from deblur4dgs_tpu_torch.convert import jax_key
    from deblur4dgs_tpu_torch.models.move_model import init_move_model

    Ws, Hs = wh
    rng = np.random.default_rng(5)
    arrays = {}
    for part, n in (("fg", 120), ("bg", 180)):
        m = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
        m[:, 2] += 2.5
        arrays.update({
            f"{part}.means": m,
            f"{part}.quats": rng.normal(size=(n, 4)).astype(np.float32),
            f"{part}.scales": rng.uniform(np.log(0.02), np.log(0.09),
                                          (n, 3)).astype(np.float32),
            f"{part}.colors": rng.normal(size=(n, 3)).astype(np.float32),
            f"{part}.opacities": rng.uniform(0, 3, n).astype(np.float32),
            f"{part}.alive": np.ones(n, np.float32),
        })
    arrays["fg.motion_coefs"] = rng.normal(size=(120, 4)).astype(np.float32)
    arrays["bases.rots"] = np.tile(np.array([1.0, 0, 0, 0, 1, 0], np.float32),
                                   (4, 8, 1))
    arrays["bases.transls"] = (0.05 * rng.normal(size=(4, 8, 3))).astype(
        np.float32)
    mv = init_move_model(torch.Generator().manual_seed(1), 8, device="cpu")
    for name, x in mv.named_parameters():
        key, tr_ = jax_key("move." + name)
        a = x.detach().numpy()
        arrays[key] = a.T if tr_ else a
    f = 110.0 * Ws / 128
    K = np.array([[f, 0, Ws / 2], [0, f, Hs / 2], [0, 0, 1]], np.float32)
    eye = np.eye(4, dtype=np.float32)

    def frames(ts, rect):
        B = len(ts)
        if rect:
            masks = np.zeros((B, Hs, Ws), np.float32)
            masks[:, Hs // 4 : Hs // 2, Ws // 4 : Ws // 2] = 1.0
        else:
            masks = (rng.uniform(size=(B, Hs, Ws)) < 0.3).astype(np.float32)
        w2cs = np.tile(eye, (B, 1, 1))
        w2cs[:, 0, 3] = 0.02 * (np.arange(B) - B // 2)
        return (np.asarray(ts, np.int32), w2cs, np.tile(K, (B, 1, 1)),
                rng.uniform(0, 1, (B, Hs, Ws, 3)).astype(np.float32), masks,
                np.ones((B, Hs, Ws), np.float32),
                rng.uniform(2, 8, (B, Hs, Ws)).astype(np.float32))

    dyn = frames([5], rect=False)
    tracks = (np.stack([rng.integers(0, Ws, 64), rng.integers(0, Hs, 64)],
                       -1).astype(np.float32),
              np.array([4, 6], np.int32), np.tile(eye, (2, 1, 1)),
              np.tile(K, (2, 1, 1)),
              rng.uniform(0, Ws, (2, 64, 2)).astype(np.float32),
              np.ones((2, 64), np.float32), np.ones((2, 64), np.float32),
              rng.uniform(2, 8, (2, 64)).astype(np.float32))
    if kind == "dynamic":
        return arrays, (None, dyn, tracks, None, None)
    static = frames([4, 5, 6], rect=True)
    reg = frames([5], rect=True)
    b4 = rng.uniform(0, 1, (1, Hs // 4, Ws // 4, 3)).astype(np.float32)
    return arrays, step_args(kind, static, dyn, tracks, reg, b4)


def phase_small_vs_cpu(tr, errs, rates, wh=(128, 128), kind="dynamic",
                       expected=None, record=None, flow=False,
                       camera_mode="linear"):
    """(d) Two small-scene train steps (``kind`` of STEP_KINDS) on the card
    vs the CPU path. The card's run is counted (counters zeroed before,
    read after) and must launch ``expected`` kernels per step; ``record``
    names a compositor whose calls are timed and held against their
    twins; ``flow`` adds the exposure-consistency term, one torch-seeded
    PWC-Net's weights on both devices (EPOCH opens its gate);
    ``camera_mode`` is RenderConfig's."""
    from deblur4dgs_tpu_torch import configs as C
    from deblur4dgs_tpu_torch.convert import scene_from_numpy
    from deblur4dgs_tpu_torch.train import trainer as TT

    arrays, inputs = small_inputs(wh, kind)
    kinds = (TT.FrameBatch, TT.FrameBatch, TT.TrackBatch, TT.FrameBatch,
             None)
    label = (f"{kind} step {wh[0]}x{wh[1]}" + (", flow term" if flow else "")
             + (f", {camera_mode} camera" if camera_mode != "linear" else ""))
    results, rec, launches = {}, None, None
    for dev in (DEV, "cpu"):
        scene = scene_from_numpy(arrays, device=dev)
        state, step = make_step(kind, scene, 8,
                                C.RenderConfig(num_exposure=3, tile_cap=256,
                                               camera_mode=camera_mode),
                                flow_net(dev) if flow else None)
        conv = lambda x: torch.as_tensor(x, device=dev)
        args = [None if x is None else
                (conv(x) if kind is None else kind(*map(conv, x)))
                for kind, x in zip(kinds, inputs)]
        out = []
        with contextlib.ExitStack() as stack:
            if dev == DEV:
                zero_launches(tr)
                if record:
                    rec = stack.enter_context(recording(tr, record))
            for _ in range(2):
                state, loss, aux = step(state, EPOCH, *args)
                out.append((float(loss), {
                    f"{b}.{k}": v.cpu().numpy()
                    for b, a in aux.items() for k, v in a.items()}))
            if dev == DEV:
                torch.cuda.synchronize()
                launches = dict(tr.LAUNCHES)
        results[dev] = out
    print(f"# {label}, card launches over 2 steps: {launches}")
    for k in tr.LAUNCHES:
        want = (expected or {}).get(k, 0) * 2
        check(launches[k] == want,
              f"{label}: {k} launched {launches[k]} times, expected {want}")
    worst = 0.0
    for (lc, ac), (lp, ap) in zip(results[DEV], results["cpu"]):
        worst = max(worst, abs(lc - lp) / abs(lp))
        for k in ap:
            if k.endswith("radii"):  # ceil(3 sigma) may flip by 1 px
                continue
            d = np.abs(ac[k] - ap[k]).max() / (np.abs(ap[k]).max() + 1e-12)
            check(d <= 1e-4, f"{label} aux {k}: rel diff {d:.3e}")
    print(f"# {label}, card vs CPU: loss rel diff {worst:.3e}")
    check(worst <= 1e-5, f"{label}: loss rel diff {worst:.3e}")
    if record:  # the first of the two steps' calls: times are per step
        rec = {k: v[: len(v) // 2] for k, v in rec.items()}
        return launches, measure(tr, errs, record, rec, rates)
    return launches


# The evaluation path (phase_eval): the synthetic 720p scene of the JAX
# package's own smoke (scripts/tpu_720p_smoke.py:36-42) at the bench's
# Gaussian counts, and the validator's reference settings.
EVAL_FRAMES = 6
EVAL_VAL = (2, 3)  # the val frames validated (inner frames: deltaT > 0)
POSE_ITERS = 500  # the validator's refinement (validator.py:437)
# The perturbed start of the refinement: w2c_bad = [Ry(0.01 rad) | t] @ w2c
# with t = (0.02, -0.015, 0) in scene units (the camera sits 2.5 from the
# scene, so roughly 9 and 7 px of shift at 720p, and 11.5 px of rotation).
POSE_ROT_Y = 0.01
POSE_SHIFT = (0.02, -0.015, 0.0)
POSE_SMALL_ITERS = 50  # phase_pose_small_vs_cpu
PROF_ITERS = 10  # phase_eval: profiled iterations
# Its two perturbed starts: (axis-angle in radians, shift), the second
# about another axis with the shift in all three directions.
POSE_SMALL_OFFSETS = (((0.0, POSE_ROT_Y, 0.0), POSE_SHIFT),
                      ((-0.015, 0.0, 0.005), (-0.01, 0.02, 0.01)))


def perturbed(w2c, rot=(0.0, POSE_ROT_Y, 0.0), shift=POSE_SHIFT):
    """[exp(rot) | shift] @ w2c, rot an axis-angle in radians."""
    from deblur4dgs_tpu_torch.ops import lie

    w = torch.as_tensor(w2c, dtype=torch.float32)
    delta = lie.rt_to_mat4(lie.so3_exp(torch.tensor(rot)),
                           torch.tensor(shift))
    return (delta @ w).numpy()


@contextlib.contextmanager
def render_events(V):
    """A CUDA event recorded as each render of the validator module
    starts: a pose-refinement iteration spans from its render to the
    next one's (the last to the final render)."""
    events, orig = [], V.render

    def timed(*a, **k):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return orig(*a, **k)

    V.render = timed
    try:
        yield events
    finally:
        V.render = orig


def phase_pose_small_vs_cpu(tr):
    """The pose refinement of the 64x48 seeded scene of small_inputs (sparse
    Gaussians before a white background) for POSE_SMALL_ITERS iterations
    on the card (K5) and on the CPU (the twins) from the same perturbed
    identity camera, against the CPU's render at that camera, for each of
    POSE_SMALL_OFFSETS: each iteration's loss and the refined w2c. Adam
    normalises the gradients, so float32 differences of the renders carry
    into the steps and the agreement loosens over the iterations; the
    per-iteration differences are printed."""
    from deblur4dgs_tpu_torch.convert import scene_from_numpy
    from deblur4dgs_tpu_torch.eval import validator as V

    wh, t = (64, 48), 3
    kw = dict(num_exposure=NUM_EXPOSURE, cap=512)
    arrays, _ = small_inputs(wh, "dynamic")
    f = 110.0 * wh[0] / 128  # small_inputs' intrinsics
    K = np.array([[f, 0, wh[0] / 2], [0, f, wh[1] / 2], [0, 0, 1]],
                 np.float32)
    w2c = np.eye(4, dtype=np.float32)
    with torch.no_grad():
        gt_cpu = V.render(scene_from_numpy(arrays, device="cpu"), t,
                          torch.as_tensor(w2c), torch.as_tensor(K), wh,
                          mode="mid", **kw)["img"].numpy()
    pose_opt = V.make_pose_opt_fn(wh, num_iters=POSE_SMALL_ITERS, **kw)
    want = {"dense_fwd": POSE_SMALL_ITERS + 1, "dense_bwd": POSE_SMALL_ITERS}
    every = (0, 9, 19, 29, 39, 49)
    out = []
    for n, (rot, shift) in enumerate(POSE_SMALL_OFFSETS):
        label = f"pose 64x48 start {n} (rot {rot}, shift {shift})"
        res, launches = {}, None
        for dev in (DEV, "cpu"):
            model = scene_from_numpy(arrays, device=dev)
            if dev == DEV:
                zero_launches(tr)
            img, w2c_t, losses = pose_opt(
                model, t, perturbed(w2c, rot, shift), K, gt_cpu)
            if dev == DEV:
                torch.cuda.synchronize()
                launches = dict(tr.LAUNCHES)
            res[dev] = (losses.cpu().numpy(), w2c_t.cpu().numpy(),
                        img.cpu().numpy())
        for k in tr.LAUNCHES:
            check(launches[k] == want.get(k, 0),
                  f"{label}: {k} launched {launches[k]} times, expected "
                  f"{want.get(k, 0)}")
        (lc, wc, ic), (lp, wp, ip) = res[DEV], res["cpu"]
        gap = np.abs(lc - lp)
        rel = gap / np.abs(lp)
        check(np.all(np.isfinite(lc)) and lc[-1] < 0.5 * lc[0],
              f"{label} on the card: losses {lc[0]} -> {lc[-1]}")
        w2c_err = float(np.abs(wc - wp).max())
        img_err = float(np.abs(ic - ip).max())
        firsts = {f"{b:.0e}": int(np.argmax(rel > b)) if (rel > b).any()
                  else None for b in (1e-6, 1e-5, 1e-4)}
        print(f"# {label}, card vs CPU over {POSE_SMALL_ITERS} iterations: "
              f"loss {lp[0]:.6f} -> {lp[-1]:.6f} (least {lp.min():.6f}); "
              f"loss abs diff max {gap.max():.3e}; rel diff max "
              f"{rel.max():.3e}, at iterations {list(every)} "
              f"{[float(f'{rel[i]:.3e}') for i in every]}; first iteration "
              f"over 1e-6/1e-5/1e-4: {firsts}; refined w2c max abs diff "
              f"{w2c_err:.3e}, image {img_err:.3e}; launches {launches}")
        check(rel[:10].max() <= POSE_LOSS_REL_EARLY, f"{label} card vs CPU: "
              f"loss rel diff {rel[:10].max():.3e} in the first 10 "
              f"iterations, over {POSE_LOSS_REL_EARLY}")
        check(gap.max() <= POSE_LOSS_ABS, f"{label} card vs CPU: loss abs "
              f"diff {gap.max():.3e} over {POSE_LOSS_ABS}")
        check(w2c_err <= POSE_W2C_ATOL, f"{label} card vs CPU: w2c diff "
              f"{w2c_err:.3e} over {POSE_W2C_ATOL}")
        out.append({"rot": list(rot), "shift": list(shift),
                    "loss_first": float(lp[0]), "loss_last": float(lp[-1]),
                    "loss_abs_max": float(gap.max()),
                    "loss_rel_max": float(rel.max()),
                    "loss_rel_at": {i: float(rel[i]) for i in every},
                    "first_iter_over": firsts, "w2c_max_abs": w2c_err,
                    "img_max_abs": img_err})
    return {"iters": POSE_SMALL_ITERS, "starts": out}


def phase_eval(tr, errs, rates, card):
    """The evaluation path at full width: the port's synthetic 720p dataset
    rendered through K5 (100k Gaussians, S=11 blur samples, D=5: RGB, mask,
    depth), the ground-truth SceneModel, and two val frames validated with
    the validator's settings (cap 1024, S=11): validate_frame at the true
    pose and validate_frame_with_pose_opt for POSE_ITERS iterations from a
    perturbed camera (D=3: the generic K5 instance), with the port's
    torch-seeded LPIPS. Checks the launch counts, the losses, the PSNRs and
    the metrics; holds K5 against its twin on the refinement's first call
    and times it; profiles PROF_ITERS iterations."""
    from deblur4dgs_tpu_torch.data import synthetic as S
    from deblur4dgs_tpu_torch.eval import lpips as LP
    from deblur4dgs_tpu_torch.eval import metrics as M
    from deblur4dgs_tpu_torch.eval import validator as V

    kw = dict(num_exposure=NUM_EXPOSURE, cap=TILE_CAP)
    torch.cuda.synchronize()
    t0 = time.time()
    scene = S.make_scene(seed=0, num_fg=NUM_FG, num_bg=NUM_BG,
                         num_frames=EVAL_FRAMES, img_wh=(W, H), exposure=0.45,
                         cam_shake=0.02, exp_shake=0.015, device=DEV)
    zero_launches(tr)
    data = S.generate_dataset(scene, num_blur_samples=NUM_EXPOSURE,
                              num_tracks=128, fast_renderer=True)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    gen_launches = dict(tr.LAUNCHES)
    # per frame: S blur renders, the sharp render, the mask + depth render
    want = EVAL_FRAMES * (NUM_EXPOSURE + 2)
    for k in tr.LAUNCHES:
        check(gen_launches[k] == (want if k == "dense_fwd" else 0),
              f"dataset generation: {k} launched {gen_launches[k]} times")
    check(data.imgs.shape == (EVAL_FRAMES, H, W, 3)
          and all(np.isfinite(getattr(data, f)).all()
                  for f in ("imgs", "sharp_imgs", "depths", "tracks_2d")),
          "dataset: shapes or non-finite values")
    fg_share = float(data.masks.mean())
    check(0.0 < fg_share < 1.0, f"dataset: fg share {fg_share}")
    print(f"# eval dataset {W}x{H} ({NUM_FG} fg + {scene.bg.capacity} bg "
          f"Gaussians, {EVAL_FRAMES} frames x {NUM_EXPOSURE} blur samples): "
          f"{gen_s:.3f} s incl. scene; fg share {fg_share:.4f}; launches "
          f"{gen_launches}")

    model = S.gt_scene_model(scene)
    val = S.SyntheticSceneAdapter(scene, data, split="val")
    lp = LP.init_lpips(torch.Generator().manual_seed(0), device=DEV)

    def lpips_fn(a, b):
        return LP.lpips(lp, a[None], b[None]).mean()

    with torch.no_grad():
        x = torch.as_tensor(val.get_item(EVAL_VAL[0])["imgs"], device=DEV)
        lpips_self = float(lpips_fn(x, x))
    check(lpips_self == 0.0, f"LPIPS of an image against itself {lpips_self}")

    # The true pose re-renders the val frame's ground truth (the model IS
    # the ground truth), so its PSNR is infinite or near it; the refined
    # frames are scored by a second validator, whose metrics are finite.
    v_true = V.Validator(model, save_dir=None, lpips_fn=lpips_fn)
    v = V.Validator(model, save_dir=None, lpips_fn=lpips_fn)
    pose_opt = V.make_pose_opt_fn((W, H), num_iters=POSE_ITERS, **kw)
    frames, iter_ms = [], []
    rec = host = None
    for n, i in enumerate(EVAL_VAL):
        item = val.get_item(i)
        t, gt = item["ts"], item["imgs"]
        bad = perturbed(item["w2cs"])
        gt_dev = torch.as_tensor(gt, device=DEV)
        torch.cuda.synchronize()
        zero_launches(tr)
        v_true.validate_frame(t, item["w2cs"], item["Ks"], gt,
                              item["masks"], item["valid_masks"], (W, H),
                              **kw)
        with torch.no_grad():
            start = V.render(model, t, torch.as_tensor(bad, device=DEV),
                             torch.as_tensor(item["Ks"], device=DEV), (W, H),
                             mode="mid", **kw)["img"]
        psnr_start = M.compute_psnr(start, gt_dev)
        with contextlib.ExitStack() as stack:
            if n == 0:  # K5's first call of the refinement, both directions
                rec = stack.enter_context(recording(tr, "dense", first=1))
                host = stack.enter_context(recording_dense_host(tr, first=1))
            events = stack.enter_context(render_events(V))
            t1 = time.time()
            img, w2c_t, losses = v.validate_frame_with_pose_opt(
                pose_opt, t, bad, item["Ks"], gt, item["masks"],
                item["valid_masks"])
            torch.cuda.synchronize()
            pose_s = time.time() - t1
        launches = dict(tr.LAUNCHES)
        # validate_frame, the perturbed start, the iterations, the final
        want = {"dense_fwd": 1 + 1 + POSE_ITERS + 1, "dense_bwd": POSE_ITERS}
        for k in tr.LAUNCHES:
            check(launches[k] == want.get(k, 0),
                  f"eval frame {i}: {k} launched {launches[k]} times, "
                  f"expected {want.get(k, 0)}")
        check(len(events) == POSE_ITERS + 1, f"{len(events)} pose renders")
        ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        iter_ms.append(ms)
        losses = losses.cpu().numpy()
        psnr_ref = M.compute_psnr(img, gt_dev)
        print(f"# eval frame {i}: losses every 25 iterations "
              f"{[float(f'{x:.6f}') for x in losses[::25]]}")
        check(np.all(np.isfinite(losses)), f"eval frame {i}: loss not finite")
        check(losses[-1] < losses[0], f"eval frame {i}: loss {losses[0]} -> "
              f"{losses[-1]}")
        check(psnr_ref > psnr_start, f"eval frame {i}: PSNR {psnr_start} -> "
              f"{psnr_ref}")
        frames.append({
            "t": int(t), "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]),
            "loss_ratio": float(losses[-1] / losses[0]),
            "psnr_start": psnr_start, "psnr_refined": psnr_ref,
            "pose_s": pose_s, "ms_per_iter_median": statistics.median(ms),
            "w2c_refined": w2c_t.cpu().numpy().round(6).tolist(),
            "launches": launches})
        print(f"# eval frame {i}: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
              f"(ratio {losses[-1] / losses[0]:.4f}), PSNR {psnr_start:.3f}"
              f" -> {psnr_ref:.3f} dB; {POSE_ITERS} iterations in "
              f"{pose_s:.3f} s, median {statistics.median(ms):.3f} ms/iter "
              f"(min {min(ms):.3f}, max {max(ms):.3f}); launches {launches}")
    metrics, metrics_true = v.compute(), v_true.compute()
    check(all(np.isfinite(x) for x in metrics.values()),
          f"validator metrics of the refined frames not finite: {metrics}")
    check(not any(np.isnan(x) for x in metrics_true.values())
          and metrics_true["val/psnr"] > 60.0,
          f"the true pose does not reproduce the ground truth: "
          f"{metrics_true}")
    print(f"# eval metrics over {len(EVAL_VAL)} frames: refined {metrics}; "
          f"at the true pose {metrics_true}")

    check(len(rec["fwd"]) == 1 and len(rec["bwd"]) == 1
          and len(host["table"]) == 1 and len(host["grad"]) == 1,
          "the refinement's first K5 call was not recorded (forward, "
          "backward, table build, reduction: "
          f"{[len(rec['fwd']), len(rec['bwd'])]}, "
          f"{[len(host['table']), len(host['grad'])]})")
    check(rec["fwd"][0][4] == 3, f"the refinement's K5 call has D = "
          f"{rec['fwd'][0][4]}, expected 3")
    ms, plain, bounds, dev, fn_ms, parts, fn_dev = measure_dense(
        tr, errs, rec, host, rates)
    k5 = {d: {"ms": ms[d], "device_ms": dev[d], "plain_ms": plain[d],
              "bound_ms": bounds[d][0], "bound_by": bounds[d][1],
              "function_ms": fn_ms[d], "function_device_ms": fn_dev[d]}
          for d in ("fwd", "bwd")}
    print(f"# eval K5 D=3 call {tuple(rec['fwd'][0][1].shape)}: device "
          f"{dev['fwd']:.4f} / {dev['bwd']:.4f} ms against bounds "
          f"{bounds['fwd'][0]:.4f} ({bounds['fwd'][1]}) / "
          f"{bounds['bwd'][0]:.4f} ms ({bounds['bwd'][1]}); card {card}")
    del rec, host

    # A refinement of n iterations also sets up Adam and makes the final
    # render; profiling PROF_ITERS and 2 * PROF_ITERS iterations and taking
    # the difference leaves PROF_ITERS iterations alone.
    item = val.get_item(EVAL_VAL[1])
    runs = {}
    for n_it in (PROF_ITERS, 2 * PROF_ITERS):
        prof_opt = V.make_pose_opt_fn((W, H), num_iters=n_it, **kw)
        runs[n_it] = profile_run(lambda: prof_opt(
            model, item["ts"], perturbed(item["w2cs"]), item["Ks"],
            item["imgs"]))[1:]
        check(runs[n_it][0], "the pose refinement's profile recorded no "
              "device event")
    (k_a, wall_a, busy_a), (k_b, wall_b, busy_b) = runs.values()
    kernels_it = (len(k_b) - len(k_a)) / PROF_ITERS
    busy_it = (busy_b - busy_a) / PROF_ITERS / 1e3
    wall_it = (wall_b - wall_a) / PROF_ITERS / 1e3
    print(f"# eval profile, pose iterations {2 * PROF_ITERS} less "
          f"{PROF_ITERS}: wall {wall_it:.3f} ms/iter, device busy "
          f"{busy_it:.3f} ms/iter (idle share {1 - busy_it / wall_it:.3f}), "
          f"{kernels_it:.1f} kernels/iter; the {PROF_ITERS}-iteration run "
          f"with its set-up and final render: wall {wall_a / 1e3:.3f} ms, "
          f"busy {busy_a / 1e3:.3f} ms, {len(k_a)} kernels")
    top_kernels(k_b, PROF_ITERS, 12, minus=k_a)
    torch.cuda.empty_cache()
    return {
        "card": card, "img_wh": [W, H],
        "gaussians": NUM_FG + scene.bg.capacity, "frames": EVAL_FRAMES,
        "blur_samples": NUM_EXPOSURE, "cap": TILE_CAP,
        "pose_iters": POSE_ITERS,
        "pose_offset": {"rot_y_rad": POSE_ROT_Y, "shift": list(POSE_SHIFT)},
        "dataset_s": gen_s, "dataset_launches": gen_launches,
        "pose_ms_per_iter_median": statistics.median(iter_ms[-1]),
        "pose_ms_per_iter_median_frame1": statistics.median(iter_ms[0]),
        "k5_launches_per_iter": {"dense_fwd": 1, "dense_bwd": 1},
        "kernels_per_iter": kernels_it,
        "device_busy_ms_per_iter": busy_it,
        "wall_ms_per_iter_profiled": wall_it,
        "lpips_self": lpips_self, "metrics_refined": metrics,
        "metrics_true_pose": {k: (x if np.isfinite(x) else str(x))
                              for k, x in metrics_true.items()},
        "val_frames": frames,
        "k5_d3": k5,
    }


# ---------------------------------------------------------------------------
# The pipeline's capacities and exposure counts; the CLI end to end; the
# flow term
# ---------------------------------------------------------------------------

# The exposure counts of the quality tiers (scripts/tpu_quality_regression
# .py:165 / :177 / :238, S = 3, 5 and 9); S = 11 is the bench's.
PIPE_S = (3, 5, 9)
BIG_T = 24  # rows of the big-capacity cases


@torch.no_grad()
def phase_big_caps(tr, errs):
    """The window kernels (K1, K2/K3) at the pipeline's capacities
    (BIG_CAPS: the quality runs' 2048 and phase A's 4096) and exposure
    counts (PIPE_S), nchan 11 and 5: random buckets (rows from 9 on with a
    fiftieth of the opacity, so they run deep into the capacity before
    they stop) and edge_buckets; then the split path (K4, S=1) at the same
    caps. Against the twins at FWD_TOL / BWD_TOL."""
    n = 0
    for cap in BIG_CAPS:
        for S in PIPE_S:
            for nchan in (11, 5):
                seed = 500 + 10 * S + nchan + cap // 1024
                fa = random_bucket(seed, BIG_T, S, nchan, cap, 80, 3600,
                                   DEV) + (80, nchan, True)
                fa[1][9:, 0] *= 0.02
                label = f"cap={cap} S={S} nchan={nchan}"
                compare_case(tr, errs, "window", f"random {label}", fa, seed)
                _, tf = tr._COMPOSITORS["window"][1](*fa)
                check(float(tf[1:9].max()) < tr.EARLY_STOP_T,
                      f"window {label}: saturating rows did not saturate")
                compare_case(tr, errs, "window", f"edge {label}", edge_bucket(
                    seed + 1, BIG_T, S, nchan, cap, 80, 3600, DEV)
                    + (80, nchan, True), seed)
                n += 2
        for nchan in (11, 5):
            for maker in (random_bucket, edge_bucket):
                seed = 600 + nchan + cap // 1024
                dyn, st, counts, ids = maker(seed, BIG_T, 1, nchan, cap, 80,
                                             3600, DEV)
                if maker is random_bucket:
                    st[9:, 0] *= 0.02
                compare_case(tr, errs, "split",
                             f"{maker.__name__} cap={cap} nchan={nchan}",
                             (dyn[:, 0], st, counts, ids, 80, nchan, True),
                             seed)
                n += 1
    torch.cuda.synchronize()
    return n


# phase_pipeline: the port's CLI at full width. Only depth is cut (the
# epochs, steps, initial-optim and pose iterations below); the widths are
# the CLI's defaults (40k fg and 100k bg Gaussians, S = 11, tile cap 1024,
# phase A at min(4 * 1024, 4096)) over a synthetic 1280x720 scene of as
# many ground-truth Gaussians and tracks.
PIPE_FRAMES = 8
PIPE_POSE_ITERS = 20
PIPE_STEPS = 2  # per stage (1 epoch each)
PIPE_CUTS = ["--epochs-static", "1", "--epochs-dynamic", "1",
             "--steps-per-epoch", str(PIPE_STEPS), "--initial-optim-iters",
             "50", "--pose-opt-iters", str(PIPE_POSE_ITERS),
             "--validate-every", "1000"]
PIPE_NUM_BG = 100_000  # the CLI's --num-bg default
PIPE_WORK = os.path.join(HERE, "build", "chip_pipeline")


def pipe_args():
    """The CLI call of phase_pipeline (the CLI's default widths, PIPE_CUTS
    for depth)."""
    return (["train", "--synthetic", "--high-res", "--synthetic-wh", str(W),
             str(H), "--synthetic-frames", str(PIPE_FRAMES),
             "--synthetic-num-fg", str(NUM_FG), "--synthetic-num-bg",
             str(PIPE_NUM_BG), "--synthetic-tracks", str(NUM_FG),
             "--device", DEV] + PIPE_CUTS)


PIPE_BLUR = 7  # generate_dataset's blur samples (its default)


def pipeline_call(tr, work, label, argv=None):
    """One CLI call (``main(argv)``, by default pipe_args(), with
    ``--log-every 1``) on ``work``, the counters zeroed just before and
    read just after. Its
    stages come from the CLI's stage_callback: each stage runs from the
    previous stage's end (the call's start for 'static') to its own, so it
    holds the renders and the init before it, and 'testing' runs from the
    last window to the call's end. Per stage: wall s, launches, the step
    times (train/step_s) and the last step's tile_overflow per branch, both
    from the scalars the CLI's writer logs. Returns (launches, stages, wall
    s, metrics.json, stage 1's scene with a copy of its tensors)."""
    from deblur4dgs_tpu_torch import cli

    marks, static = [], {}

    def on_stage(tag, scene, window):
        torch.cuda.synchronize()
        marks.append((tag, time.time(), dict(tr.LAUNCHES)))
        if tag == "static":
            static["scene"] = scene
            static["copy"] = {n: v.clone() for n, v in
                              scene.state_dict().items()}

    scalars = os.path.join(work, "scalars.jsonl")
    n_old = 0
    if os.path.exists(scalars):
        with open(scalars) as f:
            n_old = len(f.readlines())
    torch.cuda.synchronize()
    zero_launches(tr)
    t0 = time.time()
    marks.append(("start", t0, dict(tr.LAUNCHES)))
    cli.main((argv or pipe_args()) + ["--work-dir", work, "--log-every",
                                      "1"], stage_callback=on_stage)
    torch.cuda.synchronize()
    marks.append(("testing", time.time(), dict(tr.LAUNCHES)))
    wall = marks[-1][1] - t0
    launches = dict(tr.LAUNCHES)
    with open(os.path.join(work, "metrics.json")) as f:
        metrics = json.load(f)
    with open(scalars) as f:
        logged = [json.loads(line) for line in f.readlines()[n_old:]]
    stages = []
    for (_, t_a, l_a), (tag, t_b, l_b) in zip(marks, marks[1:]):
        mine = [r for r in logged if t_a <= r["time"] < t_b]
        over = {}
        for r in mine:
            if r["tag"].endswith("/tile_overflow"):
                over[r["tag"].split("/")[1]] = r["value"]
        stages.append({
            "stage": tag, "s": t_b - t_a,
            "launches": {n: l_b[n] - l_a[n] for n in l_b},
            "steps_ms": [r["value"] * 1e3 for r in mine
                         if r["tag"] == "train/step_s"],
            "tile_overflow": over or None})
    print(f"# pipeline {label}: {wall:.3f} s, launches {launches}")
    for e in stages:
        med = statistics.median(e["steps_ms"]) if e["steps_ms"] else None
        print(f"#   {e['stage']}: {e['s']:.3f} s, steps "
              f"{[round(x, 3) for x in e['steps_ms']]} ms (median {med}), "
              f"tile_overflow {e['tile_overflow']}, launches "
              f"{ {k: v for k, v in e['launches'].items() if v} }")
    return launches, stages, wall, metrics, static


def check_pipeline_launches(label, launches, stages, wins, F, V,
                            dataset_renders):
    """Exact launches per stage of a pipeline_call with F train frames, V
    val frames and ``dataset_renders`` K5 renders made by the CLI before
    stage 1 (the synthetic dataset's; none for a scene on disk). A stage
    holds what ran since the one before: 'static' the dataset's renders,
    'dynamicA' the two stage-1 bg renders (full and x4), the first window
    phase A's guide renders; each stage's validation (epoch 0, its last)
    renders its val frames (V, a window's V / F per train frame) and the
    train videos at the CLI's --save-videos-every (epoch 0 % 50 == 0) one
    per train frame; testing refines every val frame."""
    from deblur4dgs_tpu_torch.ops.tiling import default_bucket_spec, num_tiles

    nb = len(default_bucket_spec(num_tiles((W, H))[0] * num_tiles((W, H))[1],
                                 TILE_CAP))
    tx4, ty4 = num_tiles((W // 4, H // 4))
    nb4 = len(default_bucket_spec(tx4 * ty4, min(4 * TILE_CAP, 4096)))
    S, ratio = PIPE_STEPS, V // F
    want = {"static": {"window_fwd": 3 * nb * S, "window_bwd": 3 * nb * S,
                       "dense_fwd": dataset_renders + V + F},
            "dynamicA": {"window_fwd": 2 * nb4 * S, "window_bwd": 2 * nb4 * S,
                         "dense_fwd": 2 * F + S + V + F, "dense_bwd": S},
            "testing": {"dense_fwd": V * (PIPE_POSE_ITERS + 1),
                        "dense_bwd": V * PIPE_POSE_ITERS}}
    first = True
    for e in stages:
        if e["stage"].startswith("win_"):
            lo, hi = int(e["stage"][4:6]), int(e["stage"][6:8])
            want[e["stage"]] = {
                "window_fwd": 2 * nb * S, "window_bwd": 2 * nb * S,
                "dense_fwd": F * first + S + (ratio + 1) * (hi - lo),
                "dense_bwd": S}
            first = False
        w_ = want.get(e["stage"], {})
        for k, v in e["launches"].items():
            check(v == w_.get(k, 0), f"{label} {e['stage']}: {k} launched "
                  f"{v} times, expected {w_.get(k, 0)}")
        n_steps = len(e["steps_ms"])
        check(n_steps == (0 if e["stage"] == "testing" else S),
              f"{label} {e['stage']}: {n_steps} logged steps")
    for k in ("window_fwd", "window_bwd", "dense_fwd", "dense_bwd"):
        check(launches[k] > 0, f"{label}: {k} never launched")
    stage_tags = [e["stage"] for e in stages]
    check(stage_tags == ["static", "dynamicA"] + wins + ["testing"],
          f"{label} stages {stage_tags}")


def phase_pipeline(tr, card):
    """The port's CLI end to end at 1280x720 (pipe_args()): stage 1, phase A
    at x4 (cap 4096), the ceil(8/5) = 2 phase-B windows, per-window testing
    with pose refinement, the metrics; then a second call on the same work
    dir, which must restore every stage, launch no window kernel and
    reproduce metrics.json. Checks the checkpoints, metrics.json, the test
    PNGs (through vis/png.py), every stage's exact launches, and that
    stage 2 left stage 1's scene unchanged."""
    import shutil

    from deblur4dgs_tpu_torch.vis.png import read_apng, read_png

    work = PIPE_WORK
    shutil.rmtree(work, ignore_errors=True)
    launches, stages, wall, metrics, static = pipeline_call(
        tr, work, "first call")
    check(all(np.isfinite(v) for v in metrics.values())
          and 0.0 <= metrics["val/ssim"] <= 1.0,
          f"pipeline metrics.json not finite: {metrics}")
    wins = sorted(d for d in os.listdir(os.path.join(work, "ckpts"))
                  if d.startswith("win_"))
    check(len(wins) == 2, f"phase-B windows {wins}")
    for tag in ["static", "dynamicA"] + wins:
        check(os.path.isfile(os.path.join(work, "ckpts", tag, "last")),
              f"pipeline: no checkpoint for {tag}")
    n_png = 0
    for w in wins:
        d = os.path.join(work, "results", w, "rgb_test_optim")
        for f in sorted(os.listdir(d)):
            img = read_png(os.path.join(d, f))
            check(img.shape == (H, W, 3), f"{d}/{f}: shape {img.shape}")
            n_png += 1
    check(n_png == 2 * PIPE_FRAMES, f"{n_png} test PNGs")
    # the train videos (Validator.save_train_videos, animated PNGs): every
    # stage writes <kind>_0 at its epoch-0 validation, the last window last
    lo, hi = int(wins[-1][4:6]), int(wins[-1][6:8])
    videos = {}
    for kind in ("rgb", "depth", "mask"):
        path = os.path.join(work, "results", "videos", f"{kind}_0.png")
        check(os.path.isfile(path), f"pipeline: no train video {path}")
        frames, _ = read_apng(path)
        check(frames.shape == (hi - lo, H, W, 3),
              f"pipeline: train video {kind}_0 holds {frames.shape}")
        videos[kind] = list(frames.shape)

    check_pipeline_launches("pipeline", launches, stages, wins, PIPE_FRAMES,
                            PIPE_FRAMES, PIPE_FRAMES * (PIPE_BLUR + 2))
    a_over = next(e["tile_overflow"] for e in stages
                  if e["stage"] == "dynamicA")
    check(a_over is not None, "phase A logged no tile_overflow")
    print(f"# pipeline phase A (x4, cap {min(4 * TILE_CAP, 4096)}) stage-end "
          f"tile_overflow {a_over}")
    same = all(torch.equal(v, static["copy"][n]) for n, v in
               static["scene"].state_dict().items())
    check(same, "stage 2 changed stage 1's scene")

    launches2, stages2, wall2, metrics2, _ = pipeline_call(tr, work,
                                                           "resumed")
    for k in ("window_fwd", "window_bwd", "split_fwd", "split_bwd"):
        check(launches2[k] == 0, f"resumed pipeline launched {k} "
              f"{launches2[k]} times")
    check(all(e["steps_ms"] == [] for e in stages2),
          "the resumed pipeline trained")
    gap = max(abs(metrics2[k] - metrics[k]) for k in metrics)
    print(f"# pipeline resumed: metrics {metrics2}; largest gap to the first"
          f" call {gap:.3e}")
    check(set(metrics2) == set(metrics) and gap <= PIPE_RESUME_ATOL,
          f"the resumed pipeline's metrics differ by {gap:.3e}")
    torch.cuda.empty_cache()
    return {
        "card": card, "argv": pipe_args(), "cuts": PIPE_CUTS,
        "img_wh": [W, H], "frames": PIPE_FRAMES, "wall_s": wall,
        "resumed_wall_s": wall2, "metrics": metrics,
        "resume_metrics_gap": gap, "launches": launches,
        "train_videos": videos,
        "resumed_launches": launches2, "phase_a_tile_overflow": a_over,
        "stages": stages,
        "resumed_stages": [{k: e[k] for k in ("stage", "s", "launches")}
                           for e in stages2],
    }


# phase_stereo: the user's entry point for a real scene, ``train
# --data-dir``, on a scene that this script writes in the Shape-of-Motion
# layout StereoDataset reads: phase_pipeline's synthetic 1280x720 scene
# (NUM_FG fg and PIPE_NUM_BG bg ground-truth Gaussians, NUM_FG tracks) over
# STEREO_FRAMES frames, the sharp frames in a ground-truth directory of
# their own; the CLI's widths and PIPE_CUTS as in phase_pipeline, no
# resumed call (phase_pipeline proves resume). Then ``metrics --gt-dir``
# on the card and the CPU, and HDBSCAN on the bench scene's tracks.
STEREO_FRAMES = 16  # on disk: the even 8 train, in 2 windows; 16 val
STEREO_WORK = os.path.join(HERE, "build", "chip_stereo")
TRACK_LOGIT = 5.0  # |occlusion / distance logit| of the written tracks
STEREO_METRICS_RTOL = 1e-5  # metrics --gt-dir, card against CPU
HDB_SUBSET = 4000  # tracks of the card-vs-CPU HDBSCAN check


def stereo_args(data_dir):
    """phase_stereo's CLI call: pipe_args()'s widths and cuts on a scene
    directory (the model's capacities are the CLI's defaults in both)."""
    return ["train", "--data-dir", data_dir, "--high-res", "--device",
            DEV] + PIPE_CUTS


def write_colmap_binary(sparse, K, w2cs, names, wh):
    """COLMAP's binary sparse model: cameras.bin with one PINHOLE camera
    (fx, fy, cx, cy) and images.bin with each frame's world-to-camera
    rotation as a unit quaternion (w, x, y, z) and translation, no 2D
    points (the format data/colmap.py reads)."""
    import struct

    from deblur4dgs_tpu_torch.data.colmap import rotmat_to_qvec

    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<QiiQQ", 1, 1, 1, wh[0], wh[1]))
        f.write(struct.pack("<4d", K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, (name, w2c) in enumerate(zip(names, w2cs)):
            w2c = np.asarray(w2c, np.float64)
            f.write(struct.pack("<i4d3di", i + 1, *rotmat_to_qvec(w2c[:3, :3]),
                                *w2c[:3, 3], 1))
            f.write(name.encode() + b"\0" + struct.pack("<Q", 0))


def write_stereo_scene(root, gt_dir):
    """The synthetic scene (the CLI's make_scene + generate_dataset on the
    tile path) written as a scene directory: images/ (blurry frames) and
    flow3d_preprocessed/masks/ as PNGs, aligned_depth_anything_colmap/
    (inverse depth), 2d_tracks/{a}_{b}.npy for every pair of train frames
    (query frame a's tracks at frame b: x, y, occlusion logit, distance
    logit; the NUM_FG tracks split between the query frames),
    colmap/sparse/; the sharp frames as {name}.png in gt_dir. Returns
    ({path: the array written}, the tracks' visible share)."""
    from deblur4dgs_tpu_torch.data import synthetic
    from deblur4dgs_tpu_torch.vis.png import write_png

    sscene = synthetic.make_scene(
        seed=0, num_fg=NUM_FG, num_bg=PIPE_NUM_BG, num_frames=STEREO_FRAMES,
        img_wh=(W, H), device=DEV)
    data = synthetic.generate_dataset(sscene, num_tracks=NUM_FG,
                                      fast_renderer=True)
    del sscene
    pre = os.path.join(root, "flow3d_preprocessed")
    dirs = {k: os.path.join(pre, k) for k in (
        "masks", "aligned_depth_anything_colmap", "2d_tracks",
        "colmap/sparse")}
    dirs["images"] = os.path.join(root, "images")
    for d in list(dirs.values()) + [gt_dir]:
        os.makedirs(d, exist_ok=True)
    u8 = lambda x: (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    names = [f"{i:05d}" for i in range(STEREO_FRAMES)]
    written = {}
    for i, n in enumerate(names):
        for path, img in (
                (os.path.join(dirs["images"], f"{n}.png"), u8(data.imgs[i])),
                (os.path.join(dirs["masks"], f"{n}.png"),
                 (data.masks[i] > 0.5).astype(np.uint8) * 255),
                (os.path.join(gt_dir, f"{n}.png"), u8(data.sharp_imgs[i]))):
            write_png(path, img)
            written[path] = img
        np.save(os.path.join(dirs["aligned_depth_anything_colmap"],
                             f"{n}.npy"),
                (1.0 / np.maximum(data.depths[i], 1e-3)).astype(np.float32))
    occ = np.where(data.track_visibles, -TRACK_LOGIT, TRACK_LOGIT)
    train = list(range(0, STEREO_FRAMES, 2))  # the loader's train frames
    for i, a in enumerate(train):
        # TAPIR's layout: each query frame its own query points (here the
        # tracks i mod F seen in frame a), {a}_{b} their positions at b
        sel = np.nonzero((np.arange(NUM_FG) % len(train) == i)
                         & data.track_visibles[a])[0]
        conf = np.full((len(sel), 1), -TRACK_LOGIT)
        for b in train:
            np.save(os.path.join(dirs["2d_tracks"],
                                 f"{names[a]}_{names[b]}.npy"),
                    np.concatenate([data.tracks_2d[b][sel],
                                    occ[b][sel, None], conf], -1
                                   ).astype(np.float32))
    write_colmap_binary(dirs["colmap/sparse"], data.Ks[0], data.w2cs,
                        [f"{n}.png" for n in names], (W, H))
    return written, float(data.track_visibles[train].mean())


def metrics_call(args):
    """The CLI's ``metrics`` subcommand in-process: its printed JSON."""
    import io

    from deblur4dgs_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["metrics"] + args)
    return json.loads(buf.getvalue())


def bench_tracks(scene0):
    """The bench scene's tracks: its fg Gaussians' world positions over its
    NUM_FRAMES frames, all visible, confidence 1."""
    from deblur4dgs_tpu_torch.data.observations import TrackObservations
    from deblur4dgs_tpu_torch.models.scene import compute_poses_fg

    with torch.no_grad():
        xyz, _ = compute_poses_fg(scene0, torch.arange(
            NUM_FRAMES, dtype=torch.float32, device=DEV))
        seen = torch.ones(xyz.shape[:2], dtype=torch.bool, device=DEV)
        return TrackObservations(xyz.contiguous(), seen, ~seen, seen.float(),
                                 scene0.fg.get_colors())


def phase_hdbscan():
    """sample_initial_bases_centers(mode="hdbscan") on the bench tracks
    (NUM_FG x 3 (NUM_FRAMES - 1) velocity directions) on the card, timed;
    its parts timed once more; the card's labels and mutual-reachability
    matrix against the CPU's on the first HDB_SUBSET tracks; the card's
    labels against the CPU's on HDB_SUBSET seeded points in 8 blobs and
    uniform noise (21 dimensions), where clusters are sure to form."""
    from deblur4dgs_tpu_torch.data.observations import TrackObservations
    from deblur4dgs_tpu_torch.train import hdbscan as HD
    from deblur4dgs_tpu_torch.train import init as I

    tracks = bench_tracks(bench_scene_batches(DEV)[0])
    torch.cuda.synchronize()
    t0 = time.time()
    centers, labels = I.sample_initial_bases_centers(
        0, tracks, LIFE_BASES, mode="hdbscan", device=DEV)
    seconds = time.time() - t0
    check(np.isfinite(centers).all() and len(centers) == labels.max() + 1,
          f"hdbscan: centres {centers.shape}, labels up to {labels.max()}")
    xyz = tracks.xyz.cpu().numpy()  # all visible: no interpolation
    vel = xyz[:, 1:] - xyz[:, :-1]
    x = (vel / (np.linalg.norm(vel, axis=-1, keepdims=True) + 1e-5)
         ).reshape(len(xyz), -1).astype(np.float64)
    n = len(x)
    parts = {}
    torch.cuda.synchronize()
    t0 = time.time()
    mr = HD.mutual_reachability(torch.as_tensor(x, device=DEV), 20)
    torch.cuda.synchronize()
    parts["distances_s"] = time.time() - t0
    t0 = time.time()
    mst = HD.prim_mst(mr)
    parts["prim_s"] = time.time() - t0
    del mr
    t0 = time.time()
    tree = HD.condense_tree(HD.single_linkage(mst), 20)
    raw = HD.get_clusters(tree, HD.compute_stability(tree), max(n // 4, 21))
    parts["tree_s"] = time.time() - t0
    check(np.array_equal(np.where(raw < 0, 0, raw), labels),
          "hdbscan: the parts' labels differ from the entry point's")
    sub = TrackObservations(*[v[:HDB_SUBSET] for v in tracks])
    xs = torch.as_tensor(x[:HDB_SUBSET])
    mr_card = HD.mutual_reachability(xs.to(DEV), 20).cpu()
    mr_cpu = HD.mutual_reachability(xs, 20)
    check(torch.equal(mr_card, mr_cpu), "hdbscan: the card's mutual "
          "reachability differs from the CPU's "
          f"(max {float((mr_card - mr_cpu).abs().max()):.3e})")
    _, l_card = I.sample_initial_bases_centers(
        0, sub, LIFE_BASES, mode="hdbscan", device=DEV)
    t0 = time.time()
    _, l_cpu = I.sample_initial_bases_centers(
        0, sub, LIFE_BASES, mode="hdbscan", device="cpu")
    cpu_s = time.time() - t0
    check(np.array_equal(l_card, l_cpu),
          f"hdbscan: card and CPU labels differ on {HDB_SUBSET} tracks "
          f"({int((l_card != l_cpu).sum())} of them)")
    rng = np.random.default_rng(0)
    blobs = rng.normal(size=(8, 21))[rng.integers(0, 8, HDB_SUBSET)]
    xs = blobs + 0.2 * rng.normal(size=blobs.shape)
    wild = rng.uniform(size=HDB_SUBSET) < 0.2
    xs[wild] = rng.uniform(-2, 2, (int(wild.sum()), 21))
    cap = max(HDB_SUBSET // 4, 21)
    s_card, s_cpu = (HD.hdbscan_labels(xs, 20, cap, device=d)
                     for d in (DEV, "cpu"))
    check(np.array_equal(s_card, s_cpu) and s_cpu.max() >= 1,
          f"hdbscan: card and CPU labels differ on the blobs "
          f"({int((s_card != s_cpu).sum())} of them), or no clusters")
    torch.cuda.empty_cache()
    out = {"tracks": n, "dims": x.shape[1], "seconds": seconds,
           "clusters": int(raw.max()) + 1, "noise": int((raw < 0).sum()),
           "largest": int(np.bincount(raw[raw >= 0]).max()) if raw.max() >= 0
           else 0, **parts, "subset": HDB_SUBSET,
           "subset_clusters": int(l_cpu.max()) + 1, "subset_cpu_s": cpu_s,
           "subset_card_equals_cpu": True,
           "blobs_clusters": int(s_cpu.max()) + 1,
           "blobs_noise": int((s_cpu < 0).sum()),
           "blobs_card_equals_cpu": True}
    print(f"# hdbscan on {n} x {x.shape[1]}: {seconds:.3f} s through the "
          f"entry point ({parts['distances_s']:.3f} s distances, "
          f"{parts['prim_s']:.3f} s Prim, {parts['tree_s']:.3f} s tree), "
          f"{out['clusters']} clusters, {out['noise']} noise; {HDB_SUBSET} "
          f"tracks: card == CPU ({cpu_s:.3f} s on the CPU); {HDB_SUBSET} "
          f"blob points: {out['blobs_clusters']} clusters, "
          f"{out['blobs_noise']} noise, card == CPU")
    return out


def phase_stereo(tr, card):
    """``train --data-dir --high-res`` at 1280x720 end to end on a scene
    this phase writes (write_stereo_scene): every frame and mask read back
    through vis/png.py equal to what was written, the loader's time, the
    CLI call (pipeline_call: stage wall times, step medians, exact
    launches per stage, check_pipeline_launches), the checkpoints, the test
    PNGs and a finite metrics.json; ``metrics --gt-dir`` on the card
    against the CPU (STEREO_METRICS_RTOL); then phase_hdbscan."""
    import shutil

    from deblur4dgs_tpu_torch.data.stereo import (
        StereoDataConfig, StereoDataset)
    from deblur4dgs_tpu_torch.vis.png import read_png

    work = STEREO_WORK
    scene_dir, gt_dir = os.path.join(work, "scene"), os.path.join(work, "gt")
    run = os.path.join(work, "run")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.time()
    written, vis_share = write_stereo_scene(scene_dir, gt_dir)
    write_s = time.time() - t0
    t0 = time.time()
    for path, img in written.items():
        back = read_png(path)
        check(back.dtype == img.dtype and np.array_equal(back, img),
              f"stereo: read_png({path}) differs from the array written")
    read_s = time.time() - t0
    t0 = time.time()
    train_ds = StereoDataset(StereoDataConfig(
        data_dir=scene_dir, intrinsics_scale=1.0))
    val_ds = StereoDataset(StereoDataConfig(
        data_dir=scene_dir, split="val", intrinsics_scale=1.0),
        scene_norm=train_ds.scene_norm)
    load_s = time.time() - t0
    F = STEREO_FRAMES // 2
    check(len(train_ds) == F and len(val_ds) == STEREO_FRAMES
          and train_ds.imgs.shape == (F, H, W, 3)
          and set(np.unique(train_ds.masks)) <= {0.0, 1.0},
          f"stereo: loaded {len(train_ds)} / {len(val_ds)} frames, "
          f"{train_ds.imgs.shape}")
    del train_ds, val_ds
    print(f"# stereo scene: {len(written)} PNGs written in {write_s:.3f} s "
          f"(with the dataset's renders), read back equal in {read_s:.3f} "
          f"s; StereoDataset train + val loaded in {load_s:.3f} s; tracks "
          f"visible {vis_share:.4f}")

    launches, stages, wall, metrics, _ = pipeline_call(
        tr, run, "stereo (train --data-dir)", stereo_args(scene_dir))
    check(all(np.isfinite(v) for v in metrics.values())
          and 0.0 <= metrics["val/ssim"] <= 1.0,
          f"stereo metrics.json not finite: {metrics}")
    wins = sorted(d for d in os.listdir(os.path.join(run, "ckpts"))
                  if d.startswith("win_"))
    check(len(wins) == 2, f"stereo phase-B windows {wins}")
    for tag in ["static", "dynamicA"] + wins:
        check(os.path.isfile(os.path.join(run, "ckpts", tag, "last")),
              f"stereo: no checkpoint for {tag}")
    n_png = 0
    for w in wins:
        d = os.path.join(run, "results", w, "rgb_test_optim")
        for f in sorted(os.listdir(d)):
            img = read_png(os.path.join(d, f))
            check(img.shape == (H, W, 3), f"{d}/{f}: shape {img.shape}")
            n_png += 1
    check(n_png == 2 * STEREO_FRAMES, f"stereo: {n_png} test PNGs")
    # the loader's val split holds every frame on disk, its train split
    # the even ones; the scene is on disk: the CLI renders no dataset
    check_pipeline_launches("stereo", launches, stages, wins, F,
                            STEREO_FRAMES, 0)

    margs = ["--result-dir", os.path.join(run, "results"), "--gt-dir",
             gt_dir]
    t0 = time.time()
    m_card = metrics_call(margs + ["--device", DEV])
    metrics_s = time.time() - t0
    m_cpu = metrics_call(margs + ["--device", "cpu"])
    gap = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
              for k in m_cpu)
    check(set(m_card) == set(m_cpu) == {"psnr", "ssim"}
          and all(np.isfinite(v) for v in m_card.values())
          and gap <= STEREO_METRICS_RTOL,
          f"stereo metrics --gt-dir: card {m_card}, CPU {m_cpu}")
    print(f"# stereo metrics --gt-dir: card {m_card} in {metrics_s:.3f} s, "
          f"CPU {m_cpu}, largest relative gap {gap:.3e}")
    torch.cuda.empty_cache()
    hdb = phase_hdbscan()
    return {
        "card": card, "argv": stereo_args("<scene>"), "cuts": PIPE_CUTS,
        "img_wh": [W, H], "frames_on_disk": STEREO_FRAMES,
        "train_frames": F, "val_frames": STEREO_FRAMES,
        "gt_gaussians": [NUM_FG, PIPE_NUM_BG], "tracks": NUM_FG,
        "tracks_visible_share": vis_share, "scene_write_s": write_s,
        "png_read_back_s": read_s, "pngs_read_back": len(written),
        "dataset_load_s": load_s, "wall_s": wall, "metrics": metrics,
        "launches": launches, "stages": stages,
        "metrics_gt_dir": {"card": m_card, "cpu": m_cpu, "rel_gap": gap,
                           "card_s": metrics_s},
        "hdbscan": hdb,
    }


# phase_viewer: the viewer slice on phase_pipeline's last window
# checkpoint (the CLI's 40k fg / 100k bg capacities at 1280x720).
VIEW_PATH_FRAMES = 24
VIEW_SMALL_WH = (512, 288)  # the viewer's default frame
VIEW_REQUESTS = 5  # timed /render requests
VIEW_LOOP_WH = (64, 48)
VIEW_LOOP_STEPS = 3  # steps 9-11 of small_loop: a densify at step 10


def view_keyframes(num_frames):
    """4 keyframes with times about the synthetic scene's cameras (at
    z = -2.5 looking down +z, data/synthetic.py::make_scene) with its
    vertical field of view (focal 0.9 * max(W, H))."""
    fov = 2.0 * float(np.arctan(0.5 * H / (0.9 * max(W, H))))
    out = []
    for i, (x, y, yaw) in enumerate(((-0.15, 0.0, 0.06), (0.0, -0.08, 0.0),
                                     (0.15, 0.04, -0.06),
                                     (0.05, 0.08, 0.02))):
        c2w = np.eye(4)
        c2w[0, 0] = c2w[2, 2] = np.cos(yaw)
        c2w[0, 2], c2w[2, 0] = np.sin(yaw), -np.sin(yaw)
        c2w[:3, 3] = (x, y, -2.5)
        out.append({"c2w": c2w.tolist(), "fov": fov,
                    "time": round(i * (num_frames - 1) / 3)})
    return out


def frame_float(renderer, cam, wh, t):
    """render_fn's render before it is quantized: (H, W, 3) float on the
    renderer's device."""
    from deblur4dgs_tpu_torch.models.scene import render

    Wv, Hv = wh
    dev = renderer.scene.fg.means.device
    focal = 0.5 * Hv / np.tan(0.5 * cam.fov)
    K = np.asarray([[focal, 0.0, Wv / 2.0], [0.0, focal, Hv / 2.0],
                    [0.0, 0.0, 1.0]], np.float32)
    w2c = np.linalg.inv(cam.c2w.astype(np.float32))
    with torch.inference_mode():
        out = render(renderer.scene, t, torch.as_tensor(w2c, device=dev),
                     torch.as_tensor(K, device=dev), wh, mode="mid",
                     stage="second", num_exposure=renderer.num_exposure,
                     cap=renderer.cap)
        return torch.clamp(out["img"], 0, 1)


def post(base, route, body):
    import urllib.request

    req = urllib.request.Request(base + route, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers.get("Content-Type"), r.read()


def decode_png(blob):
    """A PNG's pixels (vis/png.py reads files)."""
    import tempfile

    from deblur4dgs_tpu_torch.vis.png import read_png

    with tempfile.NamedTemporaryFile(suffix=".png",
                                     dir=os.path.join(HERE, "build")) as f:
        f.write(blob)
        f.flush()
        return read_png(f.name)


def phase_viewer(tr, card):
    """The viewer slice on phase_pipeline's last window checkpoint: (a) the
    CLI's render-path at 1280x720 over view_keyframes (24 path frames):
    the animated PNG decodes to 24 frames, exactly 24 K5 forward launches
    and no other; the frames rendered again (ms per frame, host clock) and
    profiled (K5's device time per frame, device busy); (b) one path frame
    at 512x288 on the card against the CPU twin (FWD_TOL on the float
    render, 1 level on the uint8 frame); (c) a DynamicViewer over the same
    Renderer on port 0: /render posed, canonical and with tracks, each PNG
    equal to render_fn's frame byte for byte, and the posed request timed;
    (d) a 64x48 stage-2 TrainLoop (small_loop, deterministic algorithms)
    with a TrainingViewer while a client thread POSTs renders: its state
    equals the same loop's without a viewer, bit for bit."""
    import io
    import threading

    from deblur4dgs_tpu_torch import cli
    from deblur4dgs_tpu_torch.train.checkpoints import template_state
    from deblur4dgs_tpu_torch.vis.png import read_apng
    from deblur4dgs_tpu_torch.vis.render_panel import (
        Keyframe, interpolate_camera_path, render_camera_path)
    from deblur4dgs_tpu_torch.vis.renderer import CameraState, Renderer
    from deblur4dgs_tpu_torch.vis.viewer import DynamicViewer, TrainingViewer

    work = PIPE_WORK
    win = sorted(d for d in os.listdir(os.path.join(work, "ckpts"))
                 if d.startswith("win_"))[-1]
    ckpt = os.path.join(work, "ckpts", win, "last")
    T = int(win[6:8]) - int(win[4:6])
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["scene"]
    n_fg, n_bg = saved["fg.means"].shape[0], saved["bg.means"].shape[0]
    n_bases = saved["bases.rots"].shape[0]
    n_move = saved["move.time_params"].shape[0]  # stage 1's: the clip's
    del saved
    kf_json = view_keyframes(T)
    kf_path = os.path.join(work, "view_keyframes.json")
    with open(kf_path, "w") as f:
        json.dump(kf_json, f)
    keyframes = [Keyframe(c2w=np.asarray(k["c2w"], np.float32), fov=k["fov"],
                          time=k["time"]) for k in kf_json]
    ckpt_args = ["--checkpoint", ckpt, "--num-frames", str(T), "--num-fg",
                 str(n_fg), "--num-bg", str(n_bg), "--num-motion-bases",
                 str(n_bases)]

    # (a) render-path through the CLI
    argv = (["render-path"] + ckpt_args
            + ["--keyframes", kf_path, "--out",
               os.path.join(work, "view_path.mp4"), "--path-frames",
               str(VIEW_PATH_FRAMES), "--width", str(W), "--height", str(H),
               "--device", DEV])
    buf = io.StringIO()
    torch.cuda.synchronize()
    zero_launches(tr)
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    launches = dict(tr.LAUNCHES)
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    frames, delays = read_apng(res["video"])
    print(f"# viewer: render-path ({W}x{H}, {VIEW_PATH_FRAMES} frames, "
          f"{win} at {n_fg} fg / {n_bg} bg) {cli_s:.3f} s through the CLI, "
          f"launches {launches}; {res}")
    check(res["frames"] == VIEW_PATH_FRAMES
          and frames.shape == (VIEW_PATH_FRAMES, H, W, 3),
          f"render-path wrote {frames.shape}, printed {res}")
    for k, v in launches.items():
        want = VIEW_PATH_FRAMES if k == "dense_fwd" else 0
        check(v == want, f"render-path: {k} launched {v} times, expected "
              f"{want}")
    check(int(frames.std()) > 0, "render-path: blank frames")

    renderer = Renderer.init_from_checkpoint(
        ckpt, template_state(n_fg, n_bg, n_bases, T, device=DEV,
                             num_move_frames=n_move), T)
    render_camera_path(renderer.render_fn, keyframes, (W, H), 2,
                       num_scene_frames=T)  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    again, _ = render_camera_path(renderer.render_fn, keyframes, (W, H),
                                  VIEW_PATH_FRAMES, num_scene_frames=T)
    frame_ms = (time.time() - t0) * 1e3 / VIEW_PATH_FRAMES
    gap = int(np.abs(again.astype(int) - frames.astype(int)).max())
    check(gap <= 1, f"render-path frames rendered again differ by {gap}")
    _, kernels, wall_us, busy = profile_run(
        lambda: render_camera_path(renderer.render_fn, keyframes, (W, H),
                                   VIEW_PATH_FRAMES, num_scene_frames=T),
        ops=False)
    k5_us = sum(e.time_range.elapsed_us() for e in kernels
                if "dense_fwd" in e.name)
    prof = {"wall_ms_per_frame": wall_us / VIEW_PATH_FRAMES / 1e3,
            "device_busy_ms_per_frame": (busy or 0) / VIEW_PATH_FRAMES / 1e3,
            "k5_device_ms_per_frame": k5_us / VIEW_PATH_FRAMES / 1e3,
            "kernels_per_frame": len(kernels) / VIEW_PATH_FRAMES}
    print(f"# viewer: render-path frame {frame_ms:.3f} ms (render_fn, host "
          f"clock, {W}x{H}); profiled {prof}; card {card}; top kernels "
          f"per frame:")
    top_kernels(kernels, VIEW_PATH_FRAMES, 8)

    # (b) one path frame at 512x288, card against the CPU twin
    w2cs, fovs, times = interpolate_camera_path(keyframes, VIEW_PATH_FRAMES)
    i = VIEW_PATH_FRAMES // 2
    cam = CameraState(fov=float(fovs[i]), aspect=VIEW_SMALL_WH[0] /
                      VIEW_SMALL_WH[1], c2w=torch.linalg.inv(w2cs[i]).numpy())
    t_i = min(max(int(round(float(times[i]))), 0), T - 1)
    cpu = Renderer.init_from_checkpoint(
        ckpt, template_state(n_fg, n_bg, n_bases, T, device="cpu",
                             num_move_frames=n_move), T)
    card_f = frame_float(renderer, cam, VIEW_SMALL_WH, t_i).cpu()
    cpu_f = frame_float(cpu, cam, VIEW_SMALL_WH, t_i)
    err = float((card_f - cpu_f).abs().max())
    rel = err / max(1.0, float(cpu_f.abs().max()))
    levels = int(np.abs(
        renderer.render_fn(cam, VIEW_SMALL_WH, t_i).astype(int)
        - cpu.render_fn(cam, VIEW_SMALL_WH, t_i).astype(int)).max())
    print(f"# viewer: path frame {i} (t={t_i}) at {VIEW_SMALL_WH}, card vs "
          f"CPU: max abs {err:.3e} (rel {rel:.3e}), uint8 levels {levels}")
    check(rel <= FWD_TOL and levels <= 1,
          f"viewer frame card vs CPU: rel {rel:.3e}, levels {levels}")
    del cpu

    # (c) the HTTP viewer on port 0
    view = DynamicViewer(renderer.render_fn, T, img_wh=VIEW_SMALL_WH, port=0)
    view.serve_forever(background=True)
    lat = []
    try:
        base = f"http://127.0.0.1:{view.port}"
        c2w = np.asarray(kf_json[1]["c2w"], np.float32)
        for body, t, tracks in (({"t": 2}, 2, False),
                                ({"t": 2, "canonical": True}, None, False),
                                ({"t": 2, "tracks": True}, 2, True)):
            ctype, blob = post(base, "/render", {"c2w": c2w.tolist(),
                                                 **body})
            want = renderer.render_fn(
                CameraState(fov=np.pi / 3, aspect=VIEW_SMALL_WH[0] /
                            VIEW_SMALL_WH[1], c2w=c2w), VIEW_SMALL_WH, t,
                render_tracks=tracks)
            got = decode_png(blob)
            check(ctype == "image/png" and np.array_equal(got, want),
                  f"viewer /render {body}: the PNG differs from render_fn's "
                  f"frame")
        for _ in range(VIEW_REQUESTS):
            t0 = time.time()
            post(base, "/render", {"c2w": c2w.tolist(), "t": 2})
            lat.append((time.time() - t0) * 1e3)
    finally:
        view.close()
    t0 = time.time()
    for _ in range(VIEW_REQUESTS):
        renderer.render_fn(CameraState(np.pi / 3, 16 / 9, c2w),
                           VIEW_SMALL_WH, 2)
    fn_ms = (time.time() - t0) * 1e3 / VIEW_REQUESTS
    print(f"# viewer: /render at {VIEW_SMALL_WH} {[round(x, 3) for x in lat]}"
          f" ms (median {statistics.median(lat):.3f}); render_fn alone "
          f"{fn_ms:.3f} ms; card {card}")
    del renderer, view
    torch.cuda.empty_cache()

    # (d) a TrainLoop with a TrainingViewer, bit for bit against none
    arrays, inputs = small_inputs(VIEW_LOOP_WH, "stage2")
    loop_work = os.path.join(HERE, "build", "chip_smoke")
    n_renders, errors = [0], []
    torch.use_deterministic_algorithms(True)
    try:
        plain, args = small_loop(DEV, arrays, inputs, loop_work)
        for _ in range(VIEW_LOOP_STEPS):
            plain.train_step(*args)
        tv = TrainingViewer(8, img_wh=VIEW_LOOP_WH, port=0, num_exposure=3,
                            cap=256)
        tv.serve_forever(background=True)
        stop = threading.Event()

        def client():
            base = f"http://127.0.0.1:{tv.port}"
            try:
                while not stop.is_set():
                    post(base, "/render", {"c2w": np.eye(4).tolist(),
                                           "t": 3, "tracks": True})
                    n_renders[0] += 1
            except Exception as e:  # reported below, in the main thread
                errors.append(repr(e))

        th = threading.Thread(target=client)
        th.start()
        try:
            viewed, args = small_loop(DEV, arrays, inputs, loop_work,
                                      viewer=tv)
            for _ in range(VIEW_LOOP_STEPS):
                viewed.train_step(*args)
            torch.cuda.synchronize()
        finally:
            stop.set()
            th.join(timeout=120)
            tv.close()
    finally:
        torch.use_deterministic_algorithms(False)
    check(not th.is_alive() and not errors, f"viewer client: {errors}")
    check(n_renders[0] > 0, "viewer client rendered nothing")
    assert_states_equal(state_tensors(plain.state),
                        state_tensors(viewed.state), "TrainingViewer loop")
    print(f"# viewer: {VIEW_LOOP_WH} stage-2 TrainLoop, {VIEW_LOOP_STEPS} "
          f"steps with a TrainingViewer and {n_renders[0]} renders beside "
          f"it == the loop without a viewer, bit for bit")
    return {"card": card, "checkpoint": win, "capacities": [n_fg, n_bg],
            "render_path": {"img_wh": [W, H], "frames": VIEW_PATH_FRAMES,
                            "launches": launches, "cli_s": cli_s,
                            "frame_ms": frame_ms, **prof},
            "card_vs_cpu_512x288": {"max_abs": err, "rel": rel,
                                    "uint8_levels": levels},
            "request_ms": lat, "render_fn_ms": fn_ms,
            "loop_renders": n_renders[0]}


# Bars of phase_flow's PWC-Net at 720p, card against CPU (both FP32, TF32
# off): the flow, the warp where both masks hold, and the share of pixels
# whose 0.999 mask threshold falls the other way. NVIDIA H100 80GB HBM3,
# 700 W, two calls: flow 1.07e-6 / 1.13e-6 of a 1.11 max, warp 6.9e-6, no
# flip.
FLOW_ATOL = 1e-4  # times max(1, max |flow|)
WARP_ATOL = 1e-4
MASK_FLIP_SHARE = 1e-4
FLOW_PROF = 1  # steps in phase_flow's profile


def flow_net(dev):
    """make_aligned_loss_fn of the torch-seeded PWC-Net (Generator seed 0,
    drawn on the CPU) on ``dev``."""
    from deblur4dgs_tpu_torch.models import pwcnet as P
    return P.make_aligned_loss_fn(
        P.init_pwcnet(torch.Generator().manual_seed(0), "cpu").to(dev))


def phase_flow(tr, errs, rates, card, s2_median_s):
    """The exposure-consistency term: the PWC-Net on a 720p pair on the
    card against the same weights on the CPU (flow, warp, mask); two 64x48
    stage-2 steps with flow_fn, card against CPU (phase_small_vs_cpu's
    bars); two bench-shape stage-2 steps with flow_fn (finite, timed), a
    profile of that step (top kernels, device busy), and the PWC-Net's
    forward and its correlations alone at the step's shapes."""
    from deblur4dgs_tpu_torch.models import pwcnet as P

    g = torch.Generator().manual_seed(3)
    base = torch.nn.functional.interpolate(
        torch.rand((1, 3, H // 16, W // 16), generator=g), size=(H, W),
        mode="bilinear", align_corners=False)
    a = base.permute(0, 2, 3, 1).contiguous()
    b = torch.roll(a, shifts=(3, 5), dims=(1, 2))
    out = {}
    for dev in (DEV, "cpu"):
        net = P.init_pwcnet(torch.Generator().manual_seed(0), "cpu").to(dev)
        fn = P.make_aligned_loss_fn(net)
        aa, bb = a.to(dev), b.to(dev)
        if dev == DEV:
            torch.cuda.synchronize()
        t0 = time.time()
        with torch.no_grad():
            flow = P.pwcnet_flow(net, aa, bb)
            aligned, mask = fn(aa, bb)
        if dev == DEV:
            torch.cuda.synchronize()
        out[dev] = (flow.cpu(), aligned.cpu(), mask.cpu(), time.time() - t0)
    (fc, ac, mc, tc), (fp, ap, mp, tp) = out[DEV], out["cpu"]
    fscale = max(1.0, float(fp.abs().max()))
    ferr = float((fc - fp).abs().max())
    both = (mc > 0) & (mp > 0)
    werr = float(((ac - ap).abs() * both).max())
    flips = float((mc != mp).float().mean())
    print(f"# flow {W}x{H} pair: card {tc:.3f} s, CPU {tp:.3f} s (first "
          f"call); "
          f"flow max |f| {fscale:.4f}, card vs CPU {ferr:.3e}; mask share "
          f"{float(mp.mean()):.4f}, flips {flips:.3e}; warp {werr:.3e}")
    check(ferr <= FLOW_ATOL * fscale, f"flow card vs CPU {ferr:.3e}")
    check(werr <= WARP_ATOL, f"warp card vs CPU {werr:.3e}")
    check(flips <= MASK_FLIP_SHARE, f"flow mask flips {flips:.3e}")

    small = phase_small_vs_cpu(tr, errs, rates, wh=(64, 48), kind="stage2",
                               flow=True, expected={
                                   "split_fwd": 3 * 4, "split_bwd": 3 * 4,
                                   "dense_fwd": 1, "dense_bwd": 1})

    nb = n_buckets()
    net = P.init_pwcnet(torch.Generator().manual_seed(0), "cpu").to(DEV)
    state, drive = bench_state(DEV, "stage2",
                               flow_fn=P.make_aligned_loss_fn(net))
    state, times, launches = drive_steps(
        tr, state, drive, "stage-2 step with the flow term",
        {"window_fwd": 4 * nb, "window_bwd": 4 * nb, "dense_fwd": 1,
         "dense_bwd": 1})
    med = statistics.median(times)
    pairs = 2 * (NUM_EXPOSURE - 1)
    print(f"# stage-2 step {W}x{H} with the flow term ({pairs} PWC-Net "
          f"pairs): median {med * 1e3:.3f} ms over {len(times)} steps; "
          f"without it {s2_median_s * 1e3:.3f} ms (phase c); card {card}")

    # Where the step's time goes: profiles of FLOW_PROF and 2 * FLOW_PROF
    # steps, whose difference holds FLOW_PROF steps alone; then the
    # PWC-Net's forward on the step's pairs and its five correlations
    # alone (CUDA events, inputs of the same shapes).
    runs = {}
    for n in (FLOW_PROF, 2 * FLOW_PROF):
        box = [state]

        def run(n=n):
            for _ in range(n):
                box[0], _, _ = drive(box[0])

        runs[n] = profile_run(run, ops=False)[1:]
        state = box[0]
        check(runs[n][0], "the flow step's profile recorded no device event")
    (k_a, wall_a, busy_a), (k_b, wall_b, busy_b) = runs.values()
    busy_ms = (busy_b - busy_a) / FLOW_PROF / 1e3
    wall_ms = (wall_b - wall_a) / FLOW_PROF / 1e3
    ksum_ms = (sum(e.time_range.elapsed_us() for e in k_b) - sum(
        e.time_range.elapsed_us() for e in k_a)) / FLOW_PROF / 1e3
    print(f"# flow step profile, {2 * FLOW_PROF} steps less {FLOW_PROF}: "
          f"wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), kernel times summed "
          f"{ksum_ms:.3f} ms/step, "
          f"{(len(k_b) - len(k_a)) / FLOW_PROF:.1f} kernels/step")
    top_kernels(k_b, FLOW_PROF, 15, minus=k_a)
    del state, drive
    torch.cuda.empty_cache()
    Hp, Wp = -(-H // 64) * 64, -(-W // 64) * 64
    g = torch.Generator().manual_seed(4)
    pa, pb = (torch.rand((pairs, H, W, 3), generator=g).to(DEV)
              for _ in range(2))
    with torch.no_grad():
        net_ms = cuda_ms(lambda: P.pwcnet_flow(net, pa, pb), 2)
        # the same forward with cuDNN's autotuner on (the port leaves it
        # off): how much the convolution algorithms it picks cost
        torch.backends.cudnn.benchmark = True
        try:
            net_tuned_ms = cuda_ms(lambda: P.pwcnet_flow(net, pa, pb), 2)
        finally:
            torch.backends.cudnn.benchmark = False
        f1, f2 = (net.netExtractor(torch.rand(
            (pairs, 3, Hp, Wp), generator=g).to(DEV)) for _ in range(2))
        corr_ms = [cuda_ms(lambda i=i: P.correlation(f1[-1 - i], f2[-1 - i]),
                           2) for i in range(5)]
    del pa, pb, f1, f2
    torch.cuda.empty_cache()
    print(f"# PWC-Net forward on {pairs} pairs at {W}x{H} ({Wp}x{Hp} "
          f"inside): {net_ms:.3f} ms ({net_tuned_ms:.3f} ms with cuDNN's "
          f"autotuner on); its correlations (levels 6 to 2) "
          f"{[round(x, 3) for x in corr_ms]} ms, {sum(corr_ms):.3f} ms in "
          f"all; the step's flow term {(med - s2_median_s) * 1e3:.3f} ms")
    return {"card": card, "pair_card_s": tc, "pair_cpu_s": tp,
            "flow_max_abs": fscale, "flow_err": ferr, "warp_err": werr,
            "mask_flip_share": flips, "small_launches": small,
            "stage2_flow_ms": [t * 1e3 for t in times],
            "stage2_flow_median_ms": med * 1e3,
            "stage2_median_ms": s2_median_s * 1e3,
            "profile_wall_ms_per_step": wall_ms,
            "profile_busy_ms_per_step": busy_ms,
            "profile_kernel_sum_ms_per_step": ksum_ms,
            "pwcnet_forward_ms": net_ms,
            "pwcnet_forward_autotuned_ms": net_tuned_ms,
            "correlation_ms": corr_ms}


# ---------------------------------------------------------------------------
# Multiple devices (phase_multidevice) and the plain path (phase_plain_path)
# ---------------------------------------------------------------------------

MD_WORK = os.path.join(HERE, "build", "chip_multidevice")
# timed steps per mode after the compared first one (a sub-frame-sharded
# step binned per view takes ~8-10 s on one card: phase_multidevice)
MD_TIMED = {"unsharded": 2, "tile": 2, "sub": 1}
MD_LOSS_REL = 1e-4  # tests/test_tile_sharding.py:157
MD_PARAM_REL = 5e-4  # tests/test_tile_sharding.py:163, of max |param|
MD_TIMEOUT = 300  # seconds per launch of ranks


def md_rank_main(argv):
    """One rank of phase_multidevice: ``chip_smoke.py --multidevice-rank R
    WORLD PORT BACKEND DEVICE JOB``. JOB "ref" (one rank, NCCL) runs the
    unsharded stage-2 step and the same step subframe-sharded over its
    one-rank mesh; "sharded" runs it with tile_mesh and with
    subframe_sharding over all ranks. Each mode starts from the bench
    scene: the first step is the one compared (its TrainState written to
    MD_WORK, its launches counted), then MD_TIMED[mode] timed steps.
    Prints one {"md_rank": ...} JSON line."""
    rank, world, port = (int(a) for a in argv[:3])
    backend, device, job = argv[3:6]
    import torch.distributed as dist

    from deblur4dgs_tpu_torch.convert import train_state_to_numpy
    from deblur4dgs_tpu_torch.ops import cuda_build
    from deblur4dgs_tpu_torch.ops import rasterize as tr
    from deblur4dgs_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic kernels, so that the ranks' replicated work agrees
    # bit for bit (warn_only: a kernel without a deterministic version
    # shows as a difference between the ranks' states)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cuda_build.load()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = pmesh.global_mesh(device=dev)
    sub = {"subframe_sharding": pmesh.subframe_sharding(mesh)}
    modes = ({"unsharded": {}, "sub": sub} if job == "ref" else
             {"tile": {"tile_mesh": mesh._replace(axis="tile")}, "sub": sub})
    out = {"rank": rank, "device": device, "transport": mesh.transport,
           "modes": {}}
    for mode, kw in modes.items():
        scene, batches = bench_scene_batches(dev)
        state, step = make_step("stage2", scene, NUM_FRAMES, bench_rcfg(),
                                **kw)
        args = step_args("stage2", *batches)
        zero_launches(tr)
        torch.cuda.synchronize()
        t0 = time.time()
        state, loss, _ = step(state, EPOCH, *args)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        launches = {k: v for k, v in tr.LAUNCHES.items() if v}
        np.savez(os.path.join(MD_WORK, f"{job}_{mode}_rank{rank}.npz"),
                 loss=np.float32(float(loss)),
                 **train_state_to_numpy(state))
        times = []
        for _ in range(MD_TIMED[mode]):
            t0 = time.time()
            state, loss, _ = step(state, EPOCH, *args)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        out["modes"][mode] = {"first_step_s": first_s, "launches": launches,
                              "step_ms": [t * 1e3 for t in times],
                              "finite": bool(np.isfinite(float(loss)))}
        del state, step, scene, batches
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    print(json.dumps({"md_rank": out}))
    return 0


def md_launch(world, backend, devices, job):
    """Run the ranks of one md_rank_main job in parallel; their JSON lines
    (rank order). Stops them all at MD_TIMEOUT."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multidevice-rank",
         str(r), str(world), str(port), backend, devices[r], job],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MD_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"multidevice {job} rank {r} failed "
              f"({p.returncode}):\n{so[-2000:]}\n{se[-4000:]}")
        line = [ln for ln in so.splitlines() if ln.startswith('{"md_rank"')]
        check(len(line) == 1, f"multidevice {job} rank {r}: no result")
        res.append(json.loads(line[0])["md_rank"])
    return res


def md_state(job, mode, rank):
    return dict(np.load(os.path.join(MD_WORK, f"{job}_{mode}_rank{rank}.npz")))


def phase_multidevice(tr, card):
    """The stage-2 step at the bench shape on several ranks (parallel/
    mesh.py): one rank per card over NCCL where two or more cards are
    visible, else two ranks on card 0 over gloo (NCCL refuses two ranks on
    one device); and a one-rank NCCL job, whose unsharded step is
    tile_mesh's reference and whose one-rank subframe-sharded step is
    subframe_sharding's (per-sub-frame binning orders each view by its own
    depths, the shared binning by the window's front-most ones, so the
    unsharded step composites some overlaps in another order). Each mode's
    first step from the bench scene: the loss to MD_LOSS_REL, every
    parameter to MD_PARAM_REL of its max |param|, the ranks' TrainStates
    equal bit for bit, each rank's launches exact."""
    n_cards = torch.cuda.device_count()
    torch.cuda.empty_cache()
    os.makedirs(MD_WORK, exist_ok=True)
    if n_cards >= 2:
        world, backend = n_cards, "nccl"
        devices = [f"cuda:{i}" for i in range(n_cards)]
    else:
        world, backend = 2, "gloo"
        devices = ["cuda:0"] * 2
    t0 = time.time()
    ref = md_launch(1, "nccl", ["cuda:0"], "ref")[0]
    ranks = md_launch(world, backend, devices, "sharded")
    print(f"# multidevice: {world} ranks on {devices} over "
          f"{ranks[0]['transport']}; references on one rank over "
          f"{ref['transport']}; card {card}")
    nb = n_buckets()
    S = NUM_EXPOSURE
    out = {"world": world, "devices": devices, "backend": backend,
           "transport": ranks[0]["transport"], "card": card, "modes": {}}
    for mode, ref_mode in (("tile", "unsharded"), ("sub", "sub")):
        want_ref = ({"window_fwd": 4 * nb, "window_bwd": 4 * nb,
                     "dense_fwd": 1, "dense_bwd": 1} if mode == "tile" else
                    {"dense_fwd": 4 * S + 1, "dense_bwd": 4 * S + 1})
        got = ref["modes"][ref_mode]["launches"]
        check(got == want_ref, f"multidevice ref {ref_mode}: launches {got}, "
              f"expected {want_ref}")
        a = md_state("ref", ref_mode, 0)
        loss_ref = float(a["loss"])
        worst_rel, worst_key = 0.0, None
        for r, rk in enumerate(ranks):
            m = rk["modes"][mode]
            check(m["finite"], f"multidevice {mode} rank {r}: non-finite")
            if mode == "tile":  # every rank composites its rows of each
                want = want_ref  # bucket; the reg render is not sharded
            else:  # its block of the 11 sub-frames, and the reg's one
                lo, hi = (min(r * -(-S // world), S),
                          min((r + 1) * -(-S // world), S))
                n = 4 * (hi - lo) + (1 if r == 0 else 0)
                want = {"dense_fwd": n, "dense_bwd": n}
            check(m["launches"] == want, f"multidevice {mode} rank {r}: "
                  f"launches {m['launches']}, expected {want}")
            b = md_state("sharded", mode, r)
            check(set(a) == set(b), f"multidevice {mode}: state keys differ")
            rel = abs(float(b["loss"]) - loss_ref) / abs(loss_ref)
            check(rel <= MD_LOSS_REL, f"multidevice {mode} rank {r}: loss "
                  f"{float(b['loss'])} against {loss_ref} (rel {rel:.3e})")
            for k in a:
                if not k.startswith("scene/"):
                    continue
                scale = float(np.abs(a[k]).max()) + 1e-8
                d = float(np.abs(b[k] - a[k]).max()) / scale
                if d > worst_rel:
                    worst_rel, worst_key = d, k
            if r:
                b0 = md_state("sharded", mode, 0)
                diff = [k for k in b0 if not np.array_equal(b0[k], b[k])]
                check(not diff, f"multidevice {mode}: rank {r}'s TrainState "
                      f"differs from rank 0's in {diff[:5]}")
        check(worst_rel <= MD_PARAM_REL, f"multidevice {mode}: parameter "
              f"{worst_key} rel {worst_rel:.3e}")
        per_rank = [statistics.median(rk["modes"][mode]["step_ms"])
                    for rk in ranks]
        ref_ms = statistics.median(ref["modes"][ref_mode]["step_ms"])
        out["modes"][mode] = {
            "reference": ref_mode, "loss_rel": abs(float(md_state(
                "sharded", mode, 0)["loss"]) - loss_ref) / abs(loss_ref),
            "param_rel": worst_rel, "step_ms_median_per_rank": per_rank,
            "reference_step_ms_median": ref_ms,
            "launches_per_rank": [rk["modes"][mode]["launches"]
                                  for rk in ranks],
            "first_step_s_per_rank": [rk["modes"][mode]["first_step_s"]
                                      for rk in ranks]}
        loss_rel = out["modes"][mode]["loss_rel"]
        print(f"# multidevice {mode}: loss rel {loss_rel:.3e}, parameters "
              f"rel {worst_rel:.3e} ({worst_key}), ranks "
              f"equal bit for bit; step median per rank (ms) "
              f"{[round(x, 3) for x in per_rank]} against {ref_ms:.3f} on one "
              f"rank ({ref_mode}); launches per rank "
              f"{out['modes'][mode]['launches_per_rank']}; card {card}")
    out["phase_s"] = time.time() - t0
    return out


def phase_plain_path(tr):
    """render(use_pallas=False), the reference's plain compositors without
    the early stop, against the kernel path on the card at 128x128 (the
    bucketed window and the sharp dense render) and 64x48 (the split
    path): values to FWD_TOL, the gradients of a weighted sum of the
    outputs to BWD_TOL of each leaf's max |g|; the plain path launches no
    kernel."""
    from deblur4dgs_tpu_torch.convert import scene_from_numpy
    from deblur4dgs_tpu_torch.models.scene import render

    worst = {"fwd": 0.0, "bwd": 0.0}
    for wh, mode in (((128, 128), "blury"), ((64, 48), "blury"),
                     ((128, 128), "mid")):
        arrays, inputs = small_inputs(wh, "dynamic")
        _, w2cs, Ks = inputs[1][:3]
        keys = ["img", "acc", "mask"] + (["depth"] if mode == "blury" else [])
        res = {}
        for use_pallas in (True, False):
            scene = scene_from_numpy(arrays, device=DEV)
            zero_launches(tr)
            out = render(scene, 5.0, torch.as_tensor(w2cs[0], device=DEV),
                         torch.as_tensor(Ks[0], device=DEV), wh, mode=mode,
                         return_mask=True, return_depth=mode == "blury",
                         num_exposure=3, cap=256, use_pallas=use_pallas)
            g = torch.Generator(device=DEV).manual_seed(7)
            loss = sum((out[k] * torch.randn(out[k].shape, generator=g,
                                             device=DEV)).sum() for k in keys)
            loss.backward()
            torch.cuda.synchronize()
            n = sum(tr.LAUNCHES.values())
            check((n == 0) == (not use_pallas), f"plain path {wh} {mode}: "
                  f"{n} kernel launches with use_pallas={use_pallas}")
            res[use_pallas] = ({k: out[k].detach() for k in keys}, {
                name: p.grad.detach().clone()
                for name, p in scene.named_parameters() if p.grad is not None})
        (ok, gk), (op, gp) = res[True], res[False]
        for k in keys:
            e = float((ok[k] - op[k]).abs().max())
            rel = e / max(1.0, float(op[k].abs().max()))
            worst["fwd"] = max(worst["fwd"], rel)
            check(rel <= FWD_TOL, f"plain path {wh} {mode} {k}: {rel:.3e}")
        check(set(gk) == set(gp) and gp, f"plain path {wh} {mode}: grads")
        for name in gp:
            rel = float((gk[name] - gp[name]).abs().max()) / (
                float(gp[name].abs().max()) + 1e-12)
            worst["bwd"] = max(worst["bwd"], rel)
            check(rel <= BWD_TOL, f"plain path {wh} {mode} grad {name}: "
                  f"{rel:.3e}")
    print(f"# plain path (use_pallas=False) against the kernels: forward "
          f"rel {worst['fwd']:.3e}, gradients rel {worst['bwd']:.3e}")
    return worst


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--multidevice-rank"]:
        return md_rank_main(sys.argv[2:])
    try:
        from deblur4dgs_tpu_torch.ops import cuda_build
        from deblur4dgs_tpu_torch.ops import rasterize as tr
    except ImportError as e:
        print(f"chip_smoke: the port package is missing next to "
              f"{__file__}: {e}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS reproducibility under torch.use_deterministic_algorithms
    # (phase_loop_small's resume check); read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.time()

    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    print(f"# card: {card}")
    print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.time()
    cuda_build.load(verbose_ptxas=True)
    info = cuda_build.BUILD_INFO
    print(f"# kernel build: {time.time() - t0:.2f} s "
          f"(nvcc ran: {info.get('built')})")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"#   {line.strip()}")
    # the kernel instances: window exact at nchan 5 and 11, dense exact at
    # D 4 and 5, each with a generic one (queried at 3)
    instances = {
        "window": {n: cuda_build.window_kernel_info(n) for n in (5, 11, 3)},
        "dense": {n: cuda_build.dense_kernel_info(n) for n in (4, 5, 3)}}
    for kind, by_n in instances.items():
        for n, info_n in by_n.items():
            for d, v in info_n.items():
                print(f"# {kind}_{d} instance for nchan {n}: " + ", ".join(
                    f"{k} {x}" for k, x in v.items()))
    for n, info_n in instances["dense"].items():
        for d, v in info_n.items():
            check(v["spill_bytes"] == 0,
                  f"dense_{d} instance for nchan {n} spills "
                  f"{v['spill_bytes']} bytes")

    errs = Errs()
    caps = (128, 256, 512, 1024)
    phase_random(tr, errs, "window", [  # nchan 11: dynamic, 5: static
        (f"cap={c} nchan={nchan}",
         random_bucket(i + (0 if nchan == 11 else 40), 64, NUM_EXPOSURE,
                       nchan, c, 80, 3600, DEV) + (80, nchan, True))
        for nchan in (11, 5) for i, c in enumerate(caps)])
    phase_random_dense(tr, errs, [  # (a); D 3 and 8: the generic instance
        (f"cap={c} D={d}", d, 10 * d + i, c)
        for d in (4, 5, 3, 8)
        for i, c in enumerate(caps if d in (4, 5) else (128, 1024))]
        + [(f"cap={c} D={d}", d, 100 + 10 * d + i, c)  # the pipeline's caps
           for d in (3, 4, 5) for i, c in enumerate(BIG_CAPS)])
    split_cases = []  # (b)
    for nchan in (11, 5):
        for i, c in enumerate(caps):
            dyn, st, counts, ids = random_bucket(20 + i + nchan, 64, 1, nchan,
                                                 c, 80, 3600, DEV)
            split_cases.append((f"cap={c} nchan={nchan}",
                                (dyn[:, 0], st, counts, ids, 80, nchan,
                                 True)))
    phase_random(tr, errs, "split", split_cases)
    phase_random_scatter(tr, errs)
    phase_edge(tr, errs)
    phase_edge_dense(tr, errs)
    t0 = time.time()
    n_big = phase_big_caps(tr, errs)
    print(f"# {n_big} window / split cases at caps {BIG_CAPS}, S {PIPE_S}: "
          f"{time.time() - t0:.1f} s")

    dyn_times, dyn_launches, _ = phase_bench(tr, errs, rates)
    cubic_times = phase_bench_cubic(tr)
    s2_times, s2_launches, win, dense, cull = phase_stage2(tr, errs, rates)
    s1_times, s1_launches = phase_stage1(tr)
    phase_small_vs_cpu(tr, errs, rates, expected={
        "window_fwd": 2, "window_bwd": 2})
    phase_small_vs_cpu(tr, errs, rates, kind="stage2", expected={
        "window_fwd": 8, "window_bwd": 8, "dense_fwd": 1, "dense_bwd": 1})
    split_launches, split = phase_small_vs_cpu(
        tr, errs, rates, wh=(64, 48), kind="stage2", record="split",
        expected={"split_fwd": 3 * 4, "split_bwd": 3 * 4, "dense_fwd": 1,
                  "dense_bwd": 1})
    phase_small_vs_cpu(tr, errs, rates, wh=(64, 48), kind="stage1",
                       expected={"split_fwd": 3 * 3, "split_bwd": 3 * 3})
    phase_small_vs_cpu(tr, errs, rates, camera_mode="cubic", expected={
        "window_fwd": 2, "window_bwd": 2})
    ab_times = phase_scatter_ab(tr)
    s2s_times, scatter = phase_stage2_scatter(tr, errs, rates)
    life = phase_lifecycle(tr)
    phase_loop_small(tr)
    pose_small = phase_pose_small_vs_cpu(tr)
    ev = phase_eval(tr, errs, rates, card)
    ev["pose_64x48_card_vs_cpu"] = pose_small
    t0 = time.time()
    pipe = phase_pipeline(tr, card)
    pipe["phase_s"] = time.time() - t0
    t0 = time.time()
    stereo = phase_stereo(tr, card)
    stereo["phase_s"] = time.time() - t0
    t0 = time.time()
    view = phase_viewer(tr, card)
    view["phase_s"] = time.time() - t0
    t0 = time.time()
    flow = phase_flow(tr, errs, rates, card, statistics.median(s2_times))
    flow["phase_s"] = time.time() - t0
    plain_path = phase_plain_path(tr)
    md = phase_multidevice(tr, card)

    kernels = []
    full = "stage-2 step 1280x720"
    for kind, (ms, plain, bounds, dev, *extra), launches, path, timed_on in (
        ("window", win, s2_launches, f"{full}, {TIMED_STEPS} steps",
         f"{full}, its 16 window calls"),
        ("dense", dense, s2_launches, f"{full}, {TIMED_STEPS} steps",
         f"{full}, its static-reg call"),
        ("split", split, split_launches, "stage-2 step 64x48, 2 steps",
         "stage-2 step 64x48, its 12 calls"),
        ("window_scatter", scatter, life["launches"],
         f"lifecycle stage-2 TrainLoop {full}, {LIFE_STEPS} steps",
         f"{full} with D4_SCATTER on, its 16 window calls"),
    ):
        for d in ("fwd", "bwd"):
            k = f"{kind}_{d}"
            line, tpu_fn, src, fn = KERNEL_INFO[k]
            kernels.append({
                "name": k,
                "route": "cuda",
                "source": f"deblur4dgs_tpu_torch/csrc/{src}",
                "kernel": fn,
                "replaces": f"deblur4dgs_tpu/ops/rasterize.py:{line}",
                "replaces_fn": tpu_fn,
                "launches": launches[k],
                "launches_path": path,
                "launches_pipeline": pipe["launches"][k],
                "launches_stereo": stereo["launches"][k],
                "timed_on": timed_on,
                "max_abs_err": errs.v[k][0],
                "max_rel_err": errs.v[k][1],
                "ms": ms[d],
                "device_ms": dev[d],
                "plain_ms": plain[d],
                "bound_ms": bounds[d][0],
                "bound_by": bounds[d][1],
                "bound_ms_every_pair": bounds[d][2],
                "library_ms": None,
            })
            by_n = instances["dense" if kind == "dense" else "window"]
            kernels[-1]["instances"] = {  # the instances it may run
                "generic" if n == 3 else f"nchan {n}": v[d]
                for n, v in by_n.items()}
            kernels[-1]["launches_multidevice_per_rank"] = {
                mode: [n.get(k, 0) for n in m["launches_per_rank"]]
                for mode, m in md["modes"].items()}
            if kind == "dense":  # the viewer's render-path frames
                kernels[-1]["launches_render_path"] = \
                    view["render_path"]["launches"][k]
            if k == "dense_fwd":
                kernels[-1]["render_path_device_ms_per_frame"] = \
                    view["render_path"]["k5_device_ms_per_frame"]
            if extra:  # K5: (function ms, host parts' ms, function device)
                kernels[-1]["function_ms"] = extra[0][d]
                kernels[-1]["function_device_ms"] = extra[2][d]
                kernels[-1]["function_of"] = (
                    "table build + forward kernel" if d == "fwd" else
                    "backward kernel + per-Gaussian reduction")
                kernels[-1]["host_ms"] = extra[1]["table" if d == "fwd"
                                                   else "reduce"]
    print(f"# cull on the stage-2 step's {4 * n_buckets()} window calls: "
          f"keeps {cull['reached']} of {cull['walked']} (warp, Gaussian) "
          f"iterations up to the stop chunks, removes "
          f"{cull['removed_share']:.4f}")
    print(json.dumps({"kernels": kernels}))
    print(f"# dynamic-step launches over {TIMED_STEPS} steps: "
          f"{dyn_launches}; stage-1 step: {s1_launches}")
    for on in (False, True):
        print(f"# dynamic step, scatter {'on ' if on else 'off'}: medians "
              f"(ms) {[round(t * 1e3, 3) for t in ab_times[on]]} (runs "
              f"off, on, on, off in one call)")
    print(f"# lifecycle: init {life['init_s']:.3f} s; stage-2 loop step "
          f"median {statistics.median(life['step_ms']):.3f} ms without its "
          f"control event over {LIFE_STEPS} steps; control events (ms) "
          f"{[(e['step'], round(e['ms'], 3)) for e in life['events']]}")
    for label, times in (("dynamic", dyn_times),
                         ("dynamic, cubic camera", cubic_times),
                         ("stage-2", s2_times),
                         ("stage-2 scatter", s2s_times),
                         ("stage-1", s1_times)):
        med = statistics.median(times)
        print(f"# {label} train step (1280x720, 100k Gaussians, S=11, cap "
              f"1024): median {med * 1e3:.3f} ms over {len(times)} steps, "
              f"{W * H / med:.1f} rays/s; card {card}")
    print(json.dumps({"eval": ev}))
    print(json.dumps({"pipeline": pipe}))
    print(json.dumps({"stereo": stereo}))
    print(json.dumps({"viewer": view}))
    print(json.dumps({"flow": flow}))
    print(json.dumps({"multidevice": md, "plain_path": plain_path}))
    for e in pipe["stages"]:
        if e["steps_ms"]:
            print(f"# pipeline stage {e['stage']}: {e['s']:.3f} s, step "
                  f"median {statistics.median(e['steps_ms']):.3f} ms; card "
                  f"{card}")
    print(f"# pipeline (CLI, {W}x{H}): {pipe['wall_s']:.3f} s, resumed "
          f"{pipe['resumed_wall_s']:.3f} s, phase {pipe['phase_s']:.1f} s; "
          f"viewer phase {view['phase_s']:.1f} s; flow phase "
          f"{flow['phase_s']:.1f} s")
    for e in stereo["stages"]:
        med = statistics.median(e["steps_ms"]) if e["steps_ms"] else None
        print(f"# stereo stage {e['stage']}: {e['s']:.3f} s, step median "
              f"{med} ms; card {card}")
    hdb = stereo["hdbscan"]
    print(f"# stereo (train --data-dir, {W}x{H}): {stereo['wall_s']:.3f} s, "
          f"dataset load {stereo['dataset_load_s']:.3f} s, phase "
          f"{stereo['phase_s']:.1f} s; hdbscan {hdb['tracks']} x "
          f"{hdb['dims']}: {hdb['seconds']:.3f} s, {hdb['clusters']} "
          f"clusters; card {card}")
    print(f"# render-path ({W}x{H}): {view['render_path']['frame_ms']:.3f} "
          f"ms per frame, K5 forward "
          f"{view['render_path']['k5_device_ms_per_frame']:.3f} ms of device "
          f"time per frame; viewer /render at {VIEW_SMALL_WH}: median "
          f"{statistics.median(view['request_ms']):.3f} ms; card {card}")
    print(f"# multidevice phase {md['phase_s']:.1f} s over {md['transport']}"
          f"; card {card}")
    print(f"# total run {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
