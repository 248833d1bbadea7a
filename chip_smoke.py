"""On-GPU smoke run of the PyTorch port (deblur4dgs_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100 / sm_90a) and nvcc. It builds the port's CUDA
kernels from deblur4dgs_tpu_torch/csrc, then:

  1. prints the card (nvidia-smi name, power limit), torch / CUDA versions
     and the kernel build time + ptxas register report;
  2. holds the window forward kernel against its plain twin on random
     inputs at the bench's bucket capacities (128, 256, 512, 1024), S=11,
     nchan=11, with empty rows and rows that saturate early;
  3. the same for the window backward kernel (gdyn, gst);
  4. drives the port's dynamic train step at the full bench.py shape
     (1280x720, 40k fg + 60k bg Gaussians, S=11, tile cap 1024; the scene,
     batch and tracks drawn from numpy default_rng(0) exactly as bench.py
     builds them; MoveModel weights from torch.Generator seed 0): one
     warm-up step, then timed steps with the kernel launch counters zeroed
     just before and read just after (4 forward + 4 backward per step);
  5. holds both kernels against their twins on that step's real inputs
     (first 64 rows of every bucket) and times kernels and twins on the
     full buckets;
  6. runs two train steps of a small scene on the card and on the CPU
     (the CPU path is the one tests/test_torch_*.py hold against the JAX
     package) and compares losses and aux values.

Prints a {"kernels": [...]} JSON line, the step time, the card line, and
last {"ok": true, "device": {...}}. Any failed check raises (exit != 0).
Exits non-zero without a result when no CUDA card is visible or when the
package is not next to this file. Imports no JAX.
"""

from __future__ import annotations

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
NUM_FRAMES = 24
TIMED_STEPS = 5
# Kernel-vs-twin bars (float32 reassociation: per-pixel sums of up to 1024
# terms in another order; gst summed over S with atomics in any order).
FWD_TOL = 2e-4  # max |kernel - twin| / max(1, max |twin|)
BWD_TOL = 2e-3  # max |kernel - twin| / max |twin|
# Card rates for bounds (NVIDIA data sheets; dense FP32 outside the tensor
# cores, HBM bandwidth), keyed by a substring of the nvidia-smi name.
CARD_RATES = {  # name key: (bytes/s, fp32 flop/s)
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),  # SXM5 80GB HBM3
}
# Operations per (pixel, Gaussian) pair, counted from the kernels' code:
# alpha evaluation ~20 (offsets, conic quadratic, exp, box/cutoff tests);
# a live pair adds 2*nchan + 3 in the forward (weight, channel FMAs,
# transmittance), 4*nchan + 36 in the backward (sdot, channel grads,
# prefix/suffix, alpha/conic/mean/opacity grads, one add per reduced value).
OPS_PAIR = 20


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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def random_bucket(seed, T, S, nchan, cap, tiles_x, n_tiles, dev):
    """Random window-compositor inputs in the packing layout (slots past a
    row's count are zero sentinel rows). Row 0 is empty; rows 1-8 hold wide
    opaque Gaussians and saturate in their first chunk."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n_tiles)[:T].astype(np.int32)
    n_static = nchan - 1
    dyn = np.zeros((T, S, 7, cap), np.float32)
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


def bench_state(dev):
    """bench.py's scene, batch and tracks, drawn in the same order."""
    from deblur4dgs_tpu_torch.configs import (
        LossesConfig, OptimizerConfig, RenderConfig, SceneLRConfig)
    from deblur4dgs_tpu_torch.models.gaussians import Gaussians
    from deblur4dgs_tpu_torch.models.motion_bases import MotionBases
    from deblur4dgs_tpu_torch.models.move_model import init_move_model
    from deblur4dgs_tpu_torch.models.scene import SceneModel
    from deblur4dgs_tpu_torch.train.optimizers import make_optimizer
    from deblur4dgs_tpu_torch.train.trainer import (
        FrameBatch, TrackBatch, init_train_state, make_train_step)

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
    lr, ocfg, lcfg = SceneLRConfig(), OptimizerConfig(), LossesConfig()
    rcfg = RenderConfig(num_exposure=NUM_EXPOSURE, tile_cap=TILE_CAP,
                        max_tiles_per_gauss=32)
    state = init_train_state(scene, lr, ocfg)
    step = make_train_step(make_optimizer(scene, lr, ocfg), lcfg, rcfg,
                           "second", T, has_static=False, has_dynamic=True,
                           has_reg=False)
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
    return state, step, batch, tracks


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


@torch.no_grad()
def compare_fwd(tr, args):
    acc_k, tf_k = tr.window_fwd_cuda(*args)
    acc_p, tf_p = tr.composite_window_plain(*args)
    scale = max(1.0, float(acc_p.abs().max()))
    err = max(float((acc_k - acc_p).abs().max()),
              float((tf_k - tf_p).abs().max()))
    return err, err / scale


@torch.no_grad()
def compare_bwd(tr, args):
    gd_k, gs_k = tr.window_bwd_cuda(*args)
    gd_p, gs_p = tr.composite_window_bwd_plain(*args)
    err = rel = 0.0
    for k, p in ((gd_k, gd_p), (gs_k, gs_p)):
        e = float((k - p).abs().max())
        err = max(err, e)
        rel = max(rel, e / (float(p.abs().max()) + 1e-30))
    return err, rel


def bwd_args_for(tr, fwd_args, seed):
    """Backward inputs for fwd_args: the kernel's forward outputs and random
    cotangents."""
    acc, tf = tr.composite_window_plain(*fwd_args)
    g = torch.Generator(device=acc.device).manual_seed(seed)
    gacc = torch.randn(acc.shape, generator=g, device=acc.device)
    gt = torch.randn(tf.shape, generator=g, device=acc.device)
    return fwd_args[:4] + (acc, tf, gacc, gt) + fwd_args[4:]


@torch.no_grad()
def phase_random(tr, dev):
    errs = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    for i, cap in enumerate((128, 256, 512, 1024)):
        dyn, st, counts, ids = random_bucket(i, 64, NUM_EXPOSURE, 11, cap,
                                             80, 3600, dev)
        fargs = (dyn, st, counts, ids, 80, 11, True)
        e, r = compare_fwd(tr, fargs)
        print(f"# random cap={cap}: forward max abs err {e:.3e} "
              f"(rel {r:.3e})")
        check(r <= FWD_TOL, f"forward kernel vs twin at cap {cap}: {r:.3e}")
        errs["fwd"] = [max(errs["fwd"][0], e), max(errs["fwd"][1], r)]
        bargs = bwd_args_for(tr, fargs, i)
        e, r = compare_bwd(tr, bargs)
        print(f"# random cap={cap}: backward max abs err {e:.3e} "
              f"(rel to max |g| {r:.3e})")
        check(r <= BWD_TOL, f"backward kernel vs twin at cap {cap}: {r:.3e}")
        errs["bwd"] = [max(errs["bwd"][0], e), max(errs["bwd"][1], r)]
        # the early-saturating rows really stopped early
        _, tf = tr.composite_window_plain(*fargs)
        check(float(tf[1:9].max()) < tr.EARLY_STOP_T,
              "saturating rows did not saturate")
    torch.cuda.synchronize()
    return errs


def phase_bench(tr, dev="cuda"):
    state, step, batch, tracks = bench_state(dev)
    t0 = time.time()
    state, loss, aux = step(state, 25, None, batch, tracks, None, None)
    torch.cuda.synchronize()
    print(f"# warm-up step {time.time() - t0:.2f} s, loss {float(loss):.5f}, "
          f"tile_overflow {float(aux['dynamic']['tile_overflow']):.4f}")

    for k in tr.LAUNCHES:
        tr.LAUNCHES[k] = 0
    times, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.time()
        state, loss, aux = step(state, 25, None, batch, tracks, None, None)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        losses.append(float(loss))
    launches = dict(tr.LAUNCHES)
    print(f"# timed steps (s): {[round(x, 6) for x in times]}; losses "
          f"{losses}; launches {launches}")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    for name, p in state.scene.named_parameters():
        check(bool(torch.isfinite(p).all()), f"non-finite parameter {name}")
    # one forward and one backward launch per bucket per step (4 buckets at
    # the bench shape: default_bucket_spec(3600, 1024))
    from deblur4dgs_tpu_torch.ops.tiling import default_bucket_spec, num_tiles
    tx, ty = num_tiles((W, H))
    nb = len(default_bucket_spec(tx * ty, TILE_CAP))
    for k in ("window_fwd", "window_bwd"):
        check(launches[k] == nb * TIMED_STEPS,
              f"{k}: {launches[k]} launches, expected {nb * TIMED_STEPS}")

    # one more step recording every kernel call's inputs (not counted)
    rec = {"fwd": [], "bwd": []}
    orig_f, orig_b = tr.window_fwd_cuda, tr.window_bwd_cuda

    def rec_f(*a):
        rec["fwd"].append(a)
        return orig_f(*a)

    def rec_b(*a):
        rec["bwd"].append(a)
        return orig_b(*a)

    tr.window_fwd_cuda, tr.window_bwd_cuda = rec_f, rec_b
    try:
        state, loss, aux = step(state, 25, None, batch, tracks, None, None)
        torch.cuda.synchronize()
    finally:
        tr.window_fwd_cuda, tr.window_bwd_cuda = orig_f, orig_b
    check(len(rec["fwd"]) == nb and len(rec["bwd"]) == nb,
          f"recorded {len(rec['fwd'])}/{len(rec['bwd'])} kernel calls")
    step_state = (state, step, batch, tracks)
    return times, launches, rec, step_state


def phase_profile(step_state, steps=2, top=15):
    """Device time by kernel and by aten op over `steps` train steps, and
    the device's busy share of the host wall time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    state, step, batch, tracks = step_state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            state, loss, _ = step(state, 25, None, batch, tracks, None, None)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("# profiler: no device events recorded")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    print(f"# profile over {steps} steps: wall {wall_us / steps / 1e3:.3f} "
          f"ms/step, device busy {busy / steps / 1e3:.3f} ms/step "
          f"(idle share {1 - busy / wall_us:.3f}), {len(kernels) / steps:.0f} "
          f"kernels/step")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"#   kernel {us / steps / 1e3:9.3f} ms/step  {name[:90]}")
    attr = ("self_device_time_total" if hasattr(
        prof.key_averages()[0], "self_device_time_total")
        else "self_cuda_time_total")
    ops = [a for a in prof.key_averages()
           if a.key.startswith("aten::") and getattr(a, attr) > 0]
    for a in sorted(ops, key=lambda a: -getattr(a, attr))[:top]:
        print(f"#   op {getattr(a, attr) / steps / 1e3:9.3f} ms/step "
              f"x{a.count // steps:<5d} {a.key}")


@torch.no_grad()
def phase_real(tr, rec, rates):
    """Kernels vs twins on the real step inputs + times + bounds."""
    bw, peak = rates
    errs = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    for b, (fa, ba) in enumerate(zip(rec["fwd"], rec["bwd"])):
        fcut = tuple(x[:64] if torch.is_tensor(x) else x for x in fa)
        bcut = tuple(x[:64] if torch.is_tensor(x) else x for x in ba)
        e, r = compare_fwd(tr, fcut)
        check(r <= FWD_TOL, f"real bucket {b} forward: {r:.3e}")
        errs["fwd"] = [max(errs["fwd"][0], e), max(errs["fwd"][1], r)]
        e2, r2 = compare_bwd(tr, bcut)
        check(r2 <= BWD_TOL, f"real bucket {b} backward: {r2:.3e}")
        errs["bwd"] = [max(errs["bwd"][0], e2), max(errs["bwd"][1], r2)]
        print(f"# real bucket {b} {tuple(fa[0].shape)}: fwd err {e:.3e} "
              f"(rel {r:.3e}), bwd err {e2:.3e} (rel {r2:.3e})")

    launch_f = lambda: [tr.window_fwd_cuda(*a) for a in rec["fwd"]]
    launch_b = lambda: [tr.window_bwd_cuda(*a) for a in rec["bwd"]]
    ms_f = cuda_ms(launch_f, 10)
    ms_b = cuda_ms(launch_b, 10)
    plain_f = cuda_ms(lambda: [tr.composite_window_plain(*a)
                               for a in rec["fwd"]], 1)
    plain_b = cuda_ms(lambda: [tr.composite_window_bwd_plain(*a)
                               for a in rec["bwd"]], 1)
    pairs = live = 0
    nchan = rec["fwd"][0][5]
    by_f = by_b = 0
    for fa, ba in zip(rec["fwd"], rec["bwd"]):
        acc, tf, work = tr.composite_window_plain(*fa, return_work=True)
        pairs += work["pairs"]
        live += work["live"]
        by_f += nbytes(*fa[:4], acc, tf)
        gd, gs = tr.window_bwd_cuda(*ba)
        by_b += nbytes(*ba[:8], gd, gs)
    ops_f = OPS_PAIR * pairs + (2 * nchan + 3) * live
    ops_b = OPS_PAIR * pairs + (4 * nchan + 36) * live
    bounds = {}
    for k, by, ops in (("fwd", by_f, ops_f), ("bwd", by_b, ops_b)):
        t_bytes, t_ops = by / bw * 1e3, ops / peak * 1e3
        bounds[k] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
        print(f"# {k}: {by / 1e9:.3f} GB -> {t_bytes:.4f} ms; "
              f"{ops / 1e9:.2f} Gop -> {t_ops:.4f} ms; pairs {pairs}, "
              f"live {live}")
    torch.cuda.synchronize()
    return errs, {"fwd": ms_f, "bwd": ms_b}, \
        {"fwd": plain_f, "bwd": plain_b}, bounds


def phase_small_vs_cpu(gpu="cuda"):
    """Two small-scene train steps on the card vs the CPU path."""
    from deblur4dgs_tpu_torch import configs as C
    from deblur4dgs_tpu_torch.convert import jax_key, scene_from_numpy
    from deblur4dgs_tpu_torch.models.move_model import init_move_model
    from deblur4dgs_tpu_torch.train import trainer as TT
    from deblur4dgs_tpu_torch.train.optimizers import make_optimizer

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
    K = np.array([[110.0, 0, 64], [0, 110.0, 64], [0, 0, 1]], np.float32)
    eye = np.eye(4, dtype=np.float32)
    frame = (np.array([5], np.int32), eye[None], K[None],
             rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32),
             (rng.uniform(size=(1, 128, 128)) < 0.3).astype(np.float32),
             np.ones((1, 128, 128), np.float32),
             rng.uniform(2, 8, (1, 128, 128)).astype(np.float32))
    tracks = (rng.integers(0, 128, (64, 2)).astype(np.float32),
              np.array([4, 6], np.int32), np.tile(eye, (2, 1, 1)),
              np.tile(K, (2, 1, 1)),
              rng.uniform(0, 128, (2, 64, 2)).astype(np.float32),
              np.ones((2, 64), np.float32), np.ones((2, 64), np.float32),
              rng.uniform(2, 8, (2, 64)).astype(np.float32))
    results = {}
    for dev in (gpu, "cpu"):
        scene = scene_from_numpy(arrays, device=dev)
        rcfg = C.RenderConfig(num_exposure=3, tile_cap=256)
        state = TT.init_train_state(scene, C.SceneLRConfig(),
                                    C.OptimizerConfig())
        step = TT.make_train_step(
            make_optimizer(scene, C.SceneLRConfig(), C.OptimizerConfig()),
            C.LossesConfig(), rcfg, "second", 8, has_static=False,
            has_dynamic=True, has_reg=False)
        fb = TT.FrameBatch(*(torch.as_tensor(x, device=dev) for x in frame))
        tb = TT.TrackBatch(*(torch.as_tensor(x, device=dev) for x in tracks))
        out = []
        for _ in range(2):
            state, loss, aux = step(state, 25, None, fb, tb, None, None)
            out.append((float(loss), {k: v.cpu().numpy()
                                      for k, v in aux["dynamic"].items()}))
        results[dev] = out
    worst = 0.0
    for (lc, ac), (lp, ap) in zip(results[gpu], results["cpu"]):
        worst = max(worst, abs(lc - lp) / abs(lp))
        for k in ap:
            if k == "radii":  # ceil(3 sigma) may flip by 1 px at an integer
                continue
            d = np.abs(ac[k] - ap[k]).max() / (np.abs(ap[k]).max() + 1e-12)
            check(d <= 1e-4, f"small scene aux {k}: rel diff {d:.3e}")
    print(f"# small scene, card vs CPU: loss rel diff {worst:.3e}")
    check(worst <= 1e-5, f"small scene loss rel diff {worst:.3e}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from deblur4dgs_tpu_torch.ops import cuda_build
        from deblur4dgs_tpu_torch.ops import rasterize as tr
    except ImportError as e:
        print(f"chip_smoke: the port package is missing next to "
              f"{__file__}: {e}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    rand_errs = phase_random(tr, "cuda")
    times, launches, rec, step_state = phase_bench(tr)
    phase_profile(step_state)
    del step_state
    real_errs, ms, plain_ms, bounds = phase_real(tr, rec, rates)
    del rec
    torch.cuda.empty_cache()
    phase_small_vs_cpu()

    kernels = []
    for key, name_k, src_fn, replaces in (
        ("fwd", "window_fwd", "window_fwd_kernel",
         "deblur4dgs_tpu/ops/rasterize.py:989"),
        ("bwd", "window_bwd", "window_bwd_kernel",
         "deblur4dgs_tpu/ops/rasterize.py:1220"),
    ):
        kernels.append({
            "name": name_k,
            "route": "cuda",
            "source": f"deblur4dgs_tpu_torch/csrc/window_composite.cu "
                      f"({src_fn})",
            "replaces": replaces,
            **({"also_replaces": "deblur4dgs_tpu/ops/rasterize.py:1049"}
               if key == "bwd" else {}),
            "launches": launches[f"window_{key}"],
            "max_abs_err": max(rand_errs[key][0], real_errs[key][0]),
            "max_rel_err": max(rand_errs[key][1], real_errs[key][1]),
            "ms": ms[key],
            "plain_ms": plain_ms[key],
            "bound_ms": bounds[key][0],
            "bound_by": bounds[key][1],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    med = statistics.median(times)
    print(f"# train step (1280x720, 100k Gaussians, S=11, cap 1024): median "
          f"{med * 1e3:.3f} ms over {len(times)} steps, "
          f"{W * H / med:.1f} rays/s; card {card}; total run "
          f"{time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
