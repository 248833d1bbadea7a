"""One run of a cell: set-up, the checked steps, the measured or traced
window, the reference, and the result.

Set-up builds the port's train step from the seed's inputs and drives
its first ``checked_steps`` steps through the step itself (they warm up
every shape the window uses); the window then drives the same object on,
back to back, as the pipeline's phase-B loop does, with no synchronize
per step. Once the window has closed and the peak memory is read, the
program's state is freed and the reference repeats the checked steps
from the same inputs.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, replace

import torch

from harness import check, gen, sides, trace as T, work as W
from harness.spec import metric_reader


@dataclass
class Context:
    """What a per-layer metric's reader reads."""
    trace: T.Trace
    work: list  # [work.StepWork] of the traced steps
    bandwidth: float  # bytes/s
    peak_flops: float  # fp32 flop/s


@dataclass
class Outcome:
    metrics: dict  # name -> value
    correct: bool
    checks: list  # [(name, value, limit, detail)]
    attempted: int
    failed: int
    memory_peak_bytes: int
    device_extra: dict  # busy_s, window_s in a traced run
    breakdown: dict | None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def flow_span(flow_fn):
    def wrapped(a, b):
        with torch.profiler.record_function(T.FLOW_SPAN):
            return flow_fn(a, b)
    return wrapped


def snapshot_inputs(side, inputs):
    """``inputs`` with the side's current parameters as the scene."""
    params = {k: p.detach().clone() for k, p in side.scene.named_parameters()}
    return replace(
        inputs,
        scene={k: v for k, v in params.items() if not k.startswith("move.")},
        move={k[len("move."):]: v for k, v in params.items()
              if k.startswith("move.")})


def count_work(snap, cfg, traffic, device, steps):
    """StepWork of schedule steps ``steps`` on the scene ``snap``: the
    reference's renders of each step's branches, forward, with the
    compositor calls recorded."""
    ref = sides.build(sides.REFERENCE, snap, cfg,
                      dict(traffic, flow_term=False), device)
    tr = ref.module("train.trainer")
    rcfg, lcfg = ref.rcfg, ref.lcfg
    stage, br = traffic["stage"], traffic["branches"]
    n_params = sum(p.numel() for p in ref.scene.parameters())
    scene, out = ref.scene, []
    for k in steps:
        static, dyn, tracks, reg, b4 = gen.step_batches(
            snap, k, ref.frame_batch, ref.track_batch)
        with torch.no_grad(), W.recording(ref.module("ops.rasterize")) as calls:
            if br["has_static"]:
                tr.compute_static_losses(scene, static, None, lcfg, rcfg,
                                         stage)
            if br["has_dynamic"]:
                tr.compute_dynamic_losses(
                    scene, dyn, tracks, None, lcfg, rcfg, stage,
                    traffic["epoch"], cfg["window_frames"],
                    batch4_imgs=b4 if br["has_batch4"] else None)
            if br["has_reg"]:
                tr.compute_static_reg_losses(scene, reg, None, lcfg, rcfg,
                                             stage)
        out.append(W.StepWork(list(calls),
                              W.other_ops(cfg, traffic, n_params)
                              + W.flow_ops(cfg, traffic)))
    return out


def reference_readings(inputs, cfg, traffic, device, tf32=False):
    """The reference's checked steps on ``inputs`` (with TF32 on for the
    lower-precision control)."""
    ref = sides.build(sides.REFERENCE, inputs, cfg, traffic, device)
    if tf32:  # make_train_step switched it off; the control turns it on
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        return check.checked_steps(ref, inputs, traffic["checked_steps"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def run_cell(cell, seed, seconds, traced, device, rates, t_start):
    """One run of ``cell`` from ``seed``: an Outcome. ``rates`` are the
    card's (bytes/s, fp32 flop/s); ``t_start`` is the process's start."""
    cfg, traffic = cell.config, cell.traffic
    n_check = traffic["checked_steps"]
    inputs = gen.make_inputs(cfg, traffic, seed, device, sides.pwcnet_meta())
    prog = sides.build(sides.PORT, inputs, cfg, traffic, device,
                       flow_wrap=flow_span)
    prog_read = check.checked_steps(prog, inputs, n_check)
    _sync(device)
    setup_s = time.time() - t_start

    losses, k = [], n_check

    def run_steps(n):
        nonlocal k
        for _ in range(n):
            losses.append(sides.drive(prog, inputs, k))
            k += 1

    metrics, extra, breakdown, tr, snap = {}, {}, None, None, None
    if not traced:
        t0 = time.perf_counter()
        while True:
            run_steps(1)
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
        metrics = {"step_ms": 1e3 * window_s / (k - n_check),
                   "setup_s": setup_s}
    else:
        snap = snapshot_inputs(prog, inputs)
        tr = T.trace_steps(run_steps, traffic["traced_steps"])
        extra = {"busy_s": T.busy_us(tr.kernels) * 1e-6, "window_s": tr.wall_s}
        breakdown = {"device_ops": [list(x) for x in T.top_ops(tr.kernels)],
                     "idle_gaps": [list(x) for x in tr.gaps]}
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses \
        else 0
    failed += sum(1 for x in prog_read.loss if x != x or abs(x) == float("inf"))
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    del prog, losses
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    if traced:
        traced_steps = range(n_check, n_check + tr.steps)
        ctx = Context(tr, count_work(snap, cfg, traffic, device, traced_steps),
                      *rates)
        del snap
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = value

    ref_read = reference_readings(inputs, cfg, traffic, device)
    correct, rows = check.verdict(check.compare(prog_read, ref_read),
                                  cell.limits)
    return Outcome(metrics, correct, rows, k, failed, peak, extra, breakdown)
