"""Profiling and tracing utilities: a device trace, named ranges and a
blocking step timer.

PyTorch port of deblur4dgs_tpu/utils/profiling.py (the reference has only
wall-clock rays/s counters, trainer.py:301,351). ``device_trace`` runs
torch.profiler over the block and writes a trace that TensorBoard's
profiler plugin and Chrome's trace viewer read; ``annotate`` names a range
in that trace (torch.profiler.record_function) and, on a card, in an NVTX
range for external profilers; ``StepTimer.block_and_stop`` waits for the
card before it reads the clock.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed block (host ops, and the card's kernels where a
    card is present) into ``log_dir`` as ``<host>_<pid>.<time>.pt.trace.json``.
    Yields the profiler (its ``key_averages()`` sum the block's ops)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str):
    """Named range that shows up in profiler timelines."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _block(x):
    """Wait for the card on every CUDA device that holds a tensor of x (a
    tensor, or lists / tuples / dicts of them)."""
    if torch.is_tensor(x):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _block(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _block(v)


class StepTimer:
    """Blocking wall-clock timer with running stats (rays/s counters)."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *a):
        self.times.append(time.time() - self._t0)

    def block_and_stop(self, x):
        _block(x)
        self.times.append(time.time() - self._t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def rays_per_sec(self, num_rays: int) -> float:
        return num_rays / max(self.mean, 1e-9)
