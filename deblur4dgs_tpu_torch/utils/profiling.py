"""Named spans at the port's layer boundaries, for torch.profiler and NVTX.

The JAX package's utils/profiling.py wraps jax.profiler; the port's one
tracing facility is ``span(name, **args)``. With tracing on, a span is a
``torch.profiler.record_function`` range, so it sits in the same profiler
session as CUPTI's kernel records, on one clock: every kernel, and every
idle gap of the card, can be put down to the span the host was in. On a
card it is also an NVTX range, for external profilers. ``args`` are the
span's identifiers (the step index on ``d4.step``, the render mode on
``d4.render``), passed as the record_function's argument string, which
torch's execution trace (torch.profiler.ExecutionTraceObserver) records.

Tracing is off by default. Then ``span`` returns one shared no-op context:
it creates no profiler record, pushes no NVTX range and builds no string.
``tracing(on=True)`` switches it for a block and restores it after;
``D4_TRACE=1`` in the environment switches it on for the process (read at
import). Every span name starts with ``d4.``.
"""

from __future__ import annotations

import contextlib
import os

import torch

_on = os.environ.get("D4_TRACE", "0") != "0"
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether spans are being recorded."""
    return _on


@contextlib.contextmanager
def tracing(on: bool = True):
    """Spans on (or off) inside the block; the previous setting after."""
    global _on
    before, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = before


def span(name: str, **args):
    """A context marking ``name`` in traces while tracing is on, carrying
    ``args`` as ``key=value`` pairs; the shared no-op context otherwise."""
    if not _on:
        return _OFF
    return _recorded(name, ", ".join(f"{k}={v}" for k, v in args.items())
                     or None)


@contextlib.contextmanager
def _recorded(name, args):
    with torch.profiler.record_function(name, args):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()
