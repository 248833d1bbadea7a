"""The port's own spans in a profiler trace: device time, launches, host
syncs and idle gaps by span.

One more step is traced after ``trace.trace_steps``' two passes, with the
host's ops and the card's activity and with the port's tracing on
(``deblur4dgs_tpu_torch.utils.profiling.tracing``; a port without it
records no span, and every reading here is then empty). Each ``d4.``
span is a record_function range on the host thread that opened it.

A device event is tied to the runtime call that launched it by
correlation id, and charged to the spans open on that call's thread at
the call's start; a call on a thread other than the one that opened
``d4.step`` (the autograd engine's, in the backward) is charged to that
thread's spans and, outside them, to those open on the step's thread
(``d4.step.backward``). The innermost span of that chain is the event's
own. Device events that are user annotations (a record_function's range
as the card's timeline shows it, spanning the kernels launched inside)
are never counted as kernels.

Per span name, per step: ``ms``, the union of the intervals of the
kernels launched at any depth inside it; ``self_ms``, the union of those
whose innermost span it is; ``launches``, the device events launched at
any depth inside it; ``syncs``, the blocking runtime calls made inside it
(SYNC_CALLS, and the non-async cudaMemcpy calls: each waits for the card,
and the launch queue drains). Idle gaps between the device's busy
intervals are summed by the innermost span open, on any thread, at each
gap's midpoint.

One host-traced step's device times are not the device-only pass's: on
an H100 80GB HBM3 their sum read 0.77-1.21 times its busy time per step
(PERF.md §6), one step's flow term differing from the next by up to 20%. So
``charge_device_pass`` takes the times from the device-only pass's steps,
each kernel charged as the spans pass charged the kernel of the same
name and occurrence; ``consistency`` says how far the spans pass's own
times stand from them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from harness import trace as T

PREFIX = "d4."
STEP = "d4.step"
OUTSIDE = "(outside d4 spans)"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def is_sync(name):
    """A runtime call that blocks the host until the card has caught up."""
    return name in SYNC_CALLS or (name.startswith("cudaMemcpy")
                                  and "Async" not in name)


@dataclass
class SpanTrace:
    steps: int  # steps driven in the pass
    step_spans: int  # d4.step ranges seen
    spans: dict = field(default_factory=dict)  # name -> per-step readings
    idle_by_span: list = field(default_factory=list)  # [(span, s per step)]
    outside_step_ms: float = 0.0  # per step, kernels launched outside d4.step
    launches: int = 0  # device events in the pass
    launches_in_step: int = 0  # of which launched inside d4.step
    annotations: int = 0  # device events left out as user annotations
    charged: list = field(default_factory=list)  # [(kernel name, chain)]


def _stacks(spans, queries):
    """For each query time, the spans (of one thread, properly nested) open
    at it, outermost first: a tuple of events. Ranges are closed at both
    ends."""
    marks = [(e.time_range.start, 0, i) for i, e in enumerate(spans)]
    marks += [(e.time_range.end, 2, i) for i, e in enumerate(spans)]
    marks += [(t, 1, i) for i, t in enumerate(queries)]
    marks.sort(key=lambda m: (m[0], m[1]))
    open_, snap, out = [], (), [()] * len(queries)
    for _, kind, i in marks:
        if kind == 0:
            open_.append(spans[i])
            snap = None
        elif kind == 2:
            open_.remove(spans[i])
            snap = None
        else:
            if snap is None:
                snap = tuple(open_)
            out[i] = snap
    return out


class _Chains:
    """The chain of spans (outermost first) charged at (thread, time)."""

    def __init__(self, cpu):
        spans = [e for e in cpu if e.name.startswith(PREFIX)]
        self.by_thread = {}
        for e in spans:
            self.by_thread.setdefault(e.thread, []).append(e)
        steps = [e for e in spans if e.name == STEP]
        self.main = steps[0].thread if steps else None
        self.step_spans = len(steps)

    def at(self, points):
        """points: [(thread, time)] -> [tuple of span events]."""
        out = [()] * len(points)
        wanted = {}
        for i, (th, t) in enumerate(points):
            wanted.setdefault(th, []).append(i)
            if self.main is not None and th != self.main:
                wanted.setdefault(self.main, []).append(i)
        own, main = {}, {}
        for th, idx in wanted.items():
            got = _stacks(self.by_thread.get(th, []),
                          [points[i][1] for i in idx])
            for i, chain in zip(idx, got):
                (own if points[i][0] == th else main)[i] = chain
        for i in range(len(points)):
            out[i] = main.get(i, ()) + own.get(i, ())
        return out

    def innermost_any_thread(self, times):
        """The innermost span open on any thread at each time (the one
        that started last), or None."""
        best = [None] * len(times)
        for spans in self.by_thread.values():
            for i, chain in enumerate(_stacks(spans, times)):
                if chain and (best[i] is None or chain[-1].time_range.start
                              > best[i].time_range.start):
                    best[i] = chain[-1]
        return best


def read_spans(events, steps):
    """A SpanTrace of the profiler ``events`` of ``steps`` driven steps."""
    types = torch.autograd.DeviceType
    cpu = [e for e in events if e.device_type == types.CPU]
    dev = [e for e in events if e.device_type == types.CUDA]
    note = [getattr(e, "is_user_annotation", False) for e in dev]
    annotations = sum(note)
    dev = sorted((e for e, n in zip(dev, note) if not n),
                 key=lambda e: e.time_range.start)
    calls = {e.id: e for e in cpu if e.name.startswith("cu")}
    chains = _Chains(cpu)

    launched = [calls.get(e.id) for e in dev]
    k_chain = chains.at([(c.thread, c.time_range.start) if c is not None
                         else (None, float("-inf")) for c in launched])
    syncs = [e for e in cpu if is_sync(e.name)]
    s_chain = chains.at([(e.thread, e.time_range.start) for e in syncs])

    kernels = [T.Kernel(e.name, e.time_range.start, e.time_range.end)
               for e in dev]
    total, own, launches, n_sync = {}, {}, {}, {}
    outside, in_step = [], 0
    charged = []
    for k, chain in zip(kernels, k_chain):
        names = {e.name for e in chain}
        for n in names:
            total.setdefault(n, []).append(k)
            launches[n] = launches.get(n, 0) + 1
        if chain:
            own.setdefault(chain[-1].name, []).append(k)
        if STEP in names:
            in_step += 1
        else:
            outside.append(k)
        charged.append((k.name, tuple(e.name for e in chain)))
    for chain in s_chain:
        for n in {e.name for e in chain}:
            n_sync[n] = n_sync.get(n, 0) + 1

    per = 1.0 / max(steps, 1)
    names = sorted({e.name for v in chains.by_thread.values() for e in v})
    spans = {n: {"ms": T.busy_us(total.get(n, [])) * 1e-3 * per,
                 "self_ms": T.busy_us(own.get(n, [])) * 1e-3 * per,
                 "launches": launches.get(n, 0) * per,
                 "syncs": n_sync.get(n, 0) * per}
             for n in names}

    iv = T.merged(kernels)
    gaps = [(a, b) for (_, a), (b, _) in zip(iv[:-1], iv[1:])]
    where = chains.innermost_any_thread([0.5 * (a + b) for a, b in gaps])
    idle = {}
    for (a, b), e in zip(gaps, where):
        n = e.name if e is not None else OUTSIDE
        idle[n] = idle.get(n, 0.0) + (b - a) * 1e-6 * per
    return SpanTrace(
        steps=steps, step_spans=chains.step_spans, spans=spans,
        idle_by_span=sorted(idle.items(), key=lambda kv: -kv[1]),
        outside_step_ms=T.busy_us(outside) * 1e-3 * per,
        launches=len(kernels), launches_in_step=in_step,
        annotations=annotations, charged=charged)


def _port_tracing():
    try:
        from deblur4dgs_tpu_torch.utils.profiling import tracing
    except ImportError:  # a port without spans: the pass records none
        return contextlib.nullcontext()
    return tracing()


def trace_spans(run_steps, n=1):
    """Trace ``run_steps(n)`` with the host's ops and the port's spans on:
    (SpanTrace, the profiler's events)."""
    with _port_tracing():
        events, _ = T._profile(lambda: run_steps(n), with_host=True)
    return read_spans(events, n), events


def consistency(st, busy_ms_per_step):
    """The spans pass against the device-only pass: the sum over spans of
    self device time, plus the kernels launched outside d4.step, over the
    device-only pass's busy time per step."""
    total = sum(v["self_ms"] for v in st.spans.values()) + st.outside_step_ms
    return {"span_self_sum_ms": total, "busy_ms": busy_ms_per_step,
            "ratio": total / busy_ms_per_step if busy_ms_per_step > 0
            else None}


def charge_device_pass(st, kernels, steps):
    """The readings with their device times taken from the device-only
    pass's ``kernels`` (``steps`` steps) instead: each kernel takes the
    chain that the spans pass gave the kernel of the same name and the
    same occurrence index within its step. Launches and syncs stay the
    spans pass's. Returns {span: readings} per step, as SpanTrace.spans."""
    seen = {}
    for name, chain in st.charged:
        seen.setdefault(name, []).append(chain)
    counts, total, own = {}, {}, {}
    for k in kernels:
        chains = seen.get(k.name)
        i = counts.get(k.name, 0)
        counts[k.name] = i + 1
        if not chains:
            continue
        chain = chains[i % len(chains)]
        for n in set(chain):
            total.setdefault(n, []).append(k)
        if chain:
            own.setdefault(chain[-1], []).append(k)
    per = 1e-3 / max(steps, 1)
    return {n: dict(r, ms=T.busy_us(total.get(n, [])) * per,
                    self_ms=T.busy_us(own.get(n, [])) * per)
            for n, r in st.spans.items()}
