"""Reading torch.profiler's trace of a few train steps.

Two passes over the traced steps: the device's activity alone (kernel
intervals, names, counts: the per-layer metrics and ``busy_s`` /
``window_s``), then one step with the host's ops too, for what runs
inside the benchmark's own spans and what the host was doing while the
device sat idle. Tracing the host's ops slows the host, so nothing timed
comes from that second pass but the gaps' labels.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

FLOW_SPAN = "bench.flow_fn"  # record_function around the step's flow_fn


@dataclass
class Kernel:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self):
        return self.end_us - self.start_us


@dataclass
class Trace:
    kernels: list  # [Kernel] on the device, in start order
    wall_s: float  # host wall time of the traced steps, synchronized
    steps: int
    span_us: dict = field(default_factory=dict)  # span -> kernel us in it
    gaps: list = field(default_factory=list)  # [(host op, idle s)]


def _profile(run, with_host):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_host
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.events(), wall


def device_kernels(events):
    return sorted((Kernel(e.name, e.time_range.start, e.time_range.end)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda k: k.start_us)


def merged(kernels):
    """The union of the kernels' intervals: [(start_us, end_us)]."""
    out = []
    for k in kernels:
        if out and k.start_us <= out[-1][1]:
            out[-1][1] = max(out[-1][1], k.end_us)
        else:
            out.append([k.start_us, k.end_us])
    return out


def busy_us(kernels):
    return sum(e - s for s, e in merged(kernels))


def span_kernel_us(events, span):
    """Device time of the kernels launched inside every ``span`` range,
    the union of their intervals (cuDNN runs some of them concurrently): a
    device event shares its correlation id with the runtime call (cuda*)
    that launched it, and that call's start lies inside the range."""
    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == span and e.device_type == cpu]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == cpu and e.name.startswith("cu")}
    inside = []
    for e in events:
        t = launched.get(e.id) if e.device_type == dev else None
        if t is not None and any(a <= t <= b for a, b in ranges):
            inside.append(Kernel(e.name, e.time_range.start, e.time_range.end))
    return busy_us(sorted(inside, key=lambda k: k.start_us))


def idle_gaps(kernels, events, top=10):
    """Idle time between the device's busy intervals, summed by the
    innermost host op that was running at each gap's midpoint."""
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    by_op = {}
    iv = merged(kernels)
    for (_, a), (b, _) in zip(iv[:-1], iv[1:]):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        best = None
        # the innermost op holding mid: the latest-starting one among the
        # ops started before it that has not ended yet
        for e in reversed(host[max(0, i - 4096):i]):
            if e.time_range.end >= mid:
                best = e
                break
        name = best.name if best is not None else "(no host op)"
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
    return sorted(by_op.items(), key=lambda kv: -kv[1])[:top]


def trace_steps(run_steps, n):
    """Trace ``run_steps(n)`` on the device alone, then ``run_steps(1)``
    with the host's ops: a Trace of the n steps, with the flow span's
    device time and the idle gaps taken from the one-step pass."""
    events, wall = _profile(lambda: run_steps(n), with_host=False)
    tr = Trace(device_kernels(events), wall, n)
    events, _ = _profile(lambda: run_steps(1), with_host=True)
    tr.span_us[FLOW_SPAN] = span_kernel_us(events, FLOW_SPAN)
    tr.gaps = idle_gaps(device_kernels(events), events)
    return tr


def top_ops(kernels, top=10):
    """The device operations that took most time: [(name, s)]."""
    by = {}
    for k in kernels:
        by[k.name] = by.get(k.name, 0.0) + k.us * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]
