"""The spans pass's readers (harness/spans.py) against hand-built event
lists and brute force, the four span metrics' readers, and trace_steps'
outputs on a stub (the passes it already had are left as they were)."""

import random
import sys
import types
from types import SimpleNamespace

import pytest
import torch

from harness import spans as SP, spec, trace as T

CPU, DEV = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2


def ev(name, a, b, d=CPU, i=-1, th=MAIN, note=False):
    return SimpleNamespace(name=name, device_type=d, id=i, thread=th,
                           is_user_annotation=note,
                           time_range=SimpleNamespace(start=a, end=b))


def launch(i, at, kernel, a, b, th=MAIN):
    """A runtime call at ``at`` on ``th`` and the kernel it launched."""
    return [ev("cudaLaunchKernel", at, at + 1, i=i, th=th),
            ev(kernel, a, b, DEV, i=i)]


def test_total_and_self_device_time():
    events = [ev("d4.step", 0, 100), ev("d4.render", 10, 40),
              ev("d4.render.bin", 12, 20)]
    events += launch(1, 5, "k_step", 10, 20)  # d4.step's own
    events += launch(2, 15, "k_bin", 18, 30)  # in d4.render.bin
    events += launch(3, 25, "k_render", 28, 50)  # d4.render's own
    events += launch(4, 60, "k_step", 70, 80)
    st = SP.read_spans(events, 1)
    s = st.spans
    # totals: unions of everything launched inside
    assert s["d4.step"]["ms"] == pytest.approx((50 - 10 + 10) * 1e-3)
    assert s["d4.render"]["ms"] == pytest.approx((50 - 18) * 1e-3)
    assert s["d4.render.bin"]["ms"] == pytest.approx(12e-3)
    # self: the kernels whose innermost span it is
    assert s["d4.step"]["self_ms"] == pytest.approx(20e-3)
    assert s["d4.render"]["self_ms"] == pytest.approx(22e-3)
    assert s["d4.render.bin"]["self_ms"] == pytest.approx(12e-3)
    assert [s[n]["launches"] for n in ("d4.step", "d4.render",
                                       "d4.render.bin")] == [4, 2, 1]
    assert st.step_spans == 1 and st.launches_in_step == st.launches == 4
    assert st.outside_step_ms == 0.0


def test_autograd_thread_launches_charge_its_spans_then_the_steps():
    events = [ev("d4.step", 0, 200), ev("d4.step.backward", 100, 200),
              ev("d4.composite.bwd", 120, 150, th=AUTOGRAD)]
    events += launch(1, 130, "k2", 130, 140, th=AUTOGRAD)  # composite.bwd
    events += launch(2, 160, "scatter_add", 160, 175, th=AUTOGRAD)
    events += launch(3, 110, "fill", 110, 112)  # backward, step's thread
    events += launch(4, 250, "late", 250, 260)  # after the step
    st = SP.read_spans(events, 1)
    s = st.spans
    assert st.charged == [
        ("fill", ("d4.step", "d4.step.backward")),
        ("k2", ("d4.step", "d4.step.backward", "d4.composite.bwd")),
        ("scatter_add", ("d4.step", "d4.step.backward")),
        ("late", ())]
    assert s["d4.composite.bwd"]["self_ms"] == pytest.approx(10e-3)
    assert s["d4.step.backward"]["self_ms"] == pytest.approx(17e-3)
    assert s["d4.step.backward"]["ms"] == pytest.approx(27e-3)
    assert s["d4.step"]["launches"] == 3
    assert st.launches_in_step == 3 and st.launches == 4
    assert st.outside_step_ms == pytest.approx(10e-3)


def test_syncs_are_counted_in_every_span_around_them():
    events = [ev("d4.step", 0, 200), ev("d4.render", 10, 40),
              ev("d4.step.backward", 100, 200),
              ev("cudaStreamSynchronize", 20, 25),
              ev("cudaMemcpy", 60, 62),
              ev("cudaMemcpyAsync", 63, 64),  # does not wait
              ev("cudaDeviceSynchronize", 170, 171, th=AUTOGRAD),
              ev("cudaEventSynchronize", 300, 301)]  # outside the step
    s = SP.read_spans(events, 2).spans
    assert s["d4.step"]["syncs"] == 3 / 2
    assert s["d4.render"]["syncs"] == 1 / 2
    assert s["d4.step.backward"]["syncs"] == 1 / 2
    assert [SP.is_sync(n) for n in ("cudaMemcpy2D", "cudaMemcpyAsync",
                                    "cudaLaunchKernel")] == [True, False,
                                                             False]


def test_user_annotations_are_never_kernels():
    events = [ev("d4.step", 0, 100), ev("d4.render", 10, 40)]
    events += launch(1, 12, "k", 20, 25)
    # the card's view of the d4.render range, tied to the same launch
    events.append(ev("d4.render", 15, 90, DEV, i=1, note=True))
    st = SP.read_spans(events, 1)
    assert st.spans["d4.render"]["ms"] == pytest.approx(5e-3)
    assert st.launches == 1 and st.annotations == 1


def test_idle_gaps_by_the_innermost_span_on_any_thread():
    events = [ev("d4.step", 0, 200), ev("d4.render", 10, 40),
              ev("d4.step.backward", 100, 200),
              ev("d4.composite.bwd", 120, 150, th=AUTOGRAD)]
    events += launch(1, 0, "a", 0, 10)
    events += launch(2, 20, "b", 30, 50)  # gap 10-30, mid 20: d4.render
    events += launch(3, 110, "c", 110, 125)  # gap 50-110, mid 80: d4.step
    events += launch(4, 130, "d", 135, 140, th=AUTOGRAD)
    # gap 125-135, mid 130: composite.bwd (autograd thread, latest start)
    events += launch(5, 215, "e", 220, 230)
    # gap 140-220, mid 180: d4.step.backward (composite.bwd has ended)
    events += launch(6, 280, "f", 300, 310)  # gap 230-300, mid 265: none
    idle = dict(SP.read_spans(events, 1).idle_by_span)
    assert idle == pytest.approx({"d4.render": 20e-6, "d4.step": 60e-6,
                                  "d4.composite.bwd": 10e-6,
                                  "d4.step.backward": 80e-6,
                                  SP.OUTSIDE: 70e-6})


def _brute(events):
    """Per span name: the set of integer instants covered by the kernels
    launched inside it, and by those whose innermost span it is."""
    spans = [e for e in events if e.name.startswith("d4.")
             and e.device_type == CPU]
    main = next(e.thread for e in spans if e.name == "d4.step")
    calls = {e.id: e for e in events if e.name == "cudaLaunchKernel"}
    total, own = {}, {}
    for k in events:
        if k.device_type != DEV or k.is_user_annotation:
            continue
        c = calls[k.id]
        t = c.time_range.start
        inside = lambda th: sorted(
            (s for s in spans if s.thread == th
             and s.time_range.start <= t <= s.time_range.end),
            key=lambda s: s.time_range.start)
        mine = inside(c.thread)
        outer = inside(main) if c.thread != main else []
        grid = set(range(int(k.time_range.start), int(k.time_range.end)))
        for s in mine + outer:
            total.setdefault(s.name, set()).update(grid)
        inner = mine[-1] if mine else outer[-1] if outer else None
        if inner is not None:
            own.setdefault(inner.name, set()).update(grid)
    return total, own


@pytest.mark.parametrize("seed", range(6))
def test_readings_against_brute_force(seed):
    rng = random.Random(seed)
    names = ["d4.a", "d4.b", "d4.c", "d4.d"]
    events = [ev("d4.step", 0, 1000)]

    def nest(a, b, depth, th):
        t = a
        while depth < 3 and t < b - 20 and rng.random() < 0.7:
            s = rng.randrange(t, b - 10)
            e = rng.randrange(s + 5, min(b, s + 300))
            events.append(ev(rng.choice(names), s, e, th=th))
            nest(s + 1, e - 1, depth + 1, th)
            t = e + 1
    nest(1, 999, 0, MAIN)
    events.append(ev("d4.b", 600, 700, th=AUTOGRAD))
    for i in range(60):
        at = rng.randrange(0, 1000)
        th = AUTOGRAD if 600 <= at <= 700 and rng.random() < 0.5 else MAIN
        start = at + rng.randrange(0, 50)
        events += launch(i, at, "k%d" % (i % 5), start,
                         start + rng.randrange(1, 40), th=th)
        if rng.random() < 0.2:
            events.append(ev("d4.a", start, start + 100, DEV, i=i,
                             note=True))
    st = SP.read_spans(events, 1)
    total, own = _brute(events)
    for n, grid in total.items():
        assert st.spans[n]["ms"] == pytest.approx(len(grid) * 1e-3), n
    for n in st.spans:
        assert st.spans[n]["self_ms"] == pytest.approx(
            len(own.get(n, ())) * 1e-3), n


def test_the_span_metrics_read_their_spans_or_nothing():
    spans = {"d4.flow.pwcnet": {"ms": 900.0, "syncs": 1.0},
             "d4.render": {"ms": 40.0, "syncs": 0.0},
             "d4.step.backward": {"ms": 60.0, "syncs": 0.0},
             "d4.step": {"ms": 1100.0, "syncs": 0.0}}
    read = lambda m, tr: spec.metric_reader(m)(SimpleNamespace(trace=tr))
    with_spans = SimpleNamespace(spans=spans)
    assert [read(m, with_spans) for m in (
        "pwcnet_ms", "render_ms", "backward_ms", "host_syncs_per_step")] == \
        [900.0, 40.0, 60.0, 0.0]
    # a trace without spans (the parent's, or a port that records none)
    for tr in (T.Trace([], 1.0, 1), SimpleNamespace(spans={})):
        assert [read(m, tr) for m in (
            "pwcnet_ms", "render_ms", "backward_ms",
            "host_syncs_per_step")] == [None] * 4


def test_consistency_and_the_device_only_mapping():
    events = [ev("d4.step", 0, 100), ev("d4.render", 10, 40)]
    events += launch(1, 5, "a", 10, 20)
    events += launch(2, 15, "b", 20, 30)
    events += launch(3, 20, "a", 30, 40)
    events += launch(4, 200, "c", 200, 210)  # outside the step
    st = SP.read_spans(events, 1)
    c = SP.consistency(st, 40e-3)
    assert c["span_self_sum_ms"] == pytest.approx(40e-3)
    assert c["ratio"] == pytest.approx(1.0)
    # two device-only steps: each kernel takes the chain of its name's
    # occurrence in the spans pass; launches and syncs stay the pass's
    ks = [T.Kernel(n, s, s + 5) for n, s in
          (("a", 0), ("b", 10), ("a", 20), ("c", 30),
           ("a", 100), ("b", 110), ("a", 120), ("c", 130))]
    got = SP.charge_device_pass(st, ks, 2)
    assert got["d4.step"] == pytest.approx(
        {"ms": 15e-3, "self_ms": 5e-3, "launches": 3, "syncs": 0})
    assert got["d4.render"] == pytest.approx(
        {"ms": 10e-3, "self_ms": 10e-3, "launches": 2, "syncs": 0})
    assert sum(v["self_ms"] for v in got.values()) == pytest.approx(
        T.busy_us([k for k in ks if k.name != "c"]) * 1e-3 / 2)


def test_trace_steps_outputs_on_a_stub_are_unchanged(monkeypatch):
    device_pass = [ev("k1", 0, 10, DEV, i=1), ev("k2", 20, 30, DEV, i=2)]
    host_pass = [ev("bench.flow_fn", 0, 50), ev("aten::mul", 12, 18),
                 ev("cudaLaunchKernel", 5, 6, i=3), ev("k1", 10, 15, DEV, i=3),
                 ev("cudaLaunchKernel", 60, 61, i=4),
                 ev("k2", 40, 45, DEV, i=4)]
    passes = iter([(device_pass, 0.5), (host_pass, 0.7)])
    ran = []
    monkeypatch.setattr(T, "_profile", lambda run, with_host: (
        run(), next(passes))[1])
    tr = T.trace_steps(lambda n: ran.append(n), 3)
    assert ran == [3, 1]
    assert [(k.name, k.start_us, k.end_us) for k in tr.kernels] == [
        ("k1", 0, 10), ("k2", 20, 30)]
    assert (tr.wall_s, tr.steps) == (0.5, 3)
    assert tr.span_us == {T.FLOW_SPAN: 5}
    # the gap 15-40 (mid 27.5) lies in the flow span, after aten::mul ended
    assert tr.gaps == [("bench.flow_fn", pytest.approx(25e-6))]


def test_a_port_without_spans_gives_an_empty_pass(monkeypatch):
    """The parent's port has no tracing switch: the pass runs, and every
    reader finds nothing."""
    monkeypatch.setitem(sys.modules, "deblur4dgs_tpu_torch.utils.profiling",
                        types.ModuleType("profiling"))
    monkeypatch.setattr(T, "_profile", lambda run, with_host: (run(), ([
        ev("aten::mul", 0, 5), ev("cudaLaunchKernel", 1, 2, i=1),
        ev("k", 3, 9, DEV, i=1)], 0.0))[1])
    st, _ = SP.trace_spans(lambda n: None, 1)
    assert (st.step_spans, st.spans, st.launches) == (0, {}, 1)
    tr = SimpleNamespace(spans=SP.charge_device_pass(
        st, [T.Kernel("k", 0, 5)], 1))
    assert tr.spans == {}
    assert [spec.metric_reader(m)(SimpleNamespace(trace=tr)) for m in (
        "pwcnet_ms", "render_ms", "backward_ms",
        "host_syncs_per_step")] == [None] * 4


def test_the_spans_pass_on_the_port_at_a_tiny_size(monkeypatch):
    """trace_spans on the port's step at the tiny cell, on the CPU (no
    device events: every span is there, with no device time)."""
    from conftest import tiny_cell
    from torch.profiler import ProfilerActivity, profile

    from harness import gen, sides

    def cpu_profile(run, with_host):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        return prof.events(), 0.0

    monkeypatch.setattr(T, "_profile", cpu_profile)
    cell = tiny_cell()
    inputs = gen.make_inputs(cell.config, cell.traffic, 2200000123, "cpu",
                             sides.pwcnet_meta())
    side = sides.build(sides.PORT, inputs, cell.config, cell.traffic, "cpu")
    st, events = SP.trace_spans(lambda n: [sides.drive(side, inputs, k)
                                           for k in range(n)], 1)
    assert st.step_spans == 1 and st.launches == 0
    for name in ("d4.step", "d4.step.static", "d4.step.dynamic",
                 "d4.step.reg", "d4.step.backward", "d4.step.optimizer",
                 "d4.render", "d4.render.composite", "d4.flow.pwcnet",
                 "d4.pwcnet.level2", "d4.composite.bwd", "d4.loss.rgb"):
        assert st.spans[name] == {"ms": 0.0, "self_ms": 0.0,
                                  "launches": 0.0, "syncs": 0.0}, name
    # the switch is restored after the pass
    from deblur4dgs_tpu_torch.utils import profiling
    assert not profiling.enabled()
