"""The port's spans (utils/profiling.py) on the CPU.

The JAX package's counterparts wrap jax.profiler, whose traces are not
comparable with torch.profiler's, so these tests hold the port's own
contract: with tracing off a span is one shared no-op context and leaves
no record; with tracing on it is a record_function range that nests the
ops run inside it on the trace's clock and carries its args (which
torch's execution trace keeps); ``tracing()`` and ``D4_TRACE`` set the
switch and ``tracing()`` restores it. One stage-2 step at 128x128 (the
bucketed window path, the dense compositor in the reg branch, a seeded
PWC-Net as the flow term) records every span of the step the expected
number of times, and its loss and parameters are bit-identical with
tracing on and off.
"""

import importlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import (
    ExecutionTraceObserver,
    ProfilerActivity,
    profile,
)

from deblur4dgs_tpu_torch import configs as tcfg
from deblur4dgs_tpu_torch.convert import scene_from_numpy
from deblur4dgs_tpu_torch.models import pwcnet as TP
from deblur4dgs_tpu_torch.train import trainer as TT
from deblur4dgs_tpu_torch.train.optimizers import make_optimizer
from deblur4dgs_tpu_torch.utils import profiling as P
from tests.test_torch_models import (
    K128,
    NUM_FRAMES,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_train_full import _wrap, step_inputs

CPU = torch.autograd.DeviceType.CPU


def _d4(events):
    return [e for e in events if e.name.startswith("d4.")]


def _inside(inner, outer):
    return (inner.thread == outer.thread
            and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_off_is_one_shared_no_op_and_leaves_no_record():
    x = torch.randn(32, 32)
    with P.tracing(False):
        assert P.span("d4.a") is P.span("d4.b", step=1)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with P.span("d4.block", step=3):
                (x @ x).sum()
    names = [e.name for e in prof.events()]
    assert "aten::mm" in names and not _d4(prof.events())


def test_span_on_nests_the_ops_inside_and_carries_its_args(tmp_path):
    x = torch.randn(32, 32)
    et_path = tmp_path / "et.json"
    et = ExecutionTraceObserver().register_callback(str(et_path))
    with P.tracing(), profile(activities=[ProfilerActivity.CPU],
                              execution_trace_observer=et) as prof:
        with P.span("d4.block", step=3, mode="blury"):
            with P.span("d4.inner"):
                (x @ x).sum()
        torch.relu(x)
    ev = prof.events()
    block, = [e for e in ev if e.name == "d4.block"]
    inner, = [e for e in ev if e.name == "d4.inner"]
    mm, = [e for e in ev if e.name == "aten::mm"]
    relu, = [e for e in ev if e.name == "aten::relu"]
    assert _inside(inner, block) and _inside(mm, inner)
    assert not _inside(relu, block)
    nodes = {n["name"]: n for n in json.loads(et_path.read_text())["nodes"]}
    assert nodes["d4.block"]["inputs"]["values"] == ["step=3, mode=blury"]
    assert nodes["d4.inner"]["inputs"]["values"] == []


def test_tracing_and_d4_trace_set_and_restore_the_switch(monkeypatch):
    before = P.enabled()
    with P.tracing():
        assert P.enabled()
        with P.tracing(False):
            assert not P.enabled()
        assert P.enabled()
    assert P.enabled() == before
    try:
        monkeypatch.setenv("D4_TRACE", "1")
        assert importlib.reload(P).enabled()
        monkeypatch.setenv("D4_TRACE", "0")
        assert not importlib.reload(P).enabled()
        monkeypatch.delenv("D4_TRACE")
        assert not importlib.reload(P).enabled()
    finally:
        monkeypatch.undo()
        importlib.reload(P)


# One stage-2 step as the pipeline's phase B drives it: S = 3 at 128x128,
# one static frame, the dynamic frame with tracks, the guide and the flow
# term, the reg frame.
S, CAP, EPOCH = 3, 256, 25
FLAGS = dict(has_static=True, has_dynamic=True, has_reg=True, has_batch4=True)
RENDERS = 3  # static, dynamic, reg
RGB_LOSSES = 1 + 2 + 1  # static, dynamic (masked and full), reg


def _one_step(tracing_on):
    """A fresh state's first step under the profiler: (loss, parameters,
    the trace's events)."""
    arrays = scene_arrays(seed=13)
    scene = scene_from_numpy(arrays, device="cpu")
    lr, ocfg = tcfg.SceneLRConfig(), tcfg.OptimizerConfig()
    state = TT.init_train_state(scene, lr, ocfg)
    net = TP.init_pwcnet(torch.Generator().manual_seed(0), device="cpu")
    step = TT.make_train_step(
        make_optimizer(scene, lr, ocfg), tcfg.LossesConfig(),
        tcfg.RenderConfig(num_exposure=S, tile_cap=CAP), "second",
        NUM_FRAMES, flow_fn=TP.make_aligned_loss_fn(net), **FLAGS)
    cfg = dict(wh=(128, 128), K=K128, **FLAGS)
    static, dyn, tracks, reg, b4 = step_inputs(cfg)
    args = (_wrap(TT.FrameBatch, [a[:1] for a in static], torch.as_tensor),
            _wrap(TT.FrameBatch, dyn, torch.as_tensor),
            _wrap(TT.TrackBatch, tracks, torch.as_tensor),
            _wrap(TT.FrameBatch, reg, torch.as_tensor),
            torch.as_tensor(b4))
    with P.tracing(tracing_on), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        state, loss, _ = step(state, EPOCH, *args)
    params = {k: p.detach().clone() for k, p in scene.named_parameters()}
    return loss, params, prof.events()


@pytest.fixture(scope="module")
def steps():
    return {on: _one_step(on) for on in (False, True)}


def test_step_records_every_span_of_the_step(steps):
    _, _, off = steps[False]
    assert not _d4(off)
    _, _, ev = steps[True]
    spans = _d4(ev)
    count = lambda name: sum(e.name == name for e in spans)
    once = ["d4.step", "d4.step.static", "d4.step.dynamic", "d4.step.reg",
            "d4.step.backward", "d4.step.optimizer", "d4.step.density_stats",
            "d4.flow.pwcnet", "d4.flow.warp", "d4.pwcnet.extract",
            "d4.pwcnet.refine"]
    once += [f"d4.pwcnet.level{lv}" for lv in range(2, 7)]
    assert {n: count(n) for n in once} == {n: 1 for n in once}
    assert count("d4.render") == RENDERS
    assert count("d4.loss.rgb") == RGB_LOSSES
    assert count("d4.pwcnet.corr") == 5  # one cost volume per level
    # every render deforms, projects, bins, packs and composites
    for name in ("exposure", "project", "bin", "pack", "composite"):
        assert count(f"d4.render.{name}") >= RENDERS, name
    assert count("d4.composite.bwd") >= 2  # the window and the dense paths

    def parents(name, *outer):
        return all(any(_inside(e, o) for o in spans if o.name in outer)
                   for e in spans if e.name == name)
    step, = [e for e in spans if e.name == "d4.step"]
    assert all(_inside(e, step) for e in spans if e.thread == step.thread)
    assert parents("d4.render", "d4.step.static", "d4.step.dynamic",
                   "d4.step.reg")
    for name, outer in (("d4.pwcnet.level2", "d4.flow.pwcnet"),
                        ("d4.pwcnet.corr", "d4.flow.pwcnet"),
                        ("d4.flow.pwcnet", "d4.step.dynamic"),
                        ("d4.render.bin", "d4.render"),
                        ("d4.loss.rgb", "d4.step"),
                        ("d4.composite.bwd", "d4.step.backward")):
        assert parents(name, outer), (name, outer)
    aten = [e for e in ev if e.device_type == CPU
            and e.name.startswith("aten::") and e.thread == step.thread]
    assert all(_inside(e, step) for e in aten)


def test_step_is_bit_identical_with_tracing_on_and_off(steps):
    loss_off, params_off, _ = steps[False]
    loss_on, params_on, _ = steps[True]
    assert torch.equal(loss_on, loss_off)
    assert params_on.keys() == params_off.keys()
    for k in params_off:
        assert torch.equal(params_on[k], params_off[k]), k
    assert np.isfinite(float(loss_on))
