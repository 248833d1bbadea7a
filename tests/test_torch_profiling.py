"""The port's profiling utilities (utils/profiling.py) on the CPU.

The JAX package's counterparts wrap jax.profiler, whose traces are not
comparable with torch.profiler's, so these tests hold the port's own
contract: device_trace writes one trace that Chrome's trace viewer and
TensorBoard read (JSON with "traceEvents"), in which annotate's range and
the block's ops appear; StepTimer's block_and_stop takes tensors, lists
and dicts of them (no card here: nothing to wait for) and its rays/s is
the count over the mean time.
"""

import json
import os
import time

import pytest
import torch

from deblur4dgs_tpu_torch.utils import profiling as P
from tests.test_torch_models import torch_single_thread  # noqa: F401


def test_device_trace_and_annotate(tmp_path):
    with P.device_trace(str(tmp_path)) as prof:
        with P.annotate("d4gs_block"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert "d4gs_block" in names and "aten::mm" in names
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        trace = json.load(f)
    assert any(e.get("name") == "d4gs_block" for e in trace["traceEvents"])


def test_step_timer():
    timer = P.StepTimer()
    with timer:
        time.sleep(0.01)
    timer._t0 = time.time()
    timer.block_and_stop({"loss": torch.ones(()), "aux": [torch.zeros(2)]})
    assert len(timer.times) == 2 and timer.times[0] >= 0.01
    assert timer.mean == pytest.approx(sum(timer.times) / 2)
    assert timer.rays_per_sec(1000) == pytest.approx(1000 / timer.mean)
    assert P.StepTimer().mean == 0.0
