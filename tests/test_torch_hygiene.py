"""Port hygiene: no JAX in the port (nor anything else the card's machine
lacks: scikit-learn, orbax, optax, tensorboard, matplotlib, cv2, imageio,
Pillow), no kernel launches on CPU, no silent CPU fallback when CUDA is
asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deblur4dgs_tpu_torch import resolve_device
from deblur4dgs_tpu_torch.ops import rasterize as tr
from tests.test_torch_models import torch_single_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "deblur4dgs_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "flax", "deblur4dgs_tpu",
             "sklearn", "tensorboard", "tensorboardX", "matplotlib", "cv2",
             "imageio", "PIL")
# (file, module) imports allowed despite FORBIDDEN
ALLOWED = set()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_no_forbidden_imports_in_source():
    files = sorted(PKG.rglob("*.py")) + [
        REPO / "chip_smoke.py",
        REPO / "scripts" / "torch_quality_regression.py",
        REPO / "scripts" / "torch_multihost_worker.py"]
    assert len(files) >= 20
    found = [
        (f.relative_to(REPO).as_posix(), mod.split(".")[0])
        for f in files for mod in _imports(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    bad = [x for x in found if x not in ALLOWED]
    assert not bad, bad
    assert set(found) == ALLOWED


def test_importing_the_port_loads_no_jax():
    modules = [
        f"deblur4dgs_tpu_torch.{p.relative_to(PKG).with_suffix('').as_posix().replace('/', '.')}"
        for p in sorted(PKG.rglob("*.py"))
        if p.name not in ("__init__.py", "__main__.py")  # __main__ runs
    ]
    code = (
        "import sys, importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_help_loads_no_jax():
    """``python -m deblur4dgs_tpu_torch --help`` prints the usage, and the
    CLI with its subcommands' modules (the pipeline) loads no JAX."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "deblur4dgs_tpu_torch", "--help"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "train" in proc.stdout and "metrics" in proc.stdout
    code = (
        "import sys, runpy\n"
        "sys.argv = ['deblur4dgs_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('deblur4dgs_tpu_torch', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "import deblur4dgs_tpu_torch.pipeline\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cpu_calls_leave_launch_counters_at_zero():
    before = dict(tr.LAUNCHES)
    rng = np.random.default_rng(0)
    T, S, cap = 8, 2, 128
    dyn = torch.tensor(rng.uniform(0, 16, (T, S, 7, cap)).astype(np.float32),
                       requires_grad=True)
    st = torch.tensor(rng.uniform(0.1, 0.9, (T, 5, cap)).astype(np.float32),
                      requires_grad=True)
    counts = torch.full((T,), cap, dtype=torch.int32)
    ids = torch.arange(T, dtype=torch.int32)
    acc, tf = tr.composite_tiles_window(dyn, st, counts, ids, 4, 5, True)
    (acc.sum() + tf.sum()).backward()
    assert dyn.grad is not None and st.grad is not None
    d1 = dyn[:, 0].detach().clone().requires_grad_(True)
    acc, tf = tr.composite_tiles_split(d1, st, counts, ids, 4, 5, True)
    (acc.sum() + tf.sum()).backward()
    data = torch.cat([dyn[:, 0, :5], st[:, :1], dyn[:, 0, 5:6], st[:, 1:]],
                     1).detach().requires_grad_(True)
    acc, tf = tr.composite_tiles(data, counts, 4, 4)
    (acc.sum() + tf.sum()).backward()
    assert d1.grad is not None and data.grad is not None
    d2 = dyn.detach().clone().requires_grad_(True)
    acc, tf = tr.composite_buckets_scatter(
        [d2[:4], d2[4:]], [st[:4], st[4:]], [counts[:4], counts[4:]],
        [ids[:4], ids[4:]], T, 4, 5, True)
    (acc[:T].sum() + tf[:T].sum()).backward()
    assert d2.grad is not None
    assert tr.LAUNCHES == before
    assert before == {k: 0 for k in (
        "window_fwd", "window_bwd", "window_scatter_fwd",
        "window_scatter_bwd", "split_fwd", "split_bwd", "dense_fwd",
        "dense_bwd")}


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    from deblur4dgs_tpu_torch.convert import scene_from_numpy
    from tests.test_torch_models import scene_arrays

    with pytest.raises(RuntimeError):
        scene_from_numpy(scene_arrays(0), device="cuda")
    from deblur4dgs_tpu_torch.models.move_model import init_move_model

    with pytest.raises(RuntimeError):
        init_move_model(torch.Generator().manual_seed(0), 4)  # default cuda
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_or_mixed_inputs():
    """The CUDA wrappers never run on CPU tensors (and the autograd
    Function never falls back from a CUDA tensor to the twin)."""
    dyn = torch.zeros((8, 2, 7, 128))
    st = torch.zeros((8, 5, 128))
    counts = torch.zeros((8,), dtype=torch.int32)
    ids = torch.zeros((8,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tr.window_fwd_cuda(dyn, st, counts, ids, 4, 5, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tr.window_bwd_cuda(dyn, st, counts, ids, None, None, None, None, 4,
                           5, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tr.split_fwd_cuda(dyn[:, 0], st, counts, ids, 4, 5, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tr.split_bwd_cuda(dyn[:, 0], st, counts, ids, None, None, None,
                          None, 4, 5, True)
    shared = torch.zeros((9, 2, 5, 256)), torch.zeros((9, 2, 256))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tr.window_scatter_fwd_cuda(dyn, st, counts, ids, *shared, 4, 5, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tr.window_scatter_bwd_cuda(dyn, st, counts, ids, *shared, *shared,
                                   4, 5, True)
    table = torch.zeros((41, 12))
    idx = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tr.dense_fwd_cuda(table, idx, counts, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tr.dense_bwd_cuda(table, idx, counts, None, None, None, None, 4, 4)
    with pytest.raises(TypeError):
        tr._check_dense_inputs(table, idx, counts.long(), 4)
    with pytest.raises(ValueError):
        tr._check_dense_inputs(table, idx, counts, 9)  # rows of 16 floats
    assert tr._check_dense_inputs(table, idx, counts, 4) == (8, 128, 12)
    with pytest.raises(TypeError):
        tr._check_window_inputs(dyn, st, counts.long(), ids, 5, True)
    with pytest.raises(ValueError):
        tr._check_window_inputs(dyn, st[:, :4], counts, ids, 5, True)
    assert tr._check_window_inputs(dyn, st, counts, ids, 5, True) == \
        (8, 2, 7, 5, 128)


def test_scatter_buffer_checks():
    """The K6 wrappers' shape checks on the shared (T_img + 1, ...)
    buffers: the right shapes pass, a wrong sub-frame count raises."""
    acc, tf = torch.zeros((9, 2, 5, 256)), torch.zeros((9, 2, 256))
    assert tr._check_scatter_buffers(acc, tf, 2, 5, acc.device, "") == 8
    with pytest.raises(ValueError):
        tr._check_scatter_buffers(acc, tf, 3, 5, acc.device, "")
    with pytest.raises(ValueError):
        tr._check_scatter_buffers(acc, tf[:, :, :128], 2, 5, acc.device, "")


def test_train_loop_viewer_raises():
    """viewer= takes a TrainingViewer (vis/viewer.py): an object without its
    surface is refused up front, before anything is built for the loop."""
    from deblur4dgs_tpu_torch.train.loop import TrainLoop

    with pytest.raises(AttributeError, match="set_scene"):
        TrainLoop(None, None, None, None, None, 8, "unused", "first",
                  has_static=True, has_dynamic=False, has_reg=False,
                  viewer=object())
