"""The port's process groups and collectives (deblur4dgs_tpu_torch/parallel/
mesh.py) on the CPU.

  * maybe_init_distributed is a no-op unless DEBLUR4DGS_DIST is 1 / true,
    and reads the DEBLUR4DGS_* variables, else torchrun's;
  * on two gloo ranks (separate processes, one thread each), every
    collective's forward and adjoint against the same function computed in
    one process: enter / reduce_sum (a replicated leaf through both ranks'
    shares: its gradient is the sum of the shares', and a replicated term
    counts once), gather with blocks of unequal size and with an empty
    block, reduce_max / reduce_min with ties inside a rank and across the
    ranks (the cotangent split evenly over all of them) and an empty rank;
    both ranks hold equal results;
  * scripts/torch_multihost_worker.py (the three-branch step with the
    sub-frames sharded) on two gloo ranks prints one loss on both, equal to
    a single-process run's (rel 2e-5, tests/test_multihost.py's bar).

``start_ranks`` / ``wait_ranks`` launch the ranks of a test;
tests/test_torch_sharding.py uses them too.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deblur4dgs_tpu_torch.parallel import mesh as M

REPO = Path(__file__).resolve().parents[1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(target, out_dir, world=2, torchrun=False):
    """Start ``target`` (``"tests.<module>:<function>"``, called with
    out_dir; or a script's path) in ``world`` processes that rendezvous
    over gloo on the CPU: through the DEBLUR4DGS_* variables, or
    torchrun's. One thread each."""
    port = _free_port()
    if target.endswith(".py"):
        argv = [sys.executable, target]
    else:
        mod, fn = target.split(":")
        argv = [sys.executable, "-c",
                f"import sys; sys.path.insert(0, {str(REPO)!r}); "
                f"from {mod} import {fn}; {fn}({str(out_dir)!r})"]
    procs = []
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   DEBLUR4DGS_DIST="1", MULTIHOST_CPU="1")
        for k in ("DEBLUR4DGS_NUM_PROCESSES", "DEBLUR4DGS_PROCESS_ID",
                  "DEBLUR4DGS_COORDINATOR_ADDRESS", "RANK", "WORLD_SIZE",
                  "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        if torchrun:
            env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        else:
            env.update(DEBLUR4DGS_NUM_PROCESSES=str(world),
                       DEBLUR4DGS_PROCESS_ID=str(r),
                       DEBLUR4DGS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            argv, env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def wait_ranks(procs, timeout=600):
    """Wait for the ranks of start_ranks (killing them at the timeout);
    returns their outputs, fails the test if a rank failed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} (exit {p.returncode}):\n{out[-3000:]}"
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return outs


def init_rank():
    """In a rank process: one thread, the process group up (gloo, CPU)."""
    torch.set_num_threads(1)
    assert M.maybe_init_distributed(device="cpu")
    return M.global_mesh(device="cpu")


# ---------------------------------------------------------------------------
# The environment
# ---------------------------------------------------------------------------


def _capture_init(monkeypatch):
    calls = []
    monkeypatch.setattr(M.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    return calls


@pytest.mark.parametrize("value", [None, "", "0", "false", "no"])
def test_init_is_a_noop_unless_asked(monkeypatch, value):
    calls = _capture_init(monkeypatch)
    if value is None:
        monkeypatch.delenv("DEBLUR4DGS_DIST", raising=False)
    else:
        monkeypatch.setenv("DEBLUR4DGS_DIST", value)
    assert M.maybe_init_distributed(device="cpu") is False
    assert not calls
    assert not M.dist.is_initialized()


@pytest.mark.parametrize("style", ["deblur4dgs", "torchrun"])
def test_init_reads_the_launcher_variables(monkeypatch, style):
    calls = _capture_init(monkeypatch)
    for k in ("DEBLUR4DGS_NUM_PROCESSES", "DEBLUR4DGS_PROCESS_ID",
              "DEBLUR4DGS_COORDINATOR_ADDRESS", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DEBLUR4DGS_DIST", "TRUE")
    if style == "torchrun":
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("RANK", "3")
        monkeypatch.setenv("LOCAL_RANK", "1")
        monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
        monkeypatch.setenv("MASTER_PORT", "29500")
        want = (4, 3, "tcp://10.0.0.2:29500", 1)
    else:
        monkeypatch.setenv("DEBLUR4DGS_NUM_PROCESSES", "2")
        monkeypatch.setenv("DEBLUR4DGS_PROCESS_ID", "1")
        monkeypatch.setenv("DEBLUR4DGS_COORDINATOR_ADDRESS", "host0:1234")
        want = (2, 1, "tcp://host0:1234", 1)
    assert M.maybe_init_distributed(device="cpu") is True
    (args, kw), = calls
    assert args == ("gloo",)
    assert (kw["world_size"], kw["rank"], kw["init_method"]) == want[:3]
    assert M.local_rank() == want[3]


def test_rank_device_defaults_to_the_local_card(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "1")
    if not torch.cuda.is_available():  # the entry points never fall back
        with pytest.raises(RuntimeError, match="cuda:1"):
            M.rank_device()
    assert M.rank_device("cpu") == torch.device("cpu")


def test_single_process_mesh():
    """No process group: a mesh of one rank whose collectives are
    identities with identity adjoints."""
    mesh = M.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.shape) == (0, 1, {"sub": 1})
    assert mesh.block(11) == (0, 11) and mesh.counts(3) == [3]
    x = torch.arange(6.0).reshape(3, 2).requires_grad_()
    y = M.reduce_sum(mesh, *M.enter(mesh, x))[0]
    (z,) = M.gather(mesh, y)
    (M.reduce_max(mesh, z).sum() + z.sum()).backward()
    np.testing.assert_array_equal(z.detach().numpy(), x.detach().numpy())
    np.testing.assert_array_equal(x.grad.numpy(), [[1, 1], [1, 1], [2, 2]])
    with pytest.raises(ValueError, match="no process group"):
        M.make_mesh(2, device="cpu")


def test_blocks_split_as_gspmd():
    assert [M.block_of(11, 2, r) for r in range(2)] == [(0, 6), (6, 11)]
    assert [M.block_of(3, 2, r) for r in range(2)] == [(0, 2), (2, 3)]
    assert [M.block_of(1, 2, r) for r in range(2)] == [(0, 1), (1, 1)]
    assert [M.block_of(2, 4, r) for r in range(4)] == [
        (0, 1), (1, 2), (2, 2), (2, 2)]


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

STACK = np.array([[1.0, 5.0, 0.0], [3.0, 5.0, -2.0], [3.0, 2.0, -2.0]],
                 np.float32)  # rows: the sub-frames; rank 0 rows 0-1, rank 1 row 2


def _collectives(rank, world, mesh):
    """Every collective's forward and gradient on this rank, and the same
    function on one process: {name: (sharded, reference)}."""
    out = {}
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    # enter + reduce_sum: a replicated leaf p feeds both shares (share r is
    # sin(p * (r + 1))); the loss adds a replicated term (p^2).
    p = t([0.3, -1.2, 2.0]).requires_grad_()
    (pe,) = M.enter(mesh, p)
    (tot,) = M.reduce_sum(mesh, torch.sin(pe * (rank + 1)))
    ((tot * t([1.0, 2.0, 3.0])).sum() + (p * p).sum()).backward()
    q = t([0.3, -1.2, 2.0]).requires_grad_()
    ref = sum(torch.sin(q * (r + 1)) for r in range(world))
    ((ref * t([1.0, 2.0, 3.0])).sum() + (q * q).sum()).backward()
    out["sum_fwd"] = (tot.detach(), ref.detach())
    out["sum_grad"] = (p.grad, q.grad)

    # gather: blocks 2 + 1, then 1 + 0; the stack rows of each rank
    for n in (3, 1):
        a, b = M.block_of(n, world, rank)
        leaf = t(STACK[:n]).requires_grad_()
        (le,) = M.enter(mesh, leaf)
        (g,) = M.gather(mesh, le[a:b] * 2.0, counts=mesh.counts(n))
        w = t(np.arange(g.numel(), dtype=np.float32).reshape(g.shape))
        (g * w).sum().backward()
        out[f"gather{n}_fwd"] = (g.detach(), t(STACK[:n] * 2.0))
        out[f"gather{n}_grad"] = (leaf.grad, 2.0 * w)

    # reduce_max / reduce_min over the 3 sub-frames: ties inside rank 0
    # (column 1), across the ranks (column 0 of the max, column 2 of the
    # min); then over 1 sub-frame (rank 1 empty)
    for n in (3, 1):
        a, b = M.block_of(n, world, rank)
        for name, fn, ref_fn in (("max", M.reduce_max, torch.amax),
                                 ("min", M.reduce_min, torch.amin)):
            leaf = t(STACK[:n]).requires_grad_()
            (le,) = M.enter(mesh, leaf)
            y = fn(mesh, le[a:b])
            w = t([1.0, 10.0, 100.0])
            (y * w).sum().backward()
            lr = t(STACK[:n]).requires_grad_()
            yr = ref_fn(lr, 0)
            (yr * w).sum().backward()
            out[f"{name}{n}_fwd"] = (y.detach(), yr.detach())
            out[f"{name}{n}_grad"] = (leaf.grad, lr.grad)
    return out


def collectives_rank(out_dir):
    mesh = init_rank()
    out = _collectives(mesh.rank, mesh.size, mesh)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **{
        f"{k}.{i}": v[i].numpy() for k, v in out.items() for i in (0, 1)})
    M.dist.destroy_process_group()


@pytest.mark.parametrize("torchrun", [False, True],
                         ids=["deblur4dgs-vars", "torchrun-vars"])
def test_collectives_on_two_gloo_ranks(tmp_path, torchrun):
    wait_ranks(start_ranks("tests.test_torch_mesh:collectives_rank",
                           tmp_path, torchrun=torchrun))
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))
    names = sorted({k.rsplit(".", 1)[0] for k in r0.files})
    assert len(names) == 14, names
    for k in names:
        # both ranks hold the same values, bit for bit
        np.testing.assert_array_equal(r0[f"{k}.0"], r1[f"{k}.0"], err_msg=k)
        np.testing.assert_allclose(r0[f"{k}.0"], r0[f"{k}.1"], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # the ties: column 0 of the max splits over a row of each rank, column
    # 1 over both rows of rank 0; column 2 of the min over a row of each
    np.testing.assert_array_equal(
        r0["max3_grad.0"], [[0, 5, 100], [0.5, 5, 0], [0.5, 0, 0]])
    np.testing.assert_array_equal(
        r0["min3_grad.0"], [[1, 0, 0], [0, 0, 50], [0, 10, 50]])
    np.testing.assert_array_equal(r0["max1_grad.0"], [[1, 10, 100]])


def _losses(outs):
    found = [line.split() for out in outs for line in out.splitlines()
             if line.startswith("MULTIHOST_LOSS")]
    return {int(r): float(v) for _, r, v in found}


def test_multihost_worker_matches_one_process(tmp_path):
    worker = str(REPO / "scripts" / "torch_multihost_worker.py")
    two = _losses(wait_ranks(start_ranks(worker, tmp_path)))
    assert set(two) == {0, 1} and two[0] == two[1], two
    env = dict(os.environ, DEBLUR4DGS_DIST="0", MULTIHOST_CPU="1",
               OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, worker], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert one.returncode == 0, one.stdout[-2000:] + one.stderr[-4000:]
    ref = _losses([one.stdout])[0]
    assert np.isfinite(ref)
    assert two[0] == pytest.approx(ref, rel=2e-5), (two, ref)
