"""Process groups + the collectives of the multi-device paths.

PyTorch port of deblur4dgs_tpu/parallel/mesh.py. The reference is
single-controller: one JAX program drives every device, and GSPMD inserts
the collectives and differentiates through them. Here each device has its
own process under ``torch.distributed``, so the collectives and their
adjoints are stated explicitly, as ``torch.autograd.Function``s (the f / g
pair of tensor-parallel training):

  * ``enter``: identity forward, all-reduce sum backward. Applied to every
    replicated tensor that feeds this rank's share of the work, so the
    gradient of a replicated tensor is the sum of every rank's share.
  * ``reduce_sum``: all-reduce sum forward, identity backward (each rank's
    partial sum gets the whole cotangent).
  * ``gather``: all-gather along dim 0 forward (blocks of unequal size
    allowed); backward, this rank's block of the cotangent.
  * ``reduce_max`` / ``reduce_min`` over dim 0 of the ranks' stacks:
    all-reduce MAX / MIN forward; the backward splits the cotangent evenly
    over every tied position on every rank (the rule of ``jnp.max``, which
    the reference's sub-frame-sharded render differentiates).

The loss is then computed on every rank from replicated tensors, and every
rank ends backward holding the full gradient of every replicated leaf: no
gradient all-reduce runs after backward (which would count the terms that
never touch a sharded tensor once per rank). A rank whose share is empty
still joins every collective, with the identity element (0, -inf, +inf).

Collectives run in the order the ranks create them. Backward runs the
collectives' nodes in reverse creation order on every rank (autograd runs
the ready node created last first), so the ranks' graphs may differ inside
a share (six sub-frames on one rank, five on the other) but must create
their collectives in one order.

Transport: NCCL when each rank has its own card, gloo on the CPU. Ranks
that share one card use gloo: its all-reduce takes CUDA tensors, and its
all-gather, which does not, goes through host memory (``Mesh.staged``).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from deblur4dgs_tpu_torch import resolve_device


class Mesh(NamedTuple):
    """One mesh axis over a process group. ``group`` is None for the
    default (whole-world) group. A ``local`` mesh is this process alone,
    with no process group: its collectives are identities."""

    group: object
    rank: int  # this process's index on the axis
    size: int
    axis: str
    device: torch.device
    local: bool = False

    @property
    def shape(self) -> dict:
        """{axis: size}, as jax.sharding.Mesh.shape."""
        return {self.axis: self.size}

    @property
    def backend(self) -> str | None:
        return None if self.local else dist.get_backend(self.group)

    @property
    def staged(self) -> bool:
        """All-gathers of CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        if self.local:
            return "none (one process, no process group)"
        if self.staged:
            return "gloo (all-reduce of CUDA tensors; all-gather staged " \
                   "through host memory)"
        return str(self.backend)

    def block(self, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's contiguous block of n items, blocks
        of ceil(n / size) as GSPMD splits an axis (11 over 2: 6 + 5; 1 over
        2: 1 + 0)."""
        return block_of(n, self.size, self.rank)

    def counts(self, n: int) -> list[int]:
        """Every rank's block size of n items."""
        return [b - a for a, b in (block_of(n, self.size, r)
                                   for r in range(self.size))]


def block_of(n: int, size: int, rank: int) -> tuple[int, int]:
    b = -(-n // size)
    return min(rank * b, n), min((rank + 1) * b, n)


class Sharding(NamedTuple):
    """What the reference's NamedSharding says here: a mesh and the axis a
    tensor's leading dim is split over, or None for replicated."""

    mesh: Mesh
    axis: str | None


def subframe_sharding(mesh: Mesh, axis: str | None = None) -> Sharding:
    """Sharding of arrays whose leading dim is the exposure sub-frame."""
    return Sharding(mesh, mesh.axis if axis is None else axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    LOCAL_RANK, else the process id (one host)."""
    for var in ("LOCAL_RANK", "DEBLUR4DGS_PROCESS_ID", "RANK"):
        if os.environ.get(var):
            return int(os.environ[var])
    return 0


def maybe_init_distributed(env_var: str = "DEBLUR4DGS_DIST", device=None,
                           backend: str | None = None) -> bool:
    """Multi-process entry: init the default process group when the
    launcher sets ``DEBLUR4DGS_DIST=1`` (or ``true``); a no-op otherwise,
    so entry points can call it unconditionally. Returns True when it ran.

    Process count and id: DEBLUR4DGS_NUM_PROCESSES / DEBLUR4DGS_PROCESS_ID
    when set (plain-process launchers), else torchrun's WORLD_SIZE / RANK.
    Coordinator: DEBLUR4DGS_COORDINATOR_ADDRESS (``host:port``), else
    MASTER_ADDR:MASTER_PORT (torchrun). ``device`` is this rank's device
    (default ``cuda:<local_rank()>``; raises without a card); ``backend``
    defaults to NCCL for a CUDA device and gloo for the CPU; ranks that
    share one card pass ``backend="gloo"``."""
    if os.environ.get(env_var, "").lower() not in ("1", "true"):
        return False
    if os.environ.get("DEBLUR4DGS_NUM_PROCESSES"):
        world = int(os.environ["DEBLUR4DGS_NUM_PROCESSES"])
        rank = int(os.environ["DEBLUR4DGS_PROCESS_ID"])
    else:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    addr = os.environ.get("DEBLUR4DGS_COORDINATOR_ADDRESS") or (
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)
    return True


def rank_device(device=None) -> torch.device:
    """``device``, or this process's card ``cuda:<local_rank()>``."""
    return resolve_device(f"cuda:{local_rank()}" if device is None
                          else device)


def make_mesh(n_devices: int | None = None, axis: str = "sub",
              device=None) -> Mesh | None:
    """A mesh over the first ``n_devices`` ranks (all by default) of the
    default process group, or of this process alone when no group is up.
    Every rank calls it (``dist.new_group`` is collective); a rank outside
    the first ``n_devices`` gets None."""
    dev = rank_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"{n_devices} devices asked for, but no process "
                             "group is initialized")
        return Mesh(None, 0, 1, axis, dev, local=True)
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return Mesh(None, dist.get_rank(), world, axis, dev)
    if not 1 <= n_devices <= world:
        raise ValueError(f"{n_devices} devices asked for of {world}")
    group = dist.new_group(ranks=list(range(n_devices)))
    if dist.get_rank() >= n_devices:
        return None
    return Mesh(group, dist.get_rank(group), n_devices, axis, dev)


def global_mesh(axis: str = "sub", device=None) -> Mesh:
    """Mesh over every rank of the default group (all hosts after
    maybe_init_distributed)."""
    return make_mesh(None, axis, device)


# ---------------------------------------------------------------------------
# Collectives with stated adjoints
# ---------------------------------------------------------------------------


def _all_reduce(mesh: Mesh, x: torch.Tensor, op=dist.ReduceOp.SUM):
    """In place; x must be contiguous."""
    if not mesh.local:
        dist.all_reduce(x, op=op, group=mesh.group)
    return x


def _flat(ts):
    return torch.cat([t.reshape(-1) for t in ts])


def _unflat(flat, like):
    out, off = [], 0
    for t in like:
        out.append(flat[off : off + t.numel()].view_as(t))
        off += t.numel()
    return out


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        flat = _all_reduce(ctx.mesh, _flat(gs))
        return (None, *_unflat(flat, gs))


def enter(mesh: Mesh, *xs: torch.Tensor):
    """Replicated tensors entering this rank's share of the work: the same
    tensors forward; backward, the cotangents summed over the ranks (one
    all-reduce for all of them). Returns a tuple like ``xs``."""
    return _Enter.apply(mesh, *xs)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        flat = _all_reduce(mesh, _flat(xs))
        return tuple(_unflat(flat, xs))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        return (None, *gs)


def reduce_sum(mesh: Mesh, *xs: torch.Tensor):
    """The sum over the ranks of each of ``xs`` (one all-reduce); backward,
    the cotangent itself. Returns a tuple like ``xs``."""
    return _ReduceSum.apply(mesh, *xs)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, counts, *xs):
        ctx.mesh, ctx.counts = mesh, counts
        if mesh.local:
            return tuple(x.clone() for x in xs)
        m = max(counts)
        rows = [x.reshape(x.shape[0], x[0].numel() if x.shape[0] else
                          x.shape[1:].numel()) for x in xs]
        local = torch.cat(rows, 1)
        local = torch.cat([local, local.new_zeros(
            (m - local.shape[0], local.shape[1]))])
        dev = local.device
        if mesh.staged:
            local = local.cpu()
        parts = [torch.empty_like(local) for _ in range(mesh.size)]
        dist.all_gather(parts, local, group=mesh.group)
        full = torch.cat([p[:c] for p, c in zip(parts, counts)]).to(dev)
        out, off = [], 0
        for x, r in zip(xs, rows):
            w = r.shape[1]
            out.append(full[:, off : off + w].reshape(
                (full.shape[0],) + tuple(x.shape[1:])))
            off += w
        return tuple(o.contiguous() for o in out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        mesh, counts = ctx.mesh, ctx.counts
        a = sum(counts[: mesh.rank])
        return (None, None, *(g[a : a + counts[mesh.rank]] for g in gs))


def gather(mesh: Mesh, *xs: torch.Tensor, counts=None):
    """Every rank's block of each of ``xs`` along dim 0, concatenated in
    rank order (one all-gather); ``counts`` are the blocks' sizes (equal
    blocks when None). Backward: this rank's block of the cotangent.
    Returns a tuple like ``xs``."""
    if counts is None:
        counts = [xs[0].shape[0]] * mesh.size
    if xs[0].shape[0] != counts[mesh.rank]:
        raise ValueError(f"rank {mesh.rank} holds {xs[0].shape[0]} rows, "
                         f"counts say {counts[mesh.rank]}")
    return _Gather.apply(mesh, list(counts), *xs)


class _ReduceChooser(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, is_max, x):
        fill = -float("inf") if is_max else float("inf")
        if x.shape[0]:
            local = x.amax(0) if is_max else x.amin(0)
        else:
            local = x.new_full(x.shape[1:], fill)
        op = dist.ReduceOp.MAX if is_max else dist.ReduceOp.MIN
        y = _all_reduce(mesh, local.contiguous(), op)
        ctx.mesh = mesh
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        hit = (x == y[None]).to(g.dtype)
        n = _all_reduce(ctx.mesh, hit.sum(0).contiguous())
        return None, None, hit * (g / n)[None]


def reduce_max(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Max over dim 0 of every rank's stack ``x`` (S_local, ...), S_local
    may be 0; the cotangent splits evenly over the tied entries of all
    ranks."""
    return _ReduceChooser.apply(mesh, True, x)


def reduce_min(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Min over dim 0 of every rank's stack (see reduce_max)."""
    return _ReduceChooser.apply(mesh, False, x)
