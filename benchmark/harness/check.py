"""What decides ``correct``: the program's first steps against the
reference's on the same inputs.

Both sides start from the same generated state and train on the same
rows (the schedule's first ``checked_steps`` pairs, which all differ).
Three numbers are compared, each against the limit in the cell's file:

* ``loss``: the largest relative gap between the two sides' losses over
  the checked steps;
* ``grad``: the first gradient as the optimizer got it, by the worst
  leaf: |norm(program) - norm(reference)| over the larger of the
  reference's norm of that leaf and of the median leaf, the median taken
  over the leaves that have a gradient (the pose nets' layers behind
  their zero-initialized heads get exactly none);
* ``change``: the parameters' change after the checked steps, by the
  worst leaf, in the same measure. Leaves whose reference gradient is
  under ``ROUNDOFF`` of the median leaf's move by round-off alone and are
  left out; a leaf that the reference leaves unmoved (the groups that
  accumulate 25 steps) must be unmoved in the program too.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

import torch

from harness import sides

ROUNDOFF = 1e-3
NUMBERS = ("loss", "grad", "change")


@dataclass
class Readings:
    loss: list  # per checked step
    grad: dict  # leaf -> norm of the first gradient
    change: dict  # leaf -> norm of the change after the checked steps


def _norm(t):
    return float(torch.linalg.vector_norm(t.detach().double()))


def checked_steps(side, inputs, n):
    """Drive the side's first n steps of the schedule; its readings."""
    p0 = {k: p.detach().clone() for k, p in side.scene.named_parameters()}
    losses, grad = [], None
    for k in range(n):
        losses.append(sides.drive(side, inputs, k))
        if k == 0:
            grad = {k_: _norm(g) for k_, g in sides.first_gradient(side).items()}
    change = {k: _norm(p - p0[k]) for k, p in side.scene.named_parameters()}
    return Readings([float(x) for x in losses], grad, change)


def _worst(prog, ref, names, floor):
    gaps = {}
    for n in names:
        if ref[n] == 0.0:
            gaps[n] = 0.0 if prog[n] == 0.0 else float("inf")
        else:
            gaps[n] = abs(prog[n] - ref[n]) / max(ref[n], floor)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def compare(prog: Readings, ref: Readings):
    """{number: (value, detail)} of the program's readings against the
    reference's."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog.loss, ref.loss))
    if any(x != x for x in prog.loss):  # NaN
        loss = float("inf")
    names = list(ref.grad)
    med_g = statistics.median([g for g in ref.grad.values() if g > 0.0]
                              or [0.0])
    grad, g_leaf = _worst(prog.grad, ref.grad, names, med_g)
    kept = [n for n in names if ref.grad[n] >= ROUNDOFF * med_g]
    moved = [ref.change[n] for n in kept if ref.change[n] > 0.0]
    med_c = statistics.median(moved) if moved else 0.0
    change, c_leaf = _worst(prog.change, ref.change, kept, med_c)
    return {"loss": (loss, "max over steps"), "grad": (grad, g_leaf),
            "change": (change, c_leaf)}


def verdict(numbers, limits):
    """(correct, [(name, value, limit, detail)])."""
    rows = [(k, numbers[k][0], limits[k], numbers[k][1]) for k in NUMBERS]
    return all(v <= lim for _, v, lim, _ in rows), rows
