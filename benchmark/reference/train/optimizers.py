"""Per-group Adam that follows the reference's optax transforms exactly.

PyTorch port of deblur4dgs_tpu/train/optimizers.py. Groups and schedules:
  * every Gaussian / motion-basis tensor: Adam at its SceneLRConfig rate;
    'scales' decays exponentially to 0.1x over max_steps
  * MoveModel pose nets ('move.pose'): Adam 5e-4, cosine to 1e-5 over
    24*500 steps; MoveModel time_params ('move.time'): Adam 1e-1, cosine to
    1e-5 over 24*200 steps. Both wrapped like optax.MultiSteps: the MEAN
    gradient over accum_every=25 calls (Welford running mean), a zero update
    on the other 24 calls, and the inner Adam state advanced only on the
    emitting call
  * the ``alive`` mask is a buffer, never updated (optax.set_to_zero).

Adam is optax.scale_by_adam + scale_by_learning_rate: b1=0.9, b2=0.999,
eps=1e-8 outside the square root, bias correction at the incremented
count, and the learning-rate schedule evaluated at the pre-increment
count. Parameters are updated in place as p + (-lr * u).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch

from reference.configs import OptimizerConfig, SceneLRConfig

B1, B2, EPS = 0.9, 0.999, 1e-8


def _exp_decay_schedule(lr_init: float, lr_final: float, max_steps: int):
    def sched(step: int, device) -> torch.Tensor:
        f32 = dict(dtype=torch.float32, device=device)
        t = torch.clamp(torch.tensor(step, **f32) / max_steps, 0.0, 1.0)
        return torch.exp(
            torch.log(torch.tensor(lr_init, **f32)) * (1 - t)
            + torch.log(torch.tensor(lr_final, **f32)) * t
        )

    return sched


def _cosine_schedule(lr_init: float, eta_min: float, T_max: int):
    def sched(step: int, device) -> torch.Tensor:
        c = torch.tensor(min(max(step, 0), T_max), dtype=torch.float32,
                         device=device)
        return eta_min + (lr_init - eta_min) * 0.5 * (
            1 + torch.cos(math.pi * c / T_max)
        )

    return sched


@dataclass
class GroupSpec:
    lr: float | Callable  # constant, or schedule(count, device) -> tensor
    accum_every: int | None = None  # MultiSteps k (None: step every call)


@dataclass
class GroupState:
    count: int = 0  # inner Adam / schedule count
    mu: dict = field(default_factory=dict)  # param name -> first moment
    nu: dict = field(default_factory=dict)  # param name -> second moment
    mini_step: int = 0  # MultiSteps counter
    gradient_step: int = 0  # MultiSteps emitted updates
    acc_grads: dict = field(default_factory=dict)  # running mean gradient


def param_label(name: str) -> str:
    """Optimizer group of a SceneModel parameter name."""
    if name.startswith(("fg.", "bg.")):
        return name
    if name.startswith("bases."):
        return "motion_bases." + name.split(".", 1)[1]
    if name == "move.time_params":
        return "move.time"
    if name.startswith(("move.trunk.", "move.head_start.", "move.head_end.")):
        return "move.pose"
    raise KeyError(f"no optimizer group for parameter {name!r}")


class SceneAdam:
    """Label-grouped Adam over a SceneModel's named parameters."""

    def __init__(self, groups: dict[str, GroupSpec]):
        self.groups = groups

    def init(self, scene) -> dict[str, GroupState]:
        state = {label: GroupState() for label in self.groups}
        for name, p in scene.named_parameters():
            gs = state[param_label(name)]
            gs.mu[name] = torch.zeros_like(p)
            gs.nu[name] = torch.zeros_like(p)
            if self.groups[param_label(name)].accum_every:
                gs.acc_grads[name] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state, scene):
        """Apply one update in place to ``scene``'s parameters; returns the
        new state (the per-group state objects are updated in place)."""
        params = dict(scene.named_parameters())
        by_label: dict[str, list[str]] = {}
        for name in params:
            by_label.setdefault(param_label(name), []).append(name)
        for label, names in by_label.items():
            spec, gs = self.groups[label], state[label]
            if spec.accum_every is None:
                adam_apply(spec, gs, {n: grads[n] for n in names}, params)
                continue
            n_acc = gs.mini_step
            for n in names:
                acc = gs.acc_grads[n]
                gs.acc_grads[n] = acc + (grads[n] - acc) / (n_acc + 1)
            if gs.mini_step == spec.accum_every - 1:
                adam_apply(spec, gs, gs.acc_grads, params)
                gs.gradient_step += 1
                gs.acc_grads = {n: torch.zeros_like(g)
                                for n, g in gs.acc_grads.items()}
            gs.mini_step = (gs.mini_step + 1) % spec.accum_every
        return state


def adam_apply(spec: GroupSpec, gs: GroupState, grads: dict, params: dict):
    """One optax-style Adam update of the tensors ``params`` (name ->
    tensor, updated in place) from ``grads``, advancing ``gs``'s moments and
    count; the learning rate is ``spec.lr`` at the pre-increment count.
    Call it under torch.no_grad() when the parameters require grad."""
    count_inc = gs.count + 1
    dev = next(iter(grads.values())).device
    f32 = dict(dtype=torch.float32, device=dev)
    bc1 = 1 - torch.tensor(B1, **f32) ** float(count_inc)
    bc2 = 1 - torch.tensor(B2, **f32) ** float(count_inc)
    step = (-spec.lr(gs.count, dev) if callable(spec.lr)
            else torch.tensor(-spec.lr, **f32))
    for n, g in grads.items():
        mu = (1 - B1) * g + B1 * gs.mu[n]
        nu = (1 - B2) * (g * g) + B2 * gs.nu[n]
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        params[n].copy_(params[n] + step * u)
        gs.mu[n], gs.nu[n] = mu, nu
    gs.count = count_inc


def make_optimizer(scene, lr_cfg: SceneLRConfig,
                   optim_cfg: OptimizerConfig) -> SceneAdam:
    groups = {}

    def gauss_groups(part_cfg, part):
        for fld, lr in vars(part_cfg).items():
            if fld == "scales":
                groups[f"{part}.{fld}"] = GroupSpec(
                    _exp_decay_schedule(lr, 0.1 * lr, optim_cfg.max_steps)
                )
            else:
                groups[f"{part}.{fld}"] = GroupSpec(lr)

    gauss_groups(lr_cfg.fg, "fg")
    if scene.bg is not None:
        gauss_groups(lr_cfg.bg, "bg")
    groups["motion_bases.rots"] = GroupSpec(lr_cfg.motion_bases.rots)
    groups["motion_bases.transls"] = GroupSpec(lr_cfg.motion_bases.transls)
    mv = lr_cfg.move
    groups["move.pose"] = GroupSpec(
        _cosine_schedule(mv.pose, mv.eta_min, mv.pose_T_max), mv.accum_every
    )
    groups["move.time"] = GroupSpec(
        _cosine_schedule(mv.time, mv.eta_min, mv.time_T_max), mv.accum_every
    )
    return SceneAdam(groups)


def gate_move_pose_grads(grads: dict[str, torch.Tensor], gate: float):
    """Zero MoveModel pose-net grads when gate == 0 (epoch <= 20 gating)."""
    return {
        n: (g * gate if param_label(n) == "move.pose" else g)
        for n, g in grads.items()
    }
