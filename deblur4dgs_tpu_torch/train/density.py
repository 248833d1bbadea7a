"""Adaptive density control on fixed-capacity Gaussian buffers.

PyTorch port of deblur4dgs_tpu/train/density.py (the reference's
densify / cull / reset-opacity and optimizer-state surgery,
trainer.py:926-1252). Every Gaussian group keeps its capacity C and a float
alive mask:

  * densify writes dup/split children into dead slots (split kills the
    original, whose slot is immediately reusable);
  * cull clears alive bits;
  * the Adam moments of (re)allocated slots are zeroed in the per-group
    optimizer state (dict[label, GroupState], labels ``fg.means`` ...);
  * when capacity runs out, the lowest-priority candidates are dropped and
    counted.

The port updates in place under no_grad: parameter values, the ``alive``
buffers and the moments change, the Parameter objects stay the same. Stats
are zeroed after every control event (trainer.py:949-951).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from deblur4dgs_tpu_torch.configs import OptimizerConfig
from deblur4dgs_tpu_torch.models.gaussians import Gaussians

_FIELDS = ("means", "quats", "scales", "colors", "opacities", "motion_coefs")


class ControlReport(NamedTuple):
    num_split: torch.Tensor
    num_dup: torch.Tensor
    num_dropped: torch.Tensor  # candidates lost to capacity exhaustion
    num_culled: torch.Tensor
    new_slot_mask: torch.Tensor  # (C,) float 1.0 where a slot was (re)allocated


def _set_alive(g: Gaussians, alive: torch.Tensor):
    if g.alive is None:
        g.alive = alive
    else:
        g.alive.copy_(alive)


@torch.no_grad()
def densify_group(
    g: Gaussians,
    grad_avg: torch.Tensor,  # (C,)
    max_radii: torch.Tensor,  # (C,) normalized by max(W, H)
    cfg: OptimizerConfig,
    use_screen: bool,
) -> tuple[Gaussians, ControlReport]:
    """Split/dup control for one group (trainer.py:992-1047), in place."""
    C = g.capacity
    alive = g.get_alive()
    scales = torch.exp(g.scales).amax(dim=-1)

    too_high = (grad_avg > cfg.densify_xys_grad_threshold) & alive
    scale_big = scales > cfg.densify_scale_threshold
    radius_big = ((max_radii > cfg.densify_screen_threshold) if use_screen
                  else torch.zeros_like(too_high))
    should_split = too_high & (scale_big | radius_big)
    should_dup = too_high & ~scale_big

    # Free slots (dead after killing split originals), dead-first order.
    alive_after_kill = alive & ~should_split
    free = torch.argsort(alive_after_kill.to(torch.int32), stable=True)
    n_free = torch.sum(~alive_after_kill)
    n_dup = torch.sum(should_dup)
    n_split = torch.sum(should_split)
    dup_rank = torch.cumsum(should_dup, 0) - 1
    split_rank = torch.cumsum(should_split, 0) - 1

    def targets(mask, rank, offset):
        """(target slot per candidate, ok); a target exists only where ok
        (the reference's target C with mode='drop' has no counterpart)."""
        r = rank + offset
        ok = mask & (r < n_free)
        return free[torch.clamp(r, 0, C - 1)], ok

    tgt_dup, ok_dup = targets(should_dup, dup_rank, 0)
    tgt_a, ok_a = targets(should_split, split_rank, n_dup)
    tgt_b, ok_b = targets(should_split, split_rank + n_split, n_dup)

    shrink = math.log(1.6)  # params.py:94

    def write(x, adjust_scales=False):
        if x is None:
            return
        new = x.detach().clone()
        new[tgt_dup[ok_dup]] = x[ok_dup]
        # the split children read x after the dup write (density.py:94-101)
        src = new - shrink if adjust_scales else new.clone()
        new[tgt_a[ok_a]] = src[ok_a]
        new[tgt_b[ok_b]] = src[ok_b]
        x.copy_(new)

    for f in _FIELDS:
        write(getattr(g, f), adjust_scales=f == "scales")

    kept = alive_after_kill.to(torch.float32)
    new_alive = kept.clone()
    for tgt, ok in ((tgt_dup, ok_dup), (tgt_a, ok_a), (tgt_b, ok_b)):
        new_alive[tgt[ok]] = 1.0
    new_slots = new_alive * (1.0 - kept)
    _set_alive(g, new_alive)
    dropped = (torch.sum(should_dup & ~ok_dup)
               + torch.sum(should_split & ~ok_a)
               + torch.sum(should_split & ~ok_b))
    report = ControlReport(
        num_split=n_split, num_dup=n_dup, num_dropped=dropped,
        num_culled=torch.zeros((), dtype=torch.int64, device=n_dup.device),
        new_slot_mask=new_slots,
    )
    return g, report


@torch.no_grad()
def cull_group(
    g: Gaussians,
    max_radii: torch.Tensor,
    cfg: OptimizerConfig,
    scene_scale: float,
    use_scale: bool,
    use_screen: bool,
) -> tuple[Gaussians, torch.Tensor]:
    """Opacity/scale/radius culling (trainer.py:1088-1136), in place."""
    alive = g.get_alive()
    cull = torch.sigmoid(g.opacities) < cfg.cull_opacity_threshold
    if use_scale:
        scales = torch.exp(g.scales).amax(dim=-1)
        cull = cull | (scales > cfg.cull_scale_threshold * scene_scale)
    if use_screen:
        cull = cull | (max_radii > cfg.cull_screen_threshold)
    cull = cull & alive
    _set_alive(g, (alive & ~cull).to(torch.float32))
    return g, torch.sum(cull)


@torch.no_grad()
def reset_opacities_group(g: Gaussians, cfg: OptimizerConfig) -> Gaussians:
    """Reset alive opacities to at most logit(0.8 * cull_thr)
    (trainer.py:1146-1166), in place."""
    target = math.log(0.8 * cfg.cull_opacity_threshold) - math.log(
        1 - 0.8 * cfg.cull_opacity_threshold
    )
    op = g.opacities
    capped = torch.minimum(op, torch.tensor(target, dtype=op.dtype,
                                            device=op.device))
    op.copy_(torch.where(g.get_alive(), capped, op))
    return g


# ---------------------------------------------------------------------------
# Optimizer-state surgery (trainer.py:1199-1252 analog)
# ---------------------------------------------------------------------------


def reset_moments_at_slots(opt_state, part: str, slot_mask: torch.Tensor):
    """Zero the Adam moment rows (and any accumulated-gradient rows) at
    (re)allocated slots of a Gaussian part ('fg' or 'bg'); slot_mask (C,)
    float 1.0 at new slots. The moments are multiplied by 1 - mask, as the
    reference does."""
    keep = 1.0 - slot_mask
    for label, gs in opt_state.items():
        if not label.startswith(part + "."):
            continue
        for moments in (gs.mu, gs.nu, gs.acc_grads):
            for n, x in moments.items():
                if x.ndim >= 1 and x.shape[0] == keep.shape[0]:
                    moments[n] = x * keep.reshape((-1,) + (1,) * (x.ndim - 1))
    return opt_state


def reset_moments_full(opt_state, label: str):
    """Zero every moment of one group (reset_in_optim analog); its count
    stays."""
    gs = opt_state[label]
    for moments in (gs.mu, gs.nu, gs.acc_grads):
        for n, x in moments.items():
            moments[n] = torch.zeros_like(x)
    return opt_state


@torch.no_grad()
def apply_density_control(
    state,
    cfg: OptimizerConfig,
    *,
    num_frames: int,
    only_fg: bool,
    do_densify: bool,
    do_cull: bool,
    do_reset: bool,
    use_screen: bool,
    bg_scene_scale: float = 1.0,
    cull_use_scale: bool = False,
):
    """One control event on a TrainState (run_control_steps analog,
    trainer.py:926-951): the scene and optimizer state change in place,
    the stats are zeroed. Returns the state."""
    scene, stats = state.scene, state.stats
    n_fg = scene.num_fg
    grad_avg = stats.grad_norm_acc / torch.clamp(stats.vis_count, min=1)
    parts = [("fg", scene.fg, slice(0, n_fg))]
    if scene.bg is not None and not only_fg:
        parts.append(("bg", scene.bg, slice(n_fg, None)))

    for name, g, sl in parts:
        if do_densify:
            _, rep = densify_group(g, grad_avg[sl], stats.max_radii[sl], cfg,
                                   use_screen)
            reset_moments_at_slots(state.opt_state, name, rep.new_slot_mask)
        if do_cull:
            scale = bg_scene_scale if name == "bg" else 1.0
            cull_group(g, stats.max_radii[sl], cfg, scale, cull_use_scale,
                       use_screen)
        if do_reset:
            reset_opacities_group(g, cfg)
            reset_moments_full(state.opt_state, f"{name}.opacities")

    state.stats = type(stats)(*(torch.zeros_like(x) for x in stats))
    return state


def control_flags(cfg: OptimizerConfig, step: int, num_frames: int) -> dict:
    """Cadence logic of run_control_steps (trainer.py:933-947)."""
    reset_every = cfg.reset_opacity_every_n_controls * cfg.control_every
    if not (
        step > cfg.warmup_steps
        and step % cfg.control_every == 0
        and step < cfg.stop_control_steps
    ):
        return {}
    return {
        "do_densify": (
            step < cfg.stop_densify_steps
            and step % reset_every > num_frames
        ),
        "do_cull": step % reset_every > min(3 * num_frames, 1000),
        "do_reset": step % reset_every == 0,
        "use_screen": step < cfg.stop_control_by_screen_steps,
        "cull_use_scale": step > reset_every,
    }
