"""Checkpoint save / restore and the stage handoff.

PyTorch port of deblur4dgs_tpu/train/checkpoints.py (the reference's
trainer.py:126-178). The whole TrainState goes into one ``torch.save``
file (the JAX package saves the same pytree with orbax): the scene's
parameters and buffers, every optimizer group's state (count, mu, nu,
mini_step, gradient_step, acc_grads), the DensityStats, the step and the
epoch. Loading copies into a template of the same capacities, so a resumed
run continues step for step.
"""

from __future__ import annotations

import os

import torch

from deblur4dgs_tpu_torch import resolve_device
from deblur4dgs_tpu_torch.configs import OptimizerConfig, SceneLRConfig
from deblur4dgs_tpu_torch.models.gaussians import Gaussians
from deblur4dgs_tpu_torch.models.motion_bases import MotionBases
from deblur4dgs_tpu_torch.models.move_model import MoveModel, init_move_model
from deblur4dgs_tpu_torch.models.scene import SceneModel
from deblur4dgs_tpu_torch.train.trainer import (
    DensityStats,
    TrainState,
    init_train_state,
)

_GROUP_DICTS = ("mu", "nu", "acc_grads")
_GROUP_INTS = ("count", "mini_step", "gradient_step")


def _state_dict(state: TrainState, epoch: int) -> dict:
    opt = {
        label: {**{k: getattr(gs, k) for k in _GROUP_INTS},
                **{k: dict(getattr(gs, k)) for k in _GROUP_DICTS}}
        for label, gs in state.opt_state.items()
    }
    return {
        "scene": {k: v.detach() for k, v in state.scene.state_dict().items()},
        "opt": opt,
        "stats": state.stats._asdict(),
        "step": int(state.step),
        "epoch": int(epoch),
    }


def save_checkpoint(path: str, state: TrainState, epoch: int = 0):
    """Write the TrainState and the epoch to ``path`` (one file, replaced
    atomically)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_state_dict(state, epoch), tmp)
    os.replace(tmp, path)


def _copy_checked(dst: torch.Tensor, src: torch.Tensor, name: str):
    if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
        raise ValueError(f"checkpoint {name}: {tuple(src.shape)} {src.dtype}"
                         f" does not fit the template's {tuple(dst.shape)} "
                         f"{dst.dtype}")
    dst.copy_(src)


@torch.no_grad()
def load_checkpoint(path: str, template: TrainState) -> tuple[TrainState, int]:
    """Restore into ``template`` (capacities must match; its tensors are
    overwritten in place and it is returned) and the saved epoch."""
    dev = template.scene.fg.means.device
    ckpt = torch.load(os.path.abspath(path), map_location=dev,
                      weights_only=True)
    own = template.scene.state_dict()
    if set(own) != set(ckpt["scene"]):
        raise ValueError(f"checkpoint scene keys {sorted(ckpt['scene'])} "
                         f"differ from the template's {sorted(own)}")
    for k, v in ckpt["scene"].items():
        _copy_checked(own[k], v, k)
    if set(template.opt_state) != set(ckpt["opt"]):
        raise ValueError("checkpoint optimizer groups differ from the "
                         "template's")
    for label, saved in ckpt["opt"].items():
        gs = template.opt_state[label]
        for k in _GROUP_INTS:
            setattr(gs, k, int(saved[k]))
        for k in _GROUP_DICTS:
            mine = getattr(gs, k)
            if set(mine) != set(saved[k]):
                raise ValueError(f"checkpoint {label}.{k} tensors differ")
            for n, x in saved[k].items():
                _copy_checked(mine[n], x, f"{label}.{k}.{n}")
    stats = DensityStats(**ckpt["stats"])
    for name, a, b in zip(DensityStats._fields, template.stats, stats):
        _copy_checked(a, b, f"stats.{name}")
    template.step = int(ckpt["step"])
    return template, int(ckpt["epoch"])


def template_state(
    num_fg: int,
    num_bg: int,
    num_bases: int,
    num_frames: int,
    device="cuda",
    num_move_frames: int | None = None,
) -> TrainState:
    """Zero-filled TrainState with the given capacities (the shape
    load_checkpoint restores into), built from the run's dimensions.
    num_move_frames (default num_frames) sizes the MoveModel's per-frame
    exposure times: a phase-B window keeps stage 1's MoveModel, whose
    times cover the whole clip, beside bases of the window's frames (the
    JAX package's template has no such argument and cannot load a window
    checkpoint)."""
    dev = resolve_device(device)

    def gauss(n, coefs):
        quats = torch.zeros((n, 4), device=dev)
        quats[:, 0] = 1.0
        return Gaussians(
            means=torch.zeros((n, 3), device=dev), quats=quats,
            scales=torch.zeros((n, 3), device=dev),
            colors=torch.zeros((n, 3), device=dev),
            opacities=torch.zeros((n,), device=dev),
            motion_coefs=(torch.zeros((n, num_bases), device=dev) if coefs
                          else None),
            alive=torch.ones((n,), device=dev),
        )

    scene = SceneModel(
        fg=gauss(num_fg, True),
        bg=gauss(num_bg, False) if num_bg else None,
        bases=MotionBases(torch.zeros((num_bases, num_frames, 6), device=dev),
                          torch.zeros((num_bases, num_frames, 3), device=dev)),
        move=init_move_model(torch.Generator().manual_seed(0),
                             num_move_frames or num_frames, device=dev),
    )
    return init_train_state(scene, SceneLRConfig(), OptimizerConfig())


def lift_static_stage(scene: SceneModel, static_scene: SceneModel) -> SceneModel:
    """Stage handoff: the stage-1 bg Gaussians and MoveModel weights with
    the fresh fg / bases (run_training_dynamic.py:588-599); time_params are
    re-initialized if the frame count changed (trainer.py:156-158). The
    new scene shares the modules it takes."""
    move = static_scene.move
    if move.time_params.shape != scene.move.time_params.shape:
        move = MoveModel(move.trunk, move.head_start, move.head_end,
                         scene.move.time_params.detach().clone())
    return SceneModel(fg=scene.fg, bg=static_scene.bg, bases=scene.bases,
                      move=move)
