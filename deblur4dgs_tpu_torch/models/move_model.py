"""Exposure model: learned camera motion + exposure time within each frame.

PyTorch port of deblur4dgs_tpu/models/move_model.py. An MLP on the
se(3)-embedded frame pose predicts two se(3) deltas (zero-initialized heads
=> identity at init) bounding the residual camera trajectory across the
exposure window; a learnable per-frame deltaT (clamped to [0.1, 0.9])
gives the window's half-width in time. Residual poses warp Gaussian means
in world space before the static viewmat.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from deblur4dgs_tpu_torch import resolve_device
from deblur4dgs_tpu_torch.ops import lie
from deblur4dgs_tpu_torch.utils.mlp import init_mlp, mlp, posenc

NUM_FREQS = 5  # posenc over the 6-dim se(3) vector -> 6 * (1 + 2*5) = 66
WIDTH = 64


class MoveModel(nn.Module):
    def __init__(self, trunk: nn.ModuleList, head_start: nn.ModuleList,
                 head_end: nn.ModuleList, time_params: torch.Tensor):
        super().__init__()
        self.trunk = trunk  # 5 linear layers 66 -> 64 -> ... -> 64
        self.head_start = head_start  # 64 -> 64 -> 6, last layer zero-init
        self.head_end = head_end  # 64 -> 64 -> 6, last layer zero-init
        self.time_params = nn.Parameter(time_params)  # (T,) raw deltaT


class ExposureSamples(NamedTuple):
    poses: torch.Tensor  # (N, 3, 4) residual world-space poses
    times: torch.Tensor  # (N,) fractional frame times
    delta_t: torch.Tensor  # () learned exposure half-width for this frame


def init_move_model(generator: torch.Generator, num_frames: int,
                    device="cuda") -> MoveModel:
    device = resolve_device(device)
    in_dim = 6 * (1 + 2 * NUM_FREQS)
    return MoveModel(
        trunk=init_mlp(generator, [in_dim, WIDTH, WIDTH, WIDTH, WIDTH, WIDTH],
                       device=device),
        head_start=init_mlp(generator, [WIDTH, WIDTH, 6], zero_last=True,
                            device=device),
        head_end=init_mlp(generator, [WIDTH, WIDTH, 6], zero_last=True,
                          device=device),
        time_params=torch.full((num_frames,), 0.5, dtype=torch.float32,
                               device=device),
    )


def predict_deltas(model: MoveModel, w2c: torch.Tensor):
    """w2c (4, 4) -> (delta_start (6,), delta_end (6,)) se(3) residuals."""
    se3 = lie.se3_log(w2c[:3, :])
    x = posenc(se3, NUM_FREQS)
    h = mlp(model.trunk, x)  # trunk ends in a plain Linear
    return mlp(model.head_start, h), mlp(model.head_end, h)


def frame_delta_t(model: MoveModel, t, stage: str) -> torch.Tensor:
    """Learned exposure half-width for frame index t; boundary frames
    (t <= 0 or t >= T-1) and the camera-only first stage get 0."""
    dev = model.time_params.device
    if stage == "first":
        return torch.zeros((), dtype=torch.float32, device=dev)
    T = model.time_params.shape[0]
    t = torch.as_tensor(t, device=dev)
    ti = torch.clamp(t.to(torch.int32), 0, T - 1).long()
    # jnp.clip semantics: at a bound the gradient is split like
    # jnp.maximum / jnp.minimum (torch.clamp would pass all of it)
    dt = torch.minimum(
        torch.maximum(torch.relu(model.time_params[ti]),
                      torch.tensor(0.1, device=dev)),
        torch.tensor(0.9, device=dev),
    )
    boundary = (t <= 0) | (t >= T - 1)
    return torch.where(boundary, torch.zeros_like(dt), dt)


def exposure_samples(
    model: MoveModel,
    w2c: torch.Tensor,  # (4, 4)
    t,  # scalar frame index
    num_cameras: int,
    stage: str = "second",
    mode: str = "uniform",
    camera_mode: str = "linear",
) -> ExposureSamples:
    """Sample the exposure window: N residual poses + times.

    mode 'uniform' returns all N samples; 'mid' / 'start' / 'end' slice one.

    camera_mode selects the within-window pose interpolation
    (move_model.py:168-204): 'linear' (reference default) or 'cubic'. The
    reference's cubic branch cannot actually run — it feeds its TWO control
    poses into the four-basis-row cubic_bspline_interpolation
    (spline_utils.py:442-449), a shape mismatch — so we define 'cubic' as
    the SE(3) B-spline over duplicated knots [start, start, end, end]: a
    smooth ease between the endpoint poses (see PARITY.md).

    Caveats of the duplicated-knot spline: it evaluates to (5*p0+p1)/6 at
    u=0 and (p0+5*p1)/6 at u=1, so 'cubic' spans only the middle ~2/3 of
    the predicted exposure motion (reduced effective blur extent vs
    'linear'). Its exact-midpoint property — sample N//2 sitting at the
    true SE(3) midpoint of (p0, p1), which mode='mid' slicing relies on —
    holds only for ODD num_cameras; use odd num_exposure with
    camera_mode='cubic'.
    """
    d0, d1 = predict_deltas(model, w2c)
    p0 = lie.se3_exp(d0)
    p1 = lie.se3_exp(d1)
    u = torch.linspace(0.0, 1.0, num_cameras, device=w2c.device)
    if camera_mode == "cubic":
        knots = torch.stack([p0, p0, p1, p1], dim=0)  # (4, 3, 4)
        poses = lie.se3_cubic_bspline(knots, u)  # (N, 3, 4)
    else:
        poses = lie.se3_lerp(p0, p1, u)  # (N, 3, 4)

    dt = frame_delta_t(model, t, stage)
    tf = torch.as_tensor(t, dtype=torch.float32, device=w2c.device)
    times = (tf - dt) * (1.0 - u) + (tf + dt) * u  # (N,)

    if mode == "mid":
        sl = slice(num_cameras // 2, num_cameras // 2 + 1)
    elif mode == "start":
        sl = slice(0, 1)
    elif mode == "end":
        sl = slice(num_cameras - 1, num_cameras)
    else:
        sl = slice(None)
    return ExposureSamples(poses[sl], times[sl], dt)
