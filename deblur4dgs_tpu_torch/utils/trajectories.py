"""Novel-view camera path generators: average pose, ray-triangulated
lookat, arc / lemniscate / spiral / wander paths.

PyTorch port of deblur4dgs_tpu/utils/trajectories.py (the reference's
flow3d/trajectories.py). Each function computes on its inputs' device in
their dtype (float32); get_wander_w2cs, as in the reference, composes its
poses in float64 numpy and returns float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deblur4dgs_tpu_torch.ops import lie


def _normalize(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-8)


def get_avg_w2c(w2cs: torch.Tensor) -> torch.Tensor:
    """Average camera (trajectories.py:9-24)."""
    c2ws = torch.linalg.inv(w2cs)
    center = c2ws[:, :3, -1].mean(0)
    z = _normalize(c2ws[:, :3, 2].mean(0))
    y_ = c2ws[:, :3, 1].mean(0)
    x = _normalize(torch.linalg.cross(y_, z))
    y = torch.linalg.cross(z, x)
    avg_c2w = lie.rt_to_mat4(torch.stack([x, y, z], 1), center)
    return torch.linalg.inv(avg_c2w)


def get_lookat(origins: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """Least-squares triangulation of rays (trajectories.py:26-48)."""
    d = _normalize(viewdirs)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)[None]
    I_min_cov = eye - d[..., None] * d[..., None, :]
    sum_proj = (I_min_cov @ origins[..., None]).sum(dim=-3)
    A = I_min_cov.sum(dim=-3)
    return torch.linalg.lstsq(A, sum_proj).solution[..., 0]


def get_lookat_w2cs(positions, lookat, up):
    """(N, 3) positions looking at a point (trajectories.py:50-68)."""
    fwd = _normalize(lookat - positions)
    right = _normalize(torch.linalg.cross(fwd, up.expand(fwd.shape)))
    down = _normalize(torch.linalg.cross(fwd, right))
    Rs = torch.stack([right, down, fwd], dim=-1)
    return torch.linalg.inv(lie.rt_to_mat4(Rs, positions))


def _linspace(a, b, n, like):
    return torch.linspace(a, b, n, dtype=like.dtype, device=like.device)


def get_arc_w2cs(ref_w2c, lookat, up, num_frames, degree, **_):
    ref_pos = torch.linalg.inv(ref_w2c)[:3, 3]
    thetas = (torch.sin(_linspace(0.0, 2 * math.pi, num_frames + 1,
                                  ref_w2c)[:-1])
              * (degree / 2.0) / 180.0 * math.pi)
    R = lie.so3_exp(thetas[:, None] * up[None])
    # orbit about the lookat point (the reference omits the +lookat,
    # trajectories.py:89-93, which only works for lookat ~ origin)
    positions = torch.einsum("nij,j->ni", R, ref_pos - lookat) + lookat
    return get_lookat_w2cs(positions, lookat, up)


def _ref_frame_points(ref_c2w, pos_cam):
    """(N, 3) camera-frame points of ref_c2w into world space."""
    ones = torch.ones_like(pos_cam[:, :1])
    return torch.einsum("ij,nj->ni", ref_c2w[:3],
                        torch.cat([pos_cam, ones], -1))


def get_lemniscate_w2cs(ref_w2c, lookat, up, num_frames, degree, **_):
    ref_c2w = torch.linalg.inv(ref_w2c)
    a = torch.linalg.norm(ref_c2w[:3, 3] - lookat) * math.tan(
        degree / 360 * math.pi)
    thetas = _linspace(0, 2 * math.pi, num_frames + 1, ref_w2c)[:-1] \
        + math.pi / 2
    s, c = torch.sin(thetas), torch.cos(thetas)
    pos_cam = torch.stack(
        [a * c / (1 + s ** 2), a * c * s / (1 + s ** 2),
         torch.zeros_like(thetas)], -1)
    return get_lookat_w2cs(_ref_frame_points(ref_c2w, pos_cam), lookat, up)


def get_spiral_w2cs(ref_w2c, lookat, up, num_frames, rads, zrate, rots,
                    **_):
    ref_c2w = torch.linalg.inv(ref_w2c)
    thetas = _linspace(0, 2 * math.pi * rots, num_frames + 1, ref_w2c)[:-1]
    if torch.is_tensor(rads) or isinstance(rads, np.ndarray):
        rads = torch.as_tensor(rads, dtype=ref_w2c.dtype,
                               device=ref_w2c.device).reshape(-1, 3)
    pos_cam = torch.stack([torch.cos(thetas), -torch.sin(thetas),
                           -torch.sin(thetas * zrate)], -1) * rads
    return get_lookat_w2cs(_ref_frame_points(ref_c2w, pos_cam), lookat, up)


def get_wander_w2cs(ref_w2c, focal_length, num_frames, max_disp=48.0, **_):
    ref = torch.as_tensor(ref_w2c)
    c2w = np.linalg.inv(ref.detach().cpu().numpy())
    max_trans = max_disp / focal_length
    poses = []
    for i in range(num_frames):
        x_t = max_trans * np.sin(2 * np.pi * i / num_frames)
        z_t = max_trans * np.cos(2 * np.pi * i / num_frames) / 2.0
        i_pose = np.eye(4)
        i_pose[:3, 3] = [x_t, 0.0, z_t]
        poses.append(c2w @ np.linalg.inv(i_pose))
    poses = torch.as_tensor(np.stack(poses), dtype=torch.float32,
                            device=ref.device)
    return torch.linalg.inv(poses)
