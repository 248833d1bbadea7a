"""EWA projection of 3D Gaussians to screen space.

PyTorch port of deblur4dgs_tpu/ops/projection.py (gsplat v1.1.1 packed=False
semantics): quats+scales -> 3D covariance -> camera frame -> perspective
Jacobian -> 2D conic, radii, depths.
  * low-pass dilation eps2d = 0.3 on the 2D covariance diagonal
  * Jacobian at tan-FOV-clamped (x/z, y/z)
  * radius = ceil(3 * sqrt(max eigenvalue of cov2d))
  * valid = near < z < far, det(cov2d) > 0, radius > 0, on-screen

Batched over leading dims: means/quats (..., G, 3|4) with scales (G, 3)
project a whole exposure window at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.ops import lie


class Projected(NamedTuple):
    """Screen-space Gaussians for one camera (optionally with leading
    sub-frame dims)."""

    means2d: torch.Tensor  # (..., G, 2) pixel coords
    conics: torch.Tensor  # (..., G, 3) upper-tri inverse 2D covariance
    depths: torch.Tensor  # (..., G) camera-space z
    radii: torch.Tensor  # (..., G) float screen radius (3 sigma), 0 if culled
    valid: torch.Tensor  # (..., G) bool


def _covar_cam_entries(quats, scales, R_cw):
    """Unique entries (c00, c01, c02, c11, c12, c22) of
    R_cw (R diag(s^2) R^T) R_cw^T, scalar-expanded (same expression order
    as the reference)."""
    w, x, y, z = (quats[..., i] for i in range(4))
    r = (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (w * y + x * z),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (w * x + y * z), 1 - 2 * (x * x + y * y),
    )
    s2 = (scales[..., 0] ** 2, scales[..., 1] ** 2, scales[..., 2] ** 2)
    A = [
        sum(R_cw[i, m] * r[m * 3 + k] for m in range(3)) for i in range(3)
        for k in range(3)
    ]

    def cc(i, j):
        return sum(s2[k] * A[i * 3 + k] * A[j * 3 + k] for k in range(3))

    return cc(0, 0), cc(0, 1), cc(0, 2), cc(1, 1), cc(1, 2), cc(2, 2)


def project(
    means: torch.Tensor,  # (..., G, 3) world
    quats: torch.Tensor,  # (..., G, 4) wxyz
    scales: torch.Tensor,  # (G, 3) linear (already exp-activated)
    viewmat: torch.Tensor,  # (4, 4) world->camera
    K: torch.Tensor,  # (3, 3) intrinsics
    img_wh: tuple[int, int],
    eps2d: float = 0.3,
    near: float = 0.01,
    far: float = 1e10,
    aux_mask: torch.Tensor | None = None,  # (G,) bool: False => culled
) -> Projected:
    W, H = img_wh
    quats = lie.quat_normalize(quats)
    R_cw = viewmat[:3, :3]
    t_cw = viewmat[:3, 3]
    p_c = means @ R_cw.T + t_cw
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    c00, c01, c02, c11, c12, c22 = _covar_cam_entries(quats, scales, R_cw)

    # Perspective Jacobian at the FOV-clamped point (1.3 * tan(fov/2)).
    lim_x = 1.3 * (0.5 * W / fx)
    lim_y = 1.3 * (0.5 * H / fy)
    tx = zs * torch.clamp(x / zs, min=-lim_x, max=lim_x)
    ty = zs * torch.clamp(y / zs, min=-lim_y, max=lim_y)

    rz = 1.0 / zs
    rz2 = rz * rz
    jx = fx * rz
    jy = fy * rz
    jxz = -fx * tx * rz2
    jyz = -fy * ty * rz2
    a = jx * (jx * c00 + jxz * c02) + jxz * (jx * c02 + jxz * c22)
    b = jx * (jy * c01 + jyz * c02) + jxz * (jy * c12 + jyz * c22)
    c = jy * (jy * c11 + jyz * c12) + jyz * (jy * c12 + jyz * c22)

    a = a + eps2d
    c = c + eps2d
    det = a * c - b * b
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    v1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(v1, min=0.0)))

    mean_x = fx * x * rz + cx
    mean_y = fy * y * rz + cy
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    inside = (
        (mean_x + radius > 0)
        & (mean_x - radius < W)
        & (mean_y + radius > 0)
        & (mean_y - radius < H)
    )
    valid = (z > near) & (z < far) & (det > 0) & (radius > 0) & inside
    if aux_mask is not None:
        valid = valid & aux_mask
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(means2d, conic, z, radius, valid)
