"""SE(3) motion bases: per-frame basis trajectories blended per Gaussian.

PyTorch port of deblur4dgs_tpu/models/motion_bases.py. A Gaussian's
transform at (possibly fractional) time t is the softmax-coefficient blend
of the bases, lerped between floor(t) and ceil(t) in (6D-rot, transl)
space, then orthonormalized (blend-then-orthonormalize).
"""

from __future__ import annotations

import torch
from torch import nn

from reference.ops import lie


class MotionBases(nn.Module):
    def __init__(self, rots, transls):
        super().__init__()
        self.rots = nn.Parameter(rots)  # (K, T, 6) 6D-continuous rotations
        self.transls = nn.Parameter(transls)  # (K, T, 3)

    @property
    def num_bases(self) -> int:
        return self.rots.shape[0]

    @property
    def num_frames(self) -> int:
        return self.rots.shape[1]


def compute_transforms(
    bases: MotionBases,
    ts: torch.Tensor,  # (B,) or (G, B) possibly-fractional frame times
    coefs: torch.Tensor,  # (G, K) softmax blend weights
) -> torch.Tensor:
    """Blended SE(3) transforms, (G, B, 3, 4).

    For per-Gaussian times (G, B) the gather uses row 0's floor/ceil and
    per-row lerp weights, as the reference does.
    """
    T = bases.num_frames
    if ts.ndim == 1:
        ts = ts[None, :]  # (1, B)
    ts_pre = torch.clamp(torch.floor(ts), 0, T - 1).long()
    ts_next = torch.clamp(torch.ceil(ts), 0, T - 1).long()

    transls_pre = torch.einsum("gk,kbi->gbi", coefs, bases.transls[:, ts_pre[0]])
    rots_pre = torch.einsum("gk,kbi->gbi", coefs, bases.rots[:, ts_pre[0]])
    transls_next = torch.einsum("gk,kbi->gbi", coefs, bases.transls[:, ts_next[0]])
    rots_next = torch.einsum("gk,kbi->gbi", coefs, bases.rots[:, ts_next[0]])

    w = (ts - ts_pre.to(ts.dtype))[..., None]  # (1 or G, B, 1)
    transls = (1.0 - w) * transls_pre + w * transls_next
    rots = (1.0 - w) * rots_pre + w * rots_next
    rotmats = lie.cont_6d_to_rmat(rots)  # (G, B, 3, 3)
    return torch.cat([rotmats, transls[..., None]], dim=-1)


def transform_gaussians(
    transfms: torch.Tensor,  # (G, B, 3, 4)
    means: torch.Tensor,  # (G, 3) canonical
    quats: torch.Tensor,  # (G, 4) canonical unit wxyz
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply blended transforms: -> (means (G, B, 3), quats (G, B, 4))."""
    means_h = torch.cat([means, torch.ones_like(means[:, :1])], dim=-1)
    new_means = torch.einsum("gbij,gj->gbi", transfms, means_h)
    q_rot = lie.rmat_to_quat(transfms[..., :3, :3])  # (G, B, 4)
    new_quats = lie.quat_mul(q_rot, quats[:, None, :])
    return new_means, lie.quat_normalize(new_quats)
