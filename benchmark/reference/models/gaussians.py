"""Fixed-capacity Gaussian parameter sets.

PyTorch port of deblur4dgs_tpu/models/gaussians.py. The capacity N is fixed
and an ``alive`` mask (a float buffer, never optimized) marks live slots,
so parameters compare slot for slot with the JAX package.

Parameters are stored raw (pre-activation): means (N, 3); quats (N, 4)
unnormalized wxyz; scales (N, 3) log; colors (N, 3) logit RGB; opacities
(N,) logit; motion_coefs (N, K) pre-softmax (fg only).
"""

from __future__ import annotations

import torch
from torch import nn


class Gaussians(nn.Module):
    def __init__(self, means, quats, scales, colors, opacities,
                 motion_coefs=None, alive=None):
        super().__init__()
        self.means = nn.Parameter(means)
        self.quats = nn.Parameter(quats)
        self.scales = nn.Parameter(scales)
        self.colors = nn.Parameter(colors)
        self.opacities = nn.Parameter(opacities)
        self.motion_coefs = (
            None if motion_coefs is None else nn.Parameter(motion_coefs)
        )
        # float 1.0/0.0 mask; None => all alive
        self.register_buffer("alive", alive)

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def num_alive(self) -> torch.Tensor:
        """Number of live slots (an int tensor on the parameters' device)."""
        return self.get_alive().sum()

    def get_alive(self) -> torch.Tensor:
        """Bool aliveness mask."""
        if self.alive is None:
            return torch.ones((self.capacity,), dtype=torch.bool,
                              device=self.means.device)
        return self.alive > 0.5

    def get_quats(self) -> torch.Tensor:
        n = torch.linalg.norm(self.quats, dim=-1, keepdim=True)
        return self.quats / torch.clamp(n, min=1e-8)

    def get_scales(self) -> torch.Tensor:
        return torch.exp(self.scales)

    def get_colors(self) -> torch.Tensor:
        return torch.sigmoid(self.colors)

    def get_opacities(self) -> torch.Tensor:
        op = torch.sigmoid(self.opacities)
        if self.alive is not None:
            op = op * self.alive
        return op

    def get_coefs(self) -> torch.Tensor:
        assert self.motion_coefs is not None
        return torch.softmax(self.motion_coefs, dim=-1)


def pad_to_capacity(g: Gaussians, capacity: int) -> Gaussians:
    """A new Gaussians grown to ``capacity`` slots; the new slots are dead,
    zero-filled, with quats (1, 0, 0, 0) so they stay normalizable."""
    n = g.capacity
    if capacity < n:
        raise ValueError(f"capacity {capacity} below the {n} slots held")
    extra = capacity - n

    def pad(x):
        if x is None:
            return None
        x = x.detach()
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

    quats = pad(g.quats)
    quats[n:, 0] = 1.0
    alive = g.get_alive().to(torch.float32)
    return Gaussians(
        means=pad(g.means), quats=quats, scales=pad(g.scales),
        colors=pad(g.colors), opacities=pad(g.opacities),
        motion_coefs=pad(g.motion_coefs),
        alive=torch.cat([alive, alive.new_zeros((extra,))]),
    )


def concat_gaussians(fg: Gaussians, bg: Gaussians):
    """Activated (scales, opacities, colors) of fg then bg, the reference's
    fg-first order (scene_model.py:122-143)."""
    return (
        torch.cat([fg.get_scales(), bg.get_scales()], 0),
        torch.cat([fg.get_opacities(), bg.get_opacities()], 0),
        torch.cat([fg.get_colors(), bg.get_colors()], 0),
    )
