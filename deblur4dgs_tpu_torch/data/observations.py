"""Track / point observation bundles as torch tensors.

PyTorch port of deblur4dgs_tpu/data/observations.py (the reference's
flow3d/tensor_dataclass.py:62-96).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TrackObservations(NamedTuple):
    xyz: torch.Tensor  # (G, T, 3)
    visibles: torch.Tensor  # (G, T) bool
    invisibles: torch.Tensor  # (G, T) bool
    confidences: torch.Tensor  # (G, T)
    colors: torch.Tensor  # (G, 3)

    def filter_valid(self, mask) -> "TrackObservations":
        return TrackObservations(*(x[mask] for x in self))

    def check_sizes(self) -> bool:
        G, T = self.xyz.shape[:2]
        return (
            tuple(self.visibles.shape) == (G, T)
            and tuple(self.invisibles.shape) == (G, T)
            and tuple(self.confidences.shape) == (G, T)
            and tuple(self.colors.shape) == (G, 3)
        )


class StaticObservations(NamedTuple):
    xyz: torch.Tensor  # (N, 3)
    normals: torch.Tensor  # (N, 3)
    colors: torch.Tensor  # (N, 3)
