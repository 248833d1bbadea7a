"""A frozen plain-PyTorch reference of the port's stage-2 train step.

A copy of the port's step as it stood when the benchmark was written
(configs, ops/{lie,projection,tiling,rasterize}, models/{gaussians,
motion_bases,move_model,scene,pwcnet}, train/{losses,optimizers,trainer},
utils/mlp), with the CUDA kernels, the multi-device paths and the K6
scatter path taken out: every compositor runs its plain twin, on any
device. The twins are held against the JAX package's compositors by the
repository's tests, and this copy keeps the deliberate deviations of
PARITY.md (the chunk-level stop at T < 1e-4, the 3-sigma box,
front-most capacity-bounded tile lists, exposure-shared binning, the
1e-2 depth floor). It imports neither JAX nor either package of the
repository, and later changes to the port do not reach it.
"""

import torch


def resolve_device(device) -> torch.device:
    return torch.device(device)
