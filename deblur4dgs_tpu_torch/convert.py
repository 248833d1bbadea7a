"""SceneModel <-> flat dict of numpy arrays keyed by the JAX pytree paths.

No counterpart in the JAX package: this is the boundary the port's tests
(and any checkpoint migration) cross. A key is the leaf's path in the JAX
``SceneModel`` pytree — field names, list indices and dict keys joined by
dots — e.g. ``fg.means``, ``bg.alive``, ``bases.rots``, ``move.trunk.3.w``,
``move.head_end.1.b``, ``move.time_params``. Absent optional leaves (no
bg, no motion_coefs, no alive) have no key.

MLP weights: the JAX package stores ``w`` as (d_in, d_out) and applies
``x @ w``; nn.Linear stores ``weight`` as (d_out, d_in). The conversion
transposes, so both packages compute the same products.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deblur4dgs_tpu_torch import resolve_device
from deblur4dgs_tpu_torch.models.gaussians import Gaussians
from deblur4dgs_tpu_torch.models.motion_bases import MotionBases
from deblur4dgs_tpu_torch.models.move_model import MoveModel
from deblur4dgs_tpu_torch.models.scene import SceneModel

_GAUSS_FIELDS = ("means", "quats", "scales", "colors", "opacities",
                 "motion_coefs", "alive")
_MLPS = ("trunk", "head_start", "head_end")


def jax_key(name: str) -> tuple[str, bool]:
    """Torch state name (parameter or buffer) -> (JAX pytree key,
    transposed?)."""
    parts = name.split(".")
    if parts[0] == "move" and parts[1] in _MLPS:
        leaf = {"weight": "w", "bias": "b"}[parts[3]]
        return ".".join(parts[:3] + [leaf]), leaf == "w"
    return name, False


def scene_to_numpy(scene: SceneModel) -> dict[str, np.ndarray]:
    """Every parameter and the alive buffers, keyed by JAX pytree path."""
    out = {}
    for name, x in list(scene.named_parameters()) + list(scene.named_buffers()):
        key, transposed = jax_key(name)
        a = x.detach().cpu().numpy()
        out[key] = np.ascontiguousarray(a.T if transposed else a)
    return out


def _linear_stack(arrays, prefix, device) -> nn.ModuleList:
    layers = []
    i = 0
    while f"{prefix}.{i}.w" in arrays:
        w = np.array(arrays[f"{prefix}.{i}.w"], np.float32)
        lin = nn.Linear(w.shape[0], w.shape[1], device=device)
        with torch.no_grad():
            lin.weight.copy_(torch.as_tensor(w.T))
            lin.bias.copy_(torch.as_tensor(
                np.array(arrays[f"{prefix}.{i}.b"], np.float32)))
        layers.append(lin)
        i += 1
    if not layers:
        raise KeyError(f"no layers under {prefix!r}")
    return nn.ModuleList(layers)


def scene_from_numpy(arrays: dict[str, np.ndarray],
                     device="cuda") -> SceneModel:
    """Build a SceneModel on ``device`` from a scene_to_numpy-style dict."""
    dev = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.array(arrays[key], np.float32), device=dev)

    def gauss(part):
        if f"{part}.means" not in arrays:
            return None
        return Gaussians(**{
            f: (t(f"{part}.{f}") if f"{part}.{f}" in arrays else None)
            for f in _GAUSS_FIELDS
        })

    return SceneModel(
        fg=gauss("fg"),
        bg=gauss("bg"),
        bases=MotionBases(t("bases.rots"), t("bases.transls")),
        move=MoveModel(
            trunk=_linear_stack(arrays, "move.trunk", dev),
            head_start=_linear_stack(arrays, "move.head_start", dev),
            head_end=_linear_stack(arrays, "move.head_end", dev),
            time_params=t("move.time_params"),
        ),
    )
