"""SceneModel / TrainState <-> flat dicts of numpy arrays keyed by the JAX
pytree paths.

No counterpart in the JAX package: this is the boundary the port's tests
(and any checkpoint migration) cross. A key is the leaf's path in the JAX
``SceneModel`` pytree — field names, list indices and dict keys joined by
dots — e.g. ``fg.means``, ``bg.alive``, ``bases.rots``, ``move.trunk.3.w``,
``move.head_end.1.b``, ``move.time_params``. Absent optional leaves (no
bg, no motion_coefs, no alive) have no key.

MLP weights: the JAX package stores ``w`` as (d_in, d_out) and applies
``x @ w``; nn.Linear stores ``weight`` as (d_out, d_in). The conversion
transposes, so both packages compute the same products.

A whole TrainState (train_state_to_numpy / train_state_from_numpy) adds
the optimizer state per label of the reference's optax multi_transform
(``fg.means``, ``move.pose`` ...) and the density statistics:

    scene/<key>                  every scene_to_numpy array
    opt/<label>/count            the inner Adam (and schedule) count
    opt/<label>/mini_step        optax.MultiSteps counters (0 elsewhere)
    opt/<label>/gradient_step
    opt/<label>/mu/<key>         Adam moments of the label's leaves
    opt/<label>/nu/<key>
    opt/<label>/acc_grads/<key>  MultiSteps running-mean gradients
    stats/grad_norm_acc, stats/vis_count, stats/max_radii
    step

The perceptual nets (backbone_from_numpy / lpips_from_numpy and their
inverses) take the JAX parameter pytrees with numpy leaves as they are:
a backbone is a list of {"w": (kh, kw, cin, cout) HWIO, "b": (cout,)}
convolutions (5 for AlexNet, 16 for VGG19), LPIPS is {"net": <AlexNet>,
"lins": [(1, 1, C, 1) HWIO heads]}. The port's convolutions are OIHW, so
every weight is transposed at this boundary.

The PWC-Net (pwcnet_from_numpy / pwcnet_to_numpy) takes the JAX package's
pytree {"extractor": 6 levels x 3 convolutions, "decoders": {6..2: {"one",
..., "six", and below level 6 "upflow", "upfeat"}}, "refiner": 7
convolutions}, each {"w": HWIO, "b"}. Its transposed convolutions
(upflow, upfeat) hold the torch ConvTranspose2d kernel (cin, cout, kh, kw)
spatially flipped, as (kh, kw, cin, cout).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deblur4dgs_tpu_torch import resolve_device
from deblur4dgs_tpu_torch.eval.lpips import LPIPS
from deblur4dgs_tpu_torch.models.backbones import (
    ALEX_TORCH_IDX,
    VGG_TORCH_IDX,
    load_alexnet_torch,
    load_vgg19_torch,
)
from deblur4dgs_tpu_torch.models.gaussians import Gaussians
from deblur4dgs_tpu_torch.models.motion_bases import MotionBases
from deblur4dgs_tpu_torch.models.move_model import MoveModel
from deblur4dgs_tpu_torch.models.pwcnet import (
    _LEVEL_NAMES,
    PWCNet,
    load_pwcnet_torch,
)
from deblur4dgs_tpu_torch.models.scene import SceneModel
from deblur4dgs_tpu_torch.train.optimizers import GroupState, param_label
from deblur4dgs_tpu_torch.train.trainer import DensityStats, TrainState

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


def _np_leaf(x: torch.Tensor, transposed: bool = False) -> np.ndarray:
    """A copy of x as a C-contiguous numpy array (transposed if asked)."""
    a = x.detach().cpu().numpy()
    return np.array(a.T if transposed else a, order="C", copy=True)


def scene_to_numpy(scene: SceneModel) -> dict[str, np.ndarray]:
    """Every parameter and the alive buffers, keyed by JAX pytree path
    (copies: later in-place updates of the scene do not show through)."""
    out = {}
    for name, x in list(scene.named_parameters()) + list(scene.named_buffers()):
        key, transposed = jax_key(name)
        out[key] = _np_leaf(x, transposed)
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


def train_state_to_numpy(state: TrainState) -> dict[str, np.ndarray]:
    """The whole TrainState as a flat dict (layout in the module doc)."""
    out = {f"scene/{k}": v for k, v in scene_to_numpy(state.scene).items()}
    for label, gs in state.opt_state.items():
        for k in ("count", "mini_step", "gradient_step"):
            out[f"opt/{label}/{k}"] = np.asarray(getattr(gs, k), np.int32)
        for kind in ("mu", "nu", "acc_grads"):
            for name, x in getattr(gs, kind).items():
                key, transposed = jax_key(name)
                out[f"opt/{label}/{kind}/{key}"] = _np_leaf(x, transposed)
    for name, x in state.stats._asdict().items():
        out[f"stats/{name}"] = _np_leaf(x)
    out["step"] = np.asarray(state.step, np.int32)
    return out


def train_state_from_numpy(arrays: dict[str, np.ndarray],
                           device="cuda") -> TrainState:
    """Build a TrainState on ``device`` from a train_state_to_numpy-style
    dict. A label's moments exist for every parameter of its group; its
    acc_grads only where the dict holds them (the MultiSteps groups)."""
    dev = resolve_device(device)
    scene = scene_from_numpy({k[len("scene/"):]: v for k, v in arrays.items()
                              if k.startswith("scene/")}, device=dev)
    labels = {k.split("/")[1] for k in arrays if k.startswith("opt/")}
    opt_state = {
        label: GroupState(**{
            k: int(arrays[f"opt/{label}/{k}"])
            for k in ("count", "mini_step", "gradient_step")})
        for label in labels
    }

    def t(key, transposed):
        a = np.array(arrays[key], np.float32)
        return torch.as_tensor(a.T if transposed else a, device=dev)

    for name, _ in scene.named_parameters():
        label = param_label(name)
        key, transposed = jax_key(name)
        gs = opt_state[label]
        for kind in ("mu", "nu", "acc_grads"):
            k = f"opt/{label}/{kind}/{key}"
            if k in arrays:
                getattr(gs, kind)[name] = t(k, transposed)
            elif kind != "acc_grads":
                raise KeyError(k)
    stats = DensityStats(*(
        torch.as_tensor(np.array(arrays[f"stats/{f}"]), device=dev)
        for f in DensityStats._fields))
    return TrainState(scene=scene, opt_state=opt_state,
                      step=int(arrays["step"]), stats=stats)


def backbone_from_numpy(layers: list[dict], device="cuda"):
    """A JAX AlexNet (5 convolutions) or VGG19 (16) parameter list ->
    AlexNetFeatures / VGG19Features on ``device`` (through the torchvision
    state-dict loaders)."""
    loaders = {5: (load_alexnet_torch, ALEX_TORCH_IDX),
               16: (load_vgg19_torch, VGG_TORCH_IDX)}
    if len(layers) not in loaders:
        raise ValueError(f"{len(layers)} convolutions: neither AlexNet (5) "
                         "nor VGG19 (16)")
    load, idxs = loaders[len(layers)]
    sd = {}
    for i, layer in zip(idxs, layers):
        sd[f"features.{i}.weight"] = np.array(layer["w"], np.float32) \
            .transpose(3, 2, 0, 1)
        sd[f"features.{i}.bias"] = np.array(layer["b"], np.float32)
    return load(sd, device)


def backbone_to_numpy(net) -> list[dict]:
    """The inverse of backbone_from_numpy (HWIO copies)."""
    return [{"w": _np_leaf(c.weight).transpose(2, 3, 1, 0).copy(),
             "b": _np_leaf(c.bias)} for c in net.convs]


def lpips_from_numpy(params: dict, device="cuda") -> LPIPS:
    """A JAX LPIPS parameter dict {"net", "lins"} -> LPIPS on ``device``."""
    dev = resolve_device(device)
    lins = [torch.as_tensor(np.array(w, np.float32).transpose(3, 2, 0, 1),
                            device=dev) for w in params["lins"]]
    return LPIPS(backbone_from_numpy(params["net"], dev), lins)


def lpips_to_numpy(model: LPIPS) -> dict:
    """The inverse of lpips_from_numpy."""
    return {"net": backbone_to_numpy(model.net),
            "lins": [_np_leaf(w).transpose(2, 3, 1, 0).copy()
                     for w in model.lins]}


_PWC_EXTRACTOR = ["netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix"]
_PWC_DECODER = {"one": "netOne.0", "two": "netTwo.0", "thr": "netThr.0",
                "fou": "netFou.0", "fiv": "netFiv.0", "six": "netSix.0",
                "upflow": "netUpflow", "upfeat": "netUpfeat"}


def _pwc_names(params: dict):
    """(torch state name without .weight / .bias, JAX conv dict,
    transposed?) for every convolution of a JAX PWC-Net pytree."""
    for n, level in zip(_PWC_EXTRACTOR, params["extractor"]):
        for i, conv in zip((0, 2, 4), level):
            yield f"netExtractor.{n}.{i}", conv, False
    for lvl, d in params["decoders"].items():
        for key, conv in d.items():
            yield (f"{_LEVEL_NAMES[int(lvl)]}.{_PWC_DECODER[key]}", conv,
                   key.startswith("up"))
    for i, conv in enumerate(params["refiner"]):
        yield f"netRefiner.netMain.{2 * i}", conv, False


def pwcnet_from_numpy(params: dict, device="cuda") -> PWCNet:
    """A JAX PWC-Net pytree (numpy or JAX leaves) -> PWCNet on ``device``."""
    sd = {}
    for name, conv, transposed in _pwc_names(params):
        w = np.array(conv["w"], np.float32)
        sd[f"{name}.weight"] = (w[::-1, ::-1].transpose(2, 3, 0, 1)
                                if transposed else w.transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = np.array(conv["b"], np.float32)
    return load_pwcnet_torch(
        {k: np.ascontiguousarray(v) for k, v in sd.items()}, device)


def pwcnet_to_numpy(net: PWCNet) -> dict:
    """The inverse of pwcnet_from_numpy (numpy leaves, HWIO copies)."""
    sd = {k: _np_leaf(v) for k, v in net.state_dict().items()}

    def conv(name, transposed):
        w = sd[f"{name}.weight"]
        w = (w.transpose(2, 3, 0, 1)[::-1, ::-1] if transposed
             else w.transpose(2, 3, 1, 0))
        return {"w": np.ascontiguousarray(w), "b": sd[f"{name}.bias"]}

    return {
        "extractor": [[conv(f"netExtractor.{n}.{i}", False) for i in (0, 2, 4)]
                      for n in _PWC_EXTRACTOR],
        "decoders": {
            lvl: {key: conv(f"{name}.{_PWC_DECODER[key]}",
                            key.startswith("up"))
                  for key in _PWC_DECODER
                  if lvl < 6 or not key.startswith("up")}
            for lvl, name in _LEVEL_NAMES.items()},
        "refiner": [conv(f"netRefiner.netMain.{2 * i}", False)
                    for i in range(7)],
    }
