"""One side of the comparison: the port (``deblur4dgs_tpu_torch``) or the
frozen reference (``reference``), built from the same generated inputs.

The two packages share module paths and names, so one function builds
both: it imports the side's modules by name. Each side gets its own
copies of the scene, MoveModel and PWC-Net weights.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable

import torch

from harness.gen import step_batches

PORT = "deblur4dgs_tpu_torch"
REFERENCE = "reference"
GAUSS_FIELDS = ("means", "quats", "scales", "colors", "opacities",
                "motion_coefs")


@dataclass
class Side:
    pkg: str
    state: Any  # trainer.TrainState
    step: Callable  # make_train_step's step function
    optimizer: Any  # optimizers.SceneAdam
    frame_batch: type
    track_batch: type
    epoch: int
    rcfg: Any  # configs.RenderConfig
    lcfg: Any  # configs.LossesConfig

    @property
    def scene(self):
        return self.state.scene

    def module(self, name):
        return importlib.import_module(f"{self.pkg}.{name}")


def pwcnet_meta():
    """The reference's PWC-Net on the meta device: its layer shapes."""
    pw = importlib.import_module(f"{REFERENCE}.models.pwcnet")
    with torch.device("meta"):
        return pw.PWCNet()


def build(pkg, inputs, cfg, traffic, device, flow_wrap=None):
    """The side's train state and step on ``device`` from ``inputs``;
    ``flow_wrap(flow_fn) -> flow_fn`` wraps the exposure-consistency flow
    function that is handed to make_train_step."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    dev = torch.device(device)
    G = m("models.gaussians").Gaussians

    def gaussians(prefix):
        vals = [inputs.scene.get(f"{prefix}.{k}") for k in GAUSS_FIELDS]
        return G(*(None if v is None else v.clone() for v in vals))

    T = cfg["window_frames"]
    bases = m("models.motion_bases").MotionBases(
        inputs.scene["bases.rots"].clone(),
        inputs.scene["bases.transls"].clone())
    move = m("models.move_model").init_move_model(
        torch.Generator().manual_seed(0), T, device=dev)
    move.load_state_dict(inputs.move)
    scene = m("models.scene").SceneModel(
        fg=gaussians("fg"), bg=gaussians("bg"), bases=bases, move=move)

    c = m("configs")
    rcfg = c.RenderConfig(num_exposure=cfg["num_exposure"],
                          tile_cap=cfg["tile_cap"],
                          max_tiles_per_gauss=cfg["max_tiles_per_gauss"],
                          camera_mode=cfg["camera_mode"])
    lr, ocfg, lcfg = c.SceneLRConfig(), c.OptimizerConfig(), c.LossesConfig()
    tr = m("train.trainer")
    opt = m("train.optimizers").make_optimizer(scene, lr, ocfg)
    flow_fn = None
    if traffic["flow_term"]:
        pw = m("models.pwcnet")
        net = pw.PWCNet()
        net.load_state_dict(inputs.pwcnet)
        flow_fn = pw.make_aligned_loss_fn(net.to(dev).eval())
        if flow_wrap is not None:
            flow_fn = flow_wrap(flow_fn)
    step = tr.make_train_step(opt, lcfg, rcfg, traffic["stage"], T,
                              flow_fn=flow_fn, **traffic["branches"])
    return Side(pkg, tr.init_train_state(scene, lr, ocfg), step, opt,
                tr.FrameBatch, tr.TrackBatch, traffic["epoch"], rcfg, lcfg)


def drive(side, inputs, k):
    """Step k of the schedule through the side's step; returns the loss
    (on the device)."""
    args = step_batches(inputs, k, side.frame_batch, side.track_batch)
    side.state, loss, _ = side.step(side.state, side.epoch, *args)
    return loss


def first_gradient(side):
    """Each leaf's gradient as the optimizer got it on the first step,
    worked out from its state after one step: Adam's first moment over
    (1 - b1), or the running mean of the groups that accumulate (their
    mean after one call is the gradient)."""
    optim = side.module("train.optimizers")
    out = {}
    for name, _ in side.scene.named_parameters():
        label = optim.param_label(name)
        gs = side.state.opt_state[label]
        if side.optimizer.groups[label].accum_every:
            out[name] = gs.acc_grads[name]
        else:
            out[name] = gs.mu[name] / (1.0 - optim.B1)
    return out
