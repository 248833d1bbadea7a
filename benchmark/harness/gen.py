"""The general generator: a cell's scene, weights, frames and step schedule
from its configuration, its traffic and the seed.

Everything is drawn on the device from one ``torch.Generator`` in a few
large calls; the step schedule (which frames each step trains on) comes
from a numpy generator on the same seed. The same seed gives the same
inputs. The program and the reference each build their own objects from
copies of what is made here (``scene_tensors``, ``pwcnet_state``), so
neither sees the other's state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

FOCAL = 1000.0  # px at 1280x720, divided by the configuration's divisor
MOVE_WIDTH, MOVE_FREQS = 64, 5  # the MoveModel's published trunk and encoding


@dataclass
class Inputs:
    scene: dict  # parameter name -> tensor (a SceneModel's named_parameters)
    move: dict  # MoveModel state dict
    pwcnet: dict  # PWC-Net state dict
    frames: dict  # per-frame tensors, leading axis the window's frames
    schedule: np.ndarray  # (steps, 2) int: (static/reg frame, dynamic frame)
    wh: tuple  # (W, H)


def frame_size(cfg):
    return cfg["frame"]["width"], cfg["frame"]["height"]


def _uniform(g, shape, lo, hi, dev):
    return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo


def _normal(g, shape, dev):
    return torch.randn(shape, generator=g, device=dev)


def _gaussians(g, prefix, n, dev, spread, z, n_coefs=0):
    means = _uniform(g, (n, 3), -spread, spread, dev)
    means[:, 2] = _uniform(g, (n,), z[0], z[1], dev)
    out = {
        f"{prefix}.means": means,
        f"{prefix}.quats": _normal(g, (n, 4), dev),
        f"{prefix}.scales": _uniform(g, (n, 3), -5.5, -3.5, dev),
        f"{prefix}.colors": _normal(g, (n, 3), dev),
        f"{prefix}.opacities": torch.ones((n,), device=dev),
    }
    if n_coefs:
        out[f"{prefix}.motion_coefs"] = _normal(g, (n, n_coefs), dev)
    return out


def _linear_layers(dims, zero_last):
    """[(name suffix, d_in, d_out, zero)] of an MLP's nn.Linear layers."""
    n = len(dims) - 1
    return [(str(i), a, b, zero_last and i == n - 1)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]


def move_state(g, T, dev):
    """The MoveModel's state dict: nn.Linear's default uniform bounds, the
    heads' last layers zero (its exposure deltas start at 0), time
    parameters 0.5."""
    in_dim = 6 * (1 + 2 * MOVE_FREQS)
    nets = {"trunk": ([in_dim] + [MOVE_WIDTH] * 5, False),
            "head_start": ([MOVE_WIDTH, MOVE_WIDTH, 6], True),
            "head_end": ([MOVE_WIDTH, MOVE_WIDTH, 6], True)}
    sd = {}
    for net, (dims, zero_last) in nets.items():
        for i, a, b, zero in _linear_layers(dims, zero_last):
            bound = 0.0 if zero else 1.0 / math.sqrt(a)
            sd[f"{net}.{i}.weight"] = _uniform(g, (b, a), -bound, bound, dev)
            sd[f"{net}.{i}.bias"] = _uniform(g, (b,), -bound, bound, dev)
    sd["time_params"] = torch.full((T,), 0.5, device=dev)
    return sd


def pwcnet_state(g, net_meta, dev):
    """Weights for ``net_meta`` (a PWC-Net built on the meta device): every
    weight and bias uniform in +-1/sqrt(fan_in), one draw for the net."""
    convs = [(name, m) for name, m in net_meta.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    total = sum(m.weight.numel() + m.bias.numel() for _, m in convs)
    flat = torch.rand((total,), generator=g, device=dev) * 2.0 - 1.0
    sd, off = {}, 0
    for name, m in convs:
        bound = 1.0 / math.sqrt(m.in_channels * m.kernel_size[0] ** 2)
        for key in ("weight", "bias"):
            p = getattr(m, key)
            sd[f"{name}.{key}"] = flat[off : off + p.numel()].view(
                p.shape) * bound
            off += p.numel()
    return sd


def _rect_masks(g, T, H, W, dev):
    """(T, H, W): one (H/4, W/4) fg rectangle per frame at a drawn place."""
    y0 = (torch.rand((T,), generator=g, device=dev) * (H // 2)).long()
    x0 = (torch.rand((T,), generator=g, device=dev) * (W // 2)).long()
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    inside = ((ys >= y0[:, None, None]) & (ys < y0[:, None, None] + H // 4)
              & (xs >= x0[:, None, None]) & (xs < x0[:, None, None] + W // 4))
    return inside.float()


def make_frames(g, cfg, traffic, dev):
    W, H = frame_size(cfg)
    T = cfg["window_frames"]
    P, Bt = traffic["query_tracks"], traffic["track_targets"]
    f = FOCAL / cfg["frame"]["intrinsics_divisor"]
    K = torch.tensor([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]],
                     device=dev)
    w2cs = torch.eye(4, device=dev).repeat(T, 1, 1)
    w2cs[:, 0, 3] = 0.02 * (torch.arange(T, device=dev) - (T - 1) / 2.0)
    targets = torch.stack([torch.randperm(T, generator=g, device=dev)[:Bt]
                           if Bt <= T else
                           (torch.rand((Bt,), generator=g, device=dev)
                            * T).long() for _ in range(T)])
    query = torch.stack([_uniform(g, (T, P), 0, W, dev),
                         _uniform(g, (T, P), 0, H, dev)], -1).floor()
    return {
        "ts": torch.arange(T, dtype=torch.int32, device=dev),
        "w2cs": w2cs,
        "Ks": K.repeat(T, 1, 1),
        "imgs": torch.rand((T, H, W, 3), generator=g, device=dev),
        "masks": _rect_masks(g, T, H, W, dev),
        "valid_masks": torch.ones((T, H, W), device=dev),
        "depths": _uniform(g, (T, H, W), 2.0, 8.0, dev),
        "reg_imgs": torch.rand((T, H, W, 3), generator=g, device=dev),
        "guides": torch.rand((T, H // 4, W // 4, 3), generator=g, device=dev),
        "query_tracks_2d": query,
        "target_ts": targets.to(torch.int32),
        "target_tracks_2d": torch.stack(
            [_uniform(g, (T, Bt, P), 0, W, dev),
             _uniform(g, (T, Bt, P), 0, H, dev)], -1),
        "target_track_depths": _uniform(g, (T, Bt, P), 2.0, 8.0, dev),
    }


def make_schedule(seed, traffic, T):
    """(steps, 2) frame pairs drawn as the pipeline's phase-B loop draws
    them (two frame indices per step); the checked steps' pairs differ."""
    rng = np.random.default_rng(seed)
    n, k = traffic["schedule_steps"], traffic["checked_steps"]
    sched = rng.integers(0, T, size=(n, 2))
    seen = set()
    for i in range(k):
        while tuple(sched[i]) in seen:
            sched[i] = rng.integers(0, T, size=2)
        seen.add(tuple(sched[i]))
    return sched


def make_inputs(cfg, traffic, seed, device, pwcnet_meta):
    """A cell's inputs from ``seed`` on ``device``; ``pwcnet_meta`` gives
    the PWC-Net's layer shapes (the reference's net on the meta device)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    T, K = cfg["window_frames"], cfg["num_motion_bases"]
    scene = {}
    scene.update(_gaussians(g, "fg", cfg["num_fg"], dev, 0.8, (2.0, 5.0),
                            n_coefs=K))
    scene.update(_gaussians(g, "bg", cfg["num_bg"], dev, 2.0, (3.0, 10.0)))
    scene["bases.rots"] = torch.tensor(
        [1.0, 0, 0, 0, 1, 0], device=dev).repeat(K, T, 1)
    scene["bases.transls"] = 0.02 * _normal(g, (K, T, 3), dev)
    return Inputs(
        scene=scene,
        move=move_state(g, T, dev),
        pwcnet=pwcnet_state(g, pwcnet_meta, dev) if traffic["flow_term"]
        else {},
        frames=make_frames(g, cfg, traffic, dev),
        schedule=make_schedule(seed, traffic, T),
        wh=frame_size(cfg),
    )


def step_batches(inputs, k, frame_batch, track_batch):
    """Step k's arguments after the epoch: (static, dyn, tracks, reg,
    batch4), as pipeline.py's phase-B loop builds them: the static and
    reg branches train on the first frame of the pair (the reg branch
    against its stage-1 render), the dynamic branch and its tracks and
    guide on the second. ``frame_batch`` / ``track_batch`` are the side's
    FrameBatch and TrackBatch classes."""
    fr = inputs.frames
    i1, i2 = (int(v) for v in inputs.schedule[k % len(inputs.schedule)])

    def frame(i, imgs=None):
        sl = slice(i, i + 1)
        return frame_batch(
            ts=fr["ts"][sl], w2cs=fr["w2cs"][sl], Ks=fr["Ks"][sl],
            imgs=fr["imgs"][sl] if imgs is None else imgs[sl],
            masks=fr["masks"][sl], valid_masks=fr["valid_masks"][sl],
            depths=fr["depths"][sl])

    tt = fr["target_ts"][i2].long()
    Bt, P = fr["target_track_depths"].shape[1:]
    tracks = track_batch(
        query_tracks_2d=fr["query_tracks_2d"][i2],
        target_ts=fr["target_ts"][i2],
        target_w2cs=fr["w2cs"][tt], target_Ks=fr["Ks"][tt],
        target_tracks_2d=fr["target_tracks_2d"][i2],
        target_visibles=torch.ones((Bt, P), device=tt.device),
        target_confidences=torch.ones((Bt, P), device=tt.device),
        target_track_depths=fr["target_track_depths"][i2])
    return (frame(i1), frame(i2), tracks, frame(i1, fr["reg_imgs"]),
            fr["guides"][i2 : i2 + 1])
