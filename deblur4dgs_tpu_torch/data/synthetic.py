"""Synthetic dynamic blurry-video scenes for tests, smoke runs and benchmarks.

PyTorch port of deblur4dgs_tpu/data/synthetic.py. A known ground-truth
Gaussian scene stands in for preprocessed stereo blur data:

  * fg Gaussians animated by ground-truth SE(3) motion bases;
  * static bg Gaussians on a backdrop wall;
  * blurry observations = mean of sub-frame renders across a known
    exposure window (the forward model the trainer inverts);
  * masks / depths / 2D tracks derived from the ground-truth scene.

Every random draw comes from numpy ``default_rng`` in the reference's
order, so the same seed gives the same scene and dataset as the JAX
package. The scene lives on ``device``; the dataset is host-side numpy, as
the reference's adapters serve it. The oracle branch renders through
ops/rasterize_ref.py; ``fast_renderer=True`` renders through the tile path
(``models/scene.py::render``, i.e. the dense compositor K5).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from deblur4dgs_tpu_torch import resolve_device
from deblur4dgs_tpu_torch.data.observations import (
    StaticObservations,
    TrackObservations,
)
from deblur4dgs_tpu_torch.models.gaussians import Gaussians
from deblur4dgs_tpu_torch.models.motion_bases import (
    MotionBases,
    compute_transforms,
    transform_gaussians,
)
from deblur4dgs_tpu_torch.models.move_model import init_move_model
from deblur4dgs_tpu_torch.models.scene import SceneModel
from deblur4dgs_tpu_torch.models.scene import render as scene_render
from deblur4dgs_tpu_torch.ops import lie
from deblur4dgs_tpu_torch.ops.projection import project
from deblur4dgs_tpu_torch.ops.rasterize_ref import render_ref


class SyntheticScene(NamedTuple):
    fg: Gaussians
    bg: Gaussians
    bases: MotionBases
    w2cs: torch.Tensor  # (T, 4, 4) per-frame cameras
    Ks: torch.Tensor  # (T, 3, 3)
    img_wh: tuple[int, int]
    exposure: float  # GT exposure half-width (frame units)
    # (T, 6) se(3) camera-shake delta at the exposure END; the camera
    # sweeps exp(u * delta) @ w2c for u in [-1, 1] across the exposure
    # (symmetric, so the mid-exposure camera is exactly w2cs[i]). None:
    # the camera is fixed within each exposure.
    exp_deltas: torch.Tensor | None = None


def _logit(x):
    return np.log(x) - np.log1p(-x)


def _split(pose34):
    return pose34[:3, :3], pose34[:3, 3]


def make_scene(
    seed: int = 0,
    num_fg: int = 120,
    num_bg: int = 300,
    num_frames: int = 8,
    num_bases: int = 4,
    img_wh: tuple[int, int] = (64, 48),
    exposure: float = 0.4,
    cam_shake: float = 0.015,
    exp_shake: float = 0.0,
    motion_cycles: float = 1.0,
    motion_amp: float = 0.35,
    device="cuda",
) -> SyntheticScene:
    """A ground-truth scene on ``device`` (the reference's make_scene, whose
    docstring explains exp_shake, motion_cycles and motion_amp). The bg
    wall is a ceil(sqrt(num_bg))^2 grid cut to num_bg Gaussians."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    W, H = img_wh
    f = 0.9 * max(W, H)
    t_ = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # fg: a compact cluster that translates + rotates over time
    fg_means = rng.normal(0, 0.25, (num_fg, 3)).astype(np.float32)
    fg_means[:, 2] *= 0.3
    fg = Gaussians(
        means=t_(fg_means),
        quats=t_(rng.normal(size=(num_fg, 4))),
        scales=t_(np.full((num_fg, 3), np.log(0.045))),
        colors=t_(_logit(rng.uniform(0.25, 0.95, (num_fg, 3)))),
        opacities=t_(np.full((num_fg,), _logit(0.92))),
        motion_coefs=t_(rng.normal(0, 0.5, (num_fg, num_bases))),
    )

    # bg: a dense backdrop wall covering the whole view frustum
    g = int(np.ceil(np.sqrt(num_bg)))
    gx, gy = np.meshgrid(np.linspace(-1, 1, g), np.linspace(-1, 1, g))
    z_wall = 1.6  # behind the fg (camera sits at -2.5 along +z; see below)
    span = 1.25 * (2.5 + z_wall) / f * max(W, H) / 2.0
    bg_means = np.stack(
        [gx.ravel() * span * W / max(W, H), gy.ravel() * span * H / max(W, H),
         np.full(g * g, z_wall)],
        -1,
    )[:num_bg].astype(np.float32)
    bg_means += rng.normal(0, 0.02, bg_means.shape).astype(np.float32)
    bg_spacing = 2 * span * W / max(W, H) / g
    bg = Gaussians(
        means=t_(bg_means),
        quats=t_(rng.normal(size=(num_bg, 4))),
        scales=t_(np.full((num_bg, 3), np.log(1.2 * bg_spacing))),
        colors=t_(_logit(rng.uniform(0.1, 0.9, (num_bg, 3)))),
        opacities=t_(np.full((num_bg,), _logit(0.95))),
    )

    # GT motion bases: smooth sinusoidal per-basis trajectories (the Lie
    # maps on the CPU in float32, then moved)
    t = np.linspace(0, 2 * np.pi * motion_cycles, num_frames)
    rots6, transls = [], []
    for k in range(num_bases):
        amp = motion_amp * (k + 1) / num_bases
        ang = amp * np.sin(t + k)  # rotation about a per-basis axis
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        R = lie.so3_exp(torch.as_tensor(
            (ang[:, None] * axis).astype(np.float32)))
        rots6.append(lie.rmat_to_cont_6d(R))
        tr = motion_amp * np.stack(
            [np.sin(t + 2 * k), np.cos(t + k) - np.cos(float(k)),
             0.1 * np.sin(2 * t + k)], -1
        ) * (k + 1) / num_bases
        transls.append(torch.as_tensor(tr.astype(np.float32)))
    bases = MotionBases(rots=torch.stack(rots6).to(dev),
                        transls=torch.stack(transls).to(dev))

    # cameras orbit slightly; scene pushed +z in front
    w2cs = []
    for _ in range(num_frames):
        wu = np.concatenate(
            [cam_shake * rng.normal(size=3), cam_shake * rng.normal(size=3)]
        ).astype(np.float32)
        base = np.eye(4, dtype=np.float32)
        base[2, 3] = 2.5  # camera at z=-2.5 looking at origin
        delta = lie.rt_to_mat4(
            *_split(lie.se3_exp(torch.as_tensor(wu)))).numpy()
        w2cs.append(delta @ base)
    Kmat = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    exp_deltas = None
    if exp_shake > 0:
        # random direction per frame, biased toward rotation + in-plane
        # translation (handheld-shake-like); symmetric across the window
        d = rng.normal(size=(num_frames, 6)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        exp_deltas = t_(exp_shake * d)
    return SyntheticScene(
        fg=fg,
        bg=bg,
        bases=bases,
        w2cs=t_(np.stack(w2cs)),
        Ks=t_(np.tile(Kmat, (num_frames, 1, 1))),
        img_wh=img_wh,
        exposure=exposure,
        exp_deltas=exp_deltas,
    )


def gt_gaussians_at(scene: SyntheticScene, t_frac):
    """All GT Gaussians (fg deformed at t + static bg): means, quats,
    scales, opacities, colors."""
    dev = scene.fg.means.device
    ts = torch.as_tensor(t_frac, dtype=torch.float32, device=dev).reshape(1)
    tf = compute_transforms(scene.bases, ts, scene.fg.get_coefs())
    fgm, fgq = transform_gaussians(tf, scene.fg.means, scene.fg.get_quats())
    means = torch.cat([fgm[:, 0], scene.bg.means], 0)
    quats = torch.cat([fgq[:, 0], scene.bg.get_quats()], 0)
    scales = torch.cat([scene.fg.get_scales(), scene.bg.get_scales()], 0)
    opac = torch.cat([scene.fg.get_opacities(), scene.bg.get_opacities()], 0)
    colors = torch.cat([scene.fg.get_colors(), scene.bg.get_colors()], 0)
    return means, quats, scales, opac, colors


def render_frame(scene: SyntheticScene, t_frac, w2c, K, channels=None,
                 bg=1.0):
    means, quats, scales, opac, colors = gt_gaussians_at(scene, t_frac)
    ch = colors if channels is None else channels
    return render_ref(means, quats, scales, opac, ch, w2c, K, scene.img_wh,
                      bg)


class SyntheticDataset(NamedTuple):
    """Training bundle mirroring the reference dataset fields (numpy)."""

    imgs: np.ndarray  # (T, H, W, 3) blurry observations
    sharp_imgs: np.ndarray  # (T, H, W, 3) GT mid-exposure (eval only)
    masks: np.ndarray  # (T, H, W) fg masks
    depths: np.ndarray  # (T, H, W)
    w2cs: np.ndarray
    Ks: np.ndarray
    tracks_3d: np.ndarray  # (T, P, 3) world-space GT track points
    tracks_2d: np.ndarray  # (T, P, 2) pixel-space tracks
    track_depths: np.ndarray  # (T, P)
    track_visibles: np.ndarray  # (T, P)


def gt_scene_model(scene: SyntheticScene) -> SceneModel:
    """The GT Gaussians as a SceneModel on the scene's device: every slot
    alive and a MoveModel from torch.Generator seed 0. Its heads are
    zero-initialised, so mode 'mid' with stage 'first' (deltaT = 0) renders
    the GT Gaussians at exactly time t through the tile path, whatever the
    trunk's draws (the reference seeds its MoveModel with
    jax.random.PRNGKey(0))."""
    dev = scene.fg.means.device

    def alive(g, coefs):
        return Gaussians(
            means=g.means.detach(), quats=g.quats.detach(),
            scales=g.scales.detach(), colors=g.colors.detach(),
            opacities=g.opacities.detach(),
            motion_coefs=g.motion_coefs.detach() if coefs else None,
            alive=torch.ones((g.capacity,), device=dev))

    return SceneModel(
        fg=alive(scene.fg, True),
        bg=alive(scene.bg, False),
        bases=MotionBases(scene.bases.rots.detach(),
                          scene.bases.transls.detach()),
        move=init_move_model(torch.Generator().manual_seed(0),
                             num_frames=scene.w2cs.shape[0], device=dev),
    )


@torch.no_grad()
def sharp_fg_masks(scene: SyntheticScene, cap: int = 1024) -> np.ndarray:
    """Mid-exposure fg silhouettes (T, H, W) through the tile path: the
    blur_union_masks=False masks of generate_dataset, recomputable alone."""
    T = scene.w2cs.shape[0]
    sm = gt_scene_model(scene)
    masks = []
    for i in range(T):
        out = scene_render(
            sm, float(i), scene.w2cs[i], scene.Ks[i], scene.img_wh,
            mode="mid", stage="first", return_mask=True, bg_color=1.0,
            num_exposure=1, cap=cap,
        )
        masks.append((out["mask"][..., 0] > 0.5).float().cpu().numpy())
    return np.stack(masks)


class SyntheticSceneAdapter:
    """Dataset-interface adapter over a SyntheticScene + SyntheticDataset,
    the StereoDataset surface the staged pipeline consumes. Items are
    numpy; track and point observations are CPU tensors."""

    def __init__(self, scene: SyntheticScene, data: SyntheticDataset,
                 num_targets_per_frame: int = 2, seed: int = 0,
                 split: str = "train"):
        self.scene = scene
        self.data = data
        self.split = split
        self.training = split == "train"
        self.rng = np.random.default_rng(seed)
        self.num_targets = num_targets_per_frame
        T = data.imgs.shape[0]
        self.start, self.end = 0, T
        self.Ks = np.asarray(data.Ks)
        self.w2cs = np.asarray(data.w2cs)
        # The val split serves SHARP held-out frames (test-time pose opt
        # aligns the sharp render against sharp GT); training frames stay
        # blurry.
        self.imgs = np.asarray(
            data.sharp_imgs if split == "val" else data.imgs
        )
        self.masks = np.asarray(data.masks)
        self.depths = np.asarray(data.depths)

    def __len__(self):
        return self.imgs.shape[0]

    @property
    def num_frames(self):
        return self.imgs.shape[0]

    def get_dyn_time_ids(self):
        return np.arange(self.num_frames)

    def get_dyn_image_ids(self):
        return list(range(self.num_frames))

    def get_img_wh(self):
        return self.scene.img_wh

    def get_tracks_3d(self, num_samples: int, step: int = 1):
        d = self.data
        P = d.tracks_3d.shape[1]
        sel = (
            self.rng.choice(P, min(num_samples, P), replace=False)
            if num_samples < P else np.arange(P)
        )
        xyz = torch.as_tensor(np.swapaxes(d.tracks_3d[:, sel], 0, 1))
        vis = torch.as_tensor(np.swapaxes(d.track_visibles[:, sel], 0, 1))
        return TrackObservations(
            xyz=xyz,
            visibles=vis,
            invisibles=~vis,
            confidences=torch.ones(vis.shape, dtype=torch.float32),
            colors=torch.full((len(sel), 3), 0.5),
        )

    def get_bkgd_points(self, num_samples: int):
        bg = self.scene.bg
        n = bg.capacity
        sel = (
            self.rng.choice(n, min(num_samples, n), replace=False)
            if num_samples < n else np.arange(n)
        )
        sel = torch.as_tensor(sel, device=bg.means.device)
        return StaticObservations(
            xyz=bg.means.detach()[sel].cpu(),
            normals=torch.tensor([0.0, 0.0, -1.0]).repeat(len(sel), 1),
            colors=torch.sigmoid(bg.colors.detach()[sel]).cpu(),
        )

    def get_item(self, index: int) -> dict:
        d = self.data
        item = {
            "frame_names": f"{index:05d}",
            "ts": index,
            "w2cs": d.w2cs[index],
            "Ks": d.Ks[index],
            "imgs": self.imgs[index],  # sharp GT on the val split
            "valid_masks": np.ones_like(d.masks[index]),
            "masks": d.masks[index],
            "depths": d.depths[index],
        }
        if not self.training:
            return item
        W, H = self.scene.img_wh
        q = np.floor(d.tracks_2d[index])
        q = np.stack([q[:, 0].clip(0, W - 1), q[:, 1].clip(0, H - 1)], -1)
        item["query_tracks_2d"] = q.astype(np.float32)
        tids = self.rng.choice(
            self.num_frames, (self.num_targets,), replace=False
        )
        q_vis = np.asarray(d.track_visibles[index], np.float32)
        item["target_ts"] = tids
        item["target_w2cs"] = d.w2cs[tids]
        item["target_Ks"] = d.Ks[tids]
        item["target_tracks_2d"] = d.tracks_2d[tids]
        item["target_visibles"] = (
            np.asarray(d.track_visibles[tids], np.float32) * q_vis[None]
        )
        item["target_confidences"] = np.ones_like(item["target_visibles"])
        item["target_track_depths"] = d.track_depths[tids]
        return item


@torch.no_grad()
def generate_dataset(
    scene: SyntheticScene, num_blur_samples: int = 7, num_tracks: int = 64,
    seed: int = 0, fast_renderer: bool = False,
    blur_union_masks: bool = False,
) -> SyntheticDataset:
    """Render the supervision bundle of ``scene`` (the reference's
    generate_dataset; its docstring explains blur_union_masks).

    fast_renderer=False renders through the oracle (ops/rasterize_ref.py),
    keeping dataset quality independent of the kernels under test;
    fast_renderer=True renders through the tile path (K5 on the card),
    needed at realistic sizes where the oracle's (P, G) arrays do not
    fit."""
    T = scene.w2cs.shape[0]
    W, H = scene.img_wh
    dev = scene.w2cs.device
    rng = np.random.default_rng(seed)
    track_ids = rng.choice(scene.fg.capacity, size=num_tracks, replace=False)
    nfg = scene.fg.capacity

    if fast_renderer:
        sm = gt_scene_model(scene)

        def frame_at(tf, w2c, K):
            out = scene_render(
                sm, tf, w2c, K, scene.img_wh, mode="mid", stage="first",
                return_mask=True, return_depth=True, bg_color=1.0,
                num_exposure=1, cap=1024,
            )
            return out["img"], out["mask"][..., 0], out["depth"][..., 0]

        def rgb_at(tf, w2c, K):
            return frame_at(tf, w2c, K)[0]

        def mask_depth_at(tf, w2c, K):
            _, m, d = frame_at(tf, w2c, K)
            # match the oracle branch's (out[..., 0], out[..., 1]/alpha)
            return torch.stack([m, d], -1), torch.ones_like(m)
    else:

        def rgb_at(tf, w2c, K):
            means, quats, scales, opac, colors = gt_gaussians_at(scene, tf)
            img, _ = render_ref(means, quats, scales, opac, colors, w2c, K,
                                scene.img_wh, 1.0)
            return img

        def mask_depth_at(tf, w2c, K):
            means, quats, scales, opac, _ = gt_gaussians_at(scene, tf)
            maskv = torch.cat([torch.ones((nfg, 1), device=dev),
                               torch.zeros((means.shape[0] - nfg, 1),
                                           device=dev)], 0)
            proj = project(means, quats, scales, w2c, K, scene.img_wh)
            ch = torch.cat([maskv, proj.depths[:, None]], -1)
            return render_ref(means, quats, scales, opac, ch, w2c, K,
                              scene.img_wh, torch.zeros(2, device=dev))

    def sub_w2c(i, u):
        """The camera at exposure coordinate u in [-1, 1] of frame i."""
        w2c = scene.w2cs[i]
        if scene.exp_deltas is None:
            return w2c
        delta = lie.rt_to_mat4(*_split(lie.se3_exp(u * scene.exp_deltas[i])))
        return delta @ w2c

    imgs, sharps, masks, depths = [], [], [], []
    tracks3, tracks2, tdepths, tvis = [], [], [], []
    coefs = scene.fg.get_coefs()[track_ids]
    t_means = scene.fg.means[track_ids]
    t_quats = scene.fg.get_quats()[track_ids]
    for i in range(T):
        w2c, K = scene.w2cs[i], scene.Ks[i]
        # blurry = mean of sub-frame renders across the exposure window
        ts = np.linspace(i - scene.exposure, i + scene.exposure,
                         num_blur_samples)
        us = np.linspace(-1.0, 1.0, num_blur_samples)
        ts = np.clip(ts, 0, T - 1)
        acc = None
        for tf, u in zip(ts, us):
            img = rgb_at(np.float32(tf), sub_w2c(i, float(u)), K)
            acc = img if acc is None else acc + img
        imgs.append((acc / num_blur_samples).cpu().numpy())
        sharps.append(rgb_at(np.float32(i), w2c, K).cpu().numpy())

        # fg mask + depth via channel multiplexing at mid-exposure
        out, alpha = mask_depth_at(np.float32(i), w2c, K)
        out, alpha = out.cpu().numpy(), alpha.cpu().numpy()
        mask_i = (out[..., 0] > 0.5).astype(np.float32)
        if blur_union_masks:
            # union of fg coverage across the exposure window
            for tf, u in zip(ts, us):
                out_s, _ = mask_depth_at(np.float32(tf), sub_w2c(i, float(u)),
                                         K)
                mask_i = np.maximum(
                    mask_i, (out_s[..., 0] > 0.5).float().cpu().numpy())
        masks.append(mask_i)
        depths.append(out[..., 1] / np.maximum(alpha, 1e-6))

        # GT tracks: fg subset positions at time i
        tf3 = compute_transforms(
            scene.bases, torch.tensor([float(i)], device=dev), coefs)
        pts = transform_gaussians(tf3, t_means, t_quats)[0][:, 0]  # world
        cam = lie.pose_apply(w2c[:3], pts)
        uvz = (K @ cam.T).T
        uv = uvz[:, :2] / torch.clamp(uvz[:, 2:], min=1e-6)
        vis = (
            (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
            & (uv[:, 1] < H) & (cam[:, 2] > 0.05)
        )
        tracks3.append(pts.cpu().numpy())
        tracks2.append(uv.cpu().numpy())
        tdepths.append(cam[:, 2].cpu().numpy())
        tvis.append(vis.cpu().numpy())

    return SyntheticDataset(
        imgs=np.stack(imgs),
        sharp_imgs=np.stack(sharps),
        masks=np.stack(masks),
        depths=np.stack(depths),
        w2cs=scene.w2cs.cpu().numpy(),
        Ks=scene.Ks.cpu().numpy(),
        tracks_3d=np.stack(tracks3),
        tracks_2d=np.stack(tracks2),
        track_depths=np.stack(tdepths),
        track_visibles=np.stack(tvis),
    )
