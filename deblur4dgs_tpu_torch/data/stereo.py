"""Stereo blur dataset.

PyTorch port of deblur4dgs_tpu/data/stereo.py (the low- and high-res
variants differ only in the ``Ks /= 2.5`` intrinsics scaling, here the
``intrinsics_scale`` knob). Frames and masks are PNGs read by the port's
own decoder (vis/png.py::read_png, which returns what the reference's
imageio.imread does), so the loader runs where imageio is not installed;
arrays stay numpy and the track / point observations are CPU tensors.

Loads a Shape-of-Motion-preprocessed scene directory:

  data_dir/
    images/*.png                         blurry frames (sorted by int name)
    flow3d_preprocessed/
      colmap/sparse/                     refined COLMAP cameras
      masks/*.png                        fg masks
      aligned_<depth_type>/*.npy         per-frame (inverse) depths
      2d_tracks/{src}_{tgt}.npy          pairwise TAPIR tracks (x, y, occ,
                                         expected_dist)
      cache/                             scene-normalization cache

Train split: even frames, first 24. Val split: all 48 frames.
Scene normalization (center/scale/up-align from fg tracks) is computed on
the train split and cached.
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
from dataclasses import dataclass, field
from typing import Literal

import numpy as np
import torch

from deblur4dgs_tpu_torch.data.colmap import get_colmap_camera_params
from deblur4dgs_tpu_torch.data.observations import (
    StaticObservations,
    TrackObservations,
)
from deblur4dgs_tpu_torch.data.utils import (
    bilinear_sample,
    depth_to_points_world,
    normal_from_depth_image,
    parse_tapir_track_info,
)
from deblur4dgs_tpu_torch.ops import lie
from deblur4dgs_tpu_torch.vis.png import read_png


@dataclass
class StereoDataConfig:
    data_dir: str
    start: int = 0
    end: int = 24
    factor: int = 1
    split: Literal["train", "val"] = "train"
    depth_type: str = "depth_anything_colmap"
    num_targets_per_frame: int = 4
    # 2.5 for the low-res variant (288x512), 1.0 for high-res (720x1280)
    intrinsics_scale: float = 2.5
    load_from_cache: bool = True
    max_train_frames: int = 24
    seed: int = 0


class StereoDataset:
    """Loads and serves one preprocessed scene."""

    def __init__(self, cfg: StereoDataConfig, scene_norm=None):
        self.cfg = cfg
        self.training = cfg.split == "train"
        self.rng = np.random.default_rng(cfg.seed)
        d = cfg.data_dir
        self.cache_dir = osp.join(d, "flow3d_preprocessed", "cache")
        os.makedirs(self.cache_dir, exist_ok=True)

        paths = sorted(
            glob.glob(osp.join(d, "images", "*.png")),
            key=lambda x: int(osp.splitext(osp.basename(x))[0]),
        )
        mt = cfg.max_train_frames
        if self.training:
            paths = paths[::2][:mt]
            self.frame_names = [osp.splitext(osp.basename(p))[0] for p in paths]
            self.time_ids = np.arange(len(paths))
            self.start, self.end = cfg.start, min(
                cfg.end if cfg.end > 0 else len(paths), len(paths)
            )
        else:
            self.start, self.end = cfg.start * 2, cfg.end * 2
            self.frame_names = [
                osp.splitext(osp.basename(p))[0]
                for p in paths[self.start : self.end]
            ]
            self.time_ids = np.array(
                [i // 2 for i in range(len(paths))][self.start : self.end]
            )

        Ks, w2cs = get_colmap_camera_params(
            osp.join(d, "flow3d_preprocessed/colmap/sparse/"),
            [f + ".png" for f in self.frame_names],
        )
        Ks[:, :2] /= cfg.intrinsics_scale
        Ks[:, :2] /= cfg.factor
        lim = mt if self.training else 2 * mt
        self.Ks = Ks[:lim]
        self.w2cs = w2cs[:lim]
        self.frame_names = self.frame_names[:lim]
        self.time_ids = self.time_ids[:lim]

        self.imgs = (
            np.stack(
                [
                    read_png(osp.join(d, "images", f + ".png"))[..., :3]
                    for f in self.frame_names
                ]
            ).astype(np.float32)
            / 255.0
        )
        self.valid_masks = np.ones_like(self.imgs[..., 0])
        masks = (
            np.stack(
                [
                    read_png(
                        osp.join(d, "flow3d_preprocessed/masks", f + ".png")
                    )
                    for f in self.frame_names
                ]
            ).astype(np.float32)
            / 255.0
        )
        self.masks = masks[..., 0] if masks.ndim == 4 else masks

        def load_depth(f):
            depth = np.load(
                osp.join(
                    d, f"flow3d_preprocessed/aligned_{cfg.depth_type}", f + ".npy"
                )
            )
            depth = np.maximum(depth, 1e-3)
            return 1.0 / depth  # stored as inverse depth

        self.depths = np.stack(
            [load_depth(f) for f in self.frame_names]
        ).astype(np.float32)
        max_d = np.median(self.depths.reshape(len(self.frame_names), -1).max(1)) * 2.5
        self.depths = np.clip(self.depths, 0, max_d)

        if self.training:
            self.query_tracks_2d = [
                np.load(
                    osp.join(d, "flow3d_preprocessed/2d_tracks", f"{f}_{f}.npy")
                ).astype(np.float32)
                for f in self.frame_names
            ]

        # Scene normalization.
        self.scene_norm = scene_norm or self._load_or_compute_scene_norm()
        scale, transfm = self.scene_norm["scale"], self.scene_norm["transfm"]
        self.w2cs = (self.w2cs @ np.linalg.inv(transfm)).astype(np.float32)
        self.w2cs[:, :3, 3] /= scale
        if self.training:
            self.depths /= scale

    # -- basic accessors ----------------------------------------------------

    @property
    def num_frames(self):
        return len(self.frame_names)

    def __len__(self):
        return self.imgs.shape[0]

    def get_dyn_time_ids(self):
        return self.time_ids[self.start : self.end] - self.start

    def get_dyn_image_ids(self):
        return list(range(self.num_frames))[self.start : self.end]

    def get_img_wh(self):
        return self.imgs.shape[2], self.imgs.shape[1]

    # -- scene normalization ------------------------------------------------

    def _load_or_compute_scene_norm(self):
        cache = osp.join(self.cache_dir, "scene_norm_dict.npz")
        if osp.exists(cache) and self.cfg.load_from_cache:
            z = np.load(cache)
            return {"scale": float(z["scale"]), "transfm": z["transfm"]}
        if not self.training:
            raise ValueError("scene_norm must be provided for validation")
        ndyn = len(self.get_dyn_time_ids())
        tracks = self.get_tracks_3d(num_samples=10000, step=max(ndyn // 4, 1))
        pts = np.asarray(tracks.xyz).reshape(-1, 3)
        center = pts.mean(0)
        centered = np.asarray(tracks.xyz) - center
        mn = np.quantile(centered.reshape(-1, 3), 0.05, axis=0)
        mx = np.quantile(centered.reshape(-1, 3), 0.95, axis=0)
        scale = float(np.max(mx - mn)) / 2.0
        up = -self.w2cs[:, 1, :3].mean(0)
        up /= np.linalg.norm(up)
        target = np.array([0.0, 0.0, 1.0])
        axis = np.cross(up, target)
        axis /= max(np.linalg.norm(axis), 1e-8)
        ang = np.arccos(np.clip(up @ target, -1, 1))
        R = lie.so3_exp(torch.as_tensor(
            (axis * ang).astype(np.float32))).numpy()
        transfm = np.eye(4, dtype=np.float32)
        transfm[:3, :3] = R
        transfm[:3, 3] = -R @ center
        np.savez(cache, scale=scale, transfm=transfm)
        return {"scale": scale, "transfm": transfm}

    # -- track / point extraction ------------------------------------------

    def _load_pair_tracks(self, i: int, j: int) -> np.ndarray:
        if i == j:
            return self.query_tracks_2d[i]
        return np.load(
            osp.join(
                self.cfg.data_dir,
                "flow3d_preprocessed/2d_tracks",
                f"{self.frame_names[i]}_{self.frame_names[j]}.npy",
            )
        ).astype(np.float32)

    def get_tracks_3d(self, num_samples: int, step: int = 1) -> TrackObservations:
        """Unprojected, mask-filtered fg 3D tracks over the active window
        (stereo_low_dataset.py:352-512 semantics)."""
        assert self.training
        frames = list(range(self.start, self.end, step))
        nf = len(frames)
        per = max(num_samples // nf, 1)

        inv_Ks = np.linalg.inv(self.Ks[self.start : self.end][::step])
        c2ws = np.linalg.inv(self.w2cs[self.start : self.end][::step])
        H, W = self.imgs.shape[1:3]
        masks = (
            self.masks[self.start : self.end]
            * self.valid_masks[self.start : self.end]
            * (self.depths[self.start : self.end] > 0)
        )[::step] > 0.5
        depths = self.depths[self.start : self.end][::step]

        all_xyz, all_vis, all_invis, all_conf, all_colors = [], [], [], [], []
        for fi, i in enumerate(frames):
            n_query = self.query_tracks_2d[i].shape[0]
            sel = (
                self.rng.choice(n_query, per, replace=False)
                if per < n_query
                else np.arange(n_query)
            )
            pair = np.stack(
                [self._load_pair_tracks(i, j)[sel] for j in frames], axis=1
            )  # (P, T, 4)
            t2d = pair[..., :2]
            vis, invis, conf = (x.numpy() for x in parse_tapir_track_info(
                pair[..., 2], pair[..., 3]))

            td = np.stack(
                [bilinear_sample(depths[k], t2d[:, k]).numpy()
                 for k in range(nf)],
                axis=1,
            )  # (P, T)
            homo = np.concatenate([t2d, np.ones_like(t2d[..., :1])], -1)
            cam = np.einsum("tij,ptj->pti", inv_Ks, homo) * td[..., None]
            camh = np.concatenate([cam, np.ones_like(cam[..., :1])], -1)
            xyz = np.einsum("tij,ptj->pti", c2ws, camh)[..., :3]

            in_mask = np.stack(
                [bilinear_sample(masks[k].astype(np.float32),
                                 t2d[:, k]).numpy()
                 for k in range(nf)],
                axis=1,
            ) == 1.0
            vis = vis & in_mask
            invis = invis & in_mask
            conf = conf * in_mask

            colors = bilinear_sample(self.imgs[i], t2d[:, fi]).numpy()
            counts = vis.sum(1)
            valid = counts >= min(
                int(0.05 * len(self.get_dyn_time_ids())),
                np.quantile(counts, 0.1),
            )
            all_xyz.append(xyz[valid])
            all_vis.append(vis[valid])
            all_invis.append(invis[valid])
            all_conf.append(conf[valid])
            all_colors.append(colors[valid])

        return TrackObservations(
            xyz=torch.as_tensor(np.concatenate(all_xyz).astype(np.float32)),
            visibles=torch.as_tensor(np.concatenate(all_vis)),
            invisibles=torch.as_tensor(np.concatenate(all_invis)),
            confidences=torch.as_tensor(
                np.concatenate(all_conf).astype(np.float32)),
            colors=torch.as_tensor(
                np.concatenate(all_colors).astype(np.float32)),
        )

    def get_bkgd_points(self, num_samples: int) -> StaticObservations:
        """Unproject non-fg pixels + normals."""
        nf = self.num_frames
        per = max(num_samples // nf, 1)
        pts, normals, colors = [], [], []
        for i in range(nf):
            depth = self.depths[i]
            sel_mask = (
                (1.0 - self.masks[i]) * self.valid_masks[i] * (depth > 0)
            ) > 0.5
            ys, xs = np.nonzero(sel_mask)
            if len(ys) == 0:
                continue
            k = min(per, len(ys))
            idx = self.rng.choice(len(ys), k, replace=False)
            ys, xs = ys[idx], xs[idx]
            world = depth_to_points_world(depth, self.Ks[i],
                                          self.w2cs[i]).numpy()
            nrm = normal_from_depth_image(depth, self.Ks[i],
                                          self.w2cs[i]).numpy()
            pts.append(world[ys, xs])
            normals.append(nrm[ys, xs])
            colors.append(self.imgs[i][ys, xs])
        return StaticObservations(
            xyz=torch.as_tensor(np.concatenate(pts).astype(np.float32)),
            normals=torch.as_tensor(
                np.concatenate(normals).astype(np.float32)),
            colors=torch.as_tensor(np.concatenate(colors).astype(np.float32)),
        )

    # -- training item ------------------------------------------------------

    def get_item(self, index: int) -> dict:
        """One training frame + track supervision for
        num_targets_per_frame random target frames
        (stereo_low_dataset.py:574-671)."""
        data = {
            "frame_names": self.frame_names[index],
            "ts": int(self.time_ids[index]),
            "w2cs": self.w2cs[index],
            "Ks": self.Ks[index],
            "imgs": self.imgs[index],
            "valid_masks": self.valid_masks[index],
            "masks": self.masks[index],
            "depths": self.depths[index],
        }
        if not self.training:
            return data

        q = self.query_tracks_2d[index][:, :2]
        data["query_tracks_2d"] = q
        target_inds = self.rng.choice(
            self.get_dyn_image_ids(),
            (self.cfg.num_targets_per_frame,),
            replace=False,
        )
        pair = np.stack(
            [self._load_pair_tracks(index, int(j)) for j in target_inds]
        )  # (N, P, 4)
        target_ts = self.time_ids[target_inds]
        data["target_ts"] = target_ts
        data["target_w2cs"] = self.w2cs[target_ts]
        data["target_Ks"] = self.Ks[target_ts]
        data["target_tracks_2d"] = pair[..., :2]
        vis, invis, conf = parse_tapir_track_info(pair[..., 2], pair[..., 3])
        data["target_visibles"] = vis.numpy()
        data["target_invisibles"] = invis.numpy()
        data["target_confidences"] = conf.numpy()
        data["target_track_depths"] = np.stack(
            [
                bilinear_sample(self.depths[t], pair[k, :, :2]).numpy()
                for k, t in enumerate(target_inds)
            ]
        )
        return data
