"""Dataset views: temporal windows and resolution pyramids.

PyTorch port of deblur4dgs_tpu/data/views.py (numpy, as the reference;
the pairwise track re-fetch uses the port's data/utils.py). Stage 2's
phase A trains on 4x-downsampled frames and phase B on full resolution
within adaptive temporal windows, with window-local frame times. These
wrappers provide the same views over any dataset exposing the common
surface (imgs/masks/depths/Ks/w2cs arrays + get_item/get_tracks_3d/
get_bkgd_points/get_dyn_*).
"""

from __future__ import annotations

import numpy as np


def _downsample_img(img: np.ndarray, f: int) -> np.ndarray:
    """Area downsample (H, W[, C]) by integer factor."""
    H, W = img.shape[:2]
    Hc, Wc = H // f, W // f
    img = img[: Hc * f, : Wc * f]
    if img.ndim == 2:
        return img.reshape(Hc, f, Wc, f).mean((1, 3))
    return img.reshape(Hc, f, Wc, f, -1).mean((1, 3))


class DownsampleView:
    """Resolution-pyramid view: images/masks/depths area-downsampled,
    intrinsics scaled (run_training_dynamic.py phase A 'x4' scale)."""

    def __init__(self, base, factor: int):
        self.base = base
        self.factor = factor
        self.training = base.training
        self.start, self.end = base.start, base.end
        self.imgs = np.stack([_downsample_img(i, factor) for i in np.asarray(base.imgs)])
        self.masks = np.stack([_downsample_img(m, factor) for m in np.asarray(base.masks)])
        self.depths = np.stack([_downsample_img(d, factor) for d in np.asarray(getattr(base, "depths", base.masks))])
        Ks = np.asarray(base.Ks).copy()
        Ks[:, :2] /= factor
        self.Ks = Ks
        self.w2cs = np.asarray(base.w2cs)

    def __len__(self):
        return len(self.base)

    @property
    def num_frames(self):
        return self.base.num_frames

    def get_dyn_time_ids(self):
        return self.base.get_dyn_time_ids()

    def get_dyn_image_ids(self):
        return self.base.get_dyn_image_ids()

    def get_img_wh(self):
        return self.imgs.shape[2], self.imgs.shape[1]

    def get_tracks_3d(self, *a, **k):
        return self.base.get_tracks_3d(*a, **k)

    def get_bkgd_points(self, *a, **k):
        return self.base.get_bkgd_points(*a, **k)

    def get_item(self, index: int) -> dict:
        item = dict(self.base.get_item(index))
        f = self.factor
        item["imgs"] = self.imgs[index]
        item["masks"] = self.masks[index]
        item["depths"] = self.depths[index]
        item["valid_masks"] = np.ones_like(self.masks[index])
        item["Ks"] = self.Ks[index]
        if "query_tracks_2d" in item:
            W, H = self.get_img_wh()
            item["query_tracks_2d"] = np.clip(
                np.asarray(item["query_tracks_2d"]) / f,
                0, [W - 1, H - 1],
            )
            item["target_Ks"] = np.asarray(item["target_Ks"]).copy()
            item["target_Ks"][:, :2] /= f
            item["target_tracks_2d"] = np.asarray(item["target_tracks_2d"]) / f
        return item


class WindowView:
    """Temporal-window view over frame indices ``window`` (phase B): frame
    times are re-indexed to be window-local, track targets restricted to
    the window."""

    def __init__(self, base, window: list[int], seed: int = 0):
        self.base = base
        self.window = list(window)
        self.training = base.training
        self.rng = np.random.default_rng(seed)
        self.start, self.end = 0, len(self.window)
        self.imgs = np.asarray(base.imgs)[self.window]
        self.masks = np.asarray(base.masks)[self.window]
        self.depths = np.asarray(base.depths)[self.window]
        self.Ks = np.asarray(base.Ks)[self.window]
        self.w2cs = np.asarray(base.w2cs)[self.window]

    def __len__(self):
        return len(self.window)

    @property
    def num_frames(self):
        return len(self.window)

    def get_dyn_time_ids(self):
        return np.arange(len(self.window))

    def get_dyn_image_ids(self):
        return list(range(len(self.window)))

    def get_img_wh(self):
        return self.base.get_img_wh()

    def get_bkgd_points(self, *a, **k):
        return self.base.get_bkgd_points(*a, **k)

    def get_tracks_3d(self, num_samples: int, step: int = 1):
        """Window-restricted tracks: base tracks sliced to window frames."""
        tracks = self.base.get_tracks_3d(num_samples, step=step)
        w = np.asarray(self.window)
        return type(tracks)(
            xyz=tracks.xyz[:, w],
            visibles=tracks.visibles[:, w],
            invisibles=tracks.invisibles[:, w],
            confidences=tracks.confidences[:, w],
            colors=tracks.colors,
        )

    def get_item(self, local_index: int) -> dict:
        gi = self.window[local_index]
        item = dict(self.base.get_item(gi))
        item["ts"] = local_index
        if "target_ts" in item:
            # resample targets within the window
            tids = self.rng.choice(
                len(self.window),
                size=np.asarray(item["target_ts"]).shape[0],
                replace=len(self.window) < len(np.asarray(item["target_ts"])),
            )
            g = [self.window[int(t)] for t in tids]
            item["target_ts"] = np.asarray(tids)
            item["target_w2cs"] = np.asarray(self.base.w2cs)[g]
            item["target_Ks"] = np.asarray(self.base.Ks)[g]
            # pairwise track arrays re-fetched for the resampled targets
            pair = self._pair_tracks(gi, g)
            if pair is not None:
                item.update(pair)
        return item

    def _pair_tracks(self, src: int, targets: list[int]):
        """Re-pair ALL track-target arrays for the resampled target frames.

        get_item above replaces target_ts/w2cs/Ks with window-local
        resamples, so every target-indexed array must be rebuilt for the
        same frames (stereo via the pairwise loader, synthetic from the
        stored GT arrays)."""
        base = self.base
        if hasattr(base, "_load_pair_tracks"):
            from deblur4dgs_tpu_torch.data.utils import (
                bilinear_sample,
                parse_tapir_track_info,
            )

            pair = np.stack([base._load_pair_tracks(src, j) for j in targets])
            vis, invis, conf = parse_tapir_track_info(pair[..., 2],
                                                      pair[..., 3])
            depths = np.stack(
                [
                    bilinear_sample(np.asarray(base.depths)[t],
                                    pair[k, :, :2]).numpy()
                    for k, t in enumerate(targets)
                ]
            )
            return {
                "target_tracks_2d": pair[..., :2],
                "target_visibles": vis.numpy().astype(np.float32),
                "target_confidences": conf.numpy().astype(np.float32),
                "target_track_depths": depths,
            }
        if hasattr(base, "data"):  # synthetic adapter
            d = base.data
            q_vis = np.asarray(d.track_visibles[src], np.float32)
            return {
                "target_tracks_2d": np.asarray(d.tracks_2d)[targets],
                "target_visibles": np.asarray(d.track_visibles, np.float32)[
                    targets
                ]
                * q_vis[None],
                "target_confidences": np.ones(
                    (len(targets), q_vis.shape[0]), np.float32
                ),
                "target_track_depths": np.asarray(d.track_depths)[targets],
            }
        return None


class ValSliceView:
    """Contiguous slice [lo, hi) of a VAL dataset with times re-based to a
    training window.

    The reference evaluates each phase-B window's model on its own val
    frames by re-instantiating the val dataset with cfg.data.start/end set
    to the window bounds (run_testing.py:146-152); val time ids are
    train-frame units (stereo_low_dataset.py:114-124) and the validator
    subtracts the window start (validator.py:408). This view does the same
    without reloading: item ts become window-local train-frame times.

    ``t_offset`` is the window's first train-frame index;
    ``val_start_half`` is base.start//2 (the val dataset's own clip start
    in train-frame units — 0 for synthetic adapters).
    """

    def __init__(self, base, lo: int, hi: int, t_offset: int,
                 window_len: int):
        self.base = base
        self.lo, self.hi = lo, hi
        self.t_offset = t_offset
        self.window_len = window_len
        self.start = 0  # times returned already window-local

    def __len__(self):
        return self.hi - self.lo

    def get_img_wh(self):
        return self.base.get_img_wh()

    def get_item(self, index: int) -> dict:
        item = dict(self.base.get_item(self.lo + index))
        t_train = int(item["ts"]) - getattr(self.base, "start", 0) // 2
        item["ts"] = int(
            np.clip(t_train - self.t_offset, 0, self.window_len - 1)
        )
        return item
