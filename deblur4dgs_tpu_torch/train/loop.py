"""Host-side training loop: control cadence, logging and checkpoints around
the train step.

PyTorch port of deblur4dgs_tpu/train/loop.py (the epoch loops of the
reference's run_training_static.py:174-199 and
run_training_dynamic.py:285-319): call the train step, run density control
at its cadence, trap a non-finite loss, log to any writer with an
``add_scalar(tag, value, step)`` method, checkpoint periodically.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from deblur4dgs_tpu_torch import resolve_device
from deblur4dgs_tpu_torch.configs import (
    LossesConfig,
    OptimizerConfig,
    RenderConfig,
)
from deblur4dgs_tpu_torch.train.checkpoints import save_checkpoint
from deblur4dgs_tpu_torch.train.density import (
    apply_density_control,
    control_flags,
)
from deblur4dgs_tpu_torch.train.trainer import (
    FrameBatch,
    TrackBatch,
    TrainState,
    make_train_step,
)


def _as(v, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device``: no copy for one already there."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(v), device=device, dtype=dtype)


def stack_frame_batch(items: Sequence[dict], device="cuda") -> FrameBatch:
    """Stack per-frame dataset items (dataset.get_item) into a FrameBatch
    on ``device``; items already there are stacked on the device."""
    dev = resolve_device(device)

    def f(key):
        return torch.stack([_as(it[key], dev) for it in items])

    return FrameBatch(
        ts=torch.tensor([int(it["ts"]) for it in items], dtype=torch.int32,
                        device=dev),
        w2cs=f("w2cs"), Ks=f("Ks"), imgs=f("imgs"), masks=f("masks"),
        valid_masks=f("valid_masks"), depths=f("depths"),
    )


def track_batch_from_item(item: dict, start: int = 0,
                          device="cuda") -> TrackBatch:
    dev = resolve_device(device)
    f32 = torch.float32
    return TrackBatch(
        query_tracks_2d=_as(item["query_tracks_2d"], dev),
        target_ts=_as(item["target_ts"], dev, torch.int32) - start,
        target_w2cs=_as(item["target_w2cs"], dev),
        target_Ks=_as(item["target_Ks"], dev),
        target_tracks_2d=_as(item["target_tracks_2d"], dev),
        target_visibles=_as(item["target_visibles"], dev, f32),
        target_confidences=_as(item["target_confidences"], dev, f32),
        target_track_depths=_as(item["target_track_depths"], dev, f32),
    )


class TrainLoop:
    def __init__(
        self,
        state: TrainState,
        optimizer,
        lcfg: LossesConfig,
        rcfg: RenderConfig,
        ocfg: OptimizerConfig,
        num_window_frames: int,
        work_dir: str,
        stage: str,
        *,
        has_static: bool,
        has_dynamic: bool,
        has_reg: bool,
        has_batch4: bool = False,
        flow_fn=None,
        bg_scene_scale: float = 1.0,
        checkpoint_every: int = 200,
        log_every: int = 10,
        writer=None,
        viewer=None,
    ):
        if viewer is not None:
            raise NotImplementedError(
                "viewer= (live rendering during training) is not ported yet"
            )
        self.state = state
        self.ocfg = ocfg
        self.num_window_frames = num_window_frames
        self.work_dir = work_dir
        self.bg_scene_scale = bg_scene_scale
        self.checkpoint_every = checkpoint_every
        self.log_every = log_every
        self.writer = writer
        self.global_step = int(state.step)
        self.epoch = 0
        self.only_fg = not has_static
        # Device scalars, read back only at log cadence; bounded so a long
        # stage does not pin thousands of device buffers.
        self.losses: deque = deque(maxlen=max(2 * log_every, 16))
        self._last_aux: dict | None = None
        self.step_fn = make_train_step(
            optimizer, lcfg, rcfg, stage, num_window_frames,
            has_static=has_static, has_dynamic=has_dynamic, has_reg=has_reg,
            has_batch4=has_batch4, flow_fn=flow_fn,
        )
        # Host-RSS watchdog (D4_RSS_LOG=N > 0: print every N steps).
        self._rss_every = int(os.environ.get("D4_RSS_LOG", "0"))

    def _rss_gb(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9

    def train_step(self, batch_static, batch_dyn, tracks, batch_reg,
                   batch4_imgs=None):
        tic = time.time()
        self.state, loss, aux = self.step_fn(
            self.state, self.epoch, batch_static, batch_dyn, tracks,
            batch_reg, batch4_imgs,
        )
        # The loss stays on the device between log steps (a read every
        # step would synchronize the host with the card each step); the
        # NaN trap runs at log cadence, and finish() checks the tail.
        self.losses.append(loss)
        self._last_aux = aux
        self.global_step += 1

        self._maybe_control()
        if self._rss_every and self.global_step % self._rss_every == 0:
            print(f"[rss] {self.work_dir} step {self.global_step} "
                  f"{self._rss_gb():.2f} GB", flush=True)
        if self.global_step % self.log_every == 0:
            loss = float(loss)
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss {loss} at step {self.global_step}"
                )
            if self.writer is not None:
                self._log(loss, aux, time.time() - tic,
                          batch_static or batch_dyn or batch_reg)
        if (self.checkpoint_every
                and self.global_step % self.checkpoint_every == 0):
            save_checkpoint(f"{self.work_dir}/checkpoints/last", self.state,
                            self.epoch)
        return loss

    def finish(self):
        """Stage-end epilogue: the NaN check of the last loss (the in-loop
        trap fires at log cadence only) and the last step's tile_overflow
        per branch, printed even without a writer."""
        if self.losses:
            loss = float(self.losses[-1])
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss {loss} at final step {self.global_step}"
                )
        if self._last_aux:
            report = {
                branch: float(a["tile_overflow"])
                for branch, a in self._last_aux.items()
                if "tile_overflow" in a
            }
            if report:
                print(
                    f"{self.work_dir}: stage-end tile_overflow "
                    + ", ".join(f"{b}={v:.4f}" for b, v in report.items())
                )

    def _maybe_control(self):
        """Density control at its cadence; returns the flags it ran with
        (None when no event fired)."""
        flags = control_flags(self.ocfg, self.global_step,
                              self.num_window_frames)
        if not flags or not (flags["do_densify"] or flags["do_cull"]
                             or flags["do_reset"]):
            return None
        self.state = apply_density_control(
            self.state, self.ocfg, num_frames=self.num_window_frames,
            only_fg=self.only_fg, bg_scene_scale=self.bg_scene_scale,
            **flags,
        )
        return flags

    def _log(self, loss, aux, step_time, any_batch):
        w = self.writer
        w.add_scalar("train/loss", loss, self.global_step)
        if any_batch is not None:
            B, H, W = any_batch.imgs.shape[:3]
            w.add_scalar("train/num_rays_per_sec",
                         H * W * B / max(step_time, 1e-6), self.global_step)
        for branch, a in aux.items():
            for k, v in a.items():
                if torch.is_tensor(v) and v.ndim == 0:
                    w.add_scalar(f"train/{branch}/{k}", float(v),
                                 self.global_step)
        w.add_scalar("train/num_fg_alive",
                     int(self.state.scene.fg.num_alive()), self.global_step)
        if self.state.scene.bg is not None:
            w.add_scalar("train/num_bg_alive",
                         int(self.state.scene.bg.num_alive()),
                         self.global_step)
