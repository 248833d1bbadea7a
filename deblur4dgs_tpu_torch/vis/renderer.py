"""Viewer-facing renderer: a trained SceneModel behind a
(camera_state, img_wh, t) -> image callback.

PyTorch port of deblur4dgs_tpu/vis/renderer.py (the reference's
flow3d/renderer.py). A frame is one sharp mid-exposure render of stage
'second' (S = 1: the dense compositor K5, its plain twin on the CPU) on
the scene's device, under torch.inference_mode(): the viewer's HTTP
threads have grad mode on, and a render must build no graph over the
training leaves.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deblur4dgs_tpu_torch.models.scene import (
    SceneModel,
    compute_poses_fg,
    render,
)


@dataclass
class CameraState:
    """Matches nerfview's CameraState surface (fov, c2w)."""

    fov: float
    aspect: float
    c2w: np.ndarray  # (4, 4)


class Renderer:
    def __init__(self, scene: SceneModel | None, num_frames: int,
                 num_exposure: int = 11, cap: int = 512,
                 use_pallas: bool = True, num_tracks: int = 10):
        self.num_frames = num_frames
        self.num_exposure = num_exposure
        self.cap = cap
        self.use_pallas = use_pallas
        self.num_tracks = num_tracks
        self.set_scene(scene)

    def set_scene(self, scene: SceneModel | None):
        """Render ``scene`` from now on; the track cache is dropped (the
        port's train step changes a scene in place, so the scene object
        alone does not say whether its tracks moved)."""
        self.scene = scene
        self._tracks_3d = None

    @staticmethod
    def init_from_checkpoint(path: str, template_state, num_frames: int,
                             **kw) -> "Renderer":
        """A Renderer over the scene of a port checkpoint (one torch.save
        file, e.g. ``ckpts/<stage>/last``), loaded into template_state
        (train/checkpoints.py::template_state of the run's capacities, on
        the device to render on)."""
        from deblur4dgs_tpu_torch.train.checkpoints import load_checkpoint

        state, _ = load_checkpoint(path, template_state)
        return Renderer(state.scene, num_frames, **kw)

    def _device(self) -> torch.device:
        return self.scene.fg.means.device

    def _fg_tracks(self) -> np.ndarray:
        """(P, T, 3) world-space fg track positions over all frames
        (reference renderer.py:37-42: compute_poses_fg over arange(T) for a
        small index subset, cached until the scene is set again)."""
        if self._tracks_3d is None:
            alive = self.scene.fg.get_alive().cpu().numpy() > 0.5
            inds = np.nonzero(alive)[0]
            if inds.size == 0:
                inds = np.arange(min(self.num_tracks, self.scene.num_fg))
            inds = inds[: self.num_tracks]
            ts = torch.arange(self.num_frames, dtype=torch.float32,
                              device=self._device())
            with torch.inference_mode():
                means, _ = compute_poses_fg(self.scene, ts)  # (G, T, 3)
                self._tracks_3d = means[torch.as_tensor(
                    inds, device=means.device)].cpu().numpy()
        return self._tracks_3d

    def render_fn(self, camera_state: CameraState,
                  img_wh: tuple[int, int], t: int | None = 0,
                  render_tracks: bool = False) -> np.ndarray:
        """Single sharp render for the viewer (renderer.py:57-89 /
        trainer.py:180-201 semantics): (H, W, 3) uint8. render_tracks
        overlays the fg 2D track trails (renderer.py:83-88: the last 20
        frames of the cached tracks through K @ w2c, drawn on the host)."""
        W, H = img_wh
        dev = self._device()
        focal = 0.5 * H / np.tan(0.5 * camera_state.fov)
        K = np.asarray([[focal, 0.0, W / 2.0], [0.0, focal, H / 2.0],
                        [0.0, 0.0, 1.0]], np.float32)
        w2c = np.linalg.inv(camera_state.c2w.astype(np.float32))
        with torch.inference_mode():
            out = render(
                self.scene, t, torch.as_tensor(w2c, device=dev),
                torch.as_tensor(K, device=dev), (W, H), mode="mid",
                stage="second", num_exposure=self.num_exposure,
                cap=self.cap, use_pallas=self.use_pallas,
            )
            img = torch.clamp(out["img"], 0, 1).cpu().numpy()
        if render_tracks and t is not None:
            from deblur4dgs_tpu_torch.vis.utils import draw_tracks_2d

            tr = self._fg_tracks()[:, max(0, t - 20): max(1, t)]  # (P,n,3)
            Kw = K @ w2c[:3]  # (3, 4)
            xyz1 = np.concatenate([tr, np.ones_like(tr[..., :1])], axis=-1)
            p = np.einsum("ij,ptj->pti", Kw, xyz1)
            tracks_2d = p[..., :2] / np.maximum(p[..., 2:], 1e-6)
            img = draw_tracks_2d(img, tracks_2d, num_trail=tr.shape[1])
        return (img * 255).astype(np.uint8)
