"""Validator: offline evaluation + test-time camera pose refinement.

PyTorch port of deblur4dgs_tpu/eval/validator.py. The pose refinement
(make_pose_opt_fn) learns an *unconstrained* 3x3 residual rotation,
starting at the identity and never projected to SO(3), and a translation,
starting at zero, on top of w2c: w2c_t = [R @ w2c_R | T + w2c_t]. Each of
its iterations renders the sharp mid-exposure frame (one forward and one
backward of the dense compositor K5 on the card), takes the L1 loss
mean(|img - gt|) over the whole image and makes one Adam step with the
cosine schedule (optax adam: the rate at the pre-increment count, so the
first step uses lr). The reference runs the iterations as one jitted
lax.scan; here they are a plain loop, and only R and T are
differentiated (torch.autograd.grad), never the scene's parameters.

Inputs may be tensors or numpy arrays; they go to the scene's device at
this boundary. Images are written as 8-bit PNGs through vis/png.py (the
standard library alone), the files the reference writes with imageio.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable

import numpy as np
import torch

from deblur4dgs_tpu_torch.eval import metrics as M
from deblur4dgs_tpu_torch.models.scene import SceneModel, render
from deblur4dgs_tpu_torch.train.losses import abs_ref
from deblur4dgs_tpu_torch.train.optimizers import (
    GroupSpec,
    GroupState,
    _cosine_schedule,
    adam_apply,
)
from deblur4dgs_tpu_torch.vis.png import write_png


def _scene_device(scene: SceneModel) -> torch.device:
    return scene.fg.means.device


def _on(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _refined_w2c(w2c, R, T):
    """[R @ w2c[:3, :3] | T + w2c[:3, 3]] over the row (0, 0, 0, 1)."""
    top = torch.cat([R @ w2c[:3, :3], (T + w2c[:3, 3])[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=w2c.device)
    return torch.cat([top, bottom], dim=0)


def make_pose_opt_fn(
    img_wh: tuple[int, int],
    num_iters: int = 500,
    lr: float = 1e-2,
    eta_min: float = 1e-4,
    num_exposure: int = 11,
    cap: int = 512,
    use_pallas: bool = True,
):
    """Build a (scene, t, w2c, K, gt_img) -> (img, refined_w2c, losses
    (num_iters,)) test-time pose refiner."""

    def render_with(scene, t, w2c, K, R, T):
        w2c_t = _refined_w2c(w2c, R, T)
        out = render(
            scene, t, w2c_t, K, img_wh, mode="mid", stage="second",
            num_exposure=num_exposure, cap=cap, use_pallas=use_pallas,
        )
        return out["img"], w2c_t

    def pose_opt(scene, t, w2c, K, gt_img):
        dev = _scene_device(scene)
        t = float(t)
        w2c, K, gt_img = (_on(x, dev) for x in (w2c, K, gt_img))
        params = {"R": torch.eye(3, device=dev, requires_grad=True),
                  "T": torch.zeros(3, device=dev, requires_grad=True)}
        spec = GroupSpec(_cosine_schedule(lr, eta_min, num_iters))
        gs = GroupState(mu={k: torch.zeros_like(p) for k, p in params.items()},
                        nu={k: torch.zeros_like(p) for k, p in params.items()})
        losses = []
        for _ in range(num_iters):
            img, _ = render_with(scene, t, w2c, K, params["R"], params["T"])
            loss = torch.mean(abs_ref(img - gt_img))
            gR, gT = torch.autograd.grad(loss, [params["R"], params["T"]])
            losses.append(loss.detach())
            with torch.no_grad():
                adam_apply(spec, gs, {"R": gR, "T": gT}, params)
        with torch.no_grad():
            img, w2c_t = render_with(scene, t, w2c, K, params["R"],
                                     params["T"])
        return img, w2c_t, torch.stack(losses)

    return pose_opt


class Validator:
    """Streaming evaluation over a val set."""

    def __init__(
        self,
        scene: SceneModel,
        save_dir: str | None = None,
        has_bg: bool = True,
        lpips_fn: Callable | None = None,
    ):
        self.scene = scene
        self.save_dir = save_dir
        self.has_bg = has_bg
        self.lpips_fn = lpips_fn
        self.reset_metrics()

    def reset_metrics(self):
        """Fresh metric accumulators (a stage reuses one Validator across
        its mid-training validations)."""
        self.psnr = M.mPSNR()
        self.ssim = M.mSSIM()
        self.fg_psnr = M.mPSNR()
        self.fg_ssim = M.mSSIM()
        self.bg_psnr = M.mPSNR()
        self.bg_ssim = M.mSSIM()
        self.lpips_scores: list[float] = []

    @torch.no_grad()
    def _render_sharp(self, t, w2c, K, img_wh, num_exposure, cap,
                      use_pallas, return_depth=False, return_mask=False,
                      bg_only=False):
        dev = _scene_device(self.scene)
        return render(
            self.scene, float(t), _on(w2c, dev), _on(K, dev), img_wh,
            mode="mid", stage="second", num_exposure=num_exposure, cap=cap,
            use_pallas=use_pallas, return_depth=return_depth,
            return_mask=return_mask, bg_only=bg_only,
        )

    def _save(self, subdir, name, img):
        if self.save_dir is None:
            return
        d = osp.join(self.save_dir, "results", subdir)
        os.makedirs(d, exist_ok=True)
        img = img.detach().cpu().numpy() if torch.is_tensor(img) else img
        write_png(
            osp.join(d, f"{name}.png"),
            (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8),
        )

    @torch.no_grad()
    def update_metrics(self, pred, gt, fg_mask, valid_mask):
        dev = pred.device
        gt, fg_mask, valid_mask = (_on(x, dev) for x in
                                   (gt, fg_mask, valid_mask))
        fg_valid = fg_mask * valid_mask
        bg_valid = (1 - fg_mask) * valid_mask
        main = valid_mask if self.has_bg else fg_valid
        self.psnr.update(pred, gt, main)
        self.ssim.update(pred, gt, main)
        if self.lpips_fn is not None:
            self.lpips_scores.append(float(
                self.lpips_fn(pred * main[..., None], gt * main[..., None])))
        if self.has_bg:
            self.fg_psnr.update(pred, gt, fg_valid)
            self.fg_ssim.update(pred, gt, fg_valid)
            self.bg_psnr.update(pred, gt, bg_valid)
            self.bg_ssim.update(pred, gt, bg_valid)

    def validate_frame(
        self, t, w2c, K, gt_img, fg_mask, valid_mask, img_wh,
        frame_name="frame", num_exposure=11, cap=512, use_pallas=True,
        subdir="rgb_deblur_mid", bg_only=False,
    ):
        """Sharp mid-exposure render + metrics. bg_only renders without
        the fg Gaussians (the static stage's validation)."""
        out = self._render_sharp(
            t, w2c, K, img_wh, num_exposure, cap, use_pallas,
            bg_only=bg_only,
        )
        self.update_metrics(out["img"], gt_img, fg_mask, valid_mask)
        self._save(subdir, f"{frame_name}_img", out["img"])
        return out

    def validate_frame_with_pose_opt(
        self, pose_opt_fn, t, w2c, K, gt_img, fg_mask, valid_mask,
        frame_name="frame", subdir="rgb_test_optim", with_metrics=True,
    ):
        """Refined render + metrics. with_metrics=False still renders and
        saves (only held-out frames are scored)."""
        img, w2c_t, losses = pose_opt_fn(self.scene, t, w2c, K, gt_img)
        if with_metrics:
            self.update_metrics(img, gt_img, fg_mask, valid_mask)
        self._save(subdir, frame_name, img)
        self._save(subdir, f"{frame_name}_gt", gt_img)
        return img, w2c_t, losses

    @torch.no_grad()
    def validate_keypoints(
        self, t, w2c, K, target_t, target_w2c, target_K, keypoints_2d,
        target_keypoints_2d, img_wh, pck_threshold_ratio=0.05,
        num_exposure=11, cap=512, use_pallas=True,
    ):
        """PCK via rendered tracks_3d channels: render time t with
        target_ts=[target_t], read the camera-space track positions at the
        query keypoints, project by target_K, and score against the target
        keypoints."""
        W, H = img_wh
        dev = _scene_device(self.scene)
        target_w2c, target_K = _on(target_w2c, dev), _on(target_K, dev)
        out = render(
            self.scene, float(t), _on(w2c, dev), _on(K, dev), img_wh,
            mode="mid", stage="second",
            target_ts=torch.tensor([float(target_t)], device=dev),
            target_w2cs=target_w2c[None],
            num_exposure=num_exposure, cap=cap, use_pallas=use_pallas,
        )
        q = torch.as_tensor(keypoints_2d, device=dev).to(torch.int32).long()
        tracks = out["tracks_3d"][q[:, 1], q[:, 0], 0]  # (P, 3) cam space
        uvz = (target_K @ tracks.T).T
        pred_2d = uvz[:, :2] / torch.clamp(uvz[:, 2:], min=1e-6)
        thr = pck_threshold_ratio * max(W, H)
        return M.compute_pck(pred_2d, _on(target_keypoints_2d, dev), thr)

    def save_train_videos(
        self, dataset, epoch: int, fps: float = 10.0, num_exposure=11,
        cap=512, use_pallas=True,
    ):
        """rgb / depth / mask training-view videos."""
        if self.save_dir is None:
            return
        from deblur4dgs_tpu_torch.vis.utils import (
            apply_depth_colormap,
            save_video,
        )

        W, H = dataset.get_img_wh()
        rgbs, depths, masks = [], [], []
        for i in range(len(dataset)):
            out = self._render_sharp(
                i, dataset.w2cs[i], dataset.Ks[i], (W, H), num_exposure,
                cap, use_pallas, return_depth=True, return_mask=True,
            )
            out = {k: out[k].cpu().numpy()
                   for k in ("img", "depth", "acc", "mask")}
            rgbs.append(out["img"])
            depths.append(apply_depth_colormap(out["depth"][..., 0],
                                               out["acc"][..., 0]))
            masks.append(np.repeat(out["mask"], 3, axis=-1))
        d = osp.join(self.save_dir, "results", "videos")
        os.makedirs(d, exist_ok=True)
        for name, frames in (("rgb", rgbs), ("depth", depths),
                             ("mask", masks)):
            save_video(
                osp.join(d, f"{name}_{epoch}.mp4"), np.stack(frames), fps=fps
            )

    def compute(self) -> dict:
        out = {
            "val/psnr": self.psnr.compute(),
            "val/ssim": self.ssim.compute(),
        }
        if self.lpips_scores:
            out["val/lpips"] = float(np.mean(self.lpips_scores))
        if self.has_bg and len(self.fg_psnr):
            out.update(
                {
                    "val/fg_psnr": self.fg_psnr.compute(),
                    "val/fg_ssim": self.fg_ssim.compute(),
                    "val/bg_psnr": self.bg_psnr.compute(),
                    "val/bg_ssim": self.bg_ssim.compute(),
                }
            )
        return out
