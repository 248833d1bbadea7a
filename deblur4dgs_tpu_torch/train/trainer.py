"""Trainer: the dynamic loss branch + one train step.

PyTorch port of deblur4dgs_tpu/train/trainer.py for the dynamic branch
(``has_dynamic=True``, no static or static-reg branch, no flow net, no
multires guide). The step renders the frame's full exposure window,
computes every dynamic loss, backpropagates once, applies the grouped Adam
update in place and accumulates density-control statistics.

Density statistics use the tap trick: a zeros leaf (``requires_grad``) is
added to every sub-frame's projected means2d; its ``.grad`` is
dL/d(means2d) per view.

Precision: make_train_step switches TF32 off for matmuls and cuDNN (the
reference's SSIM blur and track einsums are full float32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from deblur4dgs_tpu_torch.configs import (
    LossesConfig,
    OptimizerConfig,
    RenderConfig,
    SceneLRConfig,
)
from deblur4dgs_tpu_torch.models.scene import (
    SceneModel,
    compute_transforms,
    render,
)
from deblur4dgs_tpu_torch.ops.lie import _safe_norm
from deblur4dgs_tpu_torch.train import losses as L
from deblur4dgs_tpu_torch.train.optimizers import (
    SceneAdam,
    gate_move_pose_grads,
    make_optimizer,
)

class FrameBatch(NamedTuple):
    """A batch of B frames (device-resident)."""

    ts: torch.Tensor  # (B,) int32 frame indices (window-local)
    w2cs: torch.Tensor  # (B, 4, 4)
    Ks: torch.Tensor  # (B, 3, 3)
    imgs: torch.Tensor  # (B, H, W, 3)
    masks: torch.Tensor  # (B, H, W) fg masks
    valid_masks: torch.Tensor  # (B, H, W)
    depths: torch.Tensor  # (B, H, W)


class TrackBatch(NamedTuple):
    """2D-track supervision for one dynamic frame."""

    query_tracks_2d: torch.Tensor  # (P, 2) on-grid query pixels
    target_ts: torch.Tensor  # (Bt,)
    target_w2cs: torch.Tensor  # (Bt, 4, 4)
    target_Ks: torch.Tensor  # (Bt, 3, 3)
    target_tracks_2d: torch.Tensor  # (Bt, P, 2)
    target_visibles: torch.Tensor  # (Bt, P)
    target_confidences: torch.Tensor  # (Bt, P)
    target_track_depths: torch.Tensor  # (Bt, P)


class DensityStats(NamedTuple):
    """Running per-Gaussian stats over [fg_cap + bg_cap] slots."""

    grad_norm_acc: torch.Tensor
    vis_count: torch.Tensor
    max_radii: torch.Tensor


@dataclass
class TrainState:
    scene: SceneModel
    opt_state: Any
    step: int
    stats: DensityStats


def init_train_state(
    scene: SceneModel, lr_cfg: SceneLRConfig, optim_cfg: OptimizerConfig
) -> TrainState:
    opt = make_optimizer(scene, lr_cfg, optim_cfg)
    n = scene.num_fg + scene.num_bg
    dev = scene.fg.means.device
    return TrainState(
        scene=scene,
        opt_state=opt.init(scene),
        step=0,
        stats=DensityStats(
            grad_norm_acc=torch.zeros((n,), device=dev),
            vis_count=torch.zeros((n,), dtype=torch.int32, device=dev),
            max_radii=torch.zeros((n,), device=dev),
        ),
    )


def dilate_mask(mask: torch.Tensor, size: int = 9) -> torch.Tensor:
    """size x size max-pool dilation of an (H, W) mask (-inf padding)."""
    return F.max_pool2d(mask[None, None], size, stride=1,
                        padding=size // 2)[0, 0]


def downsample_area(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Area (average-pool) downsample of (H, W, C) by an integer factor."""
    H, W, C = img.shape
    Hc, Wc = H // factor, W // factor
    img = img[: Hc * factor, : Wc * factor]
    return img.reshape(Hc, factor, Wc, factor, C).mean(dim=(1, 3))


def rgb_l1_ssim(pred, gt, mask=None):
    """0.8*L1 + 0.2*(1-SSIM), optionally pre-multiplied by a mask.
    pred/gt: (B, H, W, 3); mask: (B, H, W, 1)."""
    if mask is not None:
        pred = pred * mask
        gt = gt * mask
    l1 = torch.mean(torch.abs(pred - gt))
    ssim_val = torch.stack([L.ssim(p, g) for p, g in zip(pred, gt)]).mean()
    return 0.8 * l1 + 0.2 * (1.0 - ssim_val)


def compute_dynamic_losses(
    scene: SceneModel,
    batch: FrameBatch,  # B == 1
    tracks: TrackBatch,
    taps: torch.Tensor,  # (1, S, N_all, 2)
    lcfg: LossesConfig,
    rcfg: RenderConfig,
    stage: str,
    epoch,
    num_window_frames: int,
    batch4_imgs: torch.Tensor | None = None,
    flow_fn=None,
):
    """Dynamic branch: full blurry render + tracks, depth, mask, motion and
    exposure regularizers. Returns (loss, aux dict)."""
    if batch4_imgs is not None or flow_fn is not None:
        raise NotImplementedError(
            "the multires guide and the exposure-consistency (flow) terms "
            "come with the other-loss-branches port slice"
        )
    _, H, W = batch.imgs.shape[:3]
    img_wh = (W, H)
    dev = batch.imgs.device

    t = batch.ts[0].to(torch.float32)
    out = render(
        scene, t, batch.w2cs[0], batch.Ks[0], img_wh,
        mode="blury", stage=stage,
        target_ts=tracks.target_ts.to(torch.float32),
        target_w2cs=tracks.target_w2cs,
        return_mask=True, return_depth=True, bg_color=1.0,
        num_exposure=rcfg.num_exposure, cap=rcfg.tile_cap,
        use_pallas=rcfg.use_pallas, means2d_tap=taps[0],
        bucketed=rcfg.bucketed,
        camera_mode=rcfg.camera_mode,
        max_tiles_per_gauss=rcfg.max_tiles_per_gauss,
        return_exposure_stack=False,
    )

    masks = (batch.masks * batch.valid_masks)[0]  # (H, W)
    valid = batch.valid_masks[0]
    bg_color = torch.ones((3,), device=dev)
    img_gt = batch.imgs[0] * valid[..., None] + (1 - valid[..., None]) * bg_color
    rendered = out["img"] * valid[..., None] + (1 - valid[..., None]) * bg_color

    mask_dilated = dilate_mask(masks)[..., None]
    rgb_dyn = rgb_l1_ssim(rendered[None], img_gt[None], mask_dilated[None])
    rgb_full = rgb_l1_ssim(rendered[None], img_gt[None])
    loss = (rgb_dyn + rgb_full) * lcfg.w_rgb

    mask_loss = torch.mean((out["acc"] - 1.0) ** 2) + L.masked_l1_loss(
        out["mask"], masks[..., None], quantile=0.98
    )
    loss = loss + mask_loss * lcfg.w_mask

    # 2D track loss, gathered at the on-grid query pixels before projecting.
    q = tracks.query_tracks_2d.to(torch.int32).long()  # (P, 2) x,y
    tr_at_q = out["tracks_3d"][q[:, 1], q[:, 0]]  # (P, Bt, 3)
    pred_2d_h = torch.einsum("bij,pbj->bpi", tracks.target_Ks, tr_at_q)
    # depth bounded at 1e-2 (the reference clamps at 1e-6)
    mapped_depth = torch.clamp(pred_2d_h[..., 2:], min=1e-2)  # (Bt, P, 1)
    pred_at_q = pred_2d_h[..., :2] / mapped_depth
    depth_at_q = mapped_depth[..., 0]

    frame_intervals = torch.abs(t - tracks.target_ts.to(torch.float32))
    w_interval = torch.exp(-2.0 * frame_intervals / num_window_frames)
    track_weights = tracks.target_confidences * w_interval[:, None]
    vis_w = track_weights * tracks.target_visibles

    track_2d_loss = L.masked_l1_loss(
        pred_at_q, tracks.target_tracks_2d, mask=vis_w, quantile=0.98
    ) / max(H, W)
    loss = loss + track_2d_loss * lcfg.w_track

    pred_disp = 1.0 / torch.clamp(out["depth"], min=1e-2)
    tgt_disp = 1.0 / torch.clamp(batch.depths[0][..., None], min=1e-2)
    depth_loss = L.masked_l1_loss(pred_disp, tgt_disp, mask=masks,
                                  quantile=0.98)
    loss = loss + depth_loss * lcfg.w_depth_reg

    mapped_depth_loss = L.masked_l1_loss(
        1.0 / depth_at_q[..., None],
        1.0 / torch.clamp(tracks.target_track_depths[..., None], min=1e-2),
        mask=vis_w,
    )
    loss = loss + mapped_depth_loss * lcfg.w_depth_const

    small_accel = L.compute_se3_smoothness_loss(
        scene.bases.rots, scene.bases.transls
    )
    loss = loss + small_accel * lcfg.w_smooth_bases

    # Track smoothness + z-accel over (t-1, t, t+1).
    tc = torch.clamp(t, 1, num_window_frames - 2)
    ts_nb = torch.stack([tc - 1, tc, tc + 1])
    coefs = scene.fg.get_coefs()
    transfms_nb = compute_transforms(scene.bases, ts_nb, coefs)  # (G, 3, 3, 4)
    means_h = torch.cat(
        [scene.fg.means, torch.ones_like(scene.fg.means[:, :1])], -1
    )
    means_nb = torch.einsum("gnij,gj->gni", transfms_nb, means_h)  # (G, 3, 3)
    accel = 2 * means_nb[:, 1:2] - means_nb[:, 0:1] - means_nb[:, 2:3]
    track_smooth = 0.5 * torch.mean(_safe_norm(accel))
    loss = loss + track_smooth * lcfg.w_smooth_tracks

    loss = loss + lcfg.w_scale_var * L.scale_variance_loss(
        scene.fg.scales, scene.fg.get_alive()
    )

    z_accel = L.compute_z_acc_loss(means_nb[:, :, None, :], batch.w2cs)
    loss = loss + lcfg.w_z_accel * z_accel

    # Exposure-time hinge. torch.maximum (not clamp) splits the gradient at
    # a tie like jnp.maximum: delta_t starts exactly at exposure_min.
    dt = out["delta_t"]
    zero = torch.zeros_like(dt)
    exp_reg = torch.maximum(zero, lcfg.exposure_min - dt) + torch.maximum(
        zero, dt - lcfg.exposure_max
    )
    loss = loss + exp_reg * lcfg.w_exposure_reg

    # Multi-resolution consistency against the (detached) blurry input.
    masks_down = downsample_area(masks[..., None], 4)
    sharp_down = downsample_area(out["pred_sharp_img"], 4) * masks_down
    blur_down = downsample_area(img_gt, 4) * masks_down
    loss = loss + lcfg.w_multires * torch.mean(
        torch.abs(sharp_down - blur_down.detach())
    )

    aux = {
        "radii": out["radii"][None],  # (B=1, S, N)
        "rgb_dyn": rgb_dyn,
        "rgb_full": rgb_full,
        "mapped_depth_loss": mapped_depth_loss,
        "mask_loss": mask_loss,
        "track_2d_loss": track_2d_loss,
        "depth_loss": depth_loss,
        "smooth_bases": small_accel,
        "track_smooth": track_smooth,
        "z_accel": z_accel,
        "exp_reg": exp_reg,
        "delta_t": dt,
        "tile_overflow": out["tile_overflow"],
    }
    return loss, aux


@torch.no_grad()
def accumulate_density_stats(
    stats: DensityStats,
    tap_grads: torch.Tensor,  # (B, S, N, 2) dL/d(means2d) per frame+view
    radii: torch.Tensor,  # (B, S, N)
    img_wh: tuple[int, int],
    slot_offset: int,
) -> DensityStats:
    """Per-view grad-norm / visibility / radius accumulation; grads are
    normalized to [-1, 1] screen space and scaled by B * S."""
    W, H = img_wh
    B, S, N = radii.shape
    scale = torch.tensor([W / 2.0, H / 2.0], device=radii.device) * (B * S)
    norms = torch.linalg.norm(tap_grads * scale, dim=-1)  # (B, S, N)
    vis = radii > 0
    acc = torch.where(vis, norms, torch.zeros_like(norms)).sum(dim=(0, 1))
    cnt = vis.sum(dim=(0, 1)).to(torch.int32)
    rmax = torch.where(vis, radii / max(W, H),
                       torch.zeros_like(radii)).amax(dim=(0, 1))
    sl = slice(slot_offset, slot_offset + N)
    grad_norm_acc = stats.grad_norm_acc.clone()
    vis_count = stats.vis_count.clone()
    max_radii = stats.max_radii.clone()
    grad_norm_acc[sl] += acc
    vis_count[sl] += cnt
    max_radii[sl] = torch.maximum(max_radii[sl], rmax)
    return DensityStats(grad_norm_acc, vis_count, max_radii)


def make_train_step(
    optimizer: SceneAdam,
    lcfg: LossesConfig,
    rcfg: RenderConfig,
    stage: str,
    num_window_frames: int,
    *,
    has_static: bool,
    has_dynamic: bool,
    has_reg: bool,
    has_batch4: bool = False,
    flow_fn=None,
    subframe_sharding=None,
    tile_mesh=None,
):
    """Build the train step for one branch combination. Only the dynamic
    branch alone is ported: ``step(state, epoch, None, batch_dyn, tracks,
    None, None) -> (state, loss, aux)`` updates ``state.scene`` in place."""
    if has_static or has_reg or not has_dynamic:
        raise NotImplementedError(
            "only has_dynamic=True with has_static=has_reg=False is ported; "
            "the static and static-reg branches come in a later slice"
        )
    if has_batch4 or flow_fn is not None:
        raise NotImplementedError(
            "the multires guide and flow_fn come in a later slice"
        )
    if subframe_sharding is not None or tile_mesh is not None:
        raise NotImplementedError("multi-device training is a later slice")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def step_fn(state: TrainState, epoch, batch_static, batch_dyn, tracks,
                batch_reg, batch4_imgs):
        scene = state.scene
        S = rcfg.num_exposure
        n_all = scene.num_fg + scene.num_bg
        dev = scene.fg.means.device
        tap = torch.zeros((1, S, n_all, 2), device=dev, requires_grad=True)
        scene.zero_grad(set_to_none=True)
        loss, aux = compute_dynamic_losses(
            scene, batch_dyn, tracks, tap, lcfg, rcfg, stage, epoch,
            num_window_frames,
        )
        loss.backward()
        grads = {
            n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in scene.named_parameters()
        }
        # MoveModel pose nets train only after exposure_cons_start_epoch.
        gate = float(int(epoch) > lcfg.exposure_cons_start_epoch)
        grads = gate_move_pose_grads(grads, gate)
        opt_state = optimizer.update(grads, state.opt_state, scene)
        scene.zero_grad(set_to_none=True)

        H, W = batch_dyn.imgs.shape[1:3]
        stats = accumulate_density_stats(
            state.stats, tap.grad, aux["radii"], (W, H), 0
        )
        aux = {k: v.detach() for k, v in aux.items()}
        new_state = TrainState(scene=scene, opt_state=opt_state,
                               step=state.step + 1, stats=stats)
        return new_state, loss.detach(), {"dynamic": aux}

    return step_fn
