"""Trainer: the three loss branches + one train step.

PyTorch port of deblur4dgs_tpu/train/trainer.py: the static branch
(bg-only blurry windows), the dynamic branch (with the multires guide) and
the static-reg branch (bg-only sharp 'mid' renders). The step runs the
branches it was built with, backpropagates their summed loss once, applies
the grouped Adam update in place and accumulates density-control
statistics. With ``flow_fn`` (models/pwcnet.py::make_aligned_loss_fn) the
dynamic branch adds the exposure-consistency term. 

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

from reference.configs import (
    LossesConfig,
    OptimizerConfig,
    RenderConfig,
    SceneLRConfig,
)
from reference.models.scene import (
    SceneModel,
    compute_transforms,
    render,
)
from reference.ops.lie import _safe_norm
from reference.train import losses as L
from reference.train.optimizers import (
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


def exposure_consistency_loss(imgs_s, masks_s, flow_fn):
    """Exposure sub-frame consistency (the reference's trainer.py:599-618).

    Each term is the flow-aligned L1 between a sub-frame pair, weighted by
    the flow validity mask and the detached rendered fg mask of the pair's
    target: sub-frame e against e + 1 for e < S - 1, then sub-frame e
    against the detached sub-frame 0 for e >= 1; the sum over the 2(S - 1)
    pairs is divided by S - 1. All pairs go through ``flow_fn`` as one
    batch.

    imgs_s: (S, H, W, 3) per-sub-frame renders; masks_s: (S, H, W, 1)
    per-sub-frame rendered fg masks; flow_fn(a, b) with a, b (N, H, W, 3)
    -> (aligned a, flow mask (N, H, W, 1)).
    """
    S = imgs_s.shape[0]
    first = imgs_s[0].detach().expand_as(imgs_s[1:])
    a = torch.cat([imgs_s[:-1], imgs_s[1:]])
    b = torch.cat([imgs_s[1:], first])
    m = torch.cat([masks_s[1:], masks_s[0].expand_as(masks_s[1:])]).detach()
    aligned, fmask = flow_fn(a, b)
    w = fmask * m
    per_pair = torch.mean(torch.abs(aligned * w - b * w), dim=(1, 2, 3))
    return per_pair.sum() / (S - 1)


def rgb_l1_ssim(pred, gt, mask=None):
    """0.8*L1 + 0.2*(1-SSIM), optionally pre-multiplied by a mask.
    pred/gt: (B, H, W, 3); mask: (B, H, W, 1)."""
    if mask is not None:
        pred = pred * mask
        gt = gt * mask
    l1 = torch.mean(torch.abs(pred - gt))
    ssim_val = torch.stack([L.ssim(p, g) for p, g in zip(pred, gt)]).mean()
    return 0.8 * l1 + 0.2 * (1.0 - ssim_val)


def _valid_blend(x, valid_masks):
    """Pixels outside the valid mask become the white background."""
    v = valid_masks[..., None]
    return x * v + (1.0 - v)


def _render_kw(rcfg: RenderConfig):
    return dict(num_exposure=rcfg.num_exposure, cap=rcfg.tile_cap,
                use_pallas=rcfg.use_pallas, bucketed=rcfg.bucketed,
                camera_mode=rcfg.camera_mode,
                max_tiles_per_gauss=rcfg.max_tiles_per_gauss)


def _tap(taps, b):
    return None if taps is None else taps[b]


def compute_static_losses(
    scene: SceneModel,
    batch: FrameBatch,
    taps: torch.Tensor | None,  # (B, S, N_bg, 2)
    lcfg: LossesConfig,
    rcfg: RenderConfig,
    stage: str,
):
    """Static branch: bg-only blurry renders of B frames (RGB outside the
    dilated fg mask, bounded disparities, their gradients, scale variance
    and, for B == 3, exposure-pose continuity, which the reference
    applies). Returns (loss, aux dict with per-view radii)."""
    B, H, W = batch.imgs.shape[:3]
    outs = [
        render(
            scene, batch.ts[b].to(torch.float32), batch.w2cs[b], batch.Ks[b],
            (W, H), mode="blury", stage=stage, bg_only=True,
            return_mask=True, return_depth=True, bg_color=1.0,
            means2d_tap=_tap(taps, b), return_exposure_stack=False,
            **_render_kw(rcfg),
        )
        for b in range(B)
    ]
    stack = lambda k: torch.stack([o[k] for o in outs])
    masks = batch.masks * batch.valid_masks
    imgs = _valid_blend(batch.imgs, batch.valid_masks)
    rendered = _valid_blend(stack("img"), batch.valid_masks)

    inv = 1.0 - torch.stack([dilate_mask(m) for m in masks])[..., None]
    rgb_loss = rgb_l1_ssim(rendered, imgs, inv)
    loss = rgb_loss * lcfg.w_rgb

    # depth bounded below: uncovered pixels have expected depth ~0
    pred_disp = 1.0 / torch.clamp(stack("depth"), min=1e-2)
    tgt_disp = 1.0 / torch.clamp(batch.depths[..., None], min=1e-2)
    depth_l1 = L.masked_l1_loss(pred_disp, tgt_disp, mask=inv[..., 0],
                                quantile=0.98)
    loss = loss + lcfg.w_depth_reg * depth_l1
    grad_l = torch.stack([
        L.compute_gradient_loss(pred_disp[b, ..., 0], tgt_disp[b, ..., 0],
                                inv[b, ..., 0] > 0.5, quantile=0.95)
        for b in range(B)
    ]).mean()
    loss = loss + lcfg.w_depth_grad * grad_l
    loss = loss + lcfg.w_scale_var * L.scale_variance_loss(
        scene.bg.scales, scene.bg.get_alive()
    )

    # Exposure-pose continuity across 3 consecutive frames (the reference
    # computes it and drops it by accident; the author's intent is kept).
    poses = stack("poses")  # (B, S, 3, 4)
    if B == 3:
        cont = torch.mean(torch.abs(poses[0, -1] - poses[1, 0])) + \
            torch.mean(torch.abs(poses[2, 0] - poses[1, -1]))
    else:
        cont = torch.zeros((), device=poses.device)
    loss = loss + cont

    aux = {
        "radii": stack("radii"),  # (B, S, N_bg)
        "rgb_loss": rgb_loss,
        "depth_l1": depth_l1,
        "depth_grad": grad_l,
        "pose_cont": cont,
        "tile_overflow": torch.mean(stack("tile_overflow")),
    }
    return loss, aux


def compute_static_reg_losses(
    scene: SceneModel,
    batch: FrameBatch,  # stage-1 deblurred bg renders as imgs
    taps: torch.Tensor | None,  # (B, 1, N_bg, 2)
    lcfg: LossesConfig,
    rcfg: RenderConfig,
    stage: str,
):
    """Static-reg branch: bg-only sharp 'mid' renders (the dense
    compositor) pulled toward the stage-1 outputs outside the dilated fg
    mask, plus scale variance."""
    B, H, W = batch.imgs.shape[:3]
    outs = [
        render(
            scene, batch.ts[b].to(torch.float32), batch.w2cs[b], batch.Ks[b],
            (W, H), mode="mid", stage=stage, bg_only=True, return_mask=True,
            return_depth=False, bg_color=1.0, means2d_tap=_tap(taps, b),
            **_render_kw(rcfg),
        )
        for b in range(B)
    ]
    masks = batch.masks * batch.valid_masks
    imgs = _valid_blend(batch.imgs, batch.valid_masks)
    rendered = _valid_blend(torch.stack([o["img"] for o in outs]),
                            batch.valid_masks)
    inv = 1.0 - torch.stack([dilate_mask(m) for m in masks])[..., None]
    loss = rgb_l1_ssim(rendered, imgs, inv) * lcfg.w_rgb
    loss = loss + lcfg.w_scale_var * L.scale_variance_loss(
        scene.bg.scales, scene.bg.get_alive()
    )
    return loss, {"radii": torch.stack([o["radii"] for o in outs])}


def compute_dynamic_losses(
    scene: SceneModel,
    batch: FrameBatch,  # B == 1
    tracks: TrackBatch,
    taps: torch.Tensor | None,  # (1, S, N_all, 2)
    lcfg: LossesConfig,
    rcfg: RenderConfig,
    stage: str,
    epoch,
    num_window_frames: int,
    batch4_imgs: torch.Tensor | None = None,  # (1, H/4, W/4, 3) guide
    flow_fn=None,
):
    """Dynamic branch: full blurry render + tracks, depth, mask, motion and
    exposure regularizers, and with ``flow_fn`` the exposure-consistency
    term (its epoch gate a multiplier, as the reference's). Returns (loss,
    aux dict)."""
    _, H, W = batch.imgs.shape[:3]
    img_wh = (W, H)

    t = batch.ts[0].to(torch.float32)
    out = render(
        scene, t, batch.w2cs[0], batch.Ks[0], img_wh,
        mode="blury", stage=stage,
        target_ts=tracks.target_ts.to(torch.float32),
        target_w2cs=tracks.target_w2cs,
        return_mask=True, return_depth=True, bg_color=1.0,
        means2d_tap=_tap(taps, 0), return_exposure_stack=flow_fn is not None,
        **_render_kw(rcfg),
    )

    masks = (batch.masks * batch.valid_masks)[0]  # (H, W)
    img_gt = _valid_blend(batch.imgs[0], batch.valid_masks[0])
    rendered = _valid_blend(out["img"], batch.valid_masks[0])

    mask_dilated = dilate_mask(masks)[..., None]
    rgb_dyn = rgb_l1_ssim(rendered[None], img_gt[None], mask_dilated[None])
    rgb_full = rgb_l1_ssim(rendered[None], img_gt[None])
    loss = (rgb_dyn + rgb_full) * lcfg.w_rgb

    if flow_fn is not None:
        cons = exposure_consistency_loss(
            out["exposure_imgs"], out["exposure_masks"], flow_fn)
        gate = float(int(epoch) > lcfg.exposure_cons_start_epoch)
        loss = loss + gate * (cons * lcfg.w_exposure_cons)

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

    # Multi-resolution consistency against the (detached) blurry input, or
    # against the multires guide once the epoch gate opens. The gate is a
    # multiplier, so a closed gate gives an exact zero gradient.
    masks_down = downsample_area(masks[..., None], 4)
    sharp_down = downsample_area(out["pred_sharp_img"], 4) * masks_down
    if batch4_imgs is None:
        blur_down = downsample_area(img_gt, 4) * masks_down
        loss = loss + lcfg.w_multires * torch.mean(
            torch.abs(sharp_down - blur_down.detach())
        )
    else:
        guide = batch4_imgs[0] * masks_down
        keep = torch.mean(torch.abs(sharp_down - guide.detach()))
        gate = float(int(epoch) > lcfg.exposure_cons_start_epoch)
        loss = loss + lcfg.w_multires * gate * keep

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
):
    """Build the train step for one branch combination:
    ``step(state, epoch, batch_static, batch_dyn, tracks, batch_reg,
    batch4_imgs) -> (state, loss, aux)``; ``state.scene`` is updated in
    place and aux holds one dict per branch that ran.

    Density statistics come from the last branch that ran, reg > dynamic >
    static, as in the reference (each branch overwrites the statistic the
    densifier reads); only that branch's render carries a means2d tap.
    """
    if not (has_static or has_dynamic or has_reg):
        raise ValueError("the step needs at least one loss branch")
    stats_branch = ("reg" if has_reg else "dynamic" if has_dynamic
                    else "static")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def step_fn(state: TrainState, epoch, batch_static, batch_dyn, tracks,
                batch_reg, batch4_imgs):
        scene = state.scene
        S = rcfg.num_exposure
        n_fg, n_bg = scene.num_fg, scene.num_bg
        dev = scene.fg.means.device
        tap_shape = {
            "static": lambda: (batch_static.imgs.shape[0], S, n_bg, 2),
            "dynamic": lambda: (1, S, n_fg + n_bg, 2),
            "reg": lambda: (batch_reg.imgs.shape[0], 1, n_bg, 2),
        }[stats_branch]()
        tap = torch.zeros(tap_shape, device=dev, requires_grad=True)
        taps = lambda name: tap if name == stats_branch else None

        scene.zero_grad(set_to_none=True)
        loss = 0.0
        aux = {}
        if has_static:
            l, aux["static"] = compute_static_losses(
                scene, batch_static, taps("static"), lcfg, rcfg, stage)
            loss = loss + l
        if has_dynamic:
            l, aux["dynamic"] = compute_dynamic_losses(
                scene, batch_dyn, tracks, taps("dynamic"), lcfg, rcfg, stage,
                epoch, num_window_frames,
                batch4_imgs=batch4_imgs if has_batch4 else None,
                flow_fn=flow_fn,
            )
            loss = loss + l
        if has_reg:
            l, aux["reg"] = compute_static_reg_losses(
                scene, batch_reg, taps("reg"), lcfg, rcfg, stage)
            loss = loss + l
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

        last = batch_reg if has_reg else batch_dyn if has_dynamic \
            else batch_static
        H, W = last.imgs.shape[1:3]
        stats = accumulate_density_stats(
            state.stats, tap.grad, aux[stats_branch]["radii"], (W, H),
            0 if stats_branch == "dynamic" else n_fg,
        )
        aux = {b: {k: v.detach() for k, v in a.items()}
               for b, a in aux.items()}
        new_state = TrainState(scene=scene, opt_state=opt_state,
                               step=state.step + 1, stats=stats)
        return new_state, loss.detach(), aux

    return step_fn
