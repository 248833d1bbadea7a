"""Scene model: composed fg/bg Gaussians + motion bases + exposure model.

PyTorch port of deblur4dgs_tpu/models/scene.py. ``render`` samples the
learned exposure window (S sub-frame residual poses + times; S = 1 for the
sharp modes 'mid' / 'start' / 'end'), deforms the canonical Gaussians to
every sub-frame time and projects all S sub-frames at once. Then one of
four compositing paths, as in the reference:
  * S > 1, shared binning, bucketed, >= 64 tiles: one binning sort for the
    window, count-sorted tile buckets, the window compositor (K1, K2/K3)
    in tile space (ops/rasterize.py::composite_window_buckets);
  * S > 1, shared binning, under 64 tiles or bucketed=False: the same
    sort as dense tile lists, one payload gather for the window, and the
    split compositor (K4) per sub-frame (rasterize_split);
  * S = 1, or per-sub-frame binning: each view binned and composited on
    its own by the dense compositor (K5) (rasterize).
The per-sub-frame paths accumulate the exposure reductions in an unrolled
loop, as the reference's single-chip path does. ``use_pallas=False``
composites every path with the reference's plain compositors without the
early stop (ops/rasterize.py::composite_*_nostop) instead of the kernels.

Channel multiplexing matches the reference: [RGB(3) | mask(1)? |
tracks(3B)? | depth(1)?] composited in one pass; blurry mask = max over
sub-frames, blurry depth = min over sub-frames, everything else = mean.
"""

from __future__ import annotations

import torch
from torch import nn

from reference.models.gaussians import Gaussians
from reference.models.motion_bases import (
    MotionBases,
    compute_transforms,
    transform_gaussians,
)
from reference.models.move_model import MoveModel, exposure_samples
from reference.ops import lie
from reference.ops.projection import Projected, project
from reference.ops.rasterize import (
    composite_window_buckets,
    rasterize,
    rasterize_split,
)
from reference.ops.tiling import (
    TILE_BLOCK,
    bin_gaussians_union,
    bin_gaussians_union_runs,
    bucket_tiles_from_runs,
    default_bucket_spec,
    num_tiles,
    pack_dyn_all,
    pack_static,
    pack_window_fused,
    packed_dyn_table,
    packed_static_table,
)

BLUR_NUM_CAMERAS = 11  # exposure sub-frames


class SceneModel(nn.Module):
    def __init__(self, fg: Gaussians, bg: Gaussians | None,
                 bases: MotionBases, move: MoveModel):
        super().__init__()
        self.fg = fg
        self.bg = bg
        self.bases = bases
        self.move = move

    @property
    def has_bg(self) -> bool:
        return self.bg is not None

    @property
    def num_fg(self) -> int:
        return self.fg.capacity

    @property
    def num_bg(self) -> int:
        return self.bg.capacity if self.bg is not None else 0


def compute_poses_fg(scene: SceneModel, ts: torch.Tensor):
    """Deformed fg means/quats at times ts: (G, B, 3), (G, B, 4)."""
    coefs = scene.fg.get_coefs()
    transfms = compute_transforms(scene.bases, ts, coefs)
    return transform_gaussians(transfms, scene.fg.means, scene.fg.get_quats())


def compute_poses_all(scene: SceneModel, ts: torch.Tensor):
    """fg (deformed) then bg (static), broadcast over B times."""
    means, quats = compute_poses_fg(scene, ts)
    if scene.has_bg:
        B = means.shape[1]
        bg_means = scene.bg.means[:, None].expand(scene.num_bg, B, 3)
        bg_quats = scene.bg.get_quats()[:, None].expand(scene.num_bg, B, 4)
        means = torch.cat([means, bg_means], dim=0)
        quats = torch.cat([quats, bg_quats], dim=0)
    return means, quats


def _gather_set(scene: SceneModel, fg_only: bool, bg_only: bool):
    """Activated static params for the selected Gaussian set (fg first)."""
    if fg_only or bg_only or scene.bg is None:
        g = scene.bg if bg_only else scene.fg
        return g.get_scales(), g.get_opacities(), g.get_colors(), g.get_alive()
    fg, bg = scene.fg, scene.bg
    return (
        torch.cat([fg.get_scales(), bg.get_scales()], 0),
        torch.cat([fg.get_opacities(), bg.get_opacities()], 0),
        torch.cat([fg.get_colors(), bg.get_colors()], 0),
        torch.cat([fg.get_alive(), bg.get_alive()], 0),
    )


def _window_poses(scene, times, fg_only, bg_only):
    """World-space means/quats of the selected set at each of the S
    sub-frame times: (S, N, 3), (S, N, 4)."""
    S = times.shape[0]
    if bg_only:
        m, q = scene.bg.means, scene.bg.get_quats()
        return m[None].expand(S, -1, -1), q[None].expand(S, -1, -1)
    fn = compute_poses_fg if fg_only else compute_poses_all
    m, q = fn(scene, times)  # (N, S, 3), (N, S, 4)
    return m.transpose(0, 1), q.transpose(0, 1)


def render(
    scene: SceneModel,
    t,  # frame index (None => canonical, no deformation)
    w2c: torch.Tensor,  # (4, 4)
    K: torch.Tensor,  # (3, 3)
    img_wh: tuple[int, int],
    *,
    mode: str = "blury",
    stage: str = "second",
    fg_only: bool = False,
    bg_only: bool = False,
    target_ts: torch.Tensor | None = None,  # (B,) track supervision times
    target_w2cs: torch.Tensor | None = None,  # (B, 4, 4)
    bg_color: float | torch.Tensor = 1.0,
    return_mask: bool = False,
    return_depth: bool = False,
    num_exposure: int = BLUR_NUM_CAMERAS,
    cap: int = 512,
    use_pallas: bool = True,
    means2d_tap: torch.Tensor | None = None,  # (S, N, 2) leaf, requires_grad
    shared_exposure_binning: bool = True,
    bucketed: bool = True,
    return_exposure_stack: bool = True,
    camera_mode: str = "linear",
    max_tiles_per_gauss: int = 32,
) -> dict:
    """Render one frame: the mean of S exposure sub-frames ('blury') or
    one sharp sub-frame ('mid' / 'start' / 'end').

    ``means2d_tap`` is added to every sub-frame's projected means2d; pass a
    zeros leaf with ``requires_grad=True`` and its ``.grad`` after backward
    is dL/d(means2d) per sub-frame (the density-control statistic).
    ``tile_overflow`` is NaN on the paths that do not measure it (S = 1,
    per-sub-frame binning), as in the reference.
    """
    assert not (fg_only and bg_only)
    W, H = img_wh
    tiles_x, tiles_y = num_tiles(img_wh)
    if mode not in ("blury", "mid", "start", "end"):
        raise ValueError(f"unknown render mode {mode!r}")
    dev = w2c.device

    scales, opacities, colors, alive = _gather_set(scene, fg_only, bg_only)
    N = scales.shape[0]

    # --- exposure window ---------------------------------------------------
    samples = exposure_samples(
        scene.move, w2c, 0.0 if t is None else t, num_exposure, stage=stage,
        mode="uniform" if mode == "blury" else mode, camera_mode=camera_mode,
    )
    S = samples.poses.shape[0]

    # --- constant channel payload -----------------------------------------
    chans = [colors]
    layout = {"img": 3}
    if return_mask:
        if fg_only or bg_only:
            maskv = torch.ones((N, 1), device=dev)
        else:
            maskv = torch.cat([torch.ones((scene.num_fg, 1), device=dev),
                               torch.zeros((scene.num_bg, 1), device=dev)], 0)
        chans.append(maskv)
        layout["mask"] = 1
    B = 0
    if target_ts is not None:
        B = target_ts.shape[0]
        if fg_only:
            tmeans, _ = compute_poses_fg(scene, target_ts)
        else:
            tmeans, _ = compute_poses_all(scene, target_ts)  # (N, B, 3)
        if target_w2cs is not None:
            # camera-space track targets
            tmeans = torch.einsum(
                "bij,nbj->nbi",
                target_w2cs[:, :3, :],
                torch.cat([tmeans, torch.ones_like(tmeans[..., :1])], -1),
            )
        chans.append(tmeans.reshape(N, B * 3))
        layout["tracks_3d"] = B * 3
    const_chans = torch.cat(chans, dim=-1)
    if return_depth:
        layout["depth"] = 1
    D = sum(layout.values())

    if isinstance(bg_color, (int, float)):
        bgvec = torch.full((3,), float(bg_color), device=dev)
    else:
        bgvec = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    background = torch.cat([bgvec, torch.zeros((D - 3,), device=dev)])

    # --- project every sub-frame ------------------------------------------
    if t is None:
        times = torch.zeros((S,), device=dev)
    else:
        times = samples.times
    means_w, quats_w = _window_poses(scene, times, fg_only, bg_only)
    # residual exposure pose applied in world space
    means_w = lie.pose_apply(samples.poses[:, None], means_w)
    projs = project(means_w, quats_w, scales, w2c, K, img_wh, aux_mask=alive)
    if means2d_tap is not None:
        projs = projs._replace(means2d=projs.means2d + means2d_tap)

    tile_overflow = torch.full((), float("nan"), device=dev)
    if (shared_exposure_binning and S > 1 and bucketed
            and tiles_x * tiles_y >= 64):
        # --- shared binning + count-sorted buckets ------------------------
        rank_sorted, starts, _, raw, order = bin_gaussians_union_runs(
            projs, img_wh, cap, max_tiles_per_gauss=max_tiles_per_gauss,
        )
        spec = default_bucket_spec(tiles_x * tiles_y, cap)
        buckets = bucket_tiles_from_runs(rank_sorted, starts, raw, N, spec,
                                         pad_multiple=TILE_BLOCK)
        # Fraction of tile-Gaussian intersections dropped by capacity
        # truncation.
        kept = sum(c.sum() for c in buckets.counts)
        tile_overflow = 1.0 - kept.float() / torch.clamp(raw.sum(),
                                                         min=1).float()
        # Combined dyn+static payload table: one gather per bucket (and one
        # scatter-add in the backward).
        tbl = torch.cat(
            [
                packed_dyn_table(projs, order, return_depth),
                packed_static_table(opacities, const_chans, order),
            ],
            dim=1,
        )
        Fd = 7 if return_depth else 6
        packed_lists = [pack_window_fused(gi, tbl, S, Fd)
                        for gi in buckets.gather_idx]
        window_out = composite_window_buckets(
            buckets, [p[1] for p in packed_lists], [p[0] for p in packed_lists],
            background, img_wh,
            include_depth=return_depth,
            mask_channel=3 if return_mask else None,
            use_pallas=use_pallas,
            stack_subframes=return_exposure_stack,
            stack_mask=return_exposure_stack and return_mask,
        )
    else:
        if shared_exposure_binning and S > 1:
            # One sort for the window as dense tile lists; the static
            # payload and every sub-frame's screen rows gathered once.
            shared = bin_gaussians_union(
                projs, img_wh, cap, max_tiles_per_gauss=max_tiles_per_gauss,
            )
            tile_overflow = 1.0 - shared[1].sum().float() / torch.clamp(
                shared[2].sum(), min=1).float()
            st_data = pack_static(opacities, const_chans, shared[0],
                                  shared[3])
            dyn_all = pack_dyn_all(projs, shared[0], shared[3], return_depth)

            def composite(s):
                return rasterize_split(
                    st_data, dyn_all[s], shared[1], background, img_wh,
                    include_depth=return_depth, use_pallas=use_pallas,
                )
        else:

            def composite(s):
                return _composite_view(
                    Projected(*(x[s] for x in projs)), opacities,
                    const_chans, background, img_wh, cap, use_pallas,
                    return_depth)

        window_out = _accumulate_subframes(composite, S, (H, W, D), dev,
                                           return_mask, return_depth)

    avg = window_out["sum_img"] / S
    acc = window_out["sum_alpha"] / S
    rgb_stack = window_out["rgb_stack"]

    out = {}
    off = 0
    for name, dim in layout.items():
        x = avg[..., off : off + dim]
        off += dim
        if name == "mask":
            x = window_out["max_mask"]
        elif name == "depth":
            x = window_out["min_depth"]
        elif name == "tracks_3d":
            x = x.reshape(H, W, B, 3)
        out[name] = x
    out["acc"] = acc[..., None]
    out["delta_t"] = samples.delta_t
    out["poses"] = samples.poses
    out["times"] = samples.times
    full_stack = rgb_stack.shape[0] == S
    out["pred_sharp_img"] = rgb_stack[S // 2 if full_stack else 0]
    out["exposure_imgs"] = rgb_stack if return_exposure_stack else None
    out["exposure_alphas"] = (
        window_out["alpha_stack"] if return_exposure_stack else None
    )
    out["exposure_masks"] = (
        window_out["mask_stack"]
        if (return_exposure_stack and return_mask) else None
    )
    out["radii"] = projs.radii  # (S, N) per-sub-frame screen radii
    out["tile_overflow"] = tile_overflow
    return out


def _composite_view(proj, opacities, const_chans, background, img_wh, cap,
                    use_pallas, return_depth):
    """One view binned and composited on its own (K5): (img (H, W, D),
    alpha (H, W)); the depth channel is still the alpha-weighted sum."""
    ch = const_chans
    if return_depth:
        ch = torch.cat([ch, proj.depths[:, None]], dim=-1)
    img, alpha, _ = rasterize(proj, opacities, ch, background, img_wh,
                              cap=cap, use_pallas=use_pallas)
    return img, alpha


def _expected_depth(img, alpha):
    """The depth channel normalized by alpha (gsplat's RGB+ED)."""
    dch = img[..., -1:] / torch.clamp(alpha[..., None], min=1e-10)
    return torch.cat([img[..., :-1], dch], dim=-1)


def _accumulate_subframes(composite, S, hwd, dev, return_mask,
                          return_depth):
    """The reference's unrolled per-sub-frame accumulate loop over
    ``composite(s) -> (img (H, W, D), alpha (H, W))``: sum of images and
    alphas, max of the mask channel, min of the expected depth (the depth
    channel normalized by alpha), and per-sub-frame rgb / alpha / mask
    stacks. Same keys as composite_window_buckets."""
    H, W, D = hwd
    sum_img = torch.zeros((H, W, D), device=dev)
    sum_alpha = torch.zeros((H, W), device=dev)
    max_mask = torch.full((H, W, 1), -float("inf"), device=dev)
    min_depth = torch.full((H, W, 1), float("inf"), device=dev)
    rgbs, alphas, masks = [], [], []
    for s in range(S):
        img, alpha = composite(s)
        if return_depth:
            img = _expected_depth(img, alpha)
        sum_img = sum_img + img
        sum_alpha = sum_alpha + alpha
        if return_mask:
            max_mask = torch.maximum(max_mask, img[..., 3:4])
            masks.append(img[..., 3:4])
        if return_depth:
            min_depth = torch.minimum(min_depth, img[..., -1:])
        rgbs.append(img[..., :3])
        alphas.append(alpha)
    return {
        "sum_img": sum_img,
        "sum_alpha": sum_alpha,
        "max_mask": max_mask if return_mask else None,
        "min_depth": min_depth if return_depth else None,
        "rgb_stack": torch.stack(rgbs),
        "alpha_stack": torch.stack(alphas),
        "mask_stack": torch.stack(masks) if return_mask else None,
    }
