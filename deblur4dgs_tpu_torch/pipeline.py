"""Staged training pipeline: train_low in a single process.

PyTorch port of deblur4dgs_tpu/pipeline.py (the reference's train_low.py
with run_training_static.py, run_training_dynamic.py, run_testing.py and
run_compute_metrics.py). The stages are function calls over in-memory
scenes; each writes its checkpoint (one torch.save file) so that a rerun
resumes:

  stage 1  train_static_stage:   bg + camera-motion predictor, blurry mode
  stage 2  train_dynamic_stage:  fg dynamics + exposure times
           phase A: 4x downsampled, full clip; phase B: adaptive windows
  stage 3  run_testing_windows:  per-window test-time pose refinement
  stage 4  compute_scene_metrics: PSNR / SSIM (/ LPIPS) on held-out frames

Where the port differs in form from the JAX package:
  * every entry point runs on ``cfg.device`` ("cuda" unless the caller asks
    for the CPU; no silent fallback);
  * the port's train step updates the scene in place, so each stage clones
    the scene it is given (the JAX package copies it because its jitted
    step donates buffers): a stage never writes into another's scene;
  * ``cfg.render.use_pallas`` (the CLI's ``--no-pallas`` clears it) picks
    the compositors of every render: the kernels on the card (their plain
    twins on CPU tensors), or the reference's plain compositors without
    the early stop (ops/rasterize.py::composite_*_nostop) on cfg.device;
  * images are written and read as PNGs through vis/png.py.
The host random streams are the reference's (numpy default_rng(seed) for
stage 1, seed + 1 for stage 2, replayed on resume), so both packages
train on the same frames.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import os.path as osp
from dataclasses import dataclass, field

import numpy as np
import torch

from deblur4dgs_tpu_torch import resolve_device
from deblur4dgs_tpu_torch.configs import (
    LossesConfig,
    OptimizerConfig,
    RenderConfig,
    SceneLRConfig,
)
from deblur4dgs_tpu_torch.eval.validator import Validator, make_pose_opt_fn
from deblur4dgs_tpu_torch.models.gaussians import Gaussians, pad_to_capacity
from deblur4dgs_tpu_torch.models.move_model import init_move_model
from deblur4dgs_tpu_torch.models.scene import SceneModel, render
from deblur4dgs_tpu_torch.train import init as I
from deblur4dgs_tpu_torch.train.checkpoints import (
    lift_static_stage,
    load_checkpoint,
    save_checkpoint,
)
from deblur4dgs_tpu_torch.train.loop import (
    TrainLoop,
    stack_frame_batch,
    track_batch_from_item,
)
from deblur4dgs_tpu_torch.train.optimizers import make_optimizer
from deblur4dgs_tpu_torch.train.trainer import (
    downsample_area,
    init_train_state,
)

# ---------------------------------------------------------------------------
# Adaptive windowing (run_training_dynamic.py:58-105)
# ---------------------------------------------------------------------------


def compute_sharpness_scores(imgs: np.ndarray,
                             masks: np.ndarray) -> np.ndarray:
    """Masked Laplacian-variance sharpness per frame.

    imgs: (T, H, W, 3) in [0, 1]; masks: (T, H, W)."""
    import scipy.ndimage as ndi

    lap_kernel = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float64)
    scores = []
    for img, mask in zip(imgs, masks):
        gray = np.mean(img * 255.0, -1) * mask
        lp = ndi.convolve(gray, lap_kernel, mode="nearest")
        inter = lp - lp.sum() / max(mask.sum(), 1e-6)
        scores.append(float((inter * inter).sum() / max(mask.sum(), 1e-6)))
    return np.array(scores)


def adaptive_slides(scores: np.ndarray, num_windows: int = 5, base: int = 5):
    """Extend fixed windows toward their sharpest neighbours
    (run_training_dynamic.py:58-105, generalised to T frames)."""
    T = len(scores)
    slides: dict[str, list[int]] = {}
    trys: dict[str, list[int]] = {}
    for w in range(num_windows):
        lo = w * base
        hi = min(lo + base, T)
        if w == num_windows - 1:
            lo = max(T - base, 0)
            hi = T
        slides[str(w)] = list(range(lo, hi))
        left_try = 0 if w == 0 else min(2, lo)
        right_try = 0 if w == num_windows - 1 else min(2, T - hi)
        if w == 0:
            right_try = min(4, T - hi)
        if w == num_windows - 1:
            left_try = min(4, lo)
        trys[str(w)] = [left_try, right_try]

    for wid, win in slides.items():
        lt, rt = trys[wid]
        if lt > 0:
            left_scores = scores[win[0] - lt : win[0] + 1]
            extend_to = win[0] - (lt - int(np.argmax(left_scores))) - 1
            for j in range(win[0] - 1, extend_to, -1):
                win.insert(0, j)
        if rt > 0:
            right_scores = scores[win[-1] : win[-1] + rt + 1]
            extend_to = int(np.argmax(right_scores)) + win[-1]
            last = win[-1]
            for j in range(last + 1, extend_to + 1):
                win.append(j)

    score_dict = {
        wid: scores[win[0] : win[-1] + 1] for wid, win in slides.items()
    }
    return slides, score_dict


# ---------------------------------------------------------------------------
# Configuration and initialization
# ---------------------------------------------------------------------------


@dataclass
class PipelineConfig:
    work_dir: str
    num_fg: int = 40_000
    num_bg: int = 100_000
    num_motion_bases: int = 10
    fg_capacity_mult: float = 2.0
    bg_capacity_mult: float = 1.5
    static_epochs: int = 400
    dynamic_epochs: int = 101
    steps_per_epoch: int = 24
    initial_optim_iters: int = 1000
    validate_every: int = 100  # epochs between mid-training validations
    save_videos_every: int = 50  # epochs between train-video dumps (0 = off)
    pose_opt_iters: int = 500
    # PWC-Net weights for the exposure-consistency loss: a path to the
    # reference's pwcnet-network-default.pth, or 'random' (an untrained
    # net drawn from torch.Generator(seed); tests only). None disables it.
    flow_weights: str | None = None
    # LPIPS(alex) weights for the metrics stage: 'backbone.pth,lins.pth'
    # torch checkpoints, or 'random' (tests only). None = PSNR / SSIM only.
    lpips_weights: str | None = None
    resume: bool = True  # restore stages from their checkpoints if present
    checkpoint_every: int = 200  # steps between in-stage checkpoints
    log_every: int = 10  # steps between the writer's train/* scalars
    lr: SceneLRConfig = field(default_factory=SceneLRConfig)
    losses: LossesConfig = field(default_factory=LossesConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    # Phase-A (4x downsampled) tile capacity; None = min(4 * tile_cap,
    # 4096): at 4x downsampling 16x fewer tiles cover the same content
    # (the JAX package's PipelineConfig.tile_cap_x4 explains the clamp).
    tile_cap_x4: int | None = None
    seed: int = 0
    device: str = "cuda"

    def render_x4(self) -> RenderConfig:
        cap = self.tile_cap_x4
        if cap is None:
            cap = min(4 * self.render.tile_cap, 4096)
        return dataclasses.replace(self.render, tile_cap=cap)


def dump_run_artifacts(cfg: PipelineConfig):
    """Write the resolved config and a copy of the package into work_dir
    (the reference's YAML config dump and backup_code; JSON where PyYAML
    is not installed)."""
    import json
    import shutil

    os.makedirs(cfg.work_dir, exist_ok=True)
    try:
        import yaml

        with open(os.path.join(cfg.work_dir, "cfg.yaml"), "w") as f:
            yaml.safe_dump(dataclasses.asdict(cfg), f)
    except ImportError:
        with open(os.path.join(cfg.work_dir, "cfg.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    backup = os.path.join(cfg.work_dir, "code_backup", "deblur4dgs_tpu_torch")
    # Skip only when the backup would land inside the package itself.
    if os.path.commonpath([os.path.abspath(backup), pkg_dir]) == pkg_dir:
        print(f"code backup skipped: {backup} is inside the package")
        return
    shutil.rmtree(os.path.join(cfg.work_dir, "code_backup"),
                  ignore_errors=True)
    shutil.copytree(pkg_dir, backup,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _with_alive(g: Gaussians) -> Gaussians:
    """g with every slot alive (the bootstrap's fresh Gaussians)."""
    return Gaussians(g.means, g.quats, g.scales, g.colors, g.opacities,
                     g.motion_coefs, torch.ones((g.capacity,),
                                                device=g.means.device))


def initialize_scene(
    dataset, cfg: PipelineConfig, cano_t: int | None = None,
    static_scene: SceneModel | None = None, num_fg: int | None = None,
) -> tuple[SceneModel, float]:
    """Bootstrap fg / bg / bases from tracks and depth points
    (run_training_static.py:202-287 / run_training_dynamic.py:568-683) on
    cfg.device. With ``static_scene`` the bg and MoveModel are stage 1's
    (lift_static_stage: the new scene shares those modules)."""
    dev = resolve_device(cfg.device)
    num_fg = num_fg or cfg.num_fg
    tracks = dataset.get_tracks_3d(num_samples=num_fg)
    if cano_t is None:
        cano_t = int(np.argmax(_np(tracks.visibles).sum(0)))

    bases, motion_coefs, tracks = I.init_motion_params_with_procrustes(
        tracks, cfg.num_motion_bases, cano_t, seed=cfg.seed, device=dev)
    fg = I.init_fg_from_tracks_3d(cano_t, tracks, motion_coefs,
                                  seed=cfg.seed, device=dev)
    fg, bases, _ = I.run_initial_optim(
        fg, bases, tracks,
        np.asarray(dataset.Ks[dataset.start : dataset.end]),
        np.asarray(dataset.w2cs[dataset.start : dataset.end]),
        num_iters=cfg.initial_optim_iters, device=dev,
    )

    if static_scene is not None:
        bg, bg_scale = static_scene.bg, 1.0
    else:
        bg, bg_scale = I.init_bg(dataset.get_bkgd_points(cfg.num_bg),
                                 device=dev)

    fg = pad_to_capacity(_with_alive(fg), I.round_capacity(
        int(fg.capacity * cfg.fg_capacity_mult)))
    if static_scene is None:
        bg = pad_to_capacity(_with_alive(bg), I.round_capacity(
            int(bg.capacity * cfg.bg_capacity_mult)))

    move = (
        static_scene.move if static_scene is not None
        else init_move_model(torch.Generator().manual_seed(cfg.seed),
                             num_frames=len(dataset.get_dyn_time_ids()),
                             device=dev)
    )
    scene = SceneModel(fg=fg, bg=bg, bases=bases, move=move)
    if static_scene is not None:
        scene = lift_static_stage(scene, static_scene)
    return scene, bg_scale


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def _preload_batches(dataset, indices=None, device="cuda"):
    """Load items and move their arrays to the device once (float64 as
    float32, as jnp.asarray makes them); the loops re-batch these every
    step on the device."""
    dev = resolve_device(device)

    def put(v):
        t = torch.as_tensor(np.asarray(v))
        return t.to(dev, torch.float32 if t.dtype == torch.float64 else None)

    items = [dataset.get_item(i) for i in
             (indices if indices is not None else range(len(dataset)))]
    return [{k: put(v) if hasattr(v, "shape") else v
             for k, v in item.items()} for item in items]


def _ckpt_exists(path: str) -> bool:
    """A stage checkpoint is one file, replaced atomically
    (train/checkpoints.py::save_checkpoint)."""
    return osp.isfile(path)


def make_flow_fn(cfg: PipelineConfig):
    """The exposure-consistency AlignedLoss flow net (loss_utils.py:161-
    189) on cfg.device, or None when no weights are configured."""
    if cfg.flow_weights is None:
        return None
    from deblur4dgs_tpu_torch.models import pwcnet as P

    dev = resolve_device(cfg.device)
    if cfg.flow_weights == "random":
        net = P.init_pwcnet(torch.Generator().manual_seed(cfg.seed), dev)
    else:
        net = P.load_pwcnet_weights(cfg.flow_weights, dev)
    return P.make_aligned_loss_fn(net)


def make_lpips_fn(cfg: PipelineConfig):
    """LPIPS(alex) scorer for the metrics stage (run_compute_metrics.py:26,
    76-77) on cfg.device. Accepts (H, W, 3) or (B, H, W, 3) pairs in
    [0, 1]; returns the mean score as a 0-d tensor."""
    if cfg.lpips_weights is None:
        return None
    from deblur4dgs_tpu_torch.eval import lpips as LP

    dev = resolve_device(cfg.device)
    if cfg.lpips_weights == "random":
        net = LP.init_lpips(torch.Generator().manual_seed(cfg.seed), dev)
    else:
        backbone_path, lins_path = cfg.lpips_weights.split(",")
        net = LP.load_lpips_torch(
            torch.load(backbone_path, map_location="cpu"),
            torch.load(lins_path, map_location="cpu"), dev)

    @torch.no_grad()
    def fn(a, b):
        a = torch.as_tensor(a, dtype=torch.float32, device=dev)
        b = torch.as_tensor(b, dtype=torch.float32, device=dev)
        if a.dim() == 3:
            a, b = a[None], b[None]
        return torch.mean(LP.lpips(net, a, b))

    return fn


def _maybe_resume(loop: TrainLoop, stage_dir: str, cfg: PipelineConfig) -> int:
    """Restore the loop from stage_dir/checkpoints/last if present; returns
    the global step to resume from (0 = fresh)."""
    last = osp.join(stage_dir, "checkpoints", "last")
    if not (cfg.resume and _ckpt_exists(last)):
        return 0
    loop.state, epoch = load_checkpoint(last, loop.state)
    step = int(loop.state.step)
    loop.global_step = step
    loop.epoch = epoch
    print(f"resumed {stage_dir} from step {step} (epoch {epoch})")
    return step


def run_validation(
    scene: SceneModel, val_view, cfg: PipelineConfig, epoch: int,
    writer=None, work_dir: str | None = None, tag: str = "val",
    train_view=None, bg_only: bool = False, validator: Validator | None = None,
):
    """Mid-training validation: sharp mid-exposure renders of every val
    frame written to results/rgb_deblur_mid/{epoch:05d}/, PSNR / SSIM to
    the writer, training videos at their own cadence. Pass the returned
    validator back in on the next call of the same stage. bg_only: the
    static stage's semantics (the untrained fg is left out). Returns
    (metrics, validator)."""
    if validator is None:
        validator = Validator(scene, save_dir=work_dir,
                              has_bg=scene.bg is not None)
    else:
        validator.scene = scene
        validator.reset_metrics()
    W, H = val_view.get_img_wh()
    for i in range(len(val_view)):
        item = val_view.get_item(i)
        t = int(item["ts"]) - getattr(val_view, "start", 0) // 2
        validator.validate_frame(
            t, item["w2cs"], item["Ks"], item["imgs"], item["masks"],
            item["valid_masks"], (W, H), frame_name=str(item["frame_names"]),
            num_exposure=cfg.render.num_exposure, cap=cfg.render.tile_cap,
            use_pallas=cfg.render.use_pallas,
            subdir=osp.join("rgb_deblur_mid", f"{epoch:05d}"),
            bg_only=bg_only,
        )
    metrics = validator.compute()
    if writer is not None:
        for k, v in metrics.items():
            writer.add_scalar(f"{tag}/{k}", float(v), epoch)
    if (train_view is not None and cfg.save_videos_every
            and epoch % cfg.save_videos_every == 0):
        validator.save_train_videos(
            train_view, epoch, num_exposure=cfg.render.num_exposure,
            cap=cfg.render.tile_cap, use_pallas=cfg.render.use_pallas)
    return metrics, validator


def train_static_stage(
    dataset, scene: SceneModel, cfg: PipelineConfig, bg_scale: float,
    writer=None, val_view=None, viewer=None,
) -> SceneModel:
    """Stage 1 (run_training_static.py:140-199): bg + camera predictor.
    Trains a copy of ``scene``; returns the trained copy."""
    # the step and density control update a scene in place, and handoff
    # scenes share stage 1's bg and MoveModel
    scene = copy.deepcopy(scene)
    state = init_train_state(scene, cfg.lr, cfg.optim)
    final = osp.join(cfg.work_dir, "ckpts", "static", "last")
    if cfg.resume and _ckpt_exists(final):
        state, _ = load_checkpoint(final, state)
        print(f"static stage: restored finished checkpoint {final}")
        return state.scene
    opt = make_optimizer(scene, cfg.lr, cfg.optim)
    T = len(dataset.get_dyn_time_ids())
    stage_dir = osp.join(cfg.work_dir, "static")
    loop = TrainLoop(
        state, opt, cfg.losses, cfg.render, cfg.optim, T, stage_dir, "first",
        has_static=True, has_dynamic=False, has_reg=False,
        bg_scene_scale=bg_scale, writer=writer,
        checkpoint_every=cfg.checkpoint_every, log_every=cfg.log_every,
        viewer=viewer,
    )
    start_step = _maybe_resume(loop, stage_dir, cfg)
    items = _preload_batches(dataset, device=cfg.device)
    rng = np.random.default_rng(cfg.seed)
    for _ in range(start_step):  # replay the sampling stream up to resume
        rng.integers(1, len(items) - 1)
    total = cfg.static_epochs * cfg.steps_per_epoch
    validator = None
    for gstep in range(start_step, total):
        loop.epoch = epoch = gstep // cfg.steps_per_epoch
        idx = int(rng.integers(1, len(items) - 1))
        batch = stack_frame_batch([items[idx - 1], items[idx], items[idx + 1]],
                                  device=cfg.device)
        loop.train_step(batch, None, None, None)
        end_of_epoch = (gstep + 1) % cfg.steps_per_epoch == 0
        last_epoch = epoch == cfg.static_epochs - 1
        # no epoch-0 validation, and a model without its fg
        # (run_training_static.py:188-191)
        if (val_view is not None and end_of_epoch
                and ((epoch > 0 and epoch % cfg.validate_every == 0)
                     or last_epoch)):
            _, validator = run_validation(
                loop.state.scene, val_view, cfg, epoch, writer=writer,
                work_dir=cfg.work_dir, tag="val_static", train_view=dataset,
                bg_only=True, validator=validator,
            )
    loop.finish()
    save_checkpoint(final, loop.state, cfg.static_epochs)
    return loop.state.scene


def train_dynamic_stage(
    dataset, scene: SceneModel, cfg: PipelineConfig, bg_scale: float,
    batch4_provider=None, reg_imgs=None, writer=None,
    epochs: int | None = None, tag: str = "dynamic", val_view=None,
    flow_fn=None, viewer=None,
) -> SceneModel:
    """Stage 2 (run_training_dynamic.py:130-319): fg dynamics + exposure.
    Trains a copy of ``scene``; returns the trained copy.

    reg_imgs: stage-1 deblurred bg renders indexed by the values of
    dataset.get_dyn_image_ids(), the static-reg branch's targets (each
    step pulls the current bg's sharp render at batch 1's frame toward
    them). batch4_provider(i) -> phase-A multires guide for frame i
    (1, H/4, W/4, 3) on the device."""
    scene = copy.deepcopy(scene)  # see train_static_stage
    state = init_train_state(scene, cfg.lr, cfg.optim)
    final = osp.join(cfg.work_dir, "ckpts", tag, "last")
    if cfg.resume and _ckpt_exists(final):
        state, _ = load_checkpoint(final, state)
        print(f"{tag} stage: restored finished checkpoint {final}")
        return state.scene
    opt = make_optimizer(scene, cfg.lr, cfg.optim)
    T = len(dataset.get_dyn_time_ids())
    has_reg = reg_imgs is not None
    stage_dir = osp.join(cfg.work_dir, tag)
    loop = TrainLoop(
        state, opt, cfg.losses, cfg.render, cfg.optim, T, stage_dir,
        "second", has_static=True, has_dynamic=True, has_reg=has_reg,
        has_batch4=batch4_provider is not None, flow_fn=flow_fn,
        bg_scene_scale=bg_scale, writer=writer,
        checkpoint_every=cfg.checkpoint_every, log_every=cfg.log_every,
        viewer=viewer,
    )
    start_step = _maybe_resume(loop, stage_dir, cfg)
    ids = dataset.get_dyn_image_ids()
    items = _preload_batches(dataset, ids, device=cfg.device)
    if has_reg:  # on the device once: per-step indexing moves nothing
        reg_imgs = torch.as_tensor(np.asarray(reg_imgs), dtype=torch.float32,
                                   device=resolve_device(cfg.device))
    rng = np.random.default_rng(cfg.seed + 1)
    for _ in range(start_step):
        rng.integers(0, len(items), size=2)
    num_epochs = epochs or cfg.dynamic_epochs
    total = num_epochs * cfg.steps_per_epoch
    validator = None
    for gstep in range(start_step, total):
        loop.epoch = epoch = gstep // cfg.steps_per_epoch
        i1, i2 = (int(v) for v in rng.integers(0, len(items), size=2))
        batch1 = stack_frame_batch([items[i1]], device=cfg.device)
        batch2 = stack_frame_batch([items[i2]], device=cfg.device)
        tracks = track_batch_from_item(items[i2], start=dataset.start,
                                       device=cfg.device)
        breg = None
        if has_reg:
            # batch 1's frame with the stage-1 render as its image;
            # items[i1] is frame ids[i1], which indexes reg_imgs
            breg = batch1._replace(imgs=reg_imgs[ids[i1]][None])
        b4 = batch4_provider(i2) if batch4_provider is not None else None
        loop.train_step(batch1, batch2, tracks, breg, b4)
        end_of_epoch = (gstep + 1) % cfg.steps_per_epoch == 0
        last_epoch = epoch == num_epochs - 1
        if (val_view is not None and end_of_epoch
                and (epoch % cfg.validate_every == 0 or last_epoch)):
            _, validator = run_validation(
                loop.state.scene, val_view, cfg, epoch, writer=writer,
                work_dir=cfg.work_dir, tag=f"val_{tag}", train_view=dataset,
                validator=validator,
            )
    loop.finish()
    save_checkpoint(final, loop.state, num_epochs)
    return loop.state.scene


def run_testing(
    val_dataset, scene: SceneModel, cfg: PipelineConfig, lpips_fn=None,
) -> dict:
    """Single-scene testing (validator.py:400-499): test-time pose
    refinement on every val frame, then the metrics."""
    W, H = val_dataset.get_img_wh()
    pose_opt = make_pose_opt_fn(
        (W, H), num_iters=cfg.pose_opt_iters,
        num_exposure=cfg.render.num_exposure, cap=cfg.render.tile_cap,
        use_pallas=cfg.render.use_pallas)
    validator = Validator(scene, save_dir=cfg.work_dir,
                          has_bg=scene.bg is not None, lpips_fn=lpips_fn)
    for i in range(len(val_dataset)):
        item = val_dataset.get_item(i)
        t = int(item["ts"]) - val_dataset.start // 2
        validator.validate_frame_with_pose_opt(
            pose_opt, t, item["w2cs"], item["Ks"], item["imgs"],
            item["masks"], item["valid_masks"],
            frame_name=str(item["frame_names"]))
    return validator.compute()


def val_partition(
    num_val: int, n_win: int, train_num_frames: int, base: int = 5
) -> list[tuple[int, int]]:
    """Contiguous per-window val-frame slices [lo, hi): window w owns
    base * (val / train frame-rate ratio) val frames, the last window the
    tail (run_compute_metrics.py:36-52: 48 val frames over 5 windows ->
    10, 10, 10, 10, 8)."""
    ratio = max(num_val // max(train_num_frames, 1), 1)
    share = base * ratio
    out = []
    for w in range(n_win):
        lo = min(w * share, num_val)
        hi = num_val if w == n_win - 1 else min((w + 1) * share, num_val)
        out.append((lo, hi))
    return out


def run_testing_windows(
    val_dataset, window_scenes: dict, cfg: PipelineConfig,
    train_num_frames: int, base: int = 5, lpips_fn=None,
) -> dict:
    """Stages 3 + 4 (run_testing.py:141-204 + run_compute_metrics.py:36-
    61): each phase-B window's model refines the pose of every frame of
    its own val slice (val_partition) and renders it; every frame is
    saved under results/win_LLHH/rgb_test_optim, and only globally
    odd-indexed val frames enter the metrics.

    window_scenes: {wid: (scene, window_frame_indices)} from train_low."""
    from deblur4dgs_tpu_torch.data.views import ValSliceView

    W, H = val_dataset.get_img_wh()
    V = len(val_dataset)
    slices = val_partition(V, len(window_scenes), train_num_frames, base)
    pose_opt = make_pose_opt_fn(
        (W, H), num_iters=cfg.pose_opt_iters,
        num_exposure=cfg.render.num_exposure, cap=cfg.render.tile_cap,
        use_pallas=cfg.render.use_pallas)
    any_scene = next(iter(window_scenes.values()))[0]
    validator = Validator(any_scene, save_dir=cfg.work_dir,
                          has_bg=any_scene.bg is not None, lpips_fn=lpips_fn)
    for wid in sorted(window_scenes, key=int):
        scene_w, window = window_scenes[wid]
        lo, hi = slices[int(wid)]
        if lo >= hi:
            continue
        view = ValSliceView(val_dataset, lo, hi, t_offset=window[0],
                            window_len=len(window))
        validator.scene = scene_w
        subdir = osp.join(f"win_{window[0]:02d}{window[-1] + 1:02d}",
                          "rgb_test_optim")
        for i in range(len(view)):
            item = view.get_item(i)
            validator.validate_frame_with_pose_opt(
                pose_opt, int(item["ts"]), item["w2cs"], item["Ks"],
                item["imgs"], item["masks"], item["valid_masks"],
                frame_name=str(item["frame_names"]), subdir=subdir,
                with_metrics=(lo + i) % 2 == 1,  # held-out odd frames only
            )
    return validator.compute()


def compute_scene_metrics(
    result_dir: str, gt_dir: str | None = None, lpips_fn=None,
    device="cuda",
) -> dict:
    """Stage 4 (run_compute_metrics.py:22-86): pair rendered and gt PNGs,
    keep the odd-indexed (held-out) frames, average the metrics.

    result_dir: a flat directory of {name}.png renders, or a results/ root
    holding per-window win_*/rgb_test_optim directories (walked in window
    order). gt frames come from gt_dir when given, else from the colocated
    {name}_gt.png files the testing stage writes. The metrics run on
    ``device`` (no silent fallback to the CPU)."""
    from deblur4dgs_tpu_torch.eval import metrics as M
    from deblur4dgs_tpu_torch.vis.png import read_png

    win_dirs = sorted(
        d for d in os.listdir(result_dir)
        if d.startswith("win_")
        and osp.isdir(osp.join(result_dir, d, "rgb_test_optim")))
    dirs = ([osp.join(result_dir, d, "rgb_test_optim") for d in win_dirs]
            if win_dirs else [result_dir])
    files = []
    for d in dirs:
        files += sorted((d, f[:-4]) for f in os.listdir(d)
                        if f.endswith(".png") and not f.endswith("_gt.png"))

    dev = resolve_device(device)

    def load(path):
        return torch.as_tensor(read_png(path).astype(np.float32) / 255.0,
                               device=dev)

    psnrs, ssims, lpipss = [], [], []
    for i, (d, name) in enumerate(files):
        if i % 2 == 0:  # odd-indexed frames only (run_compute_metrics.py:60)
            continue
        pred = load(osp.join(d, f"{name}.png"))
        gt = load(osp.join(gt_dir, f"{name}.png") if gt_dir is not None
                  else osp.join(d, f"{name}_gt.png"))
        psnrs.append(M.compute_psnr(pred, gt))
        ssims.append(float(M.masked_ssim(pred, gt)))
        if lpips_fn is not None:
            lpipss.append(float(lpips_fn(pred[None], gt[None])))
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
    if lpipss:
        out["lpips"] = float(np.mean(lpipss))
    return out


@torch.no_grad()
def render_sharp_frames(scene: SceneModel, dataset, cfg: PipelineConfig,
                        bg_only=False, downsample=1) -> np.ndarray:
    """Mid-exposure renders of every frame (T, H', W', 3) on the host: the
    phase-A multires guides and the stage-1 static-reg targets
    (run_training_dynamic.py:211-284, which round-trips them through PNGs
    on disk)."""
    W, H = dataset.get_img_wh()
    dev = scene.fg.means.device
    outs = []
    for i in range(len(dataset)):
        img = render(
            scene, float(i),
            torch.as_tensor(np.asarray(dataset.w2cs[i]), device=dev),
            torch.as_tensor(np.asarray(dataset.Ks[i]), device=dev), (W, H),
            mode="mid", stage="second", bg_only=bg_only,
            num_exposure=cfg.render.num_exposure, cap=cfg.render.tile_cap,
            use_pallas=cfg.render.use_pallas,
        )["img"]
        if downsample > 1:
            img = downsample_area(img, downsample)
        outs.append(img.cpu().numpy())
    return np.stack(outs)


def train_low(train_dataset, val_dataset, cfg: PipelineConfig, writer=None,
              num_phaseB_windows: int | None = None, viewer=None,
              stage_callback=None):
    """The whole pipeline in one process (train_low.py:18-25).

    stage_callback(tag, scene, window): optional hook after every finished
    stage ('static' and 'dynamicA' with window None, then each phase-B
    'win_LLHH' with its frames).

    Stage 2 follows the reference's two scales: phase A at 4x
    downsampling over the whole clip, then phase B per adaptive window at
    full resolution with phase A's sharp renders as the multires guide and
    stage 1's bg renders as the static-reg targets
    (run_training_dynamic.py:135-564). Testing evaluates each window's
    model on its own val slice and aggregates the held-out frames'
    metrics over the windows. Returns (phase-A scene, {wid: (scene,
    window)}, metrics, slides)."""
    from deblur4dgs_tpu_torch.data.views import (
        DownsampleView,
        ValSliceView,
        WindowView,
    )

    os.makedirs(cfg.work_dir, exist_ok=True)
    dump_run_artifacts(cfg)
    dev = resolve_device(cfg.device)
    flow_fn = make_flow_fn(cfg)

    # Stage 1: static (bg + camera-motion predictor).
    scene0, bg_scale = initialize_scene(train_dataset, cfg)
    static_scene = train_static_stage(
        train_dataset, scene0, cfg, bg_scale, writer=writer,
        val_view=val_dataset, viewer=viewer)
    if stage_callback is not None:
        stage_callback("static", static_scene, None)

    # Stage 1's bg-only renders: the static-reg targets of both stage-2
    # phases (the reference reads them back from stage 1's PNGs).
    ds_x4 = DownsampleView(train_dataset, 4)
    reg_full = render_sharp_frames(static_scene, train_dataset, cfg,
                                   bg_only=True)
    cfg_x4 = dataclasses.replace(cfg, render=cfg.render_x4())
    reg_x4 = render_sharp_frames(static_scene, ds_x4, cfg_x4, bg_only=True)

    # Stage 2 phase A: 4x downsampled, the whole clip.
    sceneA, _ = initialize_scene(ds_x4, cfg_x4, static_scene=static_scene)
    sceneA = train_dynamic_stage(
        ds_x4, sceneA, cfg_x4, bg_scale, reg_imgs=reg_x4, writer=writer,
        tag="dynamicA", val_view=val_dataset, flow_fn=flow_fn, viewer=viewer)
    if stage_callback is not None:
        stage_callback("dynamicA", sceneA, None)

    # Phase A's sharp renders at 1/4 resolution: phase B's multires guide,
    # on the device (batch4_provider slices it every step).
    guide_imgs = torch.as_tensor(render_sharp_frames(sceneA, ds_x4, cfg_x4),
                                 device=dev)

    # Stage 2 phase B: adaptive windows at full resolution, one after
    # another (each an independent training job).
    scores = compute_sharpness_scores(np.asarray(train_dataset.imgs),
                                      np.asarray(train_dataset.masks))
    n_win = num_phaseB_windows
    if n_win is None:
        # ceil(T/5): every frame in a base window (5 windows for T = 24,
        # run_training_dynamic.py:78)
        n_win = max(-(-len(scores) // 5), 1)
    slides, score_dict = adaptive_slides(scores, num_windows=n_win)

    V = len(val_dataset)
    ratio = max(V // max(len(train_dataset), 1), 1)
    window_scenes = {}
    for wid, window in slides.items():
        wds = WindowView(train_dataset, window, seed=cfg.seed)
        cano_t = int(np.argmax(score_dict[wid]))
        sceneW, _ = initialize_scene(wds, cfg, cano_t=cano_t,
                                     static_scene=static_scene)

        def batch4_provider(i, _w=window):
            return guide_imgs[_w[i]][None]

        # mid-training validation over this window's val slice
        lo_v = window[0] * ratio
        hi_v = min((window[-1] + 1) * ratio, V)
        val_view_w = ValSliceView(val_dataset, lo_v, hi_v,
                                  t_offset=window[0], window_len=len(window))
        tag = f"win_{window[0]:02d}{window[-1] + 1:02d}"
        sceneW = train_dynamic_stage(
            wds, sceneW, cfg, bg_scale, batch4_provider=batch4_provider,
            reg_imgs=reg_full[window], writer=writer, tag=tag,
            val_view=val_view_w, flow_fn=flow_fn, viewer=viewer)
        window_scenes[wid] = (sceneW, window)
        if stage_callback is not None:
            stage_callback(tag, sceneW, window)

    # Stages 3 + 4: per-window testing with pose refinement, the held-out
    # frames' metrics aggregated over the windows.
    metrics = run_testing_windows(
        val_dataset, window_scenes, cfg,
        train_num_frames=len(train_dataset), lpips_fn=make_lpips_fn(cfg))
    return sceneA, window_scenes, metrics, slides
