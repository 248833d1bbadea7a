"""Config dataclasses (counterpart of the reference flow3d/configs.py).

Same semantics and defaults; plain dataclasses consumed by argparse-driven
entry points (the reference uses tyro, which is not in this image).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class FGLRConfig:
    means: float = 1.6e-4
    opacities: float = 1e-2
    scales: float = 5e-3
    quats: float = 1e-3
    colors: float = 1e-2
    motion_coefs: float = 1e-2


@dataclass
class BGLRConfig:
    means: float = 1.6e-4
    opacities: float = 5e-2
    scales: float = 5e-3
    quats: float = 1e-3
    colors: float = 1e-2


@dataclass
class MotionLRConfig:
    rots: float = 1.6e-4
    transls: float = 1.6e-4


@dataclass
class MoveLRConfig:
    pose: float = 5e-4  # trainer.py:105-111 (cosine to 1e-5, T=24*500)
    time: float = 1e-1  # trainer.py:113-116 (cosine to 1e-5, T=24*200)
    pose_T_max: int = 24 * 500
    time_T_max: int = 24 * 200
    eta_min: float = 1e-5
    accum_every: int = 25  # grads accumulate; step every 25 (trainer.py:241-255)
    # NOTE: the pose-net epoch gate is applied in make_train_step via
    # LossesConfig.exposure_cons_start_epoch (both default to the
    # reference's epoch 20, trainer.py:241-250 — one knob there too, since
    # its pose stepping and AlignedLoss activate together). This field is
    # NOT consumed; kept for config-surface parity only.
    pose_start_epoch: int = 20


@dataclass
class SceneLRConfig:
    fg: FGLRConfig = field(default_factory=FGLRConfig)
    bg: BGLRConfig = field(default_factory=BGLRConfig)
    motion_bases: MotionLRConfig = field(default_factory=MotionLRConfig)
    move: MoveLRConfig = field(default_factory=MoveLRConfig)


@dataclass
class LossesConfig:
    w_rgb: float = 1.0
    w_depth_reg: float = 0.5
    w_depth_const: float = 0.1
    w_depth_grad: float = 1.0
    w_track: float = 2.0
    w_mask: float = 1.0
    w_smooth_bases: float = 0.1
    w_smooth_tracks: float = 2.0
    w_scale_var: float = 0.01
    w_z_accel: float = 1.0
    # exposure-time hinge reg (trainer.py:730-734)
    w_exposure_reg: float = 0.1
    exposure_min: float = 0.5
    exposure_max: float = 0.75
    # exposure sub-frame consistency (trainer.py:599-618)
    w_exposure_cons: float = 2.0
    exposure_cons_start_epoch: int = 20
    # multi-resolution sharp-vs-blurry consistency (trainer.py:736-760)
    w_multires: float = 1.0


@dataclass
class OptimizerConfig:
    max_steps: int = 5000
    warmup_steps: int = 200
    control_every: int = 100
    reset_opacity_every_n_controls: int = 30
    stop_control_by_screen_steps: int = 4000
    stop_control_steps: int = 4000
    densify_xys_grad_threshold: float = 0.0002
    densify_scale_threshold: float = 0.01
    densify_screen_threshold: float = 0.05
    stop_densify_steps: int = 15000
    cull_opacity_threshold: float = 0.1
    cull_scale_threshold: float = 0.5
    cull_screen_threshold: float = 0.15


@dataclass
class RenderConfig:
    num_exposure: int = 11  # K sub-frames (scene_model.py:248)
    tile_cap: int = 512  # per-tile gaussian capacity
    use_pallas: bool = True
    # Count-sorted tile buckets on the exposure-shared path: rank-dependent
    # per-tile capacities cut pack/DMA traffic ~3x (ops/tiling.py
    # default_bucket_spec). Disable for uniform tile_cap everywhere.
    bucketed: bool = True
    # Max tiles a gaussian's bounding square may cover in pair-expansion
    # binning (ops/tiling.py): halving 32 -> 16 halves the pair sort +
    # list-gather cost but truncates coverage of gaussians with screen
    # radius over ~24 px (a 4x4-tile span plus slack). Quality-checked by
    # scripts/tpu_mt_ablate.py before changing the default.
    max_tiles_per_gauss: int = 32
    # Within-exposure camera interpolation: 'linear' (reference default,
    # move_model.py:168-204) or 'cubic' (duplicated-knot SE(3) B-spline
    # ease; see models/move_model.py::exposure_samples and PARITY.md).
    # NOTE 'cubic' endpoints shrink to (5*p0+p1)/6 and (p0+5*p1)/6 — the
    # spline covers ~2/3 of the predicted exposure motion — and its exact
    # mid-sample property (used by mode='mid') requires ODD num_exposure.
    camera_mode: str = "linear"


def asdict(cfg):
    return dataclasses.asdict(cfg)
