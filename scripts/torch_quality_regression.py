"""End-to-end deblur-quality check of the PyTorch port.

The port's copy of scripts/tpu_quality_regression.py (whose docstring
records why each setting is what it is): generate a synthetic blurry
sequence (camera shake + object motion) with the port's generator, run
the port's whole staged pipeline (deblur4dgs_tpu_torch.pipeline.train_low)
and score the test-time pose-refined sharp renders against the ground
truth's sharp frames on the held-out odd frames, beside the blurry input
scored the same way. Imports no JAX.

Tiers (the reference script's):
  --small    T=8, 64x48, 2/2 epochs of 2 steps (a sanity run; CPU-sized)
  --medium   T=8, 256x144, 30/20 epochs of 16 steps, S=5, cap 512: the
             end-to-end check of the port; the JAX package's run of this
             tier reads fg_improvement_db -3.648 (docs/QUALITY.md, "Guard
             status": the reference band is -3.6 +- 0.5 dB)
  default    T=24, 512x288, the reference-scale 400/101-epoch schedule
             (--quick: 60/32), S=9, cap 2048; asserts the margin
Every tier writes QUALITY_torch_<tier>.json at the repo root (with the
card's name and power limit when it ran on a card) and keeps a partial
JSON with per-stage diagnostics in the work directory while it runs.

Usage:
  python scripts/torch_quality_regression.py [--small|--medium|--quick]
      [--device cuda|cpu] [--work-dir DIR] [--resume]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The default tiers' required fg-PSNR gain over the blurry input (dB).
MARGIN_DB = 1.0


def psnr(a, b, mask=None):
    a = np.clip(np.asarray(a, np.float64), 0, 1)
    b = np.clip(np.asarray(b, np.float64), 0, 1)
    if mask is not None:
        m = np.asarray(mask, np.float64)[..., None]
        mse = float((((a - b) ** 2) * m).sum() / max(m.sum() * 3, 1e-9))
    else:
        mse = float(((a - b) ** 2).mean())
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def _mat4(p34):
    m = torch.eye(4, device=p34.device)
    m[:3, :] = p34
    return m


@torch.no_grad()
def diagnose_move(move, w2cs, exp_deltas=None, gt_exposure=None, frames=None,
                  t_offset: int = 0) -> dict:
    """Per-frame learned-vs-ground-truth exposure sweep (the port's copy of
    scripts/inspect_checkpoint.py::diagnose_move, whose module docstring
    explains the comparison): the learned relative sweep
    log(P(1) P(0)^-1) against log(w2c^-1 exp(2 delta) w2c), and the
    learned deltaT. Returns per-frame rows and summary means."""
    from deblur4dgs_tpu_torch.models.move_model import (
        frame_delta_t,
        predict_deltas,
    )
    from deblur4dgs_tpu_torch.ops import lie

    dev = move.time_params.device
    w2cs = torch.as_tensor(np.asarray(w2cs), dtype=torch.float32, device=dev)
    if frames is None:
        frames = list(range(w2cs.shape[0]))
    rows = []
    for f in frames:
        w2c = w2cs[f]
        d0, d1 = predict_deltas(move, w2c)
        P0, P1 = _mat4(lie.se3_exp(d0)), _mat4(lie.se3_exp(d1))
        rel = lie.se3_log((P1 @ torch.linalg.inv(P0))[:3, :])
        dt = frame_delta_t(move, f - t_offset, "second")
        lmag = float(torch.linalg.norm(rel))
        row = {
            "frame": int(f),
            "learned_sweep": [round(float(v), 5) for v in rel.cpu()],
            "learned_sweep_mag": round(lmag, 5),
            "learned_delta_t": round(float(dt), 4),
        }
        if exp_deltas is not None:
            delta = torch.as_tensor(np.asarray(exp_deltas[f]),
                                    dtype=torch.float32, device=dev)
            D = _mat4(lie.se3_exp(2.0 * delta))
            gt_rel = lie.se3_log((torch.linalg.inv(w2c) @ D @ w2c)[:3, :])
            gmag = float(torch.linalg.norm(gt_rel))
            cos = float(torch.dot(rel, gt_rel)) / (lmag * gmag + 1e-12)
            sgn = 1.0 if cos >= 0 else -1.0  # the sweep's sign is free
            row.update(
                gt_sweep_mag=round(gmag, 5),
                sweep_ratio=round(lmag / (gmag + 1e-12), 4),
                sweep_cosine=round(cos, 4),
                sweep_abs_cosine=round(abs(cos), 4),
                sweep_err_mag=round(float(torch.linalg.norm(rel - gt_rel)),
                                    5),
                sweep_err_mag_signfree=round(
                    float(torch.linalg.norm(sgn * rel - gt_rel)), 5),
            )
        if gt_exposure is not None:
            row["gt_delta_t"] = round(float(gt_exposure), 4)
        rows.append(row)
    out: dict = {"frames": rows}
    use = [r for r in rows if r["learned_delta_t"] > 0] or rows
    for k in ("learned_sweep_mag", "learned_delta_t", "gt_sweep_mag",
              "sweep_ratio", "sweep_cosine", "sweep_abs_cosine",
              "sweep_err_mag", "sweep_err_mag_signfree"):
        vals = [r[k] for r in use if k in r]
        if vals:
            out[f"mean_{k}"] = round(float(np.mean(vals)), 5)
    return out


def card_line(device: str) -> str | None:
    """nvidia-smi's name and power limit of the card, None on the CPU."""
    if not device.startswith("cuda"):
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def tier_settings(args):
    """(T, wh, scene generator kwargs, num_fg, num_bg, blur samples,
    PipelineConfig kwargs) of the tier, as the reference script sets
    them."""
    from deblur4dgs_tpu_torch.configs import (
        LossesConfig,
        RenderConfig,
        SceneLRConfig,
    )

    if args.small:
        return 8, (64, 48), dict(exp_shake=0.03, motion_cycles=1.0), 80, \
            200, 3, dict(
                num_fg=40, num_bg=100, num_motion_bases=2, static_epochs=2,
                dynamic_epochs=2, steps_per_epoch=2, initial_optim_iters=20,
                pose_opt_iters=4,
                render=RenderConfig(num_exposure=3, tile_cap=256))
    if args.medium:
        return 8, (256, 144), dict(exp_shake=0.02, motion_cycles=1.5), 800, \
            4000, 7, dict(
                num_fg=600, num_bg=3500, num_motion_bases=4, static_epochs=30,
                dynamic_epochs=20, steps_per_epoch=16, initial_optim_iters=300,
                pose_opt_iters=50,
                render=RenderConfig(num_exposure=5, tile_cap=512))
    lr_cfg = SceneLRConfig()
    lr_cfg.move.accum_every = 5
    lr_cfg.move.pose = 1e-3
    loss_cfg = LossesConfig(exposure_cons_start_epoch=3)
    epochs = dict(static_epochs=60, dynamic_epochs=32,
                  initial_optim_iters=400, pose_opt_iters=200)
    if not args.quick:  # the reference-scale schedule (the default)
        epochs = dict(static_epochs=400, dynamic_epochs=101,
                      initial_optim_iters=1000, pose_opt_iters=500)
    return 24, (512, 288), dict(exp_shake=0.10, motion_cycles=1.0,
                                motion_amp=0.7, exposure=0.7), 2000, 9000, 9, \
        dict(num_fg=2000, num_bg=8000, num_motion_bases=6,
             steps_per_epoch=24, lr=lr_cfg, losses=loss_cfg,
             lpips_weights="random",
             render=RenderConfig(num_exposure=9, tile_cap=2048), **epochs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--medium", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="full-size data, the 60/32-epoch schedule")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work-dir", default=None,
                    help="default: build/quality_torch_<tier> in the repo")
    ap.add_argument("--out", default=None,
                    help="result JSON (default QUALITY_torch_<tier>.json at "
                    "the repo root)")
    ap.add_argument("--resume", action="store_true",
                    help="restore finished / in-progress stages from the "
                    "work dir's checkpoints")
    args = ap.parse_args()

    from deblur4dgs_tpu_torch import pipeline as PL
    from deblur4dgs_tpu_torch import resolve_device
    from deblur4dgs_tpu_torch.configs import OptimizerConfig
    from deblur4dgs_tpu_torch.data import synthetic
    from deblur4dgs_tpu_torch.models.scene import render

    tier = ("small" if args.small else "medium" if args.medium
            else "quick" if args.quick else "default")
    dev = resolve_device(args.device)
    card = card_line(args.device)
    work_dir = args.work_dir or os.path.join(REPO, "build",
                                             f"quality_torch_{tier}")
    out_path = args.out or os.path.join(REPO, f"QUALITY_torch_{tier}.json")
    T, wh, scene_kw, num_fg, num_bg, blur_samples, cfg_kw = \
        tier_settings(args)
    scene_kw.setdefault("exposure", 0.45)
    blur_union = not (args.small or args.medium)

    print(f"generating synthetic blurry sequence T={T} wh={wh} on {dev}...",
          flush=True)
    t0 = time.time()
    sscene = synthetic.make_scene(seed=0, num_fg=num_fg, num_bg=num_bg,
                                  num_frames=T, img_wh=wh, cam_shake=0.03,
                                  device=dev, **scene_kw)
    sdata = synthetic.generate_dataset(
        sscene, num_blur_samples=blur_samples, num_tracks=num_fg,
        fast_renderer=not args.small, blur_union_masks=blur_union)
    train_ds = synthetic.SyntheticSceneAdapter(sscene, sdata, seed=0)
    val_ds = synthetic.SyntheticSceneAdapter(sscene, sdata, seed=0,
                                             split="val")
    blurry = sdata.imgs
    blur_lvl = float(np.mean([psnr(blurry[f], sdata.sharp_imgs[f])
                              for f in range(T)]))
    blur_lvl_fg = float(np.mean([psnr(blurry[f], sdata.sharp_imgs[f],
                                      sdata.masks[f]) for f in range(T)]))
    dataset_s = time.time() - t0
    print(f"  dataset in {dataset_s:.1f}s; blurry-vs-sharp {blur_lvl:.2f} dB"
          f" (fg {blur_lvl_fg:.2f} dB)", flush=True)
    assert args.small or blur_lvl < 38.0, (
        f"synthetic blur too weak to measure deblurring: {blur_lvl:.1f} dB")

    cfg = PL.PipelineConfig(
        work_dir=work_dir, validate_every=10_000, save_videos_every=0,
        optim=OptimizerConfig(warmup_steps=100, control_every=100),
        resume=args.resume, seed=0, device=str(dev), **cfg_kw)

    os.makedirs(work_dir, exist_ok=True)
    partial_path = os.path.join(work_dir, "partial.json")
    stages: list[dict] = []
    t_start = time.time()

    def stage_callback(tag, scene, window):
        entry = {"stage": tag, "t_seconds": round(time.time() - t_start, 1)}
        frames = window if window is not None else list(range(T))
        t_off = frames[0]
        entry["move"] = {k: v for k, v in diagnose_move(
            scene.move, sdata.w2cs, sscene.exp_deltas.cpu().numpy()
            if sscene.exp_deltas is not None else None, sscene.exposure,
            frames=frames, t_offset=t_off).items() if k != "frames"}
        if window is not None:  # unaligned fg PSNR at the GT cameras
            fg_p, fg_b = [], []
            with torch.no_grad():
                for f in frames:
                    img = render(
                        scene, float(f - t_off),
                        torch.as_tensor(sdata.w2cs[f], device=dev),
                        torch.as_tensor(sdata.Ks[f], device=dev), wh,
                        mode="mid", stage="second",
                        num_exposure=cfg.render.num_exposure,
                        cap=cfg.render.tile_cap)["img"].cpu().numpy()
                    fg_p.append(psnr(img, sdata.sharp_imgs[f],
                                     sdata.masks[f]))
                    fg_b.append(psnr(blurry[f], sdata.sharp_imgs[f],
                                     sdata.masks[f]))
            entry["direct_fg_psnr"] = round(float(np.mean(fg_p)), 3)
            entry["direct_blurry_fg_psnr"] = round(float(np.mean(fg_b)), 3)
        stages.append(entry)
        with open(partial_path, "w") as f:
            json.dump({"tier": tier, "card": card, "stages": stages}, f,
                      indent=2)
        print(f"[stage {tag}] {json.dumps(entry)}", flush=True)

    t0 = time.time()
    _, window_scenes, metrics, _ = PL.train_low(
        train_ds, val_ds, cfg, stage_callback=stage_callback)
    train_s = time.time() - t0
    print(f"train_low in {train_s:.1f}s; pose-opt metrics: "
          f"{ {k: float(v) for k, v in metrics.items()} }", flush=True)

    # Primary score (the reference's protocol): pose-refined renders against
    # the sharp held-out frames (odd indices), beside the blurry input on
    # the same frames.
    odd = [f for f in range(T) if f % 2 == 1]
    base_psnr = float(np.mean([psnr(blurry[f], sdata.sharp_imgs[f])
                               for f in odd]))
    base_fg = float(np.mean([psnr(blurry[f], sdata.sharp_imgs[f],
                                  sdata.masks[f]) for f in odd]))
    deblur_psnr = float(metrics["val/psnr"])
    deblur_fg = float(metrics["val/fg_psnr"])

    # Secondary: direct renders at the GT cameras without pose alignment,
    # each frame by the window model owning it (val_partition's slices).
    owners = {}
    slices = PL.val_partition(T, len(window_scenes), T)
    for wid in sorted(window_scenes, key=int):
        lo, hi = slices[int(wid)]
        for f in range(lo, hi):
            owners[f] = window_scenes[wid]
    direct = {"psnr": [], "fg": [], "blur": [], "blur_fg": []}
    with torch.no_grad():
        for f in range(T):
            scene_w, window = owners[f]
            t_local = int(np.clip(f - window[0], 0, len(window) - 1))
            img = render(
                scene_w, float(t_local),
                torch.as_tensor(sdata.w2cs[f], device=dev),
                torch.as_tensor(sdata.Ks[f], device=dev), wh, mode="mid",
                stage="second", num_exposure=cfg.render.num_exposure,
                cap=cfg.render.tile_cap)["img"].cpu().numpy()
            gt, mask = sdata.sharp_imgs[f], sdata.masks[f]
            direct["psnr"].append(psnr(img, gt))
            direct["fg"].append(psnr(img, gt, mask))
            direct["blur"].append(psnr(blurry[f], gt))
            direct["blur_fg"].append(psnr(blurry[f], gt, mask))

    result = {
        "tier": tier, "card": card, "device": str(dev),
        "torch": torch.__version__,
        "T": T, "img_wh": list(wh),
        "dataset_seconds": round(dataset_s, 1),
        "train_seconds": round(train_s, 1),
        "blurry_input_psnr": round(base_psnr, 3),
        "deblurred_psnr": round(deblur_psnr, 3),
        "blurry_input_fg_psnr": round(base_fg, 3),
        "deblurred_fg_psnr": round(deblur_fg, 3),
        "improvement_db": round(deblur_psnr - base_psnr, 3),
        "fg_improvement_db": round(deblur_fg - base_fg, 3),
        "direct_render_psnr": round(float(np.mean(direct["psnr"])), 3),
        "direct_render_fg_psnr": round(float(np.mean(direct["fg"])), 3),
        "direct_blurry_psnr": round(float(np.mean(direct["blur"])), 3),
        "direct_blurry_fg_psnr": round(float(np.mean(direct["blur_fg"])), 3),
        "pose_opt_metrics": {k: float(v) for k, v in metrics.items()},
        "stage_diagnostics": stages,
        "dataset_blur_psnr": round(blur_lvl, 3),
        "dataset_blur_fg_psnr": round(blur_lvl_fg, 3),
        "config": {
            "static_epochs": cfg.static_epochs,
            "dynamic_epochs": cfg.dynamic_epochs,
            "steps_per_epoch": cfg.steps_per_epoch,
            "num_exposure": cfg.render.num_exposure,
            "tile_cap": cfg.render.tile_cap,
            "pose_opt_iters": cfg.pose_opt_iters,
            "num_tracks": num_fg,
            "lpips_weights": cfg.lpips_weights,
            "w_multires": cfg.losses.w_multires,
            "blur_union_masks": blur_union,
            "scene_kw": {k: v for k, v in sorted(scene_kw.items())},
        },
    }
    print(json.dumps(result, indent=2))
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {out_path}")
    if tier in ("default", "quick"):
        assert result["fg_improvement_db"] > MARGIN_DB, (
            f"deblurred fg PSNR must beat the blurry input by "
            f">{MARGIN_DB} dB, got {result['fg_improvement_db']}")
        print("QUALITY REGRESSION PASSED")


if __name__ == "__main__":
    main()
