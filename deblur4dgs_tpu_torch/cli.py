"""Command-line entry points.

PyTorch port of deblur4dgs_tpu/cli.py (the reference's train_low.py and
run_compute_metrics.py, argparse instead of tyro, one process instead of
four):

  python -m deblur4dgs_tpu_torch train --data-dir <scene>/x1 --work-dir out \\
      [--high-res] [--epochs-static 400] [--epochs-dynamic 101] \\
      [--device cuda]
  python -m deblur4dgs_tpu_torch train --synthetic --work-dir out \\
      --device cpu ...
  python -m deblur4dgs_tpu_torch metrics --result-dir ... [--gt-dir ...]
  python -m deblur4dgs_tpu_torch view --checkpoint ... --num-frames T \\
      --num-fg N --num-bg M [--port 8890] [--device cuda]
  python -m deblur4dgs_tpu_torch render-path --checkpoint ... \\
      --num-frames T --num-fg N --num-bg M --keyframes kf.json \\
      --out path.mp4 [--device cuda]

``--device`` (default cuda; no silent fallback to the CPU) says where
everything runs. ``--no-pallas`` (train) composites every render with the
reference's plain compositors without the early stop (plain PyTorch, on
--device) instead of the hand-written kernels (their plain twins on the
CPU), as the JAX package's flag swaps its Pallas kernels for plain XLA.
Scalars go to
``<work-dir>/scalars.jsonl``, one JSON object per line. The synthetic
scene's size flags (--synthetic-num-fg, --synthetic-num-bg,
--synthetic-tracks) are the port's: their defaults give the JAX package's
synthetic scene, and they let a synthetic run fill the --num-fg /
--num-bg defaults (the fg init builds one Gaussian per track, the bg
init one per ground-truth bg Gaussian). The port renders the synthetic
frames through the tile path (K5; its plain twin on the CPU) at every
size, where the JAX package uses the per-pixel oracle, whose (pixels x
Gaussians) arrays do not fit at 1280x720. ``view`` and ``render-path``
load a checkpoint the port wrote (``<work-dir>/ckpts/<stage>/last``;
--num-fg / --num-bg are its capacities, --num-frames its frame count). A
phase-B window's exposure model is stage 1's and keeps the clip's frame
count, which is read from the file (the JAX package's CLI cannot load a
window checkpoint). ``view`` serves PNG frames; ``render-path`` writes
its video as an animated PNG at ``<out stem>.png`` and prints
{"video", "frames"}.
"""

from __future__ import annotations

import argparse
import json
import os
import time

class ScalarWriter:
    """The writer TrainLoop logs to: ``add_scalar`` appends one JSON line
    {"tag", "value", "step", "time"} to ``path``."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path

    def add_scalar(self, tag, value, step):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(step), "time": time.time()})
                    + "\n")


def _add_train(sub):
    p = sub.add_parser("train", help="staged train_low pipeline")
    p.add_argument("--data-dir", default=None,
                   help="scene dir (required unless --synthetic)")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--high-res", action="store_true",
                   help="720x1280 (no /2.5 intrinsics scaling)")
    p.add_argument("--num-fg", type=int, default=40_000)
    p.add_argument("--num-bg", type=int, default=100_000)
    p.add_argument("--num-motion-bases", type=int, default=10)
    p.add_argument("--epochs-static", type=int, default=400)
    p.add_argument("--epochs-dynamic", type=int, default=101)
    p.add_argument("--steps-per-epoch", type=int, default=24)
    p.add_argument("--num-exposure", type=int, default=11)
    p.add_argument("--tile-cap", type=int, default=1024)
    p.add_argument("--no-pallas", action="store_true",
                   help="composite with the plain compositors without the "
                        "early stop instead of the kernels")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for the plain versions)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10,
                   help="steps between the train/* scalars (a logged step "
                   "waits for the card)")
    p.add_argument("--validate-every", type=int, default=100)
    p.add_argument("--save-videos-every", type=int, default=50)
    p.add_argument("--pose-opt-iters", type=int, default=500)
    p.add_argument("--flow-weights", default=None,
                   help="PWC-Net .pth for the exposure-consistency loss "
                   "('random': an untrained net, tests only)")
    p.add_argument("--lpips-weights", default=None,
                   help="LPIPS 'backbone.pth,lins.pth' for metrics")
    p.add_argument("--no-resume", action="store_true",
                   help="ignore existing stage checkpoints")
    p.add_argument("--viewer-port", type=int, default=None,
                   help="serve a live training viewer on this port")
    p.add_argument(
        "--synthetic", action="store_true",
        help="train on a generated synthetic blurry scene instead of a "
        "Shape-of-Motion data dir (smoke/regression runs)",
    )
    p.add_argument("--synthetic-frames", type=int, default=8)
    p.add_argument("--synthetic-wh", type=int, nargs=2, default=(64, 48),
                   help="frame size; the frames render through the tile "
                   "path (K5) at every size")
    p.add_argument("--synthetic-num-fg", type=int, default=120,
                   help="ground-truth fg Gaussians of the synthetic scene")
    p.add_argument("--synthetic-num-bg", type=int, default=300,
                   help="ground-truth bg Gaussians of the synthetic scene")
    p.add_argument("--synthetic-tracks", type=int, default=64,
                   help="ground-truth tracks (the fg init builds one "
                   "Gaussian per track)")
    p.add_argument("--initial-optim-iters", type=int, default=1000)
    p.add_argument("--num-windows", type=int, default=None,
                   help="override phase-B window count (default ceil(T/5))")


def _add_metrics(sub):
    p = sub.add_parser("metrics", help="PSNR/SSIM over rendered results")
    p.add_argument("--result-dir", required=True,
                   help="flat render dir, or a results/ root containing "
                   "per-window win_*/rgb_test_optim dirs")
    p.add_argument("--gt-dir", default=None,
                   help="GT frames; defaults to colocated *_gt.png files")
    p.add_argument("--lpips-weights", default=None,
                   help="LPIPS 'backbone.pth,lins.pth' (optional)")
    p.add_argument("--device", default="cuda")


def _add_ckpt_args(p):
    p.add_argument("--checkpoint", required=True,
                   help="a port checkpoint: <work-dir>/ckpts/<stage>/last")
    p.add_argument("--num-frames", type=int, required=True)
    p.add_argument("--num-fg", type=int, required=True,
                   help="fg Gaussian capacity of the checkpoint")
    p.add_argument("--num-bg", type=int, required=True)
    p.add_argument("--num-motion-bases", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for the plain versions)")


def _add_view(sub):
    p = sub.add_parser("view", help="interactive browser viewer")
    _add_ckpt_args(p)
    p.add_argument("--port", type=int, default=8890)


def _add_render_path(sub):
    p = sub.add_parser(
        "render-path",
        help="render a keyframed camera path to a video (the reference's "
        "viser render tab); written as an animated PNG",
    )
    _add_ckpt_args(p)
    p.add_argument(
        "--keyframes", required=True,
        help="JSON file: [{c2w: 4x4 list, fov?: rad, time?: frame}, ...]",
    )
    p.add_argument("--out", required=True,
                   help="output video path (written at <stem>.png)")
    p.add_argument("--path-frames", type=int, default=120)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--loop", action="store_true")
    p.add_argument("--tension", type=float, default=0.0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("deblur4dgs_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_train(sub)
    _add_metrics(sub)
    _add_view(sub)
    _add_render_path(sub)
    return parser


def _load_renderer(args):
    import torch

    from deblur4dgs_tpu_torch import resolve_device
    from deblur4dgs_tpu_torch.train.checkpoints import template_state
    from deblur4dgs_tpu_torch.vis.renderer import Renderer

    resolve_device(args.device)
    # a phase-B window keeps stage 1's exposure model, whose per-frame
    # times cover the whole clip: their count comes from the file
    saved = torch.load(args.checkpoint, map_location="cpu", mmap=True,
                       weights_only=True)
    num_move = saved["scene"]["move.time_params"].shape[0]
    template = template_state(args.num_fg, args.num_bg,
                              args.num_motion_bases, args.num_frames,
                              device=args.device, num_move_frames=num_move)
    return Renderer.init_from_checkpoint(args.checkpoint, template,
                                         args.num_frames)


def _datasets(args):
    """(train, val) datasets of a train command."""
    if args.synthetic:
        from deblur4dgs_tpu_torch.data import synthetic

        sscene = synthetic.make_scene(
            seed=args.seed, num_fg=args.synthetic_num_fg,
            num_bg=args.synthetic_num_bg, num_frames=args.synthetic_frames,
            img_wh=tuple(args.synthetic_wh), device=args.device,
        )
        sdata = synthetic.generate_dataset(
            sscene, num_tracks=args.synthetic_tracks, fast_renderer=True)
        return (synthetic.SyntheticSceneAdapter(sscene, sdata,
                                                seed=args.seed),
                synthetic.SyntheticSceneAdapter(sscene, sdata, seed=args.seed,
                                                split="val"))
    from deblur4dgs_tpu_torch.data.stereo import (
        StereoDataConfig,
        StereoDataset,
    )

    scale = 1.0 if args.high_res else 2.5
    train_ds = StereoDataset(StereoDataConfig(
        data_dir=args.data_dir, intrinsics_scale=scale, seed=args.seed))
    val_ds = StereoDataset(
        StereoDataConfig(data_dir=args.data_dir, split="val",
                         intrinsics_scale=scale, seed=args.seed),
        scene_norm=train_ds.scene_norm)
    return train_ds, val_ds


def main(argv=None, stage_callback=None):
    """Runs one subcommand. stage_callback (Python callers only) goes to
    pipeline.train_low: it is called after every finished stage."""
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.cmd == "train":
        from deblur4dgs_tpu_torch import pipeline as PL
        from deblur4dgs_tpu_torch import resolve_device
        from deblur4dgs_tpu_torch.configs import RenderConfig

        if not args.synthetic and args.data_dir is None:
            parser.error("train: --data-dir is required unless --synthetic")
        resolve_device(args.device)
        train_ds, val_ds = _datasets(args)
        cfg = PL.PipelineConfig(
            work_dir=args.work_dir,
            num_fg=args.num_fg,
            num_bg=args.num_bg,
            num_motion_bases=args.num_motion_bases,
            static_epochs=args.epochs_static,
            dynamic_epochs=args.epochs_dynamic,
            steps_per_epoch=args.steps_per_epoch,
            initial_optim_iters=args.initial_optim_iters,
            validate_every=args.validate_every,
            save_videos_every=args.save_videos_every,
            pose_opt_iters=args.pose_opt_iters,
            flow_weights=args.flow_weights,
            lpips_weights=args.lpips_weights,
            resume=not args.no_resume,
            render=RenderConfig(num_exposure=args.num_exposure,
                                tile_cap=args.tile_cap,
                                use_pallas=not args.no_pallas),
            seed=args.seed,
            device=args.device,
            log_every=args.log_every,
        )
        writer = ScalarWriter(os.path.join(args.work_dir, "scalars.jsonl"))
        viewer = None
        if args.viewer_port is not None:
            from deblur4dgs_tpu_torch.vis.viewer import TrainingViewer

            viewer = TrainingViewer(
                len(train_ds), port=args.viewer_port,
                num_exposure=args.num_exposure, cap=args.tile_cap,
                use_pallas=not args.no_pallas, work_dir=args.work_dir)
            viewer.serve_forever(background=True)
            print(f"live viewer on http://0.0.0.0:{viewer.port}")
        try:
            _, _, metrics, _ = PL.train_low(
                train_ds, val_ds, cfg, writer,
                num_phaseB_windows=args.num_windows, viewer=viewer,
                stage_callback=stage_callback)
        finally:
            if viewer is not None:
                viewer.close()
        metrics = {k: float(v) for k, v in metrics.items()}
        print(json.dumps(metrics, indent=2))
        with open(os.path.join(args.work_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f)

    elif args.cmd == "metrics":
        from deblur4dgs_tpu_torch import resolve_device
        from deblur4dgs_tpu_torch.pipeline import (
            PipelineConfig,
            compute_scene_metrics,
            make_lpips_fn,
        )

        dev = resolve_device(args.device)
        lpips_fn = make_lpips_fn(PipelineConfig(
            work_dir="", lpips_weights=args.lpips_weights,
            device=args.device))
        print(json.dumps(compute_scene_metrics(
            args.result_dir, args.gt_dir, lpips_fn=lpips_fn, device=dev),
            indent=2))

    elif args.cmd == "view":
        from deblur4dgs_tpu_torch.vis.viewer import DynamicViewer

        renderer = _load_renderer(args)
        viewer = DynamicViewer(renderer.render_fn, args.num_frames,
                               port=args.port)
        print(f"serving on http://0.0.0.0:{args.port}")
        viewer.serve_forever(background=False)

    elif args.cmd == "render-path":
        import numpy as np

        from deblur4dgs_tpu_torch.vis.render_panel import (
            Keyframe,
            render_camera_path,
        )

        renderer = _load_renderer(args)
        with open(args.keyframes) as f:
            keyframes = [
                Keyframe(c2w=np.asarray(k["c2w"], np.float32),
                         fov=float(k.get("fov", np.pi / 3)),
                         time=k.get("time"))
                for k in json.load(f)]
        frames, video = render_camera_path(
            renderer.render_fn, keyframes, (args.width, args.height),
            num_frames=args.path_frames, out_path=args.out, fps=args.fps,
            loop=args.loop, tension=args.tension,
            num_scene_frames=args.num_frames)
        print(json.dumps({"video": video, "frames": int(frames.shape[0])}))


if __name__ == "__main__":
    main()
