"""PyTorch + CUDA port of deblur4dgs_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package module for module (``deblur4dgs_tpu_torch/ops/
rasterize.py`` <-> ``deblur4dgs_tpu/ops/rasterize.py``). The Pallas TPU
kernels become hand-written CUDA kernels (``csrc/``) wrapped in
``torch.autograd.Function``s; every kernel keeps a plain PyTorch twin that
runs on CPU tensors. This package never imports JAX or ``deblur4dgs_tpu``.

Ported so far (ROADMAP.md): the pipeline's train steps (stage 1, stage 2
and the dynamic step) with every TPU compositor kernel (K1-K6), and the
training lifecycle around them: the scene bootstrap (train/init.py),
density control (train/density.py), checkpoints (train/checkpoints.py)
and the loop (train/loop.py). The data and evaluation path: the oracle
rasterizer (ops/rasterize_ref.py), synthetic scenes and datasets, the
dataset views, the COLMAP readers and the stereo dataset (data/), the
metrics, LPIPS and the validator with its test-time pose refinement
(eval/), the perceptual backbones (models/backbones.py) and the video
helpers (vis/utils.py). The staged pipeline and its command line
(pipeline.py, cli.py, ``python -m deblur4dgs_tpu_torch``), the PWC-Net
of the exposure-consistency term (models/pwcnet.py) and a PNG codec in
the standard library (vis/png.py). The viewer and its utilities
(vis/renderer.py, vis/viewer.py, vis/render_panel.py,
utils/trajectories.py, utils/profiling.py; ``view``, ``render-path`` and
``train --viewer-port``) and the 'cubic' exposure camera.
"""

import torch


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; CUDA asked for but absent raises.

    Entry points default to ``"cuda"``; they never fall back to the CPU
    silently — the CPU is only used when the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain versions"
        )
    return dev
