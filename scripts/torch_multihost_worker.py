"""One process of a multi-process training-step run of the PyTorch port.

The counterpart of scripts/multihost_worker.py. Every process calls
maybe_init_distributed() (deblur4dgs_tpu_torch/parallel/mesh.py), builds
the global mesh over all processes, makes identical inputs from the same
numpy seeds as scripts/multihost_worker.py (the 200 fg + 300 bg Gaussians
of __graft_entry__._flagship_scene, default_rng(0); the 64x48 batches,
default_rng(7)), and runs ONE three-branch "second"-stage train step
(epoch 25) with the exposure sub-frames sharded across the mesh,
num_exposure = max(processes, 2). It prints ``MULTIHOST_LOSS <rank>
<loss>``; every process must print the same loss as a single-process run
(``DEBLUR4DGS_DIST=0``, the same step on a one-process mesh). The
MoveModel's weights come from torch.Generator seed 0; its heads start at
zero, as the JAX package's do, so the exposure poses, and the loss, do not
depend on them.

  # one process per card, over NCCL (torchrun sets RANK / WORLD_SIZE /
  # LOCAL_RANK / MASTER_ADDR / MASTER_PORT)
  DEBLUR4DGS_DIST=1 torchrun --nproc-per-node 4 scripts/torch_multihost_worker.py
  # plain processes, two gloo ranks on the CPU
  DEBLUR4DGS_DIST=1 DEBLUR4DGS_NUM_PROCESSES=2 DEBLUR4DGS_PROCESS_ID=<i> \\
  DEBLUR4DGS_COORDINATOR_ADDRESS=127.0.0.1:29500 MULTIHOST_CPU=1 \\
  python3 scripts/torch_multihost_worker.py

Each process runs on its card (``cuda:<LOCAL_RANK>``) unless
MULTIHOST_CPU=1 asks for the CPU. MULTIHOST_STEPS=N times N more steps
after the first and prints ``MULTIHOST_STEP_MS <rank> <median ms>``.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

W, H = 64, 48


def flagship_scene(device, num_fg=200, num_bg=300, num_frames=8,
                   num_bases=8, seed=0):
    """__graft_entry__._flagship_scene's Gaussians and bases, drawn from
    the same numpy stream; the port's MoveModel."""
    from deblur4dgs_tpu_torch.models.gaussians import Gaussians
    from deblur4dgs_tpu_torch.models.motion_bases import MotionBases
    from deblur4dgs_tpu_torch.models.move_model import init_move_model
    from deblur4dgs_tpu_torch.models.scene import SceneModel

    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)

    def gauss(n, coefs):
        means = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
        means[:, 2] = rng.uniform(1.5, 5.0, n)
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        scales = rng.uniform(-5, -3.5, (n, 3)).astype(np.float32)
        colors = rng.normal(size=(n, 3)).astype(np.float32)
        mc = rng.normal(size=(n, num_bases)).astype(np.float32) if coefs \
            else None
        return Gaussians(t(means), t(quats), t(scales), t(colors),
                         t(np.ones(n)), None if mc is None else t(mc),
                         t(np.ones(n)))

    fg, bg = gauss(num_fg, True), gauss(num_bg, False)
    rots = np.tile(np.array([1.0, 0, 0, 0, 1, 0], np.float32),
                   (num_bases, num_frames, 1))
    transls = 0.05 * rng.normal(size=(num_bases, num_frames, 3)).astype(
        np.float32)
    return SceneModel(
        fg=fg, bg=bg, bases=MotionBases(t(rots), t(transls)),
        move=init_move_model(torch.Generator().manual_seed(0), num_frames,
                             device=device))


def build_inputs(device):
    """scripts/multihost_worker.py's batches (default_rng(7), drawn in its
    order): frames(b) and the tracks."""
    from deblur4dgs_tpu_torch.train.trainer import FrameBatch, TrackBatch

    rng = np.random.default_rng(7)
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)
    K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1.0]],
                 np.float32)
    eye = np.eye(4, dtype=np.float32)

    def frames(b):
        return FrameBatch(
            ts=t(np.arange(2, 2 + b, dtype=np.int32)),
            w2cs=t(np.tile(eye, (b, 1, 1))), Ks=t(np.tile(K, (b, 1, 1))),
            imgs=t(rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32)),
            masks=t((rng.uniform(size=(b, H, W)) < 0.3).astype(np.float32)),
            valid_masks=t(np.ones((b, H, W), np.float32)),
            depths=t(rng.uniform(1, 5, (b, H, W)).astype(np.float32)),
        )

    P = 16
    tracks = TrackBatch(
        query_tracks_2d=t(np.stack([rng.integers(0, W, P),
                                    rng.integers(0, H, P)], -1)
                          .astype(np.float32)),
        target_ts=t(np.array([1, 3], np.int32)),
        target_w2cs=t(np.tile(eye, (2, 1, 1))),
        target_Ks=t(np.tile(K, (2, 1, 1))),
        target_tracks_2d=t(rng.uniform(0, W, (2, P, 2)).astype(np.float32)),
        target_visibles=t(np.ones((2, P), np.float32)),
        target_confidences=t(np.ones((2, P), np.float32)),
        target_track_depths=t(rng.uniform(1, 5, (2, P)).astype(np.float32)),
    )
    return frames, tracks


def main():
    from deblur4dgs_tpu_torch.configs import (
        LossesConfig,
        OptimizerConfig,
        RenderConfig,
        SceneLRConfig,
    )
    from deblur4dgs_tpu_torch.parallel.mesh import (
        global_mesh,
        maybe_init_distributed,
        subframe_sharding,
    )
    from deblur4dgs_tpu_torch.train.optimizers import make_optimizer
    from deblur4dgs_tpu_torch.train.trainer import (
        init_train_state,
        make_train_step,
    )

    device = "cpu" if os.environ.get("MULTIHOST_CPU") == "1" else None
    if device == "cpu":
        torch.set_num_threads(1)
    ran = maybe_init_distributed(device=device)
    mesh = global_mesh(device=device)
    print(f"process {mesh.rank}/{mesh.size} distributed={ran} "
          f"device={mesh.device} transport={mesh.transport}", flush=True)

    scene = flagship_scene(mesh.device)
    frames, tracks = build_inputs(mesh.device)
    lr, ocfg = SceneLRConfig(), OptimizerConfig()
    rcfg = RenderConfig(num_exposure=max(mesh.size, 2), tile_cap=256)
    state = init_train_state(scene, lr, ocfg)
    step = make_train_step(
        make_optimizer(scene, lr, ocfg), LossesConfig(), rcfg, "second", 8,
        has_static=True, has_dynamic=True, has_reg=True,
        subframe_sharding=subframe_sharding(mesh))
    b1, b2, b3 = frames(3), frames(1), frames(3)
    state, loss, _ = step(state, 25, b1, b2, tracks, b3, None)
    print(f"MULTIHOST_LOSS {mesh.rank} {float(loss):.6f}", flush=True)

    n_steps = int(os.environ.get("MULTIHOST_STEPS", "0"))
    if n_steps > 0:
        times = []
        for _ in range(n_steps):
            t0 = time.time()
            state, loss, _ = step(state, 25, b1, b2, tracks, b3, None)
            float(loss)  # waits for the step
            times.append(time.time() - t0)
        print(f"MULTIHOST_STEP_MS {mesh.rank} "
              f"{statistics.median(times) * 1e3:.3f}", flush=True)
    if ran:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
