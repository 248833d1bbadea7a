"""The port's CLI on a scene on disk: ``train --data-dir``.

The scene is tests/test_stereo_dataset.py::scene_dir's 64x48 scene in the
Shape-of-Motion layout (16 frames written by imageio, fg masks, inverse
depths, COLMAP binaries, 20 pairwise tracks), which the port's
StereoDataset reads through vis/png.py. ``train --data-dir --high-res
--device cpu`` at the smallest depth runs every stage (static, phase A,
the phase-B windows, testing, metrics) and writes every stage's
checkpoint and the windows' test renders. ``metrics --gt-dir`` on its
results, with the scene's frames as ground truth, equals the JAX
package's compute_scene_metrics (imageio, jnp): PSNR to 1e-5 relative,
SSIM to 1e-5 absolute (it is a mean of terms of both signs, ~0.01 here
against random frames, so float32 reductions in another order move its
relative value by ~1e-4).

eval/metrics.py::masked_ssim runs in float64 (its variances cancel; in
float32 a 1280x720 pair's SSIM lands ~1e-5 off, by an amount that
depends on the order of the filter's sums): on smooth bright 144x256
frames, masked and not, it equals a float64 numpy transcription of the
formula to float32's rounding (1e-7 relative), where the same
transcription in float32 is more than 5e-6 off.
"""

import json
import os

import numpy as np
import pytest
import torch

from deblur4dgs_tpu import pipeline as jpl
from deblur4dgs_tpu_torch import cli
from deblur4dgs_tpu_torch.eval.metrics import masked_ssim
from tests.test_stereo_dataset import scene_dir  # noqa: F401 (fixture)
from tests.test_torch_models import torch_single_thread  # noqa: F401

TRAIN = [
    "train", "--high-res", "--num-fg", "40", "--num-bg", "100",
    "--num-motion-bases", "2", "--epochs-static", "1", "--epochs-dynamic",
    "1", "--steps-per-epoch", "2", "--num-exposure", "3", "--tile-cap",
    "256", "--initial-optim-iters", "20", "--pose-opt-iters", "4",
    "--validate-every", "1000", "--save-videos-every", "0", "--device",
    "cpu",
]


@pytest.fixture(scope="module")
def run(scene_dir, tmp_path_factory):  # noqa: F811
    work = tmp_path_factory.mktemp("stereo") / "run"
    stages = []
    cli.main(TRAIN + ["--data-dir", scene_dir, "--work-dir", str(work)],
             stage_callback=lambda tag, *_: stages.append(tag))
    return work, stages


def test_train_data_dir_runs_every_stage(run):
    work, stages = run
    with open(work / "metrics.json") as f:
        metrics = json.load(f)
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    wins = sorted(d for d in os.listdir(work / "ckpts")
                  if d.startswith("win_"))
    assert len(wins) == 2  # 8 train frames, windows of 5
    for tag in ["static", "dynamicA"] + wins:
        assert os.path.isfile(work / "ckpts" / tag / "last"), tag
    assert stages[:2] == ["static", "dynamicA"] and len(stages) >= 4
    for d in wins:
        pngs = os.listdir(work / "results" / d / "rgb_test_optim")
        assert any(p.endswith("_gt.png") for p in pngs)


def test_metrics_gt_dir_equals_the_reference(run, scene_dir, capsys):  # noqa: F811
    work, _ = run
    gt = os.path.join(scene_dir, "images")
    capsys.readouterr()
    cli.main(["metrics", "--result-dir", str(work / "results"), "--gt-dir",
              gt, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    want = jpl.compute_scene_metrics(str(work / "results"), gt)
    assert set(got) == set(want) == {"psnr", "ssim"}
    assert np.isfinite(got["psnr"]) and np.isfinite(got["ssim"])
    np.testing.assert_allclose(got["psnr"], float(want["psnr"]), rtol=1e-5)
    np.testing.assert_allclose(got["ssim"], float(want["ssim"]), rtol=0,
                               atol=1e-5)


def ssim_numpy(a, b, m, dtype, k=11, sigma=1.5):
    """masked_ssim's formula in numpy at ``dtype``: the separable masked
    Gaussian filter with VALID padding, one shifted product per tap."""
    a, b, m = (np.asarray(x, dtype) for x in (a, b, m))
    filt = np.exp(-0.5 * ((np.arange(k) - k // 2) / sigma) ** 2).astype(dtype)
    filt /= filt.sum()

    def filt_fn(z, m):
        for axis in (1, 0):
            n = z.shape[axis] - k + 1
            take = lambda x, i: x[:, i:i + n] if axis == 1 else x[i:i + n]
            zm = z * m[..., None]
            z_ = sum(filt[i] * take(zm, i) for i in range(k))
            m_ = sum(take(m, i) for i in range(k))
            with np.errstate(invalid="ignore", divide="ignore"):
                z = np.where(m_[..., None] != 0,
                             z_ * dtype(k) / m_[..., None], 0).astype(dtype)
            m = (m_ != 0).astype(dtype)
        return z

    mu0, mu1 = filt_fn(a, m), filt_fn(b, m)
    s00 = np.maximum(filt_fn(a * a, m) - mu0 * mu0, 0)
    s11 = np.maximum(filt_fn(b * b, m) - mu1 * mu1, 0)
    s01 = filt_fn(a * b, m) - mu0 * mu1
    s01 = np.sign(s01) * np.minimum(np.sqrt(s00 * s11), np.abs(s01))
    c1, c2 = dtype(1e-4), dtype(9e-4)
    return float(np.mean((2 * mu0 * mu1 + c1) * (2 * s01 + c2)
                         / ((mu0 * mu0 + mu1 * mu1 + c1) * (s00 + s11 + c2))))


@pytest.mark.parametrize("masked", [False, True])
def test_masked_ssim_runs_in_float64(masked):
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:144, 0:256] / 256.0
    a = np.stack([0.9 + 0.05 * np.sin(5 * x + c) * np.cos(3 * y)
                  for c in range(3)], -1)
    b = np.clip(a + 0.01 * rng.normal(size=a.shape), 0, 1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    m = np.ones((144, 256), np.float32)
    if masked:
        m[40:100, 60:200] = 0
    got = masked_ssim(torch.as_tensor(a), torch.as_tensor(b),
                      torch.as_tensor(m))
    assert got.dtype == torch.float32
    want = ssim_numpy(a, b, m, np.float64)
    np.testing.assert_allclose(float(got), want, rtol=1e-7)
    np.testing.assert_allclose(
        float(masked_ssim(a.astype(np.float64), b, m)), want, rtol=1e-7)
    assert abs(ssim_numpy(a, b, m, np.float32) - want) > 5e-6 * want
