"""The port's command line (cli.py, __main__.py) and its PNG codec
(vis/png.py).

  * ``train --synthetic --device cpu`` at 48x32 with the flags of
    tests/test_pipeline_fidelity.py::TestCliTrainE2E (``--device cpu`` in
    place of ``--no-pallas``): metrics.json finite, ceil(8/5) = 2 phase-B
    windows whose checkpoints cover every frame, each window's
    rgb_test_optim PNGs (decoded through vis/png.py), every stage's
    checkpoint file, and scalars.jsonl (one JSON object per line, the
    validations' metrics among them); without ``--device`` the command
    raises where no card is present;
  * the ``metrics`` subcommand on that run's results equals
    pipeline.compute_scene_metrics; without ``--device`` it raises where
    no card is present;
  * ``train --viewer-port``, ``view`` and ``render-path`` without
    ``--device`` raise where no card is present, before they serve, load
    or write anything (tests/test_torch_viewer.py runs them on the CPU);
  * the PNG codec both ways against imageio: files imageio writes (grey,
    RGB, RGBA; its encoder picks filters per row) and files encoded here
    with each of the five row filters read back equal; files write_png
    writes, imageio reads back equal.
"""

import json
import os
import struct
import zlib

import imageio.v3 as iio
import numpy as np
import pytest
import torch

from deblur4dgs_tpu_torch import cli
from deblur4dgs_tpu_torch import pipeline as PL
from deblur4dgs_tpu_torch.vis.png import read_png, write_png
from tests.test_torch_models import torch_single_thread  # noqa: F401

TRAIN = [
    "train", "--synthetic", "--synthetic-frames", "8",
    "--synthetic-wh", "48", "32", "--num-fg", "40", "--num-bg", "100",
    "--num-motion-bases", "2", "--epochs-static", "1", "--epochs-dynamic",
    "1", "--steps-per-epoch", "2", "--num-exposure", "3", "--tile-cap",
    "256", "--initial-optim-iters", "20", "--pose-opt-iters", "4",
    "--validate-every", "1000", "--save-videos-every", "0",
]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("cli") / "run"
    cli.main(TRAIN + ["--device", "cpu", "--work-dir", str(work)])
    return work


def test_train_writes_the_stages(run):
    with open(run / "metrics.json") as f:
        metrics = json.load(f)
    assert np.isfinite(metrics["val/psnr"])
    assert 0.0 <= metrics["val/ssim"] <= 1.0
    wins = sorted(d for d in os.listdir(run / "ckpts") if d.startswith("win_"))
    assert len(wins) == 2
    spans = [(int(d[4:6]), int(d[6:8])) for d in wins]
    assert {i for lo, hi in spans for i in range(lo, hi)} == set(range(8))
    for tag in ["static", "dynamicA"] + wins:
        assert os.path.isfile(run / "ckpts" / tag / "last"), tag
    results = sorted(d for d in os.listdir(run / "results")
                     if d.startswith("win_"))
    assert results == wins
    for d in results:
        pngs = sorted(p for p in os.listdir(run / "results" / d /
                                            "rgb_test_optim")
                      if p.endswith(".png"))
        assert pngs and len(pngs) % 2 == 0  # each render beside its gt
        for p in pngs:
            img = read_png(str(run / "results" / d / "rgb_test_optim" / p))
            assert img.shape == (32, 48, 3) and img.dtype == np.uint8
    with open(run / "scalars.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert lines and all(set(r) == {"tag", "value", "step", "time"}
                         for r in lines)
    tags = {r["tag"] for r in lines}
    assert "val_static/val/psnr" in tags and "val_dynamicA/val/psnr" in tags


def test_train_without_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(TRAIN + ["--work-dir", str(tmp_path / "w")])
    assert not os.path.exists(tmp_path / "w")


def test_metrics_subcommand(run, capsys):
    cli.main(["metrics", "--result-dir", str(run / "results"), "--device",
              "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out == PL.compute_scene_metrics(str(run / "results"),
                                           device="cpu")
    assert set(out) == {"psnr", "ssim"} and np.isfinite(out["psnr"])


def test_metrics_without_device_raises_without_a_card(run, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["metrics", "--result-dir", str(run / "results")])
    assert capsys.readouterr().out == ""


CKPT = ["--checkpoint", "x", "--num-frames", "8", "--num-fg", "40",
        "--num-bg", "100"]


@pytest.mark.parametrize("argv", [
    TRAIN + ["--viewer-port", "0"],
    ["view"] + CKPT,
    ["render-path", "--keyframes", "kf.json", "--out", "p.mp4"] + CKPT,
])
def test_viewer_raises(argv, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    if argv[0] == "train":
        argv = argv + ["--work-dir", str(tmp_path / "w")]
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(argv)
    assert capsys.readouterr().out == ""
    assert not os.path.exists(tmp_path / "w")


def _images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]
    return {
        "grey": ((xx * 3 + yy) % 256).astype(np.uint8),
        "rgb_noise": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
        "rgb_smooth": np.stack([xx * 4 % 256, yy * 6 % 256,
                                (xx + yy) * 3 % 256], -1).astype(np.uint8),
        "rgba": rng.integers(0, 256, (20, 30, 4), dtype=np.uint8),
    }


def _encode_filtered(img, ftype):
    """PNG bytes of uint8 ``img`` with every row filtered by ``ftype``."""
    img = img[..., None] if img.ndim == 2 else img
    h, w, ch = img.shape
    raw = img.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    for y in range(h):
        x = raw[y]
        a = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        b = raw[y - 1] if y else np.zeros_like(x)
        c = np.concatenate([np.zeros(ch, np.int64), b[:-ch]])
        if ftype == 0:
            pred = np.zeros_like(x)
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out += bytes([ftype]) + ((x - pred) % 256).astype(np.uint8).tobytes()
    ctype = {1: 0, 3: 2, 4: 6}[ch]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("name", list(_images()))
def test_png_reads_what_imageio_writes(name, tmp_path):
    img = _images()[name]
    path = str(tmp_path / f"{name}.png")
    iio.imwrite(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(read_png(path), iio.imread(path))


@pytest.mark.parametrize("ftype", range(5))
def test_png_reads_every_filter(ftype, tmp_path):
    for name, img in _images().items():
        path = tmp_path / f"{name}_{ftype}.png"
        path.write_bytes(_encode_filtered(img, ftype))
        np.testing.assert_array_equal(iio.imread(path), img, err_msg=name)
        np.testing.assert_array_equal(read_png(str(path)), img,
                                      err_msg=name)


@pytest.mark.parametrize("name", list(_images()))
def test_imageio_reads_what_png_writes(name, tmp_path):
    img = _images()[name]
    path = str(tmp_path / f"{name}.png")
    write_png(path, img)
    np.testing.assert_array_equal(iio.imread(path), img)
    np.testing.assert_array_equal(read_png(path), img)
    write_png(path, img[..., :1] if img.ndim == 3 else img[..., None])
    assert read_png(path).ndim == 2
    with pytest.raises(TypeError):
        write_png(path, img.astype(np.float32))
