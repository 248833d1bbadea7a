"""Port vs reference: image / pose metrics (eval/metrics.py), the
perceptual backbones (models/backbones.py), LPIPS (eval/lpips.py), the
depth colormap (vis/utils.py) and the weight conversions of convert.py.

The same seeded numpy inputs go to both packages. The JAX package draws
its random backbone / LPIPS weights with jax.random; they are carried into
the port with convert.backbone_from_numpy / lpips_from_numpy (HWIO ->
OIHW), so both nets hold the same weights.

Bars: metrics 1e-5 (relative for PSNR, absolute otherwise); backbone
features and LPIPS scores / maps 1e-5 of the reference's max |value|
(float32 convolutions in another order); the port's LPIPS against the
golden fixture recorded from the reference torch implementation at 1e-4
abs (tests/test_golden_fixtures.py's bar); the weight round trip and the
colormap: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.eval import lpips as jlp
from deblur4dgs_tpu.eval import metrics as jm
from deblur4dgs_tpu.models import backbones as jb
from deblur4dgs_tpu.vis import utils as jvis
from deblur4dgs_tpu_torch import convert
from deblur4dgs_tpu_torch.eval import lpips as tlp
from deblur4dgs_tpu_torch.eval import metrics as tm
from deblur4dgs_tpu_torch.models import backbones as tb
from deblur4dgs_tpu_torch.vis import utils as tvis
from tests.golden_utils import build_seeded_state_dict, load_manifest
from tests.test_torch_models import torch_single_thread  # noqa: F401
from tests.test_torch_synthetic import np_

ATOL = 1e-5
NET_REL = 1e-5
H, W = 40, 56


def images(seed, n=None):
    rng = np.random.default_rng(seed)
    shape = (H, W, 3) if n is None else (n, H, W, 3)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    mask = np.zeros(shape[:-1], np.float32)
    mask[..., 5:30, 10:45] = 1.0
    return a, b, mask


def assert_rel(a, b, rel, name):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = float(np.abs(b).max()) + 1e-12
    err = float(np.abs(a - b).max()) / scale
    assert err <= rel, f"{name}: {err:.3e} of max |ref|"


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("masked", [False, True])
def test_psnr_and_ssim(masked):
    a, b, mask = images(0)
    m = mask if masked else None
    jp = jm.compute_psnr(jnp.asarray(a), jnp.asarray(b),
                         None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(tm.compute_psnr(a, b, m), jp, rtol=ATOL)
    js = float(jm.masked_ssim(jnp.asarray(a), jnp.asarray(b),
                              None if m is None else jnp.asarray(m)))
    np.testing.assert_allclose(float(tm.masked_ssim(a, b, m)), js, atol=ATOL)


def test_pck_and_pose_errors():
    rng = np.random.default_rng(1)
    p = rng.uniform(0, 50, (30, 2)).astype(np.float32)
    q = (p + rng.normal(0, 2.0, p.shape)).astype(np.float32)
    for thr in (1.0, 2.5, 5.0):
        assert tm.compute_pck(p, q, thr) == jm.compute_pck(
            jnp.asarray(p), jnp.asarray(q), thr)
    poses = np.tile(np.eye(4), (6, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(6, 3))
    noisy = poses.copy()
    noisy[:, :3, 3] += 0.01 * rng.normal(size=(6, 3))
    np.testing.assert_allclose(tm.compute_pose_errors(noisy, poses),
                               jm.compute_pose_errors(noisy, poses),
                               atol=ATOL)


def test_accumulators():
    j = (jm.mPSNR(), jm.mSSIM(), jm.PCK())
    t = (tm.mPSNR(), tm.mSSIM(), tm.PCK())
    for seed in range(3):
        a, b, mask = images(10 + seed)
        for acc, conv in ((j, jnp.asarray), (t, torch.as_tensor)):
            acc[0].update(conv(a), conv(b), conv(mask))
            acc[1].update(conv(a), conv(b), conv(mask))
            acc[2].update(conv(a[0, :20, :2]), conv(b[0, :20, :2]), 0.05)
    a4, b4, m4 = images(20, n=2)  # the batched SSIM update
    j[1].update(jnp.asarray(a4), jnp.asarray(b4), jnp.asarray(m4))
    t[1].update(torch.as_tensor(a4), torch.as_tensor(b4), torch.as_tensor(m4))
    for ja, ta in zip(j, t):
        assert len(ta) == len(ja)
        np.testing.assert_allclose(ta.compute(), ja.compute(), atol=ATOL)
        ta.reset()
        assert len(ta) == 0


@pytest.fixture(scope="module")
def alex():
    p = to_numpy_tree(jb.init_alexnet(jax.random.PRNGKey(0)))
    return p, convert.backbone_from_numpy(p, device="cpu")


def test_alexnet_features(alex):
    p, net = alex
    x = np.random.default_rng(2).normal(size=(2, 64, 72, 3)).astype(
        np.float32)
    jf = jb.alexnet_features(jax.tree_util.tree_map(jnp.asarray, p),
                             jnp.asarray(x))
    with torch.no_grad():
        tf = net(torch.as_tensor(x).permute(0, 3, 1, 2))
    assert len(tf) == len(jf) == 5
    for i, (a, b) in enumerate(zip(tf, jf)):
        assert_rel(a.permute(0, 2, 3, 1), b, NET_REL, f"relu{i + 1}")


def test_vgg19_features_and_loss():
    p = to_numpy_tree(jb.init_vgg19(jax.random.PRNGKey(1)))
    net = convert.backbone_from_numpy(p, device="cpu")
    assert isinstance(net, tb.VGG19Features)
    rng = np.random.default_rng(3)
    x, y = (rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jf = jb.vgg19_features(jp, jnp.asarray(x))
    with torch.no_grad():
        tf = net(torch.as_tensor(x).permute(0, 3, 1, 2))
        tloss = tb.vgg_perceptual_loss(net, torch.as_tensor(x),
                                       torch.as_tensor(y))
    assert set(tf) == set(jf)
    for name in jf:
        assert_rel(tf[name].permute(0, 2, 3, 1), jf[name], NET_REL, name)
    jloss = float(jb.vgg_perceptual_loss(jp, jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(tloss), jloss, rtol=NET_REL)


@pytest.fixture(scope="module")
def lp():
    p = to_numpy_tree(jlp.init_lpips(jax.random.PRNGKey(2)))
    return p, convert.lpips_from_numpy(p, device="cpu")


@pytest.mark.parametrize("spatial", [False, True])
def test_lpips(lp, spatial):
    p, model = lp
    a, b, _ = images(4, n=2)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    ref = jlp.lpips(jp, jnp.asarray(a), jnp.asarray(b), spatial=spatial)
    with torch.no_grad():
        out = tlp.lpips(model, torch.as_tensor(a), torch.as_tensor(b),
                        spatial=spatial)
    assert_rel(out, ref, NET_REL, "lpips")
    if spatial:  # the bilinear upsampling's borders, on their own
        for name, sl in (("top", np.s_[:, 0]), ("bottom", np.s_[:, -1]),
                         ("left", np.s_[:, :, 0]), ("right", np.s_[:, :, -1])):
            assert_rel(out[sl], np.asarray(ref)[sl], NET_REL, name)
    with torch.no_grad():
        same = tlp.lpips(model, torch.as_tensor(a), torch.as_tensor(a))
    assert float(same.abs().max()) == 0.0


def test_masked_lpips(lp):
    p, model = lp
    a, b, mask = images(5, n=1)
    ref = jlp.masked_lpips(jax.tree_util.tree_map(jnp.asarray, p),
                           jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    with torch.no_grad():
        out = tlp.masked_lpips(model, torch.as_tensor(a), torch.as_tensor(b),
                               torch.as_tensor(mask))
    np.testing.assert_allclose(float(out), float(ref), rtol=NET_REL)


def test_lpips_golden():
    """The port's LPIPS with the fixture's seeded AlexNet and recorded lin
    heads against the score the reference torch implementation gave."""
    import os

    from tests.golden_utils import FIXTURE_DIR

    fix = np.load(os.path.join(FIXTURE_DIR, "lpips_golden.npz"))
    backbone_sd = build_seeded_state_dict(load_manifest("lpips_manifest.json"),
                                          seed=43)
    lin_sd = {f"lin{i}.model.1.weight": fix[f"lin{i}"] for i in range(5)}
    model = tlp.load_lpips_torch(backbone_sd, lin_sd, device="cpu")
    with torch.no_grad():
        score = float(tlp.lpips(model, torch.as_tensor(fix["a"])[None],
                                torch.as_tensor(fix["b"])[None])[0])
    np.testing.assert_allclose(score, float(fix["score"]), atol=1e-4)


def test_conversion_round_trip(lp):
    p, model = lp
    back = convert.lpips_to_numpy(model)
    for name, a, b in (("lins", back["lins"], p["lins"]),
                       ("net", back["net"], p["net"])):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x, y, err_msg=name)
    vgg = to_numpy_tree(jb.init_vgg19(jax.random.PRNGKey(3)))
    again = convert.backbone_to_numpy(convert.backbone_from_numpy(vgg, "cpu"))
    for x, y in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(vgg)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        convert.backbone_from_numpy(vgg[:4], "cpu")


def test_init_shapes():
    g = torch.Generator().manual_seed(0)
    model = tlp.init_lpips(g, device="cpu")
    ref = to_numpy_tree(jlp.init_lpips(jax.random.PRNGKey(0)))
    mine = convert.lpips_to_numpy(model)
    for x, y in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(ref)):
        assert x.shape == y.shape
        assert float(np.abs(x).max()) <= float(np.abs(y).max()) * 1.5


def test_draw_tracks_and_video_crop():
    rng = np.random.default_rng(7)
    img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    tracks = rng.uniform(0, [W, H], (5, 12, 2)).astype(np.float32)
    np.testing.assert_array_equal(tvis.draw_tracks_2d(img, tracks),
                                  jvis.draw_tracks_2d(img, tracks))
    video = rng.uniform(size=(3, H, W, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.make_video_divisible(video),
                                  jvis.make_video_divisible(video))


@pytest.mark.parametrize("with_acc", [False, True])
def test_apply_depth_colormap(with_acc):
    rng = np.random.default_rng(6)
    depth = rng.uniform(1, 5, (H, W)).astype(np.float32)
    acc = rng.uniform(0, 1, (H, W)).astype(np.float32) if with_acc else None
    np.testing.assert_array_equal(tvis.apply_depth_colormap(depth, acc),
                                  jvis.apply_depth_colormap(depth, acc))
