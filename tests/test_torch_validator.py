"""Port vs reference: the validator (eval/validator.py) on the 48x32 scene
of tests/test_validator.py: the test-time pose refinement, the sharp
validation metrics (with an LPIPS whose weights are carried across), the
keypoint PCK and the training videos.

The JAX scene is flattened to numpy and rebuilt in the port
(convert.scene_from_numpy), so both hold the same weights, its MoveModel's
jax.random trunk included. The JAX side renders through the Pallas kernels
in interpret mode (use_pallas=True; the port has no use_pallas=False
path), the port through its K5 twin. The ground-truth image is the port's
render at the true pose; both refine from the same perturbed camera.

Bars. Pose refinement over 30 iterations: every iteration's loss within
1e-4 relative (measured 2.3e-5 at most: Adam's normalised steps carry the
float32 differences of the renders forward), the refined w2c within 1e-5
abs (measured 6.2e-8) and the refined image within 1e-5 abs (measured
1.3e-6). Metrics: PSNR 1e-5 relative, SSIM and LPIPS 1e-5 abs; PCK equal.
The cosine schedule: 1e-6 relative (float32 cosines of two libraries
differ by an ulp).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.eval import lpips as jlp
from deblur4dgs_tpu.eval import validator as jval
from deblur4dgs_tpu.models.move_model import init_move_model
from deblur4dgs_tpu.models.scene import SceneModel
from deblur4dgs_tpu.models.scene import compute_poses_fg
from deblur4dgs_tpu_torch import convert
from deblur4dgs_tpu_torch.eval import lpips as tlp
from deblur4dgs_tpu_torch.eval import validator as tval
from deblur4dgs_tpu_torch.models.scene import render as trender
from deblur4dgs_tpu_torch.train.optimizers import _cosine_schedule
from tests.test_models import identity_bases, make_gaussians
from tests.test_torch_models import jax_to_numpy
from tests.test_torch_models import torch_single_thread  # noqa: F401

W, H = 48, 32
K = np.array([[40.0, 0.0, 24.0], [0.0, 40.0, 16.0], [0.0, 0.0, 1.0]],
             np.float32)
EYE4 = np.eye(4, dtype=np.float32)
ITERS = 30
KW = dict(num_exposure=3, cap=256)
LOSS_REL, W2C_ATOL, IMG_ATOL = 1e-4, 1e-5, 1e-5


@pytest.fixture(scope="module")
def scenes():
    js = SceneModel(
        fg=make_gaussians(40, seed=1),
        bg=make_gaussians(60, seed=2, with_coefs=False),
        bases=identity_bases(4, 8),
        move=init_move_model(jax.random.PRNGKey(0), num_frames=8),
    )
    return js, convert.scene_from_numpy(jax_to_numpy(js), device="cpu")


@pytest.fixture(scope="module")
def gt(scenes):
    with torch.no_grad():
        return {t: trender(scenes[1], t, torch.as_tensor(EYE4),
                           torch.as_tensor(K), (W, H), mode="mid",
                           **KW)["img"].numpy() for t in (2, 3)}


@pytest.fixture(scope="module")
def bad_w2c():
    w = EYE4.copy()
    w[0, 3] += 0.05
    w[1, 3] -= 0.03
    return w


@pytest.fixture(scope="module")
def pose_fns():
    return (jval.make_pose_opt_fn((W, H), num_iters=ITERS, **KW),
            tval.make_pose_opt_fn((W, H), num_iters=ITERS, **KW))


@pytest.fixture(scope="module")
def lpips_fns():
    p = jax.tree_util.tree_map(np.asarray,
                               jlp.init_lpips(jax.random.PRNGKey(5)))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    model = convert.lpips_from_numpy(p, device="cpu")
    return (lambda a, b: jnp.mean(jlp.lpips(jp, a[None], b[None])),
            lambda a, b: torch.mean(tlp.lpips(model, a[None], b[None])))


def test_cosine_schedule_matches_reference():
    jsched = jval._cosine_lr(1e-2, 1e-4, ITERS)
    tsched = _cosine_schedule(1e-2, 1e-4, ITERS)
    for step in range(ITERS + 2):
        np.testing.assert_allclose(float(tsched(step, "cpu")),
                                   float(jsched(jnp.int32(step))), rtol=1e-6)


def test_pose_opt_matches_reference(scenes, gt, bad_w2c, pose_fns):
    js, ts = scenes
    jimg, jw2c, jloss = pose_fns[0](js, 3, jnp.asarray(bad_w2c),
                                    jnp.asarray(K), jnp.asarray(gt[3]))
    timg, tw2c, tloss = pose_fns[1](ts, 3, bad_w2c, K, gt[3])
    jloss, tloss = np.asarray(jloss), tloss.numpy()
    assert tloss.shape == (ITERS,)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_REL, atol=0)
    np.testing.assert_allclose(tw2c.numpy(), np.asarray(jw2c), atol=W2C_ATOL)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=IMG_ATOL)
    assert tloss[-1] < 0.5 * tloss[0]
    np.testing.assert_array_equal(tw2c.numpy()[3], [0, 0, 0, 1])
    # nothing of the scene was differentiated or accumulated
    assert all(p.grad is None for p in ts.parameters())


def test_validator_metrics(scenes, gt, bad_w2c, pose_fns, lpips_fns):
    js, ts = scenes
    fg = np.zeros((H, W), np.float32)
    fg[8:24, 12:36] = 1.0
    valid = np.ones((H, W), np.float32)
    jv = jval.Validator(js, lpips_fn=lpips_fns[0])
    tv = tval.Validator(ts, lpips_fn=lpips_fns[1])
    # frame 2 at a camera 0.01 off the true pose (a finite PSNR), then
    # frame 3 refined from a bad pose
    near = EYE4.copy()
    near[0, 3] = 0.01
    jv.validate_frame(2, jnp.asarray(near), jnp.asarray(K),
                      jnp.asarray(gt[2]), jnp.asarray(fg), jnp.asarray(valid),
                      (W, H), **KW)
    out = tv.validate_frame(2, near, K, gt[2], fg, valid, (W, H), **KW)
    assert out["img"].shape == (H, W, 3)
    jv.validate_frame_with_pose_opt(
        pose_fns[0], 3, jnp.asarray(bad_w2c), jnp.asarray(K),
        jnp.asarray(gt[3]), jnp.asarray(fg), jnp.asarray(valid))
    tv.validate_frame_with_pose_opt(pose_fns[1], 3, bad_w2c, K, gt[3], fg,
                                    valid)
    jo, to = jv.compute(), tv.compute()
    assert set(to) == set(jo)
    assert "val/lpips" in to and "val/fg_psnr" in to
    for k in jo:
        if k.endswith("psnr"):
            np.testing.assert_allclose(to[k], jo[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(to[k], jo[k], atol=1e-5, err_msg=k)
    tv.reset_metrics()
    assert len(tv.psnr) == 0 and not tv.lpips_scores


def test_validate_keypoints(scenes):
    js, ts = scenes
    m, _ = compute_poses_fg(js, jnp.asarray([2.0]))
    uvz = (jnp.asarray(K) @ m[:, 0].T).T
    uv = np.asarray(uvz[:, :2] / uvz[:, 2:])
    inb = (uv[:, 0] >= 1) & (uv[:, 0] < W - 1) & (uv[:, 1] >= 1) & \
        (uv[:, 1] < H - 1)
    uv = uv[inb][:12]
    target = uv + np.random.default_rng(0).normal(0, 1.0, uv.shape).astype(
        np.float32)
    args = (2, EYE4, K, 2.0, EYE4, K, np.floor(uv), target, (W, H))
    jp = jval.Validator(js).validate_keypoints(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
        pck_threshold_ratio=0.03, **KW)
    tp = tval.Validator(ts).validate_keypoints(*args,
                                               pck_threshold_ratio=0.03, **KW)
    assert 0.0 < tp < 1.0
    assert tp == jp


def test_save_train_videos(scenes, tmp_path):
    class MiniDS:
        w2cs = np.broadcast_to(EYE4, (2, 4, 4))
        Ks = np.broadcast_to(K, (2, 3, 3))

        def get_img_wh(self):
            return (W, H)

        def __len__(self):
            return 2

    v = tval.Validator(scenes[1], save_dir=str(tmp_path))
    v.save_train_videos(MiniDS(), epoch=1, **KW)
    vids = sorted(os.listdir(tmp_path / "results" / "videos"))
    assert {f.rsplit(".", 1)[0] for f in vids} == {"depth_1", "mask_1",
                                                   "rgb_1"}
    tval.Validator(scenes[1]).save_train_videos(MiniDS(), epoch=2, **KW)
    assert len(os.listdir(tmp_path / "results" / "videos")) == 3
