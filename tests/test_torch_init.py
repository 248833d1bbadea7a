"""Port vs reference: the scene bootstrap (train/init.py), its Lie helpers,
the observation bundles and the capacity padding.

Both packages take the same numpy inputs (tests/test_init.py's synthetic
rigid-cluster tracks: 200 tracks, 8 frames, 2 clusters). Bars: the host
helpers (knn distances, k-means labels, interpolation, Procrustes weights)
and every integer or mask output exactly equal; the float32 Procrustes fits
and the bootstrap's float outputs within 1e-5 (SVD and reductions in
another order); run_initial_optim's 20 Adam steps within rel 1e-4 of each
tensor's max (float32 reassociation through 20 steps of the track losses).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.data.observations import StaticObservations as JStatic
from deblur4dgs_tpu.data.observations import TrackObservations as JTracks
from deblur4dgs_tpu.models import gaussians as jg
from deblur4dgs_tpu.ops import lie as jlie
from deblur4dgs_tpu.train import init as ji
from deblur4dgs_tpu_torch.data.observations import StaticObservations
from deblur4dgs_tpu_torch.data.observations import TrackObservations
from deblur4dgs_tpu_torch.models import gaussians as tg
from deblur4dgs_tpu_torch.models.motion_bases import MotionBases
from deblur4dgs_tpu_torch.ops import lie as tlie
from deblur4dgs_tpu_torch.train import init as ti
from tests.test_init import make_tracks
from tests.test_torch_models import torch_single_thread  # noqa: F401

ATOL = 1e-5
OPT_REL = 1e-4
CPU = dict(device="cpu")


def tracks_np(seed=0, occlude=False):
    """make_tracks' arrays as numpy. ``occlude`` hides a few samples and
    adds 0.02 of position noise: on the exactly rigid tracks the fitted
    bases leave residuals at float32 rounding level, where the L1 losses'
    gradient signs (and so Adam's first steps, ~lr * sign(g)) are rounding
    noise in either package."""
    tracks, _, _ = make_tracks(seed=seed)
    arrs = [np.array(x) for x in tracks]
    if occlude:
        rng = np.random.default_rng(seed)
        arrs[0] += 0.02 * rng.normal(size=arrs[0].shape).astype(np.float32)
        hide = rng.uniform(size=arrs[1].shape) < 0.1
        hide[:, 0] = False
        arrs[1] = arrs[1] & ~hide
        arrs[2] = ~arrs[1]
        arrs[3] = rng.uniform(0.5, 1.0, arrs[3].shape).astype(np.float32)
    return arrs


def both(arrs):
    return (JTracks(*map(jnp.asarray, arrs)),
            TrackObservations(*map(torch.as_tensor, arrs)))


def static_np(n=150, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32) * 2,
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))


def test_knn_and_kmeans_exact():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 3)).astype(np.float32)
    np.testing.assert_array_equal(ti.knn_dists(x, 3), ji.knn_dists(x, 3))
    v = rng.normal(size=(300, 14)).astype(np.float32)
    np.testing.assert_array_equal(ti.kmeans(v, 4, seed=3),
                                  ji.kmeans(v, 4, seed=3))


def test_interp_centers_and_weights_exact():
    arrs = tracks_np(1, occlude=True)
    jt_, tt_ = both(arrs)
    np.testing.assert_array_equal(ti.interp_masked(arrs[0], arrs[1]),
                                  ji.interp_masked(arrs[0], arrs[1]))
    jc, jl = ji.sample_initial_bases_centers(2, jt_, 3, seed=1)
    tc, tl = ti.sample_initial_bases_centers(2, tt_, 3, seed=1)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)
    with pytest.raises(NotImplementedError, match="hdbscan"):
        ti.sample_initial_bases_centers(2, tt_, 3, mode="hdbscan")
    cl = arrs[0][:50].swapaxes(0, 1)
    vis = arrs[1][:50].swapaxes(0, 1)
    np.testing.assert_array_equal(ti.get_weights_for_procrustes(cl, vis),
                                  ji.get_weights_for_procrustes(cl, vis))


@pytest.mark.parametrize("enforce_se3", [True, False])
def test_solve_procrustes(enforce_se3):
    rng = np.random.default_rng(5)
    src = rng.normal(size=(60, 3)).astype(np.float32)
    wu = rng.normal(size=6).astype(np.float32) * 0.4
    pose = np.asarray(jlie.se3_exp(jnp.asarray(wu)))
    dst = (1.3 * (src @ pose[:3, :3].T + pose[:3, 3])
           + 0.01 * rng.normal(size=src.shape)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, 60).astype(np.float32)
    (jq, jt_, js), je = jlie.solve_procrustes(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), enforce_se3)
    (tq, tt_, ts), te = tlie.solve_procrustes(
        torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w),
        enforce_se3)
    sign = np.sign(float(np.dot(np.asarray(jq), tq.numpy())))
    np.testing.assert_allclose(sign * tq.numpy(), jq, atol=ATOL)
    np.testing.assert_allclose(tt_.numpy(), jt_, atol=ATOL)
    np.testing.assert_allclose(float(ts), float(js), rtol=ATOL)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-4, atol=ATOL)


def test_pose_helpers():
    rng = np.random.default_rng(2)
    A = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(size=(4, 6)),
                                            jnp.float32)))[:, :3]
    B = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(size=(4, 6)),
                                            jnp.float32)))[:, :3]
    np.testing.assert_allclose(
        tlie.pose_compose(torch.as_tensor(A), torch.as_tensor(B)).numpy(),
        jlie.pose_compose(jnp.asarray(A), jnp.asarray(B)), atol=1e-6)
    np.testing.assert_allclose(tlie.pose_inverse(torch.as_tensor(A)).numpy(),
                               jlie.pose_inverse(jnp.asarray(A)), atol=1e-6)
    np.testing.assert_array_equal(
        tlie.rmat_to_cont_6d(torch.as_tensor(A[:, :, :3])).numpy(),
        jlie.rmat_to_cont_6d(jnp.asarray(A[:, :, :3])))


def test_observations_and_padding():
    arrs = tracks_np(2)
    _, tt_ = both(arrs)
    assert tt_.check_sizes()
    keep = np.arange(200) % 3 == 0
    sub = tt_.filter_valid(torch.as_tensor(keep))
    for a, b in zip(sub, arrs):
        np.testing.assert_array_equal(a.numpy(), b[keep])
    assert not TrackObservations(*tt_[:4], tt_.colors[:, :2]).check_sizes()
    pts = StaticObservations(*map(torch.as_tensor, static_np()))
    g, _ = ti.init_bg(pts, **CPU)
    jgauss, _ = ji.init_bg(JStatic(*map(jnp.asarray, static_np())))
    jp = jg.pad_to_capacity(jgauss, 256)
    tp = tg.pad_to_capacity(g, 256)
    assert tp.capacity == 256 and int(tp.num_alive()) == 150
    for f in ("means", "quats", "scales", "colors", "opacities", "alive"):
        np.testing.assert_allclose(getattr(tp, f).detach().numpy(),
                                   getattr(jp, f), atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(tp.quats[150:].detach().numpy(),
                                  np.tile([1.0, 0, 0, 0], (106, 1)))
    for a, b in zip(tg.concat_gaussians(tp, tp), jg.concat_gaussians(jp, jp)):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=ATOL)
    assert ti.round_capacity(int(150 * 1.5)) == 256
    assert ti.round_capacity(257) == 512


def test_init_fg_and_bg():
    arrs = tracks_np(0)
    jt_, tt_ = both(arrs)
    coefs = np.random.default_rng(0).normal(size=(200, 2)).astype(np.float32)
    jf = ji.init_fg_from_tracks_3d(3, jt_, jnp.asarray(coefs), seed=4)
    tf = ti.init_fg_from_tracks_3d(3, tt_, torch.as_tensor(coefs), seed=4,
                                   **CPU)
    for f in ("means", "quats", "scales", "colors", "opacities",
              "motion_coefs"):
        np.testing.assert_array_equal(getattr(tf, f).detach().numpy(),
                                      getattr(jf, f), err_msg=f)
    sa = static_np()
    jb, jscale = ji.init_bg(JStatic(*map(jnp.asarray, sa)))
    tb, tscale = ti.init_bg(StaticObservations(*map(torch.as_tensor, sa)),
                            **CPU)
    assert tscale == jscale
    for f in ("means", "scales", "colors", "opacities"):
        np.testing.assert_array_equal(getattr(tb, f).detach().numpy(),
                                      getattr(jb, f), err_msg=f)
    np.testing.assert_allclose(tb.quats.detach().numpy(), jb.quats,
                               atol=ATOL)


@pytest.fixture(scope="module")
def procrustes_both():
    arrs = tracks_np(0, occlude=True)
    jt_, tt_ = both(arrs)
    jout = ji.init_motion_params_with_procrustes(jt_, 2, 0, seed=0)
    tout = ti.init_motion_params_with_procrustes(tt_, 2, 0, seed=0, **CPU)
    return arrs, jout, tout


def test_init_motion_params_with_procrustes(procrustes_both):
    _, (jb, jc, jtr), (tb, tc, ttr) = procrustes_both
    for a, b in zip(ttr, jtr):  # the filtered tracks
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=ATOL)
    np.testing.assert_allclose(tb.rots.detach().numpy(), jb.rots, atol=ATOL)
    np.testing.assert_allclose(tb.transls.detach().numpy(), jb.transls,
                               atol=ATOL)
    assert float(np.abs(np.asarray(jb.transls)).max()) > 0.1  # fits moved


def test_run_initial_optim(procrustes_both):
    """From the same inputs (the reference's Procrustes fit): its canonical
    frame fits the tracks to float32 rounding, so a fit that differs in the
    last bit flips the L1 gradient signs there."""
    arrs, (jb, jc, jtr), _ = procrustes_both
    T = arrs[0].shape[1]
    Ks = np.tile(np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]],
                          np.float32), (T, 1, 1))
    w2cs = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    w2cs[:, 2, 3] = 6.0
    jf = ji.init_fg_from_tracks_3d(0, jtr, jc)
    ttr = TrackObservations(*(torch.as_tensor(np.array(x)) for x in jtr))
    tf = ti.init_fg_from_tracks_3d(0, ttr, torch.as_tensor(np.asarray(jc)),
                                   **CPU)
    tb = MotionBases(torch.as_tensor(np.asarray(jb.rots)),
                     torch.as_tensor(np.asarray(jb.transls)))
    jf2, jb2, jl = ji.run_initial_optim(jf, jb, jtr, jnp.asarray(Ks),
                                        jnp.asarray(w2cs), num_iters=20)
    tf2, tb2, tl = ti.run_initial_optim(tf, tb, ttr, torch.as_tensor(Ks),
                                        torch.as_tensor(w2cs), num_iters=20,
                                        **CPU)

    def rel(a, b, msg):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(np.asarray(a) / scale, b / scale,
                                   atol=OPT_REL, rtol=0, err_msg=msg)

    rel(tl.numpy(), jl, "losses")
    assert float(tl[-1]) < float(tl[1])
    rel(tf2.means.detach().numpy(), jf2.means, "means")
    rel(tf2.motion_coefs.detach().numpy(), jf2.motion_coefs, "coefs")
    rel(tb2.rots.detach().numpy(), jb2.rots, "rots")
    rel(tb2.transls.detach().numpy(), jb2.transls, "transls")
    np.testing.assert_array_equal(tf2.quats.detach().numpy(), jf2.quats)
