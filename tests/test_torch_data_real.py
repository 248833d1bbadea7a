"""Port vs reference: the real-data layer. data/utils.py's functions, the
COLMAP readers (data/colmap.py, and data/native_colmap.py, which builds
native/colmap_reader.cpp with g++ into build/native/), StereoDataset
(data/stereo.py) on the fabricated scene of tests/test_stereo_dataset.py,
and WindowView's pairwise track re-fetch over it.

The same numpy inputs and on-disk files go to both packages. Bars: every
array within 1e-6 abs (float32 formulas in another order), except the
unprojected points and normals and the background points built from them,
1e-5 abs (float32 matrix inverses and cross products); the readers'
float64 values, integer, boolean and string values equal.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.data import colmap as jcolmap
from deblur4dgs_tpu.data import stereo as jst
from deblur4dgs_tpu.data import utils as ju
from deblur4dgs_tpu.data import views as jv
from deblur4dgs_tpu_torch.data import colmap as tcolmap
from deblur4dgs_tpu_torch.data import native_colmap as tnative
from deblur4dgs_tpu_torch.data import stereo as tst
from deblur4dgs_tpu_torch.data import utils as tu
from deblur4dgs_tpu_torch.data import views as tv
from tests.test_colmap import model_dir  # noqa: F401
from tests.test_stereo_dataset import H, W, scene_dir  # noqa: F401
from tests.test_torch_models import torch_single_thread  # noqa: F401
from tests.test_torch_synthetic import assert_items_equal, np_

ATOL = 1e-6


def assert_close(a, b, name):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


def camera_rig(rng, T):
    inv_Ks = np.linalg.inv(np.tile(np.array(
        [[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]), (T, 1, 1)))
    c2ws = np.tile(np.eye(4), (T, 1, 1))
    c2ws[:, :3, 3] = rng.normal(0, 0.1, (T, 3))
    return inv_Ks.astype(np.float32), c2ws.astype(np.float32)


def test_data_utils():
    rng = np.random.default_rng(0)
    f = np.float32
    xy = rng.uniform(-2, [W + 2, H + 2], (40, 2)).astype(f)
    assert_close(tu.normalize_coords(xy, H, W),
                 ju.normalize_coords(jnp.asarray(xy), H, W), "normalize")
    occ, dist = (rng.normal(0, 2, (5, 40)).astype(f) for _ in range(2))
    for name, a, b in zip(("visible", "invisible", "confidence"),
                          tu.parse_tapir_track_info(occ, dist),
                          ju.parse_tapir_track_info(jnp.asarray(occ),
                                                    jnp.asarray(dist))):
        assert_close(a, b, name)
    for shape in ((H, W), (H, W, 3)):
        img = rng.uniform(size=shape).astype(f)
        assert_close(tu.bilinear_sample(img, xy),
                     ju.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)),
                     f"bilinear {shape}")
    T = 4
    depths = rng.uniform(1, 4, (T, H, W)).astype(f)
    masks = (rng.uniform(size=(T, H, W)) > 0.5).astype(f)
    inv_Ks, c2ws = camera_rig(rng, T)
    tracks = np.concatenate([rng.uniform(0, [W, H], (30, T, 2)),
                             rng.normal(0, 2, (30, T, 2))], -1).astype(f)
    qimg = rng.uniform(size=(H, W, 3)).astype(f)
    outs = zip(("xyz", "colors", "visibles", "invisibles", "confidences"),
               tu.get_tracks_3d_for_query_frame(1, qimg, tracks, depths,
                                                masks, inv_Ks, c2ws),
               ju.get_tracks_3d_for_query_frame(
                   1, *map(jnp.asarray, (qimg, tracks, depths, masks,
                                         inv_Ks, c2ws))))
    for name, a, b in outs:
        assert_close(a, b, name)
    K = np.linalg.inv(inv_Ks[0])
    w2c = np.linalg.inv(c2ws[1])
    for name, fn_t, fn_j in (
            ("points", tu.depth_to_points_world, ju.depth_to_points_world),
            ("normals", tu.normal_from_depth_image,
             ju.normal_from_depth_image)):
        a = fn_t(depths[0], K, w2c)
        b = fn_j(jnp.asarray(depths[0]), jnp.asarray(K), jnp.asarray(w2c))
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(
        tu.masked_median_blur(depths, masks, ksize=5),
        ju.masked_median_blur(depths, masks, ksize=5))


def assert_cameras_equal(a, b):
    assert set(a) == set(b)
    for k in b:
        assert (a[k].model, a[k].width, a[k].height) == \
            (b[k].model, b[k].width, b[k].height)
        np.testing.assert_array_equal(a[k].params, b[k].params)
        np.testing.assert_array_equal(a[k].K, b[k].K)


def assert_images_equal(a, b, with_points=True):
    assert set(a) == set(b)
    for k in b:
        assert (a[k].name, a[k].camera_id) == (b[k].name, b[k].camera_id)
        np.testing.assert_array_equal(a[k].qvec, b[k].qvec)
        np.testing.assert_array_equal(a[k].tvec, b[k].tvec)
        np.testing.assert_array_equal(a[k].w2c, b[k].w2c)
        if with_points:
            np.testing.assert_array_equal(a[k].xys, b[k].xys)
            np.testing.assert_array_equal(a[k].point3D_ids,
                                          b[k].point3D_ids)


def test_colmap_python_reader(model_dir):  # noqa: F811
    d = model_dir[0]
    assert_cameras_equal(tcolmap.read_cameras_binary(str(d / "cameras.bin")),
                         jcolmap.read_cameras_binary(str(d / "cameras.bin")))
    assert_images_equal(tcolmap.read_images_binary(str(d / "images.bin")),
                        jcolmap.read_images_binary(str(d / "images.bin")))
    names = [im.name for im in model_dir[2]]
    for a, b in zip(tcolmap.get_colmap_camera_params(str(d), names),
                    jcolmap.get_colmap_camera_params(str(d), names)):
        np.testing.assert_array_equal(a, b)
    R = tcolmap.qvec_to_rotmat(model_dir[2][0].qvec)
    np.testing.assert_array_equal(tcolmap.rotmat_to_qvec(R),
                                  jcolmap.rotmat_to_qvec(R))


def test_native_colmap_reader(model_dir):  # noqa: F811
    """The library builds into build/native/ wherever g++ exists (else the
    readers fall back to the Python parser), and reads what it reads."""
    d = model_dir[0]
    lib = tnative.get_lib()
    if shutil.which("g++") is not None:
        assert lib is not None
        assert tnative._LIB.endswith("build/native/libcolmap_reader.so")
    assert_cameras_equal(tnative.read_cameras_binary(str(d / "cameras.bin")),
                         jcolmap.read_cameras_binary(str(d / "cameras.bin")))
    assert_images_equal(tnative.read_images_binary(str(d / "images.bin")),
                        jcolmap.read_images_binary(str(d / "images.bin")),
                        with_points=lib is None)


def stereo_pair(scene_dir, **kw):  # noqa: F811
    cfg = dict(data_dir=scene_dir, end=8, intrinsics_scale=1.0,
               max_train_frames=8, load_from_cache=False,
               num_targets_per_frame=3, **kw)
    return (jst.StereoDataset(jst.StereoDataConfig(**cfg)),
            tst.StereoDataset(tst.StereoDataConfig(**cfg)))


ARRAYS = ("imgs", "masks", "depths", "Ks", "w2cs", "valid_masks",
          "time_ids")


def test_stereo_train_split(scene_dir):  # noqa: F811
    jd, td = stereo_pair(scene_dir)
    for f in ARRAYS:
        assert_close(getattr(td, f), getattr(jd, f), f)
    assert td.frame_names == jd.frame_names
    assert_close(td.scene_norm["transfm"], jd.scene_norm["transfm"],
                 "transfm")
    np.testing.assert_allclose(td.scene_norm["scale"], jd.scene_norm["scale"],
                               rtol=1e-6)
    for i in range(len(jd)):
        assert_items_equal(jd.get_item(i), td.get_item(i), f"item {i}")
    jt, tt = jd.get_tracks_3d(num_samples=100), td.get_tracks_3d(100)
    for f in jt._fields:
        assert_close(getattr(tt, f), getattr(jt, f), f"tracks.{f}")
    jp, tp = jd.get_bkgd_points(200), td.get_bkgd_points(200)
    for f in jp._fields:
        np.testing.assert_allclose(np_(getattr(tp, f)),
                                   np.asarray(getattr(jp, f)), atol=1e-5,
                                   err_msg=f"points.{f}")


def test_stereo_val_split_and_window_view(scene_dir):  # noqa: F811
    jd, td = stereo_pair(scene_dir)
    kw = dict(data_dir=scene_dir, end=8, split="val", intrinsics_scale=1.0,
              max_train_frames=8)
    jval = jst.StereoDataset(jst.StereoDataConfig(**kw),
                             scene_norm=jd.scene_norm)
    tval = tst.StereoDataset(tst.StereoDataConfig(**kw),
                             scene_norm=jd.scene_norm)
    assert len(tval) == len(jval) == 16
    for f in ARRAYS:
        assert_close(getattr(tval, f), getattr(jval, f), f)
    for i in (0, 5, 15):
        assert_items_equal(jval.get_item(i), tval.get_item(i), f"val {i}")
    # WindowView re-pairs the stereo tracks through the pairwise loader
    jw, tw = jv.WindowView(jd, [2, 3, 4, 5], seed=1), \
        tv.WindowView(td, [2, 3, 4, 5], seed=1)
    for i in range(len(jw)):
        assert_items_equal(jw.get_item(i), tw.get_item(i), f"window {i}")
    assert isinstance(tw.get_tracks_3d(40).xyz, torch.Tensor)
