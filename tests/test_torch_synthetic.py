"""Port vs reference: synthetic scenes and datasets (data/synthetic.py) and
the dataset views (data/views.py).

Both packages draw from numpy default_rng with the same seeds, so the same
scene and dataset come out. The JAX side renders as its own suite does on
the CPU: the oracle branch through its rasterize_ref, the fast branch and
sharp_fg_masks through the Pallas kernels in interpret mode; the port's
through its oracle and its K5 twin (CPU tensors). The reference seeds its
ground-truth MoveModel with jax.random and the port with a
torch.Generator; the heads are zero-initialised, so the mid / first-stage
renders must not depend on it (the fast-branch and mask tests show it).

Bars: scene arrays 1e-6 abs; rendered images, masks' source channels,
depths and tracks 1e-5 abs + 1e-6 relative (float32 renders in another
summation order); thresholded masks, visibilities, integer draws and
every adapter / view item that is a copy: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.data import synthetic as js
from deblur4dgs_tpu.data import views as jv
from deblur4dgs_tpu_torch.data import synthetic as ts
from deblur4dgs_tpu_torch.data import views as tv
from tests.test_torch_models import torch_single_thread  # noqa: F401

ATOL, RTOL = 1e-5, 1e-6
SCENE_KW = dict(seed=3, num_fg=60, num_bg=150, num_frames=4,
                exp_shake=0.02)


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same(a, b, name, atol=ATOL):
    a, b = np_(a), np_(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, atol=atol, rtol=RTOL, err_msg=name)
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_items_equal(ja, tb, name):
    assert set(ja) == set(tb), (name, set(ja) ^ set(tb))
    for k in ja:
        if isinstance(ja[k], (str, int)):
            assert ja[k] == tb[k], (name, k)
        else:
            assert_same(ja[k], tb[k], f"{name}[{k}]")


@pytest.fixture(scope="module")
def scenes():
    return js.make_scene(**SCENE_KW), ts.make_scene(**SCENE_KW, device="cpu")


@pytest.fixture(scope="module")
def oracle_data(scenes):
    js_, ts_ = scenes
    kw = dict(num_blur_samples=3, num_tracks=16, blur_union_masks=True)
    return js.generate_dataset(js_, **kw), ts.generate_dataset(ts_, **kw)


@pytest.fixture(scope="module")
def adapters(scenes, oracle_data):
    (js_, ts_), (jd, td) = scenes, oracle_data
    return {split: (js.SyntheticSceneAdapter(js_, jd, split=split),
                    ts.SyntheticSceneAdapter(ts_, td, split=split))
            for split in ("train", "val")}


@pytest.mark.parametrize("kw", [dict(), SCENE_KW], ids=["default", "shake"])
def test_make_scene(kw):
    j = js.make_scene(**kw)
    t = ts.make_scene(**kw, device="cpu")
    for part in ("fg", "bg"):
        for f in ("means", "quats", "scales", "colors", "opacities",
                  "motion_coefs"):
            a = getattr(getattr(j, part), f)
            if a is None:
                assert getattr(getattr(t, part), f) is None
                continue
            assert_same(getattr(getattr(t, part), f), a, f"{part}.{f}", 1e-6)
    for f in ("rots", "transls"):
        assert_same(getattr(t.bases, f), getattr(j.bases, f), f, 1e-6)
    for f in ("w2cs", "Ks"):
        assert_same(getattr(t, f), getattr(j, f), f, 1e-6)
    assert (j.exp_deltas is None) == (t.exp_deltas is None)
    if j.exp_deltas is not None:
        assert_same(t.exp_deltas, j.exp_deltas, "exp_deltas", 1e-6)
    assert (t.img_wh, t.exposure) == (j.img_wh, j.exposure)


def test_generate_dataset_oracle(oracle_data):
    jd, td = oracle_data
    for f in jd._fields:
        assert_same(getattr(td, f), getattr(jd, f), f)


def test_render_frame(scenes):
    js_, ts_ = scenes
    jimg, jalpha = js.render_frame(js_, 1.5, js_.w2cs[1], js_.Ks[1])
    timg, talpha = ts.render_frame(ts_, 1.5, ts_.w2cs[1], ts_.Ks[1])
    assert_same(timg, jimg, "img")
    assert_same(talpha, jalpha, "alpha")


def test_generate_dataset_fast_renderer():
    """fast_renderer=True at 64x48 (the JAX side through interpret-mode
    Pallas, the port's through the K5 twin)."""
    kw = dict(seed=1, num_frames=3)
    jd = js.generate_dataset(js.make_scene(**kw), num_blur_samples=2,
                             num_tracks=12, fast_renderer=True)
    td = ts.generate_dataset(ts.make_scene(**kw, device="cpu"),
                             num_blur_samples=2, num_tracks=12,
                             fast_renderer=True)
    for f in jd._fields:
        assert_same(getattr(td, f), getattr(jd, f), f)


def test_sharp_fg_masks(scenes):
    js_, ts_ = scenes
    jm = np.asarray(js.sharp_fg_masks(js_, cap=256))
    tm = ts.sharp_fg_masks(ts_, cap=256)
    assert jm.sum() > 0
    np.testing.assert_array_equal(tm, jm)


def test_adapter_surface(adapters):
    ja, ta = adapters["train"]
    assert (len(ta), ta.num_frames, ta.get_img_wh()) == \
        (len(ja), ja.num_frames, ja.get_img_wh())
    np.testing.assert_array_equal(ta.get_dyn_time_ids(),
                                  ja.get_dyn_time_ids())
    assert ta.get_dyn_image_ids() == ja.get_dyn_image_ids()
    for f in ("imgs", "masks", "depths", "Ks", "w2cs"):
        assert_same(getattr(ta, f), getattr(ja, f), f)


@pytest.mark.parametrize("n", [8, 1000])  # a subset; every track
def test_adapter_tracks_and_points(adapters, n):
    ja, ta = adapters["train"]
    for label, jo, to in (("tracks", ja.get_tracks_3d(n),
                           ta.get_tracks_3d(n)),
                          ("points", ja.get_bkgd_points(n),
                           ta.get_bkgd_points(n))):
        for f in jo._fields:
            assert_same(getattr(to, f), getattr(jo, f), f"{label}.{f}")


@pytest.mark.parametrize("split", ["train", "val"])
def test_adapter_items(adapters, split):
    ja, ta = adapters[split]
    for i in range(len(ja)):
        assert_items_equal(ja.get_item(i), ta.get_item(i), f"{split} {i}")


def test_downsample_view(adapters):
    ja, ta = adapters["train"]
    jview, tview = jv.DownsampleView(ja, 2), tv.DownsampleView(ta, 2)
    assert tview.get_img_wh() == jview.get_img_wh()
    for f in ("imgs", "masks", "depths", "Ks", "w2cs"):
        assert_same(getattr(tview, f), getattr(jview, f), f)
    for i in range(len(jview)):
        assert_items_equal(jview.get_item(i), tview.get_item(i), f"item {i}")


def test_window_view(adapters):
    """Window-local times, targets resampled in the window and the track
    arrays re-paired for them (_pair_tracks, the synthetic branch)."""
    ja, ta = adapters["train"]
    jview = jv.WindowView(ja, [1, 2, 3], seed=4)
    tview = tv.WindowView(ta, [1, 2, 3], seed=4)
    for f in ("imgs", "masks", "depths", "Ks", "w2cs"):
        assert_same(getattr(tview, f), getattr(jview, f), f)
    for i in range(len(jview)):
        assert_items_equal(jview.get_item(i), tview.get_item(i), f"item {i}")
    jt, tt = jview.get_tracks_3d(8), tview.get_tracks_3d(8)
    for f in jt._fields:
        assert_same(getattr(tt, f), getattr(jt, f), f"tracks.{f}")


def test_val_slice_view(adapters):
    ja, ta = adapters["val"]
    jview = jv.ValSliceView(ja, 1, 4, t_offset=1, window_len=2)
    tview = tv.ValSliceView(ta, 1, 4, t_offset=1, window_len=2)
    assert len(tview) == len(jview) == 3
    for i in range(len(jview)):
        assert_items_equal(jview.get_item(i), tview.get_item(i), f"item {i}")
