"""Port vs reference: the reference's leftover paths.

  * ops/tiling.py: the top-k binning ``bin_gaussians``, ``bucket_tiles``
    on its lists, ``pack_dyn`` and ``pack_dyn_fused``; every integer output
    and every gathered payload equal (a random 128x128 window and the
    320x160 grid whose ties the stable sorts must break by index; see
    tests/test_torch_tiling.py);
  * ops/rasterize.py: the plain compositors without the early stop
    (``composite_{window,split,dense}_nostop``) against the reference's
    ``_composite_window_xla``, ``_composite_split_xla`` and
    ``_composite_xla``, values and gradients, in one chunk of rows and in
    several (each recomputed in the backward); ``rasterize_split_buckets``
    through the port's K4 (its twins: the window kernels at S = 1 with the
    buckets' tile ids) and through its plain compositor, both against the
    reference's plain XLA path (at this size the early stop never fires);
  * models/scene.py: render(use_pallas=False) against the reference's
    use_pallas=False render on its three paths (the bucketed window at
    128x128, the split path at 64x48, the sharp 'mid' render through the
    dense payload), values and gradients;
  * train/losses.py: masked_huber_loss, ssim_loss and tv_loss, values and
    gradients;
  * ``use_pallas`` reaches the pipeline's and the validator's renders
    (render_sharp_frames, validate_frame, the pose refiner, the train
    videos: each composites through the no-stop compositor with
    use_pallas=False), and the CLI's ``train --no-pallas`` clears
    RenderConfig.use_pallas of the pipeline and of the live viewer.

Bars: the port's (tests/test_torch_rasterize.py): forward 2e-4 abs (depth
2e-3: its units are ~3), gradients 5e-3 of max |g|. Each JAX function is
compiled once (tests/test_torch_models.py::compile_once); the three
renders in threads.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.models import scene as jscene
from deblur4dgs_tpu.ops import rasterize as jr
from deblur4dgs_tpu.ops import tiling as jt
from deblur4dgs_tpu.ops.projection import Projected as JProjected
from deblur4dgs_tpu.train import losses as jl
from deblur4dgs_tpu_torch import cli
from deblur4dgs_tpu_torch.convert import scene_from_numpy
from deblur4dgs_tpu_torch.models import scene as tscene
from deblur4dgs_tpu_torch.ops import rasterize as tr
from deblur4dgs_tpu_torch.ops import tiling as tt
from deblur4dgs_tpu_torch.ops.projection import Projected as TProjected
from deblur4dgs_tpu_torch.train import losses as tl
from tests.test_torch_cli import TRAIN
from tests.test_torch_dense import K48
from tests.test_torch_models import (
    K128,
    assert_grads_match,
    compile_once,
    jax_scene,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_rasterize import NCHAN, TILES_X, assert_rel, make_data
from tests.test_torch_tiling import random_window, tied_window

FWD_ATOL = 2e-4
GRAD_REL = 5e-3

WINDOWS = {
    "random_128": (lambda: random_window(0, 3, 400, 128, 128), (128, 128),
                   256),
    "tied_320x160": (lambda: tied_window(3, 320, 160), (320, 160), 256),
}


def _projs(case):
    make, img_wh, cap = WINDOWS[case]
    arrs = make()
    return (JProjected(*map(jnp.asarray, arrs)),
            TProjected(*map(torch.as_tensor, arrs)), img_wh, cap)


def _view(p, s):
    return type(p)(*(x[s] for x in p))


# ---------------------------------------------------------------------------
# tiling.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(WINDOWS))
def test_topk_binning_and_buckets_equal(case):
    jp, tp, img_wh, cap = _projs(case)
    jv, tv = _view(jp, 1), _view(tp, 1)
    jout = jt.bin_gaussians(jv, img_wh, cap, tile_batch=64)
    tout = tt.bin_gaussians(tv, img_wh, cap, tile_batch=64)
    for name, a, b in zip(("gather_idx", "counts", "raw", "order"), tout,
                          jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert int(tout[2].max()) > 0 and int(tout[0].min()) < tv.depths.shape[0]
    G = tv.depths.shape[0]
    tx, ty = tt.num_tiles(img_wh)
    spec = tt.default_bucket_spec(tx * ty, cap)
    jb = jt.bucket_tiles(*jout[:3], G, spec)
    tb = tt.bucket_tiles(*tout[:3], G, spec)
    assert tb.caps == jb.caps and tb.sizes == jb.sizes
    for f in ("tile_ids", "counts", "gather_idx"):
        for a, b in zip(getattr(tb, f), getattr(jb, f)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), f)


def test_topk_binning_fewer_gaussians_than_cap():
    jp, tp, img_wh, _ = _projs("random_128")
    jv, tv = _view(jp, 0), _view(tp, 0)
    cut = lambda p: type(p)(*(x[:100] for x in p))
    jout = jt.bin_gaussians(cut(jv), img_wh, 256)
    tout = tt.bin_gaussians(cut(tv), img_wh, 256)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("depth", [False, True])
def test_pack_dyn_and_fused_equal(depth):
    jp, tp, img_wh, cap = _projs("random_128")
    gi, _, _, order = jt.bin_gaussians_union(jp, img_wh, cap)
    tgi, torder = torch.tensor(np.asarray(gi)), torch.tensor(
        np.asarray(order))
    a = tt.pack_dyn(_view(tp, 2), tgi, torder, depth)
    b = jt.pack_dyn(_view(jp, 2), gi, order, depth)
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    a = tt.pack_dyn_fused(tp, tgi, torder, depth)
    b = jt.pack_dyn_fused(jp, gi, order, depth)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# rasterize.py
# ---------------------------------------------------------------------------


def _nostop_case(kind):
    """(port fn, reference fn, differentiable inputs, static args)."""
    dyn, st, counts, ids = make_data(5, 3, n_tiles=8, cap=256, hi=200,
                                     dense=True)
    c, i = jnp.asarray(counts), jnp.asarray(ids)
    if kind == "window":
        return (lambda d, s: tr.composite_window_nostop(
                    d, s, torch.as_tensor(counts), torch.as_tensor(ids),
                    TILES_X, NCHAN, True),
                lambda d, s: jr._composite_window_xla(d, s, c, i, TILES_X,
                                                      NCHAN, True),
                (dyn, st))
    if kind == "split":
        return (lambda d, s: tr.composite_split_nostop(
                    d, s, torch.as_tensor(counts), torch.as_tensor(ids),
                    TILES_X, NCHAN, True),
                lambda d, s: jr._composite_split_xla(d, s, c, i, TILES_X,
                                                     NCHAN, True),
                (dyn[:, 0], st))
    # dense: the reference's (T, 7+D, cap) payload, row t = tile t
    D = NCHAN - 1
    data = np.concatenate([dyn[:, 0, :5], st[:, :1], dyn[:, 0, 5:6],
                           st[:, 1:]], axis=1)
    return (lambda x: tr.composite_dense_nostop(x, torch.as_tensor(counts),
                                                TILES_X, D),
            lambda x: jr._composite_xla(x, c, TILES_X, D),
            (data,))


@pytest.mark.parametrize("chunk_rows", [None, 3])
@pytest.mark.parametrize("kind", ["window", "split", "dense"])
def test_nostop_compositors_against_reference(kind, chunk_rows, monkeypatch):
    port, ref, ins = _nostop_case(kind)
    if chunk_rows:  # several chunks: each recomputed in the backward
        S = ins[0].shape[1] if kind == "window" else 1
        monkeypatch.setattr(tr, "NOSTOP_CHUNK_ELEMS",
                            chunk_rows * S * tr.P * ins[0].shape[-1])
    outs_j = jax.eval_shape(ref, *map(jnp.asarray, ins))
    rng = np.random.default_rng(1)
    ws = [rng.normal(size=o.shape).astype(np.float32) for o in outs_j]

    def jloss(*xs):
        outs = ref(*xs)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), outs

    argnums = tuple(range(len(ins)))
    fn = compile_once(jax.jit(jax.grad(jloss, argnums, has_aux=True)),
                      *map(jnp.asarray, ins))
    jg, jo = fn(*map(jnp.asarray, ins))
    xs = [torch.tensor(x, requires_grad=True) for x in ins]
    to = port(*xs)
    for a, b in zip(to, jo):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, atol=FWD_ATOL,
                                   rtol=0)
    sum((o * torch.as_tensor(w)).sum() for o, w in zip(to, ws)).backward()
    for x, g in zip(xs, jg):
        assert_rel(x.grad.numpy(), g, GRAD_REL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_rasterize_split_buckets_against_reference(use_pallas):
    """One sub-frame through the 128x128 window's count-sorted buckets,
    with the gradient of the combined payload table."""
    jp, tp, img_wh, cap = _projs("random_128")
    rng = np.random.default_rng(2)
    G = tp.depths.shape[1]
    op = rng.uniform(0.1, 0.9, G).astype(np.float32)
    ch = rng.uniform(0, 1, (G, 4)).astype(np.float32)  # rgb + mask
    bg = np.array([1.0, 1.0, 1.0, 0.0, 0.0], np.float32)
    tx, ty = tt.num_tiles(img_wh)
    spec = tt.default_bucket_spec(tx * ty, cap)
    rank, starts, _, raw, order = jt.bin_gaussians_union_runs(jp, img_wh,
                                                              cap)
    jb = jt.bucket_tiles_from_runs(rank, starts, raw, G, spec)
    tb = tt.TileBuckets(*(tuple(torch.tensor(np.asarray(x)) for x in f)
                          if isinstance(f[0], jax.Array) else f for f in jb))
    jv = _view(jp, 1)
    jv = jv._replace(means2d=jv.means2d[None], conics=jv.conics[None],
                     depths=jv.depths[None], radii=jv.radii[None],
                     valid=jv.valid[None])
    tbl = np.asarray(jnp.concatenate([
        jt.packed_dyn_table(jv, order, True),
        jt.packed_static_table(jnp.asarray(op), jnp.asarray(ch), order)], 1))
    w = rng.normal(size=(img_wh[1], img_wh[0], 5)).astype(np.float32)

    def jloss(t):
        packed = [jt.pack_window_fused(gi, t, 1, 7) for gi in jb.gather_idx]
        img, alpha = jr.rasterize_split_buckets(
            jb, [p[1] for p in packed], [p[0][:, 0] for p in packed],
            jnp.asarray(bg), img_wh, True, use_pallas=False)
        return jnp.sum(img * w) + jnp.sum(alpha), (img, alpha)

    jg, (jimg, jalpha) = compile_once(jax.jit(jax.grad(jloss, has_aux=True)),
                                      jnp.asarray(tbl))(jnp.asarray(tbl))
    jimg, jalpha = np.asarray(jimg), np.asarray(jalpha)
    t = torch.tensor(tbl, requires_grad=True)
    packed = [tt.pack_window_fused(gi, t, 1, 7) for gi in tb.gather_idx]
    img, alpha = tr.rasterize_split_buckets(
        tb, [p[1] for p in packed], [p[0][:, 0] for p in packed],
        torch.as_tensor(bg), img_wh, True, use_pallas=use_pallas)
    np.testing.assert_allclose(img.detach().numpy(), jimg, atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(alpha.detach().numpy(), jalpha, atol=FWD_ATOL,
                               rtol=0)
    assert float(alpha.detach().max()) > 0.5
    ((img * torch.as_tensor(w)).sum() + alpha.sum()).backward()
    assert_rel(t.grad.numpy(), jg, GRAD_REL)


# ---------------------------------------------------------------------------
# render(use_pallas=False)
# ---------------------------------------------------------------------------

RENDERS = {  # img_wh, K, render keywords
    "window_128": ((128, 128), K128, dict(mode="blury", return_mask=True,
                                           return_depth=True)),
    "split_64x48": ((64, 48), K48, dict(mode="blury", return_mask=True,
                                         return_depth=True)),
    "mid_dense_128": ((128, 128), K128, dict(mode="mid", return_mask=True)),
}


VIEW = np.eye(4, dtype=np.float32)
VIEW[:3, 3] = [0.05, -0.02, 0.1]


def _render_kw(case):
    img_wh, K, kw = RENDERS[case]
    keys = [k for k in ("img", "acc", "mask", "depth") if k != "depth"
            or kw.get("return_depth")]
    return img_wh, K, dict(kw, num_exposure=3, cap=256, use_pallas=False), \
        keys


def _render_weights(case):
    (W, H), _, _, keys = _render_kw(case)
    rng = np.random.default_rng(6)
    return {k: rng.normal(size=(H, W, 3 if k == "img" else 1)).astype(
        np.float32) for k in keys}


@pytest.fixture(scope="module")
def jax_renders():
    """The reference's use_pallas=False renders and their gradients, the
    three cases compiled in threads (XLA compiles with the interpreter
    lock released)."""
    arrays = scene_arrays(seed=31)

    def one(case):
        img_wh, K, kw, keys = _render_kw(case)
        ws = _render_weights(case)

        def jloss(s):
            o = jscene.render(s, 3.0, jnp.asarray(VIEW), jnp.asarray(K),
                              img_wh, **kw)
            return sum(jnp.sum(o[k] * ws[k]) for k in keys), o

        js = jax_scene(arrays)
        return compile_once(jax.jit(jax.grad(jloss, has_aux=True)), js)(js)

    with ThreadPoolExecutor(len(RENDERS)) as ex:
        futs = {case: ex.submit(one, case) for case in RENDERS}
        return arrays, {case: f.result() for case, f in futs.items()}


@pytest.mark.parametrize("case", list(RENDERS))
def test_render_no_pallas_against_reference(case, jax_renders):
    arrays, refs = jax_renders
    jg, jo = refs[case]
    img_wh, K, kw, keys = _render_kw(case)
    ws = _render_weights(case)
    ts = scene_from_numpy(arrays, device="cpu")
    tout = tscene.render(ts, torch.tensor(3.0), torch.as_tensor(VIEW),
                         torch.as_tensor(K), img_wh, **kw)
    for k in keys + ["pred_sharp_img"]:
        atol = FWD_ATOL * (10 if k == "depth" else 1)
        np.testing.assert_allclose(tout[k].detach().numpy(), jo[k],
                                   atol=atol, rtol=0, err_msg=k)
    assert float(tout["acc"].detach().max()) > 0.5
    sum((tout[k] * torch.as_tensor(ws[k])).sum() for k in keys).backward()
    assert_grads_match(jg, ts, GRAD_REL, rel=True)


# ---------------------------------------------------------------------------
# losses.py
# ---------------------------------------------------------------------------


def _loss_cases():
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (20, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.3, size=a.shape), 0, 1).astype(
        np.float32)
    b[:2] = a[:2]  # exact zero residuals
    m = (rng.uniform(size=(20, 24)) < 0.6).astype(np.float32)
    return {
        "huber": (lambda L, x, y: L.masked_huber_loss(x, y, 0.2), (a, b)),
        "huber_mask": (lambda L, x, y: L.masked_huber_loss(
            x, y, 0.2, mask=_arr(L, m)), (a, b)),
        "huber_mask_sum": (lambda L, x, y: L.masked_huber_loss(
            x, y, 0.2, mask=_arr(L, m), normalize=False), (a, b)),
        "ssim_loss": (lambda L, x, y: L.ssim_loss(x, y), (a, b)),
        "tv": (lambda L, x: L.tv_loss(x), (b,)),
    }


def _arr(L, x):
    return jnp.asarray(x) if L is jl else torch.as_tensor(x)


@pytest.mark.parametrize("name", list(_loss_cases()))
def test_losses_against_reference(name):
    fn, ins = _loss_cases()[name]
    argnums = tuple(range(len(ins)))
    jins = [jnp.asarray(x) for x in ins]
    jv, jg = compile_once(jax.jit(jax.value_and_grad(
        lambda *x: fn(jl, *x), argnums)), *jins)(*jins)
    xs = [torch.tensor(x, requires_grad=True) for x in ins]
    tv = fn(tl, *xs)
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    for x, g in zip(xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# use_pallas through the pipeline, the validator and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def nostop_calls(monkeypatch):
    """Calls of each no-stop compositor while the test runs."""
    calls = {"window": 0, "split": 0, "dense": 0}

    def counting(kind):
        fn = getattr(tr, f"composite_{kind}_nostop")

        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    for kind in calls:
        monkeypatch.setattr(tr, f"composite_{kind}_nostop", counting(kind))
    return calls


def test_use_pallas_reaches_the_sharp_renders(nostop_calls, tmp_path):
    from deblur4dgs_tpu_torch import configs as tcfg
    from deblur4dgs_tpu_torch import pipeline as PL
    from deblur4dgs_tpu_torch.eval import validator as tval

    W, H = 48, 32
    K = np.array([[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]], np.float32)
    eye = np.eye(4, dtype=np.float32)

    class MiniDS:
        w2cs = np.broadcast_to(eye, (2, 4, 4))
        Ks = np.broadcast_to(K, (2, 3, 3))

        def get_img_wh(self):
            return (W, H)

        def __len__(self):
            return 2

    scene = scene_from_numpy(scene_arrays(seed=5), device="cpu")
    kw = dict(num_exposure=3, cap=256, use_pallas=False)
    cfg = PL.PipelineConfig(render=tcfg.RenderConfig(
        num_exposure=3, tile_cap=256, use_pallas=False), device="cpu",
        work_dir=str(tmp_path))
    counts = []
    for run in (
        lambda: PL.render_sharp_frames(scene, MiniDS(), cfg),
        lambda: tval.Validator(scene).validate_frame(
            2, eye, K, np.zeros((H, W, 3), np.float32),
            np.zeros((H, W), np.float32), np.ones((H, W), np.float32),
            (W, H), **kw),
        lambda: tval.make_pose_opt_fn((W, H), num_iters=1, **kw)(
            scene, 2, eye, K, torch.zeros((H, W, 3))),
        lambda: tval.Validator(scene, save_dir=str(tmp_path)
                               ).save_train_videos(MiniDS(), 1, **kw),
    ):
        before = nostop_calls["dense"]
        run()
        counts.append(nostop_calls["dense"] - before)
    assert counts == [2, 1, 2, 2], counts


def test_cli_no_pallas_reaches_the_pipeline(monkeypatch, tmp_path):
    from deblur4dgs_tpu_torch import pipeline as PL
    from deblur4dgs_tpu_torch.vis import viewer as tviewer

    seen = {}

    def train_low(train_ds, val_ds, cfg, writer, viewer=None, **kw):
        seen["cfg"], seen["viewer"] = cfg, viewer
        return None, None, {"val/psnr": 1.0}, None

    monkeypatch.setattr(PL, "train_low", train_low)
    monkeypatch.setattr(tviewer.TrainingViewer, "serve_forever",
                        lambda self, background=False: None)
    for flags, want in (([], True), (["--no-pallas"], False)):
        cli.main(TRAIN + flags + ["--device", "cpu", "--viewer-port", "0",
                                  "--work-dir", str(tmp_path / str(want))])
        assert seen["cfg"].render.use_pallas is want
        assert seen["viewer"]._renderer.use_pallas is want
        seen["viewer"].close()
