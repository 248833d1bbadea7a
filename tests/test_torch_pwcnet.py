"""Port vs reference: the PWC-Net (models/pwcnet.py) and the exposure-
consistency term of the train step (train/trainer.py).

Both packages hold the same weights: the seeded state dict of
tests/golden_utils.py (the manifest's names, seed 42) goes into the JAX
package through its load_torch_state and into the port through
load_pwcnet_torch (checked equal to convert.pwcnet_from_numpy of the JAX
pytree, and the round trip exact).

Bars:
  * the golden fixture (tests/fixtures/pwcnet_golden.npz, the reference
    torch forward executed) under the JAX test's own bars
    (tests/test_golden_fixtures.py): flow 1e-4, aligned 1e-4, mask 1e-5,
    L1 1e-5 abs (measured 7.5e-7, 1.1e-6, 0, <1e-7);
  * correlation 1e-6 abs, backwarp's warp and its input gradient 1e-6 abs
    and the mask equal, pwcnet_flow at 48x32 (both sizes resized: 64x64
    and the 1/4-resolution flow upsampled) 1e-5 abs (measured 5.6e-7 of a
    0.65 max);
  * exposure_consistency_loss (32x48) value
    rtol 1e-5 and its gradient to the sub-frame renders 1e-4 of max |g|
    (S = 2: one pair of each of the term's two loops);
  * one 64x48 stage-2 step at S = 2 (static, dynamic with flow_fn,
    static-reg, multires guide; epoch 25: the consistency and pose gates
    open) against the JAX step (use_pallas=False, as the JAX suite runs
    the pipeline on the CPU): loss and every aux value rtol 1e-5
    (tests/test_torch_train_full.py's bar; 4.5e-4 abs, against a flow
    term of 0.0168); the port's loss without flow_fn differs by more than
    1e-4 of it (measured 3.7e-4: the term is there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.configs import (
    LossesConfig,
    OptimizerConfig,
    RenderConfig,
    SceneLRConfig,
)
from deblur4dgs_tpu.models import pwcnet as JP
from deblur4dgs_tpu.train import trainer as JT
from deblur4dgs_tpu.train.optimizers import make_optimizer as j_make_opt
from deblur4dgs_tpu_torch import configs as tcfg
from deblur4dgs_tpu_torch import convert
from deblur4dgs_tpu_torch.models import pwcnet as TP
from deblur4dgs_tpu_torch.train import trainer as TT
from deblur4dgs_tpu_torch.train.optimizers import make_optimizer as t_make_opt
from tests.golden_utils import build_seeded_state_dict, load_manifest
from tests.test_torch_dense import K48
from tests.test_torch_models import (
    NUM_FRAMES,
    compile_once,
    jax_scene,
    scene_arrays,
    torch_single_thread,  # noqa: F401
)
from tests.test_torch_train_full import _wrap, step_inputs

FIX = "tests/fixtures/pwcnet_golden.npz"
# Sub-frames of the flow cases: 2 (S - 1) = 2 flow pairs, one of each of
# the term's two loops (the JAX package runs one PWC-Net per pair; on the
# CPU each costs its compile).
S_FLOW = 2


@pytest.fixture(scope="module")
def nets():
    sd = build_seeded_state_dict(load_manifest("pwcnet_manifest.json"),
                                 seed=42)
    jparams = JP.load_torch_state(sd)
    net = TP.load_pwcnet_torch(sd, device="cpu")
    return jparams, net


def test_converters(nets):
    jparams, net = nets
    j_np = jax.tree.map(np.asarray, jparams)
    net2 = convert.pwcnet_from_numpy(j_np, device="cpu")
    a, b = net.state_dict(), net2.state_dict()
    assert set(a) == set(b) and len(a) == 126
    for k in a:
        assert torch.equal(a[k], b[k]), k
    back = convert.pwcnet_to_numpy(net2)
    assert jax.tree.structure(back) == jax.tree.structure(j_np)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(j_np)):
        np.testing.assert_array_equal(x, y)


def test_golden_fixture(nets):
    _, net = nets
    fix = np.load(FIX)
    a = torch.as_tensor(fix["a"])[None]
    b = torch.as_tensor(fix["b"])[None]
    with torch.no_grad():
        flow = TP.pwcnet_flow(net, a, b)[0]
    np.testing.assert_allclose(flow.numpy(), fix["flow"], atol=1e-4)
    aligned, fmask = TP.backwarp(
        a.permute(0, 3, 1, 2),
        torch.as_tensor(fix["flow"])[None].permute(0, 3, 1, 2))
    aligned = aligned[0].permute(1, 2, 0)
    fmask = fmask[0].permute(1, 2, 0)
    # backwarp returns the warp already multiplied by the mask
    np.testing.assert_allclose((aligned * fmask).numpy(), fix["aligned"],
                               atol=1e-4)
    np.testing.assert_allclose(fmask.numpy(), fix["fmask"], atol=1e-5)
    l_rec = float(torch.mean(torch.abs(aligned * fmask - b[0] * fmask)))
    np.testing.assert_allclose(l_rec, float(fix["l_rec"]), atol=1e-5)


def test_correlation():
    rng = np.random.default_rng(0)
    f1 = rng.normal(size=(2, 7, 10, 6)).astype(np.float32)
    f2 = rng.normal(size=(2, 7, 10, 6)).astype(np.float32)
    j = np.asarray(JP.correlation(jnp.asarray(f1), jnp.asarray(f2)))
    t = TP.correlation(torch.as_tensor(f1).permute(0, 3, 1, 2),
                       torch.as_tensor(f2).permute(0, 3, 1, 2))
    assert t.shape == (2, 81, 7, 10)
    np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), j, atol=1e-6)


def test_backwarp_and_its_gradient():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 9, 13, 3)).astype(np.float32)
    # displacements up to 4 px: some samples leave the image
    flow = rng.uniform(-4, 4, (2, 9, 13, 2)).astype(np.float32)
    g = rng.normal(size=(2, 9, 13, 3)).astype(np.float32)

    def jf(xx):
        out, m = JP.backwarp(xx, jnp.asarray(flow))
        return out, m

    (jo, jm), vjp = jax.vjp(jf, jnp.asarray(x))
    (jg,) = vjp((jnp.asarray(g), jnp.zeros_like(jm)))
    xt = torch.as_tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    to, tm = TP.backwarp(xt, torch.as_tensor(flow).permute(0, 3, 1, 2))
    (to * torch.as_tensor(g).permute(0, 3, 1, 2)).sum().backward()
    assert 0 < float(tm.mean()) < 1
    np.testing.assert_array_equal(tm.permute(0, 2, 3, 1).numpy(), jm)
    np.testing.assert_allclose(to.detach().permute(0, 2, 3, 1).numpy(), jo,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), jg,
                               atol=1e-6)


# One of each convolution the net computes by GEMMs (models/pwcnet.py):
# (cin, cout, stride, dilation) of a 3x3 _Conv, or (cin, "up") of a 4x4
# stride-2 _UpConv. im2col: the pyramid's strided layers; col2im: a
# decoder's narrow layers (cin >= 8 cout); shifted taps: the pyramid's
# same-size layers, decoder and refiner layers, the dilated ones.
GEMM_LAYERS = [(3, 16, 2, 1), (32, 64, 2, 1), (533, 32, 1, 1),
               (597, 2, 1, 1), (16, 16, 1, 1), (565, 128, 1, 1),
               (64, 32, 1, 1), (128, 128, 1, 2), (128, 96, 1, 8),
               (96, 64, 1, 16), (2, "up"), (661, "up")]


@pytest.mark.parametrize("batch,hw", [(1, (13, 21)), (3, (37, 70))])
@pytest.mark.parametrize("layer", GEMM_LAYERS, ids=str)
def test_gemm_convolutions(layer, batch, hw):
    """Each GEMM layer against F.conv2d / F.conv_transpose2d of the same
    float32 weights and inputs, evaluated in float64: within 1e-6 of the
    output's largest magnitude (measured <= 7.8e-7 over 20 seeds; the
    float32 CPU F.conv_transpose2d itself reads 2.6e-6 against it at 661
    channels). Sizes are not multiples of 64, nor even."""
    g = torch.Generator().manual_seed(5)
    cin = layer[0]
    if layer[1] == "up":
        m = TP._UpConv(cin, 2)

        def ref(x, w, b):
            return torch.nn.functional.conv_transpose2d(x, w, b, 2, 1)
    else:
        _, cout, stride, dil = layer
        m = TP._Conv(cin, cout, 3, stride, dil, dilation=dil)

        def ref(x, w, b):
            return torch.nn.functional.conv2d(x, w, b, stride, dil, dil)
    bound = 1.0 / np.sqrt(cin * m.kernel_size[0] ** 2)
    x = torch.rand((batch, cin) + hw, generator=g) * 2 - 1
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.rand(p.shape, generator=g) * (2 * bound) - bound)
        y = m(x)
        r = ref(x.double(), m.weight.double(), m.bias.double())
    assert y.dtype == torch.float32 and y.shape == r.shape
    err = float((y.double() - r).abs().max() / r.abs().max())
    assert err <= 1e-6, err


def test_pwcnet_flow_48x32(nets):
    jparams, net = nets
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)
    j = np.asarray(jax.jit(JP.pwcnet_flow)(jparams, jnp.asarray(x),
                                           jnp.asarray(y)))
    with torch.no_grad():
        t = TP.pwcnet_flow(net, torch.as_tensor(x), torch.as_tensor(y))
    assert t.shape == (1, 32, 48, 2)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5)


def test_exposure_consistency_loss(nets):
    jparams, net = nets
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (32, 48, 3)).astype(np.float32)
    # sub-frames: one image shifted by a pixel per sub-frame plus noise
    imgs = np.stack([np.roll(base, s, axis=1) for s in range(S_FLOW)]) + \
        0.05 * rng.normal(size=(S_FLOW, 32, 48, 3)).astype(np.float32)
    masks = (rng.uniform(size=(S_FLOW, 32, 48, 1)) < 0.7).astype(np.float32)
    jfn = JP.make_aligned_loss_fn(jparams)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda im: JT.exposure_consistency_loss(im, jnp.asarray(masks), jfn)
    ))(jnp.asarray(imgs))
    ti = torch.as_tensor(imgs).requires_grad_(True)
    tl = TT.exposure_consistency_loss(ti, torch.as_tensor(masks),
                                      TP.make_aligned_loss_fn(net))
    tl.backward()
    assert float(tl.detach()) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(ti.grad.numpy() / scale, np.asarray(jg) / scale,
                               atol=1e-4, rtol=0)
    assert not any(p.requires_grad for p in net.parameters())


@pytest.fixture(scope="module")
def flow_steps(nets):
    """One 64x48 stage-2 step with flow_fn in each package, and the
    port's step without it; all from one scene."""
    jparams, net = nets
    cfg = dict(wh=(64, 48), K=K48, has_dynamic=True)
    flags = dict(has_static=True, has_dynamic=True, has_reg=True,
                 has_batch4=True)
    arrays = scene_arrays(seed=13)
    static, dyn, tracks, reg, batch4 = step_inputs(cfg)
    js = jax_scene(arrays)
    lr, ocfg = SceneLRConfig(), OptimizerConfig()
    jstep = JT.make_train_step(
        j_make_opt(js, lr, ocfg), LossesConfig(),
        RenderConfig(num_exposure=S_FLOW, tile_cap=256, use_pallas=False),
        "second", NUM_FRAMES, flow_fn=JP.make_aligned_loss_fn(jparams),
        **flags)
    jin = (_wrap(JT.FrameBatch, static, jnp.asarray),
           _wrap(JT.FrameBatch, dyn, jnp.asarray),
           _wrap(JT.TrackBatch, tracks, jnp.asarray),
           _wrap(JT.FrameBatch, reg, jnp.asarray), jnp.asarray(batch4))
    jstate = JT.init_train_state(js, lr, ocfg)
    _, jl, ja = compile_once(jstep, jstate, jnp.asarray(25), *jin)(
        jstate, jnp.asarray(25), *jin)
    tin = (_wrap(TT.FrameBatch, static, torch.as_tensor),
           _wrap(TT.FrameBatch, dyn, torch.as_tensor),
           _wrap(TT.TrackBatch, tracks, torch.as_tensor),
           _wrap(TT.FrameBatch, reg, torch.as_tensor),
           torch.as_tensor(batch4))
    out = {}
    for name, flow_fn in (("flow", TP.make_aligned_loss_fn(net)),
                          ("none", None)):
        ts = convert.scene_from_numpy(arrays, device="cpu")
        tstep = TT.make_train_step(
            t_make_opt(ts, tcfg.SceneLRConfig(), tcfg.OptimizerConfig()),
            tcfg.LossesConfig(), tcfg.RenderConfig(num_exposure=S_FLOW,
                                                   tile_cap=256),
            "second", NUM_FRAMES, flow_fn=flow_fn, **flags)
        _, tl, ta = tstep(TT.init_train_state(
            ts, tcfg.SceneLRConfig(), tcfg.OptimizerConfig()), 25, *tin)
        out[name] = (float(tl), ta)
    return float(jl), ja, out


def test_stage2_step_with_flow(flow_steps):
    jl, ja, out = flow_steps
    tl, ta = out["flow"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(ta) == set(ja)
    for b in ja:
        assert set(ta[b]) == set(ja[b]), b
        for k in ja[b]:
            if k == "radii":
                np.testing.assert_array_equal(ta[b][k].numpy(),
                                              np.asarray(ja[b][k]))
            else:
                np.testing.assert_allclose(ta[b][k].numpy(),
                                           np.asarray(ja[b][k]), rtol=1e-5,
                                           atol=1e-7, err_msg=f"{b}.{k}")
    # the term is there: 0.0168 of a loss of 45.06
    assert abs(tl - out["none"][0]) > 1e-4 * abs(tl)
