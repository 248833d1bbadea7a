"""Port vs reference: the plain oracle rasterizer (ops/rasterize_ref.py) and
lie.rt_to_mat4, plus the port's dense compositor twin (K5 on the CPU)
against the port's oracle.

The same seeded numpy inputs go to both packages; gradients through
jax.vjp and torch autograd.

Bars. rt_to_mat4: exact. composite_pixels, rasterize_ref, render_ref:
forward max abs <= 1e-6, every gradient max abs <= 1e-5 of its max |g|
(the same float32 formulas; cumsum and matmul sums in another order).
K5's twin (``rasterize`` on CPU tensors) against the oracle: the twin
stops a tile before a chunk once all its pixels have T < 1e-4, the oracle
composites everything, so they differ by at most ~1e-4 of a channel unit
per pixel; the bar is 2e-4 abs on the image and alpha (measured: see
test_k5_twin_against_oracle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deblur4dgs_tpu.ops import lie as jlie
from deblur4dgs_tpu.ops import rasterize_ref as jref
from deblur4dgs_tpu.ops.projection import Projected as JProjected
from deblur4dgs_tpu_torch.ops import lie as tlie
from deblur4dgs_tpu_torch.ops import rasterize as tr
from deblur4dgs_tpu_torch.ops import rasterize_ref as tref
from deblur4dgs_tpu_torch.ops.projection import Projected as TProjected
from deblur4dgs_tpu_torch.ops.projection import project as t_project
from tests.test_torch_models import torch_single_thread  # noqa: F401

FWD_ATOL = 1e-6
GRAD_REL = 1e-5
TWIN_ATOL = 2e-4
W, H = 40, 24


def assert_rel(a, b, rel, name):
    scale = float(np.abs(b).max()) + 1e-12
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max()) / scale
    assert err <= rel, f"{name}: {err:.3e} of max |g|"


def screen_gaussians(seed, G=60, D=4):
    """Seeded screen-space Gaussians over a W x H image (some invalid,
    some with a zero radius), opacities, channels and a background."""
    rng = np.random.default_rng(seed)
    f = np.float32
    means2d = rng.uniform(-4, [W + 4, H + 4], (G, 2)).astype(f)
    a = rng.uniform(0.05, 0.6, G)
    c = rng.uniform(0.05, 0.6, G)
    b = rng.uniform(-0.5, 0.5, G) * np.sqrt(a * c)
    conics = np.stack([a, b, c], -1).astype(f)
    depths = rng.uniform(1.0, 5.0, G).astype(f)
    radii = np.ceil(3.0 / np.sqrt(np.minimum(a, c))).astype(f)
    valid = rng.uniform(size=G) > 0.1
    radii[~valid] = 0.0
    radii[:3] = 0.0
    valid[:3] = False
    ops = rng.uniform(0.05, 0.95, G).astype(f)
    chans = rng.normal(size=(G, D)).astype(f)
    bg = rng.uniform(0, 1, D).astype(f)
    return means2d, conics, depths, radii, valid, ops, chans, bg


def test_rt_to_mat4():
    rng = np.random.default_rng(0)
    R = rng.normal(size=(5, 2, 3, 3)).astype(np.float32)
    t = rng.normal(size=(5, 2, 3)).astype(np.float32)
    ref = np.asarray(jlie.rt_to_mat4(jnp.asarray(R), jnp.asarray(t)))
    out = tlie.rt_to_mat4(torch.as_tensor(R), torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_composite_pixels_values_and_grads():
    m2, con, _, radii, valid, ops, chans, bg = screen_gaussians(1)
    rng = np.random.default_rng(2)
    pix = rng.uniform(0, [W, H], (300, 2)).astype(np.float32)
    diff = (m2, con, ops, chans, bg)

    def jf(m2, con, ops, chans, bg):
        return jref.composite_pixels(jnp.asarray(pix), m2, con, ops,
                                     jnp.asarray(valid), chans, bg,
                                     jnp.asarray(radii))

    (jout, jalpha), vjp = jax.vjp(jf, *map(jnp.asarray, diff))
    tin = [torch.tensor(x, requires_grad=True) for x in diff]
    tout, talpha = tref.composite_pixels(
        torch.as_tensor(pix), tin[0], tin[1], tin[2],
        torch.as_tensor(valid), tin[3], tin[4], torch.as_tensor(radii))
    np.testing.assert_allclose(tout.detach().numpy(), jout, atol=FWD_ATOL)
    np.testing.assert_allclose(talpha.detach().numpy(), jalpha, atol=FWD_ATOL)
    g_out = rng.normal(size=jout.shape).astype(np.float32)
    g_alpha = rng.normal(size=jalpha.shape).astype(np.float32)
    jg = vjp((jnp.asarray(g_out), jnp.asarray(g_alpha)))
    torch.autograd.backward([tout, talpha], [torch.as_tensor(g_out),
                                             torch.as_tensor(g_alpha)])
    for name, t, j in zip(("means2d", "conics", "opacities", "channels",
                           "background"), tin, jg):
        assert_rel(t.grad.numpy(), j, GRAD_REL, name)


@pytest.mark.parametrize("pix_chunk", [None, 256])
def test_rasterize_ref_values_and_grads(pix_chunk):
    m2, con, dep, radii, valid, ops, chans, bg = screen_gaussians(3)
    diff = (m2, con, ops, chans)

    def jf(m2, con, ops, chans):
        proj = JProjected(m2, con, jnp.asarray(dep), jnp.asarray(radii),
                          jnp.asarray(valid))
        return jref.rasterize_ref(proj, ops, chans, jnp.asarray(bg), (W, H),
                                  pix_chunk=pix_chunk)

    (jimg, jalpha), vjp = jax.vjp(jf, *map(jnp.asarray, diff))
    tin = [torch.tensor(x, requires_grad=True) for x in diff]
    proj = TProjected(tin[0], tin[1], torch.as_tensor(dep),
                      torch.as_tensor(radii), torch.as_tensor(valid))
    timg, talpha = tref.rasterize_ref(proj, tin[2], tin[3],
                                      torch.as_tensor(bg), (W, H),
                                      pix_chunk=pix_chunk)
    assert timg.shape == (H, W, chans.shape[1])
    np.testing.assert_allclose(timg.detach().numpy(), jimg, atol=FWD_ATOL)
    np.testing.assert_allclose(talpha.detach().numpy(), jalpha, atol=FWD_ATOL)
    rng = np.random.default_rng(4)
    g_img = rng.normal(size=jimg.shape).astype(np.float32)
    g_alpha = rng.normal(size=jalpha.shape).astype(np.float32)
    jg = vjp((jnp.asarray(g_img), jnp.asarray(g_alpha)))
    torch.autograd.backward([timg, talpha], [torch.as_tensor(g_img),
                                             torch.as_tensor(g_alpha)])
    for name, t, j in zip(("means2d", "conics", "opacities", "channels"),
                          tin, jg):
        assert_rel(t.grad.numpy(), j, GRAD_REL, name)


def world_gaussians(seed, G=80, D=3):
    """Seeded 3D Gaussians in front of an identity camera (W x H)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    means = rng.uniform([-0.6, -0.4, 2.0], [0.6, 0.4, 3.5], (G, 3)).astype(f)
    quats = rng.normal(size=(G, 4)).astype(f)
    scales = rng.uniform(0.02, 0.09, (G, 3)).astype(f)
    ops = rng.uniform(0.3, 0.95, G).astype(f)
    chans = rng.uniform(0, 1, (G, D)).astype(f)
    viewmat = np.eye(4, dtype=f)
    viewmat[:3, 3] = [0.02, -0.01, 0.0]
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], f)
    return means, quats, scales, ops, chans, viewmat, K


def test_render_ref_values_and_grads():
    means, quats, scales, ops, chans, viewmat, K = world_gaussians(5)
    diff = (means, quats, scales, ops, chans)

    def jf(means, quats, scales, ops, chans):
        return jref.render_ref(means, quats, scales, ops, chans,
                               jnp.asarray(viewmat), jnp.asarray(K), (W, H),
                               0.3)

    (jimg, jalpha), vjp = jax.vjp(jf, *map(jnp.asarray, diff))
    tin = [torch.tensor(x, requires_grad=True) for x in diff]
    timg, talpha = tref.render_ref(*tin, torch.as_tensor(viewmat),
                                   torch.as_tensor(K), (W, H), 0.3)
    np.testing.assert_allclose(timg.detach().numpy(), jimg, atol=FWD_ATOL)
    np.testing.assert_allclose(talpha.detach().numpy(), jalpha, atol=FWD_ATOL)
    rng = np.random.default_rng(6)
    g_img = rng.normal(size=jimg.shape).astype(np.float32)
    g_alpha = rng.normal(size=jalpha.shape).astype(np.float32)
    jg = vjp((jnp.asarray(g_img), jnp.asarray(g_alpha)))
    torch.autograd.backward([timg, talpha], [torch.as_tensor(g_img),
                                             torch.as_tensor(g_alpha)])
    for name, t, j in zip(("means", "quats", "scales", "opacities",
                           "channels"), tin, jg):
        assert_rel(t.grad.numpy(), j, GRAD_REL, name)


def test_k5_twin_against_oracle():
    """The port's tile path (bin_indexed + dense_table + the K5 twin) and
    its oracle on one small scene (no tile over capacity; 12% of the
    pixels end below T = 1e-4): the stop rule alone separates them.
    Measured on these inputs: image 2.4e-7 and alpha 1.8e-7 max abs."""
    means, quats, scales, ops, chans, viewmat, K = world_gaussians(7, G=500)
    t = lambda x: torch.as_tensor(x)
    proj = t_project(t(means), t(quats), t(scales), t(viewmat), t(K), (W, H))
    bg = torch.tensor([0.2, 0.5, 0.8])
    img_k, alpha_k, binning = tr.rasterize(proj, t(ops), t(chans), bg, (W, H),
                                           cap=512)
    assert int(binning.counts.max()) < 512
    img_o, alpha_o = tref.rasterize_ref(proj, t(ops), t(chans), bg, (W, H))
    assert float((alpha_o > 1 - tr.EARLY_STOP_T).float().mean()) > 0.1
    np.testing.assert_allclose(img_k.numpy(), img_o.numpy(), atol=TWIN_ATOL)
    np.testing.assert_allclose(alpha_k.numpy(), alpha_o.numpy(),
                               atol=TWIN_ATOL)
