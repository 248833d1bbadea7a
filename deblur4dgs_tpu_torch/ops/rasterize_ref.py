"""Plain PyTorch oracle Gaussian rasterizer (per pixel, full depth sort).

PyTorch port of deblur4dgs_tpu/ops/rasterize_ref.py. Slow but plainly
correct and differentiable through autograd; it renders the synthetic
ground truth (data/synthetic.py) and is a second CPU check for the
compositor twins. Tiny scenes only: it builds (P, G) arrays.

Compositing semantics (shared with the tile compositors):
  * Gaussians composited in front-to-back depth order;
  * alpha = min(0.999, opacity * exp(-sigma)),
    sigma = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy with conic (a, b, c);
  * alphas below 1/255 are dropped;
  * NO early termination at T < 1e-4: everything is composited (the tile
    compositors stop a tile once all its pixels have T < 1e-4);
  * out = sum_i w_i * channel_i + T_final * background, w_i = alpha_i * T_i,
    T_i = prod_{j<i} (1 - alpha_j); alpha_out = 1 - T_final;
  * pixel centers at (px + 0.5, py + 0.5).

Transmittance is computed in log space (cumsum of log1p(-alpha)), as in
the reference.
"""

from __future__ import annotations

import torch

from deblur4dgs_tpu_torch.ops.projection import Projected, project

ALPHA_CLAMP = 0.999
ALPHA_CUTOFF = 1.0 / 255.0


def composite_pixels(
    pix_xy: torch.Tensor,  # (P, 2) pixel-center coords
    means2d: torch.Tensor,  # (G, 2) depth-sorted, front first
    conics: torch.Tensor,  # (G, 3)
    opacities: torch.Tensor,  # (G,)
    alive: torch.Tensor,  # (G,) bool: invalid/padded Gaussians add 0
    channels: torch.Tensor,  # (G, D)
    background: torch.Tensor,  # (D,)
    radii: torch.Tensor | None = None,  # (G,) bounding-box cutoff
):
    """Returns (out (P, D), alpha (P,)). Gaussians must be pre-sorted by
    depth. With ``radii``, contributions outside the |dx|,|dy| <= radius
    box are dropped (the tile compositors' per-pixel cutoff)."""
    d = pix_xy[:, None, :] - means2d[None, :, :]  # (P, G, 2)
    dx, dy = d[..., 0], d[..., 1]
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy  # (P, G)
    zero = sigma.new_zeros(())
    # torch.maximum / minimum split tie gradients as jnp.maximum does
    alpha = opacities[None, :] * torch.exp(-torch.maximum(sigma, zero))
    alpha = torch.minimum(alpha, alpha.new_tensor(ALPHA_CLAMP))
    alpha = torch.where((sigma < 0) | (alpha < ALPHA_CUTOFF) | ~alive[None, :],
                        zero, alpha)
    if radii is not None:
        inbox = (torch.abs(dx) <= radii[None, :]) & \
            (torch.abs(dy) <= radii[None, :])
        alpha = torch.where(inbox, alpha, zero)

    log_one_minus = torch.log1p(-alpha)  # (P, G)
    logT = torch.cumsum(log_one_minus, dim=-1)
    # T_i = transmittance *before* Gaussian i.
    T = torch.exp(logT - log_one_minus)
    w = alpha * T  # (P, G)
    T_final = torch.exp(logT[:, -1])
    out = w @ channels + T_final[:, None] * background[None, :]
    return out, 1.0 - T_final


def rasterize_ref(
    proj: Projected,
    opacities: torch.Tensor,  # (G,)
    channels: torch.Tensor,  # (G, D)
    background: torch.Tensor,  # (D,)
    img_wh: tuple[int, int],
    use_radius_cutoff: bool = True,
    pix_chunk: int | None = None,
):
    """Rasterize projected Gaussians to a full image, pixels in chunks of
    ``pix_chunk`` to bound the (P, G) working set (the per-pixel math does
    not depend on the chunking).

    Returns (img (H, W, D), alpha (H, W))."""
    W, H = img_wh
    key = torch.where(proj.valid, proj.depths,
                      torch.full_like(proj.depths, float("inf")))
    order = torch.argsort(key, stable=True)
    means2d = proj.means2d[order]
    conics = proj.conics[order]
    ops = opacities[order]
    alive = proj.valid[order]
    chans = channels[order]
    radii = proj.radii[order] if use_radius_cutoff else None

    dev = means2d.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)  # x first
    P, G, D = H * W, means2d.shape[0], channels.shape[-1]
    if pix_chunk is None:
        pix_chunk = max(min(P, (1 << 26) // max(G, 1)), 256)
    outs, alphas = [], []
    for p0 in range(0, P, pix_chunk):
        o, a = composite_pixels(pix[p0 : p0 + pix_chunk], means2d, conics,
                                ops, alive, chans, background, radii)
        outs.append(o)
        alphas.append(a)
    return (torch.cat(outs).reshape(H, W, D),
            torch.cat(alphas).reshape(H, W))


def render_ref(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    channels: torch.Tensor,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    img_wh: tuple[int, int],
    background: torch.Tensor | float = 0.0,
):
    """Project + rasterize in one call (the oracle's end-to-end path)."""
    D = channels.shape[-1]
    if not torch.is_tensor(background) or background.dim() == 0:
        background = torch.full((D,), float(background), dtype=torch.float32,
                                device=channels.device)
    proj = project(means, quats, scales, viewmat, K, img_wh)
    return rasterize_ref(proj, opacities, channels, background, img_wh)
