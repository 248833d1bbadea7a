"""Loss library: masked/quantile-trimmed photometric losses, SSIM, motion regs.

PyTorch port of deblur4dgs_tpu/train/losses.py. Trimming is a masked
weighting with a masked quantile (sort + interpolated gather), so every
loss is fixed-shape. SSIM follows
pytorch_msssim defaults (11x11 gaussian window, sigma 1.5, K1=0.01,
K2=0.03) through banded blur matrices in full float32.
"""

from __future__ import annotations

import torch

from deblur4dgs_tpu_torch.ops.lie import _safe_norm

# ---------------------------------------------------------------------------
# Quantile-trimmed masked losses
# ---------------------------------------------------------------------------


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float):
    """Linear-interpolated quantile of x restricted to mask (torch.quantile
    semantics): masked-out entries sort last as +inf."""
    v, _ = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))
                      .reshape(-1))
    n = torch.clamp(mask.sum(), min=1)
    f = q * (n - 1).to(torch.float32)
    lo = torch.floor(f).long()
    hi = torch.minimum(lo + 1, n - 1)
    frac = f - lo.to(torch.float32)
    return v[lo] * (1.0 - frac) + v[hi] * frac


def _masked_reduce(per_elem, mask, normalize, quantile):
    """per_elem: per-pixel loss (channel mean applied); mask: same-shape
    weights or None."""
    if quantile < 1.0:
        qm = torch.ones_like(per_elem, dtype=torch.bool) if mask is None \
            else mask > 0
        thr = masked_quantile(per_elem, qm, quantile)
        qmask = (per_elem < thr).to(per_elem.dtype)
    else:
        qmask = torch.ones_like(per_elem)
    if mask is None:
        return torch.sum(per_elem * qmask) / torch.clamp(qmask.sum(), min=1e-8)
    w = mask * qmask
    if normalize:
        return torch.sum(per_elem * w) / (torch.sum(w) + 1e-8)
    return torch.mean(per_elem * w)


def abs_ref(x):
    """|x| with the reference's derivative: jnp.abs differentiates as
    select(x >= 0, 1, -1), so +1 at exactly 0, where torch.abs gives 0.
    Exact zero residuals are systematic in the initial optimization (the
    canonical frame's fitted positions equal the tracks)."""
    return torch.where(x >= 0, x, -x)


def masked_l1_loss(pred, gt, mask=None, normalize=True, quantile=1.0):
    per = torch.mean(abs_ref(pred - gt), dim=-1)
    m = None if mask is None else mask.reshape(per.shape)
    return _masked_reduce(per, m, normalize, quantile)


def masked_mse_loss(pred, gt, mask=None, normalize=True, quantile=1.0):
    per = torch.mean((pred - gt) ** 2, dim=-1)
    m = None if mask is None else mask.reshape(per.shape)
    return _masked_reduce(per, m, normalize, quantile)


def masked_huber_loss(pred, gt, delta, mask=None, normalize=True):
    """Huber loss per element (0.5 e^2 within delta, linear beyond), masked
    by ``mask`` broadcast over pred's trailing dims."""
    err = pred - gt
    abs_err = abs_ref(err)
    per = torch.where(abs_err <= delta, 0.5 * err**2,
                      delta * (abs_err - 0.5 * delta))
    if mask is None:
        return torch.mean(per)
    m = mask.reshape(mask.shape + (1,) * (per.dim() - mask.dim()))
    m = m.expand(per.shape)
    if normalize:
        return torch.sum(per * m) / (torch.sum(m) * 1.0 + 1e-8)
    return torch.mean(per * m)


def compute_gradient_loss(pred, gt, mask, quantile=0.98):
    """Edge-aware depth gradient loss: masked, quantile-trimmed L1 between
    the finite differences of pred and gt along x and y.

    pred/gt: (H, W) or (H, W, D); mask: (H, W)."""
    if pred.dim() == 2:
        pred = pred[..., None]
        gt = gt[..., None]
    mask = mask.to(pred.dtype)
    mask_x = mask[:, 1:] * mask[:, :-1]
    mask_y = mask[1:, :] * mask[:-1, :]
    lx = masked_l1_loss(pred[:, 1:] - pred[:, :-1], gt[:, 1:] - gt[:, :-1],
                        mask=mask_x, quantile=quantile)
    ly = masked_l1_loss(pred[1:, :] - pred[:-1, :], gt[1:, :] - gt[:-1, :],
                        mask=mask_y, quantile=quantile)
    return lx + ly


# ---------------------------------------------------------------------------
# SSIM (pytorch_msssim-compatible)
# ---------------------------------------------------------------------------


def _gaussian_window(size=11, sigma=1.5, device="cpu"):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _blur_matrix(n, win):
    """(n - size + 1, n) banded matrix applying `win` with VALID padding."""
    size = win.shape[0]
    m = n - size + 1
    rows = torch.arange(m, device=win.device)[:, None]
    cols = torch.arange(n, device=win.device)[None, :]
    k = cols - rows
    return torch.where((k >= 0) & (k < size), win[torch.clamp(k, 0, size - 1)],
                       torch.zeros((), device=win.device))


def _blur(img, win):
    """Separable gaussian filter, valid padding, img (H, W, C): two banded
    float32 matmuls (TF32 stays off; see train/trainer.py)."""
    H, W, C = img.shape
    bh = _blur_matrix(H, win)
    bw = _blur_matrix(W, win)
    hi = torch.einsum("yh,hwc->ywc", bh, img)
    return torch.einsum("ywc,vw->yvc", hi, bw)


def ssim(img1, img2, data_range=1.0, win_size=11, sigma=1.5, K1=0.01, K2=0.03):
    """Mean SSIM over an (H, W, C) image pair (window shrunk to the largest
    odd size that fits images smaller than it)."""
    win_size = min(win_size, img1.shape[0], img1.shape[1])
    if win_size % 2 == 0:
        win_size -= 1
    win = _gaussian_window(win_size, sigma, device=img1.device)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    stats = torch.cat(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1
    )
    C = img1.shape[-1]
    blurred = _blur(stats, win)
    mu1, mu2, e11, e22, e12 = (
        blurred[..., i * C : (i + 1) * C] for i in range(5)
    )
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = e11 - mu1_sq
    s2 = e22 - mu2_sq
    s12 = e12 - mu12
    cs = (2 * s12 + C2) / (s1 + s2 + C2)
    m = ((2 * mu12 + C1) / (mu1_sq + mu2_sq + C1)) * cs
    return torch.mean(m)


def ssim_loss(img1, img2, **kw):
    return 1.0 - ssim(img1, img2, **kw)


# ---------------------------------------------------------------------------
# Motion regularizers
# ---------------------------------------------------------------------------


def compute_accel_loss(x):
    """x: (K, T, d) — central-difference acceleration norm (zero-safe)."""
    accel = 2 * x[:, 1:-1] - x[:, :-2] - x[:, 2:]
    return torch.mean(_safe_norm(accel))


def compute_se3_smoothness_loss(rots, transls, weight_rot=1.0, weight_transl=2.0):
    return (
        compute_accel_loss(rots) * weight_rot
        + compute_accel_loss(transls) * weight_transl
    )


def compute_z_acc_loss(means_ts_nb: torch.Tensor, w2cs: torch.Tensor):
    """means_ts_nb: (G, 3, B, 3) fg means at (t-1, t, t+1); w2cs (B, 4, 4)."""
    camera_center = torch.linalg.inv(w2cs)[:, :3, 3]  # (B, 3)
    ray = means_ts_nb[:, 1] - camera_center  # (G, B, 3)
    ray = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True),
                            min=1e-8)
    d01 = torch.sum((means_ts_nb[:, 1] - means_ts_nb[:, 0]) * ray, dim=-1)
    d12 = torch.sum((means_ts_nb[:, 2] - means_ts_nb[:, 1]) * ray, dim=-1)
    return torch.mean(d01**2) + torch.mean(d12**2)


def scale_variance_loss(log_scales: torch.Tensor, mask=None):
    """Per-Gaussian variance of the 3 log-scales."""
    var = torch.var(log_scales, dim=-1, unbiased=False)
    if mask is None:
        return torch.mean(var)
    m = mask.to(var.dtype)
    return torch.sum(var * m) / (torch.sum(m) + 1e-8)


def tv_loss(x):
    """Total variation of (H, W, C)."""
    h = torch.mean((x[1:, :] - x[:-1, :]) ** 2)
    w = torch.mean((x[:, 1:] - x[:, :-1]) ** 2)
    return 2.0 * (h + w)
