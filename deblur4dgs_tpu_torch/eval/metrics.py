"""Masked image / pose metrics.

PyTorch port of deblur4dgs_tpu/eval/metrics.py: functional cores on
tensors (numpy inputs are accepted and converted) and small stateful
accumulators with update / compute / reset. The masked SSIM is the
reference's mask-aware separable Gaussian filter with VALID padding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _t(x):
    return torch.as_tensor(x, dtype=torch.float32)


def compute_psnr(preds, targets, masks=None) -> float:
    """Masked MSE -> PSNR."""
    preds, targets = _t(preds), _t(targets)
    if masks is None:
        masks = torch.ones_like(preds[..., 0])
    masks = _t(masks)
    sse = torch.sum(((preds - targets) * masks[..., None]) ** 2)
    total = torch.clamp(masks.sum(), min=1.0) * 3.0
    return float(-10.0 * torch.log(sse / total) / np.log(10.0))


def masked_ssim(
    preds, targets, masks=None, kernel_size=11, sigma=1.5, k1=0.01, k2=0.03,
    data_range=1.0,
):
    """Mask-aware SSIM of one (H, W, 3) image pair (a 0-d tensor)."""
    preds, targets = _t(preds), _t(targets)
    if masks is None:
        masks = torch.ones_like(preds[..., 0])
    masks = _t(masks)

    hw = kernel_size // 2
    shift = (2 * hw - kernel_size + 1) / 2
    f_i = ((torch.arange(kernel_size, dtype=torch.float32,
                         device=preds.device) - hw + shift) / sigma) ** 2
    filt = torch.exp(-0.5 * f_i)
    filt = filt / filt.sum()

    def conv1d(z, m, axis):
        """Mask-weighted separable filter along one spatial axis, VALID
        padding. z: (H, W, C); m: (H, W)."""
        k = filt.reshape((1, 1, -1, 1) if axis == 0 else (1, 1, 1, -1))
        zm = z * m[..., None]
        z_ = F.conv2d(zm.permute(2, 0, 1)[:, None], k)[:, 0].permute(1, 2, 0)
        m_ = F.conv2d(m[None, None], torch.ones_like(k))[0, 0]
        scale = float(kernel_size)  # sum(ones_like(filt))
        out = torch.where(m_[..., None] != 0, z_ * scale / m_[..., None],
                          z_.new_zeros(()))
        return out, (m_ != 0).to(z.dtype)

    def filt_fn(z, m):
        z, m = conv1d(z, m, axis=1)
        return conv1d(z, m, axis=0)

    mu0 = filt_fn(preds, masks)[0]
    mu1 = filt_fn(targets, masks)[0]
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = torch.clamp(filt_fn(preds**2, masks)[0] - mu00, min=0.0)
    s11 = torch.clamp(filt_fn(targets**2, masks)[0] - mu11, min=0.0)
    s01 = filt_fn(preds * targets, masks)[0] - mu01
    s01 = torch.sign(s01) * torch.minimum(torch.sqrt(s00 * s11),
                                          torch.abs(s01))

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ssim_map = ((2 * mu01 + c1) * (2 * s01 + c2)) / (
        (mu00 + mu11 + c1) * (s00 + s11 + c2)
    )
    return torch.mean(ssim_map)


def compute_pck(preds, targets, threshold: float) -> float:
    """Share of points within ``threshold`` pixels of their target."""
    preds, targets = _t(preds), _t(targets)
    ok = torch.linalg.norm(preds - targets, dim=-1) < threshold
    return float(torch.sum(ok) / max(preds.shape[0], 1))


def compute_pose_errors(preds: np.ndarray, targets: np.ndarray):
    """ATE / RPE_t / RPE_r in degrees of (N, 4, 4) camera poses; numpy in
    float64 for acos accuracy near 1.0."""
    preds = np.asarray(preds)
    targets = np.asarray(targets)
    ate = float(np.linalg.norm(preds[:, :3, -1] - targets[:, :3, -1],
                               axis=-1).mean())
    pred_rels = np.linalg.inv(preds[:-1]) @ preds[1:]
    target_rels = np.linalg.inv(targets[:-1]) @ targets[1:]
    error_rels = np.linalg.inv(target_rels) @ pred_rels
    traces = error_rels[:, :3, :3].trace(axis1=-2, axis2=-1)
    rpe_t = float(np.linalg.norm(error_rels[:, :3, -1], axis=-1).mean())
    rpe_r = float(
        np.arccos(np.clip((traces - 1.0) / 2.0, -1.0, 1.0)).mean()
        / np.pi * 180.0
    )
    return ate, rpe_t, rpe_r


# ---------------------------------------------------------------------------
# Stateful accumulators (update / compute / reset)
# ---------------------------------------------------------------------------


class mPSNR:
    """Per-image masked PSNR, averaged over updates."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum_squared_error = []
        self.total = []

    def __len__(self):
        return len(self.total)

    def update(self, preds, targets, masks=None):
        preds, targets = _t(preds), _t(targets)
        if masks is None:
            masks = torch.ones_like(preds[..., 0])
        masks = _t(masks)
        self.sum_squared_error.append(
            float(torch.sum(((preds - targets) * masks[..., None]) ** 2))
        )
        self.total.append(float(masks.sum()) * 3.0)

    def compute(self) -> float:
        sse = np.array(self.sum_squared_error)
        tot = np.array(self.total)
        return float((-10.0 * np.log(sse / tot)).mean() / np.log(10.0))


class mSSIM:
    """Per-image masked SSIM, averaged."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.similarity = []

    def __len__(self):
        return len(self.similarity)

    def update(self, preds, targets, masks=None):
        if preds.ndim == 4:
            for i in range(preds.shape[0]):
                self.similarity.append(float(masked_ssim(
                    preds[i], targets[i], None if masks is None else masks[i],
                )))
        else:
            self.similarity.append(float(masked_ssim(preds, targets, masks)))

    def compute(self) -> float:
        return float(np.mean(self.similarity))


class PCK:
    def __init__(self):
        self.reset()

    def reset(self):
        self.correct = []
        self.total = []

    def __len__(self):
        return len(self.total)

    def update(self, preds, targets, threshold):
        preds, targets = _t(preds), _t(targets)
        ok = torch.linalg.norm(preds - targets, dim=-1) < threshold
        self.correct.append(float(torch.sum(ok)))
        self.total.append(preds.shape[0])

    def compute(self) -> float:
        return float(np.mean(
            np.array(self.correct) / np.maximum(np.array(self.total), 1e-8)))
