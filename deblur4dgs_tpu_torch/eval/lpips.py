"""LPIPS perceptual similarity (richzhang PNetLin semantics).

PyTorch port of deblur4dgs_tpu/eval/lpips.py:
  1. scale inputs from [0, 1] (normalize=True) to [-1, 1], then shift /
     scale by the fixed ScalingLayer constants;
  2. AlexNet relu features (models/backbones.py);
  3. channel-unit-normalize each feature map;
  4. squared difference -> learned 1x1 linear heads (lin0..lin4, no bias)
     -> spatial mean (or a bilinear upsample to the image, spatial=True)
     -> sum over layers.

Images are (B, H, W, 3), as in the reference. Weights: the torch LPIPS
checkpoint (load_lpips_torch). init_lpips's random weights come from a
torch.Generator and are for tests and smoke runs only: they differ from
the JAX package's jax.random draws, so a "random" LPIPS of the two
packages gives different numbers (tests carry the JAX weights across
with convert.lpips_from_numpy).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deblur4dgs_tpu_torch import resolve_device
from deblur4dgs_tpu_torch.models.backbones import (
    ALEX_CFG,
    AlexNetFeatures,
    init_alexnet,
    load_alexnet_torch,
)

# richzhang ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    def __init__(self, net: AlexNetFeatures, lins: list[torch.Tensor]):
        super().__init__()
        self.net = net
        # 1x1 heads as conv weights (1, C, 1, 1)
        self.lins = nn.ParameterList(nn.Parameter(w) for w in lins)


def init_lpips(generator: torch.Generator, device="cuda") -> LPIPS:
    dev = resolve_device(device)
    net = init_alexnet(generator, dev)
    lins = [0.1 * torch.rand((1, cout, 1, 1), generator=generator).to(dev)
            for _, cout, _, _, _ in ALEX_CFG]
    return LPIPS(net, lins)


def _unit_normalize(x, eps=1e-10):
    n = torch.sqrt(torch.sum(x**2, dim=1, keepdim=True))
    return x / (n + eps)


def lpips(params: LPIPS, img1, img2, normalize=True, spatial=False):
    """img1/img2: (B, H, W, 3); normalize=True expects [0, 1] inputs.

    Returns (B,) scores, or (B, H, W, 1) upsampled maps if spatial."""
    if normalize:
        img1 = 2.0 * img1 - 1.0
        img2 = 2.0 * img2 - 1.0
    shift, scale = img1.new_tensor(_SHIFT), img1.new_tensor(_SCALE)
    x = ((img1 - shift) / scale).permute(0, 3, 1, 2)
    y = ((img2 - shift) / scale).permute(0, 3, 1, 2)
    fx, fy = params.net(x), params.net(y)
    H, W = img1.shape[1:3]
    total = None
    for fa, fb, lin in zip(fx, fy, params.lins):
        d = (_unit_normalize(fa) - _unit_normalize(fb)) ** 2
        v = F.conv2d(d, lin)  # (B, 1, h, w)
        if spatial:
            v = F.interpolate(v, size=(H, W), mode="bilinear",
                              align_corners=False)
        else:
            v = torch.mean(v, dim=(2, 3))
        total = v if total is None else total + v
    return total[:, 0] if not spatial else total.permute(0, 2, 3, 1)


def masked_lpips(params: LPIPS, pred, target, mask):
    """mLPIPS: spatial LPIPS on mask-multiplied images, averaged over the
    masked pixels. pred/target (B, H, W, 3), mask (B, H, W)."""
    scores = lpips(
        params, pred * mask[..., None], target * mask[..., None],
        normalize=True, spatial=True,
    )[..., 0]
    return torch.sum(scores * mask) / torch.clamp(mask.sum(), min=1.0)


def load_lpips_torch(backbone_sd, lin_sd, device="cuda") -> LPIPS:
    """From torch state dicts: torchvision alexnet features + richzhang
    lin heads ('lin{i}.model.1.weight' (1, C, 1, 1))."""
    lins = []
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lin_sd:
                w = lin_sd[key]
                break
        lins.append(torch.as_tensor(w, dtype=torch.float32,
                                    device=resolve_device(device)))
    return LPIPS(load_alexnet_torch(backbone_sd, device), lins)
