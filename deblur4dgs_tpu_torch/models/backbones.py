"""AlexNet / VGG19 feature backbones + torch weight loaders.

PyTorch port of deblur4dgs_tpu/models/backbones.py. They support the LPIPS
metric (eval/lpips.py) and the VGG perceptual loss. The modules run on
NCHW tensors with torchvision's ``.features`` layout, so a torchvision
state dict ('features.{i}.weight', OIHW) loads as it is; the JAX package
stores the same convolutions as HWIO (convert.py moves them across).
Random init draws from a torch.Generator and is for tests only (the JAX
package draws its own from jax.random: the weights differ).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from deblur4dgs_tpu_torch import resolve_device


def maxpool(x, k=3, s=2):
    """k x k max pool with stride s, no padding (VALID)."""
    return F.max_pool2d(x, k, s)


def _init_conv(generator, cin, cout, k, device) -> nn.Conv2d:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases, the
    reference's init (drawn on the CPU, then moved)."""
    conv = nn.Conv2d(cin, cout, k, device=device)
    bound = 1.0 / math.sqrt(cin * k * k)
    with torch.no_grad():
        for p in (conv.weight, conv.bias):
            u = torch.rand(p.shape, generator=generator)
            p.copy_((2.0 * u - 1.0) * bound)
    return conv


# ---------------------------------------------------------------------------
# AlexNet (torchvision .features layout; LPIPS taps the 5 relu outputs)
# ---------------------------------------------------------------------------

ALEX_CFG = [  # (cin, cout, kernel, stride, padding)
    (3, 64, 11, 4, 2),
    (64, 192, 5, 1, 2),
    (192, 384, 3, 1, 1),
    (384, 256, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
ALEX_TORCH_IDX = [0, 3, 6, 8, 10]


class AlexNetFeatures(nn.Module):
    def __init__(self, convs: nn.ModuleList):
        super().__init__()
        self.convs = convs

    def forward(self, x):
        """x: (B, 3, H, W) -> list of the 5 relu feature maps (NCHW)."""
        feats = []
        for i, (conv, (_, _, _, s, pad)) in enumerate(zip(self.convs,
                                                         ALEX_CFG)):
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, s, pad))
            feats.append(x)
            if i in (0, 1):  # maxpool after relu1 and relu2
                x = maxpool(x)
        return feats


def init_alexnet(generator: torch.Generator, device="cuda") -> AlexNetFeatures:
    dev = resolve_device(device)
    return AlexNetFeatures(nn.ModuleList(
        _init_conv(generator, cin, cout, k, dev)
        for cin, cout, k, _, _ in ALEX_CFG))


def _load_convs(state_dict, idxs, device) -> nn.ModuleList:
    dev = resolve_device(device)
    convs = []
    for idx in idxs:
        w = torch.as_tensor(state_dict[f"features.{idx}.weight"],
                            dtype=torch.float32)
        conv = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2], device=dev)
        with torch.no_grad():
            conv.weight.copy_(w)
            conv.bias.copy_(torch.as_tensor(
                state_dict[f"features.{idx}.bias"], dtype=torch.float32))
        convs.append(conv)
    return nn.ModuleList(convs)


def load_alexnet_torch(state_dict, device="cuda") -> AlexNetFeatures:
    """torchvision alexnet state dict ('features.{0,3,6,8,10}.weight')."""
    return AlexNetFeatures(_load_convs(state_dict, ALEX_TORCH_IDX, device))


# ---------------------------------------------------------------------------
# VGG19 (torchvision .features layout)
# ---------------------------------------------------------------------------

VGG_PLAN = [
    (3, 64), (64, 64),
    (64, 128), (128, 128),
    (128, 256), (256, 256), (256, 256), (256, 256),
    (256, 512), (512, 512), (512, 512), (512, 512),
    (512, 512), (512, 512), (512, 512), (512, 512),
]
_VGG_POOL_AFTER = {1, 3, 7, 11}  # pool after these conv indices (0-based)
VGG_TORCH_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]
_VGG_NAMES = [
    "relu1_1", "relu1_2", "relu2_1", "relu2_2",
    "relu3_1", "relu3_2", "relu3_3", "relu3_4",
    "relu4_1", "relu4_2", "relu4_3", "relu4_4",
    "relu5_1", "relu5_2", "relu5_3", "relu5_4",
]


class VGG19Features(nn.Module):
    def __init__(self, convs: nn.ModuleList):
        super().__init__()
        self.convs = convs

    def forward(self, x):
        """x: (B, 3, H, W) -> dict of every relu{i}_{j} map (NCHW)."""
        out = {}
        for i, (conv, name) in enumerate(zip(self.convs, _VGG_NAMES)):
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, 1, 1))
            out[name] = x
            if i in _VGG_POOL_AFTER:
                x = maxpool(x, k=2, s=2)
        return out


def init_vgg19(generator: torch.Generator, device="cuda") -> VGG19Features:
    dev = resolve_device(device)
    return VGG19Features(nn.ModuleList(
        _init_conv(generator, cin, cout, 3, dev) for cin, cout in VGG_PLAN))


def load_vgg19_torch(state_dict, device="cuda") -> VGG19Features:
    return VGG19Features(_load_convs(state_dict, VGG_TORCH_IDX, device))


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_perceptual_loss(net: VGG19Features, img1, img2):
    """L1 on relu3_2 / relu4_2 (x1) and relu5_2 (x2), divided by 4.
    imgs: (B, H, W, 3) in [0, 1], as the reference takes them."""
    mean = img1.new_tensor(IMAGENET_MEAN)
    std = img1.new_tensor(IMAGENET_STD)
    x = ((img1 - mean) / std).permute(0, 3, 1, 2)
    y = ((img2 - mean) / std).permute(0, 3, 1, 2)
    fx, fy = net(x), net(y)
    loss = 0.0
    for name, w in (("relu3_2", 1.0), ("relu4_2", 1.0), ("relu5_2", 2.0)):
        loss = loss + w * torch.mean(torch.abs(fx[name] - fy[name]))
    return loss / 4.0
