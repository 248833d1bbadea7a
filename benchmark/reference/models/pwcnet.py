"""PWC-Net optical flow, frozen, for the exposure-consistency loss.

PyTorch port of deblur4dgs_tpu/models/pwcnet.py (the reference's
flow3d/models/pwcnet.py with its CuPy correlation kernel). The net is an
nn.Module in NCHW whose parameter names are the reference checkpoint's
(``pwcnet-network-default.pth``) after its ``module`` -> ``net`` rename,
so a checkpoint loads with ``load_state_dict`` as it is: the JAX package
transposes and flips its kernels into HWIO, the port needs neither.

The JAX package runs all of this with XLA ops (no Pallas kernel), so the
port uses plain torch: the cost volume is the 81 shifted products of a
radius-4 window, averaged over channels (correlation.py's
kernel_Correlation_updateOutput). Only inference and the warp's input
gradient are needed: the flow runs under ``torch.no_grad`` and the loss's
gradient flows through the warp of the prediction alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from reference import resolve_device

_EXTRACTOR_DIMS = [(3, 16), (16, 32), (32, 64), (64, 96), (96, 128),
                   (128, 196)]
_LEVEL_NAMES = {6: "netSix", 5: "netFiv", 4: "netFou", 3: "netThr",
                2: "netTwo"}
_DEC_CURRENT = {6: 81, 5: 81 + 128 + 4, 4: 81 + 96 + 4, 3: 81 + 64 + 4,
                2: 81 + 32 + 4}
_DEC_PREV = {5: 81, 4: 81 + 128 + 4, 3: 81 + 96 + 4, 2: 81 + 64 + 4}
_BACKWARP_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
_REFINER = [(565, 128, 1), (128, 128, 2), (128, 128, 4), (128, 96, 8),
            (96, 64, 16), (64, 32, 1), (32, 2, 1)]


def _lrelu():
    return nn.LeakyReLU(0.1)


class _Extractor(nn.Module):
    def __init__(self):
        super().__init__()
        names = ["netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix"]
        for name, (cin, cout) in zip(names, _EXTRACTOR_DIMS):
            setattr(self, name, nn.Sequential(
                nn.Conv2d(cin, cout, 3, 2, 1), _lrelu(),
                nn.Conv2d(cout, cout, 3, 1, 1), _lrelu(),
                nn.Conv2d(cout, cout, 3, 1, 1), _lrelu()))
        self.names = names

    def forward(self, x):
        feats = []
        for name in self.names:
            x = getattr(self, name)(x)
            feats.append(x)
        return feats


class _Decoder(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.level = level
        cur = _DEC_CURRENT[level]
        if level < 6:
            self.netUpflow = nn.ConvTranspose2d(2, 2, 4, 2, 1)
            self.netUpfeat = nn.ConvTranspose2d(_DEC_PREV[level] + 448, 2, 4,
                                                2, 1)
        for name, cin, cout in (("netOne", cur, 128),
                                ("netTwo", cur + 128, 128),
                                ("netThr", cur + 256, 96),
                                ("netFou", cur + 352, 64),
                                ("netFiv", cur + 416, 32)):
            setattr(self, name, nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1),
                                              _lrelu()))
        self.netSix = nn.Sequential(nn.Conv2d(cur + 448, 2, 3, 1, 1))

    def forward(self, f1, f2, prev):
        if prev is None:
            feat = F.leaky_relu(correlation(f1, f2), 0.1)
        else:
            flow_in = self.netUpflow(prev["flow"])
            feat_up = self.netUpfeat(prev["feat"])
            warped, _ = backwarp(f2, flow_in * _BACKWARP_SCALE[self.level])
            vol = F.leaky_relu(correlation(f1, warped), 0.1)
            feat = torch.cat([vol, f1, flow_in, feat_up], 1)
        for name in ("netOne", "netTwo", "netThr", "netFou", "netFiv"):
            feat = torch.cat([getattr(self, name)(feat), feat], 1)
        return {"flow": self.netSix(feat), "feat": feat}


class _Refiner(nn.Module):
    def __init__(self):
        super().__init__()
        layers = []
        for i, (cin, cout, dil) in enumerate(_REFINER):
            layers.append(nn.Conv2d(cin, cout, 3, 1, dil, dilation=dil))
            if i < len(_REFINER) - 1:
                layers.append(_lrelu())
        self.netMain = nn.Sequential(*layers)

    def forward(self, x):
        return self.netMain(x)


class PWCNet(nn.Module):
    """Network (pwcnet.py:160-249): six-level feature pyramid, decoders
    from level 6 to 2, and the dilated context refiner."""

    def __init__(self):
        super().__init__()
        self.netExtractor = _Extractor()
        for level, name in _LEVEL_NAMES.items():
            setattr(self, name, _Decoder(level))
        self.netRefiner = _Refiner()

    def forward(self, first, second):
        """Coarse-to-fine flow at 1/4 resolution; (B, 3, H, W) inputs."""
        f1 = self.netExtractor(first)
        f2 = self.netExtractor(second)
        est = None
        for i, level in enumerate((6, 5, 4, 3, 2)):
            est = getattr(self, _LEVEL_NAMES[level])(f1[-1 - i], f2[-1 - i],
                                                     est)
        return est["flow"] + self.netRefiner(est["feat"])


def correlation(f1, f2, radius: int = 4):
    """The (2r+1)^2-channel local cost volume: channel dy * (2r+1) + dx
    holds mean_c f1[c] * f2[c] shifted by (dy - r, dx - r), zero padded.
    f1, f2: (B, C, H, W) -> (B, (2r+1)^2, H, W)."""
    H, W = f1.shape[-2:]
    f2p = F.pad(f2, (radius, radius, radius, radius))
    n = 2 * radius + 1
    return torch.stack([
        torch.mean(f1 * f2p[:, :, dy : dy + H, dx : dx + W], dim=1)
        for dy in range(n) for dx in range(n)], dim=1)


def backwarp(x, flow):
    """Bilinear warp of (B, C, H, W) by flow (B, 2, H, W) in pixels, with
    the validity mask (pwcnet.py:11-56): returns (warped * mask, mask),
    mask (B, 1, H, W).

    The reference normalises the flow by (W-1)/2 but samples through
    grid_sample(align_corners=False), whose grid unit is W/2 pixels, so its
    displacement is flow * W/(W-1) pixels; kept. Samples outside the image
    read zero; a pixel is valid where the warped ones channel exceeds
    0.999."""
    B, C, H, W = x.shape
    dev = x.device
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    px = gx[None] + flow[:, 0] * (W / (W - 1.0))
    py = gy[None] + flow[:, 1] * (H / (H - 1.0))
    x_aug = torch.cat([x, torch.ones_like(x[:, :1])], 1).reshape(B, C + 1,
                                                                 H * W)
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = (px - x0)[:, None], (py - y0)[:, None]

    def gather(yc, xc):
        inb = (yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1)
        lin = (yc.clamp(0, H - 1).long() * W
               + xc.clamp(0, W - 1).long()).reshape(B, 1, H * W)
        v = torch.gather(x_aug, 2, lin.expand(B, C + 1, H * W))
        return v.reshape(B, C + 1, H, W) * inb[:, None]

    out = (gather(y0, x0) * (1 - fx) * (1 - fy)
           + gather(y0, x0 + 1) * fx * (1 - fy)
           + gather(y0 + 1, x0) * (1 - fx) * fy
           + gather(y0 + 1, x0 + 1) * fx * fy)
    mask = (out[:, -1:] > 0.999).to(x.dtype)
    return out[:, :-1] * mask, mask


def _resize(x, h, w):
    """jax.image.resize(..., "bilinear") of (B, C, H, W): half-pixel
    centres, antialiased where the size falls."""
    if (h, w) == tuple(x.shape[-2:]):
        return x
    shrink = h < x.shape[-2] or w < x.shape[-1]
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=shrink)


def pwcnet_flow(net: PWCNet, source, target):
    """PWCNet.forward (pwcnet.py:266-299): resize to multiples of 64, run
    net(target, source), upscale x20 and rescale to the input size.

    source / target: (B, H, W, 3) in [0, 1]. Returns flow (B, H, W, 2)."""
    B, H, W, _ = source.shape
    Hp = int(math.ceil(H / 64.0) * 64)
    Wp = int(math.ceil(W / 64.0) * 64)
    s = _resize(source.permute(0, 3, 1, 2), Hp, Wp)
    t = _resize(target.permute(0, 3, 1, 2), Hp, Wp)
    flow = 20.0 * _resize(net(t, s), H, W)
    scale = torch.tensor([W / Wp, H / Hp], device=flow.device)
    return flow.permute(0, 2, 3, 1) * scale


def make_aligned_loss_fn(net: PWCNet):
    """AlignedLoss flow_fn (loss_utils.py:161-189): given pred and target
    (N, H, W, 3) (or (H, W, 3)), returns (aligned_pred, flow_mask) with
    mask (N, H, W, 1) (or (H, W, 1)). The net is frozen: the flow is
    computed without gradient, which flows only through the warp of
    pred."""
    net.requires_grad_(False)

    def flow_fn(pred, target):
        single = pred.dim() == 3
        if single:
            pred, target = pred[None], target[None]
        with torch.no_grad():
            flow = pwcnet_flow(net, pred, target)
        aligned, mask = backwarp(pred.permute(0, 3, 1, 2),
                                 flow.permute(0, 3, 1, 2))
        aligned, mask = aligned.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)
        return (aligned[0], mask[0]) if single else (aligned, mask)

    return flow_fn


def init_pwcnet(generator: torch.Generator, device="cuda") -> PWCNet:
    """An untrained net (tests only): every weight and bias uniform in
    +-1/sqrt(cin * k * k), as the JAX package's init_pwcnet draws (from a
    torch.Generator here, so not its values)."""
    dev = resolve_device(device)
    net = PWCNet()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                cin = m.in_channels
                k = m.kernel_size[0]
                bound = 1.0 / math.sqrt(cin * k * k)
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=generator)
                            * (2 * bound) - bound)
    return net.to(dev).eval()


def load_pwcnet_torch(state_dict, device="cuda") -> PWCNet:
    """The reference's checkpoint (tensors or ndarrays; ``module`` renamed
    ``net`` as the reference's loader does) as a PWCNet on ``device``."""
    dev = resolve_device(device)
    sd = {k.replace("module", "net"): torch.as_tensor(v, dtype=torch.float32)
          for k, v in state_dict.items()}
    net = PWCNet()
    net.load_state_dict(sd)
    return net.to(dev).eval()


def load_pwcnet_weights(path: str, device="cuda") -> PWCNet:
    """load_pwcnet_torch of a checkpoint file."""
    return load_pwcnet_torch(torch.load(path, map_location="cpu"), device)
