"""Minimal MLP: nn.Linear stacks + a plain apply function.

PyTorch port of deblur4dgs_tpu/utils/mlp.py. Layout note: the JAX package
stores each layer as {"w": (d_in, d_out), "b"} and applies ``x @ w + b``;
nn.Linear stores ``weight`` as (d_out, d_in). ``convert.py`` transposes at
the boundary, so ``linear.weight == w.T``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from reference import resolve_device


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                zero: bool = False, device="cuda") -> nn.Linear:
    """Kaiming-uniform init matching torch.nn.Linear defaults, drawn from
    ``generator`` (a CPU generator; zero weights and bias when ``zero``)."""
    lin = nn.Linear(d_in, d_out, device=resolve_device(device))
    with torch.no_grad():
        if zero:
            lin.weight.zero_()
            lin.bias.zero_()
        else:
            bound = 1.0 / math.sqrt(d_in)
            w = torch.rand((d_out, d_in), generator=generator)
            b = torch.rand((d_out,), generator=generator)
            lin.weight.copy_((2.0 * w - 1.0) * bound)
            lin.bias.copy_((2.0 * b - 1.0) * bound)
    return lin


def init_mlp(generator: torch.Generator, dims: list[int],
             zero_last: bool = False, device="cuda") -> nn.ModuleList:
    return nn.ModuleList(
        init_linear(generator, a, b,
                    zero=(zero_last and i == len(dims) - 2), device=device)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
    )


def mlp(layers: nn.ModuleList, x: torch.Tensor, slope: float = 0.01):
    """Apply an MLP with LeakyReLU(slope) between layers, none after last."""
    for i, lin in enumerate(layers):
        x = lin(x)
        if i < len(layers) - 1:
            x = F.leaky_relu(x, slope)
    return x


def posenc(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """NeRF positional encoding with include_input, frequencies
    2^0..2^(num_freqs-1): out dim d*(1+2*num_freqs); per frequency a sin
    block then a cos block."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=torch.float32,
                                device=x.device)
    xb = x[..., None, :] * freqs[:, None]  # (..., F, d)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2).reshape(
        x.shape[:-1] + (-1,)
    )
    return torch.cat([x, enc], dim=-1)
