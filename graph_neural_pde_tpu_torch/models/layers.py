"""Linear layer, batch norm and dropout (PyTorch port of
``models/layers.py``).

``Linear`` keeps the JAX package's ``[in, out]`` weight orientation
(``y = x @ w + b``), so converted parameters need no transpose and both
packages run the same matmul. Initialisation follows the torch defaults the
reference relies on (w and b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))), or the
constant 1e-5 weights of the attention projections. Random numbers come
from a caller's ``torch.Generator``; they are not jax.random's bits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, mode: str = "torch", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(max(in_dim, 1))
        if mode == "torch":
            w = torch.rand(in_dim, out_dim, generator=generator) * 2 - 1
            w = w * bound
        elif mode == "const1e-5":
            w = torch.full((in_dim, out_dim), 1e-5)
        else:
            raise ValueError(mode)
        b = (torch.rand(out_dim, generator=generator) * 2 - 1) * bound
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class BatchNorm(nn.Module):
    """Batch norm over nodes (torch BatchNorm1d semantics, as the JAX
    package's ``bn_init``/``bn_apply``): a training forward normalises with
    the batch mean and biased variance and moves the running statistics by
    ``momentum`` towards the batch mean and the unbiased variance; an eval
    forward reads the running statistics. The running state (``mean``,
    ``var``, ``count``) is kept in buffers, updated in place."""

    momentum, eps = 0.1, 1e-5

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        self.register_buffer("count", torch.zeros(()))

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        if training:
            mean = torch.mean(x, dim=0)
            var = torch.var(x, dim=0, correction=0)
            n = x.shape[0]
            with torch.no_grad():
                unbiased = var * n / max(n - 1, 1)
                m = self.momentum
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * unbiased)
                self.count += 1
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with a keep mask drawn from ``generator`` (which
    must live on ``x``'s device)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
