"""Normalization layers (mirror of `omnitokenizer_tpu.ops.norms`).

A gamma-only LayerNorm sits inside attention blocks and a standard affine
LayerNorm inside feed-forwards and patch embeds, both with eps 1e-5 and the
biased variance of torch's LayerNorm.
"""

from __future__ import annotations

import torch
from torch import nn


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalize over the last axis; returns f32.

    bf16 input keeps f32 statistics, and the centring runs in bf16 against
    the bf16-rounded mean, as the JAX package does."""
    if x.dtype == torch.bfloat16:
        mean = x.float().mean(-1, keepdim=True)
        var = (x.float() - mean).square().mean(-1, keepdim=True)
        return (x - mean.to(x.dtype)).float() * torch.rsqrt(var + eps)
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps)


class LayerNormGamma(nn.Module):
    """Gamma-only LayerNorm (beta fixed at zero)."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (layer_norm(x, self.eps) * self.gamma).to(self.dtype)


class LayerNorm(nn.Module):
    """Affine LayerNorm with torch defaults; output in `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (layer_norm(x, self.eps) * self.weight + self.bias).to(self.dtype)
