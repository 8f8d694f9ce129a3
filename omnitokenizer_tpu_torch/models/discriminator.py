"""PatchGAN discriminators, 2D for frames and 3D for clips, with the
intermediate features of the feature-matching loss (mirror of
`omnitokenizer_tpu.models.discriminator`).

Inputs and outputs are channels-last, as in the JAX package: (B, H, W, C)
and (B, T, H, W, C); the convolutions run channels-first inside and hand
back channels-last views. Parameters are f32; the convolutions compute in
the module's dtype, the norms in f32 (flax's promotion of a bf16 input
with f32 statistics and scale). A forward returns (logits, [features...])
with the logits last in the feature list.

`Normalize` is GroupNorm(32, eps 1e-6) or BatchNorm with flax's
semantics, which `nn.BatchNorm*d` does not have: momentum 0.9 on the
running statistics, eps 1e-5, and the running variance from the biased
batch variance E[x^2] - E[x]^2. A train-mode call normalizes with the
batch's statistics and writes the running ones only when `update_stats`
is set (the trainer's discriminator pass, not its generator pass).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _stats(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 mean and max(0, E[x^2] - E[x]^2) over `dims`, kept for broadcast."""
    x = x.float()
    mean = x.mean(dims, keepdim=True)
    var = ((x * x).mean(dims, keepdim=True) - mean * mean).clamp_min(0.0)
    return mean, var


class BatchNorm(nn.Module):
    """flax BatchNorm over the channel axis 1 of a channels-first tensor."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if train:
            dims = [0] + list(range(2, x.ndim))
            mean, var = _stats(x, dims)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1 - m) * mean.flatten())
                    self.var.copy_(m * self.var + (1 - m) * var.flatten())
        else:
            mean, var = self.mean.view(shape), self.var.view(shape)
        mul = torch.rsqrt(var + self.eps) * self.scale.view(shape)
        return (x.float() - mean) * mul + self.bias.view(shape)


class GroupNorm(nn.Module):
    """flax GroupNorm(num_groups) over a channels-first tensor, in f32."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        b, c = x.shape[:2]
        g = x.reshape(b, self.num_groups, -1)
        mean, var = _stats(g, [2])
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = ((g.float() - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.scale.view(shape) + self.bias.view(shape)


class Normalize(nn.Module):
    """GroupNorm(32, eps=1e-6) or BatchNorm (flax semantics) as `norm`."""

    def __init__(self, channels: int, norm_type: str = "group"):
        super().__init__()
        self.norm = GroupNorm(channels) if norm_type == "group" else BatchNorm(channels)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        return self.norm(x, train, update_stats)


class ApplyNoise(nn.Module):
    """x + weight * noise, one N(0, 1) draw a position shared across the
    channels (channels-last x); the identity without a generator."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None:
            return x
        noise = torch.randn(x.shape[:-1] + (1,), generator=generator, device=x.device)
        return x + self.weight * noise.to(x.dtype)


def _act(name: str):
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, 0.2)
    return torch.tanh


class _PatchGAN(nn.Module):
    """The shared stack: conv (stride 2) + act, n_layers - 1 x [conv (stride
    2) + norm + act], conv (stride 1) + norm + act, conv to one channel
    (stride 1; the 3D stack adds its norm + act); kernels of 4, padding 2."""

    conv_module = conv = None  # nn.Conv{2,3}d holds the weights, F.conv{2,3}d runs them
    last_norm = False

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm_type: str = "batch", use_sigmoid: bool = False,
                 activation: str = "leaky_relu", apply_noise: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv_cls = self.conv_module
        self.n_layers, self.use_sigmoid, self.dtype = n_layers, use_sigmoid, dtype
        self.act = _act(activation)
        if apply_noise:
            self.noise = ApplyNoise(input_nc)
        self.model0_conv = conv_cls(input_nc, ndf, 4)
        nf = ndf
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"model{n}_conv", conv_cls(nf_prev, nf, 4))
            self.add_module(f"model{n}_norm", Normalize(nf, norm_type))
        self.add_module(f"model{n_layers + 1}_conv", conv_cls(nf, 1, 4))
        if self.last_norm:
            self.add_module(f"model{n_layers + 1}_norm", Normalize(1, norm_type))

    def _conv(self, n: int, h: torch.Tensor, stride: int) -> torch.Tensor:
        layer = getattr(self, f"model{n}_conv")
        return type(self).conv(h.to(self.dtype), layer.weight.to(self.dtype),
                               layer.bias.to(self.dtype), stride=stride, padding=2)

    def forward(self, x: torch.Tensor, train: bool = True,
                noise_generator: Optional[torch.Generator] = None,
                update_stats: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x channels-last -> (logits, features), both channels-last."""
        if hasattr(self, "noise"):
            x = self.noise(x, noise_generator)
        h = x.movedim(-1, 1)
        feats = []

        def norm_act(n, h):
            return self.act(getattr(self, f"model{n}_norm")(h, train, update_stats))

        h = self.act(self._conv(0, h, 2))
        feats.append(h)
        for n in range(1, self.n_layers):
            h = norm_act(n, self._conv(n, h, 2))
            feats.append(h)
        n = self.n_layers
        h = norm_act(n, self._conv(n, h, 1))
        feats.append(h)
        h = self._conv(n + 1, h, 1)
        if self.last_norm:
            h = norm_act(n + 1, h)
        if self.use_sigmoid:
            h = torch.sigmoid(h)
        feats.append(h)
        feats = [f.movedim(1, -1) for f in feats]
        return feats[-1], feats


class NLayerDiscriminator(_PatchGAN):
    """2D PatchGAN over frames (B, H, W, C)."""

    conv_module, conv = nn.Conv2d, staticmethod(F.conv2d)


class NLayerDiscriminator3D(_PatchGAN):
    """3D PatchGAN over clips (B, T, H, W, C); its last conv also carries a
    norm and the activation."""

    conv_module, conv = nn.Conv3d, staticmethod(F.conv3d)
    last_norm = True
