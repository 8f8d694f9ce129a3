"""Differentiable GAN augmentation, DiffAugment (mirror of
`omnitokenizer_tpu.ops.diffaug`): color (brightness, saturation,
contrast), translation with zero padding, cutout.

Channels-last (B, H, W, C); the JAX package's default policy, the only
one its trainer uses. `augment_draws` takes every random value from a
`torch.Generator`; `apply_augment` applies given draws, so the same draws
give the same pixels whoever made them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..parallel import mesh


def _extent(size: int, ratio: float) -> int:
    return int(size * ratio + 0.5)


def augment_draws(batch: int, height: int, width: int, generator: Optional[torch.Generator],
                  device=None) -> Dict[str, torch.Tensor]:
    """Per-sample draws, in the policy's order: brightness in [-0.5, 0.5),
    saturation in [0, 2), contrast in [0.5, 1.5), integer shifts in
    [-s, s] with s = 1/8 of a side, cutout centres in
    [0, side + 1 - cut % 2) with cut = 1/5 of a side."""
    def uniform():
        return torch.rand(batch, generator=generator, device=device)

    def randint(lo, hi):
        return torch.randint(lo, hi, (batch,), generator=generator, device=device)

    sx, sy = _extent(height, 0.125), _extent(width, 0.125)
    ch, cw = _extent(height, 0.2), _extent(width, 0.2)
    return dict(brightness=uniform() - 0.5, saturation=uniform() * 2.0,
                contrast=uniform() + 0.5, tx=randint(-sx, sx + 1), ty=randint(-sy, sy + 1),
                ox=randint(0, height + (1 - ch % 2)), oy=randint(0, width + (1 - cw % 2)))


def apply_augment(x: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x (B, H, W, C) with the draws of `augment_draws`: color, then
    translation with zero padding, then cutout."""
    B, H, W, C = x.shape

    def per_sample(v):
        return v.to(x.dtype).view(B, 1, 1, 1)

    x = x + per_sample(draws["brightness"])
    m = x.mean(-1, keepdim=True)
    x = (x - m) * per_sample(draws["saturation"]) + m
    m = x.mean((1, 2, 3), keepdim=True)
    x = (x - m) * per_sample(draws["contrast"]) + m

    gx = torch.arange(H, device=x.device)[None, :, None] + draws["tx"].view(B, 1, 1)
    gy = torch.arange(W, device=x.device)[None, None, :] + draws["ty"].view(B, 1, 1)
    inb = (gx >= 0) & (gx < H) & (gy >= 0) & (gy < W)
    b = torch.arange(B, device=x.device)[:, None, None]
    shifted = x[b, gx.clamp(0, H - 1), gy.clamp(0, W - 1)]
    x = torch.where(inb[..., None], shifted, torch.zeros((), dtype=x.dtype, device=x.device))

    ch, cw = _extent(H, 0.2), _extent(W, 0.2)
    gx = torch.arange(H, device=x.device)[None, :, None]
    gy = torch.arange(W, device=x.device)[None, None, :]
    ox, oy = draws["ox"].view(B, 1, 1), draws["oy"].view(B, 1, 1)
    inx = (gx >= ox - ch // 2) & (gx < ox - ch // 2 + ch)
    iny = (gy >= oy - cw // 2) & (gy < oy - cw // 2 + cw)
    return x * (1.0 - (inx & iny).to(x.dtype))[..., None]


def diff_augment(x: torch.Tensor, generator: Optional[torch.Generator],
                 group=None) -> torch.Tensor:
    """Augment frames (B, H, W, C) with draws from `generator`; given a
    process group, this rank's rows of the draws for the global batch."""
    B, H, W, _ = x.shape
    n = mesh.size_of(group)
    draws = augment_draws(B * n, H, W, generator, x.device)
    return apply_augment(x, {k: mesh.rank_rows(v, group) for k, v in draws.items()})


def diff_augment_video(x: torch.Tensor, generator: Optional[torch.Generator],
                       group=None) -> torch.Tensor:
    """(B, T, H, W, C): every frame augmented on its own, as (B*T) images."""
    B, T, H, W, C = x.shape
    return diff_augment(x.reshape(B * T, H, W, C), generator, group).reshape(B, T, H, W, C)
