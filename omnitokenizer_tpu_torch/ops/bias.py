"""Attention biases (mirror of `omnitokenizer_tpu.ops.bias`): the AliBi
slopes and bias of causal attention, and the continuous relative position
bias MLP of spatial `rel` attention.

Both are applied only under `attn_bias_mode='einsum'` (ops/attention.py);
under 'sdpa' the reference drops them, and a spatial `rel` attention owns
the CPB MLP for its parameters (the flax `spatial_rel_pos_bias/net0..net2`
scope) without calling it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def alibi_slopes(heads: int) -> np.ndarray:
    """(heads,) f32 slopes: the geometric series of the next lower power of
    two, then every other slope of twice that many for the rest."""
    def pow2_slopes(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(heads).is_integer():
        s = pow2_slopes(heads)
    else:
        closest = 2 ** math.floor(math.log2(heads))
        s = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][: heads - closest]
    return np.asarray(s, dtype=np.float32)


@functools.lru_cache(maxsize=32)
def _alibi_bias_np(heads: int, i: int, j: int) -> np.ndarray:
    i_arange = np.arange(j - i, j)
    j_arange = np.arange(j)
    dist = -np.abs(j_arange[None, None, :] - i_arange[None, :, None]).astype(np.float32)
    return dist * alibi_slopes(heads)[:, None, None]


def alibi_bias(heads: int, i: int, j: int, device=None) -> torch.Tensor:
    """(heads, i, j) f32 bias -|key position - query position| * slope, the
    i queries aligned to the end of the j keys."""
    return torch.from_numpy(_alibi_bias_np(heads, i, j)).to(device)


@functools.lru_cache(maxsize=32)
def _rel_offsets_np(h: int, w: int) -> tuple:
    """The (2h-1)(2w-1) distinct relative offsets as signed-log coordinates,
    and for each (query, key) pair of the h*w grid the row of its offset."""
    dy, dx = np.meshgrid(np.arange(-(h - 1), h), np.arange(-(w - 1), w), indexing="ij")
    rel = np.stack([dy.reshape(-1), dx.reshape(-1)], axis=-1).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    index = (ys[:, None] - ys[None, :] + h - 1) * (2 * w - 1) + (xs[:, None] - xs[None, :] + w - 1)
    return np.sign(rel) * np.log(np.abs(rel) + 1.0), index


class ContinuousPositionBias(nn.Module):
    """Linear(2, dim) -> LeakyReLU(0.1) -> Linear(dim, dim) -> LeakyReLU(0.1)
    -> Linear(dim, heads) over the log relative coordinates, in f32.

    The MLP acts on each coordinate pair alone, and an h x w grid has only
    (2h-1)(2w-1) distinct offsets among its (hw)^2 pairs: the MLP runs on
    those (3969 rows at 32 x 32 instead of 1048576) and the bias gathers
    them. The JAX module evaluates every pair."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.net0 = nn.Linear(2, dim)
        self.net1 = nn.Linear(dim, dim)
        self.net2 = nn.Linear(dim, heads)

    def forward(self, h: int, w: int) -> torch.Tensor:
        """(heads, h*w, h*w) f32 bias, in f32 whatever the parameters'
        dtype (a bf16 model's serving cast rounds them)."""
        dev = self.net0.weight.device
        coords, index = _rel_offsets_np(h, w)

        def linear(x, layer):
            return F.linear(x, layer.weight.float(), layer.bias.float())

        x = F.leaky_relu(linear(torch.from_numpy(coords).to(dev), self.net0), 0.1)
        x = F.leaky_relu(linear(x, self.net1), 0.1)
        table = linear(x, self.net2).t()  # (heads, offsets)
        return table[:, torch.from_numpy(index).to(dev)]
