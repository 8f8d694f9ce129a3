"""The continuous relative position bias MLP (mirror of
`omnitokenizer_tpu.ops.bias.ContinuousPositionBias`).

Under `attn_bias_mode='sdpa'`, the only mode ported, the bias is dropped, so
a spatial `rel` attention owns this module for its parameters (the flax
`spatial_rel_pos_bias/net0..net2` scope) and never calls it on the serving
path. AliBi and the `einsum` mode that adds both biases are not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@functools.lru_cache(maxsize=32)
def log_rel_coords_np(h: int, w: int) -> np.ndarray:
    """(h*w, h*w, 2) signed-log relative coordinates."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([ys.reshape(-1), xs.reshape(-1)], axis=-1).astype(np.float32)
    rel = grid[:, None, :] - grid[None, :, :]
    return np.sign(rel) * np.log(np.abs(rel) + 1.0)


class ContinuousPositionBias(nn.Module):
    """Linear(2, dim) -> LeakyReLU(0.1) -> Linear(dim, dim) -> LeakyReLU(0.1)
    -> Linear(dim, heads) over the log relative coordinates, in f32."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.net0 = nn.Linear(2, dim)
        self.net1 = nn.Linear(dim, dim)
        self.net2 = nn.Linear(dim, heads)

    def forward(self, h: int, w: int) -> torch.Tensor:
        """(heads, h*w, h*w) bias."""
        rel = torch.from_numpy(log_rel_coords_np(h, w)).to(self.net0.weight.device)
        x = F.leaky_relu(self.net0(rel), 0.1)
        x = F.leaky_relu(self.net1(x), 0.1)
        return self.net2(x).permute(2, 0, 1)
