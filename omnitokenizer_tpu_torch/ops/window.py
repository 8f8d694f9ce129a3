"""Swin-style window attention with a learned relative-position bias
(mirror of `omnitokenizer_tpu.ops.window`).

Plain torch: the JAX package leaves it to XLA as batched matmuls, with the
windows as the batch dimension.

Under sequence parallelism (`sp=`, parallel/tp.py) a rank holds a span of
the grid's rows (`sp`'s spans: ranks may hold different counts, or none).
Where the spans do not split into whole windows, a rank takes the rows of
every window its span touches from the ranks that hold them
(`mesh.rows_of`, one batch of sends and receives; a window may span
several ranks once a span is shorter than a window), computes those
windows and keeps its own rows; the backward returns the borrowed rows'
gradient to their owners.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from .norms import LayerNormGamma


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """(B*nH*nW, ws*ws, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def window_span(span: tuple, ws: int) -> tuple:
    """The grid rows [lo, hi) of the windows of `ws` rows that a rank's
    span of rows [lo, hi) touches (none for an empty span)."""
    lo, hi = span
    return (lo, lo) if lo == hi else (lo // ws * ws, -(-hi // ws) * ws)


@functools.lru_cache(maxsize=16)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) lookup into the (2*ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


class WindowAttention(nn.Module):
    """W-MSA over non-overlapping windows of a token grid: gamma-only
    pre-norm, qkv without bias, proj with bias, scale head_dim**-0.5. The
    grid is the caller's (h, w) (a rank's rows under sequence parallelism),
    else the square int(sqrt(N))^2 one."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.window_size, self.num_heads, self.dtype = dim, window_size, num_heads, dtype
        self.norm = LayerNormGamma(dim, dtype=dtype)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        idx = torch.from_numpy(relative_position_index(window_size).reshape(-1))
        self.register_buffer("rel_index", idx, persistent=False)

    def forward(self, x: torch.Tensor, grid=None, sp=None) -> torch.Tensor:
        """`grid`: the (h, w) rows of x; `sp`: the SeqParallel whose rank's
        block of the grid's rows x holds."""
        B, N, C = x.shape
        H, W = grid or (int(N ** 0.5),) * 2
        ws = self.window_size
        have = None if sp is None else sp.spans
        if sp is None or not any(b % ws for span in have for b in span):
            return self._windows(x.reshape(B, H, W, C)).reshape(B, N, C)
        spans = [window_span(span, ws) for span in have]
        start = have[sp.rank][0] - spans[sp.rank][0]
        g = self._windows(mesh.rows_of(x.reshape(B, H, W, C), 1, spans, sp.group, have))
        return g[:, start:start + H].reshape(B, N, C)

    def _windows(self, x: torch.Tensor) -> torch.Tensor:
        """W-MSA over the whole windows of a (B, H, W, C) grid."""
        B, H, W, C = x.shape
        ws, heads = self.window_size, self.num_heads
        head_dim = C // heads

        xw = window_partition(self.norm(x), ws)
        BW, NW, _ = xw.shape
        qkv = F.linear(xw, self.qkv.weight.to(self.dtype))
        qkv = qkv.reshape(BW, NW, 3, heads, head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (BW, h, NW, d)
        q = q * head_dim ** -0.5
        bias = self.relative_position_bias_table[self.rel_index]
        bias = bias.reshape(NW, NW, heads).permute(2, 0, 1).float()

        sim = q.float() @ k.float().transpose(-1, -2) + bias
        attn = sim.softmax(-1).to(self.dtype)
        out = (attn.float() @ v.float()).transpose(1, 2).reshape(BW, NW, C).to(self.dtype)
        out = F.linear(out, self.proj.weight.to(self.dtype), self.proj.bias.to(self.dtype))
        return window_reverse(out, ws, H, W)
