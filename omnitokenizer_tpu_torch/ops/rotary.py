"""2D rotary position embeddings (mirror of `omnitokenizer_tpu.ops.rotary`).

For a flat h*w token grid each head dim is split into dim/4 complex
frequency slots; even slots rotate by x-position angles and odd slots by
y-position angles (the reference's `cat([x_cis, y_cis]).reshape` interleave).
Under sequence parallelism a rank's queries are a block of the grid's
tokens, and take the table's rows at their global offset.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def freqs_cis_2d_np(dim: int, end: int, theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables of shape (end, dim//2), float32.

    `dim` is the per-head dimension and `end` the number of tokens, with
    x = n % H, y = n // H and H = int(sqrt(end)), as the reference does
    (also on a non-square N)."""
    H = int(end ** 0.5)
    pos = np.arange(0, end, dtype=np.float64)
    x_pos = pos % H
    y_pos = pos // H
    n_freq = dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4, dtype=np.float64)[:n_freq] / dim))
    # complex slot 2k <- x frequency k, slot 2k+1 <- y frequency k
    ang = np.stack([np.outer(x_pos, freqs), np.outer(y_pos, freqs)],
                   axis=-1).reshape(end, 2 * n_freq)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def freqs_cis_2d(dim: int, end: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tables as f32 tensors on `device`, built once per shape (as
    normal tensors even inside inference_mode, since the cache outlives it
    and autograd may later save them)."""
    cos, sin = freqs_cis_2d_np(dim, end)
    with torch.inference_mode(False):
        return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate consecutive real pairs (2p, 2p+1) of the last axis by angle
    column p in f32; cos/sin broadcast against x[..., ::2]."""
    xf = x.float().unflatten(-1, (-1, 2))
    a, b = xf[..., 0], xf[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).flatten(-2)


def block_table(cos: torch.Tensor, sin: torch.Tensor, offset: int, n: int):
    """Rows offset .. offset + n - 1 of the tables, shaped to broadcast
    against (B, n, H, D/2)."""
    return cos[None, offset:offset + n, None, :], sin[None, offset:offset + n, None, :]


def apply_rotary_emb_2d(q: torch.Tensor, k: torch.Tensor,
                        q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """2D RoPE on q (B, Nq, H, D) and k (B, N, H, D), computed in f32 and
    cast back; the grid is k's N tokens and q the block of Nq of them from
    token q_offset (all of them by default)."""
    N, D = k.shape[1], k.shape[-1]
    cos, sin = freqs_cis_2d(D, N, q.device)
    return (rotate_pairs(q, *block_table(cos, sin, q_offset, q.shape[1])).to(q.dtype),
            rotate_pairs(k, *block_table(cos, sin, 0, N)).to(k.dtype))
