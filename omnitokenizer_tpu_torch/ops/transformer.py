"""Block-string transformer (mirror of `omnitokenizer_tpu.ops.transformer`).

Block codes: 't' full attention with PEG in front, 'w' window attention,
'a'/'m'/'l' pooling and 'n'/'r' upsampling of the token grid. Attention is
residual, a pool or up block replaces the tokens, the feed-forward is
residual after any of them, and a gamma-only LayerNorm closes the stack. A
pool halves the video shape's grid for the PEGs after it, an up doubles it.

Under sequence parallelism (`sp=`) video_shape is the rank's (B, T, h,
w), its h rows those of `sp`'s spans (parallel/tp.py's row partition):
the PEGs, the spatial attention and the windows take their collectives or
their local rows from them (ops/peg.py, ops/attention.py, ops/window.py).
A pool or up block regrids the rank's rows on their own (the partition
gives each rank whole row pairs at a pool, so a 2 x 2 cell, 4 consecutive
tokens of 'l' and a repeated row lie on one rank), and the rank's grid and
spans it leaves, halved or doubled, go on to the blocks after it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..parallel import tp
from .attention import Attention, FeedForward, Pooling, Up
from .norms import LayerNormGamma
from .peg import PEG
from .window import WindowAttention


def grid_after(block: str, h: int, w: int) -> Tuple[int, int]:
    """The (h, w) token grid after a stack's pools and ups."""
    for blk in block:
        if blk in "nr":
            h, w = 2 * h, 2 * w
        elif blk in "aml":
            h, w = h // 2, w // 2
    return h, w


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, block: str, causal: bool = False,
                 dim_head: int = 64, heads: int = 8, ff_mult: float = 4.0,
                 peg: bool = True, peg_causal: bool = True, window_size: int = 4,
                 spatial_pos: str = "rel", attn_bias_mode: str = "sdpa",
                 dtype: torch.dtype = torch.float32, spatial: bool = False):
        super().__init__()
        if len(block) != depth:
            raise ValueError(f"block string {block!r} does not have depth {depth}")
        self.block, self.window_size = block, window_size
        # `spatial`: a stack over the token grid; its `rel` attentions own
        # the CPB parameters (ops/attention.py)
        # submodules carry the flax names (layers_{i}_attn, ...), so the
        # state_dict keys follow the JAX variable tree
        for i, blk in enumerate(block):
            if blk == "t":
                if peg:
                    self.add_module(f"layers_{i}_peg", PEG(dim, causal=peg_causal, dtype=dtype))
                attn = Attention(dim, dim_head=dim_head, heads=heads, causal=causal,
                                 spatial_pos=spatial_pos, attn_bias_mode=attn_bias_mode,
                                 dtype=dtype, spatial=spatial)
            elif blk == "w":
                attn = WindowAttention(dim, window_size=window_size, num_heads=heads, dtype=dtype)
            elif blk in ("a", "m", "l"):
                attn = Pooling(blk, dim, dtype=dtype)
            elif blk in ("n", "r"):
                attn = Up(blk, dim, dtype=dtype)
            else:
                raise ValueError(f"unknown block code {blk!r} in {block!r}")
            self.add_module(f"layers_{i}_attn", attn)
            self.add_module(f"layers_{i}_ff", FeedForward(dim, mult=ff_mult, dtype=dtype))
        self.norm_out = LayerNormGamma(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, video_shape: Tuple[int, int, int, int],
                is_spatial: bool = True, training: bool = False, sp=None) -> torch.Tensor:
        """`sp`: the SeqParallel whose rank's rows x holds, its spans those
        of the input grid; video_shape is then the rank's."""
        vs = tuple(video_shape)
        sp_kw = {}  # the one-process path's calls stay as they were
        if sp is not None:
            sp = sp.at(sp.spans, vs[3])
            sp_kw = {"sp": sp}
        for i, blk in enumerate(self.block):
            attn = getattr(self, f"layers_{i}_attn")
            if blk == "t":
                peg = getattr(self, f"layers_{i}_peg", None)
                if peg is not None:
                    x = peg(x, vs, residual=True, is_spatial=is_spatial, **sp_kw)
                x = attn(x, is_spatial=is_spatial, training=training, **sp_kw) + x
            elif blk == "w":
                x = attn(x, grid=vs[2:] if sp is not None else None, **sp_kw) + x
            else:
                x = attn(x, grid=vs[2:] if sp is not None else None)
                up = blk in ("n", "r")
                vs = vs[:2] + tuple(s * 2 if up else s // 2 for s in vs[2:])
                if sp is not None:
                    sp = sp.at(tp.rescale(sp.spans, sp.spans[-1][1] * 2 if up
                                          else sp.spans[-1][1] // 2), vs[3])
                    sp_kw = {"sp": sp}
            x = getattr(self, f"layers_{i}_ff")(x, training=training) + x
        return self.norm_out(x)
