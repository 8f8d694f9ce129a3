"""PEG: depthwise 3x3x3 Conv3d positional encoding (mirror of
`omnitokenizer_tpu.ops.peg`).

Reference quirk kept on purpose: ANY (B', N, d) token tensor is reshaped to
`video_shape` = (B, T, H, W) row-major, including the temporal layout
(b h w) t d, which scrambles batch, space and time. Released checkpoints
were trained that way. Temporal padding is (2, 0) when causal, else (1, 1);
spatial padding is (1, 1).

The convolution runs as 27 shifted multiply-adds on the channels-last
tensor with an f32 accumulator, rounded to the compute dtype once, as the
TPU's fused elementwise loop did for the JAX package. On an H100 (700 W)
cuDNN runs a bf16 Conv3d with groups=dim as one implicit GEMM per group
(512 launches per PEG), 6.07 ms against 1.30 ms for bf16 taps at
(4, 5, 32, 32, 512) (PERF.md).

Under sequence parallelism (`sp=`, parallel/tp.py) video_shape is the
rank's (B, T, h, W), its h rows those of `sp`'s spans. A spatial stack's
(b t)(h w) tokens reshape to it without scrambling, so the rank's rows
take one halo row from each neighbour in place of the zero padding inside
the frame. A temporal stack's (b h w) t tokens are, in the scrambled
(B, T, H, W) volume, one contiguous chunk [lo W T, hi W T) of each batch
element's (rows [lo, hi) of its span), and the stencil
reaches 2 H W + W + 1 tokens back in flat order (H W + W + 1 without the
causal pad), more than a chunk holds at small sizes: that PEG gathers its
input over the group and computes the frames of the volume its chunk
touches (from the 2 frames before them, or 1 before and 1 after without
the causal pad), then keeps its chunk. Both give every output element the
same taps in the same order as one process.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


class PEG(nn.Module):
    def __init__(self, dim: int, causal: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.causal, self.dtype = dim, causal, dtype
        # holds the (dim, 1, 3, 3, 3) kernel and bias in torch's Conv3d layout
        self.dsconv = nn.Conv3d(dim, dim, 3, groups=dim)

    def forward(self, x: torch.Tensor, video_shape: Tuple[int, int, int, int],
                residual: bool = False, sp=None, is_spatial: bool = True) -> torch.Tensor:
        """residual=True returns peg(x) + x. `sp`: the SeqParallel whose
        rank's rows x holds; `is_spatial`: x in a spatial stack's layout."""
        if sp is not None and not is_spatial:
            return self._temporal_sp(x, video_shape, residual, sp)
        B, T, H, W = video_shape
        g = x.reshape(B, T, H, W, self.dim)
        tpad = (2, 0) if self.causal else (1, 1)
        gd = g.to(self.dtype)
        if sp is None:
            gp = F.pad(gd, (0, 0, 1, 1, 1, 1) + tpad)
        else:  # the neighbours' rows in place of the zero padding inside the frame
            above, below = mesh.halo(gd, 2, 1, sp.group, [hi - lo for lo, hi in sp.spans])
            gp = F.pad(torch.cat([above, gd, below], dim=2), (0, 0, 1, 1, 0, 0) + tpad)
        return self._taps(gp, g, x.shape, (T, H, W), residual)

    def _temporal_sp(self, x: torch.Tensor, video_shape, residual: bool, sp) -> torch.Tensor:
        """The (b h w) t layout of a rank's rows: its chunk [s, e) of each
        batch element's flat (T, H, W) volume. The volume is gathered over
        the group; output frames f0 .. f1 - 1, those the chunk touches, are
        computed from their input frames and the zero padding where the
        volume ends, and the chunk is cut from them (none for an empty
        chunk)."""
        B, T, _, W = video_shape
        spans = sp.spans
        H = spans[-1][1]
        hw = H * W
        chunk = x.reshape(B, -1, self.dim)
        whole = mesh.gather_summed(chunk, 1, sp.group, [(hi - lo) * W * T for lo, hi in spans])
        whole = whole.reshape(B, T, H, W, self.dim)
        s, e = (r * W * T for r in spans[sp.rank])
        if s == e:  # an empty slice of the gathered volume: its backward still joins the group
            return whole.reshape(B, -1, self.dim)[:, :0].reshape(x.shape)
        f0, f1 = s // hw, -(-e // hw)
        back, fwd = (2, 0) if self.causal else (1, 1)
        lo, hi = max(0, f0 - back), min(T, f1 + fwd)
        tpad = (back - (f0 - lo), fwd - (hi - f1))
        gp = F.pad(whole[:, lo:hi].to(self.dtype), (0, 0, 1, 1, 1, 1) + tpad)
        g = whole[:, f0:f1]
        out = self._taps(gp, g, g.shape, (f1 - f0, H, W), residual)
        return out.reshape(B, -1, self.dim)[:, s - f0 * hw:e - f0 * hw].reshape(x.shape)

    def _taps(self, gp: torch.Tensor, g: torch.Tensor, shape, thw, residual: bool
              ) -> torch.Tensor:
        """The 27 taps over the padded gp (B, T+2, H+2, W+2, C), g the
        unpadded input."""
        T, H, W = thw
        taps = self.dsconv.weight.float().reshape(self.dim, 27).t()  # (dt dh dw, C)
        acc = None
        for i in range(27):
            dt, dh, dw = i // 9, (i // 3) % 3, i % 3
            window = gp[:, dt:dt + T, dh:dh + H, dw:dw + W]
            if acc is None:
                acc = window.float() * taps[i]
            else:
                acc.addcmul_(window, taps[i])
        out = (acc + self.dsconv.bias.float()).to(self.dtype)
        if residual:
            out = out + g
        return out.reshape(shape)
