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
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class PEG(nn.Module):
    def __init__(self, dim: int, causal: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.causal, self.dtype = dim, causal, dtype
        # holds the (dim, 1, 3, 3, 3) kernel and bias in torch's Conv3d layout
        self.dsconv = nn.Conv3d(dim, dim, 3, groups=dim)

    def forward(self, x: torch.Tensor, video_shape: Tuple[int, int, int, int],
                residual: bool = False) -> torch.Tensor:
        """residual=True returns peg(x) + x."""
        B, T, H, W = video_shape
        g = x.reshape(B, T, H, W, self.dim)
        tpad = (2, 0) if self.causal else (1, 1)
        gp = F.pad(g.to(self.dtype), (0, 0, 1, 1, 1, 1) + tpad)
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
        return out.reshape(x.shape)
