"""W8A8 weights for the LM's decode (mirror of `omnitokenizer_tpu.ops.int8`).

A decode step reads every weight once for a few rows of activations, so its
time is the weights' bytes: int8 halves them against bf16. Weights are
quantized per output channel (absmax / 127) once, into a serving cache that
leaves the f32 master parameters untouched; activations per row at every
call. The product is `torch._int_mm` (int8 x int8 -> int32), a library GEMM
for a product the JAX package left to XLA outside any Pallas kernel.

On the card `torch._int_mm` takes more than 16 rows and K and N that are
multiples of 8: `int8_matmul` pads the rows and K with zeros and slices the
result, and the serving cache pads each weight's output channels to a
multiple of 8 once (a decode step has 2 or 16 rows; the head's N is 9193).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class QuantWeight(NamedTuple):
    """(N', K) int8 (rows past N zero), (N,) f32 scales, (N,) f32 bias or None."""

    q: torch.Tensor
    s: torch.Tensor
    b: Optional[torch.Tensor]


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An nn.Linear weight (N, K) -> ((N, K) int8, (N,) f32 per-output-channel
    scales). The JAX function takes the (K, N) kernel and returns its
    transpose; the values are the same (round half to even, clip +-127)."""
    w = weight.float()
    s = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def _pad_for_int_mm(xi: torch.Tensor, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad (M, K) activations and (N, K) weights to what the card's
    `_int_mm` takes: M > 16, and K and N multiples of 8. Zero rows and
    columns add nothing to the kept entries of the product."""
    m, k = xi.shape
    mp = max(-(-m // 8) * 8, 24)
    kp = -(-k // 8) * 8
    np_ = -(-q.shape[0] // 8) * 8
    if (mp, kp) != (m, k):
        xi = F.pad(xi, (0, kp - k, 0, mp - m))
    if (np_, kp) != tuple(q.shape):
        q = F.pad(q, (0, kp - k, 0, np_ - q.shape[0]))
    return xi, q


def int8_mm(xi: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 transposed -> (M, N) int32; on the card
    through the padded shapes."""
    m, n = xi.shape[0], q.shape[0]
    if xi.is_cuda:
        xi, q = _pad_for_int_mm(xi, q)
    return torch._int_mm(xi, q.t())[:m, :n]


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """x (..., K) float; wq (N', K) int8 whose first N rows are the weight;
    ws (N,) f32 -> (..., N) f32. Per-row dynamic activation quantization,
    an int8 x int8 -> int32 product, an f32 dequantization."""
    xf = x.float()
    ax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    xi = torch.clamp(torch.round(xf / ax), -127, 127).to(torch.int8)
    n = ws.shape[0]
    out = int8_mm(xi.reshape(-1, xi.shape[-1]), wq)[:, :n]
    return out.reshape(*x.shape[:-1], n).float() * ax * ws


def _pad_rows(q: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    n = q.shape[0]
    return F.pad(q, (0, 0, 0, -(-n // multiple) * multiple - n)).contiguous()


@torch.no_grad()
def quantize_gpt_decode_params(gpt: torch.nn.Module) -> Dict[str, QuantWeight]:
    """The W8A8 serving cache of a GPT (models/gpt.py): every block Linear
    and the head, keyed by module name (blocks.{i}.attn.query, ...,
    blocks.{i}.mlp.2, head); biases copied in f32. The output channels are
    zero-padded to a multiple of 8 once, here."""
    quant: Dict[str, QuantWeight] = {}
    for name, mod in gpt.named_modules():
        if isinstance(mod, torch.nn.Linear):
            q, s = quantize_weight(mod.weight)
            b = None if mod.bias is None else mod.bias.detach().float().clone()
            quant[name] = QuantWeight(_pad_rows(q), s, b)
    return quant
