"""Plain multi-head attention over (B, H, N, D): softmax(q k^T * scale) v.

Scores and softmax in f32, P rounded to the input dtype before the P v
product, which accumulates in f32; the output is in the input dtype. The
optional causal mask is bottom-right aligned (col > row + Nk - Nq) and
fills -1e9, not -inf. Replaces `omnitokenizer_tpu/ops/pallas/mha.py:mha_pallas`;
the CUDA kernel is `csrc/mha.cu` (for N > 16 a flash branch: f32 on wgmma
tensor cores with 3xTF32 error compensation, bf16 in f32 FMA; one warp per
(batch, head) for N <= 16) and `mha_plain` its plain version.
"""

from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e9
MIN_N, MAX_N = 8, 2048
# head widths the kernel is instantiated for: every dim_head of the repo's
# configs (64, 32, 8) and 16, 128; the JAX gate takes any D % 8 == 0
DIM_HEADS = (8, 16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def mha_supported(n: int, dim_head: int, dtype: torch.dtype) -> bool:
    """The JAX gate (`mha.py:mha_supported`) without its backend check,
    narrowed to the kernel's head widths and dtypes. The caller handles the
    other conditions: no bias, not training."""
    return MIN_N <= n <= MAX_N and dim_head in DIM_HEADS and dtype in DTYPES


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale [bottom-right causal]) v over (B, H, N, D):
    products of the input dtype with f32 accumulation, softmax in f32."""
    sim = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        i, j = sim.shape[-2:]
        row = torch.arange(i, device=q.device)[:, None]
        col = torch.arange(j, device=q.device)[None, :]
        sim = sim.masked_fill(col > row + (j - i), NEG_INF)
    attn = sim.softmax(-1).to(q.dtype)
    return (attn.float() @ v.to(q.dtype).float()).to(v.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
        causal: bool = False) -> torch.Tensor:
    """q, k, v contiguous (B, H, N, D) of one dtype, float32 or bfloat16.
    Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, scale, causal)
    B, H, N, D = q.shape
    if not mha_supported(N, D, q.dtype):
        raise ValueError(f"mha: unsupported N={N} dim_head={D} dtype={q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.check(t, name, q.dtype, (B, H, N, D))
        if t.data_ptr() % 16:
            raise ValueError(f"mha: {name} is not 16-byte aligned")
    out = torch.empty_like(q)
    _build.launch("mha_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B * H, N, D, float(scale), int(causal), int(q.dtype == torch.bfloat16))
    mha.launches += 1
    return out


mha.launches = 0
