"""Cosine-similarity multi-head attention over a spatial token grid.

Per (batch, head), non-causal: optional pair-interleaved 2D RoPE ->
l2norm * q_scale * scale and l2norm * k_scale -> q, k rounded to bf16 ->
softmax(q k^T) in f32 -> @ v. It reads the post-projection layouts q
(B, N, H*D) and the fused kv (B, N, 2*H*D) directly. Replaces
`omnitokenizer_tpu/ops/pallas/cosine_mha.py:cosine_mha`; the CUDA kernels are
`csrc/cosine_mha.cu` (a prep pass that writes q-hat and k-hat, then a bf16
flash kernel on wgmma; one wrapper call counts once), `cosine_prep_plain` the
plain version of the prep and `cosine_mha_plain` of the whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..rotary import freqs_cis_2d, rotate_pairs
from . import _build

TILE = 64
DIM_HEADS = (32, 64)


def cosine_mha_supported(n: int, dim_head: int) -> bool:
    """The kernel takes whole 64-token tiles; the JAX gate's square-grid
    and size bounds apply as well."""
    return (n % TILE == 0 and 16 <= n <= 2048 and int(n ** 0.5) ** 2 == n
            and dim_head in DIM_HEADS)


def cosine_prep_plain(q, kv, q_scale, k_scale, heads: int, dim_head: int,
                      scale: float, use_rope: bool = False):
    """q-hat, k-hat (B, N, H*D) in q's dtype: [RoPE in f32] -> l2norm *
    q_scale * scale and l2norm * k_scale, rounded once."""
    B, N, HD = q.shape
    qh = q.float().view(B, N, heads, dim_head)
    k = kv.float().view(B, N, 2, heads, dim_head)[:, :, 0]
    if use_rope:
        cos, sin = freqs_cis_2d(dim_head, N, q.device)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        qh, k = rotate_pairs(qh, cos, sin), rotate_pairs(k, cos, sin)
    qh = (F.normalize(qh, dim=-1) * (q_scale.float() * scale)).to(q.dtype)
    k = (F.normalize(k, dim=-1) * k_scale.float()).to(q.dtype)
    return qh.reshape(B, N, HD), k.reshape(B, N, HD)


def cosine_mha_plain(q, kv, q_scale, k_scale, heads: int, dim_head: int,
                     scale: float, use_rope: bool = False) -> torch.Tensor:
    B, N, HD = q.shape
    qh, k = cosine_prep_plain(q, kv, q_scale, k_scale, heads, dim_head, scale, use_rope)
    qh, k = (t.float().view(B, N, heads, dim_head) for t in (qh, k))
    v = kv.float().view(B, N, 2, heads, dim_head)[:, :, 1]
    p = torch.einsum("bihd,bjhd->bhij", qh, k).softmax(-1)
    out = torch.einsum("bhij,bjhd->bihd", p, v)
    return out.reshape(B, N, HD).to(q.dtype)


def cosine_mha(q: torch.Tensor, kv: torch.Tensor, q_scale: torch.Tensor,
               k_scale: torch.Tensor, heads: int, dim_head: int, scale: float,
               use_rope: bool = False) -> torch.Tensor:
    """q (B, N, H*D), kv (B, N, 2*H*D) bf16; q_scale/k_scale (D,) f32.
    Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return cosine_mha_plain(q, kv, q_scale, k_scale, heads, dim_head, scale,
                                use_rope)
    B, N, HD = q.shape
    if not cosine_mha_supported(N, dim_head) or HD != heads * dim_head:
        raise ValueError(f"cosine_mha: unsupported N={N} dim_head={dim_head}")
    _build.check(q, "q", torch.bfloat16)
    _build.check(kv, "kv", torch.bfloat16, (B, N, 2 * HD))
    _build.check(q_scale, "q_scale", torch.float32, (dim_head,))
    _build.check(k_scale, "k_scale", torch.float32, (dim_head,))
    for t, name in ((q, "q"), (kv, "kv")):
        if t.data_ptr() % 16:  # 16-byte vectors and TMA
            raise ValueError(f"cosine_mha: {name} is not 16-byte aligned")
    cos, sin = freqs_cis_2d(dim_head, N, q.device)
    q_hat, k_hat, out = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    _build.launch("cosine_mha_launch", q.data_ptr(), kv.data_ptr(), q_scale.data_ptr(),
                  k_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(), q_hat.data_ptr(),
                  k_hat.data_ptr(), out.data_ptr(), B, N, heads, dim_head, float(scale),
                  int(use_rope))
    cosine_mha.launches += 1
    return out


cosine_mha.launches = 0
