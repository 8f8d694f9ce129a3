"""Cosine-similarity multi-head attention over a spatial token grid.

Per (batch, head), non-causal: optional pair-interleaved 2D RoPE ->
l2norm * q_scale * scale and l2norm * k_scale -> q, k rounded to bf16 ->
softmax(q k^T) in f32 -> @ v. It reads the post-projection layouts q
(B, N, H*D) and the fused kv (B, N, 2*H*D) directly. Replaces
`omnitokenizer_tpu/ops/pallas/cosine_mha.py:cosine_mha`; the CUDA kernels are
`csrc/cosine_mha.cu` (a prep pass that writes q-hat and k-hat, then a bf16
flash kernel on wgmma; one wrapper call counts once), `cosine_prep_plain` the
plain version of the prep and `cosine_mha_plain` of the whole.

A query block (sequence parallelism): q holds Nq of the grid's N tokens,
from token `q_offset` on, against the whole grid's kv (B, N, 2*H*D); its
RoPE positions are the block's rows of the grid's table and the output is
(B, Nq, H*D). The kernel takes any block inside the grid; with Nq = N and
offset 0 the call is the square one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..rotary import block_table, freqs_cis_2d, rotate_pairs
from . import _build

MIN_N, MAX_N = 16, 2048
# head widths of the kernel: rows of 32, 64, 128 or 256 bytes, the first three
# one TMA box with the swizzle of their width, 256 two 128-byte boxes
DIM_HEADS = (16, 32, 64, 128)


def cosine_mha_supported(n: int, dim_head: int) -> bool:
    """The JAX gate (`cosine_mha.py:cosine_mha_supported`): a square token
    grid of 16 to 2048 tokens, here at the kernel's head widths."""
    return MIN_N <= n <= MAX_N and int(n ** 0.5) ** 2 == n and dim_head in DIM_HEADS


def narrowed(n: int, dim_head: int) -> bool:
    """Shapes the JAX gate takes (it sets no head width) and the kernel does
    not, which take the attention module's plain route: a head width other
    than 16, 32, 64 or 128. wgmma's k step is 16 wide and its shared-memory
    layouts swizzle rows of 32, 64 or 128 bytes; other widths would need
    zero-padded copies of q, k and v per call."""
    return MIN_N <= n <= MAX_N and int(n ** 0.5) ** 2 == n and dim_head not in DIM_HEADS


def query_block_ok(nq: int, n: int, q_offset: int) -> bool:
    """Whether Nq queries from token q_offset lie inside an N-token grid."""
    return 0 < nq and 0 <= q_offset and q_offset + nq <= n


def cosine_prep_plain(q, kv, q_scale, k_scale, heads: int, dim_head: int,
                      scale: float, use_rope: bool = False, q_offset: int = 0):
    """q-hat (B, Nq, H*D) and k-hat (B, N, H*D) in q's dtype: [RoPE in f32,
    q at rows q_offset.. of the N-token grid's table] -> l2norm * q_scale *
    scale and l2norm * k_scale, rounded once."""
    B, Nq, HD = q.shape
    N = kv.shape[1]
    qh = q.float().view(B, Nq, heads, dim_head)
    k = kv.float().view(B, N, 2, heads, dim_head)[:, :, 0]
    if use_rope:
        cos, sin = freqs_cis_2d(dim_head, N, q.device)
        qh = rotate_pairs(qh, *block_table(cos, sin, q_offset, Nq))
        k = rotate_pairs(k, *block_table(cos, sin, 0, N))
    qh = (F.normalize(qh, dim=-1) * (q_scale.float() * scale)).to(q.dtype)
    k = (F.normalize(k, dim=-1) * k_scale.float()).to(q.dtype)
    return qh.reshape(B, Nq, HD), k.reshape(B, N, HD)


def cosine_mha_plain(q, kv, q_scale, k_scale, heads: int, dim_head: int,
                     scale: float, use_rope: bool = False, q_offset: int = 0) -> torch.Tensor:
    B, Nq, HD = q.shape
    N = kv.shape[1]
    qh, k = cosine_prep_plain(q, kv, q_scale, k_scale, heads, dim_head, scale, use_rope,
                              q_offset)
    qh = qh.float().view(B, Nq, heads, dim_head)
    k = k.float().view(B, N, heads, dim_head)
    v = kv.float().view(B, N, 2, heads, dim_head)[:, :, 1]
    p = torch.einsum("bihd,bjhd->bhij", qh, k).softmax(-1)
    out = torch.einsum("bhij,bjhd->bihd", p, v)
    return out.reshape(B, Nq, HD).to(q.dtype)


def cosine_mha(q: torch.Tensor, kv: torch.Tensor, q_scale: torch.Tensor,
               k_scale: torch.Tensor, heads: int, dim_head: int, scale: float,
               use_rope: bool = False, q_offset: int = 0) -> torch.Tensor:
    """q (B, Nq, H*D), kv (B, N, 2*H*D) bf16; q_scale/k_scale (D,) f32; q
    the grid's tokens q_offset .. q_offset + Nq - 1 (Nq = N: all of them).
    Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return cosine_mha_plain(q, kv, q_scale, k_scale, heads, dim_head, scale,
                                use_rope, q_offset)
    _build.refuse_grad("cosine_mha", q, kv, q_scale, k_scale)
    B, Nq, HD = q.shape
    N = kv.shape[1]
    if B * Nq == 0:  # no rows (a rank of sequence parallelism that holds none): no launch
        return torch.empty_like(q)
    if not cosine_mha_supported(N, dim_head) or HD != heads * dim_head:
        raise ValueError(f"cosine_mha: unsupported N={N} dim_head={dim_head}")
    if not query_block_ok(Nq, N, q_offset):
        raise ValueError(f"cosine_mha: a block of {Nq} queries at token {q_offset} lies "
                         f"outside the {N}-token grid")
    _build.check(q, "q", torch.bfloat16)
    _build.check(kv, "kv", torch.bfloat16, (B, N, 2 * HD))
    _build.check(q_scale, "q_scale", torch.float32, (dim_head,))
    _build.check(k_scale, "k_scale", torch.float32, (dim_head,))
    for t, name in ((q, "q"), (kv, "kv")):
        if t.data_ptr() % 16:  # 16-byte vectors and TMA
            raise ValueError(f"cosine_mha: {name} is not 16-byte aligned")
    cos, sin = freqs_cis_2d(dim_head, N, q.device)
    q_hat, out = torch.empty_like(q), torch.empty_like(q)
    k_hat = torch.empty(B, N, HD, dtype=q.dtype, device=q.device)
    _build.launch("cosine_mha_launch", q.data_ptr(), kv.data_ptr(), q_scale.data_ptr(),
                  k_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(), q_hat.data_ptr(),
                  k_hat.data_ptr(), out.data_ptr(), B, Nq, N, q_offset, heads, dim_head,
                  float(scale), int(use_rope))
    cosine_mha.launches += 1
    return out


cosine_mha.launches = 0
