"""Cosine attention inside each group of n <= 8 rows (the temporal stack).

Per (group, head): l2norm(q) * q_scale, l2norm(k) * k_scale, softmax(scale *
q k^T [causal]) v, all in f32 on bf16 inputs. kv is the fused projection
output, k in the first H*D lanes of each row and v in the next H*D.
Replaces `omnitokenizer_tpu/ops/pallas/small_attn.py:small_n_attention` and
its token-flat twin `small_n_attention_flat`: a contiguous (B', n, H*D)
tensor is the same memory as the flat ((b h w) t) rows, so one kernel serves
both. The CUDA kernel is `csrc/small_attn.cu`, on the staged small-group
core `csrc/small_group.cuh` that mha's small branch shares;
`small_n_attention_plain` is its plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

MAX_SMALL_N = 8
# head widths of the small-group core: a team of D/16 lanes (rounded up to a
# power of two) holds 16 dims a lane
DIM_HEADS = tuple(range(16, 129, 16))


def small_n_supported(n: int, dim_head: int) -> bool:
    return 1 <= n <= MAX_SMALL_N and dim_head in DIM_HEADS


def narrowed(n: int, dim_head: int) -> bool:
    """Shapes the JAX gate takes (it sets no head width) and the kernel does
    not, which take the attention module's plain route: a head width that is
    no multiple of 16 or above 128. A lane holds two 16-byte vectors of a
    row, and a team of up to 8 lanes a row."""
    return 1 <= n <= MAX_SMALL_N and dim_head not in DIM_HEADS


def small_n_attention_plain(q, kv, q_scale, k_scale, heads: int, dim_head: int,
                            scale: float, causal: bool = False) -> torch.Tensor:
    B, N, HD = q.shape
    qh = q.float().view(B, N, heads, dim_head)
    k, v = kv.float().view(B, N, 2, heads, dim_head).unbind(2)
    qh = F.normalize(qh, dim=-1) * q_scale.float()
    k = F.normalize(k, dim=-1) * k_scale.float()
    s = torch.einsum("bihd,bjhd->bhij", qh, k) * scale
    if causal:
        mask = torch.ones(N, N, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(mask, float("-inf"))
    p = s.softmax(-1)
    out = torch.einsum("bhij,bjhd->bihd", p, v)
    return out.reshape(B, N, HD).to(q.dtype)


def small_n_attention(q: torch.Tensor, kv: torch.Tensor, q_scale: torch.Tensor,
                      k_scale: torch.Tensor, heads: int, dim_head: int,
                      scale: float, causal: bool = False) -> torch.Tensor:
    """q (B, N, H*D), kv (B, N, 2*H*D) bf16; q_scale/k_scale (D,) f32.
    Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return small_n_attention_plain(q, kv, q_scale, k_scale, heads, dim_head,
                                       scale, causal)
    _build.refuse_grad("small_n_attention", q, kv, q_scale, k_scale)
    B, N, HD = q.shape
    if B == 0:  # no rows (a rank of sequence parallelism that holds none): no launch
        return torch.empty_like(q)
    if not small_n_supported(N, dim_head) or HD != heads * dim_head:
        raise ValueError(f"small_n_attention: unsupported n={N} dim_head={dim_head}")
    _build.check(q, "q", torch.bfloat16)
    _build.check(kv, "kv", torch.bfloat16, (B, N, 2 * HD))
    _build.check(q_scale, "q_scale", torch.float32, (dim_head,))
    _build.check(k_scale, "k_scale", torch.float32, (dim_head,))
    out = torch.empty_like(q)
    _build.launch("small_attn_launch", q.data_ptr(), kv.data_ptr(), q_scale.data_ptr(),
                  k_scale.data_ptr(), out.data_ptr(), B, N, heads, dim_head,
                  float(scale), int(causal))
    small_n_attention.launches += 1
    return out


small_n_attention.launches = 0
