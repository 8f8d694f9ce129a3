"""Cosine-similarity attention and the GEGLU feed-forward (mirror of
`omnitokenizer_tpu.ops.attention`).

Gates, as in the JAX package: a bf16 module called with training=False
takes the fused kernels (ops/kernels); they launch CUDA kernels for a CUDA
tensor and run their plain versions for a CPU tensor. f32 and training
calls take the plain math below, which is the JAX f32 parity path; its
softmax core, `sdpa`, runs the `mha` kernel on a CUDA tensor inside that
kernel's gate at inference, in f32 and bf16 alike, as the JAX package runs
`mha_pallas`. `prepare_kernels()` builds the kernels' bf16 (and padded)
weights once, at the serving step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .bias import ContinuousPositionBias
from .kernels.cosine_mha import cosine_mha, cosine_mha_supported
from .kernels.geglu_ff import geglu_ff, geglu_ff_supported, pad_geglu_weights
from .kernels.ln_qkv import ln_qkv, ln_qkv_supported
from .kernels.mha import mha, mha_plain, mha_supported
from .kernels.small_attn import small_n_attention, small_n_supported
from .norms import layer_norm
from .rotary import apply_rotary_emb_2d


def l2norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics: x / max(||x||, eps)."""
    return F.normalize(t, dim=dim, eps=eps)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
         causal: bool = False, training: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale [bottom-right causal]) v over (B, H, N, D).
    The `mha` kernel for a CUDA tensor inside its gate at inference, else
    its plain math (`mha_plain`), as `omnitokenizer_tpu.ops.attention.sdpa`
    routes between `mha_pallas` and XLA."""
    if not training and q.is_cuda and mha_supported(q.shape[-2], q.shape[-1], q.dtype):
        return mha(q.contiguous(), k.contiguous(), v.contiguous(), scale, causal)
    return mha_plain(q, k, v, scale, causal)


def _kernels_ready(module: nn.Module):
    if module.kernel_weights is None:
        raise RuntimeError(f"{type(module).__name__}: kernel weights not built; "
                           "call prepare_kernels() (the wrapper's serving step)")
    return module.kernel_weights


class Attention(nn.Module):
    """Cosine-sim multi-head attention with a fixed logit scale of 8.

    q and k are l2-normalized per head and rescaled by learned per-dim
    q_scale / k_scale. k/v project the PRE-norm input, only q the normed
    tokens (reference quirk). RoPE applies when spatial_pos='rope' and the
    call is spatial; the causal mask when the block is causal. The
    'sdpa' bias mode drops the rel-bias and AliBi terms.

    `spatial` marks a module of a spatial stack: with spatial_pos='rel' it
    owns the CPB MLP (`spatial_rel_pos_bias`), whose parameters the JAX
    package creates on a spatial call and whose bias it then drops."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 causal: bool = False, scale: float = 8.0, spatial_pos: str = "rel",
                 attn_bias_mode: str = "sdpa", dtype: torch.dtype = torch.float32,
                 spatial: bool = False):
        super().__init__()
        if attn_bias_mode != "sdpa":
            raise NotImplementedError(
                f"attn_bias_mode={attn_bias_mode!r} is not ported yet (see ROADMAP.md)")
        self.dim, self.dim_head, self.heads = dim, dim_head, heads
        self.causal, self.scale, self.spatial_pos, self.dtype = causal, scale, spatial_pos, dtype
        inner = dim_head * heads
        self.norm_gamma = nn.Parameter(torch.ones(dim))
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        if spatial and spatial_pos == "rel":
            self.spatial_rel_pos_bias = ContinuousPositionBias(dim, heads)
        self.kernel_weights: Optional[tuple] = None

    def prepare_kernels(self) -> None:
        inner = self.dim_head * self.heads
        if not ln_qkv_supported(self.dim, inner, 2 * inner):
            return
        self.kernel_weights = (
            self.norm_gamma.detach().float().contiguous(),
            self.to_q.weight.detach().to(torch.bfloat16).contiguous(),
            self.to_kv.weight.detach().to(torch.bfloat16).contiguous(),
            self.q_scale.detach().float().contiguous(),
            self.k_scale.detach().float().contiguous(),
        )

    def _proj_out(self, o: torch.Tensor) -> torch.Tensor:
        return F.linear(o.to(self.dtype), self.to_out.weight.to(self.dtype))

    def _attend(self, q: torch.Tensor, kv: torch.Tensor, uses_rope: bool,
                training: bool) -> torch.Tensor:
        """Plain math from the projections q (B, N, H*D), kv (B, N, 2*H*D)."""
        B, N, inner = q.shape
        k, v = kv.chunk(2, dim=-1)
        q, k, v = (t.reshape(B, N, self.heads, self.dim_head) for t in (q, k, v))
        if uses_rope:
            q, k = apply_rotary_emb_2d(q, k)
        q = l2norm(q.float()) * self.q_scale
        k = l2norm(k.float()) * self.k_scale
        q = q.transpose(1, 2).to(self.dtype)
        k = k.transpose(1, 2).to(self.dtype)
        out = sdpa(q, k, v.transpose(1, 2), self.scale, causal=self.causal, training=training)
        return out.transpose(1, 2).reshape(B, N, inner)

    def forward(self, x: torch.Tensor, is_spatial: bool = True,
                training: bool = False) -> torch.Tensor:
        B, N, D = x.shape
        inner = self.dim_head * self.heads
        uses_rope = self.spatial_pos == "rope" and is_spatial

        if (self.dtype == torch.bfloat16 and not training
                and ln_qkv_supported(D, inner, 2 * inner)):
            gamma, wq, wkv, qs, ks = _kernels_ready(self)
            q2, kv2 = ln_qkv(x.reshape(B * N, D).to(self.dtype), gamma, wq, wkv)
            q, kv = q2.view(B, N, inner), kv2.view(B, N, 2 * inner)
            if not uses_rope and small_n_supported(N, self.dim_head):
                out = small_n_attention(q, kv, qs, ks, self.heads, self.dim_head,
                                        self.scale, self.causal)
            elif not self.causal and cosine_mha_supported(N, self.dim_head):
                out = cosine_mha(q, kv, qs, ks, self.heads, self.dim_head,
                                 self.scale, uses_rope)
            else:
                out = self._attend(q, kv, uses_rope, training)
            return self._proj_out(out)

        xn = (layer_norm(x) * self.norm_gamma).to(self.dtype)
        q = F.linear(xn, self.to_q.weight.to(self.dtype))
        kv = F.linear(x.to(self.dtype), self.to_kv.weight.to(self.dtype))
        return self._proj_out(self._attend(q, kv, uses_rope, training))


class FeedForward(nn.Module):
    """LayerNorm -> Linear(2*inner, no bias) -> GEGLU (erf) -> Linear(dim, no
    bias), inner = int(mult * 2/3 * dim), [val | gate] split."""

    def __init__(self, dim: int, mult: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        inner = int(mult * (2.0 / 3.0) * dim)
        self.norm_weight = nn.Parameter(torch.ones(dim))
        self.norm_bias = nn.Parameter(torch.zeros(dim))
        self.proj_in = nn.Linear(dim, 2 * inner, bias=False)
        self.proj_out = nn.Linear(inner, dim, bias=False)
        self.kernel_weights: Optional[tuple] = None

    def prepare_kernels(self) -> None:
        if not geglu_ff_supported(self.dim):
            return
        w1p, w2p = pad_geglu_weights(self.proj_in.weight.detach(),
                                     self.proj_out.weight.detach())
        self.kernel_weights = (self.norm_weight.detach().float().contiguous(),
                               self.norm_bias.detach().float().contiguous(), w1p, w2p)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        if self.dtype == torch.bfloat16 and not training and geglu_ff_supported(self.dim):
            ln_w, ln_b, w1p, w2p = _kernels_ready(self)
            out = geglu_ff(x.reshape(-1, self.dim).to(self.dtype), ln_w, ln_b, w1p, w2p)
            return out.view(x.shape)
        h = (layer_norm(x) * self.norm_weight + self.norm_bias).to(self.dtype)
        h = F.linear(h, self.proj_in.weight.to(self.dtype))
        val, gate = h.chunk(2, dim=-1)
        h = F.gelu(gate) * val
        return F.linear(h.to(self.dtype), self.proj_out.weight.to(self.dtype))
