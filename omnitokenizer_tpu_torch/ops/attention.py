"""Cosine-similarity attention and the GEGLU feed-forward (mirror of
`omnitokenizer_tpu.ops.attention`).

Gates, as in the JAX package: a bf16 module called with training=False
takes the fused kernels (ops/kernels); they launch CUDA kernels for a CUDA
tensor and run their plain versions for a CPU tensor. A bf16 training call
takes them too where `OMNITOK_TRAIN_KERNEL_FWD` names the op group, through
ops/kernel_grad.py: the kernels as the primal, the plain math below
recomputed as the backward. f32 calls and the other training calls take
the plain math, which is the JAX f32 parity path; its softmax core,
`sdpa`, runs the `mha` kernel on a CUDA tensor inside that kernel's gate at
inference, in f32 and bf16 alike, as the JAX package runs `mha_pallas`
(its training `sdpa` is plain). `prepare_kernels()` caches the kernels'
bf16 (and padded) weights for serving; without the cache an inference
call casts the live parameters, and a training call always does.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .bias import ContinuousPositionBias
from .kernel_grad import kernel_fwd_ref_bwd, train_kernel_fwd_ops
from .kernels.cosine_mha import cosine_mha, cosine_mha_supported
from .kernels.geglu_ff import geglu_ff, geglu_ff_supported, pad_geglu_weights
from .kernels.ln_qkv import ln_qkv, ln_qkv_supported
from .kernels.mha import mha, mha_plain, mha_supported, small_branch
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
    routes between `mha_pallas` and XLA. The kernel's small branch reads the
    views as they stand; the flash branches take contiguous copies."""
    n, d = q.shape[-2:]
    if not training and q.is_cuda and mha_supported(n, d, q.dtype):
        if not small_branch(n, d):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return mha(q, k, v, scale, causal)
    return mha_plain(q, k, v, scale, causal)


def project(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor, wkv: torch.Tensor,
            dtype: torch.dtype):
    """The plain projections: q from the normed tokens, kv from the
    pre-norm input (the reference quirk), products in `dtype`."""
    xn = (layer_norm(x) * gamma).to(dtype)
    return F.linear(xn, wq.to(dtype)), F.linear(x.to(dtype), wkv.to(dtype))


def attend(q: torch.Tensor, kv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor, *,
           heads: int, dim_head: int, scale: float, causal: bool, use_rope: bool,
           dtype: torch.dtype, training: bool) -> torch.Tensor:
    """Plain math from the projections q (B, N, H*D), kv (B, N, 2*H*D) to
    the (B, N, H*D) tokens before the out-projection."""
    B, N, inner = q.shape
    k, v = kv.chunk(2, dim=-1)
    q, k, v = (t.reshape(B, N, heads, dim_head) for t in (q, k, v))
    if use_rope:
        q, k = apply_rotary_emb_2d(q, k)
    q = l2norm(q.float()) * q_scale
    k = l2norm(k.float()) * k_scale
    q = q.transpose(1, 2).to(dtype)
    k = k.transpose(1, 2).to(dtype)
    out = sdpa(q, k, v.transpose(1, 2), scale, causal=causal, training=training)
    return out.transpose(1, 2).reshape(B, N, inner)


def attention_ref_math(x, gamma, wq, wkv, q_scale, k_scale, *, dtype, heads, dim_head,
                       scale, causal, use_rope) -> torch.Tensor:
    """The plain route from x (B, N, D) and the parameters to the tokens
    before the out-projection (the JAX `_attention_ref_math`): the
    recomputed backward of the training route's kernels."""
    q, kv = project(x, gamma, wq, wkv, dtype)
    return attend(q, kv, q_scale, k_scale, heads=heads, dim_head=dim_head, scale=scale,
                  causal=causal, use_rope=use_rope, dtype=dtype, training=True)


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

    def _cast_weights(self) -> tuple:
        """The kernels' weights from the live parameters: the q/k scales
        for the attention kernels, and the bf16 projection weights where
        `ln_qkv` takes the shape (as the JAX module gates the two apart)."""
        inner = self.dim_head * self.heads
        proj = None
        if ln_qkv_supported(self.dim, inner, 2 * inner):
            proj = (self.norm_gamma.float().contiguous(),
                    self.to_q.weight.to(torch.bfloat16).contiguous(),
                    self.to_kv.weight.to(torch.bfloat16).contiguous())
        return proj, self.q_scale.float().contiguous(), self.k_scale.float().contiguous()

    @torch.no_grad()
    def prepare_kernels(self) -> None:
        """The serving cache: the kernels' weights built once, so that an
        inference call casts nothing. Training never reads it."""
        if self.dtype == torch.bfloat16:
            self.kernel_weights = self._cast_weights()

    def _proj_out(self, o: torch.Tensor) -> torch.Tensor:
        return F.linear(o.to(self.dtype), self.to_out.weight.to(self.dtype))

    def _project(self, x: torch.Tensor):
        return project(x, self.norm_gamma, self.to_q.weight, self.to_kv.weight, self.dtype)

    def _attend(self, q: torch.Tensor, kv: torch.Tensor, uses_rope: bool,
                training: bool) -> torch.Tensor:
        return attend(q, kv, self.q_scale, self.k_scale, heads=self.heads,
                      dim_head=self.dim_head, scale=self.scale, causal=self.causal,
                      use_rope=uses_rope, dtype=self.dtype, training=training)

    def train_route(self, n: int, is_spatial: bool) -> Optional[str]:
        """The kernel that a bf16 training call runs under kernel_grad, as
        the JAX gates pick it: 'small' (ln_qkv + small_n_attention) or
        'cosine' (ln_qkv + cosine_mha), or None for the plain math. A
        temporal call of n <= 8 frames is the JAX flat route: the port's
        contiguous (B', n, D) tensor is the flat rows' memory."""
        ops = train_kernel_fwd_ops()
        inner = self.dim_head * self.heads
        if self.dtype != torch.bfloat16 or not ln_qkv_supported(self.dim, inner, 2 * inner):
            return None
        uses_rope = self.spatial_pos == "rope" and is_spatial
        if not is_spatial and "flat" in ops and small_n_supported(n, self.dim_head):
            return "small"
        if "attn" not in ops or n % 8:
            return None
        if not uses_rope and small_n_supported(n, self.dim_head):
            return "small"
        if not self.causal and cosine_mha_supported(n, self.dim_head):
            return "cosine"
        return None

    def _train_kernel(self, route: str, uses_rope: bool, x, gamma, wq, wkv, qs, ks):
        """The training route's primal: the kernels on the live parameters,
        cast on this call."""
        B, N, D = x.shape
        inner = self.dim_head * self.heads
        q2, kv2 = ln_qkv(x.reshape(B * N, D).contiguous(), gamma.float().contiguous(),
                         wq.to(torch.bfloat16).contiguous(), wkv.to(torch.bfloat16).contiguous())
        q, kv = q2.view(B, N, inner), kv2.view(B, N, 2 * inner)
        qs, ks = qs.float().contiguous(), ks.float().contiguous()
        if route == "small":
            return small_n_attention(q, kv, qs, ks, self.heads, self.dim_head, self.scale,
                                     self.causal)
        return cosine_mha(q, kv, qs, ks, self.heads, self.dim_head, self.scale, uses_rope)

    def forward(self, x: torch.Tensor, is_spatial: bool = True,
                training: bool = False) -> torch.Tensor:
        B, N, D = x.shape
        uses_rope = self.spatial_pos == "rope" and is_spatial

        route = self.train_route(N, is_spatial) if training else None
        if route is not None:
            ref = functools.partial(
                attention_ref_math, dtype=self.dtype, heads=self.heads, dim_head=self.dim_head,
                scale=self.scale, causal=self.causal, use_rope=uses_rope)
            out = kernel_fwd_ref_bwd(
                functools.partial(self._train_kernel, route, uses_rope), ref,
                x.to(self.dtype), self.norm_gamma, self.to_q.weight, self.to_kv.weight,
                self.q_scale, self.k_scale)
            return self._proj_out(out)
        if self.dtype != torch.bfloat16 or training:
            return self._proj_out(self._attend(*self._project(x), uses_rope, training))

        # bf16 inference, as the JAX module dispatches: the projections by
        # ln_qkv inside its gate, else plain; then the attention kernel that
        # takes (N, dim_head), whatever made q and kv. Weights from the
        # serving cache where it is built, else cast from the live parameters
        proj, qs, ks = self.kernel_weights or self._cast_weights()
        if proj is not None:
            q2, kv2 = ln_qkv(x.reshape(B * N, D).to(self.dtype), *proj)
            inner = self.dim_head * self.heads
            q, kv = q2.view(B, N, inner), kv2.view(B, N, 2 * inner)
        else:
            q, kv = self._project(x)
        if not uses_rope and small_n_supported(N, self.dim_head):
            out = small_n_attention(q, kv, qs, ks, self.heads, self.dim_head,
                                    self.scale, self.causal)
        elif not self.causal and cosine_mha_supported(N, self.dim_head):
            out = cosine_mha(q, kv, qs, ks, self.heads, self.dim_head, self.scale, uses_rope)
        else:
            out = self._attend(q, kv, uses_rope, training)
        return self._proj_out(out)


def feed_forward_ref_math(x, ln_w, ln_b, w1, w2, *, dtype) -> torch.Tensor:
    """LayerNorm -> Linear -> GEGLU (erf) -> Linear, products in `dtype`:
    the plain route, and the recomputed backward of geglu_ff's training
    route."""
    h = (layer_norm(x) * ln_w + ln_b).to(dtype)
    h = F.linear(h, w1.to(dtype))
    val, gate = h.chunk(2, dim=-1)
    h = F.gelu(gate) * val
    return F.linear(h.to(dtype), w2.to(dtype))


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

    @staticmethod
    def _cast(ln_w, ln_b, w1, w2) -> tuple:
        """geglu_ff's weights from the parameters given: f32 LN, bf16 W1
        and W2 zero-padded to whole tiles."""
        w1p, w2p = pad_geglu_weights(w1, w2)
        return ln_w.float().contiguous(), ln_b.float().contiguous(), w1p, w2p

    def _params(self) -> tuple:
        return self.norm_weight, self.norm_bias, self.proj_in.weight, self.proj_out.weight

    @torch.no_grad()
    def prepare_kernels(self) -> None:
        """The serving cache (see Attention.prepare_kernels)."""
        if self.dtype == torch.bfloat16 and geglu_ff_supported(self.dim):
            self.kernel_weights = self._cast(*self._params())

    def _train_kernel(self, x, ln_w, ln_b, w1, w2):
        return geglu_ff(x, *self._cast(ln_w, ln_b, w1, w2))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        kernel_ok = self.dtype == torch.bfloat16 and geglu_ff_supported(self.dim)
        if kernel_ok and training and "ff" in train_kernel_fwd_ops():
            flat = x.reshape(-1, self.dim).to(self.dtype).contiguous()
            out = kernel_fwd_ref_bwd(
                self._train_kernel, functools.partial(feed_forward_ref_math, dtype=self.dtype),
                flat, *self._params())
            return out.view(x.shape)
        if kernel_ok and not training:
            weights = self.kernel_weights or self._cast(*self._params())
            out = geglu_ff(x.reshape(-1, self.dim).to(self.dtype), *weights)
            return out.view(x.shape)
        return feed_forward_ref_math(x, *self._params(), dtype=self.dtype)
