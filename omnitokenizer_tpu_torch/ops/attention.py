"""Cosine-similarity attention, the GEGLU feed-forward and the token-grid
Pooling/Up blocks (mirror of `omnitokenizer_tpu.ops.attention`).

Gates, as in the JAX package: a bf16 module called with training=False
takes the fused kernels (ops/kernels); they launch CUDA kernels for a CUDA
tensor and run their plain versions for a CPU tensor. A bf16 training call
takes them too where `OMNITOK_TRAIN_KERNEL_FWD` names the op group, through
ops/kernel_grad.py: the kernels as the primal, the plain math below
recomputed as the backward. f32 calls and the other training calls take
the plain math, which is the JAX f32 parity path; its softmax core,
`sdpa`, runs the `mha` kernel on a CUDA tensor inside that kernel's gate at
inference, in f32 and bf16 alike, as the JAX package runs `mha_pallas`
(its training `sdpa` is plain), and, under the `attn` group, as the primal
of an inference-route call that autograd records (a VAE's training step).
`prepare_kernels()` caches the kernels' bf16 (and padded) weights for
serving; without the cache an inference call casts the live parameters,
and a training call always does.

Under sequence parallelism (`sp=`, parallel/tp.py) a spatial call holds
its rank's token rows, `sp`'s span of the grid (ranks may hold different
counts, or none): it projects them, gathers K/V over the group
(`mesh.gather_summed`, each rank's count) and attends with its queries at
their global offset, on the one-process call's route: `cosine_mha` and
`mha` with a query block, a biased call on its bias's rows of the block,
and a grid of at most 8 tokens through `small_n_attention` on the whole
gathered grid (its q gathered too), this rank's rows kept; the kernels on
the card, their plain versions on the CPU. A rank without rows launches
no attention kernel but joins the gathers. Temporal calls stay local.

Under `attn_bias_mode='einsum'` a spatial `rel` call adds its CPB bias and
a causal call AliBi to the f32 logits. No attention kernel takes a bias
(the JAX gates refuse one): a biased call projects with `ln_qkv` where its
gate takes the width, then runs the plain math of `sdpa`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from .bias import ContinuousPositionBias, alibi_bias
from .kernel_grad import kernel_fwd_ref_bwd, train_kernel_fwd_ops
from .kernels.cosine_mha import cosine_mha, cosine_mha_supported
from .kernels.geglu_ff import geglu_ff, geglu_ff_supported, pad_geglu_weights
from .kernels.ln_qkv import ln_qkv, ln_qkv_supported
from .kernels.mha import mha, mha_plain, mha_supported, small_branch
from .kernels.mha import query_block_ok as mha_block_ok
from .kernels.small_attn import small_n_attention, small_n_supported
from .norms import layer_norm
from .rotary import apply_rotary_emb_2d


def l2norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics: x / max(||x||, eps)."""
    return F.normalize(t, dim=dim, eps=eps)


def _mha_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                causal: bool) -> torch.Tensor:
    """The `mha` kernel: its small branch reads the views as they stand,
    the flash branches take contiguous copies."""
    if not small_branch(*q.shape[-2:], k.shape[-2]):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return mha(q, k, v, scale, causal)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
         causal: bool = False, training: bool = False,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale [+ bias] [bottom-right causal]) v over (B, H,
    N, D) queries and (B, H, Nk, D) keys and values. Without a bias, a
    call with training=False inside the `mha` gate runs the kernel for a
    CUDA tensor, as
    `omnitokenizer_tpu.ops.attention.sdpa` routes between `mha_pallas` and
    XLA; a training=True call runs the plain math (`mha_plain`). With a
    bias (broadcast to (B, H, N, N)): the plain math, the bias added to the
    f32 logits before the mask, as the JAX `sdpa` does (its kernel gate
    refuses a bias).

    A training=False call that autograd records (an input requires grad
    under grad mode: a VAE's generator pass, which runs training=False as
    the JAX trainer runs it) takes the kernel as the primal and `mha_plain`
    recomputed as the backward (ops/kernel_grad.py), under the `attn` group
    of OMNITOK_TRAIN_KERNEL_FWD, and the plain math without it. The kernel
    has no backward of its own: its output alone would carry no gradient."""
    if bias is not None:
        return mha_plain(q, k, v, scale, causal, bias)
    if (training or not mha_supported(k.shape[-2], q.shape[-1], q.dtype)
            or not mha_block_ok(q.shape[-2], k.shape[-2], causal)):
        return mha_plain(q, k, v, scale, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if "attn" not in train_kernel_fwd_ops():
            return mha_plain(q, k, v, scale, causal)
        return kernel_fwd_ref_bwd(functools.partial(_mha_kernel, scale=scale, causal=causal),
                                  functools.partial(mha_plain, scale=scale, causal=causal),
                                  q, k, v)
    return _mha_kernel(q, k, v, scale, causal) if q.is_cuda else mha_plain(q, k, v, scale, causal)


def project(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor, wkv: torch.Tensor,
            dtype: torch.dtype):
    """The plain projections: q from the normed tokens, kv from the
    pre-norm input (the reference quirk), products in `dtype`."""
    xn = (layer_norm(x) * gamma).to(dtype)
    return F.linear(xn, wq.to(dtype)), F.linear(x.to(dtype), wkv.to(dtype))


def attend(q: torch.Tensor, kv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor, *,
           heads: int, dim_head: int, scale: float, causal: bool, use_rope: bool,
           dtype: torch.dtype, training: bool,
           bias: Optional[torch.Tensor] = None, q_offset: int = 0) -> torch.Tensor:
    """Plain math from the projections q (B, Nq, H*D), kv (B, N, 2*H*D) to
    the (B, Nq, H*D) tokens before the out-projection; `bias` is added to
    the logits (sdpa). q is the grid's tokens q_offset .. (all N of them
    by default), for RoPE."""
    B, Nq, inner = q.shape
    k, v = kv.chunk(2, dim=-1)
    q = q.reshape(B, Nq, heads, dim_head)
    k, v = (t.reshape(B, kv.shape[1], heads, dim_head) for t in (k, v))
    if use_rope:
        q, k = apply_rotary_emb_2d(q, k, q_offset)
    q = l2norm(q.float()) * q_scale
    k = l2norm(k.float()) * k_scale
    q = q.transpose(1, 2).to(dtype)
    k = k.transpose(1, 2).to(dtype)
    out = sdpa(q, k, v.transpose(1, 2), scale, causal=causal, training=training, bias=bias)
    return out.transpose(1, 2).reshape(B, Nq, inner)


def attention_ref_math(x, gamma, wq, wkv, q_scale, k_scale, *, dtype, heads, dim_head,
                       scale, causal, use_rope) -> torch.Tensor:
    """The plain route from x (B, N, D) and the parameters to the tokens
    before the out-projection (the JAX `_attention_ref_math`, bias-free):
    the recomputed backward of the training route's kernels."""
    q, kv = project(x, gamma, wq, wkv, dtype)
    return attend(q, kv, q_scale, k_scale, heads=heads, dim_head=dim_head, scale=scale,
                  causal=causal, use_rope=use_rope, dtype=dtype, training=True)


class Attention(nn.Module):
    """Cosine-sim multi-head attention with a fixed logit scale of 8.

    q and k are l2-normalized per head and rescaled by learned per-dim
    q_scale / k_scale. k/v project the PRE-norm input, only q the normed
    tokens (reference quirk). RoPE applies when spatial_pos='rope' and the
    call is spatial; the causal mask when the block is causal. The
    'sdpa' bias mode drops the rel-bias and AliBi terms; 'einsum' adds the
    CPB bias to a spatial call under spatial_pos='rel' and AliBi to a
    causal call, summed where both apply.

    `spatial` marks a module of a spatial stack: with spatial_pos='rel' it
    owns the CPB MLP (`spatial_rel_pos_bias`), whose parameters the JAX
    package creates on a spatial call."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 causal: bool = False, scale: float = 8.0, spatial_pos: str = "rel",
                 attn_bias_mode: str = "sdpa", dtype: torch.dtype = torch.float32,
                 spatial: bool = False):
        super().__init__()
        if attn_bias_mode not in ("sdpa", "einsum"):
            raise ValueError(f"attn_bias_mode {attn_bias_mode!r}: 'sdpa' or 'einsum'")
        self.dim, self.dim_head, self.heads = dim, dim_head, heads
        self.attn_bias_mode = attn_bias_mode
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
                training: bool, bias: Optional[torch.Tensor] = None,
                q_offset: int = 0) -> torch.Tensor:
        return attend(q, kv, self.q_scale, self.k_scale, heads=self.heads,
                      dim_head=self.dim_head, scale=self.scale, causal=self.causal,
                      use_rope=uses_rope, dtype=self.dtype, training=training, bias=bias,
                      q_offset=q_offset)

    def needs_bias(self, is_spatial: bool) -> bool:
        """Whether a call adds a bias to its logits: in 'einsum' mode, a
        spatial call under spatial_pos='rel' or any causal call."""
        return self.attn_bias_mode == "einsum" and (
            (self.spatial_pos == "rel" and is_spatial) or self.causal)

    def bias(self, n: int, is_spatial: bool, device) -> Optional[torch.Tensor]:
        """The (heads, n, n) f32 bias of a call, or None: the CPB bias of an
        int(sqrt(n))^2 grid, AliBi, or their sum."""
        if not self.needs_bias(is_spatial):
            return None
        out = None
        if self.spatial_pos == "rel" and is_spatial:
            h = int(n ** 0.5)
            out = self.spatial_rel_pos_bias(h, h)
        if self.causal:
            ab = alibi_bias(self.heads, n, n, device)
            out = ab if out is None else out + ab
        return out

    def train_route(self, n: int, is_spatial: bool) -> Optional[str]:
        """The kernel that a bf16 training call runs under kernel_grad, as
        the JAX gates pick it: 'small' (ln_qkv + small_n_attention) or
        'cosine' (ln_qkv + cosine_mha), or None for the plain math. A
        temporal call of n <= 8 frames is the JAX flat route: the port's
        contiguous (B', n, D) tensor is the flat rows' memory. A biased call
        takes the plain math, as no attention kernel takes a bias."""
        ops = train_kernel_fwd_ops()
        inner = self.dim_head * self.heads
        if (self.dtype != torch.bfloat16 or not ln_qkv_supported(self.dim, inner, 2 * inner)
                or self.needs_bias(is_spatial)):
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

    def _qkv(self, x: torch.Tensor):
        """bf16 inference's projections, as the JAX module dispatches them:
        ln_qkv inside its gate, else plain; the kernels' weights from the
        serving cache where it is built, else cast from the live
        parameters. Returns q, kv and the attention kernels' scales."""
        B, N, D = x.shape
        proj, qs, ks = self.kernel_weights or self._cast_weights()
        if proj is None:
            return (*self._project(x), qs, ks)
        q2, kv2 = ln_qkv(x.reshape(B * N, D).to(self.dtype), *proj)
        inner = self.dim_head * self.heads
        return q2.view(B, N, inner), kv2.view(B, N, 2 * inner), qs, ks

    def _forward_sp(self, x: torch.Tensor, training: bool, sp) -> torch.Tensor:
        """A spatial call under sequence parallelism: x holds this rank's
        token rows, rows spans[rank] of the grid's, `sp.cols` tokens a row.
        It takes the one-process call's route: a bias's rows of this block,
        the small-group kernel on the whole grid (q gathered too: at most 8
        tokens a frame) with this block's rows kept, or a query block."""
        B, Nq, _ = x.shape
        spans, cols = sp.spans, sp.cols
        sizes = [(hi - lo) * cols for lo, hi in spans]
        N, offset = spans[-1][1] * cols, spans[sp.rank][0] * cols
        uses_rope = self.spatial_pos == "rope"
        bias = self.bias(N, True, x.device)
        if bias is not None:
            bias = bias[:, offset:offset + Nq]
        if self.dtype != torch.bfloat16:
            q, kv = self._project(x)
            kv = mesh.gather_summed(kv, 1, sp.group, sizes)
            return self._proj_out(self._attend(q, kv, uses_rope, training, bias, offset))
        if training:
            sp.refuse("a bf16 training-route call", "the kernels' training route under SP "
                      "has no reference: the JAX package's SP gradient is f32")
        q, kv, qs, ks = self._qkv(x)
        kv = mesh.gather_summed(kv, 1, sp.group, sizes)
        if bias is not None:
            out = self._attend(q, kv, uses_rope, False, bias, offset)
        elif not uses_rope and small_n_supported(N, self.dim_head):
            whole = mesh.gather_from(q, 1, sp.group, sizes)
            out = q if not Nq else small_n_attention(
                whole, kv, qs, ks, self.heads, self.dim_head, self.scale,
                self.causal)[:, offset:offset + Nq]
        elif not self.causal and cosine_mha_supported(N, self.dim_head):
            out = cosine_mha(q, kv, qs, ks, self.heads, self.dim_head, self.scale, uses_rope,
                             q_offset=offset)
        else:
            out = self._attend(q, kv, uses_rope, False, q_offset=offset)
        return self._proj_out(out)

    def forward(self, x: torch.Tensor, is_spatial: bool = True,
                training: bool = False, sp=None) -> torch.Tensor:
        """`sp`: the SeqParallel of a spatial call whose x holds a rank's rows."""
        if sp is not None and is_spatial:
            return self._forward_sp(x, training, sp)
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
        bias = self.bias(N, is_spatial, x.device)
        if self.dtype != torch.bfloat16 or training:
            return self._proj_out(self._attend(*self._project(x), uses_rope, training, bias))

        # bf16 inference: the projections (_qkv), then the attention kernel
        # that takes (N, dim_head), whatever made q and kv, unless a bias applies
        q, kv, qs, ks = self._qkv(x)
        if bias is not None:
            out = self._attend(q, kv, uses_rope, training, bias)
        elif not uses_rope and small_n_supported(N, self.dim_head):
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


class Pooling(nn.Module):
    """Token-grid downsample of (B, N, C) on the (h, w) grid given (a
    rank's rows under sequence parallelism), else the int(sqrt(N))^2 one:
    'a' average and 'm' max over 2 x 2, or 'l' a Linear (`pool`, with bias)
    of 4 consecutive tokens to C. Output token i of 'l' reads grid rows
    2 i // w and the next, so a block of whole row pairs pools on its own."""

    def __init__(self, pool_type: str, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_type, self.dtype = pool_type, dtype
        if pool_type == "l":
            self.pool = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, grid=None) -> torch.Tensor:
        B, N, C = x.shape
        if self.pool_type == "l":
            x = x.reshape(B, N // 4, 4 * C).to(self.dtype)
            return F.linear(x, self.pool.weight.to(self.dtype), self.pool.bias.to(self.dtype))
        h, w = grid or (int(N ** 0.5),) * 2
        g = x.reshape(B, h // 2, 2, w // 2, 2, C)
        g = g.mean((2, 4)) if self.pool_type == "a" else g.amax((2, 4))
        return g.reshape(B, (h // 2) * (w // 2), C)


class Up(nn.Module):
    """Token-grid upsample of (B, N, C) on the (h, w) grid given (a rank's
    rows under sequence parallelism), else the int(sqrt(N))^2 one: 'n'
    nearest x2, or 'r' nearest x2 then a Linear (`up`, with bias)."""

    def __init__(self, up_type: str, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up_type, self.dtype = up_type, dtype
        if up_type == "r":
            self.up = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, grid=None) -> torch.Tensor:
        B, N, C = x.shape
        h, w = grid or (int(N ** 0.5),) * 2
        g = x.reshape(B, h, w, C).repeat_interleave(2, 1).repeat_interleave(2, 2)
        x = g.reshape(B, 4 * N, C)
        if self.up_type == "r":
            x = F.linear(x.to(self.dtype), self.up.weight.to(self.dtype), self.up.bias.to(self.dtype))
        return x
