"""LatteT2V, the text-to-video latent diffusion transformer (mirror of
`omnitokenizer_tpu.models.latte_t2v`): PixArt-alpha's `ada_norm_single`
blocks with caption cross-attention, spatial and temporal in turn.

Channels-first per frame, as the port's Latte: x (B, F, C, H, W), t (B,),
captions (B, L, caption_channels) with a (B, L) keep-mask -> (B, F, out_C,
H, W). In joint image-video training (use_image_num > 0, train=True) the
captions are (B, 1 + use_image_num, L, Cc) and the mask (B, 1 +
use_image_num, L): the first caption is the video's, one for each of its
F - use_image_num frames, the rest one per image; the images bypass the
temporal blocks, and the temporal table is never added on this path (the
reference's quirk).

The modules carry the reference's torch names (pos_embed.proj,
adaln_single.emb.timestep_embedder.linear_{1,2}, adaln_single.linear,
caption_projection.linear_{1,2}, transformer_blocks.N.{attn1, attn2, ff,
norm*, scale_shift_table}, temporal_transformer_blocks.N..., the root
scale_shift_table and proj_out), so a reference state_dict loads through
convert.load_diffusion_state_dict, which drops the fixed sin-cos buffer
pos_embed.pos_embed. The patch embedding keeps the conv's (D, C, p, p) weight and
runs as one matmul over the patches (no TF32 rounding in f32).

Parameters stay f32 and a call computes in cfg.dtype, casting them as
flax's Dense layers do; `serving()` casts them once. Attention is
F.scaled_dot_product_attention (the JAX module is a plain einsum: no
Pallas kernel), the caption keep-mask an additive -10000 bias on the
keys, so that a row with every key masked stays finite.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dit import PatchEmbed, dense, sincos_1d, timestep_embedding

MASK_BIAS = -10000.0


@dataclass(frozen=True)
class LatteT2VConfig:
    """The JAX LatteT2VConfig: the reference LatteT2V.__init__ for its
    patched, `ada_norm_single` configuration."""

    num_attention_heads: int = 16
    attention_head_dim: int = 88
    in_channels: int = 4
    out_channels: Optional[int] = None
    num_layers: int = 1
    cross_attention_dim: Optional[int] = None
    attention_bias: bool = False
    sample_size: int = 32
    patch_size: int = 2
    activation_fn: str = "geglu"  # or "gelu-approximate" (PixArt)
    norm_eps: float = 1e-5
    norm_elementwise_affine: bool = True
    caption_channels: Optional[int] = None
    video_length: int = 16
    dtype: torch.dtype = torch.float32

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def out_ch(self) -> int:
        return self.in_channels if self.out_channels is None else self.out_channels

    @property
    def interpolation_scale(self) -> int:
        return max(self.sample_size // 64, 1)

    def replace(self, **kw) -> "LatteT2VConfig":
        return dataclasses.replace(self, **kw)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax LayerNorm(dtype): f32 statistics (and affine), output in dtype."""
    w = None if norm.weight is None else norm.weight.float()
    b = None if norm.bias is None else norm.bias.float()
    return F.layer_norm(x.float(), norm.normalized_shape, w, b, norm.eps).to(dtype)


class MHA(nn.Module):
    """diffusers' Attention: q/k/v projections (biased with
    attention_bias), a biased out-projection (to_out.0), softmax(q k^T /
    sqrt(d) + bias) v, the bias (B, 1, L) over the keys."""

    def __init__(self, dim: int, heads: int, head_dim: int, qkv_bias: bool):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.to_q = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype, ctx: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, _ = x.shape
        ctx = x if ctx is None else ctx
        H, hd = self.heads, self.head_dim
        q = dense(x, self.to_q, dtype).reshape(B, N, H, hd).transpose(1, 2)
        k = dense(ctx, self.to_k, dtype).reshape(B, ctx.shape[1], H, hd).transpose(1, 2)
        v = dense(ctx, self.to_v, dtype).reshape(B, ctx.shape[1], H, hd).transpose(1, 2)
        mask = None if bias is None else bias[:, None].to(dtype)  # (B, 1, 1, L)
        y = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return dense(y.transpose(1, 2).reshape(B, N, H * hd), self.to_out[0], dtype)


class _Proj(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.proj = nn.Linear(dim, out)


class T2VFeedForward(nn.Module):
    """diffusers' FeedForward, inner 4 * dim: 'geglu' (net.0.proj to [val |
    gate], val * exact gelu(gate)) or 'gelu-approximate' (tanh gelu), then
    net.2 back to dim; the activation in f32."""

    def __init__(self, dim: int, activation_fn: str):
        super().__init__()
        if activation_fn not in ("geglu", "gelu-approximate"):
            raise ValueError(f"activation_fn {activation_fn!r}: 'geglu' or 'gelu-approximate'")
        self.activation_fn = activation_fn
        inner = 4 * dim
        self.net = nn.ModuleList([_Proj(dim, 2 * inner if activation_fn == "geglu" else inner),
                                  nn.Dropout(0.0), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = dense(x, self.net[0].proj, dtype)
        if self.activation_fn == "geglu":
            h, gate = h.chunk(2, dim=-1)
            h = h * F.gelu(gate.float()).to(dtype)
        else:
            h = F.gelu(h.float(), approximate="tanh").to(dtype)
        return dense(h, self.net[2], dtype)


class T2VBlock(nn.Module):
    """An `ada_norm_single` block. cross=True: diffusers'
    BasicTransformerBlock (self-attention, caption cross-attention with no
    norm before it, norm2 and the feed-forward); cross=False: the
    reference's temporal BasicTransformerBlock_ (self-attention, norm3 and
    the feed-forward). Each block adds its scale_shift_table (6, D) to the
    timestep's 6-way modulation."""

    def __init__(self, cfg: LatteT2VConfig, cross: bool):
        super().__init__()
        D = cfg.inner_dim
        self.cross = cross
        self.scale_shift_table = nn.Parameter(torch.zeros(6, D))

        def norm():
            return nn.LayerNorm(D, eps=cfg.norm_eps, elementwise_affine=cfg.norm_elementwise_affine)

        def mha():
            return MHA(D, cfg.num_attention_heads, cfg.attention_head_dim, cfg.attention_bias)

        self.norm1, self.attn1 = norm(), mha()
        if cross:
            self.attn2, self.norm2 = mha(), norm()
        else:
            self.norm3 = norm()
        self.ff = T2VFeedForward(D, cfg.activation_fn)

    def forward(self, x: torch.Tensor, t6: torch.Tensor, dtype: torch.dtype,
                ctx: Optional[torch.Tensor] = None,
                ctx_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, _, D = x.shape
        mod = self.scale_shift_table[None].to(dtype) + t6.reshape(B, 6, D)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = (mod[:, i][:, None] for i in range(6))
        h = _layer_norm(self.norm1, x, dtype) * (1 + sc_msa) + sh_msa
        x = x + g_msa * self.attn1(h, dtype)
        if self.cross:
            x = x + self.attn2(x, dtype, ctx=ctx, bias=ctx_bias)
            h = _layer_norm(self.norm2, x, dtype)
        else:
            h = _layer_norm(self.norm3, x, dtype)
        h = h * (1 + sc_mlp) + sh_mlp
        return x + g_mlp * self.ff(h, dtype)


class TimestepEmbedding(nn.Module):
    """The 256-wide cat[cos, sin] sinusoid through linear_1, SiLU, linear_2."""

    def __init__(self, dim: int, freq_size: int = 256):
        super().__init__()
        self.freq_size = freq_size
        self.linear_1 = nn.Linear(freq_size, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = timestep_embedding(t, self.freq_size).to(dtype)
        return dense(F.silu(dense(h, self.linear_1, dtype)), self.linear_2, dtype)


class AdaLayerNormSingle(nn.Module):
    """PixArt's adaLN-single: one timestep embedding (emb.timestep_embedder)
    and one Linear to the 6-way modulation every block shares."""

    def __init__(self, dim: int):
        super().__init__()
        self.emb = nn.Module()
        self.emb.timestep_embedder = TimestepEmbedding(dim)
        self.linear = nn.Linear(dim, 6 * dim)


class CaptionProjection(nn.Module):
    def __init__(self, in_features: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_features, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = dense(x, self.linear_1, dtype)
        return dense(F.gelu(h.float(), approximate="tanh").to(dtype), self.linear_2, dtype)


class LatteT2V(nn.Module):
    def __init__(self, cfg: LatteT2VConfig):
        super().__init__()
        self.cfg = cfg
        D, p = cfg.inner_dim, cfg.patch_size
        self.pos_embed = PatchEmbed(p, cfg.in_channels, D)
        self.adaln_single = AdaLayerNormSingle(D)
        if cfg.caption_channels is not None:
            self.caption_projection = CaptionProjection(cfg.caption_channels, D)
        self.transformer_blocks = nn.ModuleList(T2VBlock(cfg, True) for _ in range(cfg.num_layers))
        self.temporal_transformer_blocks = nn.ModuleList(
            T2VBlock(cfg, False) for _ in range(cfg.num_layers))
        self.norm_out = nn.LayerNorm(D, eps=1e-6, elementwise_affine=False)
        self.scale_shift_table = nn.Parameter(torch.zeros(2, D))
        self.proj_out = nn.Linear(D, p * p * cfg.out_ch)
        # the interpolated 2D sin-cos table ([w, h] halves) and the temporal one
        h_ = cfg.sample_size // p
        grid = np.arange(h_, dtype=np.float64) / cfg.interpolation_scale
        gw, gh = np.meshgrid(grid, grid)
        pos = np.concatenate([sincos_1d(D // 2, gw.reshape(-1)),
                              sincos_1d(D // 2, gh.reshape(-1))], axis=1)
        self.register_buffer("pos_table", torch.tensor(pos, dtype=torch.float32), persistent=False)
        self.register_buffer("temp_table", torch.tensor(
            sincos_1d(D, np.arange(cfg.video_length, dtype=np.float64)), dtype=torch.float32),
            persistent=False)

    def serving(self) -> "LatteT2V":
        """A copy for inference whose parameters are already cfg.dtype."""
        return copy.deepcopy(self).eval().requires_grad_(False).to(self.cfg.dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None, use_image_num: int = 0,
                enable_temporal_attentions: bool = True, train: bool = False) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        D, p = cfg.inner_dim, cfg.patch_size
        B, Fr, C, H, W = x.shape
        if (C, H, W) != (cfg.in_channels, cfg.sample_size, cfg.sample_size):
            raise ValueError(f"expected (B, F, {cfg.in_channels}, {cfg.sample_size}, "
                             f"{cfg.sample_size}), got {tuple(x.shape)}")
        Fv = Fr - use_image_num
        N = (H // p) * (W // p)
        joint = bool(use_image_num) and train

        hid = self.pos_embed(x.reshape(B * Fr, C, H, W), dt) + self.pos_table.to(dt)
        t_emb = self.adaln_single.emb.timestep_embedder(t, dt)  # (B, D)
        t6 = dense(F.silu(t_emb), self.adaln_single.linear, dt)  # (B, 6D)

        ctx = ctx_bias = None
        if cfg.caption_channels is not None and encoder_hidden_states is not None:
            emb = self.caption_projection(encoder_hidden_states, dt)
            if joint:  # (B, 1 + img, L, D): the video's caption for each of its frames
                emb = torch.cat([emb[:, :1].expand(B, Fv, -1, -1), emb[:, 1:]], 1)
                ctx = emb.reshape(B * Fr, emb.shape[-2], D)
            else:
                ctx = emb.repeat_interleave(Fr, 0)
        if encoder_attention_mask is not None:
            bias = (1 - encoder_attention_mask.float()) * MASK_BIAS
            if bias.ndim == 2:  # (B, L) -> (B * F, 1, L)
                ctx_bias = bias[:, None].repeat_interleave(Fr, 0)
            else:  # (B, 1 + img, L): the video's mask for each of its frames
                bias = torch.cat([bias[:, :1].expand(B, Fv, -1), bias[:, 1:]], 1)
                ctx_bias = bias.reshape(B * Fr, 1, -1)

        t_spatial = t6.repeat_interleave(Fr, 0)
        t_temp = t6.repeat_interleave(N, 0)
        for i in range(cfg.num_layers):
            hid = self.transformer_blocks[i](hid, t_spatial, dt, ctx=ctx, ctx_bias=ctx_bias)
            if not enable_temporal_attentions:
                continue
            ht = hid.reshape(B, Fr, N, D).transpose(1, 2).reshape(B * N, Fr, D)
            temporal = self.temporal_transformer_blocks[i]
            if joint:  # the images bypass the temporal block; no temporal table
                ht = torch.cat([temporal(ht[:, :Fv], t_temp, dt), ht[:, Fv:]], 1)
            else:
                if i == 0:
                    ht = ht + self.temp_table[:Fr].to(dt)
                ht = temporal(ht, t_temp, dt)
            hid = ht.reshape(B, N, Fr, D).transpose(1, 2).reshape(B * Fr, N, D)

        mod = self.scale_shift_table[None].to(dt) + t_emb.repeat_interleave(Fr, 0)[:, None]
        shift, scale = mod[:, 0][:, None], mod[:, 1][:, None]
        hid = _layer_norm(self.norm_out, hid, dt) * (1 + scale) + shift
        hid = dense(hid, self.proj_out, dt)
        out_c, h_, w_ = cfg.out_ch, H // p, W // p
        hid = hid.reshape(B, Fr, h_, w_, p, p, out_c).permute(0, 1, 6, 2, 4, 3, 5)
        return hid.reshape(B, Fr, out_c, H, W)


@torch.no_grad()
def init_weights(model: LatteT2V, generator: torch.Generator) -> LatteT2V:
    """The JAX package's init, drawn from `generator` on its device:
    LeCun-normal Linear weights and zero biases, a Xavier-uniform patch
    embedding, N(0, 0.02) timestep MLP, scale_shift_tables N(0, 1/D)."""
    dev = generator.device

    def normal_(w: torch.Tensor, std: float) -> None:
        w.copy_(torch.randn(w.shape, generator=generator, device=dev) * std)

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            normal_(mod.weight, mod.in_features ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, T2VBlock):
            normal_(mod.scale_shift_table, model.cfg.inner_dim ** -0.5)
    w = model.pos_embed.proj.weight
    bound = math.sqrt(6.0 / (w[0].numel() + w.shape[0]))
    w.copy_((torch.rand(w.shape, generator=generator, device=dev) * 2 - 1) * bound)
    model.pos_embed.proj.bias.zero_()
    for lin in (model.adaln_single.emb.timestep_embedder.linear_1,
                model.adaln_single.emb.timestep_embedder.linear_2):
        normal_(lin.weight, 0.02)
    normal_(model.scale_shift_table, model.cfg.inner_dim ** -0.5)
    return model
