"""OmniTokenizer spatial-temporal transformer VQGAN/VAE (mirror of
`omnitokenizer_tpu.models.tokenizer`, linear patch embed).

Everything inside is channels-last (B, T, H, W, C); the channels-first
layout exists only at the wrapper (models/wrapper.py). The first frame is
patch-embedded on its own at temporal stride 1. The encoder runs the
spatial stack over (b t) (h w) d, then the temporal stack over (b h w) t d;
the decoder mirrors it. PEG sees the original (B, T, H, W) video shape in
both passes (see ops/peg.py).

Not ported yet (ROADMAP.md): the cnn patch embed, the deferred pools. The
TPU-only `fast_patchify` fold and `flat_temporal` layout are left
out on purpose: the plain forms here compute the same function.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from ..config import TokenizerConfig
from ..ops.attention import Attention, FeedForward, l2norm
from ..ops.codebook import Codebook
from ..ops.gaussian import DiagonalGaussian
from ..ops.norms import LayerNorm
from ..ops.peg import PEG
from ..ops.transformer import Transformer
from ..ops.window import WindowAttention


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense semantics: input, weight and bias cast to `dtype`."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _check_supported(cfg: TokenizerConfig) -> None:
    unsupported = {
        "patch_embed": cfg.patch_embed != "linear",
        "defer_temporal_pool": cfg.defer_temporal_pool,
        "defer_spatial_pool": cfg.defer_spatial_pool,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet (see ROADMAP.md): {bad}")


def _transformer(cfg: TokenizerConfig, block: str, causal: bool, spatial: bool) -> Transformer:
    """A spatial stack takes cfg.spatial_pos; a temporal one 'rel', which a
    temporal call never reads, as in the JAX package."""
    return Transformer(
        dim=cfg.embedding_dim, depth=len(block), block=block, causal=causal,
        dim_head=cfg.dim_head, heads=cfg.heads, ff_mult=cfg.ff_mult, peg=True,
        peg_causal=cfg.causal_in_peg, window_size=cfg.twod_window_size,
        spatial_pos=cfg.spatial_pos if spatial else "rel",
        attn_bias_mode=cfg.attn_bias_mode, dtype=cfg.dtype, spatial=spatial)


class Encoder(nn.Module):
    """Linear patch embed, then the spatial and temporal stacks."""

    def __init__(self, cfg: TokenizerConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        C, p, pt, E = cfg.image_channels, cfg.patch_size, cfg.temporal_patch_size, cfg.embedding_dim
        self.to_patch_emb_first_frame_norm1 = LayerNorm(C * p * p)
        self.to_patch_emb_first_frame_proj = nn.Linear(C * p * p, E)
        self.to_patch_emb_first_frame_norm2 = LayerNorm(E, dtype=cfg.dtype)
        self.to_patch_emb_norm1 = LayerNorm(C * pt * p * p)
        self.to_patch_emb_proj = nn.Linear(C * pt * p * p, E)
        self.to_patch_emb_norm2 = LayerNorm(E, dtype=cfg.dtype)
        self.enc_spatial_transformer = _transformer(cfg, cfg.enc_block, False, True)
        self.enc_temporal_transformer = _transformer(
            cfg, "t" * cfg.temporal_depth, cfg.causal_in_temporal_transformer, False)

    def forward(self, video: torch.Tensor, is_image: bool, training: bool = False) -> torch.Tensor:
        cfg = self.cfg
        p, pt = cfg.patch_size, cfg.temporal_patch_size
        T = video.shape[1]
        if (T - 1) % pt:
            raise ValueError(
                f"frames-1 ({T - 1}) must be divisible by temporal patch size ({pt})")
        video = video.to(cfg.dtype)
        first, rest = video[:, :1], video[:, 1:]

        ff = rearrange(first, "b t (h p1) (w p2) c -> b t h w (c p1 p2)", p1=p, p2=p)
        ff = dense(self.to_patch_emb_first_frame_norm1(ff), self.to_patch_emb_first_frame_proj,
                   cfg.dtype)
        tokens = self.to_patch_emb_first_frame_norm2(ff)
        if rest.shape[1] > 0:
            rf = rearrange(rest, "b (t pt) (h p1) (w p2) c -> b t h w (c pt p1 p2)",
                           pt=pt, p1=p, p2=p)
            rf = dense(self.to_patch_emb_norm1(rf), self.to_patch_emb_proj, cfg.dtype)
            tokens = torch.cat([tokens, self.to_patch_emb_norm2(rf)], dim=1)

        b, t, h, w, d = tokens.shape
        video_shape = (b, t, h, w)
        x = self.enc_spatial_transformer(tokens.reshape(b * t, h * w, d), video_shape,
                                         is_spatial=True, training=training)
        x = rearrange(x.reshape(b, t, h, w, d), "b t h w d -> (b h w) t d")
        x = self.enc_temporal_transformer(x, video_shape, is_spatial=False, training=training)
        return rearrange(x, "(b h w) t d -> b t h w d", b=b, h=h, w=w)


class Decoder(nn.Module):
    """Temporal then spatial stack, then the linear to-pixels projection."""

    def __init__(self, cfg: TokenizerConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        C, pt, E = cfg.image_channels, cfg.temporal_patch_size, cfg.embedding_dim
        p = cfg.patch_size * (cfg.gen_upscale or 1)
        self.dec_temporal_transformer = _transformer(
            cfg, "t" * cfg.temporal_depth, cfg.causal_in_temporal_transformer, False)
        self.dec_spatial_transformer = _transformer(cfg, cfg.dec_block, False, True)
        self.to_pixels_first_frame = nn.Linear(E, C * p * p)
        self.to_pixels = nn.Linear(E, C * pt * p * p)

    def forward(self, tokens: torch.Tensor, is_image: bool, training: bool = False) -> torch.Tensor:
        cfg = self.cfg
        p = cfg.patch_size * (cfg.gen_upscale or 1)
        pt = cfg.temporal_patch_size
        b, t, h, w, _ = tokens.shape
        video_shape = (b, t, h, w)

        x = rearrange(tokens, "b t h w d -> (b h w) t d")
        x = self.dec_temporal_transformer(x, video_shape, is_spatial=False, training=training)
        x = rearrange(x, "(b h w) t d -> (b t) (h w) d", b=b, h=h, w=w)
        x = self.dec_spatial_transformer(x, video_shape, is_spatial=True, training=training)
        x = rearrange(x, "(b t) (h w) d -> b t h w d", b=b, h=h, w=w)

        ff = dense(x[:, :1], self.to_pixels_first_frame, cfg.dtype)
        recon = rearrange(ff, "b t h w (c p1 p2) -> b t (h p1) (w p2) c", p1=p, p2=p)
        if t > 1:
            rf = dense(x[:, 1:], self.to_pixels, cfg.dtype)
            rf = rearrange(rf, "b t h w (c pt p1 p2) -> b (t pt) (h p1) (w p2) c",
                           pt=pt, p1=p, p2=p)
            recon = torch.cat([recon, rf], dim=1)
        return recon  # (B, T, H, W, C)


class OmniTokenizerNet(nn.Module):
    """encoder -> pre-VQ -> codebook | Gaussian posterior -> post-VQ ->
    decoder, channels-last. VAE mode builds no codebook: the JAX VAE tree
    has none."""

    def __init__(self, cfg: TokenizerConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        out_dim = cfg.codebook_dim * (2 if cfg.use_vae else 1)
        self.pre_vq_conv = nn.Linear(cfg.embedding_dim, out_dim)
        self.post_vq_conv = nn.Linear(cfg.codebook_dim, cfg.embedding_dim)
        self.codebook = None if cfg.use_vae else Codebook(cfg.n_codes, cfg.codebook_dim)

    @property
    def vq_dtype(self) -> torch.dtype:
        # fp32_quant keeps the pre-VQ projection f32 on the bf16 path
        return torch.float32 if self.cfg.fp32_quant else self.cfg.dtype

    def prepare_kernels(self) -> None:
        """Build every fused kernel's weights from the current parameters."""
        for m in self.modules():
            if isinstance(m, (Attention, FeedForward)):
                m.prepare_kernels()

    # -- pieces ---------------------------------------------------------
    def encode_latent(self, x: torch.Tensor, is_image: bool,
                      training: bool = False) -> torch.Tensor:
        """pixels (B, T, H, W, C) -> pre-quant latents (B, t, h, w, code_dim[*2])."""
        h = self.encoder(x, is_image, training=training)
        return dense(h, self.pre_vq_conv, self.vq_dtype)

    def quantize(self, h: torch.Tensor, training: bool = False) -> Dict[str, torch.Tensor]:
        if self.cfg.l2_code:
            h = l2norm(h)
        return self.codebook(h, training=training)

    def decode_latent(self, z: torch.Tensor, is_image: bool,
                      training: bool = False) -> torch.Tensor:
        """post-quant latents (B, t, h, w, code_dim) -> pixels (B, T, H, W, C)."""
        z = dense(z, self.post_vq_conv, self.cfg.dtype)
        return self.decoder(z, is_image, training=training)

    # -- public-contract methods -----------------------------------------
    def encode(self, x: torch.Tensor, is_image: bool, include_embeddings: bool = False,
               generator: Optional[torch.Generator] = None):
        """VQ: token indices (B, t, h, w) [+ straight-through embeddings].
        VAE: latents (B, t, h, w, code_dim), a sample of the posterior when
        given a generator, else its mode."""
        h = self.encode_latent(x, is_image)
        if self.cfg.use_vae:
            posterior = DiagonalGaussian.from_params(h)
            return posterior.mode() if generator is None else posterior.sample(generator)
        vq = self.quantize(h)
        if include_embeddings:
            return vq["embeddings"], vq["encodings"]
        return vq["encodings"]

    def decode(self, encodings: torch.Tensor, is_image: bool) -> torch.Tensor:
        """VQ indices, flat (B, N) or grid (B, t, h, w), or VAE latents,
        (B, t, h, w, c), flat (B, N, c) or an image's (B, h, w, c) -> pixels."""
        if self.cfg.use_vae:  # (B, h, w, c) is an image latent without its time axis
            z = encodings[:, None] if encodings.ndim == 4 else encodings
        else:
            z = self.codebook.lookup(encodings)
        if z.ndim == 3:  # flat (B, N, c)
            n = z.shape[1]
            hh = math.isqrt(n) if is_image else self.cfg.resolution // self.cfg.patch_size
            z = z.reshape(z.shape[0], n // (hh * hh), hh, hh, z.shape[-1])
        return self.decode_latent(z, is_image)

    def forward(self, x: torch.Tensor, is_image: bool, training: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full autoencode pass; returns (x_recon, aux dict). VAE mode
        decodes a sample when given a generator, else the mode, and returns
        dict(commitment_loss, kl_loss, posterior), both losses
        sum(kl) / B * kl_weight."""
        h = self.encode_latent(x, is_image, training=training)
        if self.cfg.use_vae:
            posterior = DiagonalGaussian.from_params(h)
            z = posterior.mode() if generator is None else posterior.sample(generator)
            recon = self.decode_latent(z, is_image, training=training)
            kl = posterior.kl()
            kl_loss = kl.sum() / kl.shape[0] * self.cfg.kl_weight
            return recon, dict(commitment_loss=kl_loss, kl_loss=kl_loss, posterior=posterior)
        vq = self.quantize(h, training=training)
        return self.decode_latent(vq["embeddings"], is_image, training=training), vq


@torch.no_grad()
def init_weights(net: OmniTokenizerNet, generator: torch.Generator) -> None:
    """Random weights from `generator`, shaped like the JAX init: LeCun-normal
    dense and PEG kernels, zero biases, unit norms and scales, N(0, 0.02)
    window bias tables and an N(0, 1) codebook."""
    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in net.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, m.in_features ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, PEG):
            normal_(m.dsconv.weight, 27 ** -0.5)
            m.dsconv.bias.zero_()
        elif isinstance(m, WindowAttention):
            normal_(m.relative_position_bias_table, 0.02)
        elif isinstance(m, Codebook):
            normal_(m.embeddings, 1.0)
            m.z_avg.copy_(m.embeddings)
