"""OmniTokenizer spatial-temporal transformer VQGAN/VAE (mirror of
`omnitokenizer_tpu.models.tokenizer`).

Everything inside is channels-last (B, T, H, W, C); the channels-first
layout exists only at the wrapper (models/wrapper.py). The first frame is
patch-embedded on its own at temporal stride 1. The encoder runs the
spatial stack over (b t) (h w) d, then the temporal stack over (b h w) t d;
the decoder mirrors it. PEG sees the original (B, T, H, W) video shape in
both passes (see ops/peg.py).

Patch embeds: 'linear' (LayerNorm, Linear, LayerNorm over each patch) or
'cnn' (the reference's stride-equal-to-kernel Conv3d and its norm, run as
one matmul over the patches; the to-pixels ConvTranspose3d as a per-token
Linear and depth-to-space). The cnn norm is inference only: BatchNorm
reads its running statistics (the trainer refuses a cnn model). The
deferred pools (linear only, as in the JAX package) embed at half the
patch sizes and pool after the temporal stack: 2 x 2 average in space,
the mean of frame pairs after the first frame in time; the decoder
repeats both back before its stacks.

The decoder takes its grid from the tokens, and its spatial stack's 'n'/'r'
blocks grow it: the JAX decoder rearranges at a grid shrunk by its up
blocks, which no token count fits (an einops error), so a dec_block with
'n' or 'r' runs in the port only.

The TPU-only `fast_patchify` fold and `flat_temporal` layout are left out
on purpose: the plain forms here compute the same function.

Sequence parallelism (`sp=`, a `parallel.tp.SeqParallel`): the pixels and
the reconstruction are a rank's equal block of rows (`tp.sp_shard_pixels`);
inside, a rank computes the rows of `tp.row_partition`, which keeps every
patch and pool cell on one rank: the encoder first moves its pixel rows to
the partition's, the decoder its reconstruction back (`mesh.rows_of`; no
move where the blocks are whole patches and pool cells). Latents and
encodings (flat ones too: the rank's rows' tokens in (t, h, w) order) are
the rank's rows of the latent grid's even split (`tp.even_spans`; the grid
is square, as every frame the JAX package takes, so its columns give its
rows). The stacks say their collectives (parallel/tp.py). The patch embeds
and to-pixels are per patch, the deferred pools and repeats per 2 x 2 cell
or frame pair, so they run on a rank's rows; the cnn GroupNorm sums its
statistics and counts over the group, as the JAX package forms them over
whole frames.
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
from ..parallel import mesh, tp
from ..ops.gaussian import DiagonalGaussian
from ..ops.norms import LayerNorm
from ..ops.peg import PEG
from ..ops.transformer import Transformer, grid_after
from ..ops.window import WindowAttention
from .discriminator import GroupNorm, Normalize

PATCH_EMBEDS = ("linear", "cnn")


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense semantics: input, weight and bias cast to `dtype`."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def patch_sizes(cfg: TokenizerConfig, decoder: bool = False) -> Tuple[int, int]:
    """(spatial, temporal) patch size of the embed (or the to-pixels with
    its gen_upscale); the deferred pools halve them for the linear embed."""
    if cfg.patch_embed not in PATCH_EMBEDS:
        raise ValueError(f"patch_embed {cfg.patch_embed!r}: one of {PATCH_EMBEDS}")
    p = cfg.patch_size * ((cfg.gen_upscale or 1) if decoder else 1)
    pt = cfg.temporal_patch_size
    if cfg.patch_embed == "linear":
        pt = pt // 2 if cfg.defer_temporal_pool else pt
        p = p // 2 if cfg.defer_spatial_pool else p
    return p, pt


def _deferred(cfg: TokenizerConfig) -> Tuple[bool, bool]:
    """(temporal, spatial) deferred pools, which apply to the linear embed."""
    linear = cfg.patch_embed == "linear"
    return linear and cfg.defer_temporal_pool, linear and cfg.defer_spatial_pool


def _moved(x: torch.Tensor, sp, want: tp.Spans, have: tp.Spans) -> torch.Tensor:
    """x (B, T, rows, ...) from this rank's rows of `have` to those of
    `want` (itself where they agree)."""
    return x if want == have else mesh.rows_of(x, 2, want, sp.group, have)


def latent_spans(z: torch.Tensor, sp) -> tp.Spans:
    """The ranks' rows of the latent grid of z (B, t, rows, cols, ...):
    its even split. The grid is square, so its columns count its rows."""
    return tp.even_spans(z.shape[3], sp.size)


def _transformer(cfg: TokenizerConfig, block: str, causal: bool, spatial: bool) -> Transformer:
    """A spatial stack takes cfg.spatial_pos; a temporal one 'rel', which a
    temporal call never reads, as in the JAX package."""
    return Transformer(
        dim=cfg.embedding_dim, depth=len(block), block=block, causal=causal,
        dim_head=cfg.dim_head, heads=cfg.heads, ff_mult=cfg.ff_mult, peg=True,
        peg_causal=cfg.causal_in_peg, window_size=cfg.twod_window_size,
        spatial_pos=cfg.spatial_pos if spatial else "rel",
        attn_bias_mode=cfg.attn_bias_mode, dtype=cfg.dtype, spatial=spatial)


class CnnNormalize(Normalize):
    """GroupNorm(32, eps 1e-6) or BatchNorm (eps 1e-5, its running
    statistics) over the channels of a channels-last tensor, in f32. Under
    `sp` GroupNorm's statistics are those of every rank's rows. GroupNorm
    refuses channels that its groups do not divide, as flax's does (the
    to-pixels norm over 3 channels)."""

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        kw = {}
        if isinstance(self.norm, GroupNorm):
            kw["group"] = None if sp is None else sp.group
        return self.norm(x.movedim(-1, 1), train=False, **kw).movedim(1, -1)


class PatchConv(nn.Module):
    """The cnn patch embed's Conv3d, kernel equal to its stride (kt, p, p),
    as one Linear over the flattened (C, kt, p, p) patches: no conv library
    call, so an f32 embed does not round to TF32. `weight` keeps the torch
    Conv3d layout (E, C, kt, p, p)."""

    def __init__(self, channels: int, dim: int, kt: int, p: int):
        super().__init__()
        self.kt, self.p = kt, p
        self.weight = nn.Parameter(torch.zeros(dim, channels, kt, p, p))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, T/kt, H/p, W/p, E)."""
        x = rearrange(x, "b (t pt) (h p1) (w p2) c -> b t h w (c pt p1 p2)",
                      pt=self.kt, p1=self.p, p2=self.p)
        w = self.weight.reshape(self.weight.shape[0], -1)
        return F.linear(x.to(dtype), w.to(dtype), self.bias.to(dtype))


class PatchUnconv(nn.Module):
    """The cnn to-pixels ConvTranspose3d, kernel equal to its stride, as a
    per-token Linear to (C, kt, p, p), depth-to-space, then the bias.
    `weight` keeps the torch ConvTranspose3d layout (E, C, kt, p, p)."""

    def __init__(self, dim: int, channels: int, kt: int, p: int):
        super().__init__()
        self.kt, self.p = kt, p
        self.weight = nn.Parameter(torch.zeros(dim, channels, kt, p, p))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, t, h, w, E) -> (B, t*kt, h*p, w*p, C)."""
        w = self.weight.reshape(self.weight.shape[0], -1).t()
        y = F.linear(x.to(dtype), w.to(dtype))
        y = rearrange(y, "b t h w (c i j l) -> b (t i) (h j) (w l) c",
                      i=self.kt, j=self.p, l=self.p)
        return y + self.bias.to(dtype)


class Encoder(nn.Module):
    """The patch embed, then the spatial and temporal stacks, then the
    deferred pools."""

    def __init__(self, cfg: TokenizerConfig):
        super().__init__()
        self.cfg = cfg
        C, E = cfg.image_channels, cfg.embedding_dim
        p, pt = patch_sizes(cfg)
        if cfg.patch_embed == "linear":
            self.to_patch_emb_first_frame_norm1 = LayerNorm(C * p * p)
            self.to_patch_emb_first_frame_proj = nn.Linear(C * p * p, E)
            self.to_patch_emb_first_frame_norm2 = LayerNorm(E, dtype=cfg.dtype)
            self.to_patch_emb_norm1 = LayerNorm(C * pt * p * p)
            self.to_patch_emb_proj = nn.Linear(C * pt * p * p, E)
            self.to_patch_emb_norm2 = LayerNorm(E, dtype=cfg.dtype)
        else:
            self.to_patch_emb_first_frame_conv = PatchConv(C, E, 1, p)
            self.to_patch_emb_first_frame_cnorm = CnnNormalize(E, cfg.norm_type)
            self.to_patch_emb_conv = PatchConv(C, E, pt, p)
            self.to_patch_emb_cnorm = CnnNormalize(E, cfg.norm_type)
        self.enc_spatial_transformer = _transformer(cfg, cfg.enc_block, False, True)
        self.enc_temporal_transformer = _transformer(
            cfg, "t" * cfg.temporal_depth, cfg.causal_in_temporal_transformer, False)

    def _embed(self, frames: torch.Tensor, first: bool, sp=None) -> torch.Tensor:
        cfg = self.cfg
        name = "to_patch_emb_first_frame" if first else "to_patch_emb"
        if cfg.patch_embed == "cnn":
            conv = getattr(self, f"{name}_conv")
            return getattr(self, f"{name}_cnorm")(conv(frames, cfg.dtype), sp)
        p, pt = patch_sizes(cfg)
        f = rearrange(frames, "b (t pt) (h p1) (w p2) c -> b t h w (c pt p1 p2)",
                      pt=1 if first else pt, p1=p, p2=p)
        f = dense(getattr(self, f"{name}_norm1")(f), getattr(self, f"{name}_proj"), cfg.dtype)
        return getattr(self, f"{name}_norm2")(f)

    def forward(self, video: torch.Tensor, is_image: bool, training: bool = False,
                sp=None) -> torch.Tensor:
        """video (B, T, H, W, C), a rank's H rows under `sp`."""
        cfg = self.cfg
        _, pt = patch_sizes(cfg)
        T = video.shape[1]
        sp_tokens = sp_temporal = None
        if sp is not None:  # to the partition's pixel rows
            rows = video.shape[2]
            pixels, spans = tp.encoder_spans(cfg, rows * sp.size, sp.size)
            video = _moved(video, sp, pixels, tp.even_spans(rows * sp.size, sp.size))
            sp_tokens, sp_temporal = sp.at(spans[0]), sp.at(spans[len(cfg.enc_block)])
        if (T - 1) % pt:
            raise ValueError(
                f"frames-1 ({T - 1}) must be divisible by temporal patch size ({pt})")
        video = video.to(cfg.dtype)
        tokens = self._embed(video[:, :1], True, sp)
        if T > 1:
            tokens = torch.cat([tokens, self._embed(video[:, 1:], False, sp)], dim=1)

        b, t, h, w, d = tokens.shape
        x = self.enc_spatial_transformer(tokens.reshape(b * t, h * w, d), (b, t, h, w),
                                         is_spatial=True, training=training, sp=sp_tokens)
        nh, nw = grid_after(cfg.enc_block, h, w)
        x = rearrange(x.reshape(b, t, nh, nw, d), "b t h w d -> (b h w) t d")
        x = self.enc_temporal_transformer(x, (b, t, nh, nw), is_spatial=False, training=training,
                                          sp=sp_temporal)
        tokens = rearrange(x, "(b h w) t d -> b t h w d", b=b, h=nh, w=nw)

        defer_t, defer_s = _deferred(cfg)
        if defer_s:  # 2 x 2 average pool (flax avg_pool, VALID)
            hh, ww = nh // 2, nw // 2
            tokens = tokens[:, :, :2 * hh, :2 * ww].reshape(b, t, hh, 2, ww, 2, d).mean((3, 5))
        if t > 1 and defer_t:  # the mean of each pair of frames after the first
            rest = tokens[:, 1:]
            rest = rest.reshape(b, rest.shape[1] // 2, 2, *rest.shape[2:]).mean(2)
            tokens = torch.cat([tokens[:, :1], rest], dim=1)
        if sp is not None:  # to the latent grid's even split
            tokens = _moved(tokens, sp, latent_spans(tokens, sp), spans[-1])
        return tokens  # (B, t, h, w, d)


class Decoder(nn.Module):
    """The deferred pools' repeats, the temporal then spatial stack, then
    the to-pixels projection."""

    def __init__(self, cfg: TokenizerConfig):
        super().__init__()
        self.cfg = cfg
        C, E = cfg.image_channels, cfg.embedding_dim
        p, pt = patch_sizes(cfg, decoder=True)
        self.dec_temporal_transformer = _transformer(
            cfg, "t" * cfg.temporal_depth, cfg.causal_in_temporal_transformer, False)
        self.dec_spatial_transformer = _transformer(cfg, cfg.dec_block, False, True)
        if cfg.patch_embed == "linear":
            self.to_pixels_first_frame = nn.Linear(E, C * p * p)
            self.to_pixels = nn.Linear(E, C * pt * p * p)
        else:
            self.to_pixels_first_frame_conv = PatchUnconv(E, C, 1, p)
            self.to_pixels_first_frame_conv_cnorm = CnnNormalize(C, cfg.norm_type)
            self.to_pixels_conv = PatchUnconv(E, C, pt, p)
            self.to_pixels_conv_cnorm = CnnNormalize(C, cfg.norm_type)

    def _to_pixels(self, x: torch.Tensor, first: bool, sp=None) -> torch.Tensor:
        cfg = self.cfg
        if cfg.patch_embed == "cnn":
            name = "to_pixels_first_frame_conv" if first else "to_pixels_conv"
            return getattr(self, f"{name}_cnorm")(getattr(self, name)(x, cfg.dtype), sp)
        p, pt = patch_sizes(cfg, decoder=True)
        y = dense(x, self.to_pixels_first_frame if first else self.to_pixels, cfg.dtype)
        return rearrange(y, "b t h w (c pt p1 p2) -> b (t pt) (h p1) (w p2) c",
                         pt=1 if first else pt, p1=p, p2=p)

    def forward(self, tokens: torch.Tensor, is_image: bool, training: bool = False,
                sp=None) -> torch.Tensor:
        """tokens (B, t, h, w, d), a rank's h rows under `sp`."""
        cfg = self.cfg
        defer_t, defer_s = _deferred(cfg)
        if sp is not None:  # from the latent grid's even split to the partition's
            latent = latent_spans(tokens, sp)
            lo, hi = latent[sp.rank]
            if tokens.shape[2] != hi - lo:
                sp.refuse(f"a rank's {tokens.shape[2]} latent rows of a grid "
                          f"{tokens.shape[3]} columns wide", f"a square grid's even split "
                          f"gives rank {sp.rank} {hi - lo}")
            spans, recon_spans = tp.decoder_spans(cfg, latent[-1][1], sp.size)
            tokens = _moved(tokens, sp, spans[0], latent)
            sp = sp.at(spans[int(defer_s)])
        if tokens.shape[1] > 1 and defer_t:
            tokens = torch.cat([tokens[:, :1], tokens[:, 1:].repeat_interleave(2, 1)], dim=1)
        if defer_s:
            tokens = tokens.repeat_interleave(2, 2).repeat_interleave(2, 3)
        b, t, h, w, _ = tokens.shape
        video_shape = (b, t, h, w)

        x = rearrange(tokens, "b t h w d -> (b h w) t d")
        x = self.dec_temporal_transformer(x, video_shape, is_spatial=False, training=training,
                                          sp=sp)
        x = rearrange(x, "(b h w) t d -> (b t) (h w) d", b=b, h=h, w=w)
        x = self.dec_spatial_transformer(x, video_shape, is_spatial=True, training=training,
                                         sp=sp)
        h, w = grid_after(cfg.dec_block, h, w)
        x = rearrange(x, "(b t) (h w) d -> b t h w d", b=b, h=h, w=w)

        recon = self._to_pixels(x[:, :1], True, sp)
        if t > 1:
            recon = torch.cat([recon, self._to_pixels(x[:, 1:], False, sp)], dim=1)
        if sp is not None and recon_spans[-1][1] % sp.size == 0:  # back to equal blocks
            recon = _moved(recon, sp, tp.even_spans(recon_spans[-1][1], sp.size), recon_spans)
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
        self.codebook = None if cfg.use_vae else Codebook(
            cfg.n_codes, cfg.codebook_dim, no_random_restart=cfg.no_random_restart,
            restart_thres=cfg.restart_thres)

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
                      training: bool = False, sp=None) -> torch.Tensor:
        """pixels (B, T, H, W, C) -> pre-quant latents (B, t, h, w, code_dim[*2])."""
        h = self.encoder(x, is_image, training=training, sp=sp)
        return dense(h, self.pre_vq_conv, self.vq_dtype)

    def quantize(self, h: torch.Tensor, training: bool = False,
                 generator: Optional[torch.Generator] = None,
                 group=None, sp=None) -> Dict[str, torch.Tensor]:
        """training=True advances the codebook (its init and restart rows
        drawn from `generator`; over every rank's rows given a `group`,
        under `sp` data x model, the model group by default). Under `sp`
        an inference call's commitment loss and statistics are the model
        group's."""
        if self.cfg.l2_code:
            h = l2norm(h)
        return self.codebook(h, training=training, generator=generator, group=group,
                             sp_group=None if sp is None else sp.group)

    def decode_latent(self, z: torch.Tensor, is_image: bool,
                      training: bool = False, sp=None) -> torch.Tensor:
        """post-quant latents (B, t, h, w, code_dim) -> pixels (B, T, H, W, C)."""
        z = dense(z, self.post_vq_conv, self.cfg.dtype)
        return self.decoder(z, is_image, training=training, sp=sp)

    # -- public-contract methods -----------------------------------------
    def encode(self, x: torch.Tensor, is_image: bool, include_embeddings: bool = False,
               generator: Optional[torch.Generator] = None, sp=None):
        """VQ: token indices (B, t, h, w) [+ straight-through embeddings].
        VAE: latents (B, t, h, w, code_dim), a sample of the posterior when
        given a generator, else its mode. Under `sp`, a rank's rows."""
        h = self.encode_latent(x, is_image, sp=sp)
        if self.cfg.use_vae:
            posterior = DiagonalGaussian.from_params(h)
            if generator is None:
                return posterior.mode()
            return posterior.sample(generator, self._noise(posterior, generator, None, sp))
        vq = self.quantize(h, sp=sp)
        if include_embeddings:
            return vq["embeddings"], vq["encodings"]
        return vq["encodings"]

    def decode(self, encodings: torch.Tensor, is_image: bool, sp=None) -> torch.Tensor:
        """VQ indices, flat (B, N) or grid (B, t, h, w), or VAE latents,
        (B, t, h, w, c), flat (B, N, c) or an image's (B, h, w, c) -> pixels.
        Under `sp`, a rank's rows: its rows of the grid forms, or its rows'
        tokens in (t, h, w) order of the flat ones."""
        if self.cfg.use_vae:  # (B, h, w, c) is an image latent without its time axis
            z = encodings[:, None] if encodings.ndim == 4 else encodings
        else:
            z = self.codebook.lookup(encodings)
        if z.ndim == 3:  # flat (B, N, c)
            n = z.shape[1]
            if sp is not None:  # every rank's tokens
                n = sum(mesh.counts_of(n, sp.group, z.device))
            hh = math.isqrt(n) if is_image else self.cfg.resolution // self.cfg.patch_size
            lo, hi = (0, hh) if sp is None else tp.even_spans(hh, sp.size)[sp.rank]
            z = z.reshape(z.shape[0], n // (hh * hh), hi - lo, hh, z.shape[-1])
        return self.decode_latent(z, is_image, sp=sp)

    @staticmethod
    def _noise(posterior, generator, group, sp) -> Optional[torch.Tensor]:
        """This rank's rows of one N(0, 1) draw for the whole batch (over
        `group`) and the whole grid (over `sp`'s rows), or None for a
        draw of the local shape alone."""
        if group is None and sp is None:
            return None
        shape = posterior.mean.shape
        if sp is not None:
            spans = latent_spans(posterior.mean, sp)
            shape = shape[:2] + (spans[-1][1],) + shape[3:]
        noise = mesh.draw_rows(lambda s: torch.randn(s, generator=generator,
                                                     device=posterior.mean.device), shape, group)
        if sp is not None:
            lo, hi = spans[sp.rank]
            noise = noise.narrow(2, lo, hi - lo)
        return noise

    def forward(self, x: torch.Tensor, is_image: bool, training: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, group=None, sp=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full autoencode pass; returns (x_recon, aux dict). VAE mode
        decodes a sample when given the N(0, 1) `noise` (the latents' shape)
        or a generator to draw it from, else the mode, and returns
        dict(commitment_loss, kl_loss, posterior), both losses
        sum(kl) / B * kl_weight. VQ mode with training=True advances the
        codebook, drawing its random rows from `generator`. Given a process
        group (data parallelism), the codebook's statistics are the group's
        and a posterior draw is this rank's rows of one draw for the group.
        Under `sp` (sequence parallelism) x is this rank's pixel rows, and
        so are the reconstruction, encodings, posterior and `noise`; the
        losses are the whole grid's (parallel/tp.py)."""
        h = self.encode_latent(x, is_image, training=training, sp=sp)
        if self.cfg.use_vae:
            posterior = DiagonalGaussian.from_params(h)
            if noise is None and generator is not None:
                noise = self._noise(posterior, generator, group, sp)
            z = (posterior.mode() if generator is None and noise is None
                 else posterior.sample(generator, noise))
            recon = self.decode_latent(z, is_image, training=training, sp=sp)
            kl = posterior.kl()
            kl_sum = mesh.sum_over(kl.sum(), None if sp is None else sp.group)
            kl_loss = kl_sum / kl.shape[0] * self.cfg.kl_weight
            return recon, dict(commitment_loss=kl_loss, kl_loss=kl_loss, posterior=posterior)
        vq = self.quantize(h, training=training, generator=generator, group=group, sp=sp)
        return self.decode_latent(vq["embeddings"], is_image, training=training, sp=sp), vq


@torch.no_grad()
def init_weights(net: OmniTokenizerNet, generator: torch.Generator) -> None:
    """Random weights from `generator`, shaped like the JAX init: LeCun-normal
    dense, PEG and cnn patch kernels, zero biases, unit norms and scales,
    N(0, 0.02) window bias tables, an N(0, 1) codebook, and BatchNorm's
    running statistics at mean 0, variance 1."""
    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in net.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, m.in_features ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (PatchConv, PatchUnconv)):  # fan-in C kt p p, or E
            fan_in = m.weight[0].numel() if isinstance(m, PatchConv) else m.weight.shape[0]
            normal_(m.weight, fan_in ** -0.5)
            m.bias.zero_()
        elif isinstance(m, PEG):
            normal_(m.dsconv.weight, 27 ** -0.5)
            m.dsconv.bias.zero_()
        elif isinstance(m, WindowAttention):
            normal_(m.relative_position_bias_table, 0.02)
        elif isinstance(m, Codebook):
            normal_(m.embeddings, 1.0)
            m.z_avg.copy_(m.embeddings)
