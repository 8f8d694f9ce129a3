"""Typed configuration of the tokenizer and its GAN trainer, mirroring
`omnitokenizer_tpu.config`.

Field names and defaults are the JAX package's (tests hold the
dataclasses together); only `dtype` is a `torch.dtype` here.
`fast_patchify` and `flat_temporal` are kept so the mirror stays exact, but
the port ignores them: both are TPU layout workarounds, and the port always
runs the plain rearrange -> LayerNorm -> Linear patchify and keeps the
temporal stack as a contiguous (b h w, t, d) tensor, which is the same
memory as the token-flat rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import torch


@dataclass(frozen=True)
class TokenizerConfig:
    """Architecture + loss configuration of the OmniTokenizer VQGAN/VAE."""

    # core dims
    embedding_dim: int = 512
    n_codes: int = 8192
    codebook_dim: int = 8
    resolution: int = 256
    sequence_length: int = 17
    image_channels: int = 3

    # patchification
    patch_embed: str = "linear"  # 'linear' | 'cnn'
    patch_size: int = 8
    temporal_patch_size: int = 4
    defer_temporal_pool: bool = False
    defer_spatial_pool: bool = False

    # transformer stack
    enc_block: str = "ttww"
    dec_block: str = "tttt"
    spatial_depth: int = 4
    temporal_depth: int = 4
    twod_window_size: int = 8
    spatial_pos: str = "rope"  # 'rel' | 'rope'
    causal_in_temporal_transformer: bool = True
    causal_in_peg: bool = True
    dim_head: int = 64
    heads: int = 8
    ff_mult: float = 4.0
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    norm_type: str = "batch"
    gen_upscale: Optional[int] = None
    initialize_vit: bool = False

    # quantizer
    use_vae: bool = False
    l2_code: bool = True
    use_external_codebook: bool = False
    no_random_restart: bool = True
    restart_thres: float = 1.0
    commitment_weight: float = 1.0
    kl_weight: float = 1e-6
    # pre-VQ projection and codebook distances stay f32 on the bf16 path so
    # the indices do not depend on bf16 rounding
    fp32_quant: bool = True

    # 'sdpa' drops the rel-bias / AliBi terms as the reference's SDPA path
    # does; 'einsum' is not ported (ROADMAP)
    attn_bias_mode: str = "sdpa"

    # compute dtype for the transformer stack (params are created f32)
    dtype: torch.dtype = torch.float32

    # TPU-only layout switches, kept for the mirror; no-ops in the port
    fast_patchify: bool = True
    flat_temporal: str = "auto"

    @property
    def latent_t(self) -> int:
        """Latent frames for a full-length clip: 1 + (T-1)/pt."""
        return 1 + (self.sequence_length - 1) // self.temporal_patch_size

    @property
    def latent_hw(self) -> int:
        return self.resolution // self.patch_size

    def replace(self, **kw) -> "TokenizerConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LossConfig:
    """GAN and reconstruction loss weights (the reference's stage-2 recipe)."""

    recon_loss_type: str = "l1"  # 'l1' | 'l2'
    l1_weight: float = 4.0
    perceptual_weight: float = 4.0
    video_perceptual_weight: float = 0.0
    image_gan_weight: float = 0.0
    video_gan_weight: float = 0.01
    gan_feat_weight: float = 4.0
    logitslaplace_weight: float = 0.0
    disc_loss_type: str = "hinge"  # 'hinge' | 'vanilla'
    disc_channels: int = 64
    disc_layers: int = 3
    discriminator_iter_start: int = 0
    sigmoid_in_disc: bool = False
    activation_in_disc: str = "leaky_relu"
    apply_blur: bool = False  # the reference's Blur2d(f=None) is the identity
    apply_noise: bool = True
    apply_diffaug: bool = False
    apply_allframes: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule and skip gates of the GAN trainer."""

    lr: float = 5e-5
    lr_min: float = 5e-5
    warmup_steps: int = 50_000
    warmup_lr_init: float = 0.0
    max_steps: int = 500_000
    dis_lr_multiplier: float = 0.1
    dis_minlr_multiplier: bool = True
    dis_warmup_steps: int = 500_000
    grad_accumulates: int = 1
    grad_clip_val: Optional[float] = 1.0
    grad_clip_val_disc: Optional[float] = 1.0
    disloss_check_thres: Optional[float] = 0.001
    perloss_check_thres: Optional[float] = None
    recloss_check_thres: Optional[float] = None
    resolution_scale: Optional[Sequence[float]] = None
    sample_ratio: Optional[Sequence[float]] = None
    force_alternation: bool = False
    batch_size: int = 8
    seed: int = 1234
    # zero the gradients of every {enc,dec}_{spatial,temporal}_transformer
    # parameter (the finetune stage)
    freeze_trans: bool = False
    # 2: the D pass re-encodes the batch with the updated generator and
    # advances the codebook EMA a second time, as the reference's
    # two-forward step does; 1: one codebook update a step
    ema_advances_per_step: int = 2


def imagenet_k600_config(use_vae: bool = False) -> TokenizerConfig:
    """The released ImageNet+K600 tokenizer (patch 8, temporal patch 4)."""
    return TokenizerConfig(use_vae=use_vae)


def imagenet_only_config() -> TokenizerConfig:
    """The stage-1 tokenizer: temporal patch 2, 'rel' spatial positions."""
    return TokenizerConfig(temporal_patch_size=2, spatial_pos="rel")
