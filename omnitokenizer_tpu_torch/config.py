"""Typed configuration of the tokenizer, mirroring `omnitokenizer_tpu.config`.

Field names and defaults are the JAX package's (a test holds the two
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
from typing import Optional

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


def imagenet_k600_config(use_vae: bool = False) -> TokenizerConfig:
    """The released ImageNet+K600 tokenizer (patch 8, temporal patch 4)."""
    return TokenizerConfig(use_vae=use_vae)


def imagenet_only_config() -> TokenizerConfig:
    """The stage-1 tokenizer: temporal patch 2, 'rel' spatial positions."""
    return TokenizerConfig(temporal_patch_size=2, spatial_pos="rel")
