"""Latent-diffusion adapter, the seam DiT and Latte consume (mirror of
`omnitokenizer_tpu.models.diffusion_adapter`): a VAE-mode tokenizer in
place of the SD-VAE,

    latents = vae.encode(x, is_image=...) * 0.18215       # 8 channels
    pixels  = vae.decode(latents / 0.18215, is_image=...)

with image latents (8, 32, 32) and video latents (8, 1 + (T-1)/4, 32, 32)
for the released config.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..config import TokenizerConfig
from .wrapper import OmniTokenizerVQGAN

SD_LATENT_SCALE = 0.18215


class DiffusionVAEAdapter:
    """Wraps a VAE-mode OmniTokenizerVQGAN, from a checkpoint
    (`load_from_checkpoint`), from `from_config` or from JAX weights through
    convert.py."""

    def __init__(self, vae: OmniTokenizerVQGAN, scale: float = SD_LATENT_SCALE):
        if not vae.cfg.use_vae:
            raise ValueError("the diffusion adapter needs a VAE-mode tokenizer (use_vae=True)")
        self.vae = vae
        self.scale = scale

    @classmethod
    def from_config(cls, cfg: TokenizerConfig, seed: int = 0, device: Any = "cuda",
                    scale: float = SD_LATENT_SCALE) -> "DiffusionVAEAdapter":
        """Random weights made from `seed`, on the card unless the caller
        asks for the CPU."""
        return cls(OmniTokenizerVQGAN.from_config(cfg, seed=seed, device=device), scale)

    @classmethod
    def load_from_checkpoint(cls, ckpt_path: str, device: Any = "cuda",
                             scale: float = SD_LATENT_SCALE) -> "DiffusionVAEAdapter":
        """A VAE-mode tokenizer checkpoint (OmniTokenizerVQGAN.load_from_checkpoint),
        on the card unless the caller asks for the CPU."""
        return cls(OmniTokenizerVQGAN.load_from_checkpoint(ckpt_path, device=device), scale)

    # -- the DiT/Latte-facing contract ---------------------------------
    def encode(self, x, is_image: bool, seed: int = 0) -> torch.Tensor:
        """pixels (channels-first) -> scaled latents (B, c, h, w) or
        (B, c, t, h, w)."""
        return self.vae.encode(x, is_image=is_image, seed=seed) * self.scale

    def decode(self, z, is_image: bool) -> torch.Tensor:
        """Scaled latents in the layout encode gives -> channels-first
        pixels. A video's (B, c, t, h, w) becomes the channels-last (B, t, h,
        w, c) that the wrapper's video decode takes (Latte's rearrange)."""
        z = torch.as_tensor(z, device=self.vae.device) / self.scale
        if not is_image and z.ndim == 5:
            z = z.permute(0, 2, 3, 4, 1)
        return self.vae.decode(z, is_image=is_image)

    @property
    def latent_channels(self) -> int:
        return self.vae.cfg.codebook_dim

    def latent_shape(self, is_image: bool) -> Tuple[int, ...]:
        cfg = self.vae.cfg
        if is_image:
            return (cfg.codebook_dim, cfg.latent_hw, cfg.latent_hw)
        return (cfg.codebook_dim, cfg.latent_t, cfg.latent_hw, cfg.latent_hw)
