"""User-facing tokenizer API (mirror of `omnitokenizer_tpu.models.wrapper`):

    vqgan = OmniTokenizerVQGAN.from_config(cfg, seed=0)   # on the card
    vqgan = OmniTokenizerVQGAN.load_from_checkpoint(ckpt)  # a released .ckpt, a .pt
                                                           # or a JAX .msgpack
    tokens = vqgan.encode(video, is_image=False)   # (B, C, T, H, W) in
    recons = vqgan.decode(tokens, is_image=False)  # (B, C, T, H, W) out

Tensors are channels-first at this boundary, (B, C, H, W) for images and
(B, C, T, H, W) for videos, and channels-last inside the model. A VAE-mode
model (cfg.use_vae) encodes to continuous latents instead of indices.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ..config import TokenizerConfig
from .tokenizer import OmniTokenizerNet, init_weights


def _to_channels_last(x: torch.Tensor, is_image: bool) -> torch.Tensor:
    if is_image:  # (B, C, H, W) -> (B, 1, H, W, C)
        return x.permute(0, 2, 3, 1)[:, None]
    return x.permute(0, 2, 3, 4, 1)  # (B, C, T, H, W) -> (B, T, H, W, C)


def _to_channels_first(x: torch.Tensor, is_image: bool) -> torch.Tensor:
    if is_image:  # (B, 1, H, W, C) -> (B, C, H, W)
        return x[:, 0].permute(0, 3, 1, 2)
    return x.permute(0, 4, 1, 2, 3)


def check_device(device: Any) -> None:
    """Raise for a CUDA device on a host without one (no silent CPU fallback)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")


class OmniTokenizerVQGAN:
    """Serving wrapper around OmniTokenizerNet (inference only). Weights come
    from a checkpoint (`load_from_checkpoint`) or from the JAX package
    through convert.state_dict_from_jax.

    VAE mode samples its latents with a `torch.Generator` seeded from the
    caller's `seed`: the same seed does not give the JAX package's noise."""

    def __init__(self, cfg: TokenizerConfig, net: OmniTokenizerNet):
        self.cfg = cfg
        self.net = net.eval()
        self._serving = False
        self.unfilled: List[str] = []

    @property
    def device(self) -> torch.device:
        return self.net.post_vq_conv.weight.device

    # -- construction -----------------------------------------------------
    @classmethod
    def from_config(cls, cfg: TokenizerConfig, seed: int = 0,
                    device: Any = "cuda") -> "OmniTokenizerVQGAN":
        """Random weights made from `seed` (on the CPU, then moved to
        `device`: the card unless the caller asks for the CPU). With no card,
        a CUDA device raises rather than leaving the model on the CPU."""
        check_device(device)
        net = OmniTokenizerNet(cfg)
        init_weights(net, torch.Generator().manual_seed(seed))
        return cls(cfg, net.to(device))

    @classmethod
    def load_from_checkpoint(cls, ckpt_path: str, cfg: Optional[TokenizerConfig] = None,
                             device: Any = "cuda", strict: bool = False
                             ) -> "OmniTokenizerVQGAN":
        """A reference Lightning .ckpt, a training checkpoint
        (checkpoints/step_*.pt), a save_tokenizer_checkpoint file or the JAX
        package's .msgpack (variables or a training state, with its
        .cfg.json sidecar unless `cfg` is given), on the card unless the
        caller asks for the CPU; see
        utils.checkpoint.load_tokenizer_checkpoint. With strict=False a
        tensor a torch file lacks keeps its init value (from seed 0), and
        `unfilled` names them; a .msgpack must hold every tensor."""
        from ..utils.checkpoint import load_tokenizer_checkpoint

        check_device(device)
        cfg, net, unfilled = load_tokenizer_checkpoint(ckpt_path, cfg=cfg, strict=strict)
        model = cls(cfg, net.to(device))
        model.unfilled = unfilled
        return model

    def serving(self) -> "OmniTokenizerVQGAN":
        """Cast the f32 parameters to the compute dtype and build the fused
        kernels' weights, once. Buffers (the codebook) keep their dtype."""
        if self._serving:
            return self
        dtype = self.cfg.dtype
        if dtype != torch.float32:
            with torch.no_grad():
                for p in self.net.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(dtype)
            self.net.prepare_kernels()
        self._serving = True
        return self

    # -- public API ---------------------------------------------------------
    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.inference_mode()
    def encode(self, x, is_image: bool, include_embeddings: bool = False, seed: int = 0):
        """VQ: indices (B, t, h, w) int32 [and channels-first embeddings].
        VAE: a posterior sample drawn with `seed`, channels-first: (B, c, t,
        h, w), or (B, c, h, w) for an image."""
        self.serving()
        xl = _to_channels_last(self._input(x), is_image)
        if self.cfg.use_vae:
            z = self.net.encode(xl, is_image, generator=self._generator(seed))
            z = z.permute(0, 4, 1, 2, 3)
            return z[:, :, 0] if is_image else z
        out = self.net.encode(xl, is_image, include_embeddings)
        if include_embeddings:
            emb, enc = out
            return emb.permute(0, 4, 1, 2, 3), enc
        return out

    @torch.inference_mode()
    def decode(self, encodings, is_image: bool) -> torch.Tensor:
        """VQ indices, flat (B, N) or grid (B, t, h, w), or VAE latents ->
        channels-first pixels. VAE image latents come channels-first, (B, c,
        h, w), but video latents channels-LAST, (B, t, h, w, c): the
        reference's asymmetry, which the JAX wrapper keeps (its
        `wrapper.py:129-141`)."""
        self.serving()
        enc = torch.as_tensor(encodings, device=self.device)
        if self.cfg.use_vae and enc.ndim == 4 and enc.is_floating_point():
            enc = enc.permute(0, 2, 3, 1)  # (B, c, h, w) -> (B, h, w, c)
        return _to_channels_first(self.net.decode(enc, is_image), is_image)

    @torch.inference_mode()
    def reconstruct(self, x, is_image: bool, seed: int = 0):
        """Round trip; returns (channels-first recon, aux dict). VAE mode
        decodes a sample drawn with `seed`."""
        self.serving()
        xl = _to_channels_last(self._input(x), is_image)
        gen = self._generator(seed) if self.cfg.use_vae else None
        recon, aux = self.net(xl, is_image, generator=gen)
        return _to_channels_first(recon, is_image), aux

    # -- info ---------------------------------------------------------------
    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        cfg = self.cfg
        return (cfg.latent_t, cfg.latent_hw, cfg.latent_hw)

    def num_params(self) -> int:
        """Parameters only; the codebook's buffers are not counted."""
        return sum(p.numel() for p in self.net.parameters())
