"""What the DiT/Latte train and sample CLIs share (mirror of
`omnitokenizer_tpu.cli.diffusion_common`): the common flags, the latent
geometry, the model, the VAE seam and synthetic latents.

The VAE seam is `models.diffusion_adapter.DiffusionVAEAdapter` (x0.18215):
pixels in the data range [-0.5, 0.5] go in x2 (the seam's [-1, 1]), and
decoded pixels come back x0.5, clipped to [-0.5, 0.5]. Latents are
channels-first: (B, C, h, w) images, (B, F, C, h, w) clips. The port adds
one flag, --device (the card by default, cpu for tests).
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from . import args as A


def add_common_diffusion_args(p: argparse.ArgumentParser, video: bool):
    p.add_argument("--model", type=str, default="Latte-XL/2-omnitokenizer" if video else "DiT-XL/2")
    p.add_argument("--vae_ckpt", type=str, default=None, help="OmniTokenizer VAE checkpoint")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--in_channels", type=int, default=8, help="latent channels (OmniTokenizer VAE = 8)")
    p.add_argument("--num_classes", type=int, default=1000 if not video else 101)
    p.add_argument("--results_dir", type=str, default="results_diffusion")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    if video:
        p.add_argument("--num_frames", type=int, default=17, help="pixel frames (latent = 1+(T-1)//4)")
        p.add_argument("--extras", type=int, default=2, choices=[1, 2, 78])
    A.add_device_arg(p)
    return p


def latent_geometry(args, video: bool) -> Tuple[int, int]:
    """(latent hw, latent frames): image_size // 8 and 1 + (T-1) // 4."""
    latent_hw = args.image_size // 8
    latent_t = 1 + (args.num_frames - 1) // 4 if video else 1
    return latent_hw, latent_t


def model_config(args, video: bool):
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    latent_hw, latent_t = latent_geometry(args, video)
    if video:
        from ..models.latte import latte_config

        return latte_config(args.model, input_size=latent_hw, num_frames=latent_t,
                            num_classes=args.num_classes, extras=args.extras, dtype=dtype,
                            ).replace(in_channels=args.in_channels)
    from ..models.dit import dit_config

    return dit_config(args.model, input_size=latent_hw, in_channels=args.in_channels,
                      num_classes=args.num_classes, dtype=dtype)


def build_model(args, video: bool, init: bool = True):
    """(model, cfg) on --device (raises for the card on a host without
    one), with the JAX package's init from --seed unless init is False."""
    from ..models.dit import DiT, init_weights
    from ..models.latte import Latte
    from ..models.wrapper import check_device

    check_device(args.device)
    cfg = model_config(args, video)
    with torch.device(args.device):
        model = Latte(cfg) if video else DiT(cfg)
    if init:
        init_weights(model, torch.Generator(args.device).manual_seed(args.seed))
    return model, cfg


def load_vae_adapter(args):
    if not args.vae_ckpt:
        return None
    from ..models.diffusion_adapter import DiffusionVAEAdapter

    return DiffusionVAEAdapter.load_from_checkpoint(args.vae_ckpt, device=args.device)


def encode_batch_fn(adapter, video: bool):
    """pixels (channels-first, data range [-0.5, 0.5]) -> scaled latents,
    (B, C, h, w) or (B, F, C, h, w)."""
    def encode(x, seed: int = 0) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=adapter.vae.device)
        z = adapter.encode(x * 2.0, is_image=not video, seed=seed)
        return z.permute(0, 2, 1, 3, 4).contiguous() if video else z

    return encode


def decode_batch_fn(adapter, video: bool):
    """latents in encode's layout -> channels-first pixels in [-0.5, 0.5]."""
    def decode(z: torch.Tensor) -> torch.Tensor:
        if video:
            z = z.permute(0, 2, 1, 3, 4)  # (B, F, C, h, w) -> (B, C, F, h, w)
        return (adapter.decode(z, is_image=not video) * 0.5).clamp(-0.5, 0.5)

    return decode


def synthetic_latents(rng: np.random.RandomState, n: int, cfg, video: bool) -> np.ndarray:
    """N(0, 0.25) latents, the JAX CLI's draws (made channels-last, as it
    makes them) in the port's channels-first layout."""
    if video:
        shape = (n, cfg.num_frames, cfg.input_size, cfg.input_size, cfg.in_channels)
        return np.moveaxis((rng.randn(*shape) * 0.5).astype(np.float32), -1, 2)
    shape = (n, cfg.input_size, cfg.input_size, cfg.in_channels)
    return np.moveaxis((rng.randn(*shape) * 0.5).astype(np.float32), -1, 1)
