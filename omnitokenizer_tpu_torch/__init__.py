"""PyTorch + CUDA port of the OmniTokenizer tokenizer (VQ and VAE).

The JAX package `omnitokenizer_tpu` is the reference; this package mirrors
its module layout and imports no JAX.
"""

from .config import TokenizerConfig, imagenet_k600_config, imagenet_only_config
from .models.diffusion_adapter import DiffusionVAEAdapter
from .models.tokenizer import OmniTokenizerNet
from .models.wrapper import OmniTokenizerVQGAN

__all__ = ["TokenizerConfig", "imagenet_k600_config", "imagenet_only_config",
           "DiffusionVAEAdapter", "OmniTokenizerNet", "OmniTokenizerVQGAN"]
