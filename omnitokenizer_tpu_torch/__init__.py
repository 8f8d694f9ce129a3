"""PyTorch + CUDA port of the OmniTokenizer VQ tokenizer.

The JAX package `omnitokenizer_tpu` is the reference; this package mirrors
its module layout and imports no JAX.
"""

from .config import TokenizerConfig, imagenet_k600_config
from .models.tokenizer import OmniTokenizerNet
from .models.wrapper import OmniTokenizerVQGAN

__all__ = ["TokenizerConfig", "imagenet_k600_config", "OmniTokenizerNet",
           "OmniTokenizerVQGAN"]
