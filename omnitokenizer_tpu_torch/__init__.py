"""PyTorch + CUDA port of the OmniTokenizer tokenizer (VQ and VAE), its GAN
training (`training/`), the LM's serving path (`models/gpt.py`,
`models/net2net.py`) and its training (`training/lm_loop.py`, with the causal
flash attention kernels of `ops/kernels/flash_attn.py`), and diffusion
synthesis (`diffusion/`, `models/dit.py`, `models/latte.py`,
`training/diffusion_loop.py`), the JAX package's msgpack checkpoints read
and written without flax (`utils/msgpack_io.py`, `cli/convert_ckpt.py`),
and the generation metrics (`cli/metrics_eval.py`, `eval/prec_recall.py`).

The JAX package `omnitokenizer_tpu` is the reference; this package mirrors
its module layout and imports no JAX.
"""

from .config import (GPTConfig, Net2NetConfig, TokenizerConfig, imagenet_k600_config,
                     imagenet_only_config)
from .models.diffusion_adapter import DiffusionVAEAdapter
from .models.gpt import GPT
from .models.net2net import Net2NetTransformer
from .models.tokenizer import OmniTokenizerNet
from .models.wrapper import OmniTokenizerVQGAN

__all__ = ["GPTConfig", "Net2NetConfig", "TokenizerConfig", "imagenet_k600_config",
           "imagenet_only_config", "DiffusionVAEAdapter", "GPT", "Net2NetTransformer",
           "OmniTokenizerNet", "OmniTokenizerVQGAN"]
