"""PyTorch + CUDA port of the OmniTokenizer tokenizer (VQ and VAE), its GAN
training (`training/`), the LM's serving path (`models/gpt.py`,
`models/net2net.py`) and its training (`training/lm_loop.py`, with the causal
flash attention kernels of `ops/kernels/flash_attn.py`), and diffusion
synthesis (`diffusion/`, `models/dit.py`, `models/latte.py`,
`training/diffusion_loop.py`), the JAX package's msgpack checkpoints read
and written without flax (`utils/msgpack_io.py`, `cli/convert_ckpt.py`),
the generation metrics (`cli/metrics_eval.py`, `eval/prec_recall.py`), the
legacy TATS CNN VQGAN (`models/cnn_vqgan.py`, exported lazily as `VQGAN`)
and the quantizer library (`ops/quantizers.py`).

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

# the legacy TATS-style CNN VQGAN under the reference's name, resolved on
# first use, as the JAX package exports it (omnitokenizer_tpu/__init__.py)
_LAZY = {
    "VQGAN": ("omnitokenizer_tpu_torch.models.cnn_vqgan", "CnnVQGAN"),
    "load_cnn_vqgan_checkpoint": ("omnitokenizer_tpu_torch.models.cnn_vqgan",
                                  "load_cnn_vqgan_checkpoint"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'omnitokenizer_tpu_torch' has no attribute {name!r}")


__all__ = ["GPTConfig", "Net2NetConfig", "TokenizerConfig", "imagenet_k600_config",
           "imagenet_only_config", "DiffusionVAEAdapter", "GPT", "Net2NetTransformer",
           "OmniTokenizerNet", "OmniTokenizerVQGAN", *sorted(_LAZY)]
