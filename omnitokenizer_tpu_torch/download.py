"""The model zoo's names resolved to local files, and loaders on top of
them (mirror of `omnitokenizer_tpu.download`; the reference's download.py).

    vqgan = load_vqgan("imagenet_k600")                     # on the card
    n2n = load_transformer("imagenet_class_lm", "imagenet_only")

Nothing is fetched: a name resolves to a file of the released model zoo in
the cache ($OMNITOKENIZER_CACHE, default ~/.cache/omnitokenizer_tpu),
./ckpts_pub or the working directory, or the call raises and says where to
put the file. A path that exists passes through, a JAX `.msgpack` too.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

# the released checkpoints (the reference README's model zoo)
_MODEL_ZOO = {
    "imagenet_only": "imagenet_only.ckpt",
    "celebahq": "celebahq.ckpt",
    "ffhq": "ffhq.ckpt",
    "imagenet_ucf": "imagenet_ucf.ckpt",
    "imagenet_k600": "imagenet_k600.ckpt",
    "imagenet_mit": "imagenet_mit.ckpt",
    "imagenet_sthv2": "imagenet_sthv2.ckpt",
    "imagenet_ucf_vae": "imagenet_ucf_vae.ckpt",
    "imagenet_k600_vae": "imagenet_k600_vae.ckpt",
    "imagenet_class_lm": "imagenet_class_lm.ckpt",
    "ucf_class_lm": "ucf_class_lm.ckpt",
    "k600_uncond_lm": "k600_uncond_lm.ckpt",
}

DEFAULT_CACHE = os.environ.get("OMNITOKENIZER_CACHE",
                               os.path.expanduser("~/.cache/omnitokenizer_tpu"))


def resolve_checkpoint(name_or_path: str, cache_dir: str = DEFAULT_CACHE) -> str:
    """A local path for a zoo name, or the path itself if it exists."""
    if os.path.exists(name_or_path):
        return name_or_path
    fname = _MODEL_ZOO.get(name_or_path)
    if fname is None:
        raise FileNotFoundError(f"'{name_or_path}' is neither a file nor a known model name "
                                f"({sorted(_MODEL_ZOO)})")
    for root in (cache_dir, "./ckpts_pub", "."):
        cand = os.path.join(root, fname)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"checkpoint '{fname}' not found in {cache_dir}, ./ckpts_pub or the "
                            "working directory; download it from the OmniTokenizer release and "
                            "place it there (nothing is fetched here)")


def load_vqgan(name_or_path: str, cfg=None, device: Any = "cuda"):
    """A zoo name or a path -> OmniTokenizerVQGAN on `device`."""
    from .models.wrapper import OmniTokenizerVQGAN

    return OmniTokenizerVQGAN.load_from_checkpoint(resolve_checkpoint(name_or_path), cfg=cfg,
                                                   device=device)


def load_transformer(gpt_name_or_path: str, vqvae_name_or_path: str,
                     net2net_cfg: Optional[Any] = None, device: Any = "cuda"):
    """A zoo name or path pair -> Net2NetTransformer on `device`. Without
    `net2net_cfg` the LM's config comes from the Lightning checkpoint's
    hparams, as the JAX loader reads them; a `.msgpack` LM carries none, so
    it needs `net2net_cfg`."""
    from .config import GPTConfig, Net2NetConfig
    from .models.gpt import GPT
    from .models.net2net import Net2NetTransformer
    from .utils.checkpoint import load_torch_state_dict
    from .utils.gpt_checkpoint import gpt_state_dict_from_reference, load_gpt_checkpoint

    tok = load_vqgan(vqvae_name_or_path, device=device)
    path = resolve_checkpoint(gpt_name_or_path)
    if path.endswith(".msgpack"):
        if net2net_cfg is None:
            raise ValueError(f"{path}: a JAX LM file carries no hparams; pass net2net_cfg")
        sd = load_gpt_checkpoint(path)
    else:
        raw, args = load_torch_state_dict(path)
        sd = gpt_state_dict_from_reference(raw)
        if net2net_cfg is None:
            if args is None:
                raise ValueError(f"{path}: the LM checkpoint has no hparams; pass net2net_cfg")
            cond = 0 if getattr(args, "unconditional", False) else getattr(args, "class_cond_dim",
                                                                           1000)
            sos = getattr(args, "starts_with_sos", False)
            gpt_cfg = GPTConfig(vocab_size=tok.cfg.n_codes + cond + (1 if sos else 0),
                                block_size=getattr(args, "block_size", 1025),
                                n_layer=getattr(args, "n_layer", 24),
                                n_head=getattr(args, "n_head", 16),
                                n_embd=getattr(args, "n_embd", 1536))
            net2net_cfg = Net2NetConfig(gpt=gpt_cfg, class_cond_dim=cond if cond else 1000,
                                        unconditional=getattr(args, "unconditional", False),
                                        starts_with_sos=sos,
                                        class_first=getattr(args, "class_first", False),
                                        first_stage_vocab_size=tok.cfg.n_codes)
    with torch.device("meta"):
        gpt = GPT(net2net_cfg.gpt)
    gpt.load_state_dict(sd, assign=True)
    return Net2NetTransformer(net2net_cfg, tok, gpt=gpt)
