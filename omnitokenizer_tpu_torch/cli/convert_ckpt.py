"""Checkpoint conversion CLI (counterpart of `omnitokenizer_tpu.cli.convert_ckpt`):
a reference Lightning `.ckpt` or a JAX package `.msgpack` in, the port's
native torch file out.

    python -m omnitokenizer_tpu_torch.cli.convert_ckpt --src run/step_00010000.msgpack \\
        --dst tokenizer.pt [--kind tokenizer]
    python -m omnitokenizer_tpu_torch.cli.convert_ckpt --kind gpt --src lm.msgpack --dst lm.pt
    python -m omnitokenizer_tpu_torch.cli.convert_ckpt --kind dit --src state_000400000.msgpack \\
        --dst dit.pt [--patch_size 2]

kinds:
  tokenizer: `save_tokenizer_checkpoint`'s {"net": state_dict} and its
    `<dst>.cfg.json` sidecar (the config from the source's hparams or its
    own sidecar), which load_from_checkpoint, vqgan_eval and
    transformer_* read;
  gpt: the GPT's state_dict, which transformer_eval --gpt_ckpt reads;
  dit, latte: {"model": params, "ema": EMA} as the reference's train
    scripts write them (a raw state_dict source's one state_dict under
    both), which dit_sample/latte_sample --ckpt and dit_train/latte_train
    --init_from read.
No flax, JAX or msgpack package is needed (utils/msgpack_io.py).
"""

from __future__ import annotations

import argparse
import os

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("convert_ckpt")
    p.add_argument("--src", required=True, help="a reference .ckpt/.pt or a JAX .msgpack")
    p.add_argument("--dst", required=True, help="the port's .pt")
    p.add_argument("--kind", default="tokenizer", choices=["tokenizer", "gpt", "dit", "latte"])
    p.add_argument("--patch_size", type=int, default=2,
                   help="dit/latte: the latent patch size (the JAX kernel (p*p*C, D) does not "
                        "carry it)")
    return p


def convert(src: str, dst: str, kind: str = "tokenizer", patch_size: int = 2) -> str:
    """Write `src` as the port's file at `dst`; returns what was written."""
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    if kind == "tokenizer":
        from ..utils.checkpoint import load_tokenizer_checkpoint, save_tokenizer_checkpoint

        cfg, net, unfilled = load_tokenizer_checkpoint(src)
        if unfilled:
            print(f"[convert_ckpt] {len(unfilled)} tensors not in {src} keep their init values: "
                  f"{unfilled[:5]}")
        save_tokenizer_checkpoint(dst, net, cfg)
        return (f"tokenizer ({sum(p.numel() for p in net.parameters())} parameters) -> {dst} "
                f"(config sidecar {dst}.cfg.json)")
    if kind == "gpt":
        from ..utils.gpt_checkpoint import load_gpt_checkpoint

        sd = load_gpt_checkpoint(src)
        torch.save(sd, dst)
        return f"gpt ({len(sd)} tensors) -> {dst}"
    from ..convert import (diffusion_state_field, dit_state_dict_from_jax,
                           load_torch_diffusion_state_dict)
    from ..utils.msgpack_io import read_msgpack

    if src.endswith(".msgpack"):
        raw = read_msgpack(src)
        model, ema = (dit_state_dict_from_jax(diffusion_state_field(raw, field, src), patch_size)
                      for field in ("params", "ema_params"))
    else:
        model, ema = (load_torch_diffusion_state_dict(src, use_ema) for use_ema in (False, True))
    torch.save({"model": model, "ema": ema}, dst)
    return f"{kind} ({len(model)} tensors, model and ema) -> {dst}"


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    done = convert(args.src, args.dst, args.kind, args.patch_size)
    print(f"converted {done}")
    return done


if __name__ == "__main__":
    main()
