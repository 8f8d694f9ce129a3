"""LatteT2V text-to-video sampling CLI (mirror of
`omnitokenizer_tpu.cli.latte_t2v_sample`, the reference's
sample/sample_t2v.py with its VideoGenPipeline).

    python -m omnitokenizer_tpu_torch.cli.latte_t2v_sample --ckpt t2v.pt \\
        [--t5_dir T5] [--vae_ckpt VAE.ckpt --in_channels 8] [--bf16] [--device cpu]

As the JAX CLI: prompts through T5 (padded and cut to --max_token_length,
the keep-mask carried into cross-attention), classifier-free guidance on
the [uncond, text] batch, eps = uncond + scale * (text - uncond), the
learned-variance half of the output dropped, and a fixed-small-variance
process (respaced `ddim<N>` or plain over --num_sampling_steps) on a
--beta_schedule of 1000 steps. --ckpt takes a reference .pt/.pth/.ckpt
(its EMA where it has one) or a JAX msgpack (its `params`, or the root).

Where it differs from the JAX CLI:
  - --device: the card by default, cpu for tests.
  - Without --t5_dir the captions come from a byte-embedding table of
    (257, caption_channels) drawn N(0, 0.02^2) from a torch.Generator
    seeded 0: another table than the JAX CLI's, which draws from
    jax.random. `transformers` is imported only under --t5_dir.
  - The noise comes from a torch.Generator seeded --seed, not jax.random.
  - Latents are channels-first per frame, (B, F, C, h, w), in latents.npy
    too (the JAX file is channels-last).
  - With --vae_ckpt the latent channels must be the VAE's (its codebook
    dim, 8 for OmniTokenizer): the JAX CLI's default --in_channels 4
    cannot be decoded, and the port raises where the JAX CLI fails inside
    the decode. The mp4s are written from the decode in the data range
    [-0.5, 0.5], channels-last, as dit_sample writes them.
"""

from __future__ import annotations

import argparse
import html
import json
import os
import re

import numpy as np
import torch

from . import args as A


def build_parser():
    p = argparse.ArgumentParser("latte_t2v_sample")
    p.add_argument("--ckpt", type=str, default=None,
                   help="LatteT2V weights: a torch .pt/.pth/.ckpt state dict or a JAX msgpack")
    p.add_argument("--model_config", type=str, default=None,
                   help="PixArt transformer config.json (from_pretrained_2d)")
    p.add_argument("--num_layers", type=int, default=28)
    p.add_argument("--num_attention_heads", type=int, default=16)
    p.add_argument("--attention_head_dim", type=int, default=72)
    p.add_argument("--cross_attention_dim", type=int, default=1152)
    p.add_argument("--caption_channels", type=int, default=4096)
    p.add_argument("--in_channels", type=int, default=4)
    p.add_argument("--out_channels", type=int, default=8)
    p.add_argument("--patch_size", type=int, default=2)
    p.add_argument("--activation_fn", type=str, default="gelu-approximate")
    p.add_argument("--no_attention_bias", dest="attention_bias",
                   action="store_false", default=True)
    p.add_argument("--norm_eps", type=float, default=1e-6)
    p.add_argument("--image_size", type=int, default=512,
                   help="pixel size; latent = image_size // 8")
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--text_prompt", type=str, nargs="+",
                   default=["a corgi running on the beach"])
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--num_sampling_steps", type=int, default=50)
    p.add_argument("--sample_method", type=str, default="ddim", choices=["ddim", "ddpm"])
    p.add_argument("--beta_schedule", type=str, default="linear")
    p.add_argument("--enable_temporal_attentions", action="store_true", default=True)
    p.add_argument("--disable_temporal_attentions",
                   dest="enable_temporal_attentions", action="store_false")
    p.add_argument("--t5_dir", type=str, default=None,
                   help="local HF dir with a T5 encoder (and tokenizer); without it, captions "
                        "from a seeded byte-embedding table (another table than the JAX CLI's)")
    p.add_argument("--max_token_length", type=int, default=120)
    p.add_argument("--vae_ckpt", type=str, default=None,
                   help="OmniTokenizer VAE for the pixel decode (--in_channels must be its "
                        "latent channels, 8)")
    p.add_argument("--save_img_path", type=str, default="./sample_videos/t2v")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    A.add_device_arg(p)
    return p


_WS = re.compile(r"\s+")


def basic_clean(text: str) -> str:
    """The html/whitespace subset of the pipeline's caption cleaning."""
    return _WS.sub(" ", html.unescape(html.unescape(text))).strip()


def _byte_ids(prompts, L):
    ids = np.zeros((len(prompts), L), np.int64)
    mask = np.zeros((len(prompts), L), np.int64)
    for i, t in enumerate(prompts):
        bs = list(t.encode("utf-8"))[: L]
        ids[i, : len(bs)] = np.asarray(bs, np.int64) + 1
        mask[i, : max(len(bs), 1)] = 1  # an empty prompt keeps one live slot
    return ids, mask


def byte_table(caption_channels: int) -> np.ndarray:
    """The fallback's (257, caption_channels) table: N(0, 0.02^2) from a
    torch.Generator seeded 0."""
    g = torch.Generator().manual_seed(0)
    return (torch.randn(257, caption_channels, generator=g) * 0.02).numpy()


def encode_prompts(args, prompts):
    """prompts -> (embeddings (B, L, caption_channels) f32, keep-mask (B, L))."""
    prompts = [basic_clean(t) for t in prompts]
    L = args.max_token_length
    if args.t5_dir:
        from transformers import T5EncoderModel

        enc = T5EncoderModel.from_pretrained(args.t5_dir)
        enc.eval()
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(args.t5_dir)
            batch = tok(prompts, padding="max_length", max_length=L, truncation=True,
                        add_special_tokens=True, return_tensors="pt")
            ids, mask = batch.input_ids, batch.attention_mask
        except Exception:  # no tokenizer files: byte ids into the T5 vocabulary
            ids, mask = _byte_ids(prompts, L)
            ids = torch.as_tensor(ids % enc.config.vocab_size)
            mask = torch.as_tensor(mask)
        with torch.no_grad():
            emb = enc(input_ids=ids, attention_mask=mask).last_hidden_state.float().numpy()
        return emb, np.asarray(mask)
    ids, mask = _byte_ids(prompts, L)
    return byte_table(args.caption_channels)[ids], mask


def load_t2v_config(args, dtype):
    """The model's config from the flags, the fields of a --model_config
    JSON over them (its video_length the flag's)."""
    from ..models.latte_t2v import LatteT2VConfig

    kw = dict(num_attention_heads=args.num_attention_heads,
              attention_head_dim=args.attention_head_dim,
              in_channels=args.in_channels, out_channels=args.out_channels,
              num_layers=args.num_layers, cross_attention_dim=args.cross_attention_dim,
              attention_bias=args.attention_bias, sample_size=args.image_size // 8,
              patch_size=args.patch_size, activation_fn=args.activation_fn,
              norm_eps=args.norm_eps, norm_elementwise_affine=False,
              caption_channels=args.caption_channels, video_length=args.video_length)
    if args.model_config:
        with open(args.model_config) as f:
            raw = json.load(f)
        for k in list(kw):
            if k in raw:
                kw[k] = raw[k]
        kw["video_length"] = args.video_length  # from_pretrained_2d's override
    return LatteT2VConfig(dtype=dtype, **kw)


def load_weights(model, path: str) -> None:
    """--ckpt into `model`: a torch file's EMA (else its weights), or a
    JAX msgpack's `params` (else its root)."""
    from ..convert import (latte_t2v_state_dict_from_jax, load_diffusion_state_dict,
                           load_torch_diffusion_state_dict)

    if path.endswith((".pt", ".pth", ".ckpt")):
        sd = load_torch_diffusion_state_dict(path, use_ema=True)
    else:
        from ..utils.msgpack_io import read_msgpack

        raw = read_msgpack(path)
        sd = latte_t2v_state_dict_from_jax(raw.get("params", raw), model.cfg.patch_size)
    load_diffusion_state_dict(model, sd)


def guided_eps(model, ctx, mask, guidance_scale: float, channels: int,
               enable_temporal_attentions: bool = True):
    """eps(x, t) of the sampling loop: one forward over [uncond, text] when
    guidance_scale > 1, eps = uncond + scale * (text - uncond), the first
    `channels` channels of each frame (the learned variance dropped)."""
    do_cfg = guidance_scale > 1.0

    def eps(x, t):
        xin, tin = (torch.cat([x, x]), torch.cat([t, t])) if do_cfg else (x, t)
        out = model(xin, tin, encoder_hidden_states=ctx, encoder_attention_mask=mask,
                    enable_temporal_attentions=enable_temporal_attentions)
        if do_cfg:
            u, c = out.chunk(2, dim=0)
            out = u + guidance_scale * (c - u)
        return out[:, :, :channels]

    return eps


def make_diffusion(args):
    from ..diffusion import create_diffusion

    respacing = (f"ddim{args.num_sampling_steps}" if args.sample_method == "ddim"
                 else str(args.num_sampling_steps))
    return create_diffusion(respacing, noise_schedule=args.beta_schedule, learn_sigma=False,
                            sigma_small=True, channel_axis=2)


def main(argv=None):
    from ..models.latte_t2v import LatteT2V, init_weights
    from ..models.wrapper import check_device
    from ..utils.media import save_video_grid
    from .diffusion_common import decode_batch_fn, load_vae_adapter

    args = build_parser().parse_args(argv)
    check_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cfg = load_t2v_config(args, dtype)
    adapter = load_vae_adapter(args)
    if adapter is not None and adapter.latent_channels != cfg.in_channels:
        raise ValueError(f"--in_channels {cfg.in_channels} is not the VAE's latent channels "
                         f"({adapter.latent_channels}): the VAE cannot decode these latents")
    with torch.device(args.device):
        model = LatteT2V(cfg)
    if args.ckpt:
        load_weights(model, args.ckpt)
    else:
        init_weights(model, torch.Generator(args.device).manual_seed(0))
        print("[t2v] WARNING: no --ckpt; sampling from random weights")
    model = model.serving()

    B, C, lat = len(args.text_prompt), cfg.in_channels, cfg.sample_size
    pos_emb, pos_mask = encode_prompts(args, args.text_prompt)
    neg_emb, neg_mask = encode_prompts(args, [args.negative_prompt] * B)
    if args.guidance_scale > 1.0:  # [uncond, text]
        pos_emb, pos_mask = np.concatenate([neg_emb, pos_emb]), np.concatenate([neg_mask, pos_mask])
    ctx = torch.as_tensor(pos_emb, dtype=torch.float32, device=args.device)
    mask = torch.as_tensor(pos_mask, device=args.device)
    eps = guided_eps(model, ctx, mask, args.guidance_scale, C, args.enable_temporal_attentions)

    diffusion = make_diffusion(args)
    loop = diffusion.ddim_sample_loop if args.sample_method == "ddim" else diffusion.p_sample_loop
    generator = torch.Generator(args.device).manual_seed(args.seed)
    with torch.inference_mode():
        z = loop(eps, (B, args.video_length, C, lat, lat), generator, clip_denoised=False,
                 device=args.device)

    os.makedirs(args.save_img_path, exist_ok=True)
    if adapter is not None:
        with torch.inference_mode():
            x = decode_batch_fn(adapter, video=True)(z).float().cpu().numpy()
        x = np.moveaxis(x, 1, -1)  # (B, T, H, W, 3) in [-0.5, 0.5]
        for i, prompt in enumerate(args.text_prompt):
            name = re.sub(r"\W+", "_", prompt)[:40] or f"sample_{i}"
            save_video_grid(x[i:i + 1], os.path.join(args.save_img_path, name + ".mp4"))
    else:
        out = os.path.join(args.save_img_path, "latents.npy")
        np.save(out, z.float().cpu().numpy())
        print(f"[t2v] saved latents {tuple(z.shape)} -> {out}")
    return z.float().cpu().numpy()


if __name__ == "__main__":
    main()
