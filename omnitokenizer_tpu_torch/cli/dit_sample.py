"""DiT sampling CLI (mirror of `omnitokenizer_tpu.cli.dit_sample`, the
reference's DiT sample.py / sample_ddp.py).

    python -m omnitokenizer_tpu_torch.cli.dit_sample --ckpt RUN/state_000400000.pt \\
        [--vae_ckpt VAE.ckpt] [--ddim] [--bf16] [--device cpu]

The EMA weights by default (--no_ema: the trained ones) of a dit_train
state_*.pt, a reference .pt (a raw state_dict or the train script's
{'ema', 'model'} dict) or the JAX package's state_*.msgpack (its
ema_params, or params with --no_ema). Classifier-free guidance doubles the batch with the
null class; respaced DDPM over --num_sampling_steps (or DDIM with --ddim),
without clipping. With --vae_ckpt the latents decode through the VAE into
PNGs (mp4s for Latte); without, they are written as .npy, channels-first.
On N processes (torchrun or the OMNITOK_* variables, parallel/mesh.py)
each rank samples --num_samples as the JAX CLI's process does: its
generator seeded seed + 1000 * rank, the classes rotated by its rank,
its rank in each file's name.
`latte_sample` is `main(video=True)` (CFG on the first 4 channels).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .diffusion_common import (add_common_diffusion_args, build_model, decode_batch_fn,
                               load_vae_adapter)


def build_parser(video: bool = False):
    p = argparse.ArgumentParser("latte_sample" if video else "dit_sample")
    add_common_diffusion_args(p, video)
    p.add_argument("--ckpt", type=str, required=True,
                   help="state_*.pt from dit_train/latte_train, a reference .pt, or the JAX "
                        "package's state_*.msgpack")
    p.add_argument("--use_ema", action="store_true", default=True)
    p.add_argument("--no_ema", dest="use_ema", action="store_false")
    p.add_argument("--num_sampling_steps", type=int, default=250)
    p.add_argument("--ddim", action="store_true", help="use ddim<N> respacing + DDIM sampler")
    p.add_argument("--cfg_scale", type=float, default=4.0)
    p.add_argument("--cfg_channels", type=int, default=None,
                   help="channels guided (reference quirk: 3 for DiT, 4 for Latte)")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--per_proc_batch_size", type=int, default=8)
    p.add_argument("--classes", type=int, nargs="+", default=None)
    p.add_argument("--sample_dir", type=str, default="samples_diffusion")
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", type=str, default="linear")
    return p


def make_diffusion(args, video: bool):
    from ..diffusion import create_diffusion

    respacing = f"ddim{args.num_sampling_steps}" if args.ddim else str(args.num_sampling_steps)
    return create_diffusion(respacing, noise_schedule=args.noise_schedule,
                            diffusion_steps=args.diffusion_steps, channel_axis=2 if video else 1)


def sample_batch(args, model, diffusion, y_real: torch.Tensor, generator: torch.Generator,
                 video: bool) -> torch.Tensor:
    """Latents of len(y_real) samples of those classes: (n, C, h, w) or (n,
    F, C, h, w)."""
    from ..models import dit, latte

    cfg = model.cfg
    n, device = len(y_real), y_real.device
    guided = args.cfg_scale != 1.0
    latent = ((cfg.num_frames,) if video else ()) + (cfg.in_channels,) + (cfg.input_size,) * 2
    y = torch.cat([y_real, torch.full_like(y_real, cfg.num_classes)]) if guided else y_real
    if guided:
        fwd = latte.forward_with_cfg if video else dit.forward_with_cfg
        channels = args.cfg_channels if args.cfg_channels is not None else (4 if video else 3)

        def model_fn(x, t):
            return fwd(model, x, t, y, args.cfg_scale, channels)
    else:
        def model_fn(x, t):
            return model(x, t, y)
    loop = diffusion.ddim_sample_loop if args.ddim else diffusion.p_sample_loop
    with torch.inference_mode():
        z = loop(model_fn, (len(y),) + latent, generator, clip_denoised=False, device=device)
    return z[:n] if guided else z


def generate(args, model, diffusion, adapter, video: bool) -> int:
    """--num_samples samples in batches of --per_proc_batch_size, cycling
    through --classes (from this rank's offset), written under
    --sample_dir; returns how many."""
    from ..parallel import mesh
    from ..utils.media import save_image_grid, save_video_grid

    decode = decode_batch_fn(adapter, video) if adapter is not None else None
    os.makedirs(args.sample_dir, exist_ok=True)
    device = next(model.parameters()).device
    classes = args.classes if args.classes is not None else list(range(max(model.cfg.num_classes, 1)))
    rank = mesh.rank()
    generator = torch.Generator(device).manual_seed(args.seed + 1000 * rank)
    made = 0
    while made < args.num_samples:
        n = min(args.per_proc_batch_size, args.num_samples - made)
        y_real = torch.tensor([classes[(made + i + rank) % len(classes)] for i in range(n)],
                              device=device)
        z = sample_batch(args, model, diffusion, y_real, generator, video)
        if decode is not None:
            with torch.inference_mode():
                x = decode(z).float().cpu().numpy()  # channels-first, [-0.5, 0.5]
            x = np.moveaxis(x, 1, -1)  # channels-last: (n, H, W, 3) or (n, T, H, W, 3)
            for i in range(n):
                tag = os.path.join(args.sample_dir, f"{rank:02d}_{made + i:05d}_c{int(y_real[i])}")
                if video:
                    save_video_grid(x[i:i + 1], tag + ".mp4")
                else:
                    save_image_grid(x[i:i + 1], tag + ".png")
        else:
            np.save(os.path.join(args.sample_dir, f"latents_{rank:02d}_{made:05d}.npy"),
                    z.float().cpu().numpy())
        made += n
        print(f"[sample] {made}/{args.num_samples}")
    return made


def main(argv=None, video: bool = False):
    from ..convert import load_diffusion_checkpoint, load_diffusion_state_dict
    from ..parallel import mesh

    args = build_parser(video).parse_args(argv)
    mesh.init_distributed(args.device)
    model, cfg = build_model(args, video, init=False)
    load_diffusion_state_dict(model, load_diffusion_checkpoint(args.ckpt, cfg.patch_size,
                                                               args.use_ema))
    model = model.serving()
    return generate(args, model, make_diffusion(args, video), load_vae_adapter(args), video)


if __name__ == "__main__":
    main()
