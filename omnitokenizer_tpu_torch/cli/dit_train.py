"""DiT training CLI (mirror of `omnitokenizer_tpu.cli.dit_train`, the
reference's DiT train.py).

    python -m omnitokenizer_tpu_torch.cli.dit_train --vae_ckpt VAE.ckpt --data_path DIR \\
        --train_datalist LIST --results_dir RUN [--device cpu]
    python -m omnitokenizer_tpu_torch.cli.dit_train --synthetic_data --results_dir RUN

The reference's recipe: AdamW (lr 1e-4, weight decay 0), an EMA of 0.9999
that starts as a copy of the parameters, uniform timesteps, latents =
vae.encode(pixels) * 0.18215 each step (--synthetic_data: random latents,
no VAE or data). A run resumes from the newest state_*.pt under
--results_dir, writes one every --ckpt_every steps and at the end, and
logs metrics.jsonl. --init_from seeds the parameters from a reference
DiT/Latte .pt (its EMA), a state_*.pt, or the JAX package's state_*.msgpack
(its params, as the JAX CLI takes them). On N processes (torchrun or the
OMNITOK_* variables, parallel/mesh.py) the run is data-parallel: each rank
takes global_batch_size / N rows (synthetic latents and the timesteps are
its rows of the global draw; the loader strides the data by rank), the
gradients are averaged (training/diffusion_loop.py), so the parameters
and their EMA stay equal everywhere, and rank 0 logs and writes the
states. --wandb_project mirrors the metrics into a wandb run.
`latte_train` is `main(video=True)`.
"""

from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np
import torch

from ..parallel import mesh
from . import args as A
from .diffusion_common import (add_common_diffusion_args, build_model, encode_batch_fn,
                               load_vae_adapter, synthetic_latents)


def build_parser(video: bool = False):
    p = argparse.ArgumentParser("latte_train" if video else "dit_train")
    add_common_diffusion_args(p, video)
    A.add_data_args(p)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--grad_clip_val", type=float, default=0.0)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--max_steps", type=int, default=400_000)
    p.add_argument("--global_batch_size", type=int, default=256)
    p.add_argument("--ckpt_every", type=int, default=50_000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", type=str, default="linear")
    p.add_argument("--schedule_sampler", type=str, default="uniform",
                   choices=["uniform", "loss-second-moment"])
    p.add_argument("--init_from", type=str, default=None,
                   help="seed the parameters from a reference DiT/Latte .pt, a state_*.pt or "
                        "the JAX package's state_*.msgpack")
    p.add_argument("--synthetic_data", action="store_true",
                   help="train directly on random latents (no VAE or data needed)")
    p.add_argument("--wandb_project", type=str, default=None,
                   help="mirror the metrics into a wandb run (an offline run directory under "
                        "--results_dir/wandb without the wandb package)")
    if video:
        p.add_argument("--use_image_num", type=int, default=0,
                       help="joint image-video training (latte_img): append N independent "
                            "image latents per sample; they ride the spatial blocks with "
                            "their own labels and bypass the temporal blocks")
    return p


def find_latest(root: str):
    """The newest state_*.pt under root."""
    cands = glob.glob(os.path.join(root, "state_*.pt"))
    if not cands:
        return None
    return max(cands, key=lambda p: int(re.findall(r"state_(\d+)", p)[-1]))


def _forever(batches):
    """The batches, epoch after epoch."""
    while True:
        empty = True
        for batch in batches:
            empty = False
            yield batch
        if empty:
            raise ValueError("the training data yielded no batch")


def _next_batch(args, stream, rng, cfg, video, encode, encode_img, step, device, group=None):
    """(x0, y, y_image) of one step: the loader's pixels encoded (the
    images of --use_image_num drawn from other rows of the batch, each with
    its source's label), or synthetic latents; all channels-first."""
    use_image_num = getattr(args, "use_image_num", 0) if video else 0
    y_image = None
    if stream is None:
        B = args.global_batch_size
        x0 = synthetic_latents(rng, B, cfg, video)
        if use_image_num:
            extra = synthetic_latents(rng, B, cfg, video)[:, :use_image_num]
            x0 = np.concatenate([x0, extra], axis=1)
            y_image = rng.randint(0, max(cfg.num_classes, 1), size=(B, use_image_num))
        y = rng.randint(0, max(cfg.num_classes, 1), size=(len(x0),))
        def to(a):  # this rank's rows of the global draw
            return mesh.rank_rows(torch.as_tensor(a, device=device), group)
        return to(x0), to(y), None if y_image is None else to(y_image)

    batch = next(stream)
    pix = torch.as_tensor(batch["video"], dtype=torch.float32, device=device)  # channels-last
    if not video and pix.ndim == 5:  # a clip dataset: its first frame
        pix = pix[:, 0]
    y = torch.as_tensor(batch.get("label", np.zeros(len(pix))), device=device).long()
    img_pix = None
    if video and use_image_num:
        Bc, Tc = pix.shape[:2]
        img_pix, y_image = [], []
        for j in range(use_image_num):
            src = torch.as_tensor(np.roll(np.arange(Bc), j + 1), device=device)
            fidx = torch.as_tensor(rng.randint(0, Tc, size=Bc), device=device)
            img_pix.append(pix[src, fidx])
            y_image.append(y[src])
        img_pix, y_image = torch.stack(img_pix, 1), torch.stack(y_image, 1)
    if encode is not None:
        x0 = encode(pix.movedim(-1, 1), seed=step)
        if img_pix is not None:
            zi = encode_img(img_pix.flatten(0, 1).movedim(-1, 1), seed=step + 1)
            x0 = torch.cat([x0, zi.reshape((len(pix), use_image_num) + zi.shape[1:])], 1)
    else:  # pixels that are latents already
        x0 = pix.movedim(-1, 2 if video else 1)
        if img_pix is not None:
            x0 = torch.cat([x0, img_pix.movedim(-1, 2)], 1)
    return x0.clone(), y, y_image


def train(args, model, adapter=None, batches=None, video: bool = False):
    """Train `model` (the parameters to start from) with args' recipe on
    `batches` (dicts with channels-last 'video' pixels in [-0.5, 0.5] and
    'label'; encoded through `adapter`) or, without batches, on synthetic
    latents. Returns the final DiffusionTrainState."""
    from ..diffusion import create_diffusion, create_named_schedule_sampler
    from ..training.diffusion_loop import (init_diffusion_state, load_diffusion_state,
                                           make_diffusion_train_step, sample_timesteps,
                                           save_diffusion_state, update_sampler)
    from ..training.loop import MetricsLogger
    from ..training.trainer import OptaxAdam

    group = mesh.world_group()
    lead = mesh.rank() == 0
    cfg, device = model.cfg, next(model.parameters()).device
    diffusion = create_diffusion(None, noise_schedule=args.noise_schedule,
                                 diffusion_steps=args.diffusion_steps,
                                 channel_axis=2 if video else 1)
    sampler = create_named_schedule_sampler(args.schedule_sampler, diffusion.num_timesteps)
    opt = OptaxAdam(lambda _: args.lr, args.grad_clip_val or None, b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=args.weight_decay)  # optax.adamw
    state = init_diffusion_state(model, opt)
    os.makedirs(args.results_dir, exist_ok=True)
    latest = find_latest(args.results_dir)
    if latest:
        load_diffusion_state(latest, state)
        print(f"[{'latte' if video else 'dit'}_train] resumed from {latest} at step {state.step}")
    mesh.replicate(state.model, group)  # rank 0's parameters (and EMA) everywhere
    mesh.replicate(state.ema, group)

    use_image_num = getattr(args, "use_image_num", 0) if video else 0

    def loss_model_fn(m, x_t, t, generator, y=None, text_embedding=None, y_image=None,
                      group=None):
        kw = dict(train=True, generator=generator, group=group)
        if video and text_embedding is not None:
            kw["text_embedding"] = text_embedding
        if use_image_num:
            kw.update(use_image_num=use_image_num, y_image=y_image)
        return m(x_t, t, y, **kw)

    step_fn = make_diffusion_train_step(loss_model_fn, diffusion, opt, args.ema_decay, group)
    logger = MetricsLogger(args.results_dir, log_every=args.log_every,
                           wandb_project=args.wandb_project, wandb_config=vars(args)
                           ) if lead else None
    rng = np.random.RandomState(args.seed)
    encode = encode_batch_fn(adapter, video) if adapter is not None else None
    # the appended frames of joint training encode as images (one latent frame each)
    encode_img = encode_batch_fn(adapter, False) if adapter is not None else None
    stream = _forever(batches) if batches is not None else None

    step = state.step
    while step < args.max_steps:
        x0, y, y_image = _next_batch(args, stream, rng, cfg, video, encode, encode_img, step,
                                     device, group)
        ts, weights, ts_all = sample_timesteps(sampler, len(x0), rng, group)
        cond = {"y": y} if cfg.num_classes else {}
        if use_image_num and y_image is not None and cfg.num_classes:
            cond["y_image"] = y_image
        gen = torch.Generator(device).manual_seed(args.seed * 1_000_003 + step)
        state, loss, aux = step_fn(state, x0, torch.as_tensor(ts, device=device),
                                   torch.as_tensor(weights, device=device), gen, cond)
        if args.schedule_sampler == "loss-second-moment":
            update_sampler(sampler, ts_all, aux["per_t_loss"], group)
        step = state.step
        if lead and (step % args.log_every == 0 or step == 1):
            logger.log(step, {"loss": float(loss), "mse": float(aux.get("mse", loss)),
                              "grad_norm": float(aux["grad_norm"])})
        if lead and (step % args.ckpt_every == 0 or step == args.max_steps):
            save_diffusion_state(os.path.join(args.results_dir, f"state_{step:09d}.pt"), state)
    if lead:
        logger.close()
    mesh.barrier()
    print(f"[{'latte' if video else 'dit'}_train] done at step {step}")
    return state


def main(argv=None, video: bool = False):
    from ..convert import load_diffusion_checkpoint, load_diffusion_state_dict

    args = build_parser(video).parse_args(argv)
    mesh.init_distributed(args.device)
    model, cfg = build_model(args, video)
    if args.init_from:
        # a JAX state's params (its :119-124), a torch file's EMA
        use_ema = not args.init_from.endswith(".msgpack")
        load_diffusion_state_dict(model, load_diffusion_checkpoint(args.init_from,
                                                                   cfg.patch_size, use_ema))
        print(f"[{'latte' if video else 'dit'}_train] initialized params from {args.init_from}")
    adapter = None if args.synthetic_data else load_vae_adapter(args)
    batches = None
    if not args.synthetic_data and args.train_datalist[0] != "none":
        from ..data.loader import VideoData

        batches = VideoData(args, train=True, process_index=mesh.rank(),
                            process_count=mesh.world())
    return train(args, model, adapter, batches, video)


if __name__ == "__main__":
    main()
