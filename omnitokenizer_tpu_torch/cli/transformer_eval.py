"""LM generation CLI (mirror of `omnitokenizer_tpu.cli.transformer_eval`,
the reference's transformer_eval.py).

    python -m omnitokenizer_tpu_torch.cli.transformer_eval --inference_type class \\
        --gpt_ckpt GPT.ckpt --vqvae TOKENIZER.ckpt --starts_with_sos --class_first \\
        --cfg_ratio 1.5 --top_k 2048 --sequence_length 1 --decode_bucket 256 --bf16 [--int8] \\
        [--device cpu]

class: class-conditional generation with CFG, 8 classes a batch, one PNG
  per class for images (npz with --save_as npz), one npz per class for
  videos (mp4 with --save_as mp4);
frame_prediction: encode the first 2 latent frames of each clip of
  --data_path/--val_datalist, continue the rest with the LM, decode, and
  write pred*.npz (video, ground_truth).
The tokenizer and the GPT load from the reference's checkpoints or the JAX
package's `.msgpack` files (utils/checkpoint.py, utils/gpt_checkpoint.py);
the decode runs as CUDA
graphs on the card unless --device cpu.

On N processes (torchrun or the OMNITOK_* variables, parallel/mesh.py;
--distributed alone brings up a world of one) the ranks form a (data,
model) grid of --model_parallel ranks a row: each data row takes the
classes classes[row::rows] with a generator seeded seed + row (frame
prediction: seed + row), as the JAX CLI splits them by process, and its
first rank writes the files. --model_parallel M decodes with the GPT's
Megatron shards and head-sharded KV caches (parallel/tp.py; refused with
--int8, as in JAX). The decode graphs capture NCCL's collectives; gloo's
cannot be captured, so under gloo a tensor-parallel decode on the card
runs its steps eagerly.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import args as A


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("transformer_eval")
    A.add_model_args(p)
    A.add_data_args(p)
    A.add_device_arg(p)
    p.add_argument("--gpt_ckpt", type=str, required=True)
    p.add_argument("--vqvae", "--vqgan_ckpt", type=str, required=True,
                   help="tokenizer ckpt (reference name: --vqgan_ckpt)")
    p.add_argument("--inference_type", type=str, default="class",
                   choices=["class", "frame_prediction"])
    p.add_argument("--class_cond", action="store_true",
                   help="force class-conditional generation (equals --inference_type class)")
    p.add_argument("--data_dir", type=str, default=None,
                   help="frame-prediction input root (alias of --data_path)")
    p.add_argument("--data_list", type=str, default=None,
                   help="frame-prediction clip list (alias of --val_datalist)")
    p.add_argument("--distributed", action="store_true",
                   help="bring up a process group (a world of one without a launcher)")
    p.add_argument("--save", type=str, default="./gen_out")
    p.add_argument("--n_sample", type=int, default=16)
    p.add_argument("--class_cond_dim", type=int, default=1000)
    p.add_argument("--block_size", type=int, default=1025)
    p.add_argument("--n_layer", type=int, default=24)
    p.add_argument("--n_head", type=int, default=16)
    p.add_argument("--n_embd", type=int, default=1536)
    p.add_argument("--starts_with_sos", action="store_true")
    p.add_argument("--class_first", action="store_true")
    p.add_argument("--unconditional", action="store_true")
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--cfg_ratio", type=float, default=1.5)
    p.add_argument("--no_scale_cfg", action="store_true",
                   help="constant guidance scale instead of the default step-scaled "
                        "t = cfg_ratio * n")
    p.add_argument("--int8", action="store_true", help="int8 W8A8 decode weights (ops/int8.py)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel decode: ranks of one Megatron group")
    p.add_argument("--decode_bucket", type=int, default=128,
                   help="segmented attention windows for long AR decode, one CUDA graph "
                        "per window (0 = the whole block every step)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--save_as", type=str, default="png", choices=["png", "mp4", "npz"])
    return p


def build_model(args):
    """(Net2NetTransformer, tokenizer) from the CLI's flags and checkpoints."""
    from ..config import GPTConfig, Net2NetConfig
    from ..models.gpt import GPT
    from ..models.net2net import Net2NetTransformer
    from ..models.wrapper import OmniTokenizerVQGAN
    from ..utils.gpt_checkpoint import load_gpt_checkpoint

    tok = OmniTokenizerVQGAN.load_from_checkpoint(args.vqvae, device=args.device)
    vocab = tok.cfg.n_codes + (0 if args.unconditional else args.class_cond_dim)
    if args.starts_with_sos and not args.unconditional:
        vocab += 1
    gpt_cfg = GPTConfig(vocab_size=vocab, block_size=args.block_size, n_layer=args.n_layer,
                        n_head=args.n_head, n_embd=args.n_embd,
                        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    n2n_cfg = Net2NetConfig(gpt=gpt_cfg, class_cond_dim=args.class_cond_dim,
                            unconditional=args.unconditional,
                            starts_with_sos=args.starts_with_sos, class_first=args.class_first,
                            first_stage_vocab_size=tok.cfg.n_codes)
    with torch.device("meta"):
        gpt = GPT(gpt_cfg)
    gpt.load_state_dict(load_gpt_checkpoint(args.gpt_ckpt), assign=True)
    return Net2NetTransformer(n2n_cfg, tok, gpt=gpt), tok


def _frame_prediction(args, n2n, tok, seed: int) -> int:
    from ..data.loader import VideoData

    # one finite pass, as the reference's val loader; n_sample may stop it sooner
    loader = VideoData(args, train=False, epochs=1)
    sampler = n2n.make_frame_prediction_sampler(
        tok.cfg.latent_t, prefix_latent_frames=2, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, bucket=args.decode_bucket or None, int8=args.int8)
    gen = torch.Generator(n2n.device).manual_seed(seed)
    done = 0
    for batch in iter(loader):
        if done >= args.n_sample:
            break
        video = np.moveaxis(np.asarray(batch["video"], np.float32), -1, 1)
        ids = sampler(video, gen)
        pixels = n2n.decode_to_pixels(ids, is_image=False).float().cpu().numpy()
        for i in range(len(pixels)):
            np.savez(os.path.join(args.save, f"pred{done:05d}.npz"), video=pixels[i],
                     ground_truth=video[i])
            done += 1
    return done


def _save_class(args, pixels: np.ndarray, c: int, is_image: bool) -> None:
    from ..training.loop import write_png
    from ..utils.media import save_video_grid, to_uint8

    stem = os.path.join(args.save, f"class{c:04d}")
    if is_image and args.save_as != "npz":
        write_png(stem + ".png", to_uint8(np.moveaxis(pixels, 0, -1)))
    elif not is_image and args.save_as == "mp4":
        save_video_grid(np.moveaxis(pixels, 0, -1)[None], stem + ".mp4")
    else:
        np.savez(stem + ".npz", **{"image" if is_image else "video": pixels})


def main(argv=None) -> int:
    from ..parallel import mesh, tp

    args = A.normalize_precision(build_parser().parse_args(argv))
    if args.model_parallel > 1:
        if args.int8:
            raise ValueError("--int8 and --model_parallel are mutually exclusive")
        tp.check_layout(args.n_head, args.n_embd, args.model_parallel)
    group = mesh.init_distributed(args.device, world_of_one=args.distributed)
    grid = mesh.grid(args.model_parallel) if group is not None else None
    if grid is None and args.model_parallel > 1:
        raise ValueError(f"--model_parallel {args.model_parallel} needs that many processes")
    row, rows = (grid.data_rank, grid.data_size) if grid else (0, 1)
    writer = grid is None or grid.inner_rank == 0
    if args.class_cond:
        args.inference_type = "class"
    if args.data_dir:
        args.data_path = [args.data_dir]
    if args.data_list:
        args.val_datalist = [args.data_list]
    torch.backends.cuda.matmul.allow_tf32 = False
    n2n, tok = build_model(args)
    os.makedirs(args.save, exist_ok=True)

    if args.inference_type == "frame_prediction":
        done = _frame_prediction(args, n2n, tok, args.seed + mesh.rank())
        print(f"frame-predicted {done} clips to {args.save}")
        return done

    graphs = True
    if args.model_parallel > 1:
        tp.shard_gpt(n2n.gpt, grid.inner)
        # gloo's collectives cannot be captured in a CUDA graph; NCCL's can
        graphs = torch.distributed.get_backend(grid.inner) != "gloo"

    hw, lt = tok.cfg.latent_hw, tok.cfg.latent_t
    is_image = args.sequence_length == 1
    steps = hw * hw if is_image else lt * hw * hw
    sampler = n2n.make_class_conditional_sampler(
        steps, temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        cfg_ratio=args.cfg_ratio, use_cfg=args.starts_with_sos,
        scale_cfg=not args.no_scale_cfg, bucket=args.decode_bucket or None, int8=args.int8,
        cuda_graphs=graphs)
    # the JAX CLI's split: data row r of R takes classes r, r + R, ...
    classes = np.arange(args.class_cond_dim)[row::rows]
    gen = torch.Generator(n2n.device).manual_seed(args.seed + row)
    done = 0
    n_total = min(args.n_sample, len(classes))
    for start in range(0, n_total, 8):
        cls = classes[start:min(start + 8, n_total)]
        ids = sampler(torch.as_tensor(cls), gen)
        pixels = n2n.decode_to_pixels(ids, is_image=is_image).float().cpu().numpy()
        for i, c in enumerate(cls):
            if writer:
                _save_class(args, pixels[i], int(c), is_image)
            done += 1
    print(f"generated {done} samples to {args.save}")
    return done


if __name__ == "__main__":
    main()
