"""LM training CLI (mirror of `omnitokenizer_tpu.cli.transformer_train`, the
reference's transformer_train.py): the GPT over a frozen tokenizer's codes,
AdamW with the decay/no-decay split and a warmup-cosine schedule,
checkpoints with auto-resume.

    python -m omnitokenizer_tpu_torch.cli.transformer_train --vqvae TOKENIZER.ckpt \\
        --data_path DIR --train_datalist LIST --default_root_dir RUNS \\
        --starts_with_sos --class_first --sequence_length 1 --bf16 [--device cpu]

--vqvae takes a reference .ckpt, the port's .pt or the JAX package's
.msgpack (with its .cfg.json sidecar). Checkpoints land in
<default_root_dir>/checkpoints/step_*.pt (the GPT's state_dict, the
optimizer state, the step) every 3000 steps and at the end; a run resumes
from the newest, written by rank 0 alone and holding the full model
(training/lm_loop.py), so a run resumes under any layout. The card unless
--device cpu. On N processes (torchrun, or OMNITOK_COORD / OMNITOK_NPROCS /
OMNITOK_PROC_ID; parallel/mesh.py) the run is data-parallel, each process
loading its strided share of the batches; --model_parallel M puts M ranks
on a tensor-parallel group (parallel/tp.py) and --pipeline_stages S makes
S ranks a GPipe pipeline of --microbatches microbatches (parallel/pp.py),
the data axis taking the rest.

Text conditioning: --text_cond --cond_stage_key text on a CoinRun
directory (its auto-captions, or --text_path's) or a caption HDF5 puts the
caption's CLIP BPE ids (--text_seq_len wide; 256 for CoinRun, 77 for
HDF5) in the sequence as the condition column, with --class_cond_dim 49408
(CLIP's vocabulary) and a --block_size that holds sos + the column + the
codes. The BPE merge table is read from data/text_tokenizer.py's VOCAB_DIR.
--wandb_project mirrors the metrics into a wandb run (an offline run
directory under <default_root_dir>/wandb without the wandb package).

Refused, each where the JAX CLI goes wrong: --cond_stage_key stft (the JAX
CLI loads --stft_vqvae but conditions on the batch's label, which
StftDataset gives as -1: it never reads the stft), --vtokens (the JAX CLI
would send the pre-tokenized code grids through the tokenizer as pixels),
and --ckpt_backend (vqgan_train's; the LM's checkpoints are .pt).
"""

from __future__ import annotations

import argparse

import torch

from . import args as A


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("transformer_train")
    A.add_model_args(p)
    A.add_train_args(p)
    A.add_data_args(p)
    A.add_device_arg(p)
    p.add_argument("--vqvae", type=str, required=True, help="tokenizer ckpt")
    p.add_argument("--unconditional", action="store_true")
    p.add_argument("--starts_with_sos", action="store_true")
    p.add_argument("--class_first", action="store_true")
    p.add_argument("--p_drop_cond", type=float, default=None)
    p.add_argument("--block_size", type=int, default=1025)
    p.add_argument("--n_layer", type=int, default=24)
    p.add_argument("--n_head", type=int, default=16)
    p.add_argument("--n_embd", type=int, default=1536)
    p.add_argument("--n_unmasked", type=int, default=0)
    p.add_argument("--transformer_dropout", type=float, default=0.0)
    p.add_argument("--class_cond_dim", type=int, default=1000)
    p.add_argument("--pkeep", type=float, default=1.0)
    p.add_argument("--first_stage_key", type=str, default="video")
    p.add_argument("--stft_vqvae", type=str, default=None,
                   help="second tokenizer ckpt for 'stft' conditioning; refused")
    p.add_argument("--vocab_size", type=int, default=None,
                   help="override the GPT vocab (default: the tokenizer's codes + the "
                        "conditioning)")
    p.add_argument("--first_stage_vocab_size", type=int, default=None,
                   help="override the first-stage code vocab")
    p.add_argument("--cond_stage_key", type=str, default="label")
    p.add_argument("--sample_every_n_latent_frames", type=int, default=0)
    p.add_argument("--base_lr", type=float, default=4.5e-6)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--pipeline_stages", type=int, default=1,
                   help="GPipe pipeline stages (ranks of one pipeline)")
    p.add_argument("--microbatches", type=int, default=2,
                   help="GPipe microbatches a step; read only with --pipeline_stages")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel size (ranks of one Megatron group)")
    return p


def build_model(args):
    """The Net2NetTransformer of the flags: the tokenizer from its
    checkpoint, a GPT at minGPT's init from --seed, the vocabulary as the
    JAX CLI computes it."""
    from ..config import GPTConfig, Net2NetConfig
    from ..models.net2net import Net2NetTransformer
    from ..models.wrapper import OmniTokenizerVQGAN

    tok = OmniTokenizerVQGAN.load_from_checkpoint(args.vqvae, device=args.device)
    first_stage_vocab = args.first_stage_vocab_size or tok.cfg.n_codes
    vocab = first_stage_vocab + (0 if args.unconditional else args.class_cond_dim)
    if args.starts_with_sos and not args.unconditional:
        vocab += 1
    if args.vocab_size:
        if args.vocab_size < vocab:
            raise ValueError(f"--vocab_size {args.vocab_size} < required {vocab}")
        vocab = args.vocab_size
    gpt_cfg = GPTConfig(
        vocab_size=vocab, block_size=args.block_size, n_layer=args.n_layer,
        n_head=args.n_head, n_embd=args.n_embd, embd_pdrop=args.transformer_dropout,
        resid_pdrop=args.transformer_dropout, attn_pdrop=args.transformer_dropout,
        n_unmasked=args.n_unmasked, dtype=torch.bfloat16 if args.bf16 else torch.float32)
    n2n_cfg = Net2NetConfig(
        gpt=gpt_cfg, class_cond_dim=args.class_cond_dim, unconditional=args.unconditional,
        starts_with_sos=args.starts_with_sos, class_first=args.class_first,
        p_drop_cond=args.p_drop_cond, pkeep=args.pkeep,
        first_stage_vocab_size=first_stage_vocab, cond_stage_key=args.cond_stage_key,
        sample_every_n_latent_frames=args.sample_every_n_latent_frames)
    return Net2NetTransformer(n2n_cfg, tok, seed=args.seed)


def check_data(args) -> None:
    """Refuse the flag sets the JAX CLI accepts but trains wrongly, and a
    condition the data does not carry."""
    from ..data.loader import CLASSLESS, special_family

    if args.cond_stage_key == "stft":
        raise NotImplementedError(
            "--cond_stage_key stft is refused: the JAX CLI loads --stft_vqvae but conditions "
            "on the batch's label, which StftDataset gives as -1, so it never reads the stft "
            "(omnitokenizer_tpu/cli/transformer_train.py:219-224)")
    if args.vtokens:
        raise NotImplementedError(
            "--vtokens is refused: the JAX CLI has no vtokens branch and would send the "
            "dataset's int code grids through the tokenizer as pixels "
            "(omnitokenizer_tpu/cli/transformer_train.py:215-218)")
    if args.ckpt_backend:
        raise ValueError("--ckpt_backend is vqgan_train's; transformer_train writes .pt "
                         "checkpoints (training/lm_loop.py)")
    family = special_family(args)
    if args.cond_stage_key == "text" and not (args.text_cond
                                               and family in ("coinrun", "text_cond")):
        raise ValueError("--cond_stage_key text needs captions: --text_cond on a CoinRun "
                         "directory or a caption HDF5")
    if args.cond_stage_key == "label" and not args.unconditional and family in CLASSLESS:
        raise ValueError(f"the {family!r} dataset family gives no class (label -1): train it "
                         "with --unconditional, or --cond_stage_key text on captions")


def main(argv=None):
    from ..data.loader import VideoData
    from ..parallel import mesh, tp
    from ..training.lm_loop import make_lm_optimizer, setup_parallel, train_lm

    args = A.normalize_precision(build_parser().parse_args(argv))
    if args.pipeline_stages > 1 and args.model_parallel > 1:
        raise ValueError("--pipeline_stages and --model_parallel are mutually exclusive")
    if args.model_parallel > 1:
        tp.check_layout(args.n_head, args.n_embd, args.model_parallel)
    if args.pipeline_stages > 1 and args.n_layer % args.pipeline_stages:
        raise ValueError("n_layer must divide by --pipeline_stages")
    check_data(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    inner = max(args.model_parallel, args.pipeline_stages)
    mesh.init_distributed(args.device)
    if mesh.world() % inner:
        raise ValueError(f"{mesh.world()} processes do not divide into groups of {inner} "
                         "(--model_parallel / --pipeline_stages)")
    n2n = build_model(args)
    opt = make_lm_optimizer(n2n.gpt, lr=args.lr, max_steps=args.max_steps,
                            warmup_steps=args.warmup_steps, warmup_lr_init=args.warmup_lr_init,
                            lr_min=args.lr_min, grad_clip_val=args.grad_clip_val,
                            weight_decay=args.weight_decay, accumulates=args.grad_accumulates)
    par = setup_parallel(n2n, opt, args.model_parallel, args.pipeline_stages, args.microbatches)
    # a data row's ranks read the same batches; the rows stride the stream
    loader = VideoData(args, train=True, process_index=par.data_rank,
                       process_count=par.data_size)
    return train_lm(n2n, opt, iter(loader), args.default_root_dir, args.max_steps,
                    seed=args.seed, par=par, wandb_project=args.wandb_project,
                    wandb_config=vars(args))


if __name__ == "__main__":
    main()
