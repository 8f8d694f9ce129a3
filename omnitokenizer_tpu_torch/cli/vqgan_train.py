"""Tokenizer training CLI (mirror of `omnitokenizer_tpu.cli.vqgan_train`, the
reference's vqgan_train.py): the reference's flags, an optional pretrained
load with weight inflation, auto-resume, the GAN step over the loader.

    python -m omnitokenizer_tpu_torch.cli.vqgan_train --patch_size 8 ... \\
        --data_path DIR --train_datalist LIST --default_root_dir RUNS [--device cpu]

Checkpoints land in <default_root_dir>/checkpoints/step_*.pt (with
--ckpt_backend msgpack, step_*.msgpack in the JAX package's train-state
format, which the JAX CLI resumes from too); a run resumes from the
newest, and `vqgan_eval --vqgan_ckpt` reads them. --wandb_project mirrors
the metrics into a wandb run (offline without the wandb package).
`--pretrained` takes a reference Lightning `.ckpt`, a port `.pt` or a JAX
package `.msgpack`; with `--use_vae --kl_weight 1e-6 --init_vgen keep
--init_vdis keep` from a VQ stage it is the recipe's stage 3
(scripts/recons/train.sh), the VAE finetune. The card unless --device
cpu. On N processes (torchrun, or OMNITOK_COORD / OMNITOK_NPROCS /
OMNITOK_PROC_ID; parallel/mesh.py) the run is data-parallel, as the
reference's DDP and the JAX CLI's ('data',) mesh: each process loads
--batch_size clips of its strided share of the data, the step is the
one-process step on the N processes' batches together
(training/trainer.py), and rank 0 writes the checkpoints.
"""

from __future__ import annotations

import argparse

from . import args as A


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vqgan_train")
    A.add_model_args(p)
    A.add_loss_args(p)
    A.add_train_args(p)
    A.add_data_args(p)
    A.add_device_arg(p)
    return p


def main(argv=None):
    from ..data.loader import VideoData
    from ..parallel import mesh
    from ..training.loop import check_ckpt_backend, train_tokenizer
    from ..training.trainer import TokenizerTrainer
    from ..utils.inflate import load_pretrained_into_state

    args = A.normalize_precision(build_parser().parse_args(argv))
    check_ckpt_backend(args.ckpt_backend)
    mesh.init_distributed(args.device)
    trainer = TokenizerTrainer(A.tokenizer_config_from(args), A.loss_config_from(args),
                               A.train_config_from(args), device=args.device,
                               group=mesh.world_group())
    rank, world = mesh.rank(), mesh.world()
    loader = VideoData(args, train=True, process_index=rank, process_count=world)
    try:
        val_loader = VideoData(args, train=False, process_index=rank, process_count=world)
    except (ValueError, OSError) as e:
        print(f"no validation loader ({e}); skipping val passes")
        val_loader = None

    state = None
    if args.pretrained:
        state = load_pretrained_into_state(
            trainer, args.pretrained, init_vgen=args.init_vgen, init_vdis=args.init_vdis,
            no_init_idis=args.no_init_idis, seed=args.seed)

    return train_tokenizer(
        trainer, iter(loader), args.default_root_dir, max_steps=args.max_steps, seed=args.seed,
        initial_state=state, val_batches=iter(val_loader) if val_loader is not None else None,
        wandb_project=args.wandb_project, wandb_config=vars(args), ckpt_backend=args.ckpt_backend)


if __name__ == "__main__":
    main()
