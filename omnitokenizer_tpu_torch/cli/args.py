"""Composable argparse flag sets (mirror of `omnitokenizer_tpu.cli.args`),
so the reference's shell recipes run with the module name swapped.

The flag inventories are the JAX package's: the reference's
omnitokenizer.py:694-768 (model), base.py:245-269 (VQ/GAN), data.py:551-577
(data), and the trainer's flags. --ckpt_backend has no default here:
without it the tokenizer trainer writes torch.save checkpoints, with
msgpack the JAX package's train state (training/loop.py); orbax is
refused. The JAX CLIs' multi-host bring-up is parallel/mesh.py's. The
port adds --device: the card ("cuda", the default) or "cpu".
"""

from __future__ import annotations

import argparse

import torch

from ..config import LossConfig, TokenizerConfig, TrainConfig


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs: cuda (default; raises without a "
                        "card) or cpu")
    return p


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--tokenizer", type=str, default="omnitokenizer")
    p.add_argument("--embedding_dim", type=int, default=512)
    p.add_argument("--n_codes", type=int, default=8192)
    p.add_argument("--codebook_dim", type=int, default=8)
    p.add_argument("--n_hiddens", type=int, default=512)
    p.add_argument("--image_channels", type=int, default=3)
    p.add_argument("--patch_size", type=int, default=8)
    p.add_argument("--temporal_patch_size", type=int, default=4)
    p.add_argument("--patch_embed", type=str, default="linear", choices=["linear", "cnn"])
    p.add_argument("--enc_block", type=str, default="ttww")
    p.add_argument("--dec_block", type=str, default="tttt")
    p.add_argument("--twod_window_size", type=int, default=8)
    p.add_argument("--spatial_depth", type=int, default=4)
    p.add_argument("--temporal_depth", type=int, default=4)
    p.add_argument("--spatial_pos", type=str, default="rel", choices=["rel", "rope"])
    p.add_argument("--causal_in_temporal_transformer", action="store_true")
    p.add_argument("--causal_in_peg", action="store_true")
    p.add_argument("--defer_temporal_pool", action="store_true")
    p.add_argument("--defer_spatial_pool", action="store_true")
    p.add_argument("--dim_head", type=int, default=64)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--ff_mult", type=float, default=4.0)
    p.add_argument("--attn_dropout", type=float, default=0.0)
    p.add_argument("--ff_dropout", type=float, default=0.0)
    p.add_argument("--gen_upscale", type=int, default=None)
    p.add_argument("--initialize_vit", action="store_true")
    p.add_argument("--use_vae", action="store_true")
    p.add_argument("--kl_weight", type=float, default=1e-6)
    p.add_argument("--l2_code", action="store_true")
    p.add_argument("--use_external_codebook", action="store_true")
    p.add_argument("--codebook_type", type=str, default="vq", choices=["vq"],
                   help="external-codebook family; the reference implements "
                        "only 'vq' (omnitokenizer.py:131-140)")
    p.add_argument("--no_random_restart", action="store_true")
    p.add_argument("--restart_thres", type=float, default=1.0)
    p.add_argument("--commitment_weight", type=float, default=0.25)
    p.add_argument("--norm_type", type=str, default="group", choices=["batch", "group"])
    p.add_argument("--fp32_quant", action=argparse.BooleanOptionalAction, default=True,
                   help="accepted as the JAX CLI accepts it; like the JAX "
                        "tokenizer_config_from, the config keeps its default "
                        "(an f32 pre-VQ projection on the bf16 path)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute path")
    p.add_argument("--fp16", action="store_true",
                   help="accepted for recipe compat; maps to the bf16 path, as in "
                        "the JAX package")
    return p


def add_loss_args(p: argparse.ArgumentParser):
    p.add_argument("--recon_loss_type", type=str, default="l1", choices=["l1", "l2"])
    p.add_argument("--l1_weight", type=float, default=4.0)
    p.add_argument("--perceptual_weight", type=float, default=0.0)
    p.add_argument("--video_perceptual_weight", type=float, default=0.0)
    p.add_argument("--image_gan_weight", type=float, default=1.0)
    p.add_argument("--video_gan_weight", type=float, default=1.0)
    p.add_argument("--gan_feat_weight", type=float, default=0.0)
    p.add_argument("--logitslaplace_weight", type=float, default=0.0)
    p.add_argument("--disc_loss_type", type=str, default="hinge", choices=["hinge", "vanilla"])
    p.add_argument("--disc_channels", type=int, default=64)
    p.add_argument("--disc_layers", type=int, default=3)
    p.add_argument("--discriminator_iter_start", type=int, default=0)
    p.add_argument("--sigmoid_in_disc", action="store_true")
    p.add_argument("--activation_in_disc", type=str, default="leaky_relu")
    p.add_argument("--apply_blur", action="store_true")
    p.add_argument("--apply_noise", action="store_true")
    p.add_argument("--apply_diffaug", action="store_true")
    p.add_argument("--apply_allframes", action="store_true")
    return p


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--lr_min", type=float, default=0.0)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--warmup_lr_init", type=float, default=0.0)
    p.add_argument("--max_steps", type=int, default=500_000)
    p.add_argument("--dis_lr_multiplier", type=float, default=1.0)
    p.add_argument("--dis_minlr_multiplier", action="store_true")
    p.add_argument("--dis_warmup_steps", type=int, default=0)
    p.add_argument("--grad_accumulates", type=int, default=1)
    p.add_argument("--grad_clip_val", type=float, default=1.0)
    p.add_argument("--grad_clip_val_disc", type=float, default=1.0)
    p.add_argument("--disloss_check_thres", type=float, default=None)
    p.add_argument("--ema_advances_per_step", type=int, default=2,
                   choices=[1, 2],
                   help="codebook-EMA advances per G+D step: 2 = the "
                        "reference's cadence (its omnitokenizer.py:548,582); "
                        "1 = one advance a step")
    p.add_argument("--perloss_check_thres", type=float, default=None)
    p.add_argument("--recloss_check_thres", type=float, default=None)
    p.add_argument("--resolution_scale", default=None, nargs="+", type=float)
    p.add_argument("--default_root_dir", type=str, default="./runs/omnitokenizer")
    p.add_argument("--ckpt_backend", type=str, default=None, choices=["msgpack", "orbax"],
                   help="vqgan_train's checkpoint format: torch.save .pt (default), msgpack "
                        "(the JAX package's TokenizerTrainState file, step_*.msgpack), or "
                        "orbax (refused: tensorstore)")
    p.add_argument("--pretrained", type=str, default=None)
    p.add_argument("--init_vgen", type=str, default=None)
    p.add_argument("--inflation_pe", action="store_true",
                   help="accepted for recipe compat (vqgan_train.py:54 passes "
                        "it to inflate_gen, whose body never reads it)")
    p.add_argument("--init_vdis", type=str, default=None)
    p.add_argument("--no_init_idis", action="store_true")
    p.add_argument("--freeze_trans", action="store_true")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--num_nodes", type=int, default=1)
    p.add_argument("--gpus", type=int, default=0)
    p.add_argument("--sync_batchnorm", action="store_true")
    p.add_argument("--progress_bar_refresh_rate", type=int, default=50)
    # the reference's WandbLogger (vqgan_train.py:149); an offline run
    # directory without the wandb package (utils/wandb_logger.py)
    p.add_argument("--wandb_project", type=str, default=None)
    return p


def add_data_args(p: argparse.ArgumentParser):
    p.add_argument("--loader_type", type=str, default="joint", choices=["sep", "joint"])
    p.add_argument("--data_path", type=str, nargs="+", default=["./data"])
    p.add_argument("--train_datalist", type=str, nargs="+", default=["none"])
    p.add_argument("--val_datalist", type=str, nargs="+", default=["none"])
    p.add_argument("--batch_size", type=int, nargs="+", default=[8])
    p.add_argument("--sample_ratio", type=float, nargs="+", default=None)
    p.add_argument("--force_alternation", action="store_true")
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--data_worker_mode", type=str, default="thread",
                   choices=["thread", "process"],
                   help="process = spawn-pool decode workers (the analogue "
                        "of torch DataLoader num_workers, the reference's "
                        "data.py:512-535)")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--sequence_length", type=int, default=17)
    p.add_argument("--fps", type=int, default=-1)
    p.add_argument("--resizecrop", action="store_true")
    p.add_argument("--sample_every_n_frames", type=int, default=1)
    p.add_argument("--downsample", nargs="+", type=int, default=[4, 8, 8])
    p.add_argument("--smap_cond", type=int, default=0)
    # special dataset families (reference data.py:430-489 'sep' routing)
    p.add_argument("--vtokens", action="store_true",
                   help="data_path is a pre-tokenized HDF5 (HDF5Dataset_vtokens)")
    p.add_argument("--vtokens_pos", action="store_true",
                   help="use 3D positional crop boxes with --vtokens")
    p.add_argument("--spatial_length", type=int, default=15,
                   help="spatial crop for --vtokens grids")
    p.add_argument("--image_folder", action="store_true",
                   help="data_path holds per-frame image folders (FrameDataset)")
    p.add_argument("--stft_data", action="store_true",
                   help="data_path holds paired stft+video npz (StftDataset)")
    p.add_argument("--smap_only", action="store_true",
                   help="train on segmentation maps instead of frames")
    p.add_argument("--text_cond", action="store_true",
                   help="HDF5 with caption strings (HDF5Dataset_text); on a "
                        "coinrun dir: auto/manual captions -> BPE ids "
                        "(reference get_text_desc, coinrun_data.py:7-14)")
    p.add_argument("--text_seq_len", type=int, default=None,
                   help="caption token length; defaults per dataset family "
                        "like the reference: 77 for HDF5/CLIP text, 256 for "
                        "coinrun (its CoinRunDataset default)")
    p.add_argument("--text_path", type=str, default=None,
                   help="JSON of manual captions keyed by clip id "
                        "(coinrun_data.py:161-170); auto-captions otherwise")
    p.add_argument("--data_path2", type=str, default=None,
                   help="second HDF5 for --smap_cond pairing")
    p.add_argument("--asset_root", type=str, default=None,
                   help="coinrun sprite assets dir (default <data_path>/assets)")
    p.add_argument("--padding_type", type=str, default="replicate",
                   help="SamePad conv padding (legacy CNN VQGAN, base.py:251)")
    return p


def normalize_precision(args):
    """--fp16 recipe compat: the JAX package maps it to its bf16 path, and so
    does the port."""
    if getattr(args, "fp16", False) and not getattr(args, "bf16", False):
        print("[args] --fp16 requested: using the bf16 compute path")
        args.bf16 = True
    return args


def tokenizer_config_from(args) -> TokenizerConfig:
    return TokenizerConfig(
        embedding_dim=args.embedding_dim, n_codes=args.n_codes,
        codebook_dim=args.codebook_dim, resolution=args.resolution,
        sequence_length=args.sequence_length, image_channels=args.image_channels,
        patch_embed=args.patch_embed, patch_size=args.patch_size,
        temporal_patch_size=args.temporal_patch_size,
        defer_temporal_pool=args.defer_temporal_pool,
        defer_spatial_pool=args.defer_spatial_pool,
        enc_block=args.enc_block, dec_block=args.dec_block,
        spatial_depth=args.spatial_depth, temporal_depth=args.temporal_depth,
        twod_window_size=args.twod_window_size, spatial_pos=args.spatial_pos,
        causal_in_temporal_transformer=args.causal_in_temporal_transformer,
        causal_in_peg=args.causal_in_peg, dim_head=args.dim_head,
        heads=args.heads, ff_mult=args.ff_mult, norm_type=args.norm_type,
        gen_upscale=args.gen_upscale, use_vae=args.use_vae,
        l2_code=args.l2_code, use_external_codebook=args.use_external_codebook,
        no_random_restart=args.no_random_restart, restart_thres=args.restart_thres,
        commitment_weight=args.commitment_weight, kl_weight=args.kl_weight,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )


def loss_config_from(args) -> LossConfig:
    return LossConfig(
        recon_loss_type=args.recon_loss_type, l1_weight=args.l1_weight,
        perceptual_weight=args.perceptual_weight,
        video_perceptual_weight=args.video_perceptual_weight,
        image_gan_weight=args.image_gan_weight,
        video_gan_weight=args.video_gan_weight,
        gan_feat_weight=args.gan_feat_weight,
        logitslaplace_weight=args.logitslaplace_weight,
        disc_loss_type=args.disc_loss_type, disc_channels=args.disc_channels,
        disc_layers=args.disc_layers,
        discriminator_iter_start=args.discriminator_iter_start,
        sigmoid_in_disc=args.sigmoid_in_disc,
        activation_in_disc=args.activation_in_disc,
        apply_blur=args.apply_blur, apply_noise=args.apply_noise,
        apply_diffaug=args.apply_diffaug, apply_allframes=args.apply_allframes,
    )


def train_config_from(args) -> TrainConfig:
    return TrainConfig(
        lr=args.lr, lr_min=args.lr_min, warmup_steps=args.warmup_steps,
        warmup_lr_init=args.warmup_lr_init, max_steps=args.max_steps,
        dis_lr_multiplier=args.dis_lr_multiplier,
        dis_minlr_multiplier=args.dis_minlr_multiplier,
        dis_warmup_steps=args.dis_warmup_steps,
        grad_accumulates=args.grad_accumulates,
        grad_clip_val=args.grad_clip_val,
        grad_clip_val_disc=args.grad_clip_val_disc,
        disloss_check_thres=args.disloss_check_thres,
        perloss_check_thres=args.perloss_check_thres,
        recloss_check_thres=args.recloss_check_thres,
        resolution_scale=args.resolution_scale,
        sample_ratio=args.sample_ratio,
        force_alternation=args.force_alternation,
        seed=args.seed,
        freeze_trans=getattr(args, "freeze_trans", False),
        ema_advances_per_step=getattr(args, "ema_advances_per_step", 2),
    )
