#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  0. the card: nvidia-smi name and power limit, versions, TF32 off;
  1. build every CUDA kernel from omnitokenizer_tpu_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch version at the shapes each path
     gives it (B=4, 17x256^2 clips: 5 x 32 x 32 tokens for the flagship and
     the f32 VAE, 9 x 32 x 32 for the stage-1 tokenizer), with its time
     (also with its calls issued as a caller issues them, so the host's
     share shows), its plain version's time, the least time the card could
     take (bound), for mha, cosine_mha and small_n_attention the time of
     PyTorch's own attention call on inputs made ahead (and the name of the
     kernel it runs; mha on the views the attention module hands over, with
     no copies), cosine_mha also at a ragged N = 784 (28^2, a 224^2 image at
     patch 8: no path's shape), and as chain the time of the
     module's own plain bf16 route: layer_norm and cuBLAS bf16 F.linear
     for ln_qkv and geglu_ff; [RoPE], F.normalize and one SDPA call for
     cosine_mha and small_n_attention; the f32 distance argmin (TF32 off)
     for vq_argmin (also at the CNN VQGAN's 16384 x 256 rows against 2048
     codes, and at a ragged 16384 x 100 against 2048 x 100, no path's
     shape); and the LM's causal flash forward and backward at the
     training shape (8, 16, 1025, 96), at the long-sequence recipes'
     (4, 16, 5121, 96), where they are compute-bound, and at phase 17b's
     text-conditioned shape (4, 16, 5376, 96), on the (B, T, H, D)
     projections' views, beside SDPA (is_causal) forward and forward +
     backward, two backward runs bitwise equal (where the plain twins' f32
     scores do not fit, they are held and timed on batch 0);
  3. the bf16 VQ round trip of imagenet_k600_config() at full width through
     OmniTokenizerVQGAN.reconstruct, with the launch count of every kernel,
     checked against the plain bf16 path on the same weights, and frames/s
     of both paths;
  4. a small f32 round trip on the card against the same model on the CPU;
  5. the f32 VAE of imagenet_k600_config(use_vae=True) at full width through
     DiffusionVAEAdapter (the DiT/Latte seam): encode -> decode of B=4 clips
     and B=4 images, launch counts, the kernel path against the plain path,
     frames/s and peak memory; then a small f32 VAE on the card against the
     CPU with the same noise;
  6. the bf16 round trip of imagenet_only_config() (temporal patch 2, 'rel'
     positions: 9 latent frames, causal temporal attention through mha's
     small branch on the attention module's views, with no copies) at full
     width, with phase 3's checks;
  7. the bf16 round trip of the flagship widened to width 768 with heads of
     128 (B=1, full depth: ln_qkv and geglu_ff at D = 768, cosine_mha and
     small_n_attention at a head width of 128), with phase 3's checks; then
     each of its kernels against its plain version at its shapes, as in
     phase 2, and vq_argmin against its plain version at a code dim of 6;
  8. the GAN training step of the flagship in bf16 (B=4, 17x256^2 clips,
     the losses of bench.py's train_gan mode, random weights from seed 0)
     through train_tokenizer: one warm-up step that writes a checkpoint,
     then a run that resumes from it for 6 more steps, 5 of them timed;
     the launches of each kernel a step (mha none), every loss finite,
     every parameter of G and D and the codebook moved, the checkpoint
     equal to the state it saved; the inference wrappers refusing a
     grad-requiring input; each of the four training routes (kernels as
     the primal, the plain math recomputed as the backward:
     ops/kernel_grad.py) at the flagship's shapes against its plain math,
     primal and gradients, timed forward and forward + backward; one whole
     step of the kernel route against the plain route from the same state
     (losses, gradient norms, the reconstruction); and a step with a
     wiring fault (q and k projections swapped in one block of the kernel
     route) that this comparison must fail;
  9. the eval entry point, vqgan_eval.evaluate, at the released tokenizer's
     eval flags (scripts/recons/eval_video.sh: f32, B=8 clips of 17x256^2,
     4 batches from an in-memory dataset through the port's DataLoader):
     (a) a Lightning-style checkpoint of the flagship in the reference's key
     scheme, random values from seed 0, loaded on the card through
     OmniTokenizerVQGAN.load_from_checkpoint, every tensor one the file
     holds; (b) the f32 eval, its launches a batch (mha 6, vq_argmin 1),
     clips/s, peak memory, where its time goes, and its round trip against
     the plain route (indices, the decode of the same indices); (c) the same
     with --bf16 (the flagship's launches and the bf16 slice bars against
     the f32 model of the same checkpoint); (d) --use_vae in f32 (mha 6); (e)
     the FVD and FID feature extractors with random weights, card against
     CPU, timed; then mha's f32 flash branch and vq_argmin at the eval's
     shapes against their plain versions;
 10. LM synthesis serving: the flagship LM's width (1536, 16 heads of 96)
     at 6 of its 24 layers (a depth cut that keeps the whole run inside its
     time), class-conditional CFG images and K600 frame prediction at
     scripts/lm_gen/'s flags;
 11. diffusion synthesis behind the f32 VAE of phase 5 (DiffusionVAEAdapter),
     random weights from seed 0 with every tensor filled, DiT and Latte at
     their XL widths and 8 of their 28 blocks (a depth cut, as phase
     10's): (a) DiT-XL/2 (B=2) and
     Latte-XL/2-omnitokenizer (B=1) f32 forwards on the card against the
     CPU, bf16 against f32, and 10 DDIM steps card against CPU; (b) DiT
     class-conditional sampling at the sample CLI's defaults (250 respaced
     DDPM steps, CFG 4.0 on 3 channels, B=8) in f32 and bf16, decoded; (c)
     Latte (B=2 clips, CFG on 4 channels) in bf16 over 250 steps and f32 over
     50, decoded; each with ms a step beside its FLOP bound, images or clips
     per second, peak memory, device kernels a step, mha's launches in the
     decode and the decode against the VAE's plain route; (d) the DiT (B=32
     images) and Latte (B=4 clips) training steps through dit_train.train on
     pixels the VAE encodes each step: a warm-up step and its checkpoint, a
     resumed run of 6 steps (5 timed), every parameter moved, the EMA;
 12. LM training: the flagship LM at scripts/lm_train/train_imagenet_class.sh's
     flags (24 x 1536, B=8, bf16 on f32 masters, random weights from seed 0)
     on 256^2 images encoded by the bf16 flagship tokenizer each step: one
     step of the kernel route (the flash kernels) against the plain route
     (the materialized scores) on the same batch and weights (loss,
     gradient norms), the flash forward (1e-2) and backward (2e-2) against
     their plain versions on that step's first-layer q, k, v and output
     gradient, 2 warm-up and 5 timed steps of each route (ms a
     step, tokens/s, peak memory, the share of the FLOP bound, launches a
     step), every parameter moved, a profiled step by kernel group; then
     train_lm at full width and 2 layers: 2 steps and a resume to 3 against
     an unbroken 3-step run;
 13. checkpoints in, scores out: (a) the flagship tokenizer with random
     weights from seed 0 written in the JAX package's msgpack format with
     its .cfg.json sidecar (utils/msgpack_io.py, convert.state_dict_to_jax),
     loaded on the card through load_from_checkpoint: its bf16 round trip
     of B=4 clips bit-equal to the source model's, the five kernels'
     launches, load seconds beside convert_ckpt's .pt; (b) the LM at 24 x
     1536 written as the JAX CLI's (params, opt_state, step), loaded through
     transformer_eval's loader: logits bit-equal; (c) DiT-XL/2 at full width
     and 2 blocks written as a DiffusionTrainState, read through
     dit_sample's loader from params and ema_params: forwards bit-equal, 10
     sampling steps decoded through the f32 VAE (mha 4); (d) metrics_eval
     over .npz directories of (a)'s clips and reconstructions, every metric,
     on the card against --device cpu; (e) precision_recall on 50000 x 2048
     f32 features timed beside its bound;
 14. the tokenizer's variants and text-to-video: (a) five bf16 variants at
     the flagship's width with every tensor random and BatchNorm's running
     statistics off 0 and 1 (einsum on imagenet_only_config() and on the
     flagship, patch_embed='cnn', both deferred pools at B=1, enc 'ttaw' /
     dec 'nttt'), each round trip's launches asserted (no attention kernel
     on a biased call) and held against its plain route at phase 3's bars
     with frames/s and peak memory; the new paths' kernel shapes against
     their plain versions; the plain attention of the deferred and biased
     spatial calls timed beside SDPA; a small f32 cnn and einsum model card
     against CPU; a cnn checkpoint as a reference .ckpt and as a JAX
     msgpack with batch_stats, each loaded into a round trip bit-equal to
     the source's. (b) LatteT2V at PixArt-alpha's widths with the JAX
     CLI's defaults (28 x 1152, 4096-channel captions of 120 tokens from
     the byte fallback, 16 frames of 32^2 latents, 8 -> 16 channels): f32
     at 2 layers card against CPU, bf16 against f32 at full depth, ddim50
     with CFG 7.5 on one prompt in bf16 (ms a step beside its FLOP bound,
     clips/s, peak, kernels a step, device ms by group), the decode through
     the f32 VAE (mha 8) against its plain route, and
     latte_t2v_sample.main end to end from a JAX msgpack through the VAE;
 15. the last tokenizer pieces: (a) the recipe's stage 3 (scripts/recons/
     train.sh), the f32 VAE finetune of imagenet_k600_config(use_vae=True)
     with kl_weight 1e-6 and the recipe's losses and schedule, seeded
     through load_pretrained_into_state (init_vgen keep, init_vdis keep)
     from a random stage-2 VQ checkpoint in the reference's names: 3 video
     steps at B=4 x 17x256^2 and 1 image step at B=8 x 256^2 through
     train_tokenizer on the kernel route (mha as the primal of the
     generator pass, 6 a step) and on the plain route
     (OMNITOK_TRAIN_KERNEL_FWD=0, mha 0), ms a step, peak memory, the
     first step's losses within the f32 card bar of each other and its
     gradient norms within the training bar, the kernel route's first mha
     call against mha_plain on its inputs; (b) the CNN VQGAN at
     load_cnn_vqgan_checkpoint's defaults (240 wide, downsample (4, 4, 4),
     2048 codes of 256, group norm) on B=4 clips of 16x128^2: launches
     (vq_argmin 1), indices against vq_argmin_plain on the same latents
     (near-ties counted), the decodes of both index sets, frames/s and
     peak, a small one card against CPU; (c) the quantizers at working
     sizes (16384 rows; VQ of 8192 codes of 256, euclidean and cosine,
     kmeans held step by step, one training call's EMA; FSQ (8, 8, 8, 5, 5,
     5); LFQ of 2^14 codes; the residual stacks 2 deep, a depth cut for
     time) card against CPU.
 16. parallelism over torch.distributed, in child processes: (a) a world of
     one over NCCL: the flagship GAN step bit-equal to the step with no
     group, the codebook step twice bit-equal, the class-CFG decode of
     transformer_eval's --model_parallel 1 path on CUDA graphs; (b) two
     ranks, over NCCL one card a rank where the host has two cards or more,
     else both on the one card over gloo: TP=2 and PP=2 steps of the
     flagship LM at 4 of its 24 layers, a TP=2 class-CFG decode (CUDA
     graphs under NCCL, against the eager TP decode and the one-process
     greedy sampler), vq_argmin_sharded, the DP=2 GAN step with BatchNorm
     discriminators; each against one process.
 17. the host pieces: (a) each special dataset family (HDF5 clips, HDF5
     captions, smap pairs, vtokens code grids, frame folders, stft pairs,
     CoinRun with auto-captions) written at the flagship's input size
     (17 x 256^2 uint8; vtokens at its 5 x 32 x 32 code grid) and 32 clips
     read through the port's VideoData, timed (the HDF5 families where the
     host has h5py); (b) text-conditioned LM training through
     transformer_train.main on the card over a CoinRun directory it writes
     (game JSONs, sprites, a BPE merge table, auto-captions): B=4 clips of
     17 x 256^2 encoded by the bf16 flagship tokenizer (random weights,
     seed 0), captions of 256 BPE ids, the LM at train_ucf.sh's widths
     (1536, 16 heads of 96, block 5377 = sos + 256 + 5120 codes) at 6 of
     its 24 layers, --bf16; launches a step (flash 6 + 6 and the encode's),
     the caption ids in the sequence after sos, finite losses and gradient
     norms, ms a step after 2 warm-up steps, tokens/s, peak memory, the
     share of the FLOP bound; the same step on the first batch with no
     loader thread running, and one profiled; then the first step's batch
     and weights at 2 of the layers, kernel route against plain route
     (loss and per-layer gradient norms at phase 12's bars).
 18. sequence parallelism of the tokenizer (parallel/tp.py), two ranks in
     child processes as in 16b (NCCL one card a rank, else gloo on one
     card), each holding 128 of the 256 pixel rows: the bf16 flagship round
     trip (B=4, 17 x 256^2, random weights, seed 0) with launches per rank
     16/14/6/8/1 (cosine_mha on a query block of 512 of 1024 tokens), held
     on rank 0 to the one-process round trip of the same clips (pixels 2e-2
     whole-tensor; indices equal but at near-ties of the SP latents, a
     relative gap of at most 1e-3); the f32 VAE the same way (mha 6 a rank,
     512 queries against 1024 keys; pixels 1e-4); frames/s and peak memory
     per rank and of the one process; one SP round trip profiled through
     utils/profiling.py and utils/trace_analysis.py (kernels by name and by
     the encode / quantize / decode range that launched them, the host
     time in c10d collectives); the JAX dry run's SP forward on the card.
     Phase 2 holds the two query-block kernels against their plain
     versions at those shapes (rows "sp" and "sp_vae").
`--phases 14` (any comma list) runs phases 0, 1 and those alone.
Phase 0 also prints which host data backends load (the native normalize,
the libav decoder, PIL, imageio) and whether h5py is importable.
The line before the last is a JSON object with a row per kernel and shape
(and one per training route); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

B, T, RES = 4, 17, 256  # the flagship serve shape
KERNELS = ("vq_argmin", "ln_qkv", "geglu_ff", "small_n_attention", "cosine_mha", "mha",
           "flash_attn_fwd", "flash_attn_bwd")
# the LM's causal flash attention runs on no tokenizer path
NO_FLASH = {"flash_attn_fwd": 0, "flash_attn_bwd": 0}
# launches in one video round trip of each path
EXPECTED_LAUNCHES = {
    "vq": {"geglu_ff": 16, "ln_qkv": 14, "cosine_mha": 6, "small_n_attention": 8,
           "vq_argmin": 1, "mha": 0, **NO_FLASH},
    # f32: every spatial 't' block's attention (encoder 'ttww' 2, decoder 'tttt' 4);
    # the temporal blocks (N=5) are below mha's N >= 8 and take the plain math
    "vae": {**{k: 0 for k in KERNELS}, "mha": 6},
    # bf16, 9 latent frames: too many for small_n_attention (n <= 8) and causal,
    # which cosine_mha refuses, so the 8 temporal blocks take mha
    "rel": {"geglu_ff": 16, "ln_qkv": 14, "cosine_mha": 6, "small_n_attention": 0,
            "vq_argmin": 1, "mha": 8, **NO_FLASH},
    # the flagship at width 768, heads of 128: the flagship's routes
    "wide": {"geglu_ff": 16, "ln_qkv": 14, "cosine_mha": 6, "small_n_attention": 8,
             "vq_argmin": 1, "mha": 0, **NO_FLASH},
    # a flagship training step: the generator's training forward (every 't'
    # block and feed-forward on the training route: ln_qkv 14, geglu_ff 16,
    # cosine_mha 6, small_n 8, the codebook's search 1), then the second
    # codebook advance's encoder on the inference route (ln_qkv 6, geglu_ff
    # 8, cosine_mha 2, small_n 4, vq_argmin 1); training sdpa is plain, the
    # backward recomputes plain math
    "train": {"geglu_ff": 24, "ln_qkv": 20, "cosine_mha": 8, "small_n_attention": 12,
              "vq_argmin": 2, "mha": 0, **NO_FLASH},
    # a batch of vqgan_eval at the released tokenizer's flags (B=8 clips):
    # f32, the eval scripts' precision: mha in the 6 spatial 't' blocks and
    # the codebook's search; --bf16: the flagship's round trip; --use_vae:
    # the f32 VAE's
    "eval_f32": {**{k: 0 for k in KERNELS}, "mha": 6, "vq_argmin": 1},
    "eval_bf16": {"geglu_ff": 16, "ln_qkv": 14, "cosine_mha": 6, "small_n_attention": 8,
                  "vq_argmin": 1, "mha": 0, **NO_FLASH},
    "eval_vae": {**{k: 0 for k in KERNELS}, "mha": 6},
    # LM generation (phase 10), through the bf16 flagship tokenizer: class-conditional
    # images decode 8 images (the decoder's 4 spatial 't' blocks and 4 temporal blocks at
    # n = 1); frame prediction encodes and decodes 2 clips (a round trip's launches)
    "lm_class": {"geglu_ff": 8, "ln_qkv": 8, "cosine_mha": 4, "small_n_attention": 4,
                 "vq_argmin": 0, "mha": 0, **NO_FLASH},
    "lm_frame": {"geglu_ff": 16, "ln_qkv": 14, "cosine_mha": 6, "small_n_attention": 8,
                 "vq_argmin": 1, "mha": 0, **NO_FLASH},
    # a flagship LM training step (phase 12): the encode of 8 images (the
    # encoder's 2 spatial 't' blocks, its 4 temporal blocks at n = 1, the
    # codebook's search), then the GPT's 24 layers, each one flash forward and
    # one flash backward
    "lm_train": {"geglu_ff": 8, "ln_qkv": 6, "cosine_mha": 2, "small_n_attention": 4,
                 "vq_argmin": 1, "mha": 0, "flash_attn_fwd": 24, "flash_attn_bwd": 24},
    # a stage-3 VAE training step (phase 15a): the generator pass runs the f32
    # VAE on the inference route under autograd, so each spatial 't' block
    # (encoder 2, decoder 4) runs mha as the primal of ops/kernel_grad.py; the
    # backward recomputes the plain math, and a VAE has no codebook
    "vae_train": {**{k: 0 for k in KERNELS}, "mha": 6},
    # the CNN VQGAN's round trip (phase 15b): its codebook's search
    "cnn_vqgan": {**{k: 0 for k in KERNELS}, "vq_argmin": 1},
}
# training-route calls a step (ops/kernel_grad.py): the flat temporal route
# in the 8 temporal blocks, cosine attention in the 6 spatial 't' blocks,
# geglu_ff in the 16 feed-forwards; the spatial small-group route (N = 8)
# is on no path of the flagship
EXPECTED_TRAIN_ROUTES = {"flat": 8, "cosine": 6, "small": 0, "ff": 16}
SOURCES = {
    "vq_argmin": ("omnitokenizer_tpu_torch/csrc/vq_argmin.cu",
                  "omnitokenizer_tpu/ops/pallas/vq_kernel.py:39"),
    "ln_qkv": ("omnitokenizer_tpu_torch/csrc/ln_qkv.cu",
               "omnitokenizer_tpu/ops/pallas/ln_qkv.py:43"),
    "geglu_ff": ("omnitokenizer_tpu_torch/csrc/geglu_ff.cu",
                 "omnitokenizer_tpu/ops/pallas/geglu_ff.py:51"),
    "small_n_attention": ("omnitokenizer_tpu_torch/csrc/small_attn.cu",
                          "omnitokenizer_tpu/ops/pallas/small_attn.py:98"),
    "cosine_mha": ("omnitokenizer_tpu_torch/csrc/cosine_mha.cu",
                   "omnitokenizer_tpu/ops/pallas/cosine_mha.py:111"),
    "mha": ("omnitokenizer_tpu_torch/csrc/mha.cu", "omnitokenizer_tpu/ops/pallas/mha.py:52"),
    # JAX's stock TPU kernel, which the JAX LM calls at models/gpt.py:103-131
    "flash_attn_fwd": ("omnitokenizer_tpu_torch/csrc/flash_attn.cu",
                       "jax/experimental/pallas/ops/tpu/flash_attention.py:758 "
                       "(_flash_attention_impl), called at omnitokenizer_tpu/models/gpt.py:115"),
    "flash_attn_bwd": ("omnitokenizer_tpu_torch/csrc/flash_attn.cu",
                       "jax/experimental/pallas/ops/tpu/flash_attention.py:1121, :1456 "
                       "(_flash_attention_bwd_dkv, _flash_attention_bwd_dq), the backward of "
                       "omnitokenizer_tpu/models/gpt.py:115"),
}
KERNEL_REL_TOL = 2e-2   # bf16 output rounding + another summation order
MHA_F32_REL_TOL = 1e-5  # f32 with another summation order
VQ_TIE_TOL = 1e-5       # relative distance gap allowed for an index mismatch
# Slice bars, on the whole-tensor relative error ||a - b|| / ||b||: two bf16
# paths that round at different places sit ~1.7e-2 apart after the decoder's
# 8 blocks of random weights, about the distance of either from f32
LATENT_REL_TOL = 5e-2   # pre-VQ latents, kernel vs plain bf16 path
DECODE_REL_TOL = 2e-2   # decode of the same indices, kernel vs plain
FLOOR_RATIO = 1.25      # kernel path's distance from f32 vs the plain path's
VAE_REL_TOL = 1e-4      # f32 VAE, kernel vs plain path (summation order only)
# One training step, kernel route vs plain route from the same state, each
# reading relative to the larger of the two or 0.1. The losses are means
# over whole tensors, so the routes' bf16 rounding (1.7e-2 whole-tensor at
# the decoder's output, phase 3) mostly averages out of them: the largest
# reading on an H100 80GB HBM3 (700 W) was 2.48e-3 (aeloss, a mean of few
# logits). The gradient norms are sums of squares over every parameter's
# gradient, the plain math at inputs that differ by that rounding: largest
# reading 1.30e-2 (grad_norm_d). The bars sit at about 2x and 4x those.
# The reconstruction of the training forward, whole-tensor relative: a
# code that the two routes pick apart changes its tokens' output
# wholesale (largest reading 4.45e-2), so its bar sits at about 2x too.
# Each module's training call is held against its plain route on the same
# input at KERNEL_REL_TOL, whole-tensor. A fault run (q and k projections
# swapped in one attention block of the kernel route) must fail the step's
# bars and the module check at that block alone.
TRAIN_LOSS_REL_TOL = 5e-3
TRAIN_GRAD_NORM_REL_TOL = 5e-2
TRAIN_RECON_REL_TOL = 1e-1
# Published H100 SXM peaks (dense): bf16 and TF32 tensor cores, f32 outside
# them, HBM3. The f32 paths must not round to one TF32 pass: vq_argmin runs in
# f32 FMA, and the f32 mha runs three TF32 passes with error compensation
# (3xTF32), so its least time is 3x its flops at the TF32 rate.
PEAK_BF16, PEAK_TF32, PEAK_F32, HBM_BYTES_PER_S = 989e12, 495e12, 67e12, 3.35e12
# vq_argmin's issue floor: D FFMA and one min a (row, code) pair, one warp
# instruction a clock on each of an SM's 4 schedulers, at the H100 SXM's
# 1.98 GHz boost clock (an estimate beside the bound, not a measurement)
BOOST_HZ, LANES_PER_SM = 1.98e9, 128


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """The least time of the work on the card: the larger of its operations
    over the peak rate of their type and its bytes (each input read once,
    each output written once) over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over the whole tensor."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


@contextlib.contextmanager
def train_kernel_ops(ops: str):
    """OMNITOK_TRAIN_KERNEL_FWD for the calls inside: "0" makes a bf16
    training=True call the plain route (ops/kernel_grad.py)."""
    old = os.environ.get("OMNITOK_TRAIN_KERNEL_FWD")
    os.environ["OMNITOK_TRAIN_KERNEL_FWD"] = ops
    try:
        yield
    finally:
        if old is None:
            del os.environ["OMNITOK_TRAIN_KERNEL_FWD"]
        else:
            os.environ["OMNITOK_TRAIN_KERNEL_FWD"] = old


def cuda_ms(fn, iters: int = 10, warmup: int = 3, queued: bool = True) -> float:
    """Mean time of fn() in ms between CUDA events around `iters` calls
    after warm-up. queued: the timed calls queue behind a kernel that sleeps
    for twice their host time, so a short kernel's time is its own and not
    the host's (a wrapper's checks, allocation and launch take tens of us a
    call, as long as the small attention kernels run). Not queued: the calls
    are issued as a caller issues them, and the host's time a call shows
    where it is the longer (the method of PRs 1-4)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(min(2 * iters * host_s, 0.2) * 2e9))  # cycles, at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn) -> list:
    """Names of the device kernels one call of fn() launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def randn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)


def phase0_card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc[-1] if nvcc else 'not found'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    print(f"[0] device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; TF32 off")
    from omnitokenizer_tpu_torch.native import build as native

    print(f"[0] host data backends (native normalize and libav video decoder built here; "
          f"PIL, imageio importable): {native.backends()}; h5py importable: {has_h5py()}")
    return smi


def has_h5py() -> bool:
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


def phase1_build() -> None:
    from omnitokenizer_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"[1] built {_build.library_path().name} in {time.perf_counter() - t0:.1f} s")


ROWS: list = []  # a row per kernel and shape: the kernels line
BF = torch.bfloat16


def compare(name, got, want, tol=KERNEL_REL_TOL):
    err = (max_abs(got, want), rel_err(got, want))
    if not err[1] <= tol:
        raise AssertionError(f"{name}: relative error {err[1]:.3e} > {tol}")
    return err


def record(tag, name, path, errs, kernel_fn, plain_fn, cost, library_fn=None, chain_fn=None,
           **shape):
    """Time a kernel (queued and not), its plain version and its yardsticks,
    and keep the row."""
    ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
    host_paced_ms = cuda_ms(kernel_fn, queued=False)
    library_ms = None if library_fn is None else cuda_ms(library_fn)
    chain_ms = None if chain_fn is None else cuda_ms(chain_fn)
    row = {"name": name, "path": path, "max_abs_err": max(e[0] for e in errs), "ms": ms,
           "host_paced_ms": host_paced_ms, "plain_ms": plain_ms, **cost,
           "library_ms": library_ms, "chain_ms": chain_ms, **shape}
    ROWS.append(row)
    lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
    lib += "" if chain_ms is None else f"  chain {chain_ms:.4f} ms"
    print(f"[{tag}] {name} ({path}) {shape}: max_abs {row['max_abs_err']:.3e} "
          f"max_rel {max(e[1] for e in errs):.3e}  kernel {ms:.4f} ms (not queued "
          f"{host_paced_ms:.4f} ms)  plain {plain_ms:.4f} ms"
          f"{lib}  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")


# Each check_* holds a kernel against its plain version at one path's
# shapes and records its row. Its chain is the module's own plain bf16
# route (ops/attention.py: Attention and FeedForward with training=True and
# OMNITOK_TRAIN_KERNEL_FWD=0):
# layer_norm, then cuBLAS bf16 F.linear; [RoPE], F.normalize and one SDPA
# call for the attention kernels.
def check_ln_qkv(tag, path, x, gamma, wq, wkv):
    """ln_qkv: x (M, D) -> q (M, dq), kv (M, dkv)."""
    from omnitokenizer_tpu_torch.ops.kernels import ln_qkv as lq
    from omnitokenizer_tpu_torch.ops.norms import layer_norm

    (M, D), dqkv = x.shape, wq.shape[0] + wkv.shape[0]

    def chain():
        return F.linear((layer_norm(x) * gamma).to(BF), wq), F.linear(x, wkv)

    q_k, kv_k = lq.ln_qkv(x, gamma, wq, wkv)
    q_p, kv_p = lq.ln_qkv_plain(x, gamma, wq, wkv)
    record(tag, "ln_qkv", path,
           [compare("ln_qkv q", q_k, q_p), compare("ln_qkv kv", kv_k, kv_p)],
           lambda: lq.ln_qkv(x, gamma, wq, wkv), lambda: lq.ln_qkv_plain(x, gamma, wq, wkv),
           bound(2 * M * D * dqkv, 2 * (M * D + dqkv * D + M * dqkv) + 4 * D, PEAK_BF16),
           chain_fn=chain, shape=[M, D, wq.shape[0], wkv.shape[0]])


def check_geglu(tag, path, x, ln_w, ln_b, w1, w2):
    """geglu_ff: x (M, D), w1 (2 inner, D), w2 (D, inner); the bound counts
    the unpadded inner."""
    from omnitokenizer_tpu_torch.ops.kernels import geglu_ff as gf
    from omnitokenizer_tpu_torch.ops.norms import layer_norm

    (M, D), inner = x.shape, w2.shape[1]
    w1p, w2p = gf.pad_geglu_weights(w1, w2)
    w1b, w2b = w1.to(BF), w2.to(BF)

    def chain():
        val, gate = F.linear((layer_norm(x) * ln_w + ln_b).to(BF), w1b).chunk(2, dim=-1)
        return F.linear((F.gelu(gate) * val).to(BF), w2b)

    record(tag, "geglu_ff", path,
           [compare("geglu_ff", gf.geglu_ff(x, ln_w, ln_b, w1p, w2p),
                    gf.geglu_ff_plain(x, ln_w, ln_b, w1p, w2p))],
           lambda: gf.geglu_ff(x, ln_w, ln_b, w1p, w2p),
           lambda: gf.geglu_ff_plain(x, ln_w, ln_b, w1p, w2p),
           bound(6 * M * D * inner, 2 * (2 * M * D + 3 * inner * D) + 8 * D, PEAK_BF16),
           chain_fn=chain, shape=[M, D, inner])


def sdpa_inputs(q, kv, heads, dim_head, qs, ks, rope, q_offset=0):
    """The attention modules' bf16 route up to SDPA (ops/attention.py:
    _attend): [RoPE], F.normalize * scales -> bf16, as (B, H, N, Dh) views;
    q may be a block of the grid's tokens from q_offset."""
    from omnitokenizer_tpu_torch.ops.rotary import block_table, freqs_cis_2d, rotate_pairs

    b, nq, _ = q.shape
    n = kv.shape[1]
    qh, k = q.view(b, nq, heads, dim_head), kv.view(b, n, 2, heads, dim_head)[:, :, 0]
    if rope:
        cos, sin = freqs_cis_2d(dim_head, n, q.device)
        qh = rotate_pairs(qh, *block_table(cos, sin, q_offset, nq))
        k = rotate_pairs(k, *block_table(cos, sin, 0, n))
    qh = (F.normalize(qh.float(), dim=-1) * qs).to(BF)
    k = (F.normalize(k.float(), dim=-1) * ks).to(BF)
    return [t.transpose(1, 2) for t in (qh, k, kv.view(b, n, 2, heads, dim_head)[:, :, 1])]


def attention_chain(q, kv, heads, dim_head, qs, ks, rope, causal=False, q_offset=0):
    b, nq, _ = q.shape
    out = F.scaled_dot_product_attention(
        *sdpa_inputs(q, kv, heads, dim_head, qs, ks, rope, q_offset), is_causal=causal,
        scale=8.0)
    return out.transpose(1, 2).reshape(b, nq, heads * dim_head)


def check_small_n(tag, path, q, kv, qs, ks, heads, dim_head):
    """small_n_attention: (b h w, t, H*Dh), causal and not; timed causal, as
    the paths run it; its library call is SDPA alone on q-hat and k-hat made
    ahead."""
    from omnitokenizer_tpu_torch.ops.kernels import small_attn as sa

    R, t, _ = q.shape
    args = (q, kv, qs, ks, heads, dim_head, 8.0)
    errs = [compare(f"small_n_attention causal={c}", sa.small_n_attention(*args, c),
                    sa.small_n_attention_plain(*args, c)) for c in (True, False)]
    small_in = sdpa_inputs(q, kv, heads, dim_head, qs, ks, False)

    def library():
        return F.scaled_dot_product_attention(*small_in, is_causal=True, scale=8.0)

    print(f"[{tag}] small_n_attention ({path}): its SDPA call runs {device_kernels(library)}")
    record(tag, "small_n_attention", path, errs, lambda: sa.small_n_attention(*args, True),
           lambda: sa.small_n_attention_plain(*args, True),
           bound(4 * R * heads * dim_head * t * (t + 1) // 2,
                 2 * R * t * 4 * heads * dim_head + 8 * dim_head, PEAK_BF16), library,
           chain_fn=lambda: attention_chain(q, kv, heads, dim_head, qs, ks, False, causal=True),
           shape=[R, t, heads * dim_head], causal=True)


def check_cosine(tag, path, q, kv, qs, ks, heads, dim_head, rope):
    """cosine_mha: (b t, h w, H*Dh), RoPE on and off; timed as the path runs
    it."""
    from omnitokenizer_tpu_torch.ops.kernels import cosine_mha as cm

    bt, n, _ = q.shape
    args = (q, kv, qs, ks, heads, dim_head, 8.0)
    errs = [compare(f"cosine_mha N={n} rope={r}", cm.cosine_mha(*args, r),
                    cm.cosine_mha_plain(*args, r)) for r in (True, False)]
    sdpa_in = sdpa_inputs(q, kv, heads, dim_head, qs, ks, rope)

    def library():
        return F.scaled_dot_product_attention(*sdpa_in, scale=8.0)

    chain_err = max_abs(attention_chain(q, kv, heads, dim_head, qs, ks, rope),
                        cm.cosine_mha_plain(*args, rope))
    print(f"[{tag}] cosine_mha ({path}): chain vs plain max_abs {chain_err:.3e}; "
          f"its SDPA call runs {device_kernels(library)}")
    record(tag, "cosine_mha", path, errs, lambda: cm.cosine_mha(*args, rope),
           lambda: cm.cosine_mha_plain(*args, rope),
           bound(4 * bt * heads * n * n * dim_head,
                 2 * bt * n * 4 * heads * dim_head + 8 * dim_head, PEAK_BF16), library,
           chain_fn=lambda: attention_chain(q, kv, heads, dim_head, qs, ks, rope),
           shape=[bt, n, heads * dim_head], rope=rope)


def check_cosine_block(tag, path, q, kv, qs, ks, heads, dim_head, offset):
    """cosine_mha with a query block (sequence parallelism): q (b t, Nq,
    H*Dh), the grid's tokens from `offset`, against the whole grid's kv
    (b t, N, 2*H*Dh), RoPE on and off, each also against the rows of the
    square call's plain version; timed with RoPE, as the SP path runs it."""
    from omnitokenizer_tpu_torch.ops.kernels import cosine_mha as cm

    bt, nq, hd = q.shape
    n = kv.shape[1]
    args = (q, kv, qs, ks, heads, dim_head, 8.0)
    errs = []
    for r in (True, False):
        got = cm.cosine_mha(*args, r, q_offset=offset)
        errs.append(compare(f"cosine_mha block {nq} of {n} at {offset} rope={r}", got,
                            cm.cosine_mha_plain(*args, r, q_offset=offset)))
        whole_q = torch.zeros(bt, n, hd, dtype=BF, device="cuda")
        whole_q[:, offset:offset + nq] = q
        rows = cm.cosine_mha_plain(whole_q, *args[1:], r)[:, offset:offset + nq]
        compare(f"cosine_mha block {nq} of {n} rope={r} vs the square call's rows", got, rows)
    sdpa_in = sdpa_inputs(q, kv, heads, dim_head, qs, ks, True, offset)

    def library():
        return F.scaled_dot_product_attention(*sdpa_in, scale=8.0)

    print(f"[{tag}] cosine_mha query block ({path}): its SDPA call runs "
          f"{device_kernels(library)}")
    record(tag, "cosine_mha", path, errs, lambda: cm.cosine_mha(*args, True, q_offset=offset),
           lambda: cm.cosine_mha_plain(*args, True, q_offset=offset),
           bound(4 * bt * heads * nq * n * dim_head,
                 2 * (2 * bt * nq * hd + bt * n * 2 * hd) + 8 * dim_head, PEAK_BF16), library,
           chain_fn=lambda: attention_chain(q, kv, heads, dim_head, qs, ks, True,
                                            q_offset=offset),
           shape=[bt, nq, n, hd], rope=True, q_offset=offset)


def check_vq(tag, path, z, emb):
    """vq_argmin: rows (M, D) f32 against codes (K, D); its chain is the
    f32 distance argmin (TF32 off); its row also carries the issue floor."""
    from omnitokenizer_tpu_torch.ops.kernels import vq_argmin as vq

    (M, D), K = z.shape, emb.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gap = vq_gap(tag, f"vq_argmin ({path})", z, emb)
    record(tag, "vq_argmin", path, [(gap, 0.0)], lambda: vq.vq_argmin(z, emb),
           lambda: vq.vq_argmin_plain(z, emb),
           bound(2 * M * K * D, 4 * (M * D + K * D + M), PEAK_F32),
           chain_fn=lambda: torch.argmin((emb * emb).sum(1)[None, :] - 2.0 * (z @ emb.t()),
                                         dim=1),
           shape=[M, K, D],
           issue_bound_ms=M * K * (D + 1) / (sms * LANES_PER_SM * BOOST_HZ) * 1e3)


def phase2_kernels() -> None:
    from omnitokenizer_tpu_torch.ops.kernels import mha as mh

    g = torch.Generator().manual_seed(0)
    D, H, Dh = 512, 8, 64
    hw = (RES // 8) ** 2  # 32 x 32 tokens a frame
    inner = int(4 * 2 / 3 * D)  # 1365, padded to 1408 for geglu_ff

    ln_w, ln_b = 1 + randn(g, D, scale=0.1), randn(g, D, scale=0.1)
    gamma = 1 + randn(g, D, scale=0.1)
    wq = randn(g, D, D, scale=D ** -0.5, dtype=BF)
    wkv = randn(g, 2 * D, D, scale=D ** -0.5, dtype=BF)
    w1, w2 = randn(g, 2 * inner, D, scale=D ** -0.5), randn(g, D, inner, scale=inner ** -0.5)
    qs, ks = 1 + randn(g, Dh, scale=0.1), 1 + randn(g, Dh, scale=0.1)
    emb = randn(g, 8192, 8)

    # the VQ paths' shapes: the flagship's 5 latent frames (RoPE) and the
    # stage-1 tokenizer's 9 ('rel': no RoPE, no small_n_attention)
    for path, t, rope in (("vq", 1 + (T - 1) // 4, True), ("rel", 1 + (T - 1) // 2, False)):
        M = B * t * hw
        x = randn(g, M, D, dtype=BF)
        check_ln_qkv("2", path, x, gamma, wq, wkv)
        check_geglu("2", path, x, ln_w, ln_b, w1, w2)
        if path == "vq":
            check_small_n("2", path, randn(g, B * hw, t, H * Dh, dtype=BF),
                          randn(g, B * hw, t, 2 * H * Dh, dtype=BF), qs, ks, H, Dh)
        # after the flagship's row, one at a ragged N (the last key tile
        # partial) with the flagship's batch and RoPE
        for row_path, n_sp, rope_sp in [(path, hw, rope)] + (
                [("ragged", 784, True)] if path == "vq" else []):
            check_cosine("2", row_path, randn(g, B * t, n_sp, H * Dh, dtype=BF),
                         randn(g, B * t, n_sp, 2 * H * Dh, dtype=BF), qs, ks, H, Dh, rope_sp)
        # l2-normalized latents against an N(0, 1) 8192 x 8 codebook
        check_vq("2", path, F.normalize(randn(g, M, 8), dim=-1).contiguous(), emb)

    # the CNN VQGAN's codebook at the loader defaults: B=4 clips of 16 x 128^2 give
    # 4 x 4 x 32 x 32 rows of width 256 against 2048 codes
    check_vq("2", "cnn_vqgan", randn(g, CNN_B * (CNN_T // 4) * (CNN_RES // 4) ** 2, 256),
             randn(g, 2048, 256))
    # and at a ragged code width no path runs (its last 16-dim step zero-filled)
    check_vq("2", "ragged", randn(g, 16384, 100), randn(g, 2048, 100))

    # mha at both of its paths' shapes: the f32 VAE's spatial blocks, (b t, H,
    # h w, Dh) non-causal, and the stage-1 tokenizer's causal temporal blocks,
    # (b h w, H, 9, Dh) in bf16
    check_mha("2", "vae", g, (B * (1 + (T - 1) // 4), H, hw, Dh), torch.float32, False)
    check_mha("2", "rel", g, (B * hw, H, 1 + (T - 1) // 2, Dh), BF, True)
    # sequence parallelism's query blocks at two ranks (phase 18): a rank's 512 of the
    # flagship's 1024 tokens, the second rank's, against the whole grid's keys; the f32
    # VAE's spatial blocks the same way
    t_vq = 1 + (T - 1) // 4
    check_cosine_block("2", "sp", randn(g, B * t_vq, hw // SP_RANKS, H * Dh, dtype=BF),
                       randn(g, B * t_vq, hw, 2 * H * Dh, dtype=BF), qs, ks, H, Dh,
                       offset=hw - hw // SP_RANKS)
    check_mha("2", "sp_vae", g, (B * t_vq, H, hw // SP_RANKS, Dh), torch.float32, False, nk=hw)
    # phase 18b's flagship at 320^2: the second rank's 800 of 1600 tokens (a partial query tile)
    hw320 = (SP_RES_320 // 8) ** 2
    check_cosine_block("2", "sp_flagship_320",
                       randn(g, B * t_vq, hw320 // SP_RANKS, H * Dh, dtype=BF),
                       randn(g, B * t_vq, hw320, 2 * H * Dh, dtype=BF), qs, ks, H, Dh,
                       offset=hw320 - hw320 // SP_RANKS)
    # phase 18c's ragged_264 (33 x 33 = 1089 tokens a frame): each rank's query block, the
    # first rank's 17 rows of 33 at token 0 and the second's 16 at token 561
    hw264 = (SP_RAGGED_RES // 8) ** 2
    for rows, offset in ((17, 0), (16, 17 * 33)):
        check_cosine_block("2", "sp_ragged_264",
                           randn(g, B * t_vq, rows * 33, H * Dh, dtype=BF),
                           randn(g, B * t_vq, hw264, 2 * H * Dh, dtype=BF), qs, ks, H, Dh,
                           offset=offset)
    mha_f32_floor(mh, g)
    # the LM training step's attention: (B, H, T, D) views of the (B, T, H, D)
    # projections; then the long-sequence recipes' shape, where the kernels are
    # compute-bound (scripts/lm_train/train_ucf.sh: block 5121, B = 4, 16 heads
    # of 96; no phase drives it, so its launches are null)
    check_flash("2", "lm_train", LM_TRAIN_B, LM_HEADS, LM_BLOCK, LM_WIDTH // LM_HEADS)
    check_flash("2", "lm_train_ucf", 4, LM_HEADS, 5121, LM_WIDTH // LM_HEADS)
    # phase 17b's text-conditioned step: sos + 256 caption ids + 5120 codes, less the last
    check_flash("2", "text_lm_train", TEXT_LM_B, LM_HEADS, TEXT_LM_BLOCK - 1,
                LM_WIDTH // LM_HEADS)


def check_mha(tag, path, g, shape, dtype, causal, nk=None) -> None:
    """mha at one path's (B, H, N, D) against its plain version: q and k
    l2-normalized, as the cosine attention hands them over, with its logit
    scale 8. The bf16 ones are the views that ops/attention.py:_attend hands
    over: (B, H, N, D) views of (B, N, H, D) memory, v inside the fused kv;
    the f32 ones the contiguous copies sdpa makes for the flash branch, k
    and v of nk keys where given (a query block: sequence parallelism)."""
    from omnitokenizer_tpu_torch.ops.kernels import mha as mh

    b, h, n, d = shape
    nk = nk or n
    if dtype == torch.float32:
        q = F.normalize(randn(g, *shape), dim=-1)
        k = F.normalize(randn(g, b, h, nk, d), dim=-1)
        v, tol = randn(g, b, h, nk, d), MHA_F32_REL_TOL
    else:
        q, k = (F.normalize(randn(g, b, n, h, d), dim=-1).to(dtype).transpose(1, 2)
                for _ in range(2))
        kv = randn(g, b, n, 2 * h * d, dtype=dtype)
        v, tol = kv[..., h * d:].view(b, n, h, d).transpose(1, 2), KERNEL_REL_TOL
    err = compare(f"mha {dtype} causal={causal}", mh.mha(q, k, v, 8.0, causal),
                  mh.mha_plain(q, k, v, 8.0, causal), tol)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=8.0)

    if dtype == BF and mh.mha(q, k, v, 8.0, causal).stride() != q.stride():
        raise AssertionError("mha: the output on views does not take q's layout")
    print(f"[{tag}] mha ({path}): library call vs plain max_abs "
          f"{max_abs(library(), mh.mha_plain(q, k, v, 8.0, causal)):.3e}; "
          f"it runs {device_kernels(library)}")
    pairs = n * (n + 1) // 2 if causal else n * nk
    flops, nbytes = 4 * b * h * pairs * d, 2 * b * h * (n + nk) * d * q.element_size()
    record(tag, "mha", path, [err], lambda: mh.mha(q, k, v, 8.0, causal),
           lambda: mh.mha_plain(q, k, v, 8.0, causal),
           bound(flops, nbytes, PEAK_BF16) if dtype == BF
           else bound(3 * flops, nbytes, PEAK_TF32),  # 3xTF32
           library, shape=list(shape), dtype=str(dtype).split(".")[1], causal=causal,
           **({"nk": nk} if nk != n else {}))


FLASH_FWD_TOL, FLASH_BWD_TOL = 1e-2, 2e-2  # bf16 outputs vs f32 math on the same bf16 inputs


def flash_cost(B: int, H: int, T: int, D: int) -> tuple:
    """(forward, backward) FLOPs and bytes of causal attention: 4 D flops a
    (query, key) pair at or below the diagonal forward, 10 D backward (the
    scores again, dV, dP, dQ, dK); bytes of q, k, v read and o written (bf16)
    and lse written (f32) forward; q, k, v, o, dO and lse read and dq, dk,
    dv written backward."""
    pairs, elems = B * H * T * (T + 1) // 2, B * H * T * D
    return ((4 * pairs * D, 4 * elems * 2 + B * H * T * 4),
            (10 * pairs * D, 8 * elems * 2 + B * H * T * 4))


def check_flash(tag, path, B_, H_, T_, D_) -> None:
    """The causal flash forward and backward against their plain versions on
    the same bf16 inputs, each timed beside its bound and PyTorch's SDPA
    (is_causal) on the same views: its forward for the forward row, its
    forward + backward for the backward row (no single library call computes
    the backward alone), where the kernels' own forward + backward is timed
    too."""
    from omnitokenizer_tpu_torch.ops.kernels import flash_attn as fa

    g = torch.Generator().manual_seed(12)
    q, k, v, do = (randn(g, B_, T_, H_, D_, dtype=BF).transpose(1, 2) for _ in range(4))
    scale = D_ ** -0.5
    o, lse = fa.flash_attn_fwd(q, k, v, scale)
    grads = fa.flash_attn_bwd(q, k, v, o, do, lse, scale)
    # the plain twins hold a few (B, H, T, T) f32 tensors at once: where ~8
    # of them do not fit beside what is allocated, they run on batch 0 alone
    # and are timed there
    pb = B_ if 8 * B_ * H_ * T_ * T_ * 4 < torch.cuda.mem_get_info()[0] else 1
    pq, pk, pv, pdo = (t[:pb] for t in (q, k, v, do))
    o_ref, lse_ref = fa.flash_attn_fwd_plain(pq, pk, pv, scale)
    err_o = compare("flash_attn_fwd", o[:pb], o_ref, FLASH_FWD_TOL)
    lse_err = max_abs(lse[:pb], lse_ref)
    want = fa.flash_attn_bwd_plain(pq, pk, pv, o_ref, pdo, lse_ref, scale)
    errs = [compare(f"flash_attn_bwd {n}", a[:pb], b, FLASH_BWD_TOL)
            for n, a, b in zip(("dq", "dk", "dv"), grads, want)]
    again = fa.flash_attn_bwd(q, k, v, o, do, lse, scale)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError("flash_attn_bwd: two runs on the same inputs differ")
    del grads, want, again
    sliced = "" if pb == B_ else f"; plain twins on batch 0 of {B_} (memory), timed there"
    print(f"[{tag}] flash_attn ({path}) lse max_abs {lse_err:.3e}; dq, dk, dv max_rel "
          f"{[f'{e[1]:.3e}' for e in errs]}; backward bitwise equal over two runs{sliced}")
    (f_flops, f_bytes), (b_flops, b_bytes) = flash_cost(B_, H_, T_, D_)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)

    def lib_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=scale)
        return torch.autograd.grad(out, (qg, kg, vg), do)

    def kernel_fwd_bwd():
        o2, lse2 = fa.flash_attn_fwd(q, k, v, scale)
        return fa.flash_attn_bwd(q, k, v, o2, do, lse2, scale)

    shape = dict(shape=[B_, H_, T_, D_], dtype="bfloat16", causal=True, plain_batch=pb)
    record(tag, "flash_attn_fwd", path, [err_o], lambda: fa.flash_attn_fwd(q, k, v, scale),
           lambda: fa.flash_attn_fwd_plain(pq, pk, pv, scale),
           bound(f_flops, f_bytes, PEAK_BF16), lib_fwd, **shape, lse_max_abs_err=lse_err,
           library_kernels=device_kernels(lib_fwd))
    record(tag, "flash_attn_bwd", path, errs,
           lambda: fa.flash_attn_bwd(q, k, v, o, do, lse, scale),
           lambda: fa.flash_attn_bwd_plain(pq, pk, pv, o_ref, pdo, lse_ref, scale),
           bound(b_flops, b_bytes, PEAK_BF16), lib_fwd_bwd, **shape,
           library_covers="forward + backward", fwd_bwd_ms=cuda_ms(kernel_fwd_bwd),
           fwd_bwd_bound_ms=bound(f_flops + b_flops, f_bytes + b_bytes, PEAK_BF16)["bound_ms"])
    del q, k, v, do, qg, kg, vg, o, o_ref, lse, lse_ref, pq, pk, pv, pdo
    torch.cuda.empty_cache()


def vq_gap(tag: str, name: str, z: torch.Tensor, emb: torch.Tensor) -> float:
    """vq_argmin against its plain version: indices may differ only at
    near-ties (relative distance gap <= VQ_TIE_TOL); returns the largest
    absolute distance gap of a differing index."""
    from omnitokenizer_tpu_torch.ops.kernels import vq_argmin as vq

    idx_k = vq.vq_argmin(z, emb)
    idx_p = vq.vq_argmin_plain(z, emb)
    bad = (idx_k != idx_p).nonzero().flatten()
    gap = 0.0
    if bad.numel():
        zz, e64 = z[bad].double(), emb.double()
        d_k = (zz - e64[idx_k[bad].long()]).square().sum(-1)
        d_p = (zz - e64[idx_p[bad].long()]).square().sum(-1)
        rel_gap = ((d_k - d_p).abs() / d_p.clamp_min(1e-12)).max()
        gap = float((d_k - d_p).abs().max())
        if not float(rel_gap) <= VQ_TIE_TOL:
            raise AssertionError(f"{name}: mismatch with relative distance gap {rel_gap:.3e}")
    print(f"[{tag}] {name}: {bad.numel()} of {z.shape[0]} indices differ (near-ties only)")
    return gap


def mha_f32_floor(mh, g) -> None:
    """The f32 mha at large logits: N(0, 1) q and k with scale 8 put them near
    200, where one f32 ulp is 1.5e-5, so any two f32 summation orders differ
    by ~1e-5 there. The plain version and the kernel against an f64 result:
    the kernel within 1e-5 of it, or within twice the plain version's error
    where that is larger."""
    for n, causal in ((64, True), (1024, False)):
        q, k, v = (randn(g, 2, 2, n, 64) for _ in range(3))
        s = (q.double() @ k.double().transpose(-1, -2)) * 8.0
        if causal:
            s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device="cuda").triu(1), -1e9)
        want = s.softmax(-1) @ v.double()
        plain = rel_err(mh.mha_plain(q, k, v, 8.0, causal), want)
        kernel = rel_err(mh.mha(q, k, v, 8.0, causal), want)
        print(f"[2] mha f32 N={n} causal={causal} at logits near 200 against f64: "
              f"plain {plain:.3e}, kernel {kernel:.3e}")
        if not kernel <= max(MHA_F32_REL_TOL, 2 * plain):
            raise AssertionError(f"mha f32 at large logits: {kernel:.3e} from f64, "
                                 f"plain {plain:.3e}")


def plain_vq_round_trip(model, xl: torch.Tensor) -> torch.Tensor:
    """The plain route's VQ round trip of (B, T, H, W, C) clips: training=True
    calls (in bf16 with the training route's kernels off, under
    train_kernel_ops("0")) and vq_argmin_plain."""
    from omnitokenizer_tpu_torch.ops.attention import l2norm
    from omnitokenizer_tpu_torch.ops.kernels.vq_argmin import vq_argmin_plain

    cfg, net = model.cfg, model.net
    h = net.encode_latent(xl, False, training=True)
    i = vq_argmin_plain(l2norm(h).reshape(-1, cfg.codebook_dim), net.codebook.embeddings)
    return net.decode_latent(net.codebook.lookup(i.view(h.shape[:-1])), False, training=True)


def route_bars(tag: str, model, video: torch.Tensor, idx: torch.Tensor, lat_tol: float,
               dec_tol: float, agree_min: float = 0.0, ref32=None) -> None:
    """A VQ model's kernel route against its plain route on (B, C, T, H, W)
    clips whose kernel-route indices are `idx`, on the same weights: pre-VQ
    latents within lat_tol, indices at least agree_min equal, the decode of
    the same indices within dec_tol (whole-tensor relative). A bf16 model's
    kernel route must also be no farther from the f32 model (`ref32`, else
    the same seed's f32 model) than its plain route."""
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN
    from omnitokenizer_tpu_torch.ops.attention import l2norm
    from omnitokenizer_tpu_torch.ops.kernels.vq_argmin import vq_argmin_plain

    cfg, net, emb = model.cfg, model.net, model.net.codebook.embeddings
    xl = video.permute(0, 2, 3, 4, 1)
    floor = cfg.dtype != torch.float32
    with torch.inference_mode(), train_kernel_ops("0"):
        h_k = net.encode_latent(xl, False)
        h_p = net.encode_latent(xl, False, training=True)
        lat_err = rel_norm(h_k, h_p)
        idx_p = vq_argmin_plain(l2norm(h_p).reshape(-1, cfg.codebook_dim), emb).view(idx.shape)
        agree = float((idx_p == idx).float().mean())
        del h_k, h_p
        dec_k = net.decode(idx, False)
        dec_p = net.decode_latent(net.codebook.lookup(idx), False, training=True)
        dec_err = rel_norm(dec_k, dec_p)
        if floor:  # the same weights before the bf16 cast, f32 throughout
            ref = ref32 or OmniTokenizerVQGAN.from_config(cfg.replace(dtype=torch.float32),
                                                          seed=0, device="cuda")
            dec_32 = ref.net.decode(idx, False)
            floor_k, floor_p = rel_norm(dec_k, dec_32), rel_norm(dec_p, dec_32)
            del ref, dec_32
    b = video.shape[0]
    print(f"[{tag}] kernel vs plain route, B={b}: pre-VQ latents rel err {lat_err:.3e}; "
          f"indices agree {agree:.5%}")
    print(f"[{tag}] decode of the same indices, B={b}: kernel vs plain rel err {dec_err:.3e} "
          f"(max-abs ratio {rel_err(dec_k, dec_p):.3e})"
          + (f"; vs f32: kernel {floor_k:.3e}, plain {floor_p:.3e}" if floor else ""))
    if not lat_err <= lat_tol:
        raise AssertionError(f"pre-VQ latents rel err {lat_err:.3e} > {lat_tol}")
    if not agree >= agree_min:
        raise AssertionError(f"indices agree {agree:.5%} < {agree_min:.3%}")
    if not dec_err <= dec_tol:
        raise AssertionError(f"decode rel err {dec_err:.3e} > {dec_tol}")
    if floor and not floor_k <= FLOOR_RATIO * floor_p:
        raise AssertionError(f"kernel path is {floor_k:.3e} from f32, plain {floor_p:.3e}")


def bf16_slice(tag: str, cfg, expected: dict, batch: int = B, model=None, ref32=None) -> dict:
    """A bf16 VQ round trip at full width through OmniTokenizerVQGAN: launch
    counts, then the slice bars against the plain bf16 path on the same
    weights and against the f32 model (`ref32`, else the same seed's), then
    frames/s of both paths. `model`: the bf16 model, else from_config's."""
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    model = (model or OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cuda")).serving()
    g = torch.Generator().manual_seed(1)
    video = (torch.rand(batch, 3, T, RES, RES, generator=g) * 2 - 1).to("cuda")
    torch.cuda.synchronize()

    reset_launch_counts()
    recon, aux = model.reconstruct(video, is_image=False)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[{tag}] launches in one round trip: {counts}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != {expected}")

    pools = sum(cfg.enc_block.count(c) for c in "aml")  # the encoder's 2 x 2 pools
    t, hw = 1 + (T - 1) // cfg.temporal_patch_size, RES // cfg.patch_size // 2 ** pools
    if tuple(recon.shape) != (batch, 3, T, RES, RES) or not bool(torch.isfinite(recon).all()):
        raise AssertionError(f"bad reconstruction {tuple(recon.shape)}")
    idx = aux["encodings"]
    if tuple(idx.shape) != (batch, t, hw, hw) or int(idx.min()) < 0 or int(idx.max()) >= cfg.n_codes:
        raise AssertionError("bad indices")

    route_bars(tag, model, video, idx, LATENT_REL_TOL, DECODE_REL_TOL, ref32=ref32)
    xl = video.permute(0, 2, 3, 4, 1)
    with torch.inference_mode(), train_kernel_ops("0"):
        fps_k, mem_k = fps_and_peak(lambda: model.reconstruct(video, is_image=False), batch * T)
        fps_p, mem_p = fps_and_peak(lambda: plain_vq_round_trip(model, xl), batch * T)
    print(f"[{tag}] round trip B={batch} {T}x{RES}^2 bf16: kernel path {fps_k:.2f} frames/s "
          f"(peak {mem_k:.2f} GiB), plain path {fps_p:.2f} frames/s (peak {mem_p:.2f} GiB)")
    SLICE_STATS[tag] = {"batch": batch, "fps": fps_k, "peak_gib": mem_k, "plain_fps": fps_p,
                        "plain_peak_gib": mem_p}
    return counts


SLICE_STATS: dict = {}  # frames/s and peak memory of each bf16 round trip, by phase tag


def fps_and_peak(fn, frames: int, iters: int = 5):
    """Frames/s of fn() (host clock around synchronized runs, after one
    warm-up) and the peak device memory of those runs in GiB."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (iters * frames / (time.perf_counter() - t0),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def phase3_slice() -> dict:
    from omnitokenizer_tpu_torch import imagenet_k600_config

    return bf16_slice("3", imagenet_k600_config().replace(dtype=torch.bfloat16),
                      EXPECTED_LAUNCHES["vq"])


def phase4_small_f32() -> None:
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, TokenizerConfig

    cfg = TokenizerConfig(embedding_dim=128, n_codes=256, resolution=64, sequence_length=9,
                          enc_block="tw", dec_block="tt", spatial_depth=2, temporal_depth=2,
                          twod_window_size=4, heads=2, dim_head=64)
    g = torch.Generator().manual_seed(2)
    video = torch.rand(2, 3, 9, 64, 64, generator=g) * 2 - 1
    ref = OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cpu")
    gpu = OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cuda")
    rec_c, aux_c = ref.reconstruct(video, is_image=False)
    rec_g, aux_g = gpu.reconstruct(video.cuda(), is_image=False)
    if not torch.equal(aux_c["encodings"], aux_g["encodings"].cpu()):
        raise AssertionError("f32 indices differ between the card and the CPU")
    err = max_abs(rec_g.cpu(), rec_c)
    if not err <= 2e-4:
        raise AssertionError(f"f32 reconstruction differs by {err:.3e}")
    print(f"[4] small f32 round trip: indices equal to the CPU's, pixels max abs {err:.2e}")


def phase5_vae() -> dict:
    from omnitokenizer_tpu_torch import (DiffusionVAEAdapter, OmniTokenizerVQGAN,
                                         TokenizerConfig, imagenet_k600_config)
    from omnitokenizer_tpu_torch.ops.gaussian import DiagonalGaussian
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    cfg = imagenet_k600_config(use_vae=True)  # f32, as load_from_checkpoint gives it
    ad = DiffusionVAEAdapter.from_config(cfg, seed=0)  # on the card by default
    g = torch.Generator().manual_seed(3)
    video = (torch.rand(B, 3, T, RES, RES, generator=g) * 2 - 1).to("cuda")
    images = (torch.rand(B, 3, RES, RES, generator=g) * 2 - 1).to("cuda")
    t, hw = 1 + (T - 1) // cfg.temporal_patch_size, RES // cfg.patch_size
    lat_video = (B, cfg.codebook_dim, t, hw, hw)
    torch.cuda.synchronize()

    counts = None
    for name, x, is_image, lat in (("video", video, False, lat_video),
                                   ("image", images, True, (B, cfg.codebook_dim, hw, hw))):
        reset_launch_counts()
        z = ad.encode(x, is_image)
        rec = ad.decode(z, is_image)
        torch.cuda.synchronize()
        got = launch_counts()
        print(f"[5] launches in one {name} round trip (encode -> decode): {got}")
        if got != EXPECTED_LAUNCHES["vae"]:
            raise AssertionError(f"launch counts {got} != {EXPECTED_LAUNCHES['vae']}")
        if (tuple(z.shape) != lat or tuple(rec.shape) != tuple(x.shape)
                or not bool(torch.isfinite(z).all() and torch.isfinite(rec).all())):
            raise AssertionError(f"bad {name} latents {tuple(z.shape)} or pixels {tuple(rec.shape)}")
        counts = counts or got

    # the kernel path against the plain path (the net's training=True route)
    # on the same weights and the same noise
    net = ad.vae.net
    xl = video.permute(0, 2, 3, 4, 1)
    noise = torch.randn(lat_video[:1] + lat_video[2:] + lat_video[1:2], generator=g).cuda()
    with torch.inference_mode():
        post_k = DiagonalGaussian.from_params(net.encode_latent(xl, False))
        post_p = DiagonalGaussian.from_params(net.encode_latent(xl, False, training=True))
        z = post_p.sample(noise=noise)
        errs = {"mean": rel_norm(post_k.mean, post_p.mean),
                "logvar": rel_norm(post_k.logvar, post_p.logvar),
                "decode": rel_norm(net.decode_latent(z, False),
                                   net.decode_latent(z, False, training=True))}
    print("[5] kernel vs plain path, rel err: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for key, err in errs.items():
        if not err <= VAE_REL_TOL:
            raise AssertionError(f"VAE {key}: kernel vs plain rel err {err:.3e} > {VAE_REL_TOL}")

    def plain_round_trip(x, nz):
        post = DiagonalGaussian.from_params(net.encode_latent(x, False, training=True))
        return net.decode_latent(post.sample(noise=nz), False, training=True)

    il = images.permute(0, 2, 3, 1)[:, None]
    noise_i = noise[:, :1]
    with torch.inference_mode():
        for name, frames, kernel_fn, plain_fn in (
                ("video", B * T, lambda: ad.decode(ad.encode(video, False), False),
                 lambda: plain_round_trip(xl, noise)),
                ("image", B, lambda: ad.decode(ad.encode(images, True), True),
                 lambda: plain_round_trip(il, noise_i))):
            fps_k, mem_k = fps_and_peak(kernel_fn, frames)
            fps_p, mem_p = fps_and_peak(plain_fn, frames)
            print(f"[5] f32 VAE {name} round trip B={B}: kernel path {fps_k:.2f} frames/s "
                  f"(peak {mem_k:.2f} GiB), plain path {fps_p:.2f} frames/s "
                  f"(peak {mem_p:.2f} GiB)")
    del ad, net

    # a small f32 VAE on the card against the same model on the CPU, same noise
    small = TokenizerConfig(embedding_dim=128, n_codes=256, resolution=64, sequence_length=9,
                            enc_block="tw", dec_block="tt", spatial_depth=2, temporal_depth=2,
                            twod_window_size=4, heads=2, dim_head=64, use_vae=True)
    x = torch.rand(2, 9, 64, 64, 3, generator=g) * 2 - 1
    nz = torch.randn(2, 3, 8, 8, 8, generator=g)
    out = []
    for device in ("cpu", "cuda"):
        m = OmniTokenizerVQGAN.from_config(small, seed=0, device=device)
        reset_launch_counts()
        with torch.inference_mode():
            post = DiagonalGaussian.from_params(m.net.encode_latent(x.to(device), False))
            out.append(m.net.decode_latent(post.sample(noise=nz.to(device)), False).cpu())
        launched = launch_counts()["mha"]
    err = max_abs(out[1], out[0])
    if not err <= 2e-4 or launched == 0:
        raise AssertionError(f"small f32 VAE: card vs CPU {err:.3e}, mha launches {launched}")
    print(f"[5] small f32 VAE: card vs CPU pixels max abs {err:.2e} ({launched} mha launches)")
    return counts


def phase6_rel() -> dict:
    from omnitokenizer_tpu_torch import imagenet_only_config

    return bf16_slice("6", imagenet_only_config().replace(dtype=torch.bfloat16),
                      EXPECTED_LAUNCHES["rel"])


def phase7_wide() -> dict:
    """The flagship at width 768 with heads of 128 (8 x 128), B=1: the
    widths the port's gates opened last. Then each kernel of that path
    against its plain version at the path's shapes, and vq_argmin at a code
    dim of 6, which the kernel zero-pads to 8."""
    from omnitokenizer_tpu_torch import imagenet_k600_config

    cfg = imagenet_k600_config().replace(embedding_dim=768, dim_head=128, dtype=BF)
    counts = bf16_slice("7", cfg, EXPECTED_LAUNCHES["wide"], batch=1)
    g = torch.Generator().manual_seed(4)
    D, H, Dh = cfg.embedding_dim, cfg.heads, cfg.dim_head
    t, hw = 1 + (T - 1) // cfg.temporal_patch_size, (RES // cfg.patch_size) ** 2
    M, inner = t * hw, int(4 * 2 / 3 * D)
    x = randn(g, M, D, dtype=BF)
    check_ln_qkv("7", "wide", x, 1 + randn(g, D, scale=0.1),
                 randn(g, H * Dh, D, scale=D ** -0.5, dtype=BF),
                 randn(g, 2 * H * Dh, D, scale=D ** -0.5, dtype=BF))
    check_geglu("7", "wide", x, 1 + randn(g, D, scale=0.1), randn(g, D, scale=0.1),
                randn(g, 2 * inner, D, scale=D ** -0.5), randn(g, D, inner, scale=inner ** -0.5))
    qs, ks = 1 + randn(g, Dh, scale=0.1), 1 + randn(g, Dh, scale=0.1)
    check_small_n("7", "wide", randn(g, hw, t, H * Dh, dtype=BF),
                  randn(g, hw, t, 2 * H * Dh, dtype=BF), qs, ks, H, Dh)
    check_cosine("7", "wide", randn(g, t, hw, H * Dh, dtype=BF),
                 randn(g, t, hw, 2 * H * Dh, dtype=BF), qs, ks, H, Dh, True)
    check_vq("7", "wide", F.normalize(randn(g, M, cfg.codebook_dim), dim=-1).contiguous(),
             randn(g, cfg.n_codes, cfg.codebook_dim))
    vq_gap("7", "vq_argmin at code dim 6", F.normalize(randn(g, 20480, 6), dim=-1).contiguous(),
           randn(g, 8192, 6))
    return counts


TRAIN_ROWS: list = []  # a row per training route (ops/kernel_grad.py)
TRAIN_TIMED = 5  # timed steps after the warm-up


def check_train_route(name, kernels, kern, ref, args, cost, launches, **shape):
    """A training route against its plain math: the primal within the
    kernels' bar; the gradient of every input, from one upstream gradient,
    equal to the plain math's bit for bit (the backward is that math on
    the same inputs, on the same card), with no kernel launched; times of
    the forward and of forward + backward, each against the plain math's."""
    from omnitokenizer_tpu_torch.ops.kernel_grad import kernel_fwd_ref_bwd
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    def route():
        return kernel_fwd_ref_bwd(kern, ref, *args)

    out, want = route(), ref(*args)
    err = compare(f"training route {name}", out.detach(), want.detach())
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)).to(out.device, out.dtype)
    reset_launch_counts()
    got = torch.autograd.grad(out, args, g)
    torch.cuda.synchronize()
    bwd_launches = sum(launch_counts().values())
    diffs = [max_abs(a, b) for a, b in zip(got, torch.autograd.grad(want, args, g))]
    if bwd_launches or any(d != 0 for d in diffs):
        raise AssertionError(f"training route {name}: backward launched {bwd_launches} kernels; "
                             f"gradients differ from the plain math's by {diffs}")

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    ms, plain_ms = cuda_ms(no_grad(route)), cuda_ms(no_grad(lambda: ref(*args)))
    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(route(), args, g))
    plain_fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(ref(*args), args, g))
    TRAIN_ROWS.append({"name": f"train_route:{name}", "kernels": kernels, "path": "train",
                       "max_abs_err": err[0], "ms": ms, "plain_ms": plain_ms, **cost,
                       "library_ms": None, "fwd_bwd_ms": fwd_bwd_ms,
                       "plain_fwd_bwd_ms": plain_fwd_bwd_ms, "launches": launches,
                       "grad_max_abs_diff": max(diffs), **shape})
    print(f"[8] training route {name} ({kernels}) {shape}: primal max_abs {err[0]:.3e} "
          f"max_rel {err[1]:.3e}; gradients equal to plain, 0 launches in the backward; "
          f"forward {ms:.4f} ms (plain {plain_ms:.4f}), forward + backward {fwd_bwd_ms:.4f} ms "
          f"(plain {plain_fwd_bwd_ms:.4f}); bound {cost['bound_ms']:.4f} ms ({cost['bound_by']})")


def train_route_rows(route_calls: dict) -> None:
    """The four training routes at the flagship's shapes: the flat temporal
    route (B*32*32 groups of 5 frames, causal), the spatial small-group
    route at N = 8 (as 29-frame clips' 8 latent frames would give it under
    the 'attn' group alone; on no path of the flagship), cosine attention
    over the 32x32 grid with RoPE, and the feed-forward over every token.
    The bound counts the function's own inputs (x once, the f32 parameters
    it casts) and output, and the flops of all its kernels."""
    from omnitokenizer_tpu_torch.ops import attention as tattn

    g = torch.Generator().manual_seed(8)
    D, H, Dh = 512, 8, 64
    hw, t = (RES // 8) ** 2, 1 + (T - 1) // 4
    for name, route, rows, n, spatial, causal, ops in (
            ("flat", "small", B * hw, t, False, True, "attn,ff,flat"),
            ("small", "small", B * hw, 8, False, True, "attn"),
            ("cosine", "cosine", B * t, hw, True, False, "attn,ff,flat")):
        m = tattn.Attention(D, Dh, H, causal=causal, spatial_pos="rope", dtype=BF,
                            spatial=spatial).cuda()
        with torch.no_grad():
            for lin in (m.to_q, m.to_kv):
                lin.weight.copy_(randn(g, *lin.weight.shape, scale=D ** -0.5))
            for prm in (m.norm_gamma, m.q_scale, m.k_scale):
                prm.add_(randn(g, *prm.shape, scale=0.1))
        with train_kernel_ops(ops):
            if m.train_route(n, spatial) != route:
                raise AssertionError(f"training route {name}: took {m.train_route(n, spatial)}")
        x = randn(g, rows, n, D, dtype=BF).requires_grad_()
        args = (x, m.norm_gamma, m.to_q.weight, m.to_kv.weight, m.q_scale, m.k_scale)
        ref = functools.partial(tattn.attention_ref_math, dtype=BF, heads=H, dim_head=Dh,
                                scale=8.0, causal=causal, use_rope=spatial)
        M = rows * n
        pairs = n * (n + 1) // 2 if causal else n * n
        flops = 2 * M * D * 3 * H * Dh + 4 * rows * H * Dh * pairs
        nbytes = 2 * M * D + 4 * (3 * H * Dh * D + D + 2 * Dh) + 2 * M * H * Dh
        kernels = "ln_qkv+" + ("small_n_attention" if route == "small" else "cosine_mha")
        check_train_route(name, kernels, functools.partial(m._train_kernel, route, spatial), ref,
                          args, bound(flops, nbytes, PEAK_BF16),
                          route_calls.get(name), shape=[rows, n, H * Dh], causal=causal,
                          rope=spatial)
    ff = tattn.FeedForward(D, dtype=BF).cuda()
    inner = ff.proj_out.weight.shape[1]
    with torch.no_grad():
        ff.proj_in.weight.copy_(randn(g, *ff.proj_in.weight.shape, scale=D ** -0.5))
        ff.proj_out.weight.copy_(randn(g, *ff.proj_out.weight.shape, scale=inner ** -0.5))
        ff.norm_weight.add_(randn(g, D, scale=0.1))
        ff.norm_bias.add_(randn(g, D, scale=0.1))
    M = B * t * hw
    x = randn(g, M, D, dtype=BF).requires_grad_()
    check_train_route("ff", "geglu_ff", ff._train_kernel,
                      functools.partial(tattn.feed_forward_ref_math, dtype=BF),
                      (x, *ff._params()),
                      bound(6 * M * D * inner, 2 * 2 * M * D + 4 * (2 * D + 3 * inner * D),
                            PEAK_BF16), route_calls.get("ff"), shape=[M, D, inner])


def _train_tensors(state) -> dict:
    """G and D parameters and the codebook's buffers, by name."""
    out = {f"G.{n}": p for n, p in state.net.named_parameters()}
    out.update({f"D.image.{n}": p for n, p in state.image_disc.named_parameters()})
    out.update({f"D.video.{n}": p for n, p in state.video_disc.named_parameters()})
    cb = state.net.codebook
    out.update({f"codebook.{n}": getattr(cb, n) for n in ("embeddings", "N", "z_avg",
                                                           "codebook_usage")})
    return out


STAGES = {"g_forward": "_g_losses", "g_backward": "_grads", "g_update": "_g_update",
          "codebook_again": "_codebook_again", "d_forward": "_d_losses",
          "d_backward": "_grads", "d_update": "_d_update"}


def profile_train_step(trainer, state, video, tag: str = "8") -> dict:
    """One training step timed by stage: CUDA events around each of the
    trainer's stage methods (the device's time from the stage's first
    kernel to its last, gaps included), and the whole step; then one more
    step under torch.profiler for the device's busy time and the kernels
    that take the most. Returns the stages' ms and the step's."""
    from torch.profiler import ProfilerActivity, profile

    marks = []

    def timed(name, fn):
        def run(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks.append((name, start, end))
            return out
        return run

    for method in set(STAGES.values()):
        setattr(trainer, method, timed(method, getattr(trainer, method)))
    try:
        step = timed("step", trainer.train_step)
        step(state, video)
        torch.cuda.synchronize()
    finally:
        for method in set(STAGES.values()):
            delattr(trainer, method)
    names = [n for n, _, _ in marks if n != "step"]
    order = [n for n in STAGES if STAGES[n] in names]
    if [STAGES[n] for n in order] != names:  # the stages ran in this order
        raise AssertionError(f"stages ran as {names}")
    ms = {n: a.elapsed_time(b) for n, (_, a, b) in zip(order, marks)}
    ms["step"] = marks[-1][1].elapsed_time(marks[-1][2])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, video)
        torch.cuda.synchronize()

    def self_dev(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=self_dev, reverse=True)
    ms["busy"] = sum(self_dev(e) for e in kernels)
    route = os.environ.get("OMNITOK_TRAIN_KERNEL_FWD")
    print(f"[{tag}] step by stage ({route}), device ms: " + ", ".join(f"{k} {v:.2f}"
                                                                   for k, v in ms.items())
          + f"; device busy {ms['busy'] / ms['step']:.1%} of the step (profiled step)")
    for e in kernels[:10]:
        print(f"[{tag}]   {self_dev(e):8.2f} ms {e.count:5d}x {e.key[:110]}")
    if ms["busy"] < 0.5 * ms["step"]:  # the host holds the card back: its own top ops
        host = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        for e in host[:10]:
            print(f"[{tag}]   host {e.self_cpu_time_total / 1e3:8.2f} ms self {e.count:5d}x "
                  f"{e.key[:100]}")
    return ms


LOSSES = ("recon_loss", "commitment_loss", "aeloss", "perceptual_loss", "gan_feat_loss",
          "g_total", "discloss", "d_image_loss", "d_video_loss")


def one_step(trainer, state, video, wiring=None) -> tuple:
    """One train_step: its metrics as floats and the reconstruction of its
    training forward. With a list for `wiring`, every training call of an
    Attention or FeedForward appends (module, relative error): its output
    against the module's plain route on the same input and parameters,
    whole-tensor, computed as the call returns (before the step moves the
    parameters)."""
    from omnitokenizer_tpu_torch.ops import attention as tattn

    kept, handles = [], []
    g_losses = trainer._g_losses

    def keep(*args):
        res = g_losses(*args)
        kept.append(res[1].detach())
        return res

    def against_plain(name, mod, args, kwargs, out):
        if kwargs.get("training"):
            with torch.no_grad(), train_kernel_ops("0"):
                wiring.append((name, rel_norm(out.detach(), mod.forward(*args, **kwargs))))

    if wiring is not None:
        handles = [mod.register_forward_hook(functools.partial(against_plain, name),
                                             with_kwargs=True)
                   for name, mod in state.net.named_modules()
                   if isinstance(mod, (tattn.Attention, tattn.FeedForward))]
    trainer._g_losses = keep
    try:
        _, m = trainer.train_step(state, video)
    finally:
        del trainer._g_losses
        for h in handles:
            h.remove()
    return {k: float(v) for k, v in m.items()}, kept[0]


def wiring_over(name, wiring) -> list:
    """The module calls of a step over the kernels' bar against their plain
    route; prints the largest."""
    worst = max(wiring, key=lambda w: w[1])
    print(f"[8] {name}: {len(wiring)} training calls of Attention/FeedForward against their "
          f"plain route on the same input, largest whole-tensor error {worst[1]:.3e} "
          f"({worst[0]})")
    return [f"{n} {e:.3e} > {KERNEL_REL_TOL}" for n, e in wiring if not e <= KERNEL_REL_TOL]


def step_vs_plain(name, got, got_recon, want, want_recon) -> list:
    """A step's losses, gradient norms and reconstruction against the plain
    route's; prints the readings and returns those over their bars."""
    errs = {k: abs(got[k] - want[k]) / max(abs(got[k]), abs(want[k]), 0.1)
            for k in LOSSES + ("grad_norm_g", "grad_norm_d")}
    errs["x_recon"] = rel_norm(got_recon, want_recon)
    bars = {k: TRAIN_LOSS_REL_TOL for k in LOSSES}
    bars.update(grad_norm_g=TRAIN_GRAD_NORM_REL_TOL, grad_norm_d=TRAIN_GRAD_NORM_REL_TOL,
                x_recon=TRAIN_RECON_REL_TOL)
    print(f"[8] one step, {name} vs plain route (relative to the larger or 0.1; x_recon "
          f"whole-tensor): " + ", ".join(f"{k} {got[k]:.5g}/{want[k]:.5g} ({errs[k]:.2e})"
                                        for k in LOSSES + ("grad_norm_g", "grad_norm_d"))
          + f", x_recon ({errs['x_recon']:.2e})")
    return [f"{k} {v:.3e} > {bars[k]}" for k, v in errs.items() if not v <= bars[k]]


def swap_qk_once(real, route):
    """kernel_fwd_ref_bwd that hands the first call of `route` its q and k
    projection weights swapped (a wiring fault), and the rest unchanged."""
    done = []

    def call(kern, ref, x, gamma, wq, wkv, *rest):
        if not done and isinstance(kern, functools.partial) and kern.args[0] == route:
            done.append(route)
            inner = wq.shape[0]
            wq, wkv = wkv[:inner], torch.cat([wq, wkv[inner:]])
        return real(kern, ref, x, gamma, wq, wkv, *rest)
    return call


def phase8_train(smi: str) -> dict:
    """The flagship GAN training step through train_tokenizer (see the
    module docstring); returns the launches of one step."""
    from omnitokenizer_tpu_torch import imagenet_k600_config
    from omnitokenizer_tpu_torch.config import LossConfig, TrainConfig
    from omnitokenizer_tpu_torch.ops import attention as tattn
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.ops.kernels.ln_qkv import ln_qkv
    from omnitokenizer_tpu_torch.training.loop import (find_latest_checkpoint, load_state,
                                                       train_tokenizer)
    from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer

    cfg = imagenet_k600_config().replace(dtype=BF)
    # bench.py's train_gan losses and schedule
    trainer = TokenizerTrainer(
        cfg, LossConfig(perceptual_weight=1.0, image_gan_weight=1.0, video_gan_weight=1.0,
                        gan_feat_weight=4.0, discriminator_iter_start=0),
        TrainConfig(lr=1e-4, warmup_steps=10, max_steps=1000, warmup_lr_init=1e-5,
                    ema_advances_per_step=2), device="cuda")
    state = trainer.init_state(seed=0)
    print(f"[8] trainer on {trainer.device}: G {sum(p.numel() for p in state.g_params())} "
          f"parameters, D {sum(p.numel() for p in state.d_params())}, LPIPS pretrained "
          f"{trainer.lpips_pretrained}")
    before = {k: v.detach().clone() for k, v in _train_tensors(state).items()}
    video = (torch.randn(B, T, RES, RES, 3, generator=torch.Generator().manual_seed(5))
             * 0.2).cuda()
    stamps = []

    def batches():
        while True:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield {"video": video}

    routes, spatial = {}, [None]
    real, real_forward = tattn.kernel_fwd_ref_bwd, tattn.Attention.forward

    def attention_call(self, x, is_spatial=True, training=False):
        spatial[0] = is_spatial
        return real_forward(self, x, is_spatial, training)

    def counting(kern, ref, *args):
        key = kern.args[0] if isinstance(kern, functools.partial) else "ff"
        if key == "small" and not spatial[0]:
            key = "flat"
        routes[key] = routes.get(key, 0) + 1
        return real(kern, ref, *args)

    with tempfile.TemporaryDirectory() as root:
        # the warm-up step, its launches, its checkpoint
        reset_launch_counts()
        tattn.kernel_fwd_ref_bwd, tattn.Attention.forward = counting, attention_call
        try:
            train_tokenizer(trainer, batches(), root, max_steps=1, initial_state=state,
                            img_every=0, log_every=1)
        finally:
            tattn.kernel_fwd_ref_bwd, tattn.Attention.forward = real, real_forward
        torch.cuda.synchronize()
        per_step = launch_counts()
        print(f"[8] launches in one training step: {per_step}; training-route calls {routes}")
        if per_step != EXPECTED_LAUNCHES["train"]:
            raise AssertionError(f"launch counts {per_step} != {EXPECTED_LAUNCHES['train']}")
        if {k: routes.get(k, 0) for k in EXPECTED_TRAIN_ROUTES} != EXPECTED_TRAIN_ROUTES:
            raise AssertionError(f"training routes {routes} != {EXPECTED_TRAIN_ROUTES}")
        ckpt = find_latest_checkpoint(root)
        saved = load_state(ckpt, trainer.init_state(seed=1))
        if saved.step != 1 or any(not torch.equal(a, b) for a, b in zip(
                _train_tensors(saved).values(), _train_tensors(state).values())):
            raise AssertionError(f"{ckpt} does not hold the state it saved")
        del saved

        # the resumed run: 1 + TRAIN_TIMED steps, the first TRAIN_TIMED timed
        stamps.clear()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        last = 2 + TRAIN_TIMED
        resumed = train_tokenizer(trainer, batches(), root, max_steps=last, img_every=0,
                                  log_every=1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = launch_counts()
        want = {k: v * (last - 1) for k, v in EXPECTED_LAUNCHES["train"].items()}
        if counts != want or resumed.step != last:
            raise AssertionError(f"resumed run: step {resumed.step}, launches {counts} != {want}")
        step_s = (stamps[TRAIN_TIMED] - stamps[0]) / TRAIN_TIMED
        with open(os.path.join(root, "metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        if [r["step"] for r in records] != list(range(last)):
            raise AssertionError(f"metrics.jsonl steps {[r['step'] for r in records]}")
        bad = [(r["step"], k) for r in records for k in LOSSES if not abs(r[k]) < float("inf")]
        if bad:
            raise AssertionError(f"non-finite losses {bad}")
        after = _train_tensors(resumed)
        still = [k for k, v in before.items() if torch.equal(v, after[k])]
        if still:
            raise AssertionError(f"{len(still)} tensors did not move: {still[:5]}")
        print(f"[8] resumed from {os.path.basename(ckpt)} to step {resumed.step}; all "
              f"{len(before)} G/D parameters and codebook buffers moved; last step "
              + ", ".join(f"{k} {records[-1][k]:.4f}" for k in LOSSES + ("perplexity",
                                                                           "avg_usage")))
        print(f"[8] flagship GAN step B={B} {T}x{RES}^2 bf16 ({smi}): {step_s * 1e3:.2f} ms a "
              f"step (mean of {TRAIN_TIMED}), {B * T / step_s:.2f} frames/s, peak "
              f"{peak:.2f} GiB")
        del resumed, state, before, after

        # one step of the kernel route against the plain route from the same
        # state; then 3 more steps of each, timed, in the order kernel,
        # plain, plain, kernel; then one step of each timed by stage
        out, recon, timing, stages, wiring = {}, {}, {"attn,ff,flat": [], "0": []}, {}, []
        for i, ops in enumerate(("attn,ff,flat", "0", "0", "attn,ff,flat")):
            st = load_state(find_latest_checkpoint(root), trainer.init_state(seed=2))
            with train_kernel_ops(ops):
                m, x_recon = one_step(trainer, st, video, wiring if i == 0 else None)
                out.setdefault(ops, m)
                recon.setdefault(ops, x_recon)
                del x_recon
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(3):
                    _, m = trainer.train_step(st, video)
                    float(m["g_total"])
                timing[ops].append(((time.perf_counter() - t0) / 3 * 1e3,
                                    torch.cuda.max_memory_allocated() / 2 ** 30))
                if i >= 2:
                    stages[ops] = profile_train_step(trainer, st, video)
            del st
        for ops, name in (("attn,ff,flat", "kernel route"), ("0", "plain route")):
            print(f"[8] {name}: ms a step (peak GiB), 3 steps each, in the order kernel, "
                  f"plain, plain, kernel: " + ", ".join(f"{t:.2f} ({p:.2f})"
                                                        for t, p in timing[ops]))
        print("[8] device ms by stage, kernel route / plain route: "
              + ", ".join(f"{k} {stages['attn,ff,flat'][k]:.2f} / {stages['0'][k]:.2f}"
                          for k in stages["0"]))
        failed = step_vs_plain("kernel route", out["attn,ff,flat"], recon["attn,ff,flat"],
                               out["0"], recon["0"]) + wiring_over("kernel route", wiring)
        if failed or len(wiring) != sum(EXPECTED_TRAIN_ROUTES.values()):
            raise AssertionError(f"kernel vs plain training step ({len(wiring)} module calls): "
                                 f"{failed}")

        # the fault runs: both comparisons must fail a step whose kernel
        # route swaps the q and k projections in one attention block
        for route in ("cosine", "small"):
            st, wiring = load_state(find_latest_checkpoint(root), trainer.init_state(seed=2)), []
            tattn.kernel_fwd_ref_bwd = swap_qk_once(real, route)
            try:
                m, x_recon = one_step(trainer, st, video, wiring)
            finally:
                tattn.kernel_fwd_ref_bwd = real
            name = f"fault: q/k swapped in the first {route} block"
            if not step_vs_plain(name, m, x_recon, out["0"], recon["0"]):
                raise AssertionError(f"the step comparison passes a q/k swap in a {route} block")
            if len(wiring_over(name, wiring)) != 1:
                raise AssertionError(f"the module check does not single out the {route} block")
            del st, x_recon

    # the inference wrappers refuse a grad-requiring input under grad mode
    gen = torch.Generator().manual_seed(6)
    x = randn(gen, 64, 512, dtype=BF).requires_grad_()
    w = randn(gen, 512, 512, dtype=BF)
    for call in (lambda: ln_qkv(x, torch.ones(512, device=x.device), w, torch.cat([w, w])),
                 lambda: tattn.Attention(512, 64, 8, dtype=BF).to(x.device)(
                     x.detach().view(4, 16, 512))):
        try:
            call()
        except RuntimeError as e:
            if "has no backward" not in str(e):
                raise
        else:
            raise AssertionError("an inference kernel took a grad-requiring input")
    print("[8] ln_qkv and a bf16 Attention's inference call refuse grad-requiring inputs")

    train_route_rows(routes)
    return per_step


# -- phase 9: the eval entry point ----------------------------------------------------------
# the released tokenizer's eval flags (scripts/recons/eval_video.sh), f32
EVAL_FLAGS = (
    "--inference_type video --patch_embed linear --patch_size 8 --temporal_patch_size 4 "
    "--spatial_depth 4 --temporal_depth 4 --embedding_dim 512 --disc_layers 3 "
    "--enc_block ttww --dec_block tttt --twod_window_size 8 --causal_in_temporal_transformer "
    "--causal_in_peg --dim_head 64 --heads 8 --apply_noise --apply_blur --spatial_pos rope "
    "--n_codes 8192 --codebook_dim 8 --l2_code --no_random_restart --batch_size 8 "
    "--loader_type joint --resolution 256 --sequence_length 17 --norm_type batch "
    "--replacewithgt 0").split()
EVAL_B, EVAL_BATCHES = 8, 4
EVAL_REL_TOL = 1e-4        # f32 kernel vs plain route, whole-tensor relative
EVAL_INDEX_AGREE = 0.999   # f32 indices, kernel vs plain route
FEATURES_REL_TOL = 1e-3    # I3D logits / Inception features, card vs CPU, f32


def reference_tokenizer_state(cfg, seed: int = 0) -> dict:
    """A state_dict in the reference's key scheme (Lightning's names for the
    tokenizer, as tests/test_checkpoint.py writes them, the cnn patch embed's too)
    with random values from `seed` at a trained model's scales, plus keys of
    the discriminators and LPIPS that the tokenizer's loader skips."""
    import numpy as np

    rng = np.random.RandomState(seed)
    d, H, dh, ws = cfg.embedding_dim, cfg.heads, cfg.dim_head, cfg.twod_window_size
    inner, ffi = H * dh, int(cfg.ff_mult * 2 / 3 * d)
    p, pt, c = cfg.patch_size, cfg.temporal_patch_size, cfg.image_channels
    sd = {}

    def w(key, *shape, fan_in=None):
        sd[key] = rng.standard_normal(shape) / np.sqrt(fan_in or np.prod(shape[1:]))

    def ones(key, n):
        sd[key] = 1 + 0.1 * rng.standard_normal(n)

    def small(key, n):
        sd[key] = 0.02 * rng.standard_normal(n)

    def zeros(key, *shape):
        sd[key] = np.zeros(shape)

    def transformer(prefix, block, rel):
        for i, blk in enumerate(block):
            a = f"{prefix}.layers.{i}.1"
            if blk == "t":
                w(f"{prefix}.layers.{i}.0.dsconv.weight", d, 1, 3, 3, 3)
                small(f"{prefix}.layers.{i}.0.dsconv.bias", d)
                ones(f"{a}.norm.gamma", d)
                zeros(f"{a}.norm.beta", d)
                ones(f"{a}.context_norm.gamma", d)
                zeros(f"{a}.context_norm.beta", d)
                w(f"{a}.to_q.weight", inner, d)
                w(f"{a}.to_kv.weight", 2 * inner, d)
                w(f"{a}.to_out.weight", d, inner)
                ones(f"{a}.q_scale", dh)
                ones(f"{a}.k_scale", dh)
                if rel:
                    for j, (o, i_) in enumerate(((d, 2), (d, d))):
                        w(f"{a}.spatial_rel_pos_bias.net.{j}.0.weight", o, i_)
                        small(f"{a}.spatial_rel_pos_bias.net.{j}.0.bias", o)
                    w(f"{a}.spatial_rel_pos_bias.net.2.weight", H, d)
                    small(f"{a}.spatial_rel_pos_bias.net.2.bias", H)
            else:  # 'w'
                ones(f"{a}.norm.gamma", d)
                zeros(f"{a}.norm.beta", d)
                w(f"{a}.relative_position_bias_table", (2 * ws - 1) ** 2, H, fan_in=2500)
                sd[f"{a}.relative_position_index"] = np.zeros((ws * ws, ws * ws), np.int64)
                w(f"{a}.qkv.weight", 3 * d, d)
                w(f"{a}.proj.weight", d, d)
                small(f"{a}.proj.bias", d)
            ones(f"{prefix}.layers.{i}.3.0.weight", d)
            small(f"{prefix}.layers.{i}.3.0.bias", d)
            w(f"{prefix}.layers.{i}.3.1.weight", 2 * ffi, d)
            w(f"{prefix}.layers.{i}.3.4.weight", d, ffi)
        ones(f"{prefix}.norm_out.gamma", d)
        zeros(f"{prefix}.norm_out.beta", d)

    def norm(key, n):  # a cnn Normalize (BatchNorm), its running statistics too
        ones(f"{key}.weight", n)
        small(f"{key}.bias", n)
        sd[f"{key}.running_mean"] = 0.1 * rng.standard_normal(n)
        sd[f"{key}.running_var"] = rng.uniform(0.5, 1.5, n)
        sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)

    cnn = cfg.patch_embed == "cnn"
    for name, kt in (("to_patch_emb_first_frame", 1), ("to_patch_emb", pt)):
        n_in = c * kt * p * p
        if cnn:  # Conv3d, Normalize
            w(f"encoder.{name}.0.weight", d, c, kt, p, p)
            small(f"encoder.{name}.0.bias", d)
            norm(f"encoder.{name}.1", d)
            continue
        ones(f"encoder.{name}.1.weight", n_in)
        small(f"encoder.{name}.1.bias", n_in)
        w(f"encoder.{name}.2.weight", d, n_in)
        small(f"encoder.{name}.2.bias", d)
        ones(f"encoder.{name}.3.weight", d)
        small(f"encoder.{name}.3.bias", d)
    rel = cfg.spatial_pos == "rel"
    transformer("encoder.enc_spatial_transformer", cfg.enc_block, rel)
    transformer("encoder.enc_temporal_transformer", "t" * cfg.temporal_depth, False)
    transformer("decoder.dec_temporal_transformer", "t" * cfg.temporal_depth, False)
    transformer("decoder.dec_spatial_transformer", cfg.dec_block, rel)
    for name, kt in (("to_pixels_first_frame", 1), ("to_pixels", pt)):
        if cnn:  # Rearrange, ConvTranspose3d, Normalize
            w(f"decoder.{name}.1.weight", d, c, kt, p, p, fan_in=d)
            small(f"decoder.{name}.1.bias", c)
            norm(f"decoder.{name}.2", c)
            continue
        w(f"decoder.{name}.0.weight", c * kt * p * p, d)
        small(f"decoder.{name}.0.bias", c * kt * p * p)
    code_out = cfg.codebook_dim * (2 if cfg.use_vae else 1)
    w("pre_vq_conv.1.weight", code_out, d)
    small("pre_vq_conv.1.bias", code_out)
    w("post_vq_conv.1.weight", d, cfg.codebook_dim)
    small("post_vq_conv.1.bias", d)
    if not cfg.use_vae:
        sd["codebook.embeddings"] = rng.standard_normal((cfg.n_codes, cfg.codebook_dim))
        sd["codebook.N"] = np.ones(cfg.n_codes)
        sd["codebook.z_avg"] = sd["codebook.embeddings"].copy()
        sd["codebook.codebook_usage"] = np.zeros(cfg.n_codes)
    w("image_discriminator.model0.0.weight", 64, 3, 4, 4)
    w("video_discriminator.model0.0.weight", 64, 3, 4, 4, 4)
    w("perceptual_model.lin0.model.1.weight", 1, 64, 1, 1)
    return {k: torch.from_numpy(v.astype(np.int64 if v.dtype == np.int64 else np.float32))
            for k, v in sd.items()}


def write_and_load(tag: str, path: str, flags: list):
    """Write a Lightning-style checkpoint of the config the eval flags
    describe (reference names, random values from seed 0, the run's
    Namespace in its hparams), load it on the card through
    OmniTokenizerVQGAN.load_from_checkpoint, and check that every tensor of
    the port's net equals, bit for bit, the file tensor that the key map
    (utils/checkpoint.py:port_key) sends to its key, and that no tensor was
    left unfilled."""
    import numpy as np

    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN
    from omnitokenizer_tpu_torch.cli import args as A
    from omnitokenizer_tpu_torch.cli import vqgan_eval
    from omnitokenizer_tpu_torch.utils.checkpoint import port_key

    args = A.normalize_precision(vqgan_eval.build_parser().parse_args(
        flags + ["--vqgan_ckpt", path]))
    cfg = A.tokenizer_config_from(args)
    sd = reference_tokenizer_state(cfg.replace(dtype=torch.float32), seed=0)
    if not os.path.exists(path):
        torch.save({"state_dict": sd, "hyper_parameters": {"args": args}}, path)
    t0 = time.perf_counter()
    model = OmniTokenizerVQGAN.load_from_checkpoint(path, cfg=cfg)  # the card: the default
    load_s = time.perf_counter() - t0

    sent = {}  # port key -> the file tensor in the port's layout
    for key, val in sd.items():
        k, v = port_key(key, val.numpy(), cfg)
        if k is not None:
            sent[k] = v
    port = {k: v for k, v in model.net.state_dict().items()
            if k not in ("codebook.initialized", "codebook.call_cnt")}
    wrong = [k for k, v in port.items()
             if k not in sent or not np.array_equal(v.detach().float().cpu().numpy(), sent[k])]
    if model.unfilled or wrong or model.device.type != "cuda":
        raise AssertionError(f"{path}: unfilled {model.unfilled[:5]}, tensors unequal to the "
                             f"file tensor mapped to them {wrong[:5]}, device {model.device}")
    print(f"[{tag}] loaded {os.path.basename(path)} on {model.device} in {load_s:.2f} s: all "
          f"{len(port)} tensors ({model.num_params()} parameters) equal to the file tensors "
          f"the key map sends to them; none left at init")
    return model, args


class SyntheticClips:
    """An in-memory dataset of `n` clips of T frames of RES^2 made from a seed:
    8x8-pixel blocks of random colour, uint8, normalized to [-0.5, 0.5] by the
    port's native host kernel (numpy without a compiler). The card's host may
    have no PIL, imageio or libav to read files with."""

    def __init__(self, n: int, seed: int = 0):
        self.n, self.seed = n, seed

    def __len__(self) -> int:
        return self.n

    def clip_u8(self, i: int):
        import numpy as np

        rng = np.random.RandomState(self.seed + i)
        small = rng.randint(0, 256, (T, RES // 8, RES // 8, 3), np.uint8)
        return small.repeat(8, axis=1).repeat(8, axis=2)

    def __getitem__(self, i: int) -> dict:
        from omnitokenizer_tpu_torch.native import normalize_u8

        return {"video": normalize_u8(self.clip_u8(i)), "label": 0}


def eval_run(tag: str, model, args, expected: dict) -> dict:
    """vqgan_eval.evaluate over EVAL_BATCHES batches of EVAL_B clips through
    the port's DataLoader: launches per batch, the result, clips/s (host
    clock around the whole call, data loading and host metrics included)
    and the peak memory."""
    from omnitokenizer_tpu_torch.cli import vqgan_eval
    from omnitokenizer_tpu_torch.data.loader import DataLoader
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    loader = DataLoader(SyntheticClips(EVAL_B * EVAL_BATCHES), EVAL_B, shuffle=False,
                        drop_last=False, epochs=1, num_workers=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = vqgan_eval.evaluate(model, iter(loader), args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = launch_counts()
    per_batch = {k: v / EVAL_BATCHES for k, v in counts.items()}
    print(f"[{tag}] evaluate: {result}; launches a batch {per_batch}; "
          f"{EVAL_B * EVAL_BATCHES / secs:.2f} clips/s ({secs:.2f} s for "
          f"{EVAL_B * EVAL_BATCHES} clips of {T}x{RES}^2, data and host metrics included), "
          f"peak {peak:.2f} GiB")
    if result["batches"] != EVAL_BATCHES or per_batch != expected:
        raise AssertionError(f"evaluate: {result['batches']} batches, launches a batch "
                             f"{per_batch} != {expected}")
    if not (result["psnr"] is not None and abs(result["psnr"]) < float("inf")):
        raise AssertionError(f"evaluate: PSNR {result['psnr']}")
    return {k: int(v) for k, v in per_batch.items()}


def eval_breakdown(tag: str, model, args) -> None:
    """Where one evaluate call's time goes: the loader alone (the clips made,
    normalized and stacked, no model), and one profiled evaluate for the
    device's busy time (its kernels' self time) against the call's wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    from omnitokenizer_tpu_torch.cli import vqgan_eval
    from omnitokenizer_tpu_torch.data.loader import DataLoader

    def loader():
        return DataLoader(SyntheticClips(EVAL_B * EVAL_BATCHES), EVAL_B, shuffle=False,
                          drop_last=False, epochs=1, num_workers=2)

    t0 = time.perf_counter()
    n = sum(len(b["video"]) for b in loader())
    load_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vqgan_eval.evaluate(model, iter(loader()), args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"[{tag}] the loader alone: {load_s * 1e3:.1f} ms for {n} clips; one profiled "
          f"evaluate: {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")


def first_batch() -> torch.Tensor:
    """The eval's first batch as (B, C, T, H, W) on the card."""
    import numpy as np

    ds = SyntheticClips(EVAL_B * EVAL_BATCHES)
    video = np.stack([ds[i]["video"] for i in range(EVAL_B)])
    return torch.from_numpy(video).cuda().permute(0, 4, 1, 2, 3)


def f32_vq_vs_plain(tag: str, model, video: torch.Tensor) -> torch.Tensor:
    """The f32 VQ eval round trip against the plain route: route_bars at the
    eval's bars, the whole round trip within EVAL_REL_TOL, and both routes'
    frames/s and peak memory. Returns the kernel route's reconstruction."""
    xl = video.permute(0, 2, 3, 4, 1)
    with torch.inference_mode():
        idx = model.encode(video, is_image=False)
        rec = model.decode(idx, is_image=False)
        full_err = rel_norm(rec.permute(0, 2, 3, 4, 1), plain_vq_round_trip(model, xl))
    route_bars(tag, model, video, idx, EVAL_REL_TOL, EVAL_REL_TOL, EVAL_INDEX_AGREE)
    print(f"[{tag}] f32 whole round trip, B={video.shape[0]}: kernel vs plain route rel err "
          f"{full_err:.3e}")
    if not full_err <= EVAL_REL_TOL:
        raise AssertionError(f"f32 eval round trip kernel vs plain: {full_err:.3e}")
    with torch.inference_mode():
        fps_k, mem_k = fps_and_peak(lambda: model.decode(model.encode(video, False), False),
                                    EVAL_B * T, iters=3)
        fps_p, mem_p = fps_and_peak(lambda: plain_vq_round_trip(model, xl), EVAL_B * T, iters=3)
    print(f"[{tag}] round trip B={EVAL_B} {T}x{RES}^2 f32: kernel route {fps_k:.2f} frames/s "
          f"(peak {mem_k:.2f} GiB), plain route {fps_p:.2f} frames/s (peak {mem_p:.2f} GiB)")
    return rec


def f32_vae_vs_plain(tag: str, model, video: torch.Tensor) -> None:
    """The f32 VAE against the plain route on the same noise (phase 5's bars)."""
    from omnitokenizer_tpu_torch.ops.gaussian import DiagonalGaussian

    net = model.net
    xl = video.permute(0, 2, 3, 4, 1)
    with torch.inference_mode():
        post_k = DiagonalGaussian.from_params(net.encode_latent(xl, False))
        post_p = DiagonalGaussian.from_params(net.encode_latent(xl, False, training=True))
        z = post_p.sample(generator=torch.Generator(device="cuda").manual_seed(0))
        errs = {"mean": rel_norm(post_k.mean, post_p.mean),
                "logvar": rel_norm(post_k.logvar, post_p.logvar),
                "decode": rel_norm(net.decode_latent(z, False),
                                   net.decode_latent(z, False, training=True))}
    print(f"[{tag}] f32 VAE kernel vs plain route, rel err: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= EVAL_REL_TOL}
    if bad:
        raise AssertionError(f"f32 VAE eval kernel vs plain: {bad}")


def eval_features(tag: str, real_u8, fake_u8) -> None:
    """FVD's I3D and FID's Inception with random weights (I3D the JAX
    package's init): on the card against the CPU in f32 (2 clips, 4 frames),
    then timed on the card, I3D per 16 clips and Inception per 32 frames;
    the FVD between the eval's input and reconstructed clips, a pipeline
    check with random features, not a metric."""
    import numpy as np

    from omnitokenizer_tpu_torch.eval.frechet import frechet_distance
    from omnitokenizer_tpu_torch.eval.i3d import compute_fvd_logits, load_i3d
    from omnitokenizer_tpu_torch.eval.inception import compute_fid_features, load_inception

    i3d_gpu, _ = load_i3d(None)
    i3d_cpu, _ = load_i3d(None, device="cpu")
    inc_gpu, _ = load_inception(None)
    inc_cpu, _ = load_inception(None, device="cpu")
    frames = np.concatenate([real_u8[:2, 0], fake_u8[:2, 0]]).astype(np.float32) / 255.0
    errs = {"i3d": rel_err(torch.from_numpy(compute_fvd_logits(real_u8[:2], i3d_gpu)),
                           torch.from_numpy(compute_fvd_logits(real_u8[:2], i3d_cpu))),
            "inception": rel_err(torch.from_numpy(compute_fid_features(frames, inc_gpu)),
                                 torch.from_numpy(compute_fid_features(frames, inc_cpu)))}
    del i3d_cpu, inc_cpu
    print(f"[{tag}] card vs CPU, f32, max-abs ratio: " + ", ".join(f"{k} {v:.3e}"
                                                               for k, v in errs.items()))
    if not max(errs.values()) <= FEATURES_REL_TOL:
        raise AssertionError(f"feature extractors, card vs CPU: {errs}")
    clips = np.concatenate([real_u8, fake_u8])[:16]
    all_frames = clips[:2].reshape(-1, *clips.shape[2:])[:32].astype(np.float32) / 255.0
    i3d_ms = cuda_ms(lambda: compute_fvd_logits(clips, i3d_gpu, batch=16), iters=3, warmup=1,
                     queued=False)
    inc_ms = cuda_ms(lambda: compute_fid_features(all_frames, inc_gpu, batch=32), iters=3,
                     warmup=1, queued=False)
    fvd = frechet_distance(compute_fvd_logits(real_u8, i3d_gpu),
                           compute_fvd_logits(fake_u8, i3d_gpu))
    print(f"[{tag}] I3D {i3d_ms:.2f} ms per 16 clips of {T}x{RES}^2 (resize to 224 included), "
          f"Inception {inc_ms:.2f} ms per 32 frames (resize to 299 included); FVD of the "
          f"{len(real_u8)} input vs reconstructed clips with random I3D features: {fvd:.4f} "
          f"(a pipeline check, not a metric)")
    if not abs(fvd) < float("inf"):
        raise AssertionError(f"FVD {fvd}")


def phase9_eval() -> dict:
    """The eval entry point at the released tokenizer's flags; returns the
    launches a batch of each eval path."""
    import numpy as np

    from omnitokenizer_tpu_torch.cli import vqgan_eval
    from omnitokenizer_tpu_torch.ops.kernels import mha as mh

    paths = {}
    with tempfile.TemporaryDirectory() as root:
        flags = EVAL_FLAGS + ["--save", root]
        ckpt = os.path.join(root, "imagenet_k600.ckpt")
        # (a) the checkpoint, (b) f32 VQ eval
        f32, args = write_and_load("9a", ckpt, flags)
        paths["eval_f32"] = eval_run("9b", f32, args, EXPECTED_LAUNCHES["eval_f32"])
        eval_breakdown("9b", f32, args)
        video = first_batch()
        rec = f32_vq_vs_plain("9b", f32, video)
        real_u8 = np.stack([SyntheticClips(EVAL_B).clip_u8(i) for i in range(EVAL_B)])
        fake_u8 = vqgan_eval._to_u8(rec.float().permute(0, 2, 3, 4, 1).cpu().numpy())
        del rec
        # (c) the same checkpoint with --bf16
        bf16, args16 = write_and_load("9c", ckpt, flags + ["--bf16"])
        paths["eval_bf16"] = eval_run("9c", bf16.serving(), args16,
                                      EXPECTED_LAUNCHES["eval_bf16"])
        eval_breakdown("9c", bf16, args16)
        with torch.inference_mode():
            idx = bf16.encode(video, is_image=False)
        route_bars("9c", bf16, video, idx, LATENT_REL_TOL, DECODE_REL_TOL, ref32=f32)
        del idx
        del bf16, f32
        # (d) an f32 VAE checkpoint
        vae, args_vae = write_and_load("9d", os.path.join(root, "imagenet_k600_vae.ckpt"),
                                       flags + ["--use_vae"])
        paths["eval_vae"] = eval_run("9d", vae, args_vae, EXPECTED_LAUNCHES["eval_vae"])
        f32_vae_vs_plain("9d", vae, video)
        del vae
    torch.cuda.empty_cache()
    # (e) the feature extractors of FVD and FID
    eval_features("9e", real_u8, fake_u8)

    # mha's f32 flash branch at the eval's shape: the 6 spatial blocks, B=8
    g = torch.Generator().manual_seed(10)
    shape = (EVAL_B * (1 + (T - 1) // 4), 8, (RES // 8) ** 2, 64)
    q, k = (F.normalize(randn(g, *shape), dim=-1) for _ in range(2))
    v = randn(g, *shape)
    err = compare("mha f32 eval", mh.mha(q, k, v, 8.0, False), mh.mha_plain(q, k, v, 8.0, False),
                  MHA_F32_REL_TOL)
    bh, n = shape[0] * shape[1], shape[2]
    record("9", "mha", "eval_f32", [err], lambda: mh.mha(q, k, v, 8.0, False),
           lambda: mh.mha_plain(q, k, v, 8.0, False),
           bound(3 * 4 * bh * n * n * 64, 4 * bh * n * 64 * 4, PEAK_TF32),
           lambda: F.scaled_dot_product_attention(q, k, v, scale=8.0),
           shape=list(shape), dtype="float32", causal=False)
    del q, k, v
    # and vq_argmin at the eval's rows: 8 clips x 5 x 32 x 32
    check_vq("9", "eval_f32", F.normalize(randn(g, EVAL_B * 5 * 1024, 8), dim=-1).contiguous(),
             randn(g, 8192, 8))
    return paths



# -- phase 10: LM synthesis serving ---------------------------------------------------------
# the flagship LM of scripts/lm_gen/gen_imagenet_class_cfg.sh: 24 layers, 16 heads, width
# 1536, vocab 8192 codes + 1000 classes + sos, block 1025; the frame-prediction LM of
# gen_k600_frame_prediction.sh: unconditional, vocab 8192, block 5120
LM_LAYERS, LM_HEADS, LM_WIDTH, LM_BLOCK = 24, 16, 1536, 1025
LM_GEN_LAYERS = 6  # phase 10's depth: a quarter of the flagship's, to keep the run inside its time
LM_B, LM_FRAME_B = 8, 2
LM_CACHE_REL_TOL = 2e-2   # bf16 cached prefill + decode vs the full forward, whole-tensor
LM_WINDOW_REL_TOL = 1e-4  # f32 teacher-forced logits, bucketed windows vs the whole block
LM_INT8_MEAN_REL = 0.1    # int8 vs bf16 logits, mean |diff| / mean |bf16| (tests/test_int8.py)
LM_GREEDY_STEPS = 128


def lm_model(vocab: int, block: int, seed: int = 0, layers: int = LM_LAYERS, dtype=BF):
    """The LM at full width, f32 masters computing in `dtype` (bf16), minGPT's init
    from `seed` on the card, and the position table N(0, 0.02) (minGPT
    leaves it 0, which would hide a wrong position)."""
    from omnitokenizer_tpu_torch.config import GPTConfig
    from omnitokenizer_tpu_torch.models.gpt import GPT, init_weights

    cfg = GPTConfig(vocab_size=vocab, block_size=block, n_layer=layers, n_head=LM_HEADS,
                    n_embd=LM_WIDTH, dtype=dtype)
    with torch.device("cuda"):
        gpt = GPT(cfg)
    gen = torch.Generator("cuda").manual_seed(seed)
    init_weights(gpt, gen)
    with torch.no_grad():
        gpt.pos_emb.normal_(0.0, 0.02, generator=gen)
    return gpt.eval()


def lm_step_bytes(cfg, rows: int, window: int, int8: bool) -> float:
    """Bytes a decode step must move: every block weight, bias and the head
    read once (bf16; or int8 with f32 per-channel scales and f32 biases),
    the rows' keys and values over the window read, their new ones written.
    The embedding rows and LayerNorm vectors are left out (under 0.1%)."""
    C, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    weights, biases = L * 12 * C * C + V * C, L * 9 * C
    w = weights + (2 * biases + V) * 4 if int8 else (weights + biases) * 2
    return w + rows * 2 * L * (window + 1) * C * 2


def phase10a_lm(gpt) -> None:
    """The flagship LM's forwards on the card: the cache against the full
    forward, bucketed windows against the whole block in f32, the graph
    greedy sampler against the eager loop, int8 against bf16."""
    from omnitokenizer_tpu_torch.models.gpt import (_cast_params_once, _decode_segments,
                                                     init_cache, make_sampler)
    from omnitokenizer_tpu_torch.ops.int8 import quantize_gpt_decode_params

    cfg = gpt.cfg
    g = torch.Generator().manual_seed(20)
    idx = torch.randint(0, cfg.vocab_size, (2, 300), generator=g).cuda()
    with torch.no_grad():
        served = _cast_params_once(gpt, cfg)
        full, _ = served(idx[:, :64])
        caches = init_cache(cfg, 2)
        parts = [served(idx[:, :32], caches, 0)[0]]
        for t in range(32, 64):
            parts.append(served(idx[:, t:t + 1], caches, torch.tensor([t], device="cuda"))[0])
        err = rel_norm(torch.cat(parts, 1), full)
        print(f"[10a] bf16 cached prefill 32 + decode 32 vs the full forward on 64 tokens: "
              f"rel err {err:.3e} (bar {LM_CACHE_REL_TOL})")
        if not err <= LM_CACHE_REL_TOL:
            raise AssertionError(f"cached logits rel err {err:.3e} > {LM_CACHE_REL_TOL}")

        f32 = _cast_params_once(gpt, cfg.replace(dtype=torch.float32))
        logits = {}
        for bucket in (None, 128):
            caches = init_cache(f32.cfg, 2)
            out = [f32(idx[:, :2], caches, 0)[0][:, -1]]
            for off, n, win in _decode_segments(2, 298, cfg.block_size, bucket):
                for t in range(2 + off, 2 + off + n):
                    out.append(f32(idx[:, t:t + 1], caches, torch.tensor([t], device="cuda"),
                                   kv_window=win)[0][:, -1])
            logits[bucket] = torch.stack(out, 1)
        del caches, f32
        err = rel_norm(logits[128], logits[None])
        print(f"[10a] f32 teacher-forced logits over 300 tokens, windows 256/512 vs the whole "
              f"block: rel err {err:.3e} (max-abs ratio {rel_err(logits[128], logits[None]):.3e};"
              f" bar {LM_WINDOW_REL_TOL})")
        if not err <= LM_WINDOW_REL_TOL:
            raise AssertionError(f"windowed logits rel err {err:.3e} > {LM_WINDOW_REL_TOL}")

        quant = quantize_gpt_decode_params(gpt)
        l8, _ = _cast_params_once(gpt, cfg.replace(int8_decode=True))(idx[:, :64], quant=quant)
        err = float((l8 - full).abs().mean() / full.abs().mean())
        print(f"[10a] int8 full-forward logits vs bf16 on 64 tokens: mean rel {err:.3e} "
              f"(bar {LM_INT8_MEAN_REL}); whole-tensor {rel_norm(l8, full):.3e}")
        if not err <= LM_INT8_MEAN_REL:
            raise AssertionError(f"int8 logits mean rel {err:.3e} > {LM_INT8_MEAN_REL}")
        del served, quant, full, l8

    cond = torch.randint(0, cfg.vocab_size, (LM_B, 2), generator=g).cuda()
    toks = {}
    for graphs in (True, False):
        sample = make_sampler(cfg, LM_GREEDY_STEPS, greedy=True, bucket=64, cuda_graphs=graphs)
        toks[graphs] = sample(gpt, cond)
        ms = [f"{win}: {m:.4f}" for win, _, m in sample.segment_ms()]
        print(f"[10a] greedy sampler B={LM_B}, {LM_GREEDY_STEPS} steps, "
              f"{'CUDA graphs' if graphs else 'eager'}: ms/step by window {ms}")
    same = float((toks[True] == toks[False]).float().mean())
    print(f"[10a] graph vs eager greedy tokens: {same:.5%} equal "
          f"({len(set(toks[True].flatten().tolist()))} distinct tokens)")
    if not torch.equal(toks[True], toks[False]):
        raise AssertionError("the graph greedy sampler's tokens differ from the eager loop's")


def lm_report(tag: str, fn, rows: int, int8: bool, cfg, tokens: int, wall_s: float,
              items: int, unit: str, eager_fn, peak: float) -> dict:
    """Print and return a generation's numbers: decode ms/step by window
    (CUDA events around the replays) beside its bound, tokens/s and items/s
    end to end, peak memory, and the eager loop's ms/step."""
    windows = []
    for win, n, ms in fn.segment_ms():
        w = cfg.block_size if win is None else win
        bound_ms = lm_step_bytes(cfg, rows, w, int8) / HBM_BYTES_PER_S * 1e3
        windows.append({"window": w, "steps": n, "ms_per_step": ms, "bound_ms": bound_ms})
    eager = [m for _, _, m in eager_fn.segment_ms()]
    row = {"path": tag, "int8": int8, "tokens_per_s": tokens / wall_s,
           f"{unit}_per_s": items / wall_s, "wall_s": wall_s, "peak_gib": peak,
           "eager_ms_per_step": eager[0], "windows": windows}
    print(f"[{tag}] {'int8' if int8 else 'bf16'}: {tokens / wall_s:.1f} tokens/s, "
          f"{items / wall_s:.3f} {unit}/s end to end ({wall_s:.3f} s), peak {peak:.2f} GiB; "
          f"decode ms/step (bound) by window "
          f"{[(w['window'], round(w['ms_per_step'], 4), round(w['bound_ms'], 4)) for w in windows]}; "
          f"eager {eager[0]:.4f} ms/step over 64 steps")
    return row


def lm_breakdown(tag: str, run, steps: int) -> None:
    """Where a decode step's device time goes: one eager sampler call of
    `steps` decode steps under torch.profiler (the same kernels a replayed
    graph runs), its kernels' self time a step, the largest first."""
    from torch.profiler import ProfilerActivity, profile

    def self_dev(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=self_dev, reverse=True)
    busy = sum(self_dev(e) for e in kernels)
    print(f"[{tag}] eager decode under the profiler: device busy {busy / steps:.4f} ms a step "
          f"(prefill included), {sum(e.count for e in kernels) / steps:.0f} kernels a step")
    for e in kernels[:8]:
        print(f"[{tag}]   {self_dev(e) / steps:8.4f} ms {e.count / steps:6.1f}x {e.key[:100]}")


def phase10b_class(gpt, tok) -> tuple:
    """Class-conditional CFG image generation at gen_imagenet_class_cfg.sh's
    flags, in bf16 and int8; returns (launches of the lm path, rows)."""
    from omnitokenizer_tpu_torch.config import Net2NetConfig
    from omnitokenizer_tpu_torch.models.gpt import _cast_params_once, init_cache
    from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    n2n = Net2NetTransformer(Net2NetConfig(gpt=gpt.cfg, class_cond_dim=1000, starts_with_sos=True,
                                           class_first=True, first_stage_vocab_size=8192),
                             tok, gpt=gpt)
    flags = dict(top_k=2048, top_p=1.0, cfg_ratio=1.5, use_cfg=True, scale_cfg=True, bucket=256)
    classes = torch.arange(0, 1000, 125)
    hw = tok.cfg.latent_hw
    with torch.no_grad():  # the two prefills of a batch (cond on 2 tokens, uncond on sos)
        served = _cast_params_once(gpt, gpt.cfg)
        caches = init_cache(gpt.cfg, 2 * LM_B)
        prefix = torch.stack([classes + 1, torch.zeros_like(classes)], 1).cuda()
        prefill_ms = cuda_ms(lambda: (served(prefix, [(k[:LM_B], v[:LM_B]) for k, v in caches], 0),
                                      served(prefix[:, 1:], [(k[LM_B:], v[LM_B:]) for k, v in caches],
                                             0)), iters=5, queued=False)
        del served, caches
    print(f"[10b] prefill (cond 2 tokens + uncond 1, B={LM_B}): {prefill_ms:.4f} ms")
    rows, counts = [], None
    for int8 in (False, True):
        sample = n2n.make_class_conditional_sampler(hw * hw, int8=int8, **flags)
        eager = n2n.make_class_conditional_sampler(65, int8=int8, cuda_graphs=False, **flags)
        gen = torch.Generator("cuda").manual_seed(7)
        eager(classes, gen)
        sample(classes, gen)  # warm: the shapes' first cuBLAS calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        ids = sample(classes, gen)
        pixels = n2n.decode_to_pixels(ids, is_image=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[10b] launches in one class-conditional batch ({'int8' if int8 else 'bf16'}): {got}")
        if got != EXPECTED_LAUNCHES["lm_class"]:
            raise AssertionError(f"launch counts {got} != {EXPECTED_LAUNCHES['lm_class']}")
        counts = got
        if (tuple(ids.shape) != (LM_B, hw * hw) or int(ids.min()) < 0 or int(ids.max()) >= 8192
                or tuple(pixels.shape) != (LM_B, 3, RES, RES)
                or not bool(torch.isfinite(pixels).all())):
            raise AssertionError(f"bad generation {tuple(ids.shape)} {tuple(pixels.shape)}")
        print(f"[10b] ids: {len(set(ids.flatten().tolist()))} distinct codes of 8192")
        rows.append(lm_report("10b", sample.fn, 2 * LM_B, int8, gpt.cfg, LM_B * hw * hw, wall,
                              LM_B, "images", eager.fn, peak))
        with torch.inference_mode(), train_kernel_ops("0"):
            grid = ids.view(LM_B, 1, hw, hw)
            dec_k = tok.net.decode(grid, True)
            dec_p = tok.net.decode_latent(tok.net.codebook.lookup(grid), True, training=True)
        err = rel_norm(dec_k, dec_p)
        print(f"[10b] decode of the generated ids: kernel vs plain route rel err {err:.3e} "
              f"(bar {DECODE_REL_TOL})")
        if not err <= DECODE_REL_TOL:
            raise AssertionError(f"decode rel err {err:.3e} > {DECODE_REL_TOL}")
        short = n2n.make_class_conditional_sampler(17, int8=int8, cuda_graphs=False, **flags)
        lm_breakdown(f"10b {'int8' if int8 else 'bf16'}", lambda: short(classes, gen), 16)
        del sample, eager, short, ids, pixels, dec_k, dec_p
    return counts, rows


def phase10c_frames(tok) -> tuple:
    """Frame prediction at gen_k600_frame_prediction.sh's flags (int8, bf16);
    returns (launches of the lm path, row)."""
    from omnitokenizer_tpu_torch.config import Net2NetConfig
    from omnitokenizer_tpu_torch.models.gpt import _cast_params_once, init_cache, make_sampler
    from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer
    from omnitokenizer_tpu_torch.ops.int8 import quantize_gpt_decode_params
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    gpt = lm_model(8192, 5120, seed=1, layers=LM_GEN_LAYERS)
    n2n = Net2NetTransformer(Net2NetConfig(gpt=gpt.cfg, unconditional=True,
                                           first_stage_vocab_size=8192), tok, gpt=gpt)
    lt, hw = tok.cfg.latent_t, tok.cfg.latent_hw
    flags = dict(top_k=2048, top_p=0.9, bucket=512, int8=True)
    g = torch.Generator().manual_seed(21)
    clips = (torch.rand(LM_FRAME_B, 3, T, RES, RES, generator=g) - 0.5).cuda()
    prefix = torch.randint(0, 8192, (LM_FRAME_B, 1 + 2 * hw * hw), generator=g).cuda()
    cfg8 = gpt.cfg.replace(int8_decode=True)
    with torch.no_grad():
        quant = quantize_gpt_decode_params(gpt)
        served = _cast_params_once(gpt, cfg8)
        caches = init_cache(gpt.cfg, LM_FRAME_B)
        prefill_ms = cuda_ms(lambda: served(prefix, caches, 0, quant=quant), iters=3,
                             queued=False)
        del served, caches
    print(f"[10c] prefill ({prefix.shape[1]} tokens, B={LM_FRAME_B}, int8): {prefill_ms:.4f} ms")
    # the eager loop over 64 steps after the same prefix length
    eager = make_sampler(cfg8, 65, top_k=2048, top_p=0.9, bucket=512, cuda_graphs=False)
    eager(gpt, prefix, torch.Generator("cuda").manual_seed(9), quant=quant)
    del quant
    sample = n2n.make_frame_prediction_sampler(lt, 2, **flags)
    gen = torch.Generator("cuda").manual_seed(8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    grid = sample(clips, gen)
    pixels = n2n.decode_to_pixels(grid.reshape(LM_FRAME_B, -1), is_image=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[10c] launches in one frame prediction of {LM_FRAME_B} clips: {counts}")
    if counts != EXPECTED_LAUNCHES["lm_frame"]:
        raise AssertionError(f"launch counts {counts} != {EXPECTED_LAUNCHES['lm_frame']}")
    if (tuple(grid.shape) != (LM_FRAME_B, lt, hw, hw) or tuple(pixels.shape) != tuple(clips.shape)
            or not bool(torch.isfinite(pixels).all())):
        raise AssertionError(f"bad prediction {tuple(grid.shape)} {tuple(pixels.shape)}")
    with torch.inference_mode():
        enc = tok.encode(clips, is_image=False)
    if not torch.equal(grid[:, :2].int(), enc[:, :2].int()):
        raise AssertionError("the returned grid's first two latent frames are not the encode's")
    print(f"[10c] the grid's first 2 latent frames equal the encode's ids; the 3 continued "
          f"hold {len(set(grid[:, 2:].flatten().tolist()))} distinct codes")
    row = lm_report("10c", sample.fn, LM_FRAME_B, True, gpt.cfg, LM_FRAME_B * (lt - 2) * hw * hw,
                    wall, LM_FRAME_B, "clips", eager, peak)
    return counts, row


def phase10_lm() -> dict:
    """LM synthesis serving: 10a the flagship LM, 10b class-conditional
    CFG image generation, 10c frame prediction; returns the lm paths'
    launches."""
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, imagenet_k600_config

    t0 = time.perf_counter()
    gpt = lm_model(9193, 1025, layers=LM_GEN_LAYERS)
    print(f"[10] LM: {sum(p.numel() for p in gpt.parameters())} parameters "
          f"({LM_GEN_LAYERS} of the flagship's {LM_LAYERS} layers x {LM_WIDTH}, {LM_HEADS} "
          f"heads, vocab 9193, block 1025)")
    phase10a_lm(gpt)
    tok = OmniTokenizerVQGAN.from_config(imagenet_k600_config().replace(dtype=BF), seed=0,
                                         device="cuda").serving()
    paths = {}
    paths["lm_class"], rows = phase10b_class(gpt, tok)
    del gpt
    torch.cuda.empty_cache()
    paths["lm_frame"], row = phase10c_frames(tok)
    print(json.dumps({"lm": rows + [row]}))
    print(f"[10] phase 10 in {time.perf_counter() - t0:.1f} s")
    return paths


# -- phase 11: diffusion synthesis ------------------------------------------------------------
# DiT-XL/2 at the OmniTokenizer settings of the reference's DiT train.py (8 latent channels,
# 32x32 latents of 256^2 images, 1000 classes, learned sigma) and Latte-XL/2-omnitokenizer
# (17x256^2 clips: 5 latent frames, 101 classes, extras 2), both behind the f32 VAE of
# imagenet_k600_config(use_vae=True). Random weights from seed 0 with every tensor filled
# N(0, 0.02): the JAX init zeroes the adaLN modulations and the final linear, and a model that
# outputs 0 would compare nothing.
DIFF_STD = 0.02
DIFF_F32_REL_TOL = 1e-4   # card f32 vs CPU f32, whole-tensor (summation order only)
DIFF_BF16_REL_TOL = 5e-2  # bf16 vs f32 on the card, whole-tensor
DIFF_DDIM_REL_TOL = 1e-3  # 10 DDIM steps (eta 0) from one noise, card f32 vs CPU f32
DIT_B, LATTE_B = 8, 2             # images / clips a sampling batch (CFG doubles the rows)
DIT_TRAIN_B, LATTE_TRAIN_B = 32, 4  # the reference's global 256 over 8 GPUs; 4 clips
DIFF_DEPTH = 8            # phase 11's blocks, of XL's 28: to keep the run inside its time
LATTE_F32_STEPS = 50      # f32 Latte sampling: enough steps to read its ms a step
# the f32 VAE's mha launches: its decoder's 4 spatial 't' blocks in a decode, its encoder's 2
# in an encode (the temporal blocks, N = 5, take the plain math)
DIFF_LAUNCHES = {"decode": {**{k: 0 for k in KERNELS}, "mha": 4},
                 "encode": {**{k: 0 for k in KERNELS}, "mha": 2}}
SAMPLE_FLAGS = ["--ckpt", "random-weights"]


@contextlib.contextmanager
def diffusion_depth(depth: int):
    """The diffusion CLIs' models at `depth` blocks inside (their widths as
    the flags give them): diffusion_common.model_config patched."""
    from omnitokenizer_tpu_torch.cli import diffusion_common

    full = diffusion_common.model_config
    diffusion_common.model_config = lambda args, video: full(args, video).replace(depth=depth)
    try:
        yield
    finally:
        diffusion_common.model_config = full


def fill_random(model, seed: int = 0):
    """Every parameter N(0, DIFF_STD^2), drawn on the card from `seed`."""
    g = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device="cuda") * DIFF_STD)
    return model


def served_as(model, dtype):
    """A copy of `model` for sampling, its parameters cast once to `dtype`."""
    saved = model.cfg
    model.cfg = saved.replace(dtype=dtype)
    try:
        return model.serving()
    finally:
        model.cfg = saved


def diffusion_flops(cfg, rows: int, video: bool) -> float:
    """FLOPs of one forward of `rows` samples, every product counted as the
    code runs it (the temporal blocks' modulation runs once per patch)."""
    D, p = cfg.hidden_size, cfg.patch_size
    N = (cfg.input_size // p) ** 2
    F_ = cfg.num_frames if video else 1
    mlp = int(D * cfg.mlp_ratio)
    lin = 2 * D * (3 * D + D) + 2 * 2 * D * mlp  # qkv, proj, fc1, fc2 a token
    ada = 2 * D * 6 * D
    flops = 2 * N * F_ * cfg.in_channels * p * p * D + 2 * (256 * D + D * D)
    if video:
        half = cfg.depth // 2
        flops += half * (N * F_ * lin + F_ * 4 * N * N * D + F_ * ada)  # spatial blocks
        flops += half * (N * F_ * lin + N * 4 * F_ * F_ * D + N * ada)  # temporal blocks
    else:
        flops += cfg.depth * (N * lin + 4 * N * N * D + ada)
    flops += F_ * (2 * D * 2 * D + 2 * N * D * p * p * cfg.out_channels)  # final layer
    return float(rows * flops)


def kernel_stats(fn) -> tuple:
    """(device kernels one call of fn() launches, their summed device time
    in ms) under torch.profiler: on one stream the kernels do not overlap,
    so the sum is the time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def parity(tag: str, model, args_fn, video: bool) -> None:
    """11a: one f32 forward on the card against the same weights on the
    CPU, and bf16 on the card against f32 on the card."""
    with torch.no_grad():
        inputs = args_fn("cuda")
        f32 = model(*inputs)
        bf = served_as(model, BF)
        bf16 = bf(*inputs).float()
        del bf
        model.cpu()
        t0 = time.perf_counter()
        cpu = model(*args_fn("cpu"))
        cpu_s = time.perf_counter() - t0
        model.cuda()
    err, err_bf = rel_norm(f32.cpu(), cpu), rel_norm(bf16, f32)
    print(f"[11a] {tag}: f32 card vs CPU rel err {err:.3e} (bar {DIFF_F32_REL_TOL}; CPU forward "
          f"{cpu_s:.1f} s), bf16 vs f32 on the card {err_bf:.3e} (bar {DIFF_BF16_REL_TOL}); "
          f"output {tuple(f32.shape)}, rms {float(f32.pow(2).mean().sqrt()):.4f}")
    if not (err <= DIFF_F32_REL_TOL and err_bf <= DIFF_BF16_REL_TOL
            and bool(torch.isfinite(f32).all())):
        raise AssertionError(f"{tag}: parity {err:.3e} / {err_bf:.3e} off its bars")


def ddim_parity(model, diffusion_args) -> None:
    """11a: DDIM (eta 0) over 10 steps from one initial noise, card against
    CPU, f32, B=1 without guidance."""
    from omnitokenizer_tpu_torch.cli import dit_sample

    args = dit_sample.build_parser().parse_args(SAMPLE_FLAGS + diffusion_args)
    diffusion = dit_sample.make_diffusion(args, False)
    cfg = model.cfg
    shape = (1, cfg.in_channels, cfg.input_size, cfg.input_size)
    noise = torch.randn(shape, generator=torch.Generator().manual_seed(30))
    y = torch.tensor([207])
    out = {}
    with torch.inference_mode():
        for device in ("cuda", "cpu"):
            model.to(device)
            t0 = time.perf_counter()
            out[device] = diffusion.ddim_sample_loop(
                lambda x, t: model(x, t, y.to(device)), shape, noise=noise,
                clip_denoised=False, device=device).cpu()
            out[device + "_s"] = time.perf_counter() - t0
    model.cuda()
    err = rel_norm(out["cuda"], out["cpu"])
    print(f"[11a] DiT DDIM eta 0, 10 steps, B=1: card vs CPU rel err {err:.3e} "
          f"(bar {DIFF_DDIM_REL_TOL}; card {out['cuda_s']:.2f} s, CPU {out['cpu_s']:.1f} s)")
    if not err <= DIFF_DDIM_REL_TOL:
        raise AssertionError(f"DDIM card vs CPU rel err {err:.3e} > {DIFF_DDIM_REL_TOL}")


def decode_vs_plain(tag: str, ad, z: torch.Tensor, video: bool, got: torch.Tensor) -> float:
    """The adapter's decode (mha's kernel) against the VAE's plain route
    (training=True) on the same latents, whole-tensor."""
    net = ad.vae.net
    with torch.inference_mode():
        zl = z / ad.scale
        if video:  # (B, F, C, h, w) -> (B, F, h, w, C)
            plain = net.decode_latent(zl.permute(0, 1, 3, 4, 2), False, training=True)
            got = got.permute(0, 2, 3, 4, 1)
        else:  # (B, C, h, w) -> (B, 1, h, w, C)
            plain = net.decode_latent(zl.permute(0, 2, 3, 1)[:, None], True, training=True)[:, 0]
            got = got.permute(0, 2, 3, 1)
    err = rel_norm(got, plain)
    print(f"[{tag}] decode: kernel vs plain route rel err {err:.3e} (bar {VAE_REL_TOL})")
    if not err <= VAE_REL_TOL:
        raise AssertionError(f"{tag} decode rel err {err:.3e} > {VAE_REL_TOL}")
    return err


def sample_run(tag: str, model, ad, argv: list, video: bool, n: int, unit: str) -> dict:
    """One sampling batch through the CLI's own functions (dit_sample.
    sample_batch, then the seam's decode): ms a step of the CFG forward with
    the step's math (CUDA events) beside its FLOP bound, the loop's ms a
    step and items/s end to end (host clock, decode included), peak memory,
    device kernels a step, mha's launches in the decode."""
    from omnitokenizer_tpu_torch.cli import diffusion_common, dit_sample
    from omnitokenizer_tpu_torch.models import dit, latte
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    parser = dit_sample.build_parser(video)
    args = parser.parse_args(SAMPLE_FLAGS + argv)
    cfg = model.cfg
    diffusion = dit_sample.make_diffusion(args, video)
    decode = diffusion_common.decode_batch_fn(ad, video)
    classes = torch.arange(n, device="cuda") * (cfg.num_classes // n)
    gen = torch.Generator("cuda").manual_seed(40)

    # one step of the loop at its shapes: the CFG forward over 2n rows and the step's math
    latent = ((cfg.num_frames,) if video else ()) + (cfg.in_channels,) + (cfg.input_size,) * 2
    x = torch.randn((2 * n,) + latent, generator=gen, device="cuda")
    y = torch.cat([classes, torch.full_like(classes, cfg.num_classes)])
    t = torch.full((2 * n,), diffusion.num_timesteps - 1, device="cuda")
    fwd = latte.forward_with_cfg if video else dit.forward_with_cfg
    ch = 4 if video else 3

    def one_step():
        return diffusion.p_sample(lambda xx, tt: fwd(model, xx, tt, y, args.cfg_scale, ch), x, t,
                                  gen, clip_denoised=False)

    with torch.inference_mode():
        step_ms = cuda_ms(one_step, iters=5, warmup=2, queued=False)
        kernels, busy_ms = kernel_stats(one_step)
    flops = diffusion_flops(cfg, 2 * n, video)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters()) + 3 * x.numel() * 4
    b = bound(flops, nbytes, PEAK_BF16 if cfg.dtype == BF else PEAK_F32)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    z = dit_sample.sample_batch(args, model, diffusion, classes, gen, video)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    if any(launch_counts().values()):  # the transformer runs no hand-written kernel
        raise AssertionError(f"kernels launched while sampling: {launch_counts()}")
    reset_launch_counts()
    with torch.inference_mode():
        pixels = decode(z)
        torch.cuda.synchronize()
    counts = launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = diffusion.num_timesteps
    print(f"[{tag}] launches in the decode of {n} {unit}: {counts}")
    if counts != DIFF_LAUNCHES["decode"]:
        raise AssertionError(f"launch counts {counts} != {DIFF_LAUNCHES['decode']}")
    shape = (n, 3) + ((T,) if video else ()) + (RES, RES)
    if (tuple(z.shape) != (n,) + latent or tuple(pixels.shape) != shape
            or not bool(torch.isfinite(z).all() and torch.isfinite(pixels).all())
            or float(pixels.abs().max()) > 0.5):
        raise AssertionError(f"bad samples {tuple(z.shape)} {tuple(pixels.shape)}")
    with torch.inference_mode():
        raw = ad.decode(z.permute(0, 2, 1, 3, 4) if video else z, is_image=not video)
    err = decode_vs_plain(tag, ad, z, video, raw)
    row = {"path": tag, "dtype": "bf16" if cfg.dtype == BF else "f32", "batch": n,
           "rows_a_step": 2 * n, "steps": steps, "ms_per_step": step_ms,
           "loop_ms_per_step": loop_s * 1e3 / steps, "gflop_per_step": flops / 1e9, **b,
           f"{unit}_per_s": n / wall, "wall_s": wall, "peak_gib": peak,
           "kernels_per_step": kernels, "device_busy_ms_per_step": busy_ms,
           "mha_decode_launches": counts["mha"],
           "decode_rel_err": err}
    print(f"[{tag}] {row['dtype']} B={n} ({2 * n} rows), {steps} steps: {step_ms:.4f} ms a step "
          f"(bound {b['bound_ms']:.4f} ms by {b['bound_by']}, {flops / 1e9:.1f} GFLOP; "
          f"{b['bound_ms'] / step_ms:.1%} of it), loop {row['loop_ms_per_step']:.4f} ms a step, "
          f"{row[unit + '_per_s']:.4f} {unit}/s end to end ({wall:.2f} s, decode included), "
          f"peak {peak:.2f} GiB, {kernels} device kernels a step, busy {busy_ms:.4f} ms of "
          f"a profiled step")
    return row


class TimedBatches:
    """`steps` pixel batches made on the card from a seed (channels-last, in
    [-0.5, 0.5], with labels), the host time of each request kept: the gap
    between two requests is one training step (its encode included)."""

    def __init__(self, shape: tuple, classes: int, steps: int, seed: int):
        self.shape, self.classes, self.steps, self.seed = shape, classes, steps, seed
        self.times: list = []

    def __iter__(self):
        g = torch.Generator("cuda").manual_seed(self.seed)
        for _ in range(self.steps):
            torch.cuda.synchronize()
            self.times.append(time.perf_counter())
            yield {"video": torch.rand(self.shape, generator=g, device="cuda") - 0.5,
                   "label": torch.randint(0, self.classes, (self.shape[0],), generator=g,
                                          device="cuda")}


def train_run(tag: str, ad, video: bool, batch: int, unit: str) -> dict:
    """11d: the train CLI's loop (dit_train.train) on pixels encoded by the
    VAE each step: one warm-up step that writes a checkpoint, then a run
    that resumes from it for 6 steps, 5 timed."""
    from omnitokenizer_tpu_torch.cli import diffusion_common, dit_train
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    shape = (batch,) + ((T,) if video else ()) + (RES, RES, 3)
    with tempfile.TemporaryDirectory() as root:
        argv = ["--results_dir", root, "--global_batch_size", str(batch), "--log_every", "1",
                "--device", "cuda"]
        args = dit_train.build_parser(video).parse_args(argv + ["--max_steps", "1",
                                                                 "--ckpt_every", "1"])
        model, cfg = diffusion_common.build_model(args, video, init=False)
        fill_random(model, 0)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = dit_train.train(args, model, ad, TimedBatches(shape, cfg.num_classes, 1, 50), video)
        # the EMA started as a copy of the parameters: one step gives 0.9999 p0 + 0.0001 p1
        name = "blocks.0.attn.qkv.weight"
        want = 0.9999 * p0[name] + 0.0001 * dict(state.model.named_parameters())[name].detach()
        ema_err = max_abs(dict(state.ema.named_parameters())[name], want)
        ckpt = os.path.join(root, "state_000000001.pt")
        ckpt_gb = os.path.getsize(ckpt) / 1e9
        del state, model
        torch.cuda.empty_cache()

        args = dit_train.build_parser(video).parse_args(argv + ["--max_steps", "7",
                                                                 "--ckpt_every", "1000"])
        model, _ = diffusion_common.build_model(args, video, init=False)  # the resume loads it
        batches = TimedBatches(shape, cfg.num_classes, 6, 51)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        state = dit_train.train(args, model, ad, batches, video)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(root, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
    step_ms = [(b - a) * 1e3 for a, b in zip(batches.times, batches.times[1:])]
    ms = sum(step_ms) / len(step_ms)
    moved = [n for n, p in state.model.named_parameters() if not torch.equal(p.detach(), p0[n])]
    per_step = {k: v / 6 for k, v in counts.items()}
    print(f"[{tag}] launches a step (6 resumed steps): {per_step}")
    if per_step != DIFF_LAUNCHES["encode"]:
        raise AssertionError(f"launches a step {per_step} != {DIFF_LAUNCHES['encode']}")
    if (state.step != 7 or len(moved) != len(p0) or not ema_err <= 1e-6
            or not all(map(math.isfinite, losses))):
        raise AssertionError(f"{tag}: step {state.step}, {len(moved)}/{len(p0)} parameters "
                             f"moved, EMA err {ema_err:.3e}, losses {losses}")
    flops = 3 * diffusion_flops(cfg, batch, video)  # forward + backward, the model alone
    row = {"path": tag, "dtype": "f32", "batch": batch, "step_ms": ms, "step_ms_each": step_ms,
           f"{unit}_per_s": batch / (ms / 1e3), "peak_gib": peak, "checkpoint_gb": ckpt_gb,
           "resumed_run_s": run_s, "mha_launches_per_step": per_step["mha"],
           "model_gflop_per_step": flops / 1e9, **bound(flops, 0, PEAK_F32), "ema_err": ema_err,
           "losses": losses}
    print(f"[{tag}] f32 B={batch}: {ms:.2f} ms a step ({[round(s, 1) for s in step_ms]}), "
          f"{row[unit + '_per_s']:.3f} {unit}/s, peak {peak:.2f} GiB; the model's fwd+bwd "
          f"{flops / 1e12:.2f} TFLOP, bound {row['bound_ms']:.1f} ms at the f32 peak; resumed "
          f"at step 1 from a {ckpt_gb:.2f} GB checkpoint, all {len(p0)} parameters moved, "
          f"EMA after step 1 within {ema_err:.1e} of 0.9999 ema + 0.0001 params")
    return row


def phase11_diffusion() -> dict:
    """Diffusion synthesis at DIFF_DEPTH blocks: 11a parity on the card, 11b
    DiT class-conditional sampling, 11c Latte, 11d the two training steps;
    returns their launches."""
    with diffusion_depth(DIFF_DEPTH):
        return _phase11_diffusion()


def _phase11_diffusion() -> dict:
    from omnitokenizer_tpu_torch import DiffusionVAEAdapter, imagenet_k600_config
    from omnitokenizer_tpu_torch.cli import diffusion_common, dit_sample

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    ad = DiffusionVAEAdapter.from_config(imagenet_k600_config(use_vae=True), seed=0)
    rows, paths = [], {}

    dit_args = dit_sample.build_parser().parse_args(SAMPLE_FLAGS + ["--device", "cuda"])
    dit, cfg = diffusion_common.build_model(dit_args, False, init=False)
    fill_random(dit, 0)
    print(f"[11] DiT-XL/2: {sum(p.numel() for p in dit.parameters())} parameters, "
          f"{cfg.depth} x {cfg.hidden_size}, latents {cfg.in_channels} x {cfg.input_size}^2")
    g = torch.Generator().manual_seed(31)
    x = torch.randn(2, cfg.in_channels, cfg.input_size, cfg.input_size, generator=g)
    t, y = torch.tensor([17, 640]), torch.tensor([3, 981])
    parity("DiT-XL/2 B=2", dit, lambda d: (x.to(d), t.to(d), y.to(d)), False)
    ddim_parity(dit, ["--ddim", "--num_sampling_steps", "10"])
    rows.append(sample_run("11b", dit, ad, [], False, DIT_B, "images"))
    bf = served_as(dit, BF)
    del dit
    rows.append(sample_run("11b", bf, ad, ["--bf16"], False, DIT_B, "images"))
    del bf
    torch.cuda.empty_cache()

    latte_args = dit_sample.build_parser(True).parse_args(SAMPLE_FLAGS + ["--device", "cuda"])
    latte, lcfg = diffusion_common.build_model(latte_args, True, init=False)
    fill_random(latte, 0)
    print(f"[11] Latte-XL/2-omnitokenizer: {sum(p.numel() for p in latte.parameters())} "
          f"parameters, {lcfg.num_frames} latent frames, {lcfg.num_classes} classes")
    xv = torch.randn(1, lcfg.num_frames, lcfg.in_channels, lcfg.input_size, lcfg.input_size,
                     generator=g)
    tv, yv = torch.tensor([333]), torch.tensor([42])
    parity("Latte-XL/2-omnitokenizer B=1", latte, lambda d: (xv.to(d), tv.to(d), yv.to(d)), True)
    rows.append(sample_run("11c", latte, ad, ["--num_sampling_steps", str(LATTE_F32_STEPS)],
                           True, LATTE_B, "clips"))
    bf = served_as(latte, BF)
    del latte
    rows.append(sample_run("11c", bf, ad, ["--bf16"], True, LATTE_B, "clips"))
    del bf
    torch.cuda.empty_cache()
    paths["dit_sample"] = paths["latte_sample"] = DIFF_LAUNCHES["decode"]

    rows.append(train_run("11d DiT", ad, False, DIT_TRAIN_B, "images"))
    torch.cuda.empty_cache()
    rows.append(train_run("11d Latte", ad, True, LATTE_TRAIN_B, "clips"))
    paths["dit_train"] = paths["latte_train"] = DIFF_LAUNCHES["encode"]
    print(json.dumps({"diffusion": rows}))
    print(f"[11] phase 11 in {time.perf_counter() - t0:.1f} s")
    return paths


# -- phase 12: LM training ------------------------------------------------------------------
# the flagship LM at scripts/lm_train/train_imagenet_class.sh's flags: 24 x 1536, 16 heads of
# 96, vocab 8192 codes + 1000 classes + sos, block 1025, B=8, --bf16 (bf16 compute on f32
# masters), --starts_with_sos --class_first, lr 1e-3 held (lr_min 1e-3), weight decay 0.01,
# clip 1; images 256^2 encoded by the bf16 flagship tokenizer each step. Random weights from
# seed 0 (pixels from seed 60).
LM_TRAIN_B = 8
LM_TRAIN_WARMUP, LM_TRAIN_TIMED = 2, 5
LM_TRAIN_LOSS_REL_TOL = 5e-3       # kernel vs plain route, same batch and weights
LM_TRAIN_GRAD_NORM_REL_TOL = 5e-2  # global and per-layer gradient norms, likewise
LM_RESUME_LAYERS = 2               # the resume check: full width, 2 layers


def lm_train_flops(cfg, batch: int, T: int) -> float:
    """A step's FLOPs: 6 x the matmul parameters (12 C^2 a layer and the
    head) x the tokens, plus the causal attention (flash_cost: forward and
    backward) in every layer. The tokenizer's encode is not counted."""
    C, L, H = cfg.n_embd, cfg.n_layer, cfg.n_head
    (f_flops, _), (b_flops, _) = flash_cost(batch, H, T, C // H)
    return 6 * (L * 12 * C * C + cfg.vocab_size * C) * batch * T + L * (f_flops + b_flops)


def lm_n2n(gpt, tok):
    from omnitokenizer_tpu_torch.config import Net2NetConfig
    from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer

    return Net2NetTransformer(Net2NetConfig(gpt=gpt.cfg, class_cond_dim=1000, starts_with_sos=True,
                                            class_first=True, first_stage_vocab_size=8192),
                              tok, gpt=gpt)


def lm_optimizer(gpt):
    from omnitokenizer_tpu_torch.training import lm_loop

    return lm_loop.make_lm_optimizer(gpt, lr=1e-3, max_steps=4_000_000, warmup_steps=1,
                                     lr_min=1e-3, grad_clip_val=1.0, weight_decay=0.01)


def lm_route(gpt, flash: bool) -> None:
    """The kernel route (the flash gate open: cfg.flash_attention) or the
    plain route (the materialized (B, H, T, T) scores) of the same GPT."""
    cfg = gpt.cfg.replace(flash_attention=flash)
    gpt.cfg = cfg
    for block in gpt.blocks:
        block.cfg = cfg


def lm_grad_norms(gpt, grads) -> dict:
    """The global gradient norm and each layer's (the blocks, the rest)."""
    groups: dict = {}
    for (name, _), g in zip(gpt.named_parameters(), grads):
        key = ".".join(name.split(".")[:2]) if name.startswith("blocks.") else "rest"
        groups[key] = groups.get(key, 0.0) + float(g.float().square().sum())
    norms = {k: math.sqrt(v) for k, v in groups.items()}
    norms["global"] = math.sqrt(sum(groups.values()))
    return norms


def lm_timed_steps(n2n, opt, state, batches) -> tuple:
    """encode + lm_train_step over the batches, CUDA events around each step
    and its encode; returns (step ms, encode ms, losses) of the steps after
    the warm-up."""
    from omnitokenizer_tpu_torch.training import lm_loop

    marks, losses = [], []
    for batch in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        z, labels = lm_loop.encode_batch(n2n, batch)
        ev[1].record()
        metrics = lm_loop.lm_train_step(n2n, opt, state, z, labels)
        ev[2].record()
        marks.append(ev)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    timed = marks[LM_TRAIN_WARMUP:]
    return ([a.elapsed_time(c) for a, _, c in timed], [a.elapsed_time(b) for a, b, _ in timed],
            [float(x) for x in losses])


def lm_profile(n2n, opt, state, batch, tag: str = "12") -> dict:
    """One kernel-route step (encode included) under torch.profiler: the
    device's busy ms and the ms of each group of kernels (the flash kernels,
    the GEMMs, the optimizer's foreach passes, the tokenizer's kernels, the
    rest), and the ten longest kernels."""
    from torch.profiler import ProfilerActivity, profile
    from omnitokenizer_tpu_torch.training import lm_loop

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lm_loop.lm_train_step(n2n, opt, state, *lm_loop.encode_batch(n2n, batch))
        torch.cuda.synchronize()

    def self_dev(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA), key=self_dev,
                     reverse=True)
    def group(key: str) -> str:
        if "flash_fwd_kernel" in key or "flash_bwd_" in key:
            return "flash"
        if ("otk::" in key or "anonymous namespace)::" in key) and "at::" not in key:
            return "tokenizer"  # the repo's other kernels, all in the encode
        if any(k in key for k in ("gemm", "nvjet", "xmma", "cutlass")):
            return "gemm"
        if "multi_tensor" in key or "foreach" in key:
            return "optimizer"
        return "other"

    ms = dict.fromkeys(("flash", "tokenizer", "gemm", "optimizer", "other"), 0.0)
    for e in kernels:
        ms[group(e.key)] += self_dev(e)
    ms["busy"] = sum(self_dev(e) for e in kernels)
    print(f"[{tag}] profiled kernel-route step, device ms by group: "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    for e in kernels[:10]:
        print(f"[{tag}]   {self_dev(e):8.2f} ms {e.count:5d}x {e.key[:110]}")
    return ms


def phase12_lm_train() -> dict:
    """The flagship LM's training step on the card: (a) one step's loss and
    gradient norms, kernel route against plain route on the same batch and
    weights, and the flash kernels against their plain versions on the
    first layer's own q, k, v and output gradient from that step; (b) 2 warm-up and 5 timed steps of each route (ms a step,
    tokens/s, peak memory, the share of the FLOP bound, launches a step),
    every parameter moved; (c) train_lm at full width and 2 layers: 2 steps
    and a resume to 3 against an unbroken 3-step run."""
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, imagenet_k600_config
    from omnitokenizer_tpu_torch.ops.kernels import flash_attn as fa
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.training import lm_loop

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    tok = OmniTokenizerVQGAN.from_config(imagenet_k600_config().replace(dtype=BF), seed=0,
                                         device="cuda").serving()
    gpt = lm_model(9193, LM_BLOCK)
    n2n = lm_n2n(gpt, tok)
    shape = (LM_TRAIN_B, RES, RES, 3)
    steps = LM_TRAIN_WARMUP + LM_TRAIN_TIMED
    tokens = LM_TRAIN_B * LM_BLOCK
    flops = lm_train_flops(gpt.cfg, LM_TRAIN_B, LM_BLOCK)
    print(f"[12] LM {sum(p.numel() for p in gpt.parameters())} parameters, B={LM_TRAIN_B}, "
          f"{tokens} tokens a step, {flops / 1e12:.2f} TFLOP a step "
          f"(bound {flops / PEAK_BF16 * 1e3:.2f} ms at {PEAK_BF16 / 1e12:.0f} TFLOP/s)")

    # (a) one step from the same state: the kernel route against the plain route
    z, labels = lm_loop.encode_batch(n2n, next(iter(TimedBatches(shape, 1000, 1, 60))))
    if tuple(z.shape) != (LM_TRAIN_B, LM_BLOCK - 1) or int(z.max()) >= 8192:
        raise AssertionError(f"encode: ids {tuple(z.shape)} max {int(z.max())}")
    one, layer0 = {}, {}
    real_flash = fa.flash_attention

    def keep_layer0(q, k, v, scale):  # the first layer's q, k, v and output gradient
        out = real_flash(q, k, v, scale)
        if not layer0:
            layer0.update(q=q.detach(), k=k.detach(), v=v.detach(), scale=scale)
            out.register_hook(lambda g: layer0.setdefault("do", g.detach()))
        return out

    for name, flash in (("kernel", True), ("plain", False)):
        lm_route(gpt, flash)
        reset_launch_counts()
        fa.flash_attention = keep_layer0
        try:
            loss, metrics = n2n.loss_fn(z, labels)
            grads = torch.autograd.grad(loss, list(gpt.parameters()))
        finally:
            fa.flash_attention = real_flash
        one[name] = (float(loss.detach()), lm_grad_norms(gpt, grads), launch_counts(),
                     float(metrics["acc5"]))
        del loss, grads
    # the flash kernels against their plain versions on the main path's own tensors:
    # the first layer's (B, T, H, D) projections and the gradient of its output
    q, k, v, do, sc = (layer0[n] for n in ("q", "k", "v", "do", "scale"))
    o, lse = fa.flash_attn_fwd(q, k, v, sc)
    o_ref, lse_ref = fa.flash_attn_fwd_plain(q, k, v, sc)
    fwd_err = compare("[12] flash_attn_fwd on layer 0", o, o_ref, FLASH_FWD_TOL)
    bwd_err = [compare(f"[12] flash_attn_bwd {n} on layer 0", a, b, FLASH_BWD_TOL)
               for n, a, b in zip(("dq", "dk", "dv"), fa.flash_attn_bwd(q, k, v, o, do, lse, sc),
                                  fa.flash_attn_bwd_plain(q, k, v, o_ref, do, lse_ref, sc))]
    print(f"[12] flash kernels on layer 0's own q, k, v {tuple(q.shape)} (strides {q.stride()}) "
          f"and output gradient: forward max_rel {fwd_err[1]:.3e} (bar {FLASH_FWD_TOL}), "
          f"dq, dk, dv {[f'{e[1]:.3e}' for e in bwd_err]} (bar {FLASH_BWD_TOL})")
    del q, k, v, do, o, lse, o_ref, lse_ref, layer0
    counts = {n: one[n][2] for n in one}
    if (counts["kernel"]["flash_attn_fwd"], counts["kernel"]["flash_attn_bwd"]) != (24, 24) \
            or any(counts["plain"].values()):
        raise AssertionError(f"one step's launches: {counts}")
    loss_err = abs(one["kernel"][0] - one["plain"][0]) / abs(one["plain"][0])
    norm_err = {k: abs(v - one["plain"][1][k]) / one["plain"][1][k]
                for k, v in one["kernel"][1].items()}
    worst = max(norm_err, key=norm_err.get)
    print(f"[12] one step, kernel vs plain route: loss {one['kernel'][0]:.6f} vs "
          f"{one['plain'][0]:.6f} (rel {loss_err:.3e}, bar {LM_TRAIN_LOSS_REL_TOL}); gradient "
          f"norms rel: global {norm_err['global']:.3e}, worst {worst} {norm_err[worst]:.3e} "
          f"(bar {LM_TRAIN_GRAD_NORM_REL_TOL}); acc5 {one['kernel'][3]:.3f} / {one['plain'][3]:.3f}")
    if not (loss_err <= LM_TRAIN_LOSS_REL_TOL
            and max(norm_err.values()) <= LM_TRAIN_GRAD_NORM_REL_TOL):
        raise AssertionError(f"kernel vs plain route: loss {loss_err:.3e}, norms {norm_err}")

    # (b) timed steps of each route
    runs = {}
    p0 = {n: p.detach().clone() for n, p in gpt.named_parameters()}
    opt = lm_optimizer(gpt)
    state = lm_loop.init_lm_state(n2n, opt)
    for name, flash in (("kernel", True), ("plain", False)):
        lm_route(gpt, flash)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        step_ms, enc_ms, losses = lm_timed_steps(n2n, opt, state,
                                                 TimedBatches(shape, 1000, steps, 61))
        got = {k: v // steps if v % steps == 0 else v / steps
               for k, v in launch_counts().items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = sum(step_ms) / len(step_ms)
        runs[name] = {"route": name, "step_ms": ms, "step_ms_each": step_ms,
                      "encode_ms": sum(enc_ms) / len(enc_ms), "tokens_per_s": tokens / ms * 1e3,
                      "images_per_s": LM_TRAIN_B / ms * 1e3, "peak_gib": peak,
                      "flop_bound_share": flops / PEAK_BF16 * 1e3 / ms,
                      "launches_per_step": got, "losses": losses}
        print(f"[12] {name} route: {ms:.2f} ms a step ({[round(s, 2) for s in step_ms]}; "
              f"encode {runs[name]['encode_ms']:.2f}), {runs[name]['tokens_per_s']:.0f} tokens/s, "
              f"{runs[name]['images_per_s']:.2f} images/s, peak {peak:.2f} GiB, "
              f"{100 * runs[name]['flop_bound_share']:.1f}% of the FLOP bound; launches a step "
              f"{got}")
        want = EXPECTED_LAUNCHES["lm_train"] if flash else {
            **EXPECTED_LAUNCHES["lm_train"], **NO_FLASH}
        if got != want or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name} route: launches {got} != {want}, losses {losses}")
        if flash:
            moved = [n for n, p in gpt.named_parameters() if not torch.equal(p.detach(), p0[n])]
            if len(moved) != len(p0):
                raise AssertionError(f"{len(moved)}/{len(p0)} parameters moved")
        if flash:
            runs[name]["profile_ms"] = lm_profile(n2n, opt, state,
                                                  next(iter(TimedBatches(shape, 1000, 1, 63))))
    print(f"[12] every one of {len(p0)} parameters moved in the kernel route's steps; plain "
          f"route {runs['plain']['step_ms'] / runs['kernel']['step_ms']:.3f}x its ms a step "
          f"in {runs['plain']['peak_gib'] / runs['kernel']['peak_gib']:.3f}x its peak memory")
    del p0, opt, state, n2n, gpt
    torch.cuda.empty_cache()

    # (c) train_lm, the loop: 2 steps and a resume to 3 against 3 unbroken steps
    batches = TimedBatches(shape, 1000, 3, 62)
    with tempfile.TemporaryDirectory() as root:
        finals = []
        for run, stops in (("broken", (2, 3)), ("unbroken", (3,))):
            gpt = lm_model(9193, LM_BLOCK, seed=3, layers=LM_RESUME_LAYERS)
            n2n = lm_n2n(gpt, tok)
            for stop in stops:
                state = lm_loop.train_lm(n2n, lm_optimizer(gpt), batches,
                                         os.path.join(root, run), max_steps=stop, log_every=1)
            finals.append(({n: p.detach().clone() for n, p in gpt.named_parameters()},
                           [t.clone() for t in state.opt.mu + state.opt.nu], state.step))
            ckpt_gb = os.path.getsize(os.path.join(root, run, "checkpoints",
                                                   "step_00000003.pt")) / 1e9
            del gpt, n2n, state
        (pa, ma, sa), (pb, mb, sb) = finals
        diff = max(max_abs(pa[n], pb[n]) for n in pb)
        opt_diff = max(max_abs(a, b) for a, b in zip(ma, mb))
        exact = all(torch.equal(pa[n], pb[n]) for n in pb)
    print(f"[12] train_lm at {LM_RESUME_LAYERS} layers: resumed at step 2 from a "
          f"{ckpt_gb:.2f} GB checkpoint to step {sa}, against {sb} unbroken steps: parameters "
          f"{'bit-equal' if exact else f'max abs diff {diff:.3e}'}, optimizer moments max abs "
          f"diff {opt_diff:.3e}")
    if not (sa == sb == 3 and diff <= 1e-6 and opt_diff <= 1e-9):
        raise AssertionError(f"resume vs unbroken: steps {sa}/{sb}, diff {diff}, {opt_diff}")
    row = {"kernel": runs["kernel"], "plain": runs["plain"], "flops_per_step": flops,
           "bound_ms": flops / PEAK_BF16 * 1e3, "tokens_per_step": tokens,
           "one_step": {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err},
           "resume_max_abs_diff": diff, "resume_bit_equal": exact, "checkpoint_gb": ckpt_gb}
    print(json.dumps({"lm_train": row}))
    print(f"[12] phase 12 in {time.perf_counter() - t0:.1f} s")
    return {"lm_train": runs["kernel"]["launches_per_step"]}


# -- phase 13: checkpoints in, scores out ------------------------------------------------------
# The JAX package's msgpack files, written by the port's own writer (utils/msgpack_io.py, the
# inverse key maps of convert.py) from models with random weights, read back through the CLIs'
# loaders on the card, then the generation metrics on the card against the CPU.
CKPT_METRIC_TOL = 1e-4     # metrics_eval psnr / ssim, card vs CPU, absolute
PR_N, PR_D = 50000, 2048   # the OpenAI evaluator's 50k samples of pool3 features
PR_SUBSET = 5000           # radii card vs CPU on this many rows
PR_RADII_REL_TOL = 1e-5    # f32 distances in another summation order, TF32 off on both


def _file_gb(path: str) -> float:
    return os.path.getsize(path) / 1e9


def phase13a_tokenizer(root: str, video: torch.Tensor) -> tuple:
    """The flagship tokenizer written as a JAX .msgpack + .cfg.json sidecar,
    loaded on the card; its bf16 round trip bit-equal to the source's, with
    the kernels' launches; convert_ckpt's .pt loaded beside it."""
    import numpy as np

    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, imagenet_k600_config
    from omnitokenizer_tpu_torch.cli import convert_ckpt
    from omnitokenizer_tpu_torch.convert import state_dict_to_jax
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.utils.checkpoint import config_to_json
    from omnitokenizer_tpu_torch.utils.msgpack_io import read_msgpack, write_msgpack

    cfg = imagenet_k600_config().replace(dtype=BF)
    src = OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cuda")
    path = os.path.join(root, "imagenet_k600.msgpack")
    t0 = time.perf_counter()
    write_msgpack(path, state_dict_to_jax(src.net))  # the f32 masters, before serving()
    with open(path + ".cfg.json", "w") as f:
        json.dump(config_to_json(cfg), f)
    write_s = time.perf_counter() - t0
    pt = os.path.join(root, "imagenet_k600.pt")
    convert_ckpt.main(["--src", path, "--dst", pt])
    secs = {"load_s": [], "pt_load_s": [], "read_s": [], "torch_load_s": []}
    for _ in range(2):  # in turns, twice: the first of each pays the first-call costs
        for name, fn in (("load_s", lambda: OmniTokenizerVQGAN.load_from_checkpoint(path)),
                         ("pt_load_s", lambda: OmniTokenizerVQGAN.load_from_checkpoint(pt)),
                         ("read_s", lambda: read_msgpack(path)),
                         ("torch_load_s", lambda: torch.load(pt, map_location="cpu"))):
            t0 = time.perf_counter()
            out = fn()  # load_from_checkpoint: on the card, the default
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            if name == "load_s":
                model = out
            elif name == "pt_load_s":
                from_pt = out
            del out
    load_s, load_pt_s, read_s, torch_load_s = (min(secs[k]) for k in
                                               ("load_s", "pt_load_s", "read_s", "torch_load_s"))
    for k, v in src.net.state_dict().items():
        if not (torch.equal(model.net.state_dict()[k], v)
                and torch.equal(from_pt.net.state_dict()[k], v)):
            raise AssertionError(f"{k}: the loaded tensor differs from the written one")
    del from_pt
    src.serving()
    model.serving()
    with torch.inference_mode():
        want, want_aux = src.reconstruct(video, is_image=False)
        torch.cuda.synchronize()
        reset_launch_counts()
        got, aux = model.reconstruct(video, is_image=False)
        torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[13a] launches in the loaded tokenizer's round trip: {counts}")
    if counts != EXPECTED_LAUNCHES["vq"]:
        raise AssertionError(f"launch counts {counts} != {EXPECTED_LAUNCHES['vq']}")
    if not (torch.equal(got, want) and torch.equal(aux["encodings"], want_aux["encodings"])):
        raise AssertionError(f"round trip from the msgpack differs: max abs {max_abs(got, want)}")
    print(f"[13a] imagenet_k600 {model.num_params()} parameters: wrote {_file_gb(path):.3f} GB "
          f"msgpack in {write_s:.2f} s; load_from_checkpoint on the card {load_s:.2f} s (the "
          f"file read alone {read_s:.2f} s) against the convert_ckpt .pt's {load_pt_s:.2f} s "
          f"(torch.load alone {torch_load_s:.2f} s), the faster of two turns each, warm page "
          f"cache ({ {k: [round(x, 3) for x in v] for k, v in secs.items()} }); bf16 round trip of "
          f"B={video.shape[0]} {T}x{RES}^2 clips bit-equal to the source model's, indices too")
    row = {"params": model.num_params(), "msgpack_gb": _file_gb(path), "write_s": write_s,
           "load_s": load_s, "read_s": read_s, "pt_load_s": load_pt_s,
           "torch_load_s": torch_load_s, "turns": secs, "launches": counts}
    recon = got.float().cpu().numpy()
    del src, model, got, want
    torch.cuda.empty_cache()
    return counts, row, recon


def phase13b_lm(root: str, tok_path: str) -> dict:
    """The class-conditional LM at 24 x 1536 written as the JAX CLI's
    (params, opt_state, step), loaded through transformer_eval's loader;
    one batch's logits bit-equal to the source model's."""
    from omnitokenizer_tpu_torch.cli import args as A
    from omnitokenizer_tpu_torch.cli import transformer_eval
    from omnitokenizer_tpu_torch.convert import gpt_state_dict_from_jax, gpt_state_dict_to_jax
    from omnitokenizer_tpu_torch.utils.msgpack_io import read_msgpack, write_msgpack

    gpt = lm_model(9193, LM_BLOCK)
    path = os.path.join(root, "imagenet_class_lm.msgpack")
    t0 = time.perf_counter()
    # opt_state written as None, as the JAX convert_ckpt writes it: an Adam state would triple
    # the file, and no loader reads it
    write_msgpack(path, (gpt_state_dict_to_jax(gpt.state_dict()), None, 0))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()  # where the loader's time goes: the file read, the key map
    tree = read_msgpack(path)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gpt_state_dict_from_jax(tree["0"])
    map_s = time.perf_counter() - t0
    del tree
    args = A.normalize_precision(transformer_eval.build_parser().parse_args(
        ["--gpt_ckpt", path, "--vqvae", tok_path, "--starts_with_sos", "--class_first", "--bf16"]))
    t0 = time.perf_counter()
    n2n, _ = transformer_eval.build_model(args)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    idx = torch.randint(0, 9193, (LM_B, LM_BLOCK - 1), generator=torch.Generator().manual_seed(70)
                        ).cuda()
    with torch.inference_mode():
        want, got = gpt(idx)[0], n2n.gpt(idx)[0]
        torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"LM logits from the msgpack differ: max abs {max_abs(got, want)}")
    n = sum(p.numel() for p in gpt.parameters())
    print(f"[13b] LM {n} parameters: wrote {_file_gb(path):.3f} GB msgpack (opt_state None) in "
          f"{write_s:.2f} s; transformer_eval's loader (the tokenizer's .msgpack too) on the "
          f"card {load_s:.2f} s (alone: the file read {read_s:.2f} s, the key map {map_s:.2f} "
          f"s); logits of B={LM_B} x {LM_BLOCK - 1} tokens bit-equal to the source model's")
    row = {"params": n, "msgpack_gb": _file_gb(path), "write_s": write_s, "load_s": load_s,
           "read_s": read_s, "map_s": map_s}
    del gpt, n2n, want, got
    os.remove(path)
    torch.cuda.empty_cache()
    return row


def phase13c_dit(root: str) -> tuple:
    """DiT-XL/2 at full width and 2 blocks written as a JAX
    DiffusionTrainState, read through dit_sample's loader from params and
    ema_params: each forward bit-equal to its source; then 10 DDPM steps of
    the EMA model decoded through the f32 VAE, mha's launches counted."""
    from omnitokenizer_tpu_torch import DiffusionVAEAdapter, imagenet_k600_config
    import numpy as np

    from omnitokenizer_tpu_torch.cli import diffusion_common, dit_sample
    from omnitokenizer_tpu_torch.convert import (dit_state_dict_to_jax, load_diffusion_checkpoint,
                                                 load_diffusion_state_dict)
    from omnitokenizer_tpu_torch.models.dit import DiT
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.utils.msgpack_io import write_msgpack

    args = dit_sample.build_parser().parse_args(SAMPLE_FLAGS + ["--num_sampling_steps", "10"])
    cfg = diffusion_common.model_config(args, False).replace(depth=2)
    sources = {}
    for field, seed in (("params", 0), ("ema_params", 1)):
        with torch.device("cuda"):
            sources[field] = fill_random(DiT(cfg), seed).eval()
    path = os.path.join(root, "state_000000002.msgpack")
    t0 = time.perf_counter()
    write_msgpack(path, {f: dit_state_dict_to_jax(m.state_dict(), cfg.patch_size)
                         for f, m in sources.items()} | {"opt_state": None,
                                                         "step": np.asarray(2, np.int32)})
    write_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(71)
    x = torch.randn(2, cfg.in_channels, cfg.input_size, cfg.input_size, generator=g).cuda()
    t, y = torch.tensor([17, 640], device="cuda"), torch.tensor([3, 981], device="cuda")
    loaded, load_s = {}, {}
    for field, use_ema in (("params", False), ("ema_params", True)):
        t0 = time.perf_counter()
        with torch.device("cuda"):
            model = DiT(cfg)
        load_diffusion_state_dict(model, load_diffusion_checkpoint(path, cfg.patch_size, use_ema))
        torch.cuda.synchronize()
        load_s[field] = time.perf_counter() - t0
        with torch.inference_mode():
            same = torch.equal(model.eval()(x, t, y), sources[field](x, t, y))
        if not same:
            raise AssertionError(f"DiT forward from {field} differs from its source")
        loaded[field] = model
    del sources
    ad = DiffusionVAEAdapter.from_config(imagenet_k600_config(use_vae=True), seed=0)
    diffusion = dit_sample.make_diffusion(args, False)
    gen = torch.Generator("cuda").manual_seed(72)
    z = dit_sample.sample_batch(args, loaded["ema_params"], diffusion,
                                torch.tensor([1, 500], device="cuda"), gen, False)
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.inference_mode():
        pixels = diffusion_common.decode_batch_fn(ad, False)(z)
        torch.cuda.synchronize()
    counts = launch_counts()
    if counts != DIFF_LAUNCHES["decode"]:
        raise AssertionError(f"decode launches {counts} != {DIFF_LAUNCHES['decode']}")
    if (tuple(pixels.shape) != (2, 3, RES, RES) or not bool(torch.isfinite(pixels).all())
            or float(pixels.abs().max()) > 0.5):
        raise AssertionError(f"bad samples {tuple(pixels.shape)}")
    print(f"[13c] DiT-XL/2 at 2 blocks: wrote {_file_gb(path):.3f} GB (params + ema_params) in "
          f"{write_s:.2f} s; dit_sample's loader {load_s['params']:.2f} s (--no_ema) and "
          f"{load_s['ema_params']:.2f} s (--use_ema), each forward bit-equal to its source; 10 "
          f"DDPM steps of 2 images decoded through the f32 VAE, launches in the decode {counts}")
    del loaded, ad, z, pixels
    torch.cuda.empty_cache()
    return counts, {"msgpack_gb": _file_gb(path), "write_s": write_s, "load_s": load_s}


def he_normal(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every conv and linear weight N(0, 2 / fan_in), zero biases, unit
    BatchNorm (running mean 0, var 1): random weights under which a deep
    ReLU network's features still depend on its input (the default inits
    shrink them layer by layer until every clip gives the same features)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * (2 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
    return model


def phase13d_metrics(root: str, video: torch.Tensor, recon) -> dict:
    """metrics_eval over .npz directories of (a)'s clips and their
    reconstructions with random I3D and Inception .pt files, every metric,
    on the card and with --device cpu."""
    import numpy as np

    from omnitokenizer_tpu_torch.cli import metrics_eval
    from omnitokenizer_tpu_torch.eval.frechet import frechet_distance
    from omnitokenizer_tpu_torch.eval.i3d import InceptionI3d
    from omnitokenizer_tpu_torch.eval.inception import load_inception

    gt = video.float().cpu().numpy()
    for d, clips in (("gt", gt), ("gen", recon)):
        os.makedirs(os.path.join(root, d))
        for i, clip in enumerate(clips):  # (C, T, H, W), the model's [-0.5, 0.5]
            np.savez(os.path.join(root, d, f"clip{i}.npz"), video=clip)
    torch.save(he_normal(InceptionI3d(), 2).state_dict(), os.path.join(root, "i3d.pt"))
    inc, _ = load_inception(None, device="cpu", seed=1)
    torch.save(he_normal(inc, 3).state_dict(), os.path.join(root, "inception.pt"))
    flags = ["--gen_dir", os.path.join(root, "gen"), "--gt_dir", os.path.join(root, "gt"),
             "--i3d_path", os.path.join(root, "i3d.pt"), "--inception_path",
             os.path.join(root, "inception.pt"),
             "--metrics", "psnr,ssim,fvd,lpips,is,fid,sfid,prec_recall"]
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[device] = metrics_eval.main(flags + ["--device", device])
        torch.cuda.synchronize()
        out[device + "_s"] = time.perf_counter() - t0
        if device == "cuda":
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card, cpu = out["cuda"], out["cpu"]
    frames = len(gt) * T
    feats = np.random.RandomState(75).randn(2, frames, 2048)
    t0 = time.perf_counter()  # one Frechet distance on the host (float64, two SVD roots)
    frechet_distance(feats[0], feats[1])
    frechet_s = time.perf_counter() - t0
    errs = {k: abs(card[k] - cpu[k]) for k in ("psnr", "ssim", "precision", "recall")}
    print(f"[13d] metrics_eval, {len(gt)} clips of {T}x{RES}^2 ({frames} frames): card "
          f"{out['cuda_s']:.2f} s ({len(gt) / out['cuda_s']:.3f} clips/s, peak {peak:.2f} GiB), "
          f"--device cpu "
          f"{out['cpu_s']:.2f} s; |card - cpu|: " + ", ".join(f"{k} {v:.3e}"
                                                               for k, v in errs.items())
          + f"; one 2048-d Frechet distance on the host {frechet_s:.2f} s (FID and sFID take "
            f"one each, FVD one at 400-d)")
    print(f"[13d] Frechet values with random features (no bar: N < d leaves the matrix root "
          f"ill-conditioned), card / cpu: " + ", ".join(
              f"{k} {card[k]:.6g} / {cpu[k]:.6g}" for k in ("fvd", "fid", "sfid", "is")))
    if not (errs["psnr"] <= CKPT_METRIC_TOL and errs["ssim"] <= CKPT_METRIC_TOL
            and errs["precision"] <= 2 / frames and errs["recall"] <= 2 / frames):
        raise AssertionError(f"metrics, card vs CPU: {errs}")
    if any(card[k] is None or not math.isfinite(card[k])
           for k in ("psnr", "ssim", "fvd", "is", "fid", "sfid", "precision", "recall")):
        raise AssertionError(f"metrics on the card: {card}")
    return {"card": card, "cpu": cpu, "card_s": out["cuda_s"], "cpu_s": out["cpu_s"],
            "clips_per_s": len(gt) / out["cuda_s"], "peak_gib": peak, "abs_err": errs,
            "frechet_2048_host_s": frechet_s}


def phase13e_prec_recall() -> dict:
    """precision_recall at the evaluator's size, timed beside its bound, and
    the radii of a subset on the card against the CPU."""
    from omnitokenizer_tpu_torch.eval.prec_recall import manifold_radii, precision_recall

    g = torch.Generator("cuda").manual_seed(73)
    ref = torch.randn(PR_N, PR_D, generator=g, device="cuda")
    sample = torch.randn(PR_N, PR_D, generator=g, device="cuda")
    sub = ref[:PR_SUBSET]
    rel = rel_err(manifold_radii(sub).cpu(), manifold_radii(sub.cpu(), device="cpu"))
    if not rel <= PR_RADII_REL_TOL:
        raise AssertionError(f"radii, card vs CPU: {rel:.3e} > {PR_RADII_REL_TOL}")
    precision_recall(ref[:PR_SUBSET], sample[:PR_SUBSET])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    prec, rec = precision_recall(ref, sample)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    flops = 3 * 2 * PR_N ** 2 * PR_D  # the radii of each set and the folds: N^2 D MACs each
    b = bound(flops, 2 * PR_N * PR_D * 4, PEAK_F32)
    print(f"[13e] precision_recall {PR_N} x {PR_D} f32 (TF32 off): {secs:.3f} s, bound "
          f"{b['bound_ms'] / 1e3:.3f} s ({flops / 1e12:.1f} TFLOP at {PEAK_F32 / 1e12:.0f} "
          f"TFLOP/s, {b['bound_ms'] / 1e3 / secs:.1%} of it), peak {peak:.2f} GiB above the "
          f"features; precision {prec:.4f} recall {rec:.4f}; radii of {PR_SUBSET} rows, card vs "
          f"CPU, max-abs ratio {rel:.3e}")
    return {"seconds": secs, "bound_s": b["bound_ms"] / 1e3, "bound_by": b["bound_by"],
            "tflop": flops / 1e12, "peak_gib": peak, "precision": prec, "recall": rec,
            "radii_rel_err": rel}


def phase13_checkpoints() -> dict:
    """Checkpoints in, scores out: (a) the flagship tokenizer, (b) the LM,
    (c) DiT, each written in the JAX package's msgpack format and read back
    through the entry points' loaders on the card; (d) metrics_eval on the
    card against the CPU; (e) precision/recall at the evaluator's size."""
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(74)
    video = (torch.rand(B, 3, T, RES, RES, generator=g) - 0.5).cuda()  # the model's range
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        paths["ckpt_tokenizer"], tok, recon = phase13a_tokenizer(root, video)
        lm = phase13b_lm(root, os.path.join(root, "imagenet_k600.msgpack"))
        paths["ckpt_dit_decode"], dit = phase13c_dit(root)
        metrics = phase13d_metrics(root, video, recon)
    del video, recon
    torch.cuda.empty_cache()
    pr = phase13e_prec_recall()
    print(json.dumps({"checkpoints": {"tokenizer": tok, "lm": lm, "dit": dit},
                      "metrics": metrics, "prec_recall": pr}))
    print(f"[13] phase 13 in {time.perf_counter() - t0:.1f} s")
    return paths


# -- phase 14: the tokenizer's variants and text-to-video Latte ----------------------------------
# (a) the flagship's width (512, 8 heads of 64, depth 4 + 4) in bf16 under the configurations the
# port serves beside the linear/sdpa flagship, random weights from seed 0 with every tensor filled
# and BatchNorm's running statistics away from 0 and 1. A call that carries a bias (einsum mode)
# reaches no attention kernel: its logits take the bias in the plain math.
_NONE = {k: 0 for k in KERNELS}
VARIANTS = {  # name: (overrides of the config, the config, batch, launches in one round trip)
    # 'rel' CPB on the spatial calls, AliBi on the causal temporal ones: ln_qkv and geglu_ff only
    "einsum_rel": (dict(attn_bias_mode="einsum"), "imagenet_only", B,
                   {**_NONE, "geglu_ff": 16, "ln_qkv": 14, "vq_argmin": 1}),
    # RoPE: the spatial calls carry no bias (cosine_mha), the temporal ones AliBi (plain)
    "einsum_rope": (dict(attn_bias_mode="einsum"), "imagenet_k600", B,
                    {**_NONE, "geglu_ff": 16, "ln_qkv": 14, "cosine_mha": 6, "vq_argmin": 1}),
    # the strided-conv patch embed and its BatchNorm: the flagship's stacks
    "cnn": (dict(patch_embed="cnn"), "imagenet_k600", B, EXPECTED_LAUNCHES["vq"]),
    # half patches: the spatial stacks at 64 x 64 = 4096 tokens, above cosine_mha's and mha's
    # N <= 2048 (plain), the temporal ones at 9 frames (mha's small branch, causal)
    "defer": (dict(defer_temporal_pool=True, defer_spatial_pool=True), "imagenet_k600", 1,
              {**_NONE, "geglu_ff": 16, "ln_qkv": 14, "mha": 8, "vq_argmin": 1}),
    # encoder 'ttaw': 2 cosine_mha at 32^2, a 2 x 2 average pool to 16^2, a window block; the
    # temporal stacks at 16^2; decoder 'nttt': nearest x2 back to 32^2, 3 cosine_mha
    "pool": (dict(enc_block="ttaw", dec_block="nttt"), "imagenet_k600", B,
             {**_NONE, "geglu_ff": 16, "ln_qkv": 13, "cosine_mha": 5, "small_n_attention": 8,
              "vq_argmin": 1}),
}
SMALL_VARIANT_REL_TOL = 1e-4  # f32 card vs CPU, whole-tensor


def filled_tokenizer(cfg, seed: int = 0, device: str = "cuda"):
    """OmniTokenizerVQGAN of `cfg` with every tensor random from `seed`:
    from_config's LeCun-normal kernels and codebook, then every 1-D weight
    (norms, scales) 1 + N(0, 0.1^2), every bias N(0, 0.02^2), BatchNorm's
    running mean N(0, 0.1^2) and variance U(0.5, 1.5). The same seed fills
    the same values at any dtype."""
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN

    model = OmniTokenizerVQGAN.from_config(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.net.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if t.ndim != 1 or not t.is_floating_point() or name.startswith("codebook."):
                continue
            if leaf == "var":
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif leaf == "mean":
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif leaf.endswith("bias"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.02)
            else:
                t.copy_(1 + 0.1 * torch.randn(t.shape, generator=g))
    model.net.to(device)
    return model


def reference_state_from(net, cfg) -> dict:
    """`net`'s tensors under the reference's Lightning keys, in its layouts:
    each key's index map from utils/checkpoint.py:port_key, applied to an
    arange, inverts the layout transform exactly; the keys the tokenizer's
    loader skips keep reference_tokenizer_state's values."""
    import numpy as np

    from omnitokenizer_tpu_torch.utils.checkpoint import port_key

    port = {k: v.detach().float().cpu().numpy() for k, v in net.state_dict().items()}
    out = {}
    for key, val in reference_tokenizer_state(cfg, seed=0).items():
        k, idx = port_key(key, np.arange(val.numel()).reshape(tuple(val.shape)), cfg)
        if k is None:
            out[key] = val
            continue
        ref = np.empty(val.numel(), np.float32)
        ref[idx.astype(np.int64).ravel()] = port[k].ravel()
        out[key] = torch.from_numpy(ref.reshape(tuple(val.shape)))
    return out


def phase14a_variants() -> dict:
    """The five variants' bf16 round trips (launches, the kernel route
    against the plain route, frames/s and peak memory); each new path's
    kernel shapes against their plain versions; a small f32 cnn and einsum
    model on the card against the CPU; a cnn checkpoint as a reference .ckpt
    and as a JAX msgpack with batch_stats, each loaded on the card into a
    round trip bit-equal to the source model's."""
    import argparse

    from omnitokenizer_tpu_torch import (OmniTokenizerVQGAN, TokenizerConfig,
                                         imagenet_k600_config, imagenet_only_config)
    from omnitokenizer_tpu_torch.convert import state_dict_to_jax
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.utils.checkpoint import config_to_json
    from omnitokenizer_tpu_torch.utils.msgpack_io import write_msgpack

    bases = {"imagenet_k600": imagenet_k600_config, "imagenet_only": imagenet_only_config}
    paths = {}
    for name, (kw, base, batch, expected) in VARIANTS.items():
        cfg = bases[base]().replace(dtype=BF, **kw)
        t0 = time.perf_counter()
        ref32 = filled_tokenizer(cfg.replace(dtype=torch.float32))
        paths[name] = bf16_slice(f"14a {name}", cfg, expected, batch,
                                 model=filled_tokenizer(cfg), ref32=ref32)
        del ref32
        torch.cuda.empty_cache()
        print(f"[14a {name}] {kw} on {base}, B={batch}: {time.perf_counter() - t0:.1f} s")

    # the new paths' kernel shapes (the einsum and cnn variants run the flagship's and the
    # stage-1 tokenizer's, phase 2's rows), with phase 2's weights
    g = torch.Generator().manual_seed(14)
    D, H, Dh, inner = 512, 8, 64, int(4 * 2 / 3 * 512)
    gamma, ln_w, ln_b = 1 + randn(g, D, scale=0.1), 1 + randn(g, D, scale=0.1), randn(g, D, scale=0.1)
    wq = randn(g, D, D, scale=D ** -0.5, dtype=BF)
    wkv = randn(g, 2 * D, D, scale=D ** -0.5, dtype=BF)
    w1, w2 = randn(g, 2 * inner, D, scale=D ** -0.5), randn(g, D, inner, scale=inner ** -0.5)
    qs, ks, emb = 1 + randn(g, Dh, scale=0.1), 1 + randn(g, Dh, scale=0.1), randn(g, 8192, 8)
    for path, M in (("defer", 9 * 64 * 64), ("pool", B * 5 * 16 * 16)):
        x = randn(g, M, D, dtype=BF)
        check_ln_qkv("14a", path, x, gamma, wq, wkv)
        check_geglu("14a", path, x, ln_w, ln_b, w1, w2)
    check_mha("14a", "defer", g, (64 * 64, H, 9, Dh), BF, True)
    check_small_n("14a", "pool", randn(g, B * 256, 5, H * Dh, dtype=BF),
                  randn(g, B * 256, 5, 2 * H * Dh, dtype=BF), qs, ks, H, Dh)
    for path, M in (("defer", 5 * 1024), ("pool", B * 5 * 256)):
        check_vq("14a", path, F.normalize(randn(g, M, 8), dim=-1).contiguous(), emb)

    # what the plain attention of these paths costs: the deferred encoder's spatial calls at
    # (9, 8, 4096, 64), 6 a round trip, and einsum_rel's biased spatial calls at (36, 8, 1024,
    # 64) with the CPB bias, 6 a round trip; bf16, SDPA on the same inputs beside them
    from omnitokenizer_tpu_torch.ops.kernels.mha import mha_plain

    for path, (b_, n) in (("defer", (9, 4096)), ("einsum_rel", (B * 9, 1024))):
        q, k, v = (randn(g, b_, H, n, Dh, dtype=BF) for _ in range(3))
        bias = randn(g, H, n, n) if path == "einsum_rel" else None
        plain_ms = cuda_ms(lambda: mha_plain(q, k, v, 8.0, False, bias), iters=3, warmup=1)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=None if bias is None else bias.to(BF), scale=8.0), iters=3,
            warmup=1)
        print(f"[14a] {path}: the plain attention of a spatial call ({b_}, {H}, {n}, {Dh}) "
              f"bf16{' + bias' if bias is not None else ''}: {plain_ms:.4f} ms (6 a round trip: "
              f"{6 * plain_ms:.2f} ms); SDPA on the same inputs {sdpa_ms:.4f} ms")
        del q, k, v, bias
    torch.cuda.empty_cache()

    # a small f32 cnn (BatchNorm) and einsum ('rel': CPB and AliBi) model, card against CPU
    small = TokenizerConfig(embedding_dim=128, n_codes=256, resolution=64, sequence_length=9,
                            enc_block="tw", dec_block="tt", spatial_depth=2, temporal_depth=2,
                            twod_window_size=4, heads=2, dim_head=64, spatial_pos="rel")
    video = torch.rand(2, 3, 9, 64, 64, generator=torch.Generator().manual_seed(15)) * 2 - 1
    for kw in (dict(patch_embed="cnn"), dict(attn_bias_mode="einsum")):
        out = {d: filled_tokenizer(small.replace(**kw), device=d).reconstruct(video.to(d), False)
               for d in ("cpu", "cuda")}
        err = rel_norm(out["cuda"][0].cpu(), out["cpu"][0])
        same = torch.equal(out["cuda"][1]["encodings"].cpu(), out["cpu"][1]["encodings"])
        print(f"[14a] small f32 {kw}: card vs CPU pixels rel err {err:.3e} (bar "
              f"{SMALL_VARIANT_REL_TOL}), indices equal {same}")
        if not (same and err <= SMALL_VARIANT_REL_TOL):
            raise AssertionError(f"small f32 {kw}: card vs CPU {err:.3e}, indices equal {same}")

    # a cnn flagship's weights as a reference .ckpt and as a JAX msgpack (batch_stats), loaded
    cfg = imagenet_k600_config().replace(dtype=BF, patch_embed="cnn")
    source = filled_tokenizer(cfg)
    src = source.net  # its f32 masters, written before serving() casts them
    clip = (torch.rand(B, 3, T, RES, RES, generator=torch.Generator().manual_seed(16)) - 0.5)
    with tempfile.TemporaryDirectory() as root:
        ckpt, mp = os.path.join(root, "cnn.ckpt"), os.path.join(root, "cnn.msgpack")
        hp = argparse.Namespace(**{k: v for k, v in config_to_json(cfg).items() if k != "dtype"})
        torch.save({"state_dict": reference_state_from(src, cfg),
                    "hyper_parameters": {"args": hp}}, ckpt)
        write_msgpack(mp, state_dict_to_jax(src))
        with open(mp + ".cfg.json", "w") as f:
            json.dump(config_to_json(cfg), f)
        want = source.reconstruct(clip, is_image=False)
        for path in (ckpt, mp):
            t0 = time.perf_counter()
            model = OmniTokenizerVQGAN.load_from_checkpoint(path, cfg=cfg)  # the card
            load_s = time.perf_counter() - t0
            reset_launch_counts()
            got = model.reconstruct(clip, is_image=False)
            torch.cuda.synchronize()
            counts = launch_counts()
            stats = model.net.encoder.to_patch_emb_cnorm.norm.var
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1]["encodings"], want[1]["encodings"])
                    and counts == EXPECTED_LAUNCHES["vq"] and not bool((stats == 1).all())
                    and not model.unfilled):
                raise AssertionError(f"{os.path.basename(path)}: round trip unequal to the "
                                     f"source's, launches {counts}, unfilled {model.unfilled[:3]}")
            print(f"[14a] cnn {os.path.basename(path)} ({_file_gb(path):.3f} GB) loaded on the "
                  f"card in {load_s:.2f} s: bf16 round trip of B={B} clips bit-equal to the "
                  f"source model's, indices too, BatchNorm statistics from the file; launches "
                  f"{counts}")
            del model
    del source, src
    torch.cuda.empty_cache()
    return paths


# (b) LatteT2V at PixArt-alpha's widths with the JAX CLI's defaults (28 layers, 16 heads of 72,
# T5-XXL captions of 4096 channels, 120 tokens, patch 2, gelu-approximate with attention bias,
# 16 frames) at --image_size 256 (32^2 latents) and --in_channels 8 --out_channels 16 (the VAE's
# latents, learned sigma); random weights from seed 0 with every tensor filled N(0, 0.02^2),
# captions from the byte fallback (no T5 weights are at hand)
T2V_FLAGS = ["--image_size", "256", "--in_channels", "8", "--out_channels", "16", "--device",
             "cuda"]
T2V_STEPS = 50
# the f32 VAE's decode of 16 latent frames: the decoder's 4 spatial 't' blocks and its 4
# temporal ones (N = 16: mha's small branch, causal)
T2V_DECODE_LAUNCHES = {**_NONE, "mha": 8}


def t2v_flops(cfg, rows: int, frames: int, tokens: int) -> float:
    """FLOPs of one forward of `rows` samples, the products the code runs:
    spatial blocks (self-attention, caption cross-attention over `tokens`,
    feed-forward), temporal blocks, the caption projection, the embeds and
    the final layer."""
    D, p, Cc = cfg.inner_dim, cfg.patch_size, cfg.caption_channels
    N = (cfg.sample_size // p) ** 2
    ff = 2 * 2 * D * 4 * D
    spatial = frames * (N * (2 * 4 * D * D + 4 * N * D + 2 * 2 * D * D + 4 * tokens * D + ff)
                        + tokens * 2 * 2 * D * D)
    temporal = N * frames * (2 * 4 * D * D + 4 * frames * D + ff)
    other = (2 * tokens * (Cc * D + D * D) + 2 * (256 * D + D * D + 6 * D * D)
             + frames * N * 2 * D * (cfg.in_channels * p * p + p * p * cfg.out_ch))
    return float(rows * (cfg.num_layers * (spatial + temporal) + other))


def t2v_profile(fn) -> dict:
    """One call of fn() under torch.profiler: device ms by group (GEMMs,
    attention, the rest: norms, modulation, activations, casts) and the
    eight longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def self_dev(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    def group(key: str) -> str:
        if any(k in key for k in ("fmha", "flash", "attention", "sdpa", "softmax")):
            return "attention"
        if any(k in key for k in ("gemm", "nvjet", "xmma", "cutlass")):
            return "gemm"
        return "other"

    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA), key=self_dev,
                     reverse=True)
    ms = dict.fromkeys(("gemm", "attention", "other"), 0.0)
    for e in kernels:
        ms[group(e.key)] += self_dev(e)
    print("[14b] a profiled sampling step, device ms by group: "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    for e in kernels[:8]:
        print(f"[14b]   {self_dev(e):8.2f} ms {e.count:5d}x {e.key[:110]}")
    return ms


def phase14b_t2v() -> dict:
    """LatteT2V: the f32 forward at 2 layers card against CPU, bf16 against
    f32 at full depth, ddim50 sampling with CFG 7.5 in bf16 decoded through
    the f32 VAE, and the sample CLI end to end from a JAX msgpack."""
    import importlib.util

    import numpy as np

    from omnitokenizer_tpu_torch import DiffusionVAEAdapter, imagenet_k600_config
    from omnitokenizer_tpu_torch.cli import latte_t2v_sample as cli
    from omnitokenizer_tpu_torch.convert import latte_t2v_state_dict_to_jax
    from omnitokenizer_tpu_torch.models.latte_t2v import LatteT2V
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.utils import media
    from omnitokenizer_tpu_torch.utils.checkpoint import save_tokenizer_checkpoint
    from omnitokenizer_tpu_torch.utils.msgpack_io import write_msgpack

    args = cli.build_parser().parse_args(T2V_FLAGS)
    cfg = cli.load_t2v_config(args, torch.float32)
    prompts = ["a corgi running on the beach"]
    emb, mask = cli.encode_prompts(args, prompts)
    neg, neg_mask = cli.encode_prompts(args, [args.negative_prompt])
    ctx = torch.from_numpy(np.concatenate([neg, emb])).float()
    keep = torch.from_numpy(np.concatenate([neg_mask, mask]))
    lat, C = cfg.sample_size, cfg.in_channels
    g = torch.Generator().manual_seed(90)

    # f32 at full width and 2 layers, 4 frames of the CFG batch: card against CPU
    with torch.device("cuda"):
        two = fill_random(LatteT2V(cfg.replace(num_layers=2)), 0).eval()
    x4 = torch.randn(2, 4, C, lat, lat, generator=g)
    t2 = torch.tensor([999, 999])
    with torch.no_grad():
        card = two(x4.cuda(), t2.cuda(), ctx.cuda(), keep.cuda()).cpu()
        cpu = two.cpu()(x4, t2, ctx, keep)
    err = rel_norm(card, cpu)
    print(f"[14b] LatteT2V f32, {cfg.inner_dim} wide, 2 layers, 4 frames, CFG batch: card vs CPU "
          f"rel err {err:.3e} (bar {DIFF_F32_REL_TOL}); output {tuple(card.shape)}")
    if not (err <= DIFF_F32_REL_TOL and bool(torch.isfinite(card).all())):
        raise AssertionError(f"t2v f32 card vs CPU rel err {err:.3e}")
    del two

    # bf16 against f32 on the card at full depth, 16 frames
    with torch.device("cuda"):
        model = fill_random(LatteT2V(cfg), 0).eval()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.randn(2, cfg.video_length, C, lat, lat, generator=g).cuda()
    t = torch.tensor([999, 999], device="cuda")
    ctx, keep = ctx.cuda(), keep.cuda()
    with torch.no_grad():
        f32 = model(x, t, ctx, keep)
        bf = served_as(model, BF)
        err_bf = rel_norm(bf(x, t, ctx, keep), f32)
    del model
    print(f"[14b] LatteT2V {cfg.num_layers} x {cfg.inner_dim} ({n_params} parameters), "
          f"{cfg.video_length} frames of {lat}^2 latents: bf16 vs f32 on the card rel err "
          f"{err_bf:.3e} (bar {DIFF_BF16_REL_TOL})")
    if not err_bf <= DIFF_BF16_REL_TOL:
        raise AssertionError(f"t2v bf16 vs f32 rel err {err_bf:.3e}")

    # mha at the f32 VAE decode's shapes for 16 latent frames: the spatial blocks (16, 8,
    # 1024, 64) and the causal temporal ones (1024, 8, 16, 64)
    check_mha("14b", "t2v_decode", g, (cfg.video_length, 8, 1024, 64), torch.float32, False)
    check_mha("14b", "t2v_decode", g, (1024, 8, cfg.video_length, 64), torch.float32, True)

    # ddim50, CFG 7.5, B=1 prompt in bf16 (2 rows a step), the sample CLI's functions
    sargs = cli.build_parser().parse_args(T2V_FLAGS + ["--bf16"])
    diffusion = cli.make_diffusion(sargs)
    eps = cli.guided_eps(bf, ctx, keep, sargs.guidance_scale, C)
    shape = (1, cfg.video_length, C, lat, lat)
    gen = torch.Generator("cuda").manual_seed(91)
    xs = torch.randn(shape, generator=gen, device="cuda")
    ts = torch.full((1,), diffusion.num_timesteps - 1, device="cuda")

    def one_step():
        return diffusion.ddim_sample(eps, xs, ts, clip_denoised=False)

    with torch.inference_mode():
        step_ms = cuda_ms(one_step, iters=5, warmup=2, queued=False)
        kernels, busy_ms = kernel_stats(one_step)
        groups = t2v_profile(one_step)
    flops = t2v_flops(cfg, 2, cfg.video_length, args.max_token_length)
    b = bound(flops, n_params * 2 + 3 * xs.numel() * 4, PEAK_BF16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        z = diffusion.ddim_sample_loop(eps, shape, gen, clip_denoised=False, device="cuda")
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    if any(launch_counts().values()):  # the transformer runs no hand-written kernel
        raise AssertionError(f"kernels launched while sampling: {launch_counts()}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del bf
    torch.cuda.empty_cache()

    # the decode through phase 5's f32 VAE: mha's launches, against the VAE's plain route
    ad = DiffusionVAEAdapter.from_config(imagenet_k600_config(use_vae=True), seed=0)
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        raw = ad.decode(z.permute(0, 2, 1, 3, 4), is_image=False)
        torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = launch_counts()
    frames = 1 + (cfg.video_length - 1) * ad.vae.cfg.temporal_patch_size
    print(f"[14b] launches in the decode of 1 clip ({frames} frames): {counts}")
    if counts != T2V_DECODE_LAUNCHES:
        raise AssertionError(f"decode launches {counts} != {T2V_DECODE_LAUNCHES}")
    if (tuple(raw.shape) != (1, 3, frames, RES, RES) or not bool(torch.isfinite(z).all())
            or not bool(torch.isfinite(raw).all())):
        raise AssertionError(f"bad t2v sample {tuple(z.shape)} / {tuple(raw.shape)}")
    dec_err = decode_vs_plain("14b", ad, z, True, raw)
    wall = loop_s + decode_s
    row = {"path": "t2v", "dtype": "bf16", "batch": 1, "rows_a_step": 2, "steps": T2V_STEPS,
           "params": n_params, "ms_per_step": step_ms, "loop_ms_per_step": loop_s * 1e3 / T2V_STEPS,
           "gflop_per_step": flops / 1e9, **b, "clips_per_s": 1 / wall, "wall_s": wall,
           "decode_s": decode_s, "peak_gib": peak, "kernels_per_step": kernels,
           "device_busy_ms_per_step": busy_ms, "mha_decode_launches": counts["mha"],
           "decode_rel_err": dec_err, "f32_card_vs_cpu": err, "bf16_vs_f32": err_bf,
           "device_ms_by_group": groups}
    print(f"[14b] bf16 B=1 (2 rows), {T2V_STEPS} DDIM steps: {step_ms:.4f} ms a step (bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}, {flops / 1e9:.1f} GFLOP; "
          f"{b['bound_ms'] / step_ms:.1%} of it), loop {row['loop_ms_per_step']:.4f} ms a step, "
          f"{row['clips_per_s']:.4f} clips/s end to end ({wall:.2f} s, the f32 decode "
          f"{decode_s:.2f} s), peak {peak:.2f} GiB, {kernels} device kernels a step, busy "
          f"{busy_ms:.4f} ms of a profiled step")

    # the CLI end to end: a 2-layer JAX msgpack --ckpt and the VAE's checkpoint. On a host
    # without an mp4 encoder (imageio with its ffmpeg or av plugin) the clips go to a stand-in
    # that writes the uint8 grid save_video_grid would encode, as .npy beside the mp4's name
    with tempfile.TemporaryDirectory() as root:
        with torch.device("cuda"):
            small = fill_random(LatteT2V(cfg.replace(num_layers=2)), 1)
        mp = os.path.join(root, "t2v.msgpack")
        write_msgpack(mp, {"params": latte_t2v_state_dict_to_jax(small.state_dict())})
        vae = os.path.join(root, "vae.pt")
        save_tokenizer_checkpoint(vae, ad.vae.net, ad.vae.cfg)
        encoder = any(importlib.util.find_spec(m) for m in ("imageio_ffmpeg", "av"))
        writer = media.save_video_grid
        if not (importlib.util.find_spec("imageio") and encoder):
            media.save_video_grid = lambda video, fname: np.save(
                fname + ".npy", media.make_video_grid(video))
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(T2V_FLAGS + ["--num_layers", "2", "--ckpt", mp, "--vae_ckpt", vae,
                                  "--num_sampling_steps", "10", "--save_img_path", root])
            cli_s = time.perf_counter() - t0
        finally:
            media.save_video_grid = writer
        counts = launch_counts()
        out = [f for f in os.listdir(root) if f.startswith("a_corgi")]
    print(f"[14b] latte_t2v_sample.main, 2 layers from a JAX msgpack, 10 DDIM steps, through the "
          f"f32 VAE: {cli_s:.2f} s, wrote {out}; launches {counts}")
    if len(out) != 1 or counts != T2V_DECODE_LAUNCHES:
        raise AssertionError(f"t2v CLI wrote {out}, launches {counts}")
    row["cli_s"] = cli_s
    del ad, small, z, raw
    torch.cuda.empty_cache()
    print(json.dumps({"t2v": row}))
    return {"t2v_decode": counts}


def phase14_variants_t2v() -> dict:
    """(a) the tokenizer's variants, (b) LatteT2V; returns their launches."""
    t0 = time.perf_counter()
    paths = phase14a_variants()
    paths.update(phase14b_t2v())
    print(json.dumps({"variants": {k: v for k, v in SLICE_STATS.items() if k.startswith("14a")}}))
    print(f"[14] phase 14 in {time.perf_counter() - t0:.1f} s")
    return paths


# -- phase 15: VAE training, the CNN VQGAN, the quantizers ------------------------------------
# The recipe's stage 3 (scripts/recons/train.sh): the f32 VAE finetune from the stage-2 VQ
# checkpoint, its losses and schedule (grad_accumulates 2, clips 1.0, the disc gate 0.001),
# 3 video steps at B=4 x 17x256^2 then 1 image step at B=8 x 256^2 (its --batch_size 4 8).
# Kernel route against plain route from the same start: the first step's losses within the
# training bar (5e-3, TRAIN_LOSS_REL_TOL) and within the f32 card bar (1e-4) too, the gradient
# norms within 5e-2; the f32 mha kernel on the step's first spatial q, k, v against mha_plain
STAGE3_F32_LOSS_REL_TOL = 1e-4
STAGE3_VIDEO_STEPS, STAGE3_IMAGE_B = 3, 8
# the CNN VQGAN at load_cnn_vqgan_checkpoint's defaults (n_hiddens 240, downsample (4, 4, 4),
# 256-wide codes, 2048 of them, group norm) on B=4 clips of 16 x 128^2
CNN_B, CNN_T, CNN_RES = 4, 16, 128
CNN_REL_TOL = 1e-4        # f32, whole-tensor relative: card against CPU; decodes of two index sets
# the quantizers at working sizes, card against CPU: 16384 rows, VQ of 8192 codes of width
# 256 (kmeans init, 10 Lloyd steps), FSQ levels (8, 8, 8, 5, 5, 5), LFQ of 2^14 codes,
# residual stacks 2 deep (a depth cut for the run's time: each layer's kmeans is held step by
# step against the CPU's). Indices equal but for f32 near-ties (the two choices' f64 scores
# within VQ_TIE_TOL), each counted and the codes they touch left out of the state's bar
Q_ROWS, Q_DIM, Q_CODES, Q_DEPTH = 16384, 256, 8192, 2
Q_FSQ_LEVELS, Q_LFQ_DIM = (8, 8, 8, 5, 5, 5), 14
Q_REL_TOL = 1e-5


def stage3_trainer(device: str = "cuda"):
    from omnitokenizer_tpu_torch import imagenet_k600_config
    from omnitokenizer_tpu_torch.config import LossConfig, TrainConfig
    from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer

    cfg = imagenet_k600_config(use_vae=True).replace(kl_weight=1e-6)
    return TokenizerTrainer(cfg, LossConfig(), TrainConfig(grad_accumulates=2), device=device)


def stage3_data(b_video: int) -> list:
    """3 batches of b_video clips of 17x256^2, then 1 of 8 images of 256^2,
    seeded, on the card."""
    g = torch.Generator().manual_seed(15)
    shapes = [(b_video, T, RES, RES, 3)] * STAGE3_VIDEO_STEPS + [(STAGE3_IMAGE_B, RES, RES, 3)]
    return [((torch.rand(*shape, generator=g) - 0.5) * 0.9).cuda() for shape in shapes]


def stage3_batches(data: list, stamps: list, counts: list):
    """The batches; each yield stamps the host clock (synchronized) and the
    launch counts."""
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts

    for video in data:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        counts.append(launch_counts())
        yield {"video": video}


def stage3_route(trainer, start: str, root: str, ops: str, data: list) -> dict:
    """The stage-3 run from the `start` checkpoint on one route through
    train_tokenizer; its steps' ms (from a batch's arrival to the step's
    end, synchronized: the loop's final checkpoint is not in the last),
    launches and metrics, and the peak."""
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.training.loop import load_state, train_tokenizer

    state = load_state(start, trainer.init_state(seed=1))
    stamps, counts, ends = [], [], []
    real_step = trainer.train_step

    def timed_step(*args, **kw):
        out = real_step(*args, **kw)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    trainer.train_step = timed_step
    try:
        with train_kernel_ops(ops):
            state = train_tokenizer(trainer, stage3_batches(data, stamps, counts), root,
                                    max_steps=STAGE3_VIDEO_STEPS + 1, img_every=0,
                                    log_every=1, initial_state=state, resume=False)
    finally:
        del trainer.train_step
    torch.cuda.synchronize()
    counts.append(launch_counts())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(root, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    steps = [{k: counts[i + 1][k] - counts[i][k] for k in KERNELS}
             for i in range(STAGE3_VIDEO_STEPS + 1)]
    ms = [(end - start) * 1e3 for start, end in zip(stamps, ends)]
    bad = [(r["step"], k) for r in records for k in LOSSES if not abs(r[k]) < float("inf")]
    if bad or state.step != STAGE3_VIDEO_STEPS + 1:
        raise AssertionError(f"stage 3 ({ops}): step {state.step}, non-finite {bad}")
    del state
    return {"ms": ms, "launches": steps, "peak": peak, "first": records[0]}


def stage3_vs_plain(kern: dict, plain: dict) -> list:
    """The first step's losses and gradient norms, kernel against plain
    route; returns the readings over their bars."""
    failed = []
    for k in LOSSES + ("grad_norm_g", "grad_norm_d"):
        a, b = kern["first"][k], plain["first"][k]
        err = abs(a - b) / max(abs(a), abs(b), 0.1)
        bars = ((TRAIN_GRAD_NORM_REL_TOL,) if k.startswith("grad_norm")
                else (TRAIN_LOSS_REL_TOL, STAGE3_F32_LOSS_REL_TOL))
        print(f"[15a] first step {k}: kernel {a:.7g} plain {b:.7g} ({err:.2e}; bar {min(bars)})")
        failed += [f"{k} {err:.3e} > {bar}" for bar in bars if not err <= bar]
    return failed


def phase15a_stage3(smi: str) -> dict:
    """Stage 3 at full width (see the module docstring); returns the
    launches of a video step."""
    from omnitokenizer_tpu_torch import imagenet_k600_config
    from omnitokenizer_tpu_torch.ops import attention as tattn
    from omnitokenizer_tpu_torch.ops.kernels import mha as mh
    from omnitokenizer_tpu_torch.training.loop import load_state, save_state
    from omnitokenizer_tpu_torch.utils.inflate import load_pretrained_into_state

    trainer = stage3_trainer()
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "stage2.ckpt")
        sd = reference_tokenizer_state(imagenet_k600_config(), seed=0)
        torch.save({"state_dict": sd}, path)
        t0 = time.perf_counter()
        state = load_pretrained_into_state(trainer, path, init_vgen="keep", init_vdis="keep",
                                           seed=0)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        fresh = trainer.init_state(seed=0)
        net, init = state.net.state_dict(), fresh.net.state_dict()
        kept = [k for k in net if torch.equal(net[k], init[k])]
        if sorted(kept) != ["pre_vq_conv.bias", "pre_vq_conv.weight"] or state.net.codebook:
            raise AssertionError(f"stage 3's load: tensors at their init values {kept}")
        if not torch.equal(state.image_disc.model0_conv.weight.cpu(),
                           sd["image_discriminator.model0.0.weight"]):
            raise AssertionError("stage 3's load: the image discriminator's first conv")
        print(f"[15a] a stage-2 VQ .ckpt (reference names, seed 0) loaded into the stage-3 VAE "
              f"trainer in {load_s:.2f} s (init_vgen keep, init_vdis keep): every tensor but "
              f"the posterior head pre_vq_conv {tuple(net['pre_vq_conv.weight'].shape)} from "
              f"the file, no codebook")
        start = os.path.join(root, "start.pt")
        save_state(start, state)
        del state, fresh, net, init

        # the kernel route's first spatial mha call, against its plain math
        seen, real = [], tattn._mha_kernel

        def spy(q, k, v, scale, causal):
            if not seen:
                seen.append(tuple(t.detach().contiguous().clone() for t in (q, k, v))
                            + (scale, causal))
            return real(q, k, v, scale, causal)

        def in_turns(b_video: int) -> dict:
            """kernel, plain, plain, kernel: each route's runs from `start`."""
            runs, data = {"attn,ff,flat": [], "0": []}, stage3_data(b_video)
            for i, ops in enumerate(("attn,ff,flat", "0", "0", "attn,ff,flat")):
                run_root = os.path.join(root, f"run{i}")
                tattn._mha_kernel = spy
                try:
                    runs[ops].append(stage3_route(trainer, start, run_root, ops, data))
                finally:
                    tattn._mha_kernel = real
                    shutil.rmtree(run_root, ignore_errors=True)
            return runs

        b_video = B
        try:
            runs = in_turns(b_video)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            b_video = 2
            print(f"[15a] a route at B={B} exceeds the card's memory: both routes at "
                  f"B={b_video}")
            runs = in_turns(b_video)
        # one video step of each route by stage, and its device kernels; then
        # the kernel route's image step
        data = stage3_data(b_video)
        for ops, batch in (("attn,ff,flat", data[0]), ("0", data[0]),
                           ("attn,ff,flat", data[-1][:, None])):
            st = load_state(start, trainer.init_state(seed=2))
            with train_kernel_ops(ops):
                profile_train_step(trainer, st, batch, tag="15a")
            del st
        del data
    q, k, v, scale, causal = seen[0]
    err = compare("stage 3's first mha call", mh.mha(q, k, v, scale, causal),
                  mh.mha_plain(q, k, v, scale, causal), MHA_F32_REL_TOL)
    print(f"[15a] the kernel route's first spatial mha call {tuple(q.shape)} f32 against "
          f"mha_plain on its inputs: max_abs {err[0]:.3e} max_rel {err[1]:.3e}")
    want = EXPECTED_LAUNCHES["vae_train"]
    report = {"batch": b_video}
    for ops, name, mha_calls in (("attn,ff,flat", "kernel", want["mha"]), ("0", "plain", 0)):
        expect = {**want, "mha": mha_calls}
        for run in runs[ops]:
            if any(step != expect for step in run["launches"]):
                raise AssertionError(f"stage 3, {name} route: launches a step "
                                     f"{run['launches']} != {expect}")
            run["video_ms"] = sum(run["ms"][1:STAGE3_VIDEO_STEPS]) / (STAGE3_VIDEO_STEPS - 1)
            run["image_ms"] = run["ms"][-1]
        report[name] = [{k: run[k] for k in ("video_ms", "image_ms", "peak")}
                        for run in runs[ops]]
        print(f"[15a] stage 3 f32 {name} route ({smi}), its runs in the order kernel, plain, "
              f"plain, kernel: video step B={b_video} {T}x{RES}^2 "
              + ", ".join(f"{r['video_ms']:.2f}" for r in runs[ops])
              + f" ms (mean of steps 1-{STAGE3_VIDEO_STEPS - 1}; step 0 "
              + ", ".join(f"{r['ms'][0]:.2f}" for r in runs[ops])
              + f"); image step B={STAGE3_IMAGE_B} "
              + ", ".join(f"{r['image_ms']:.2f}" for r in runs[ops])
              + " ms; peak " + ", ".join(f"{r['peak']:.2f}" for r in runs[ops])
              + f" GiB; mha launches a step {[s['mha'] for s in runs[ops][0]['launches']]}")
    failed = stage3_vs_plain(runs["attn,ff,flat"][0], runs["0"][0])
    if failed:
        raise AssertionError(f"stage 3, kernel vs plain route: {failed}")
    print(json.dumps({"stage3": report}))
    # the image step's spatial calls: (8 images, 8 heads, 32 x 32 tokens, 64)
    check_mha("15a", "vae_train", torch.Generator().manual_seed(15),
              (STAGE3_IMAGE_B, 8, (RES // 8) ** 2, 64), torch.float32, False)
    return {"vae_train": want}


def cnn_config():
    from omnitokenizer_tpu_torch import TokenizerConfig

    return TokenizerConfig(embedding_dim=256, codebook_dim=256, n_codes=2048, norm_type="group")


def phase15b_cnn() -> dict:
    """The CNN VQGAN at the loader's defaults: a round trip's launches, the
    indices against vq_argmin_plain on the same latents, the decodes of the
    two index sets, frames/s and peak; a small one card against CPU."""
    from omnitokenizer_tpu_torch import TokenizerConfig
    from omnitokenizer_tpu_torch.models.cnn_vqgan import CnnVQGAN, init_cnn_vqgan
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.ops.kernels import vq_argmin as vq

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 convs would round to it")
    model = init_cnn_vqgan(CnnVQGAN(cnn_config(), 240, (4, 4, 4)),
                           torch.Generator().manual_seed(0)).cuda().eval()
    g = torch.Generator().manual_seed(16)
    x = ((torch.rand(CNN_B, CNN_T, CNN_RES, CNN_RES, 3, generator=g) - 0.5)).cuda()
    with torch.no_grad():
        reset_launch_counts()
        recon, out = model(x)
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts != EXPECTED_LAUNCHES["cnn_vqgan"] or recon.shape != x.shape:
            raise AssertionError(f"CNN VQGAN round trip: launches {counts}, {tuple(recon.shape)}")
        h = model.encode_latent(x)
        flat, emb = h.reshape(-1, 256).float().contiguous(), model.codebook.embeddings
        idx_k = out["encodings"]
        idx_p = vq.vq_argmin_plain(flat, emb).reshape(idx_k.shape)
        gap = vq_gap("15b", f"CNN VQGAN codebook {tuple(flat.shape)} x {tuple(emb.shape)}",
                     flat, emb)
        err = rel_norm(model.decode(idx_k), model.decode(idx_p))
        if not err <= CNN_REL_TOL:
            raise AssertionError(f"CNN VQGAN: decodes of the kernel's and plain indices {err:.3e}")
        print(f"[15b] indices: {int((idx_k != idx_p).sum())} of {idx_k.numel()} differ from "
              f"vq_argmin_plain (largest distance gap {gap:.3e}); the decodes of both "
              f"{err:.3e} apart; {len(idx_k.unique())} codes in use")
        fps, peak = fps_and_peak(lambda: model(x), CNN_B * CNN_T, iters=3)
        print(f"[15b] CNN VQGAN round trip B={CNN_B} x {CNN_T}x{CNN_RES}^2 f32: {fps:.2f} "
              f"frames/s, peak {peak:.2f} GiB")
        SLICE_STATS["15b"] = {"batch": CNN_B, "fps": fps, "peak_gib": peak}

        small = init_cnn_vqgan(CnnVQGAN(TokenizerConfig(embedding_dim=16, codebook_dim=16,
                                                        n_codes=128, norm_type="group"),
                                        32, (2, 4, 4)), torch.Generator().manual_seed(1))
        xs = (torch.rand(1, 4, 32, 32, 3, generator=g) - 0.5)
        want_idx, want = small.encode(xs), small.decode(small.encode(xs))
        small.cuda()
        got_idx = small.encode(xs.cuda())
        err = rel_norm(small.decode(want_idx.cuda()), want.cuda())
        if not torch.equal(got_idx.cpu(), want_idx) or not err <= CNN_REL_TOL:
            raise AssertionError(f"small CNN VQGAN card vs CPU: indices "
                                 f"{torch.equal(got_idx.cpu(), want_idx)}, decode {err:.3e}")
        print(f"[15b] small CNN VQGAN (32 wide, 4x32^2) card vs CPU: indices equal, decode "
              f"{err:.3e}")
    del model, x, h, flat
    return {"cnn_vqgan": EXPECTED_LAUNCHES["cnn_vqgan"]}


def _tie_rows(tag, rows, got, want, score64) -> torch.Tensor:
    """Rows whose card index differs from the CPU's: each must be a near-tie
    of f64 scores (relative gap <= VQ_TIE_TOL); returns them."""
    bad = (got.cpu() != want).nonzero().flatten()
    if bad.numel():
        s_got = score64(rows[bad], got.cpu()[bad].long())
        s_want = score64(rows[bad], want[bad].long())
        gap = ((s_got - s_want).abs() / torch.maximum(s_got.abs(), s_want.abs()).clamp_min(1e-12))
        if not float(gap.max()) <= VQ_TIE_TOL:
            raise AssertionError(f"{tag}: an index differs by a relative score gap "
                                 f"{float(gap.max()):.3e}")
    return bad


def _scores(embed64: torch.Tensor, cosine: bool):
    def score(rows, idx):
        e = embed64[idx]
        if cosine:
            return (rows.double() * e).sum(-1)
        return (rows.double() - e).square().sum(-1)
    return score


def _close_except(tag, got, want, skip=None):
    got, want = got.detach().cpu().double(), want.detach().double()
    if skip is not None and skip.numel():
        keep = torch.ones(want.shape[0], dtype=torch.bool)
        keep[skip] = False
        got, want = got[keep], want[keep]
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))
    if not err <= Q_REL_TOL:
        raise AssertionError(f"{tag}: card vs CPU {err:.3e} > {Q_REL_TOL}")
    return err


def hold_kmeans(tag, samples, idx, cosine) -> torch.Tensor:
    """kmeans step by step, each card step against the CPU's from the card's
    previous means; returns the card's means."""
    from omnitokenizer_tpu_torch.ops import quantizers as Q

    cpu = samples.cpu()
    means = samples[idx]
    ties, worst = 0, 0.0
    for _ in range(10):
        m_c, a_c = Q.kmeans_step(samples, means, cosine)
        m_p, a_p = Q.kmeans_step(cpu, means.cpu(), cosine)
        m64 = means.double().cpu()
        m64 = m64 / m64.norm(dim=-1, keepdim=True).clamp_min(1e-12) if cosine else m64
        bad = _tie_rows(tag, cpu, a_c, a_p, _scores(m64, cosine))
        touched = torch.cat([a_c.cpu()[bad], a_p[bad]]).unique()
        worst = max(worst, _close_except(f"{tag} kmeans means", m_c, m_p, touched))
        ties += bad.numel()
        means = m_c
    print(f"[15c] {tag}: kmeans, 10 Lloyd steps each held against the CPU's from the same "
          f"means: {ties} near-tie assignments, means {worst:.2e}")
    return means


def hold_vq_call(tag, vq, z, state, training=True):
    """One VectorQuantize call on the card against the CPU's on the same
    input and state: -> the card's outputs and state."""
    from omnitokenizer_tpu_torch.ops import quantizers as Q

    out_c, st_c = vq(z, state, training=training)
    out_p, st_p = vq(z.cpu(), Q.VQState(*(t.cpu() for t in state)), training=training)
    flat = z.reshape(-1, vq.dim).cpu().double()
    flat = flat / flat.norm(dim=-1, keepdim=True).clamp_min(1e-12) if vq.use_cosine_sim else flat
    e64 = state.embed.cpu().double()
    e64 = e64 / e64.norm(dim=-1, keepdim=True).clamp_min(1e-12) if vq.use_cosine_sim else e64
    bad = _tie_rows(tag, flat, out_c["encodings"].reshape(-1), out_p["encodings"].reshape(-1),
                    _scores(e64, vq.use_cosine_sim))
    touched = torch.cat([out_c["encodings"].reshape(-1).cpu()[bad],
                         out_p["encodings"].reshape(-1)[bad]]).unique().long()
    errs = [_close_except(f"{tag} embeddings", out_c["embeddings"].reshape(-1, vq.dim),
                          out_p["embeddings"].reshape(-1, vq.dim), bad),
            _close_except(f"{tag} loss", out_c["commitment_loss"].reshape(1),
                          out_p["commitment_loss"].reshape(1))]
    for name in ("embed", "cluster_size", "embed_avg"):
        errs.append(_close_except(f"{tag} {name}", getattr(st_c, name), getattr(st_p, name),
                                  touched))
    if int(st_c.initialized) != int(st_p.initialized):
        raise AssertionError(f"{tag}: initialized {int(st_c.initialized)}")
    print(f"[15c] {tag}: {bad.numel()} near-tie indices of {flat.shape[0]} ({touched.numel()} "
          f"codes left out of the state's bar); outputs, loss and state within {max(errs):.2e}")
    return out_c, st_c


def phase15c_quantizers() -> None:
    """The quantizers at working sizes on the card against the CPU."""
    from omnitokenizer_tpu_torch.ops import quantizers as Q

    g = torch.Generator().manual_seed(17)
    z = torch.randn(Q_ROWS, Q_DIM, generator=g).cuda()
    for cosine in (False, True):
        tag = "VQ cosine" if cosine else "VQ euclidean"
        vq = Q.VectorQuantize(Q_DIM, Q_CODES, use_cosine_sim=cosine)
        state = Q.VQState(*(t.cuda() for t in vq.init_state(torch.Generator().manual_seed(18))))
        idx = torch.randint(0, Q_ROWS, (Q_CODES,), generator=torch.Generator().manual_seed(19))
        samples = Q._l2norm(z) if cosine else z
        means = hold_kmeans(tag, samples, idx.cuda(), cosine)
        held, _ = hold_vq_call(f"{tag} training call", vq, z,
                               state._replace(embed=means, initialized=torch.ones_like(
                                   state.initialized)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = vq(z, state, training=True, kmeans_idx=idx)  # the whole path: kmeans inside
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        same = (out["encodings"] == held["encodings"]).float().mean()
        if int(st.initialized) != 1 or float(same) != 1.0 or not bool(
                torch.isfinite(st.embed).all()):
            raise AssertionError(f"{tag}: the kmeans-init call, {float(same):.4f} of its indices "
                                 f"equal the held path's")
        print(f"[15c] {tag}: the first training call (kmeans init + EMA) {ms:.1f} ms on the "
              f"card; its indices equal the held path's (kmeans is deterministic there)")

    res = Q.ResidualVQ(Q_DIM, Q_CODES, Q_DEPTH)
    states = [Q.VQState(*(t.cuda() for t in s))
              for s in res.init_state(torch.Generator().manual_seed(20))]
    idxs = [torch.randint(0, Q_ROWS, (Q_CODES,), generator=torch.Generator().manual_seed(21 + i))
            for i in range(Q_DEPTH)]
    residual, layer_idx = z, []
    for i, (layer, st) in enumerate(zip(res.layers, states)):
        means = hold_kmeans(f"ResidualVQ layer {i}", residual, idxs[i].cuda(), False)
        out, _ = hold_vq_call(f"ResidualVQ layer {i} training call", layer, residual,
                              st._replace(embed=means, initialized=torch.ones_like(st.initialized)))
        residual = residual - out["embeddings"]
        layer_idx.append(out["encodings"])
    out, new_states = res(z, states, training=True, kmeans_idx=idxs)
    same = (out["encodings"] == torch.stack(layer_idx, -1)).float().mean()
    if float(same) != 1.0 or len(new_states) != Q_DEPTH:
        raise AssertionError(f"ResidualVQ: {float(same):.4f} of its indices equal the held path's")
    print(f"[15c] ResidualVQ x{Q_DEPTH}: its indices equal the layers' held one by one")

    zf = (torch.randn(Q_ROWS, len(Q_FSQ_LEVELS), generator=g) * 2).cuda()
    zl = (torch.randn(Q_ROWS, Q_LFQ_DIM, generator=g) * 0.05).cuda()
    for tag, fn, x in (("FSQ", Q.FSQ(Q_FSQ_LEVELS), zf),
                       ("ResidualFSQ", Q.ResidualFSQ(Q_FSQ_LEVELS, Q_DEPTH), zf),
                       ("LFQ", lambda t: Q.LFQ(Q_LFQ_DIM)(t, training=True), zl),
                       ("ResidualLFQ", lambda t: Q.ResidualLFQ(Q_LFQ_DIM, Q_DEPTH)(
                           t, training=True), zl)):
        got, want = fn(x), fn(x.cpu())
        if not torch.equal(got["encodings"].cpu(), want["encodings"]):
            raise AssertionError(f"{tag}: indices differ, card vs CPU")
        errs = [_close_except(f"{tag} embeddings", got["embeddings"], want["embeddings"]),
                abs(float(got["commitment_loss"]) - float(want["commitment_loss"]))
                / max(abs(float(want["commitment_loss"])), 1e-12)]
        if not errs[1] <= Q_REL_TOL:
            raise AssertionError(f"{tag}: loss card vs CPU {errs[1]:.3e}")
        print(f"[15c] {tag} on {tuple(x.shape)}: indices equal, card vs CPU {max(errs):.2e}")


def phase15_last_pieces(smi: str) -> dict:
    """(a) stage 3, (b) the CNN VQGAN, (c) the quantizers; returns the launches."""
    t0 = time.perf_counter()
    paths = phase15a_stage3(smi)
    t1 = time.perf_counter()
    paths.update(phase15b_cnn())
    t2 = time.perf_counter()
    phase15c_quantizers()
    t3 = time.perf_counter()
    print(f"[15] phase 15 in {t3 - t0:.1f} s (15a {t1 - t0:.1f}, 15b {t2 - t1:.1f}, "
          f"15c {t3 - t2:.1f})")
    return paths


# -- phase 16: parallelism -----------------------------------------------------------------
# 16a runs in one child process (a world of one over NCCL), 16b in two: over NCCL
# one card a rank on a host of two cards or more, else both on the one card over
# gloo (NCCL refuses two ranks on one device; parallel/mesh.py picks the backend),
# so that no process group outlives its phase; each child writes its readings as JSON.
PAR_LM_LAYERS = 4          # the TP / PP LM: 4 of the flagship's 24 layers, widths kept
PAR_VOCAB = 8192 + 1000 + 1
PAR_RANKS = 2


def _gan_trainer(group, cfg=None):
    """Phase 8's trainer (bench.py's train_gan losses and schedule) over `group`."""
    from omnitokenizer_tpu_torch import imagenet_k600_config
    from omnitokenizer_tpu_torch.config import LossConfig, TrainConfig
    from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer

    cfg = cfg or imagenet_k600_config().replace(dtype=BF)
    return TokenizerTrainer(
        cfg, LossConfig(perceptual_weight=1.0, image_gan_weight=1.0, video_gan_weight=1.0,
                        gan_feat_weight=4.0, discriminator_iter_start=0),
        TrainConfig(lr=1e-4, warmup_steps=10, max_steps=1000, warmup_lr_init=1e-5,
                    ema_advances_per_step=2), device="cuda", group=group)


def _gan_video() -> torch.Tensor:
    return (torch.randn(B, T, RES, RES, 3, generator=torch.Generator().manual_seed(5))
            * 0.2).cuda()


def _gan_step(group, video, rows=None) -> dict:
    """A fresh flagship state (seed 0), one train_step on `rows` of `video`:
    its metrics, codebook buffers, parameters, ms and launches."""
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.parallel import mesh

    trainer = _gan_trainer(group)
    state = trainer.init_state(seed=0)
    x = mesh.rank_rows(video, group) if rows is None else rows
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, x)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3, "launches": launch_counts(),
           "metrics": {k: float(v) for k, v in m.items()},
           "codebook": {k: v.clone() for k, v in state.net.codebook.state_dict().items()},
           "params": [p.detach().clone() for p in state.g_params() + state.d_params()]}
    del state, trainer
    torch.cuda.empty_cache()
    return out


def _standin_tokenizer():
    import types

    return types.SimpleNamespace(device=torch.device("cuda"))


def _lm_setup(model_parallel=1, stages=1):
    """Phase 12's LM at PAR_LM_LAYERS layers (random weights, seed 0) and
    optimizer, laid out over the world's ranks (model_parallel = stages = 1:
    this process alone, touching no group)."""
    from omnitokenizer_tpu_torch.training import lm_loop

    gpt = lm_model(PAR_VOCAB, LM_BLOCK, seed=0, layers=PAR_LM_LAYERS)
    n2n = lm_n2n(gpt, _standin_tokenizer())
    opt = lm_optimizer(gpt)
    par = (lm_loop.setup_parallel(n2n, opt, model_parallel, stages, microbatches=2)
           if max(model_parallel, stages) > 1 else lm_loop.LMParallel())
    return n2n, opt, par, lm_loop.init_lm_state(n2n, opt)


def _lm_batch():
    g = torch.Generator("cuda").manual_seed(11)
    hw = RES // 8  # a 256^2 image's 32 x 32 codes: the sequence fills block 1025
    z = torch.randint(0, 8192, (LM_TRAIN_B, hw * hw), generator=g, device="cuda")
    return z, torch.randint(0, 1000, (LM_TRAIN_B,), generator=g, device="cuda")


def _lm_step(model_parallel=1, stages=1) -> dict:
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.training import lm_loop

    n2n, opt, par, state = _lm_setup(model_parallel, stages)
    z, labels = _lm_batch()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    m = lm_loop.lm_train_step(n2n, opt, state, z, labels, par=par)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3, "launches": launch_counts(),
           "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "heads": n2n.gpt.n_local_heads, "blocks": len(n2n.gpt.blocks)}
    del n2n, opt, par, state
    torch.cuda.empty_cache()
    return out


def child16a(out_path: str) -> None:
    """A world of one over NCCL: the flagship GAN step through the
    data-parallel trainer bit-equal to the step with no group; the codebook
    step twice bit-equal, its sums' ms against index_add_; the class-CFG
    decode of transformer_eval's path under the group on CUDA graphs against
    the greedy CFG sampler."""
    import torch.distributed as dist

    from omnitokenizer_tpu_torch.models.gpt import make_cfg_sampler
    from omnitokenizer_tpu_torch.ops.codebook import Codebook, code_sums
    from omnitokenizer_tpu_torch.ops.kernels.vq_argmin import vq_argmin
    from omnitokenizer_tpu_torch.parallel import mesh

    # the discriminators' and LPIPS's cuDNN convolutions, deterministic for the bit-equal check
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    group = mesh.init_distributed("cuda", world_of_one=True)
    mesh.all_reduce_(torch.zeros(1, device="cuda"), group)  # NCCL's communicator, before timing
    res = {"backend": dist.get_backend(group), "world": mesh.world()}
    video = _gan_video()
    with_group = _gan_step(group, video)
    without = _gan_step(None, video)
    again = _gan_step(group, video)["ms"]  # in turns: group, none, group
    res["gan"] = {
        "ms_group": [with_group["ms"], again], "ms_none": without["ms"],
        "launches": with_group["launches"],
        "metrics_equal": with_group["metrics"] == without["metrics"],
        "metrics": with_group["metrics"],
        "metric_diffs": {k: with_group["metrics"][k] - without["metrics"][k]
                         for k in without["metrics"]},
        "codebook_equal": all(torch.equal(with_group["codebook"][k], without["codebook"][k])
                              for k in without["codebook"]),
        "params_equal": sum(torch.equal(a, b) for a, b in zip(with_group["params"],
                                                                 without["params"])),
        "params": len(without["params"])}
    del with_group, without

    # the codebook's EMA step at the flagship's rows, twice from one state
    g = torch.Generator("cuda").manual_seed(3)
    z = torch.randn(B, 5, 32, 32, 8, generator=g, device="cuda")
    codes = torch.randn(8192, 8, generator=g, device="cuda")

    def codebook_step():
        cb = Codebook(8192, 8).cuda()
        with torch.no_grad():
            cb.embeddings.copy_(codes)
            cb.z_avg.copy_(codes)
            cb.initialized.fill_(1)
        cb(z, training=True, generator=torch.Generator("cuda").manual_seed(4))
        return cb.state_dict()

    a, b = codebook_step(), codebook_step()
    flat = z.reshape(-1, 8)
    idx = vq_argmin(flat, codes).long()

    def index_add():
        return torch.zeros(8192, 8, device="cuda").index_add_(0, idx, flat)

    def segment_sum():  # another deterministic form: a stable sort, then a segment sum
        order = torch.argsort(idx, stable=True)
        return torch.segment_reduce(flat[order], "sum", axis=0, unsafe=True,
                                    lengths=torch.bincount(idx, minlength=8192))

    res["codebook"] = {
        "buffers_equal": all(torch.equal(a[k], b[k]) for k in a),
        "segment_ms": cuda_ms(segment_sum),
        "sums_repeats_equal": bool(torch.equal(code_sums(idx, flat, 8192),
                                               code_sums(idx, flat, 8192))),
        "segment_equals_code_sums": bool(torch.equal(segment_sum(), code_sums(idx, flat, 8192))),
        "rows": flat.shape[0],
        "code_sums_ms": cuda_ms(lambda: code_sums(idx, flat, 8192)),
        "index_add_ms": cuda_ms(index_add),
        "index_add_repeats_equal": bool(torch.equal(index_add(), index_add())),
        "sums_max_abs_vs_index_add": float((code_sums(idx, flat, 8192) - index_add()).abs().max())}

    # transformer_eval's class split and class-CFG sampler (its --model_parallel 1 path: a
    # data row of one rank, CUDA graphs) against the greedy CFG sampler, no group
    from omnitokenizer_tpu_torch.config import Net2NetConfig
    from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer

    gpt = lm_model(PAR_VOCAB, LM_BLOCK, seed=0, layers=LM_GEN_LAYERS)
    grid = mesh.grid(1)
    classes = torch.arange(1000)[grid.data_rank::grid.data_size][:LM_B].cuda()
    steps = LM_GREEDY_STEPS
    ref = make_cfg_sampler(gpt.cfg, steps, cfg_ratio=1.5, class_first=True, scale_cfg=True,
                           greedy=True, bucket=256)(gpt, classes[:, None], None)
    n2n = Net2NetTransformer(Net2NetConfig(gpt=gpt.cfg, class_cond_dim=1000, starts_with_sos=True,
                                           class_first=True, first_stage_vocab_size=8192),
                             _standin_tokenizer(), gpt=gpt)
    sample = n2n.make_class_conditional_sampler(steps, top_k=1, cfg_ratio=1.5, use_cfg=True,
                                                scale_cfg=True, bucket=256, cuda_graphs=True)
    got = sample(classes, torch.Generator("cuda").manual_seed(1234 + grid.data_rank))
    want = torch.clamp(ref - n2n.z_offset, 0, 8191)
    res["decode"] = {"tokens_equal": bool(torch.equal(got, want)), "steps": steps,
                     "batch": len(classes), "graphs": sample.fn.cuda_graphs,
                     "first_differing_step": int((got != want).any(0).nonzero()[0])
                     if not torch.equal(got, want) else None}
    mesh.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


def _tp_decode(grid) -> dict:
    """transformer_eval's --model_parallel path at PAR_RANKS: the f32 LM at
    PAR_LM_LAYERS layers, the greedy class-CFG decode of this data row's
    classes sharded over `grid.inner` (CUDA graphs where the backend is NCCL:
    gloo's collectives cannot be captured), against the eager sharded decode
    and the greedy CFG sampler on the whole model in this process."""
    from omnitokenizer_tpu_torch.config import Net2NetConfig
    from omnitokenizer_tpu_torch.models.gpt import make_cfg_sampler
    from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer
    from omnitokenizer_tpu_torch.parallel import tp

    gpt = lm_model(PAR_VOCAB, LM_BLOCK, seed=0, layers=PAR_LM_LAYERS, dtype=torch.float32)
    classes = torch.arange(1000)[grid.data_rank::grid.data_size][:LM_B].cuda()
    steps = LM_GREEDY_STEPS
    ref = make_cfg_sampler(gpt.cfg, steps, cfg_ratio=1.5, class_first=True, scale_cfg=True,
                           greedy=True, bucket=256)(gpt, classes[:, None], None)
    n2n = Net2NetTransformer(Net2NetConfig(gpt=gpt.cfg, class_cond_dim=1000, starts_with_sos=True,
                                           class_first=True, first_stage_vocab_size=8192),
                             _standin_tokenizer(), gpt=gpt)
    want = torch.clamp(ref - n2n.z_offset, 0, 8191)
    tp.shard_gpt(n2n.gpt, grid.inner)
    graphs = torch.distributed.get_backend(grid.inner) != "gloo"
    toks, ms = {}, {}
    for g in sorted({graphs, False}, reverse=True):
        sample = n2n.make_class_conditional_sampler(steps, top_k=1, cfg_ratio=1.5, use_cfg=True,
                                                    scale_cfg=True, bucket=256, cuda_graphs=g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks[g] = sample(classes, torch.Generator("cuda").manual_seed(1234 + grid.data_rank))
        torch.cuda.synchronize()
        ms[g] = (time.perf_counter() - t0) * 1e3
    got = toks[graphs]
    return {"graphs": graphs, "heads": n2n.gpt.n_local_heads, "batch": len(classes),
            "steps": steps, "ms": ms[graphs], "eager_ms": ms[False],
            "graphs_equal_eager": bool(torch.equal(got, toks[False])),
            "tokens_equal": bool(torch.equal(got, want)),
            "first_differing_step": int((got != want).any(0).nonzero()[0])
            if not torch.equal(got, want) else None}


def child16b(out_path: str) -> None:
    """One of two ranks (over NCCL one card a rank, or both on one card over
    gloo): TP=2 and PP=2 LM steps, the TP=2 decode, the sharded-table argmin,
    the DP=2 GAN step; rank 0 then runs the one-process steps they are held
    to."""
    from omnitokenizer_tpu_torch.ops.codebook import vq_argmin_sharded
    from omnitokenizer_tpu_torch.ops.kernels import vq_argmin as vq
    from omnitokenizer_tpu_torch.parallel import mesh

    group = mesh.init_distributed("cuda")
    rank = mesh.rank()
    res = {"rank": rank, "world": mesh.world(), "backend": torch.distributed.get_backend(group),
           "card": torch.cuda.current_device()}
    res["tp"] = _lm_step(model_parallel=PAR_RANKS)
    res["pp"] = _lm_step(stages=PAR_RANKS)
    res["decode"] = _tp_decode(mesh.grid(PAR_RANKS))
    torch.cuda.empty_cache()

    # the flagship's 20480 x 8 rows against 8192 codes in two slabs, a tie planted across them
    g = torch.Generator("cuda").manual_seed(9)
    flat = torch.randn(B * 5 * 32 * 32, 8, generator=g, device="cuda")
    emb = torch.randn(8192, 8, generator=g, device="cuda")
    emb[4096 + 100] = emb[100]
    flat[:64] = emb[100]
    k = emb.shape[0] // PAR_RANKS
    slab = emb[rank * k:(rank + 1) * k].contiguous()
    got = vq_argmin_sharded(flat, slab, group)
    plain, kern = vq.vq_argmin_plain(flat, emb), vq.vq_argmin(flat, emb)
    near = kern != got
    res["vq"] = {"rows": flat.shape[0], "equal_plain": bool(torch.equal(got, plain)),
                 "tie_rows_ok": bool((got[:64] == 100).all() and (kern[:64] == 100).all()),
                 "kernel_differs": int(near.sum()),
                 "ms": cuda_ms(lambda: vq_argmin_sharded(flat, slab, group), iters=5,
                               queued=False),
                 "kernel_ms": cuda_ms(lambda: vq.vq_argmin(flat, emb))}
    if near.any():
        zz, e64 = flat[near].double(), emb.double()
        d_k = (zz - e64[kern[near].long()]).square().sum(-1)
        d_s = (zz - e64[got[near].long()]).square().sum(-1)
        res["vq"]["kernel_rel_gap"] = float(((d_k - d_s).abs() / d_s.clamp_min(1e-12)).max())

    video = _gan_video()
    dp = _gan_step(group, video)
    res["dp"] = {k: dp[k] for k in ("ms", "launches", "metrics")}
    del dp
    torch.cuda.empty_cache()
    mesh.barrier()
    if rank == 0:  # the one-process steps, the other rank's memory given back
        res["one_lm"] = _lm_step()
        one = _gan_step(None, video)
        res["one_gan"] = {k: one[k] for k in ("ms", "launches", "metrics")}
    mesh.barrier()
    mesh.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


LAUNCH_VARS = ("OMNITOK_COORD", "OMNITOK_NPROCS", "OMNITOK_PROC_ID", "OMNITOK_NO_DIST",
               "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


def _children(role: str, n: int, env: dict, timeout: float = 900.0) -> list:
    """Run `n` chip_smoke.py --child ROLE processes (rank r of n: OMNITOK_PROC_ID
    r) in this environment less any launcher's variables, plus `env`; their
    JSON results."""
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    outs, procs = [], []
    with tempfile.TemporaryDirectory() as d:
        for r in range(n):
            out = os.path.join(d, f"{role}{r}.json")
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", role, "--out", out],
                env=dict(base, **env, **({"OMNITOK_PROC_ID": str(r)} if n > 1 else {}))))
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise AssertionError(f"child {role}: exit codes {rcs}")
        results = []
        for out in outs:
            with open(out) as f:
                results.append(json.load(f))
    return results


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 0.1)


def phase16_parallel(smi: str) -> dict:
    """(a) a world of one over NCCL, (b) two ranks (over NCCL on two cards, or
    over gloo on one); returns the launches of a rank's DP GAN step and TP / PP
    LM steps."""
    from omnitokenizer_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    (a,) = _children("16a", 1, {})
    print(f"[16a] in {time.perf_counter() - t0:.1f} s")
    gan, cb, dec = a["gan"], a["codebook"], a["decode"]
    print(f"[16a] {a['backend']} world of {a['world']}: flagship GAN step (B={B}, {T}x{RES}^2, "
          f"bf16) with the group {gan['ms_group'][0]:.2f} / {gan['ms_group'][1]:.2f} ms, "
          f"without {gan['ms_none']:.2f} ms (in turns); "
          f"metrics bit-equal {gan['metrics_equal']}, codebook buffers bit-equal "
          f"{gan['codebook_equal']}, parameters bit-equal {gan['params_equal']} of "
          f"{gan['params']}; launches {gan['launches']} ({smi})")
    print(f"[16a] codebook step at {cb['rows']} x 8 rows, 8192 codes: two runs bit-equal "
          f"{cb['buffers_equal']}; code_sums {cb['code_sums_ms']:.4f} ms (two runs bit-equal "
          f"{cb['sums_repeats_equal']}, equal to a stable-sort segment sum "
          f"{cb['segment_equals_code_sums']}, {cb['segment_ms']:.4f} ms) against index_add_ "
          f"{cb['index_add_ms']:.4f} ms (two runs bit-equal {cb['index_add_repeats_equal']}, "
          f"max |diff| {cb['sums_max_abs_vs_index_add']:.3e})")
    print(f"[16a] class-CFG decode under the group (CUDA graphs {dec['graphs']}, B={dec['batch']},"
          f" {dec['steps']} steps, top_k 1) vs the greedy CFG sampler: tokens equal "
          f"{dec['tokens_equal']}")
    if not (a["backend"] == "nccl" and gan["metrics_equal"] and gan["codebook_equal"]):
        raise AssertionError(f"16a: the world of one is not the step with no group: "
                             f"{gan['metric_diffs']}")
    if not (cb["buffers_equal"] and cb["sums_repeats_equal"]):
        raise AssertionError("16a: two codebook steps hold different buffers")
    if not dec["tokens_equal"]:
        raise AssertionError(f"16a: decode tokens differ from step {dec['first_differing_step']}")

    port = mesh.free_port()
    ranks = _children("16b", PAR_RANKS, {"OMNITOK_COORD": f"localhost:{port}",
                                         "OMNITOK_NPROCS": str(PAR_RANKS)})
    r0 = ranks[0]
    one_lm, one_gan = r0["one_lm"], r0["one_gan"]
    backend = r0["backend"]
    shared = len({r["card"] for r in ranks}) == 1
    print(f"[16b] {PAR_RANKS} ranks over {backend} on card(s) {[r['card'] for r in ranks]}")
    fails = []
    if backend != ("gloo" if shared else "nccl"):
        fails.append(f"backend {backend} for ranks on cards {[r['card'] for r in ranks]}")
    # a TP rank runs every layer once; a stage runs its layers once a microbatch (2)
    for kind, want_blocks, calls in (("tp", PAR_LM_LAYERS, PAR_LM_LAYERS),
                                     ("pp", PAR_LM_LAYERS // PAR_RANKS, PAR_LM_LAYERS)):
        for r in ranks:
            s = r[kind]
            f_fwd, f_bwd = s["launches"]["flash_attn_fwd"], s["launches"]["flash_attn_bwd"]
            print(f"[16b] {kind.upper()}={PAR_RANKS} LM step rank {r['rank']} ({s['blocks']} "
                  f"layers x {s['heads']} heads of 96, B={LM_TRAIN_B}, block {LM_BLOCK}, bf16): "
                  f"{s['ms']:.2f} ms, loss {s['loss']:.6f}, grad norm {s['grad_norm']:.6f}; "
                  f"flash launches {f_fwd}/{f_bwd}")
            if s["blocks"] != want_blocks or f_fwd != calls or f_bwd != calls:
                fails.append(f"{kind} rank {r['rank']}: flash launches {f_fwd}/{f_bwd}")
            if _rel(s["loss"], one_lm["loss"]) > LM_TRAIN_LOSS_REL_TOL:
                fails.append(f"{kind} loss {s['loss']} vs {one_lm['loss']}")
            if _rel(s["grad_norm"], one_lm["grad_norm"]) > LM_TRAIN_GRAD_NORM_REL_TOL:
                fails.append(f"{kind} grad norm {s['grad_norm']} vs {one_lm['grad_norm']}")
    print(f"[16b] one-process LM step ({PAR_LM_LAYERS} layers x 16 heads): {one_lm['ms']:.2f} ms, "
          f"loss {one_lm['loss']:.6f}, grad norm {one_lm['grad_norm']:.6f}")
    for r in ranks:
        d = r["decode"]
        print(f"[16b] TP={PAR_RANKS} class-CFG decode rank {r['rank']} (f32, {PAR_LM_LAYERS} layers"
              f" x {d['heads']} heads of 96, B={d['batch']}, {d['steps']} steps, top_k 1, CUDA "
              f"graphs {d['graphs']}): {d['ms']:.2f} ms (eager {d['eager_ms']:.2f} ms); tokens "
              f"equal to the eager TP decode {d['graphs_equal_eager']}, to the one-process greedy "
              f"CFG sampler {d['tokens_equal']}")
        if d["graphs"] != (backend == "nccl") or not d["graphs_equal_eager"]:
            fails.append(f"tp decode rank {r['rank']}: graphs {d['graphs']}, equal to eager "
                         f"{d['graphs_equal_eager']}")
        if not d["tokens_equal"]:
            fails.append(f"tp decode rank {r['rank']}: tokens differ from step "
                         f"{d['first_differing_step']}")
    for r in ranks:
        v = r["vq"]
        print(f"[16b] vq_argmin_sharded rank {r['rank']}: {v['rows']} rows x 8192 codes in "
              f"{PAR_RANKS} slabs, {v['ms']:.4f} ms (the kernel, unsharded: "
              f"{v['kernel_ms']:.4f} ms); equal to the plain search {v['equal_plain']}, planted "
              f"ties {v['tie_rows_ok']}, {v['kernel_differs']} rows apart from the kernel "
              f"(near-ties, rel gap {v.get('kernel_rel_gap', 0.0):.3e})")
        if not (v["equal_plain"] and v["tie_rows_ok"]
                and v.get("kernel_rel_gap", 0.0) <= VQ_TIE_TOL):
            fails.append(f"vq_argmin_sharded rank {r['rank']}: {v}")
    for r in ranks:
        d = r["dp"]
        print(f"[16b] DP={PAR_RANKS} GAN step rank {r['rank']} (B={B // PAR_RANKS} a rank, "
              f"BatchNorm over both): {d['ms']:.2f} ms, launches {d['launches']}")
        if d["launches"] != EXPECTED_LAUNCHES["train"]:
            fails.append(f"dp rank {r['rank']} launches {d['launches']}")
        for k, v in one_gan["metrics"].items():
            tol = TRAIN_GRAD_NORM_REL_TOL if k.startswith("grad_norm") else TRAIN_LOSS_REL_TOL
            if _rel(d["metrics"][k], v) > tol:
                fails.append(f"dp {k} {d['metrics'][k]} vs {v}")
    worst = max(_rel(ranks[0]["dp"]["metrics"][k], v) for k, v in one_gan["metrics"].items())
    note = ("Two ranks share one card: their times show no speed-up" if shared
            else "One card a rank")
    print(f"[16b] one-process GAN step (B={B}): {one_gan['ms']:.2f} ms; DP metrics' largest "
          f"relative gap {worst:.3e}. {note} ({smi})")
    if fails:
        raise AssertionError("16b: " + "; ".join(fails))
    print(f"[16] phase 16 in {time.perf_counter() - t0:.1f} s")
    return {"dp_train": ranks[0]["dp"]["launches"], "tp_lm_train": ranks[0]["tp"]["launches"],
            "pp_lm_train": ranks[0]["pp"]["launches"]}


# -- phase 17: the host pieces ----------------------------------------------------------------
# (a) the special dataset families at the flagship's input size; (b) text-conditioned LM
# training through transformer_train on CoinRun captions, at train_ucf.sh's widths
FAMILY_CLIPS = 32
FAMILY_VIDEOS, FAMILY_FRAMES = 8, 24   # videos a file, frames a video (a 17-frame window each)
TEXT_LM_B, TEXT_LEN, TEXT_LM_LAYERS = 4, 256, 6  # train_ucf.sh's batch; 6 of its 24 layers
TEXT_LM_BLOCK = 1 + TEXT_LEN + 5 * 32 * 32       # sos + the caption + the codes: 5377
TEXT_LM_VOCAB = 8192 + 49408 + 1                 # codes + CLIP's vocabulary + sos
TEXT_LM_WARMUP, TEXT_LM_TIMED = 2, 2  # 2 timed steps: phase 17 aims at 45 s
TEXT_LM_COMPARE_LAYERS = 2                       # the kernel-vs-plain check's depth
CAPTION_WORDS = ("mugen runs to the right left and jumps climbs a ladder collects coin coins "
                 "is in power up mode kills monster gets killed stays place")
# the encode of 4 clips (the encoder's 2 spatial 't' blocks, 4 temporal blocks at n = 5,
# the codebook's search), then one flash forward and one backward in each of the 6 layers
TEXT_LM_LAUNCHES = {**EXPECTED_LAUNCHES["lm_train"], "flash_attn_fwd": TEXT_LM_LAYERS,
                    "flash_attn_bwd": TEXT_LM_LAYERS}


def write_merge_table(path: str) -> str:
    """A CLIP-format BPE merge table over the caption words: each word's
    symbols merged left to right, in the order the words come."""
    merges = []
    for word in CAPTION_WORDS.split():
        syms = list(word[:-1]) + [word[-1] + "</w>"]
        while len(syms) > 1:
            if (syms[0], syms[1]) not in merges:
                merges.append((syms[0], syms[1]))
            syms = [syms[0] + syms[1]] + syms[2:]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return path


def coinrun_trace(seed: int, frames: int) -> dict:
    """A CoinRun game trace (game.py's asdict format) from a seed: a maze of
    every tile kind, an agent that runs, jumps, climbs, eats coins and dies
    at the end, three monsters, one dying."""
    import numpy as np

    rng = np.random.RandomState(seed)
    maze = [list("." * 64) for _ in range(13)]
    maze[0], maze[1] = list("A" * 64), list("S" * 64)
    for x in range(2, 64, 3):
        maze[2 + rng.randint(0, 6)][x] = "S1a2b#$&%^|="[rng.randint(0, 12)]
    coins = [[x, y] for y in range(13) for x in range(64) if maze[y][x] in "12"]
    trace = []
    for i in range(frames):
        trace.append({
            "agent": {"x": 4.0 + 0.5 * i, "y": 2.0 + (i % 4 == 1), "vx": 0.5,
                      "vy": 0.3 * (i % 4 == 1), "time_alive": i, "ladder": i % 7 == 3,
                      "is_killed": i >= frames - 2, "killed_animation_frame_cnt": i % 3},
            "coins_eaten": coins[:i // 4],
            "monsters": [{"m_id": m, "x": 10.0 + 3 * m - 0.2 * i, "y": 2.0, "vx": -0.2,
                          "theme": m, "time": i, "is_dead": m == 0 and i > frames // 2,
                          "monster_dying_frame_cnt": 1} for m in range(3)]})
    return {"zoom": 5.5, "bgzoom": 0.4, "world_theme_n": seed % 2, "agent_theme_n": 0,
            "background_themes": ["backgrounds/a.png", "backgrounds/b.png"],
            "ground_themes": ["Grass", "Planet"], "agent_themes": ["Beige"],
            "monster_names": {"ground": ["slimeBlock"], "walking": ["snail"], "flying": ["bee"]},
            "maze_w": 64, "maze_h": 13, "maze": ["".join(r) for r in maze], "frames": trace}


def write_coinrun_dir(root: str, games: int, frames: int) -> None:
    """Game JSONs under root and their sprites under root/assets: a random
    RGBA PNG at every path data/coinrun.py's asset_paths names (tiles 70^2,
    the alien 128 x 256, monsters 64^2, backgrounds 512^2, as kenney's)."""
    import numpy as np
    from PIL import Image

    from omnitokenizer_tpu_torch.data.coinrun import Game, asset_paths

    rng = np.random.RandomState(171)
    os.makedirs(root, exist_ok=True)
    rels = {}
    for i in range(games):
        trace = coinrun_trace(i, frames)
        with open(os.path.join(root, f"level{i:03d}.json"), "w") as f:
            json.dump(trace, f)
        paths = asset_paths(Game(**trace))
        rels[paths["background"]] = (512, 512)
        rels.update({r: (70, 70) for r in paths["world"].values()})
        rels.update({r: (256, 128) for r in paths["alien"].values()})
        rels.update({r.replace(".png", s + ".png"): (64, 64) for r in paths["monster"].values()
                     for s in ("", "_move", "_dead")})
    for rel, hw in rels.items():
        p = os.path.join(root, "assets", rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        rgba = rng.randint(0, 256, hw + (4,)).astype(np.uint8)
        rgba[..., 3] = np.where(rng.rand(*hw) < 0.4, 0, 255)
        Image.fromarray(rgba, "RGBA").save(p)


def write_families(root: str) -> dict:
    """Each family's files at the flagship's input size, FAMILY_VIDEOS videos
    of FAMILY_FRAMES frames of 256^2 (vtokens: code grids of 32^2); the
    VideoData flags of each."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(170)
    n = FAMILY_VIDEOS * FAMILY_FRAMES
    idx = np.arange(FAMILY_VIDEOS + 1) * FAMILY_FRAMES
    out = {}
    if has_h5py():
        import h5py

        def h5(name, data, **extra):
            path = os.path.join(root, name)
            with h5py.File(path, "w") as f:
                f["train_data"], f["train_idx"] = data, idx
                for k, v in extra.items():
                    f.create_dataset(k, data=v, dtype=h5py.string_dtype())
            return path

        clips = rng.randint(0, 256, (n, RES, RES, 3)).astype(np.uint8)
        caps = [f"clip {i} of a dog walking on grass" for i in range(FAMILY_VIDEOS)]
        out["hdf5"] = dict(data_path=[h5("clips.h5", clips)])
        out["text"] = dict(data_path=[h5("text.h5", clips, train_text=caps)], text_cond=True)
        out["smap"] = dict(data_path=[out["hdf5"]["data_path"][0]], smap_cond=1,
                           data_path2=h5("smap.h5", rng.randint(0, 20, (n, RES, RES))
                                         .astype(np.uint8)))
        out["vtokens"] = dict(data_path=[h5("vtokens.h5", rng.randint(0, 8192, (n, 32, 32)))],
                              vtokens=True, resolution=32, spatial_length=32, sequence_length=5)
    frames = os.path.join(root, "frames")
    for v in range(FAMILY_VIDEOS):
        os.makedirs(os.path.join(frames, f"v{v}"))
        for t in range(T):
            Image.fromarray(rng.randint(0, 256, (RES, RES, 3), np.uint8)).save(
                os.path.join(frames, f"v{v}", f"{t:03d}.png"))
    out["frames"] = dict(data_path=[frames], image_folder=True)
    stft = os.path.join(root, "stft")
    os.makedirs(stft)
    for v in range(FAMILY_VIDEOS):
        np.savez(os.path.join(stft, f"v{v}.npz"), stft=rng.randn(FAMILY_FRAMES, 128)
                 .astype(np.float32), video=rng.randint(0, 256, (FAMILY_FRAMES, RES, RES, 3))
                 .astype(np.uint8))
    out["stft"] = dict(data_path=[stft], stft_data=True)
    write_coinrun_dir(os.path.join(root, "coinrun"), FAMILY_VIDEOS, FAMILY_FRAMES)
    out["coinrun"] = dict(data_path=[os.path.join(root, "coinrun")], text_cond=True)
    return out


def phase17a_families() -> dict:
    """32 clips of each family through VideoData (B=4, 4 decode threads),
    timed from the loader's construction to the 8th batch."""
    import argparse

    import numpy as np

    from omnitokenizer_tpu_torch.data import loader, text_tokenizer

    rows = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        families = write_families(root)
        vocab_dir = text_tokenizer.VOCAB_DIR
        text_tokenizer.VOCAB_DIR = os.path.dirname(
            write_merge_table(os.path.join(root, "vocab", text_tokenizer.VOCAB_NAME)))
        print(f"[17a] wrote the families' files in {time.perf_counter() - t0:.1f} s")
        if not has_h5py():
            print("[17a] h5py is not importable on this host: the HDF5 families (clips, "
                  "captions, smap, vtokens) did not run here")
        try:
            for name, flags in families.items():
                args = argparse.Namespace(**{
                    "train_datalist": ["none"], "val_datalist": ["none"], "batch_size": [B],
                    "resolution": RES, "sequence_length": T, "num_workers": 4, **flags})
                assert loader.special_family(args) is not None, name
                t1 = time.perf_counter()
                it = iter(loader.VideoData(args, train=True))
                batches = [next(it) for _ in range(FAMILY_CLIPS // B)]
                ms = (time.perf_counter() - t1) * 1e3
                it.close()
                video = np.stack([b["video"] for b in batches])
                want = ((B, 5, 32, 32) if name == "vtokens" else (B, T, RES, RES, 3))
                if video.shape[1:] != want or not np.isfinite(video).all():
                    raise AssertionError(f"{name}: clips {video.shape[1:]} != {want}")
                if name != "vtokens" and not (-0.5 <= video.min() and video.max() <= 0.5):
                    raise AssertionError(f"{name}: pixels outside [-0.5, 0.5]")
                extra = {k: tuple(batches[0][k].shape) for k in ("text", "stft", "smap", "cbox")
                         if k in batches[0]}
                rows[name] = {"ms_32_clips": ms, "ms_a_clip": ms / FAMILY_CLIPS, **extra}
                print(f"[17a] {name}: {FAMILY_CLIPS} clips {tuple(video.shape[2:])} in "
                      f"{ms:.1f} ms ({ms / FAMILY_CLIPS:.2f} ms a clip) {extra}")
        finally:
            text_tokenizer.VOCAB_DIR = vocab_dir
    return rows


def phase17b_text_lm() -> dict:
    """transformer_train.main on the card over a CoinRun directory with
    auto-captions: the launches a step, the caption column, finite losses
    and gradient norms, ms a step; then the first step at 2 of the layers,
    kernel route against plain route."""
    import types

    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, imagenet_k600_config
    from omnitokenizer_tpu_torch.cli import transformer_train
    from omnitokenizer_tpu_torch.config import GPTConfig, Net2NetConfig
    from omnitokenizer_tpu_torch.data import text_tokenizer
    from omnitokenizer_tpu_torch.models.gpt import GPT
    from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.training import lm_loop
    from omnitokenizer_tpu_torch.utils.checkpoint import save_tokenizer_checkpoint

    steps = TEXT_LM_WARMUP + TEXT_LM_TIMED
    marks, first, losses, norms = [], {}, [], []
    real_encode, real_step = lm_loop.encode_batch, lm_loop.lm_train_step

    def encode(n2n, batch):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append([ev])
        first.setdefault("batch", batch)
        return real_encode(n2n, batch)

    def step(n2n, opt, state, z_ids, labels, **kw):
        if "z" not in first:  # the first step's batch, sequence and weights (2 layers)
            inputs, _, _ = n2n.loss_inputs(z_ids, labels)
            first.update(z=z_ids.clone(), text=labels.clone(), inputs=inputs[:, :1 + TEXT_LEN]
                         .clone(), cfg=n2n.cfg, sd={
                k: v.detach().clone() for k, v in n2n.gpt.state_dict().items()
                if not k.startswith("blocks.") or int(k.split(".")[1]) < TEXT_LM_COMPARE_LAYERS},
                         run=(n2n, opt, state))
        metrics = real_step(n2n, opt, state, z_ids, labels, **kw)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1].append(ev)
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
        return metrics

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    vocab_dir = text_tokenizer.VOCAB_DIR
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "coinrun_train")
        write_coinrun_dir(data, 2 * TEXT_LM_B, T + 3)
        text_tokenizer.VOCAB_DIR = os.path.dirname(
            write_merge_table(os.path.join(root, "vocab", text_tokenizer.VOCAB_NAME)))
        cfg = imagenet_k600_config().replace(dtype=BF)
        tok = OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cuda")
        save_tokenizer_checkpoint(os.path.join(root, "tok.pt"), tok.net, cfg)
        del tok
        argv = ["--vqvae", os.path.join(root, "tok.pt"), "--data_path", data,
                "--train_datalist", "none", "--default_root_dir", os.path.join(root, "run"),
                "--batch_size", str(TEXT_LM_B), "--num_workers", "4", "--resolution", str(RES),
                "--sequence_length", str(T), "--text_cond", "--cond_stage_key", "text",
                "--text_seq_len", str(TEXT_LEN), "--class_cond_dim", "49408",
                "--starts_with_sos", "--block_size", str(TEXT_LM_BLOCK),
                "--n_layer", str(TEXT_LM_LAYERS), "--n_head", str(LM_HEADS),
                "--n_embd", str(LM_WIDTH), "--lr", "1e-3", "--lr_min", "1e-3",
                "--warmup_steps", "1", "--max_steps", str(steps), "--seed", "0", "--bf16",
                "--device", "cuda"]
        print(f"[17b] wrote {2 * TEXT_LM_B} CoinRun traces, their sprites, a merge table and "
              f"the flagship tokenizer in {time.perf_counter() - t0:.1f} s")
        lm_loop.encode_batch, lm_loop.lm_train_step = encode, step
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t1 = time.perf_counter()
            state = transformer_train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = launch_counts()
        finally:
            lm_loop.encode_batch, lm_loop.lm_train_step = real_encode, real_step
            text_tokenizer.VOCAB_DIR = vocab_dir
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gpt_cfg = state.gpt.cfg
        # the same step with no loader running: the first batch again, encode included
        bare = []
        for _ in range(1 + TEXT_LM_TIMED):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            real_step(*first["run"], *real_encode(first["run"][0], first["batch"]))
            ev[1].record()
            bare.append(ev)
        torch.cuda.synchronize()
        bare_ms = [a.elapsed_time(b) for a, b in bare[1:]]
        profile = lm_profile(*first["run"], first["batch"], tag="17b")
        del state, first["run"], first["batch"]
    torch.cuda.empty_cache()
    got = {k: v // steps if v % steps == 0 else v / steps for k, v in counts.items()}
    step_ms = [a.elapsed_time(b) for a, b in marks[TEXT_LM_WARMUP:]]
    losses, norms = [float(x) for x in losses], [float(x) for x in norms]
    ms = sum(step_ms) / len(step_ms)
    tokens = TEXT_LM_B * (TEXT_LM_BLOCK - 1)
    flops = lm_train_flops(gpt_cfg, TEXT_LM_B, TEXT_LM_BLOCK - 1)
    print(f"[17b] transformer_train --cond_stage_key text: {len(marks)} steps in {wall:.1f} s "
          f"(model build, data and checkpoint included); {ms:.2f} ms a step "
          f"({[round(x, 2) for x in step_ms]}, encode included, loader waits not), "
          f"{tokens / ms * 1e3:.0f} tokens/s, {TEXT_LM_B / ms * 1e3:.2f} clips/s, peak "
          f"{peak:.2f} GiB, {100 * flops / PEAK_BF16 * 1e3 / ms:.1f}% of the FLOP bound "
          f"({flops / 1e12:.2f} TFLOP a step); losses {[round(x, 4) for x in losses]}, "
          f"gradient norms {[round(x, 4) for x in norms]}; launches a step {got}")
    bare_mean = sum(bare_ms) / len(bare_ms)
    print(f"[17b] the same step on the first batch with no loader thread running: "
          f"{bare_mean:.2f} ms ({[round(x, 2) for x in bare_ms]}), "
          f"{tokens / bare_mean * 1e3:.0f} tokens/s, "
          f"{100 * flops / PEAK_BF16 * 1e3 / bare_mean:.1f}% of the FLOP bound; the CLI's "
          f"steps {ms / bare_mean:.2f}x that while its loader renders")
    if len(marks) != steps or got != TEXT_LM_LAUNCHES or gpt_cfg.vocab_size != TEXT_LM_VOCAB:
        raise AssertionError(f"steps {len(marks)}, launches a step {got} != {TEXT_LM_LAUNCHES}, "
                             f"vocabulary {gpt_cfg.vocab_size}")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"losses {losses}, gradient norms {norms}")

    # the caption column: sos, then the caption ids shifted past sos
    text, inputs = first["text"], first["inputs"]
    if tuple(first["z"].shape) != (TEXT_LM_B, 5 * 32 * 32) or tuple(text.shape) != (
            TEXT_LM_B, TEXT_LEN) or not torch.equal(inputs[:, 1:], text + 1) \
            or bool((inputs[:, 0] != 0).any()):
        raise AssertionError(f"sequence: codes {tuple(first['z'].shape)}, text "
                             f"{tuple(text.shape)}, column equal "
                             f"{torch.equal(inputs[:, 1:], text + 1)}")
    with tempfile.TemporaryDirectory() as root:
        vocab = text_tokenizer.SimpleTokenizer(write_merge_table(os.path.join(root, "v.txt")))
    sot, eot = vocab.encoder["<|startoftext|>"], vocab.encoder["<|endoftext|>"]
    caption = vocab.decode([t for t in text[0].tolist() if t not in (0, sot, eot)])
    if not (bool((text[:, 0] == sot).all()) and caption.startswith("mugen")):
        raise AssertionError(f"captions: first ids {text[:, 0].tolist()}, {caption!r}")
    print(f"[17b] the caption column sits after sos: ids {text.shape[1]} wide, "
          f"{int((text != 0).sum(1).max())} used at most; first caption {caption!r}")

    # the first step at 2 of the layers: kernel route against plain route
    cfg2 = gpt_cfg.replace(n_layer=TEXT_LM_COMPARE_LAYERS)
    gpt = GPT(cfg2).cuda()
    gpt.load_state_dict(first["sd"])
    n2n = Net2NetTransformer(first["cfg"].replace(gpt=cfg2),
                             types.SimpleNamespace(device=torch.device("cuda")), gpt=gpt)
    one = {}
    for name, flash in (("kernel", True), ("plain", False)):
        lm_route(gpt, flash)
        reset_launch_counts()
        loss, _ = n2n.loss_fn(first["z"], first["text"])
        grads = torch.autograd.grad(loss, list(gpt.parameters()))
        one[name] = (float(loss.detach()), lm_grad_norms(gpt, grads), launch_counts())
        del loss, grads
        torch.cuda.empty_cache()
    if (one["kernel"][2]["flash_attn_fwd"], one["kernel"][2]["flash_attn_bwd"]) != (
            TEXT_LM_COMPARE_LAYERS,) * 2 or any(one["plain"][2].values()):
        raise AssertionError(f"routes' launches: {one['kernel'][2]}, {one['plain'][2]}")
    loss_err = abs(one["kernel"][0] - one["plain"][0]) / abs(one["plain"][0])
    norm_err = {k: abs(v - one["plain"][1][k]) / one["plain"][1][k]
                for k, v in one["kernel"][1].items()}
    worst = max(norm_err, key=norm_err.get)
    print(f"[17b] the first step at {TEXT_LM_COMPARE_LAYERS} layers, kernel vs plain route: "
          f"loss {one['kernel'][0]:.6f} vs {one['plain'][0]:.6f} (rel {loss_err:.3e}, bar "
          f"{LM_TRAIN_LOSS_REL_TOL}); gradient norms rel: global {norm_err['global']:.3e}, "
          f"worst {worst} {norm_err[worst]:.3e} (bar {LM_TRAIN_GRAD_NORM_REL_TOL})")
    if not (loss_err <= LM_TRAIN_LOSS_REL_TOL
            and max(norm_err.values()) <= LM_TRAIN_GRAD_NORM_REL_TOL):
        raise AssertionError(f"kernel vs plain route: loss {loss_err:.3e}, norms {norm_err}")
    del gpt, n2n, first
    torch.cuda.empty_cache()
    row = {"step_ms": ms, "step_ms_each": step_ms, "tokens_per_s": tokens / ms * 1e3,
           "clips_per_s": TEXT_LM_B / ms * 1e3, "peak_gib": peak, "flops_per_step": flops,
           "bound_ms": flops / PEAK_BF16 * 1e3, "flop_bound_share": flops / PEAK_BF16 * 1e3 / ms,
           "launches_per_step": got, "losses": losses, "grad_norms": norms,
           "bare_step_ms": bare_mean, "bare_step_ms_each": bare_ms, "profile_ms": profile,
           "one_step": {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err},
           "wall_s": wall}
    print(json.dumps({"text_lm_train": row}))
    return got


def phase17_host_pieces() -> dict:
    t0 = time.perf_counter()
    families = phase17a_families()
    print(json.dumps({"families": families}))
    got = phase17b_text_lm()
    print(f"[17] phase 17 in {time.perf_counter() - t0:.1f} s")
    return {"text_lm_train": got}


# -- phase 18: sequence parallelism of the tokenizer ---------------------------------------------
# Two ranks in child processes, as in phase 16b: over NCCL one card a rank where the host has
# two cards or more, else both on the one card over gloo (collectives staged through the
# host). Each rank holds 128 of the 256 pixel rows (16 of the 32 token rows) of every frame.
SP_RANKS = 2
# indices may differ from the one process's only at near-ties of the SP run's own latents:
# the one process's pre-VQ latents differ from the SP run's by its cuBLAS calls' other row
# blockings (bf16 roundings), so a near-tie is a relative distance gap of at most this
SP_TIE_REL_TOL = 1e-3


def _sp_round_trip(net, x, sp, annotate=False) -> tuple:
    """encode_latent -> quantize (VQ) or the posterior's mode (VAE) ->
    decode_latent under `sp`; (recon, indices or None, pre-VQ latents)."""
    from omnitokenizer_tpu_torch.ops.gaussian import DiagonalGaussian
    from omnitokenizer_tpu_torch.utils.profiling import annotate as rng

    ctx = rng if annotate else (lambda name: contextlib.nullcontext())
    with ctx("encode"):
        h = net.encode_latent(x, False, sp=sp)
    if net.cfg.use_vae:
        z, idx = DiagonalGaussian.from_params(h).mode(), None
    else:
        with ctx("quantize"):
            vq = net.quantize(h, sp=sp)
        z, idx = vq["embeddings"], vq["encodings"]
    with ctx("decode"):
        return net.decode_latent(z, False, sp=sp), idx, h


def _sp_case(model, video, grid, sp, trace_dir=None, profiled=True, flat=False,
             iters=5) -> dict:
    """One model's SP round trip on this rank's rows: launches, frames/s and
    peak; rank 0 then holds the gathered result to the one-process round
    trip of the whole clips (pixels whole-tensor, indices with near-ties
    counted) and times it; with `profiled`, one more SP round trip on every
    rank, traced where trace_dir is given; with `flat`, whether the decode
    of this rank's flat indices equals its grid decode bit for bit."""
    from omnitokenizer_tpu_torch.ops.attention import l2norm
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.parallel import mesh, tp
    from omnitokenizer_tpu_torch.utils import profiling, trace_analysis

    net = model.net
    xl = video.permute(0, 2, 3, 4, 1)
    rows = tp.sp_shard_pixels(xl, grid.inner).contiguous()
    frames = video.shape[0] * video.shape[2]
    out = {}
    with torch.inference_mode():
        _sp_round_trip(net, rows, sp)  # warm-up: the collectives' first use
        torch.cuda.synchronize()
        mesh.barrier()
        reset_launch_counts()
        recon, idx, h = _sp_round_trip(net, rows, sp)
        torch.cuda.synchronize()
        out["launches"] = launch_counts()
        out["finite"] = bool(torch.isfinite(recon).all())
        out["shape"] = list(recon.shape)
        whole = tp.sp_gather(recon, grid.inner, 2)
        whole_idx = None if idx is None else tp.sp_gather(idx, grid.inner, 2)
        whole_h = tp.sp_gather(h, grid.inner, 2)
        mesh.barrier()
        if flat:
            grid_px = net.decode(idx, False, sp=sp)
            out["flat_equal"] = bool(torch.equal(
                net.decode(idx.reshape(idx.shape[0], -1), False, sp=sp), grid_px))
            del grid_px
        mesh.barrier()
        fps, peak = fps_and_peak(lambda: _sp_round_trip(net, rows, sp), frames, iters)
        out.update(fps=fps, peak_gib=peak)
        mesh.barrier()  # every rank runs the round trip (its collectives); one traces it
        with profiling.trace(trace_dir) if trace_dir else contextlib.nullcontext():
            if profiled:
                t0 = time.perf_counter()
                _sp_round_trip(net, rows, sp, annotate=True)
                torch.cuda.synchronize()
                out["traced_ms"] = (time.perf_counter() - t0) * 1e3
        if trace_dir:
            events = trace_analysis.load_trace_events(trace_dir)
            out["op_table"] = trace_analysis.op_table(events)[:12]
            out["source_table"] = trace_analysis.source_table(events)
            # host time in SP's collectives, the "sp.gather" / "sp.halo" / "sp.rows" ranges
            # (parallel/mesh.py) with their staging copies under gloo, and in the
            # c10d ops alone (the wire under gloo, the enqueue under NCCL)
            def host_ms(pred):
                return sum(e["dur"] for e in events if e.get("ph") == "X" and pred(e)) / 1e3

            out["sp_collective_host_ms"] = host_ms(
                lambda e: e.get("cat") == "user_annotation" and e["name"] in (
                    "sp.gather", "sp.halo", "sp.rows"))
            out["collective_host_ms"] = host_ms(
                lambda e: e.get("cat") == "cpu_op" and e["name"].startswith("c10d::"))
        mesh.barrier()
        if mesh.rank() != 0:
            return out
        reset_launch_counts()
        want, want_idx, want_h = _sp_round_trip(net, xl, None)
        torch.cuda.synchronize()
        out["one_launches"] = launch_counts()
        out["pixels_rel_err"] = rel_norm(whole, want)
        out["latents_rel_err"] = rel_norm(whole_h, want_h)
        if idx is not None:
            bad = (whole_idx != want_idx).flatten().nonzero().flatten()
            out["indices"] = int(want_idx.numel())
            out["indices_differ"] = int(bad.numel())
            if bad.numel():
                emb = net.codebook.embeddings.double()
                z = whole_h.flatten(0, -2)[bad].double()
                z = l2norm(z) if net.cfg.l2_code else z
                d_sp = (z - emb[whole_idx.flatten()[bad].long()]).square().sum(-1)
                d_one = (z - emb[want_idx.flatten()[bad].long()]).square().sum(-1)
                out["tie_rel_gap"] = float(((d_one - d_sp).abs() / d_sp.clamp_min(1e-12)).max())
        one_fps, one_peak = fps_and_peak(lambda: _sp_round_trip(net, xl, None), frames, iters)
        out.update(one_fps=one_fps, one_peak_gib=one_peak)
    return out


# phase 18b: phase 14's five variants (bf16, every tensor random, BatchNorm's statistics off 0
# and 1) and the flagship at 320^2 under SP, at the flagship's width; phase 14's launches a
# rank. At 320^2 the 40 token rows give 20 a rank, so the encoder's windows of 8 rows 16-23
# straddle the two ranks; the flagship also decodes its flat indices.
SP_RES_320 = 320
SP_VARIANTS = {**VARIANTS, "flagship_320": (dict(resolution=SP_RES_320), "imagenet_k600", B,
                                            EXPECTED_LAUNCHES["vq"])}
SP_VARIANT_ITERS = 3  # timed round trips of each, SP and one process


def _child18b(grid, sp) -> dict:
    """Each 18b case's SP round trip on this rank (see _sp_case)."""
    from omnitokenizer_tpu_torch import imagenet_k600_config, imagenet_only_config

    bases = {"imagenet_k600": imagenet_k600_config, "imagenet_only": imagenet_only_config}
    out = {}
    for name, (kw, base, batch, _) in SP_VARIANTS.items():
        t0 = time.perf_counter()
        cfg = bases[base]().replace(dtype=BF, **kw)
        model = filled_tokenizer(cfg).serving()
        g = torch.Generator().manual_seed(1)
        video = (torch.rand(batch, 3, T, cfg.resolution, cfg.resolution, generator=g) * 2
                 - 1).to("cuda")
        out[name] = _sp_case(model, video, grid, sp, profiled=False,
                             flat=name == "flagship_320", iters=SP_VARIANT_ITERS)
        out[name]["seconds"] = time.perf_counter() - t0
        del model, video
        torch.cuda.empty_cache()
    return out


# phase 18c: ragged rows (the row partition, parallel/tp.py). ragged_264: the flagship's widths
# with a spatial 'tttt' encoder (its 'w' blocks would need token rows that windows of 8 divide)
# at 17 x 264^2, B=4, over the 2 ranks of phase 18: 33 token rows split 17 / 16, so a rank's
# 132 pixel rows are 16.5 patches; bf16 and the f32 VAE. ragged_16: the flagship itself at
# 17 x 320^2, B=1, over 16 ranks (one card: gloo; 16 cards: NCCL): 40 token rows split 3 x 8
# and 2 x 8, a rank's 20 pixel rows 2.5 patches, and windows of 8 rows span up to 4 ranks.
SP_RAGGED_RES, SP_RAGGED_16_RES, SP_RAGGED_16_RANKS = 264, 320, 16
SP_RAGGED_LAUNCHES = {  # one round trip: the 8 spatial and 8 temporal 't' blocks
    "ragged_264": {**_NONE, "geglu_ff": 16, "ln_qkv": 16, "cosine_mha": 8,
                   "small_n_attention": 8, "vq_argmin": 1},
    "ragged_264_vae": {**_NONE, "mha": 8},
    "ragged_16": EXPECTED_LAUNCHES["vq"],
}


def _child18c(grid, sp) -> dict:
    """ragged_264's SP round trips on this rank, bf16 (its flat indices'
    decode too) and the f32 VAE (see _sp_case)."""
    from omnitokenizer_tpu_torch import imagenet_k600_config

    out = {}
    ragged = dict(resolution=SP_RAGGED_RES, enc_block="tttt")
    g = torch.Generator().manual_seed(2)
    video = (torch.rand(B, 3, T, SP_RAGGED_RES, SP_RAGGED_RES, generator=g) * 2 - 1).to("cuda")
    for name, cfg in (("ragged_264", imagenet_k600_config().replace(dtype=BF, **ragged)),
                      ("ragged_264_vae", imagenet_k600_config(use_vae=True).replace(**ragged))):
        t0 = time.perf_counter()
        model = filled_tokenizer(cfg)
        model = model.serving() if cfg.dtype == BF else model
        out[name] = _sp_case(model, video, grid, sp, profiled=False,
                             flat=name == "ragged_264", iters=SP_VARIANT_ITERS)
        out[name]["seconds"] = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()
    return out


def child18c(out_path: str) -> None:
    """One of 16 ranks: ragged_16's SP round trip (see _sp_case)."""
    from omnitokenizer_tpu_torch import imagenet_k600_config
    from omnitokenizer_tpu_torch.parallel import mesh, tp

    t0 = time.perf_counter()
    group = mesh.init_distributed("cuda")
    grid = mesh.grid(SP_RAGGED_16_RANKS)
    sp = tp.seq_parallel(grid.inner)
    res = {"rank": mesh.rank(), "card": torch.cuda.current_device(),
           "backend": torch.distributed.get_backend(group)}
    cfg = imagenet_k600_config().replace(dtype=BF, resolution=SP_RAGGED_16_RES)
    model = filled_tokenizer(cfg).serving()
    g = torch.Generator().manual_seed(3)
    video = (torch.rand(1, 3, T, SP_RAGGED_16_RES, SP_RAGGED_16_RES, generator=g) * 2
             - 1).to("cuda")
    res["ragged_16"] = _sp_case(model, video, grid, sp, profiled=False, iters=1)
    res["ragged_16"]["seconds"] = time.perf_counter() - t0
    mesh.barrier()
    mesh.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


def child18(out_path: str) -> None:
    """One of two ranks: the bf16 flagship and the f32 VAE round trips with
    the pixel rows over the model group, against one process on rank 0; the
    dry run's SP forward; one profiled round trip."""
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, imagenet_k600_config
    from omnitokenizer_tpu_torch.parallel import dryrun, mesh, tp

    assert not torch.backends.cuda.matmul.allow_tf32
    group = mesh.init_distributed("cuda")
    grid = mesh.grid(SP_RANKS)
    sp = tp.seq_parallel(grid.inner)
    res = {"rank": mesh.rank(), "world": mesh.world(), "card": torch.cuda.current_device(),
           "backend": torch.distributed.get_backend(group), "sp_size": sp.size}
    g = torch.Generator().manual_seed(1)
    video = (torch.rand(B, 3, T, RES, RES, generator=g) * 2 - 1).to("cuda")
    trace_dir = tempfile.mkdtemp(prefix="sp_trace_")
    try:
        model = OmniTokenizerVQGAN.from_config(imagenet_k600_config().replace(dtype=BF), seed=0,
                                               device="cuda").serving()
        res["vq"] = _sp_case(model, video, grid, sp,
                             trace_dir=trace_dir if mesh.rank() == 0 else None)
        del model
        torch.cuda.empty_cache()
        model = OmniTokenizerVQGAN.from_config(imagenet_k600_config(use_vae=True), seed=0,
                                               device="cuda")
        res["vae"] = _sp_case(model, video, grid, sp)
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    # the JAX dry run's SP forward: its small config, random weights, f32 on the card
    import numpy as np

    from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet, init_weights
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    net = OmniTokenizerNet(dryrun._config()[0])
    init_weights(net, torch.Generator().manual_seed(0))
    batch = torch.from_numpy(np.random.RandomState(0).randn(
        2 * mesh.world(), 5, 32, 32, 3).astype(np.float32) * 0.2)
    reset_launch_counts()
    res["dryrun"] = dryrun.sp_forward(net.cuda(), batch.cuda())
    res["dryrun"]["mha"] = launch_counts()["mha"]
    mesh.barrier()
    t0 = time.perf_counter()
    res["b"] = _child18b(grid, sp)
    res["b_seconds"] = time.perf_counter() - t0
    mesh.barrier()
    t0 = time.perf_counter()
    res["c"] = _child18c(grid, sp)
    res["c_seconds"] = time.perf_counter() - t0
    mesh.barrier()
    mesh.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


def phase18_sp(smi: str) -> dict:
    """Two ranks of sequence parallelism; returns a rank's launches in the
    bf16 flagship's and the f32 VAE's SP round trips."""
    from omnitokenizer_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    ranks = _children("18", SP_RANKS, {"OMNITOK_COORD": f"localhost:{mesh.free_port()}",
                                       "OMNITOK_NPROCS": str(SP_RANKS)})
    r0 = ranks[0]
    backend, shared = r0["backend"], len({r["card"] for r in ranks}) == 1
    print(f"[18] {SP_RANKS} ranks over {backend} on card(s) {[r['card'] for r in ranks]}, "
          f"a model group of {r0['sp_size']}: {RES // SP_RANKS} of {RES} pixel rows a rank")
    fails = []
    if backend != ("gloo" if shared else "nccl"):
        fails.append(f"backend {backend} for ranks on cards {[r['card'] for r in ranks]}")
    for name, want, tol in (("vq", EXPECTED_LAUNCHES["vq"], DECODE_REL_TOL),
                            ("vae", EXPECTED_LAUNCHES["vae"], VAE_REL_TOL)):
        for r in ranks:
            c = r[name]
            print(f"[18] {name} SP round trip rank {r['rank']} (B={B}, {T}x{RES}^2, rows "
                  f"{c['shape'][2]}): launches {c['launches']}; {c['fps']:.2f} frames/s, peak "
                  f"{c['peak_gib']:.2f} GiB ({backend}; {smi})")
            if c["launches"] != want:
                fails.append(f"{name} rank {r['rank']} launches {c['launches']} != {want}")
            if not c["finite"] or c["shape"][2] != RES // SP_RANKS:
                fails.append(f"{name} rank {r['rank']}: reconstruction {c['shape']}, finite "
                             f"{c['finite']}")
        c = r0[name]
        ties = ""
        if "indices" in c:
            ties = (f"; indices differ at {c['indices_differ']} of {c['indices']} "
                    f"(largest relative gap {c.get('tie_rel_gap', 0.0):.3e})")
            if c.get("tie_rel_gap", 0.0) > SP_TIE_REL_TOL:
                fails.append(f"{name}: an index differs by a relative gap {c['tie_rel_gap']:.3e}")
        print(f"[18] {name} SP vs one process: pixels rel err {c['pixels_rel_err']:.3e} (bar "
              f"{tol}), pre-VQ latents {c['latents_rel_err']:.3e}{ties}; one process "
              f"{c['one_fps']:.2f} frames/s, peak {c['one_peak_gib']:.2f} GiB")
        if not c["pixels_rel_err"] <= tol:
            fails.append(f"{name}: pixels rel err {c['pixels_rel_err']:.3e} > {tol}")
    vq = r0["vq"]
    print(f"[18] one SP round trip (rank 0) profiled: {vq['traced_ms']:.2f} ms on the host "
          f"clock, {vq['sp_collective_host_ms']:.2f} ms of it in SP's collectives (sp.gather, "
          f"sp.halo, sp.rows; {vq['collective_host_ms']:.2f} ms in their c10d ops)")
    for row in vq["op_table"]:
        print(f"[18]   {row['ms']:8.3f} ms x{row['count']:<5} {row['name'][:70]:70} "
              f"{row['source']}")
    for row in vq["source_table"]:
        print(f"[18]   {row['ms']:8.3f} ms x{row['count']:<5} launched in {row['source']}")
    for r in ranks:
        d = r["dryrun"]
        print(f"[18] the dry run's SP forward rank {r['rank']}: recon rel err vs one process "
              f"{d['sp_recon_rel_err']:.3e}, commitment {d['sp_commitment_loss']:.6f}, mha "
              f"launches {d['mha']}")
        if d["mha"] == 0:
            fails.append(f"dry run rank {r['rank']}: no mha launch")
    fails += _report18b(ranks, smi, backend)
    t_c = time.perf_counter()
    ranks16 = _children("18c", SP_RAGGED_16_RANKS, {
        "OMNITOK_COORD": f"localhost:{mesh.free_port()}",
        "OMNITOK_NPROCS": str(SP_RAGGED_16_RANKS)}, timeout=600)
    cases = {name: [r["c"][name] for r in ranks] for name in ranks[0]["c"]}
    cases["ragged_16"] = [r["ragged_16"] for r in ranks16]
    fails += _report18c(cases, smi, {"ragged_264": backend, "ragged_264_vae": backend,
                                     "ragged_16": ranks16[0]["backend"]})
    print(f"[18c] ragged_264 in {r0['c_seconds']:.1f} s on the 2 ranks (rank 0); ragged_16's "
          f"16 ranks in {time.perf_counter() - t_c:.1f} s, started to stopped")
    if fails:
        raise AssertionError("18: " + "; ".join(fails))
    print(f"[18] phase 18 in {time.perf_counter() - t0:.1f} s")
    return {"sp": r0["vq"]["launches"], "sp_vae": r0["vae"]["launches"],
            **{f"sp_{name}": r0["b"][name]["launches"] for name in SP_VARIANTS},
            **{f"sp_{name}": per_rank[0]["launches"] for name, per_rank in cases.items()}}


def _report18b(ranks: list, smi: str, backend: str) -> list:
    """18b's lines and the failures of its bars: a rank's launches against
    phase 14's, pixels against one process under DECODE_REL_TOL, indices
    with near-ties counted, the flagship's flat decode bit-equal."""
    fails = []
    r0 = ranks[0]
    for name, (kw, base, batch, want) in SP_VARIANTS.items():
        res = kw.get("resolution", RES)
        for r in ranks:
            c = r["b"][name]
            print(f"[18b] {name} ({base} {kw}, bf16) SP round trip rank {r['rank']} (B={batch}, "
                  f"{T}x{res}^2, pixel rows {c['shape'][2]}): launches {c['launches']}; "
                  f"{c['fps']:.2f} frames/s, peak {c['peak_gib']:.2f} GiB ({backend}; {smi})")
            if c["launches"] != want:
                fails.append(f"18b {name} rank {r['rank']} launches {c['launches']} != {want}")
            if not c["finite"] or c["shape"][2] != res // SP_RANKS:
                fails.append(f"18b {name} rank {r['rank']}: reconstruction {c['shape']}, "
                             f"finite {c['finite']}")
            if "flat_equal" in c and not c["flat_equal"]:
                fails.append(f"18b {name} rank {r['rank']}: the flat indices' decode differs "
                             "from the grid's")
        c = r0["b"][name]
        flat = ("; flat decode bit-equal to the grid's on every rank"
                if "flat_equal" in c else "")
        print(f"[18b] {name} SP vs one process: pixels rel err {c['pixels_rel_err']:.3e} (bar "
              f"{DECODE_REL_TOL}), pre-VQ latents {c['latents_rel_err']:.3e}; indices differ at "
              f"{c['indices_differ']} of {c['indices']} (largest relative gap "
              f"{c.get('tie_rel_gap', 0.0):.3e}, bar {SP_TIE_REL_TOL}){flat}; one process "
              f"{c['one_fps']:.2f} frames/s, peak {c['one_peak_gib']:.2f} GiB; "
              f"{c['seconds']:.1f} s")
        if not c["pixels_rel_err"] <= DECODE_REL_TOL:
            fails.append(f"18b {name}: pixels rel err {c['pixels_rel_err']:.3e} > "
                         f"{DECODE_REL_TOL}")
        if c.get("tie_rel_gap", 0.0) > SP_TIE_REL_TOL:
            fails.append(f"18b {name}: an index differs by a relative gap "
                         f"{c['tie_rel_gap']:.3e}")
    print(f"[18b] the six cases in {r0['b_seconds']:.1f} s (rank 0)")
    return fails


def _report18c(cases: dict, smi: str, backends: dict) -> list:
    """18c's lines and the failures of its bars: each rank's launches
    against one process's (counted on rank 0) and against the count above,
    pixels against one process (DECODE_REL_TOL; the f32 VAE VAE_REL_TOL),
    indices with near-ties counted (SP_TIE_REL_TOL), ragged_264's flat
    decode bit-equal to its grid decode on every rank."""
    fails = []
    for name, per_rank in cases.items():
        c0, want = per_rank[0], SP_RAGGED_LAUNCHES[name]
        tol = VAE_REL_TOL if name.endswith("_vae") else DECODE_REL_TOL
        if c0["one_launches"] != want:
            fails.append(f"18c {name}: one process's launches {c0['one_launches']} != {want}")
        for r, c in enumerate(per_rank):
            print(f"[18c] {name} SP round trip rank {r} (pixel rows {c['shape'][2]}): launches "
                  f"{c['launches']}; {c['fps']:.2f} frames/s, peak {c['peak_gib']:.2f} GiB "
                  f"({backends[name]}; {smi})")
            if c["launches"] != c0["one_launches"]:
                fails.append(f"18c {name} rank {r} launches {c['launches']} != one process's "
                             f"{c0['one_launches']}")
            if not c["finite"]:
                fails.append(f"18c {name} rank {r}: a reconstruction value is not finite")
            if "flat_equal" in c and not c["flat_equal"]:
                fails.append(f"18c {name} rank {r}: the flat indices' decode differs from "
                             "the grid's")
        ties = ""
        if "indices" in c0:
            ties = (f"; indices differ at {c0['indices_differ']} of {c0['indices']} (largest "
                    f"relative gap {c0.get('tie_rel_gap', 0.0):.3e}, bar {SP_TIE_REL_TOL})")
            if c0.get("tie_rel_gap", 0.0) > SP_TIE_REL_TOL:
                fails.append(f"18c {name}: an index differs by a relative gap "
                             f"{c0['tie_rel_gap']:.3e}")
        flat = ("; flat decode bit-equal to the grid's on every rank"
                if "flat_equal" in c0 else "")
        print(f"[18c] {name} SP vs one process: pixels rel err {c0['pixels_rel_err']:.3e} (bar "
              f"{tol}), pre-VQ latents {c0['latents_rel_err']:.3e}{ties}{flat}; one process "
              f"{c0['one_fps']:.2f} frames/s, peak {c0['one_peak_gib']:.2f} GiB, launches "
              f"{c0['one_launches']}; {c0['seconds']:.1f} s")
        if not c0["pixels_rel_err"] <= tol:
            fails.append(f"18c {name}: pixels rel err {c0['pixels_rel_err']:.3e} > {tol}")
    return fails


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="drive the port's paths on one GPU")
    parser.add_argument("--phases", type=lambda v: {int(x) for x in v.split(",")}, default=None,
                        help="comma-separated phases after 0 and 1 (the card, the build) to "
                             "run, for a short run; all of them by default")
    parser.add_argument("--child", choices=["16a", "16b", "18", "18c"], default=None,
                        help="run as one of phase 16's or 18's child processes (set by them)")
    parser.add_argument("--out", default=None, help="a child's JSON result file")
    parsed = parser.parse_args(argv)
    run = parsed.phases
    if parsed.child:
        {"16a": child16a, "16b": child16b, "18": child18,
         "18c": child18c}[parsed.child](parsed.out)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = phase0_card()
    phase1_build()
    phases = [(2, phase2_kernels), (3, lambda: {"vq": phase3_slice()}), (4, phase4_small_f32),
              (5, lambda: {"vae": phase5_vae()}), (6, lambda: {"rel": phase6_rel()}),
              (7, lambda: {"wide": phase7_wide()}), (8, lambda: {"train": phase8_train(smi)}),
              (9, phase9_eval), (10, phase10_lm), (11, phase11_diffusion),
              (12, phase12_lm_train), (13, phase13_checkpoints), (14, phase14_variants_t2v),
              (15, lambda: phase15_last_pieces(smi)), (16, lambda: phase16_parallel(smi)),
              (17, phase17_host_pieces), (18, lambda: phase18_sp(smi))]
    paths = {}
    for n, phase in phases:
        if run is None or n in run:
            t_phase = time.perf_counter()
            paths.update(phase() or {})
            print(f"[{n}] phase {n} took {time.perf_counter() - t_phase:.1f} s")
    # a row per kernel and path shape; `launches` is that path's round trip
    # (a step for "train"), and null for a shape no path runs (cosine_mha's
    # and vq_argmin's ragged rows); then a row per training route,
    # `launches` its calls a step
    kernels = []
    for row in ROWS:
        src, rep = SOURCES[row["name"]]
        by_path = {path: counts[row["name"]] for path, counts in paths.items()}
        kernels.append({"name": row["name"], "route": "cuda", "source": src, "replaces": rep,
                        "launches": by_path.get(row["path"]), "launches_by_path": by_path,
                        **row})
    src, rep = "omnitokenizer_tpu_torch/ops/kernel_grad.py", "omnitokenizer_tpu/ops/kernel_grad.py:49"
    kernels += [{"route": "cuda", "source": src, "replaces": rep, **row} for row in TRAIN_ROWS]
    done = "0-18" if run is None else ",".join(map(str, [0, 1] + sorted(run)))
    print(f"[done] phases {done} in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
