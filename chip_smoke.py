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
     for vq_argmin;
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
     route) that this comparison must fail.
The line before the last is a JSON object with a row per kernel and shape
(and one per training route); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

B, T, RES = 4, 17, 256  # the flagship serve shape
KERNELS = ("vq_argmin", "ln_qkv", "geglu_ff", "small_n_attention", "cosine_mha", "mha")
# launches in one video round trip of each path
EXPECTED_LAUNCHES = {
    "vq": {"geglu_ff": 16, "ln_qkv": 14, "cosine_mha": 6, "small_n_attention": 8,
           "vq_argmin": 1, "mha": 0},
    # f32: every spatial 't' block's attention (encoder 'ttww' 2, decoder 'tttt' 4);
    # the temporal blocks (N=5) are below mha's N >= 8 and take the plain math
    "vae": {**{k: 0 for k in KERNELS}, "mha": 6},
    # bf16, 9 latent frames: too many for small_n_attention (n <= 8) and causal,
    # which cosine_mha refuses, so the 8 temporal blocks take mha
    "rel": {"geglu_ff": 16, "ln_qkv": 14, "cosine_mha": 6, "small_n_attention": 0,
            "vq_argmin": 1, "mha": 8},
    # the flagship at width 768, heads of 128: the flagship's routes
    "wide": {"geglu_ff": 16, "ln_qkv": 14, "cosine_mha": 6, "small_n_attention": 8,
             "vq_argmin": 1, "mha": 0},
    # a flagship training step: the generator's training forward (every 't'
    # block and feed-forward on the training route: ln_qkv 14, geglu_ff 16,
    # cosine_mha 6, small_n 8, the codebook's search 1), then the second
    # codebook advance's encoder on the inference route (ln_qkv 6, geglu_ff
    # 8, cosine_mha 2, small_n 4, vq_argmin 1); training sdpa is plain, the
    # backward recomputes plain math
    "train": {"geglu_ff": 24, "ln_qkv": 20, "cosine_mha": 8, "small_n_attention": 12,
              "vq_argmin": 2, "mha": 0},
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
    return smi


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


def sdpa_inputs(q, kv, heads, dim_head, qs, ks, rope):
    """The attention modules' bf16 route up to SDPA (ops/attention.py:
    _attend): [RoPE], F.normalize * scales -> bf16, as (B, H, N, Dh) views."""
    from omnitokenizer_tpu_torch.ops.rotary import freqs_cis_2d, rotate_pairs

    b, n, _ = q.shape
    qh, k = q.view(b, n, heads, dim_head), kv.view(b, n, 2, heads, dim_head)[:, :, 0]
    if rope:
        cos, sin = freqs_cis_2d(dim_head, n, q.device)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        qh, k = rotate_pairs(qh, cos, sin), rotate_pairs(k, cos, sin)
    qh = (F.normalize(qh.float(), dim=-1) * qs).to(BF)
    k = (F.normalize(k.float(), dim=-1) * ks).to(BF)
    return [t.transpose(1, 2) for t in (qh, k, kv.view(b, n, 2, heads, dim_head)[:, :, 1])]


def attention_chain(q, kv, heads, dim_head, qs, ks, rope, causal=False):
    b, n, _ = q.shape
    out = F.scaled_dot_product_attention(*sdpa_inputs(q, kv, heads, dim_head, qs, ks, rope),
                                         is_causal=causal, scale=8.0)
    return out.transpose(1, 2).reshape(b, n, heads * dim_head)


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

    # mha at both of its paths' shapes: the f32 VAE's spatial blocks, (b t, H,
    # h w, Dh) non-causal, and the stage-1 tokenizer's causal temporal blocks,
    # (b h w, H, 9, Dh) in bf16; q and k are l2-normalized, as the cosine
    # attention hands them over, with its logit scale 8. The bf16 ones are the
    # views that ops/attention.py:_attend hands over: (B, H, N, D) views of
    # (B, N, H, D) memory, v inside the fused kv; the f32 ones the contiguous
    # copies sdpa makes for the flash branch
    def mha_inputs(shape, dtype):
        b, h, n, d = shape
        if dtype == torch.float32:
            q, k = (F.normalize(randn(g, *shape), dim=-1) for _ in range(2))
            return q, k, randn(g, *shape)
        q, k = (F.normalize(randn(g, b, n, h, d), dim=-1).to(dtype).transpose(1, 2)
                for _ in range(2))
        kv = randn(g, b, n, 2 * h * d, dtype=dtype)
        return q, k, kv[..., h * d:].view(b, n, h, d).transpose(1, 2)

    for path, shape, dtype, causal, tol in (
            ("vae", (B * (1 + (T - 1) // 4), H, hw, Dh), torch.float32, False, MHA_F32_REL_TOL),
            ("rel", (B * hw, H, 1 + (T - 1) // 2, Dh), BF, True, KERNEL_REL_TOL)):
        q, k, v = mha_inputs(shape, dtype)
        bh, n = shape[0] * shape[1], shape[2]
        err = compare(f"mha {dtype} causal={causal}", mh.mha(q, k, v, 8.0, causal),
                      mh.mha_plain(q, k, v, 8.0, causal), tol)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=8.0)

        if dtype == BF and mh.mha(q, k, v, 8.0, causal).stride() != q.stride():
            raise AssertionError("mha: the output on views does not take q's layout")

        print(f"[2] mha ({path}): library call vs plain max_abs "
              f"{max_abs(library(), mh.mha_plain(q, k, v, 8.0, causal)):.3e}; "
              f"it runs {device_kernels(library)}")
        pairs = n * (n + 1) // 2 if causal else n * n
        flops, nbytes = 4 * bh * pairs * Dh, 4 * bh * n * Dh * q.element_size()
        record("2", "mha", path, [err], lambda: mh.mha(q, k, v, 8.0, causal),
               lambda: mh.mha_plain(q, k, v, 8.0, causal),
               bound(flops, nbytes, PEAK_BF16) if dtype == BF
               else bound(3 * flops, nbytes, PEAK_TF32),  # 3xTF32
               library, shape=list(shape), dtype=str(dtype).split(".")[1], causal=causal)
    mha_f32_floor(mh, g)


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


def bf16_slice(tag: str, cfg, expected: dict, batch: int = B) -> dict:
    """A bf16 VQ round trip at full width through OmniTokenizerVQGAN: launch
    counts, then the slice bars against the plain bf16 path on the same
    weights and against the f32 model, then frames/s of both paths."""
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN
    from omnitokenizer_tpu_torch.ops.attention import l2norm
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.ops.kernels.vq_argmin import vq_argmin_plain

    model = OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cuda").serving()
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

    t, hw = 1 + (T - 1) // cfg.temporal_patch_size, RES // cfg.patch_size
    if tuple(recon.shape) != (batch, 3, T, RES, RES) or not bool(torch.isfinite(recon).all()):
        raise AssertionError(f"bad reconstruction {tuple(recon.shape)}")
    idx = aux["encodings"]
    if tuple(idx.shape) != (batch, t, hw, hw) or int(idx.min()) < 0 or int(idx.max()) >= cfg.n_codes:
        raise AssertionError("bad indices")

    net, emb = model.net, model.net.codebook.embeddings
    xl = video.permute(0, 2, 3, 4, 1)

    def plain_round_trip():
        h = net.encode_latent(xl, False, training=True)
        i = vq_argmin_plain(l2norm(h).reshape(-1, cfg.codebook_dim), emb)
        return net.decode_latent(net.codebook.lookup(i.view(h.shape[:-1])), False,
                                 training=True)

    # the plain bf16 path: training=True calls with the training route's
    # kernels off
    with torch.inference_mode(), train_kernel_ops("0"):
        h_k = net.encode_latent(xl, False)
        h_p = net.encode_latent(xl, False, training=True)
        lat_err = rel_norm(h_k, h_p)
        idx_p = vq_argmin_plain(l2norm(h_p).reshape(-1, cfg.codebook_dim), emb).view(idx.shape)
        agree = float((idx_p == idx).float().mean())
        dec_k = net.decode(idx, False)
        dec_p = net.decode_latent(net.codebook.lookup(idx), False, training=True)
        dec_err = rel_norm(dec_k, dec_p)
        # the same weights before the bf16 cast, f32 throughout
        ref32 = OmniTokenizerVQGAN.from_config(cfg.replace(dtype=torch.float32), seed=0,
                                               device="cuda")
        dec_32 = ref32.net.decode(idx, False)
        floor_k, floor_p = rel_norm(dec_k, dec_32), rel_norm(dec_p, dec_32)
        del ref32, dec_32
        print(f"[{tag}] pre-VQ latents rel err {lat_err:.3e} (max-abs ratio "
              f"{rel_err(h_k, h_p):.3e}); indices agree {agree:.4%}")
        print(f"[{tag}] decode of the same indices: kernel vs plain rel err {dec_err:.3e} "
              f"(max-abs ratio {rel_err(dec_k, dec_p):.3e}); vs f32: kernel {floor_k:.3e}, "
              f"plain {floor_p:.3e}")
        if not lat_err <= LATENT_REL_TOL:
            raise AssertionError(f"pre-VQ latents rel err {lat_err:.3e} > {LATENT_REL_TOL}")
        if not dec_err <= DECODE_REL_TOL:
            raise AssertionError(f"decode rel err {dec_err:.3e} > {DECODE_REL_TOL}")
        if not floor_k <= FLOOR_RATIO * floor_p:
            raise AssertionError(f"kernel path is {floor_k:.3e} from f32, plain {floor_p:.3e}")

        fps_k, mem_k = fps_and_peak(lambda: model.reconstruct(video, is_image=False), batch * T)
        fps_p, mem_p = fps_and_peak(plain_round_trip, batch * T)
    print(f"[{tag}] round trip B={batch} {T}x{RES}^2 bf16: kernel path {fps_k:.2f} frames/s "
          f"(peak {mem_k:.2f} GiB), plain path {fps_p:.2f} frames/s (peak {mem_p:.2f} GiB)")
    return counts


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


def profile_train_step(trainer, state, video) -> dict:
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
    print(f"[8] step by stage ({route}), device ms: " + ", ".join(f"{k} {v:.2f}"
                                                                 for k, v in ms.items())
          + f"; device busy {ms['busy'] / ms['step']:.1%} of the step (profiled step)")
    for e in kernels[:10]:
        print(f"[8]   {self_dev(e):8.2f} ms {e.count:5d}x {e.key[:110]}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = phase0_card()
    phase1_build()
    phase2_kernels()
    paths = {"vq": phase3_slice()}
    phase4_small_f32()
    paths["vae"] = phase5_vae()
    paths["rel"] = phase6_rel()
    paths["wide"] = phase7_wide()
    paths["train"] = phase8_train(smi)
    # a row per kernel and path shape; `launches` is that path's round trip
    # (a step for "train"), and null for a shape no path runs (cosine_mha's
    # ragged row); then a row per training route, `launches` its calls a step
    kernels = []
    for row in ROWS:
        src, rep = SOURCES[row["name"]]
        by_path = {path: counts[row["name"]] for path, counts in paths.items()}
        kernels.append({"name": row["name"], "route": "cuda", "source": src, "replaces": rep,
                        "launches": by_path.get(row["path"]), "launches_by_path": by_path,
                        **row})
    src, rep = "omnitokenizer_tpu_torch/ops/kernel_grad.py", "omnitokenizer_tpu/ops/kernel_grad.py:49"
    kernels += [{"route": "cuda", "source": src, "replaces": rep, **row} for row in TRAIN_ROWS]
    print(f"[done] phases 0-8 in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
