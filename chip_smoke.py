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
     phase 2, and vq_argmin against its plain version at a code dim of 6.
The line before the last is a JSON object with a row per kernel and shape;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
}
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
# route (ops/attention.py: Attention and FeedForward with training=True):
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

    with torch.inference_mode():
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
    # a row per kernel and path shape; `launches` is that path's round trip,
    # and null for a shape no path runs (cosine_mha's ragged row)
    kernels = []
    for row in ROWS:
        src, rep = SOURCES[row["name"]]
        by_path = {path: counts[row["name"]] for path, counts in paths.items()}
        kernels.append({"name": row["name"], "route": "cuda", "source": src, "replaces": rep,
                        "launches": by_path.get(row["path"]), "launches_by_path": by_path,
                        **row})
    print(f"[done] phases 0-7 in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
