#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  0. the card: nvidia-smi name and power limit, versions, TF32 off;
  1. build every CUDA kernel from omnitokenizer_tpu_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch version at the flagship serve
     shapes (B=4, 17x256^2 -> 5 x 32 x 32 tokens), with times;
  3. the bf16 round trip of imagenet_k600_config() at full width through
     OmniTokenizerVQGAN.reconstruct, with the launch count of every kernel,
     checked against the plain bf16 path on the same weights, and frames/s
     of both paths;
  4. a small f32 round trip on the card against the same model on the CPU.
The line before the last is a JSON object with a row per kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

B, T, RES = 4, 17, 256  # the flagship serve shape
EXPECTED_LAUNCHES = {"geglu_ff": 16, "ln_qkv": 14, "cosine_mha": 6,
                     "small_n_attention": 8, "vq_argmin": 1}
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
}
KERNEL_REL_TOL = 2e-2   # bf16 output rounding + another summation order
VQ_TIE_TOL = 1e-5       # relative distance gap allowed for an index mismatch
# Slice bars, on the whole-tensor relative error ||a - b|| / ||b||: two bf16
# paths that round at different places sit ~1.7e-2 apart after the decoder's
# 8 blocks of random weights, about the distance of either from f32
LATENT_REL_TOL = 5e-2   # pre-VQ latents, kernel vs plain bf16 path
DECODE_REL_TOL = 2e-2   # decode of the same indices, kernel vs plain
FLOOR_RATIO = 1.25      # kernel path's distance from f32 vs the plain path's


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over the whole tensor."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def phase2_kernels() -> dict:
    from omnitokenizer_tpu_torch.ops.kernels import cosine_mha as cm
    from omnitokenizer_tpu_torch.ops.kernels import geglu_ff as gf
    from omnitokenizer_tpu_torch.ops.kernels import ln_qkv as lq
    from omnitokenizer_tpu_torch.ops.kernels import small_attn as sa
    from omnitokenizer_tpu_torch.ops.kernels import vq_argmin as vq

    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    D, H, Dh = 512, 8, 64
    t, hw = 1 + (T - 1) // 4, (RES // 8) ** 2   # 5 latent frames of 32 x 32 tokens
    M = B * t * hw
    rows = {}

    def record(name, errs, kernel_fn, plain_fn):
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        rows[name] = {"max_abs_err": max(e[0] for e in errs), "ms": ms, "plain_ms": plain_ms}
        print(f"[2] {name}: max_abs {rows[name]['max_abs_err']:.3e} "
              f"max_rel {max(e[1] for e in errs):.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")

    def compare(name, got, want, tol=KERNEL_REL_TOL):
        err = (max_abs(got, want), rel_err(got, want))
        if not err[1] <= tol:
            raise AssertionError(f"{name}: relative error {err[1]:.3e} > {tol}")
        return err

    # ln_qkv: x (M, 512) -> q (M, 512), kv (M, 1024)
    x = randn(g, M, D, dtype=bf)
    gamma = 1 + randn(g, D, scale=0.1)
    wq = randn(g, D, D, scale=D ** -0.5, dtype=bf)
    wkv = randn(g, 2 * D, D, scale=D ** -0.5, dtype=bf)
    q_k, kv_k = lq.ln_qkv(x, gamma, wq, wkv)
    q_p, kv_p = lq.ln_qkv_plain(x, gamma, wq, wkv)
    record("ln_qkv", [compare("ln_qkv q", q_k, q_p), compare("ln_qkv kv", kv_k, kv_p)],
           lambda: lq.ln_qkv(x, gamma, wq, wkv), lambda: lq.ln_qkv_plain(x, gamma, wq, wkv))

    # geglu_ff: inner 1365 padded to 1408
    inner = int(4 * 2 / 3 * D)
    ln_w, ln_b = 1 + randn(g, D, scale=0.1), randn(g, D, scale=0.1)
    w1p, w2p = gf.pad_geglu_weights(randn(g, 2 * inner, D, scale=D ** -0.5),
                                    randn(g, D, inner, scale=inner ** -0.5))
    out_k = gf.geglu_ff(x, ln_w, ln_b, w1p, w2p)
    out_p = gf.geglu_ff_plain(x, ln_w, ln_b, w1p, w2p)
    record("geglu_ff", [compare("geglu_ff", out_k, out_p)],
           lambda: gf.geglu_ff(x, ln_w, ln_b, w1p, w2p),
           lambda: gf.geglu_ff_plain(x, ln_w, ln_b, w1p, w2p))

    qs, ks = 1 + randn(g, Dh, scale=0.1), 1 + randn(g, Dh, scale=0.1)

    # small_n_attention: (b h w, t, H*Dh), causal and not
    qt = randn(g, B * hw, t, H * Dh, dtype=bf)
    kvt = randn(g, B * hw, t, 2 * H * Dh, dtype=bf)
    errs = []
    for causal in (True, False):
        errs.append(compare(f"small_n_attention causal={causal}",
                            sa.small_n_attention(qt, kvt, qs, ks, H, Dh, 8.0, causal),
                            sa.small_n_attention_plain(qt, kvt, qs, ks, H, Dh, 8.0, causal)))
    record("small_n_attention", errs,
           lambda: sa.small_n_attention(qt, kvt, qs, ks, H, Dh, 8.0, True),
           lambda: sa.small_n_attention_plain(qt, kvt, qs, ks, H, Dh, 8.0, True))

    # cosine_mha: (b t, h w, H*Dh), RoPE on and off
    qsp = randn(g, B * t, hw, H * Dh, dtype=bf)
    kvsp = randn(g, B * t, hw, 2 * H * Dh, dtype=bf)
    errs = []
    for rope in (True, False):
        errs.append(compare(f"cosine_mha rope={rope}",
                            cm.cosine_mha(qsp, kvsp, qs, ks, H, Dh, 8.0, rope),
                            cm.cosine_mha_plain(qsp, kvsp, qs, ks, H, Dh, 8.0, rope)))
    record("cosine_mha", errs,
           lambda: cm.cosine_mha(qsp, kvsp, qs, ks, H, Dh, 8.0, True),
           lambda: cm.cosine_mha_plain(qsp, kvsp, qs, ks, H, Dh, 8.0, True))

    # vq_argmin: l2-normalized latents against an N(0, 1) 8192 x 8 codebook
    z = torch.nn.functional.normalize(randn(g, M, 8), dim=-1).contiguous()
    emb = randn(g, 8192, 8)
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
            raise AssertionError(f"vq_argmin: mismatch with relative distance gap {rel_gap:.3e}")
    print(f"[2] vq_argmin: {bad.numel()} of {M} indices differ (near-ties only)")
    rows["vq_argmin"] = {"max_abs_err": gap, "ms": cuda_ms(lambda: vq.vq_argmin(z, emb)),
                         "plain_ms": cuda_ms(lambda: vq.vq_argmin_plain(z, emb))}
    print(f"[2] vq_argmin: kernel {rows['vq_argmin']['ms']:.4f} ms  "
          f"plain {rows['vq_argmin']['plain_ms']:.4f} ms")
    return rows


def phase3_slice() -> dict:
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, imagenet_k600_config
    from omnitokenizer_tpu_torch.ops.attention import l2norm
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from omnitokenizer_tpu_torch.ops.kernels.vq_argmin import vq_argmin_plain

    cfg = imagenet_k600_config().replace(dtype=torch.bfloat16)
    model = OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cuda").serving()
    g = torch.Generator().manual_seed(1)
    video = (torch.rand(B, 3, T, RES, RES, generator=g) * 2 - 1).to("cuda")
    torch.cuda.synchronize()

    reset_launch_counts()
    recon, aux = model.reconstruct(video, is_image=False)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[3] launches in one round trip: {counts}")
    if counts != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {counts} != {EXPECTED_LAUNCHES}")

    t = cfg.latent_t
    if tuple(recon.shape) != (B, 3, T, RES, RES) or not bool(torch.isfinite(recon).all()):
        raise AssertionError(f"bad reconstruction {tuple(recon.shape)}")
    idx = aux["encodings"]
    if tuple(idx.shape) != (B, t, 32, 32) or int(idx.min()) < 0 or int(idx.max()) >= cfg.n_codes:
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
        print(f"[3] pre-VQ latents rel err {lat_err:.3e} (max-abs ratio {rel_err(h_k, h_p):.3e}); "
              f"indices agree {agree:.4%}")
        print(f"[3] decode of the same indices: kernel vs plain rel err {dec_err:.3e} "
              f"(max-abs ratio {rel_err(dec_k, dec_p):.3e}); vs f32: kernel {floor_k:.3e}, "
              f"plain {floor_p:.3e}")
        if not lat_err <= LATENT_REL_TOL:
            raise AssertionError(f"pre-VQ latents rel err {lat_err:.3e} > {LATENT_REL_TOL}")
        if not dec_err <= DECODE_REL_TOL:
            raise AssertionError(f"decode rel err {dec_err:.3e} > {DECODE_REL_TOL}")
        if not floor_k <= FLOOR_RATIO * floor_p:
            raise AssertionError(f"kernel path is {floor_k:.3e} from f32, plain {floor_p:.3e}")

        def fps(fn, iters=5):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            return iters * B * T / (time.perf_counter() - t0)

        torch.cuda.reset_peak_memory_stats()
        fps_k = fps(lambda: model.reconstruct(video, is_image=False))
        mem_k = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        fps_p = fps(plain_round_trip)
        mem_p = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[3] round trip B={B} {T}x{RES}^2 bf16: kernel path {fps_k:.2f} frames/s "
          f"(peak {mem_k:.2f} GiB), plain path {fps_p:.2f} frames/s (peak {mem_p:.2f} GiB)")
    return counts


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = phase0_card()
    phase1_build()
    rows = phase2_kernels()
    counts = phase3_slice()
    phase4_small_f32()
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name], **rows[name]}
               for name, (src, rep) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
