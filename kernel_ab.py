#!/usr/bin/env python3
"""Time the attention and code-search kernels of one checkout of the PyTorch
port by both of chip_smoke.py's timing methods, so that two checkouts (a
commit and its parent) are compared with one yardstick on one GPU.

    python3 kernel_ab.py --root DIR [--only NAME]

DIR is the root of a checkout: its omnitokenizer_tpu_torch is imported and
builds its own kernels; the timing is this checkout's `chip_smoke.cuda_ms`,
with the timed calls queued behind a sleeping kernel (the device's time)
and issued as a caller issues them (the host's time shows where it is the
longer). Run it for the parent and the change in turns (parent, change,
change, parent). Rows, at chip_smoke.py phase 2's shapes:
  small_n_attention at the flagship's VQ shape (4096 x 5 x (8x64), causal);
  mha, bf16 causal (4096, 8, 9, 64): the kernel on contiguous tensors, and
    the stage-1 tokenizer's route: `sdpa` on the attention module's
    (B, H, N, D) views of (B, N, H, D) memory, v inside the fused kv, and
    the transpose-reshape after it, with whatever copies the checkout makes;
  cosine_mha at the flagship's (20, 1024, 8x64) with RoPE;
  vq_argmin at the flagship's 20480 and the stage-1 tokenizer's 36864 rows
    of 8 against an 8192 x 8 codebook, called as the checkout's codebook
    calls it; where that passes squared code norms made ahead, also with
    the norms left to the wrapper; and at the CNN VQGAN's 16384 rows of 256
    against a 2048 x 256 codebook (N(0, 1) both, phase 2's row);
  where the checkout has it, the LM's causal flash attention at the flagship
    LM's training shape (8, 16, 1025, 96) and at the long-sequence recipes'
    (4, 16, 5121, 96), on (B, H, T, D) views of (B, T, H, D) memory: the
    forward, and the backward from the forward's o and lse (held against
    the plain twins; at T = 5121 on batch 0).
Each row is timed `--repeats` times a method and held against its plain
version (vq_argmin: indices equal but at near-ties). Prints one JSON line
{"root": ..., "rows": [...]}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="root of the checkout to time")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--only", default="", help="time only the rows whose name contains this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # this checkout's timing and error measures

    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from omnitokenizer_tpu_torch.ops.attention import sdpa
    from omnitokenizer_tpu_torch.ops.kernels import cosine_mha as cm
    from omnitokenizer_tpu_torch.ops.kernels import mha as mh
    from omnitokenizer_tpu_torch.ops.kernels import small_attn as sa
    from omnitokenizer_tpu_torch.ops.kernels import vq_argmin as vq

    if not Path(mh.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {mh.__file__}, not the package under {root}")
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=g).to("cuda", dtype)

    H, Dh = 8, 64
    qs, ks = 1 + 0.1 * randn(Dh, dtype=torch.float32), 1 + 0.1 * randn(Dh, dtype=torch.float32)

    # small_n_attention: (b h w, t, H*Dh) at the flagship's 5 latent frames
    qt, kvt = randn(4096, 5, H * Dh), randn(4096, 5, 2 * H * Dh)

    # mha: the views _attend hands to sdpa at the 'rel' path's 9 frames
    b, n = 4096, 9
    q, k = (F.normalize(randn(b, n, H, Dh).float(), dim=-1).to(bf).transpose(1, 2)
            for _ in range(2))
    kv = randn(b, n, 2 * H * Dh)
    v = kv[..., H * Dh:].view(b, n, H, Dh).transpose(1, 2)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()

    # cosine_mha: (b t, h w, H*Dh) at the flagship's shape
    qsp, kvsp = randn(20, 1024, H * Dh), randn(20, 1024, 2 * H * Dh)

    # vq_argmin: l2-normalized rows against an N(0, 1) codebook; the
    # codebook of a checkout that keeps the norms hands them over
    emb = randn(8192, 8, dtype=torch.float32)
    norms = (vq.code_norms(emb),) if hasattr(vq, "code_norms") else ()
    zs = {m: F.normalize(randn(m, 8, dtype=torch.float32), dim=-1).contiguous()
          for m in (20480, 36864)}
    z_cnn = randn(16384, 256, dtype=torch.float32)
    emb_cnn = randn(2048, 256, dtype=torch.float32)

    def vq_case(m, args):
        made = ", norms made in the call" if norms and not args else ""
        return (f"vq_argmin, {m} rows{made}", lambda: vq.vq_argmin(zs[m], emb, *args),
                lambda: vq.vq_argmin_plain(zs[m], emb))

    cases = [
        ("small_n_attention", lambda: sa.small_n_attention(qt, kvt, qs, ks, H, Dh, 8.0, True),
         lambda: sa.small_n_attention_plain(qt, kvt, qs, ks, H, Dh, 8.0, True)),
        ("mha kernel, contiguous", lambda: mh.mha(qc, kc, vc, 8.0, True),
         lambda: mh.mha_plain(qc, kc, vc, 8.0, True)),
        ("mha route, sdpa on views + reshape",
         lambda: sdpa(q, k, v, 8.0, causal=True).transpose(1, 2).reshape(b, n, H * Dh),
         lambda: mh.mha_plain(q, k, v, 8.0, True).transpose(1, 2).reshape(b, n, H * Dh)),
        ("cosine_mha", lambda: cm.cosine_mha(qsp, kvsp, qs, ks, H, Dh, 8.0, True),
         lambda: cm.cosine_mha_plain(qsp, kvsp, qs, ks, H, Dh, 8.0, True)),
        vq_case(20480, norms), vq_case(36864, norms),
    ] + ([vq_case(20480, ()), vq_case(36864, ())] if norms else []) + [
        ("vq_argmin, CNN VQGAN 16384 x 256", lambda: vq.vq_argmin(z_cnn, emb_cnn),
         lambda: vq.vq_argmin_plain(z_cnn, emb_cnn))]
    try:
        from omnitokenizer_tpu_torch.ops.kernels import flash_attn as fa
    except ImportError:  # a checkout from before the LM's training slice
        fa = None
    if fa is not None:
        sc = 96 ** -0.5

        def flash_cases(B_, T_, pb):
            """The forward and the backward at (B_, 16, T_, 96); the plain
            twins (held, not timed) on the first pb batches: at T = 5121 on
            batch 0 alone, whose f32 scores are 1.7 GB."""
            fq, fk, fv, fdo = (randn(B_, T_, 16, 96).transpose(1, 2) for _ in range(4))
            fo, flse = fa.flash_attn_fwd(fq, fk, fv, sc)
            fo_ref, flse_ref = fa.flash_attn_fwd_plain(fq[:pb], fk[:pb], fv[:pb], sc)
            dref = fa.flash_attn_bwd_plain(fq[:pb], fk[:pb], fv[:pb], fo_ref, fdo[:pb], flse_ref,
                                           sc)
            at = "" if T_ == 1025 else f" ({B_}, 16, {T_}, 96)"
            return [(f"flash_attn_fwd{at}", lambda: fa.flash_attn_fwd(fq, fk, fv, sc)[0],
                     lambda: fo_ref),
                    (f"flash_attn_bwd{at}",
                     lambda: fa.flash_attn_bwd(fq, fk, fv, fo, fdo, flse, sc), lambda: dref)]

        cases += flash_cases(8, 1025, 8) + flash_cases(4, 5121, 1)
    rows = []
    for name, fn, plain in (c for c in cases if args.only in c[0]):
        if name.startswith("vq_argmin"):  # the share of indices that differ
            err = float((fn() != plain()).float().mean())
            if not err <= 1e-3:
                raise AssertionError(f"{name}: {err:.3e} of the indices differ")
        elif name.startswith("flash_attn_bwd"):  # dq, dk, dv: the worst, on the plain batches
            err = max(chip_smoke.rel_err(a[:b.shape[0]], b) for a, b in zip(fn(), plain()))
            if not err <= chip_smoke.KERNEL_REL_TOL:
                raise AssertionError(f"{name}: relative error {err:.3e}")
        else:
            got, want = fn(), plain()  # the flash rows' plain twins: their batches
            err = chip_smoke.rel_err(got[:want.shape[0]], want)
            if not err <= chip_smoke.KERNEL_REL_TOL:
                raise AssertionError(f"{name}: relative error {err:.3e}")
        row = {"name": name, "rel_err": err}
        for method, queued in (("queued_ms", True), ("host_paced_ms", False)):
            times = [chip_smoke.cuda_ms(fn, queued=queued) for _ in range(args.repeats)]
            row[method] = times
            row[method.replace("_ms", "_median_ms")] = statistics.median(times)
        rows.append(row)
        print(f"{name}: queued {row['queued_median_ms']:.4f} ms, host-paced "
              f"{row['host_paced_median_ms']:.4f} ms (medians of {args.repeats}); "
              f"rel err {err:.3e}", file=sys.stderr)
    print(json.dumps({"root": str(root), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
