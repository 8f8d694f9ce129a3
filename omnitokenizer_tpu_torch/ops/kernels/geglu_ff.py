"""Fused LayerNorm -> Linear -> GEGLU -> Linear (the FeedForward block).

LN(x; w, b) with f32 statistics, h = xn @ W1^T split [val | gate], act =
gelu_erf(gate) * val, out = act @ W2^T; bf16 products with f32 accumulation.
Replaces `omnitokenizer_tpu/ops/pallas/geglu_ff.py:geglu_ff` (whose tanh GELU
is a Mosaic limitation: the port uses erf, as the JAX math path does). The
CUDA kernels are `csrc/geglu_ff.cu` (LN, then two wgmma GEMMs fed by TMA,
the GEGLU in the first one's epilogue; one wrapper call launches the three
and counts once) and `geglu_ff_plain` is their plain version.

inner = int(4 * 2/3 * dim) (1365 at dim 512) is not a tile multiple, so
`pad_geglu_weights` pads each half of W1 with zero rows and W2 with zero
columns to a multiple of 64, once at the serving step: a zero val column
contributes gelu(0) * 0 = 0, so the output is unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

EPS = 1e-5
INNER_TILE = 64
MAX_DIM = 2048  # the LN pass holds a row in one warp's registers


def padded_inner(inner: int) -> int:
    return -(-inner // INNER_TILE) * INNER_TILE


def pad_geglu_weights(w1: torch.Tensor, w2: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """w1 (2*inner, D) [val | gate], w2 (D, inner) in the nn.Linear layout ->
    w1p (2*Ip, D), w2p (D, Ip) zero-padded to Ip = padded_inner(inner)."""
    inner = w2.shape[1]
    pad = padded_inner(inner) - inner
    val, gate = w1[:inner], w1[inner:]
    w1p = torch.cat([F.pad(val, (0, 0, 0, pad)), F.pad(gate, (0, 0, 0, pad))])
    w2p = F.pad(w2, (0, pad))
    return w1p.to(dtype).contiguous(), w2p.to(dtype).contiguous()


def geglu_ff_supported(dim: int) -> bool:
    """Any D a multiple of 64 up to MAX_DIM: a superset of the JAX gate's
    D % 128 == 0 but for `narrowed`."""
    return dim % 64 == 0 and 0 < dim <= MAX_DIM


def narrowed(dim: int) -> bool:
    """Widths the JAX gate takes and the kernels do not, which take the
    plain route: D above 2048, where the LN pass's row (8 16-byte chunks a
    lane of one warp) would outgrow its registers."""
    return dim % 128 == 0 and dim > MAX_DIM


def geglu_ff_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                   w1p: torch.Tensor, w2p: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + EPS) * ln_w + ln_b).to(x.dtype)
    h = xn.float() @ w1p.float().t()
    val, gate = h.chunk(2, dim=-1)
    act = (F.gelu(gate) * val).to(x.dtype)
    return (act.float() @ w2p.float().t()).to(x.dtype)


def geglu_ff(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
             w1p: torch.Tensor, w2p: torch.Tensor) -> torch.Tensor:
    """x (M, D) bf16; ln_w/ln_b (D,) f32; padded w1p (2*Ip, D), w2p (D, Ip)
    bf16. Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, ln_w, ln_b, w1p, w2p)
    _build.refuse_grad("geglu_ff", x, ln_w, ln_b, w1p, w2p)
    M, D = x.shape
    ip = w2p.shape[1]
    if not geglu_ff_supported(D) or ip % INNER_TILE:
        raise ValueError(f"geglu_ff: unsupported shapes D={D} inner_padded={ip}")
    _build.check(x, "x", torch.bfloat16)
    _build.check(ln_w, "ln_w", torch.float32, (D,))
    _build.check(ln_b, "ln_b", torch.float32, (D,))
    _build.check(w1p, "w1p", torch.bfloat16, (2 * ip, D))
    _build.check(w2p, "w2p", torch.bfloat16, (D, ip))
    for t, name in ((x, "x"), (w1p, "w1p"), (w2p, "w2p")):
        if t.data_ptr() % 16:  # 16-byte vectors and TMA
            raise ValueError(f"geglu_ff: {name} is not 16-byte aligned")
    out = torch.empty_like(x)
    # the chain's intermediates: LN(x) and the activations, both bf16
    xn, act = torch.empty_like(x), x.new_empty(M, ip)
    _build.launch("geglu_ff_launch", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                  w1p.data_ptr(), w2p.data_ptr(), xn.data_ptr(), act.data_ptr(),
                  out.data_ptr(), M, D, ip)
    geglu_ff.launches += 1
    return out


geglu_ff.launches = 0
