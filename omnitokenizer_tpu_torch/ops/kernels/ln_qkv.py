"""Fused gamma-only LayerNorm + q/kv projection.

q = LN_gamma(x) @ Wq^T, kv = x @ Wkv^T: k and v read the PRE-norm input (the
reference quirk). bf16 products with f32 accumulation, f32 LN statistics.
Replaces `omnitokenizer_tpu/ops/pallas/ln_qkv.py:ln_qkv`; the CUDA kernels are
`csrc/ln_qkv.cu` (an LN pass, then one TMA/wgmma GEMM launch over the q and kv
columns; one wrapper call counts once) and `ln_qkv_plain` their plain
version. Weights are in the `nn.Linear` layout (out, in), pre-cast to bf16
once at the serving step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

EPS = 1e-5
MAX_DIM = 2048  # the LN pass holds a row in one warp's registers


def ln_qkv_supported(dim: int, dq: int, dkv: int) -> bool:
    """Shapes the CUDA kernels take: D a multiple of the 64-wide TMA box up to
    MAX_DIM, output widths whole 64-column tiles. A superset of the JAX
    gate's D % 128 == 0 but for `narrowed`."""
    return (dim % 64 == 0 and 0 < dim <= MAX_DIM and dq % 64 == 0 and dkv % 64 == 0
            and dq > 0 and dkv > 0)


def narrowed(dim: int) -> bool:
    """Widths the JAX gate takes and the kernels do not, which take the
    plain route: D above 2048, where the LN pass's row (8 16-byte chunks a
    lane of one warp) would outgrow its registers."""
    return dim % 128 == 0 and dim > MAX_DIM


def ln_qkv_plain(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
                 wkv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + EPS) * gamma.float()).to(x.dtype)
    q = (xn.float() @ wq.float().t()).to(x.dtype)
    kv = (xf @ wkv.float().t()).to(x.dtype)
    return q, kv


def ln_qkv(x: torch.Tensor, gamma: torch.Tensor, wq: torch.Tensor,
           wkv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, D) bf16; gamma (D,) f32; wq (Dq, D), wkv (Dkv, D) bf16.
    Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, gamma, wq, wkv)
    _build.refuse_grad("ln_qkv", x, gamma, wq, wkv)
    M, D = x.shape
    dq, dkv = wq.shape[0], wkv.shape[0]
    if not ln_qkv_supported(D, dq, dkv):
        raise ValueError(f"ln_qkv: unsupported shapes D={D} Dq={dq} Dkv={dkv}")
    _build.check(x, "x", torch.bfloat16)
    _build.check(gamma, "gamma", torch.float32, (D,))
    _build.check(wq, "wq", torch.bfloat16, (dq, D))
    _build.check(wkv, "wkv", torch.bfloat16, (dkv, D))
    for t, name in ((x, "x"), (wq, "wq"), (wkv, "wkv")):
        if t.data_ptr() % 16:  # 16-byte vectors and TMA
            raise ValueError(f"ln_qkv: {name} is not 16-byte aligned")
    xn = torch.empty_like(x)  # the LN pass's output, the GEMM's A for q
    q = torch.empty(M, dq, dtype=x.dtype, device=x.device)
    kv = torch.empty(M, dkv, dtype=x.dtype, device=x.device)
    _build.launch("ln_qkv_launch", x.data_ptr(), gamma.data_ptr(), wq.data_ptr(),
                  wkv.data_ptr(), xn.data_ptr(), q.data_ptr(), kv.data_ptr(), M, D, dq, dkv)
    ln_qkv.launches += 1
    return q, kv


ln_qkv.launches = 0
