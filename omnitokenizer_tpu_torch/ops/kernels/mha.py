"""Plain multi-head attention over (B, H, N, D): softmax(q k^T * scale) v.

Scores and softmax in f32, P rounded to the input dtype before the P v
product, which accumulates in f32; the output is in the input dtype. The
optional causal mask is bottom-right aligned (col > row + Nk - Nq) and
fills -1e9, not -inf. Replaces `omnitokenizer_tpu/ops/pallas/mha.py:mha_pallas`;
the CUDA kernel is `csrc/mha.cu` (for N > 16 a flash branch: f32 on wgmma
tensor cores with 3xTF32 error compensation, bf16 in f32 FMA; for N <= 16 the
staged small-group core of `csrc/small_group.cuh`, which reads strided views)
and `mha_plain` its plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e9
MIN_N, MAX_N = 8, 2048
# head widths the flash branches are instantiated for; any other D % 8 == 0
# up to 128 is zero-padded to the next one (zero columns of q and k add
# nothing to q k^T, zero columns of v give zero output columns, sliced off)
DIM_HEADS = (8, 16, 32, 64, 128)
MAX_DIM_HEAD = DIM_HEADS[-1]
DTYPES = (torch.float32, torch.bfloat16)
# the small branch: any (b, h, n) strides whose rows are 16-byte aligned
SMALL_MAX_N, SMALL_DIM_HEADS = 16, tuple(range(16, 129, 16))


def mha_supported(n: int, dim_head: int, dtype: torch.dtype) -> bool:
    """The JAX gate (`mha.py:mha_supported`) without its backend check:
    8 <= N <= 2048 and D % 8 == 0, here up to D = 128 and in the kernel's
    dtypes. The caller handles the other conditions: no bias, not training."""
    return (MIN_N <= n <= MAX_N and dim_head % 8 == 0 and 0 < dim_head <= MAX_DIM_HEAD
            and dtype in DTYPES)


def narrowed(n: int, dim_head: int) -> bool:
    """Shapes the JAX gate takes and the kernel does not, which take the
    plain math: D above 128. A flash block keeps 64 query rows of O in a
    warpgroup's registers (D / 2 f32 a thread) beside the score tile, and
    the f32 branch splits each K/V tile into hi and lo TF32 copies in shared
    memory; at D = 256 neither fits."""
    return MIN_N <= n <= MAX_N and dim_head % 8 == 0 and dim_head > MAX_DIM_HEAD


def small_branch(n: int, dim_head: int) -> bool:
    """Whether the kernel takes (n, dim_head) in its small branch, which
    reads strided views; the flash branches take contiguous tensors."""
    return n <= SMALL_MAX_N and dim_head in SMALL_DIM_HEADS


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale [bottom-right causal]) v over (B, H, N, D):
    products of the input dtype with f32 accumulation, softmax in f32."""
    sim = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        i, j = sim.shape[-2:]
        row = torch.arange(i, device=q.device)[:, None]
        col = torch.arange(j, device=q.device)[None, :]
        sim = sim.masked_fill(col > row + (j - i), NEG_INF)
    attn = sim.softmax(-1).to(q.dtype)
    return (attn.float() @ v.to(q.dtype).float()).to(v.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
        causal: bool = False) -> torch.Tensor:
    """q, k, v (B, H, N, D) of one dtype, float32 or bfloat16: contiguous,
    or in the small branch any views with 16-byte rows (the attention
    module's transposed (B, N, H, D) memory; the output then takes q's
    layout). Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, scale, causal)
    _build.refuse_grad("mha", q, k, v)
    B, H, N, D = q.shape
    if not mha_supported(N, D, q.dtype):
        raise ValueError(f"mha: unsupported N={N} dim_head={D} dtype={q.dtype}")
    small = small_branch(N, D)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.check(t, name, q.dtype, (B, H, N, D), contiguous=not small)
        if small and t.stride(-1) != 1:
            raise ValueError(f"mha: {name} needs a unit last stride, got {t.stride(-1)}")
        if small and any(s * t.element_size() % 16
                         for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"mha: {name} rows are not 16-byte aligned (strides {t.stride()})")
        if t.data_ptr() % 16:
            raise ValueError(f"mha: {name} is not 16-byte aligned")
    width = D if small else next(d for d in DIM_HEADS if d >= D)
    if width != D:  # zero columns to the flash branch's next instance
        q, k, v = (F.pad(t, (0, width - D)) for t in (q, k, v))
    if small and q.transpose(1, 2).is_contiguous():
        out = torch.empty(B, N, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    else:
        out = torch.empty(B, H, N, width, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    _build.launch("mha_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  ctypes.addressof(strides), B, H, N, width, float(scale), int(causal),
                  int(q.dtype == torch.bfloat16))
    mha.launches += 1
    return out[..., :D] if width != D else out


mha.launches = 0
