"""Causal flash attention over (B, H, T, D), forward and backward.

    o = softmax(q k^T * scale, key j <= query i) v,   lse = logsumexp of each row

Replaces JAX's stock TPU kernel, which the JAX LM's full forward calls at
`omnitokenizer_tpu/models/gpt.py:103-131` (jax/experimental/pallas/ops/tpu/
flash_attention.py: the forward `_flash_attention_impl`, the backward's
`_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`; its (l, m) pair is
folded into lse). The CUDA kernels are `csrc/flash_attn.cu`, TMA-fed
wgmma with warp specialization: one forward launch, and a backward of three
(di = sum o * do with lse * log2(e) into a padded scratch, then dk/dv and
dq) that counts as one call. `flash_attn_fwd_plain` and `flash_attn_bwd_plain` are
their plain versions, in f32 math; `flash_attention` is the
`torch.autograd.Function` that saves (q, k, v, o, lse) and runs the
backward kernels (on a CPU tensor, the plain versions).

The kernels take bf16 q, k, v whose last stride is 1 and whose (b, h, t)
strides are multiples of 8 elements (16-byte rows): the LM hands them its
(B, T, H, D) projections seen as (B, H, T, D) views, which TMA reads as
they are through a map of four dimensions, and the outputs are written in
that layout too. A tensor with other strides
(a gradient that arrives expanded, say) is copied once with `.contiguous()`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

# the JAX gate's sequence bound (models/gpt.py:_flash_ok): shorter sequences
# keep the materialized math there, and so in the port
MIN_T = 256
# head widths the kernels are instantiated for; any other width up to 128 is
# zero-padded to the next one (zero columns of q and k add nothing to q k^T,
# zero columns of v give zero output columns, sliced off)
DIM_HEADS = (16, 32, 64, 96, 128)
MAX_DIM_HEAD = DIM_HEADS[-1]
# the backward's query tile (csrc/flash_attn.cu kBwdTile): its scratch rows
# are T rounded up to it
AUX_PAD = 64


def flash_attn_supported(t: int, dim_head: int) -> bool:
    """Shapes the kernels take: any sequence length, head widths up to 128."""
    return t >= 1 and 0 < dim_head <= MAX_DIM_HEAD


def narrowed(t: int, dim_head: int) -> bool:
    """Shapes the JAX gate takes (bf16, T >= 256, any head width) and the
    kernels do not, which keep the LM's materialized math: head widths above
    128. A warpgroup keeps 64 rows of its f32 accumulators (O, dQ, or dK and
    dV) in registers, D / 2 a thread each; past 128 they do not fit beside
    the score tiles."""
    return t >= MIN_T and dim_head > MAX_DIM_HEAD


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    t = s.shape[-1]
    hidden = torch.ones(t, t, dtype=torch.bool, device=q.device).triu_(1)
    return s.masked_fill(hidden, float("-inf"))


def flash_attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype, lse (B, H, T) f32) of causal attention, in f32 math."""
    s = _scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.exp(s - lse[..., None]) @ v.float()
    return o.to(q.dtype), lse


def flash_attn_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                         do: torch.Tensor, lse: torch.Tensor, scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's dtype from the saved (o, lse), in f32 math: p =
    exp(s - lse), di = sum o * do, ds = p (do v^T - di)."""
    p = torch.exp(_scores(q, k, scale) - lse[..., None].float())
    do32 = do.float()
    dv = p.transpose(-1, -2) @ do32
    di = (o.float() * do32).sum(-1, keepdim=True)
    ds = p * (do32 @ v.float().transpose(-1, -2) - di)
    dq = (ds @ k.float()) * scale
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _strided(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernels read it through its strides (unit last
    stride, 16-byte base, positive strides of whole 16-byte rows: what a TMA
    map takes), else one contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s > 0 and s % 8 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))
    return t if ok else t.contiguous()


def _check(name: str, B: int, H: int, T: int, D: int, *tensors: torch.Tensor) -> None:
    if not flash_attn_supported(T, D):
        raise ValueError(f"{name}: unsupported T={T} dim_head={D} (narrowed: D > 128)")
    for i, t in enumerate(tensors):
        _build.check(t, f"{name} input {i}", torch.bfloat16, (B, H, T, D), contiguous=False)


def _width(D: int) -> int:
    return next(d for d in DIM_HEADS if d >= D)


def _out(B: int, H: int, T: int, D: int, like: torch.Tensor) -> torch.Tensor:
    """A (B, H, T, D) view of (B, T, H, D) memory: the LM's layout."""
    return torch.empty(B, T, H, D, dtype=like.dtype, device=like.device).transpose(1, 2)


def _strides(*tensors: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, H, T, D) bf16 -> (o (B, H, T, D) bf16 as a view of (B, T,
    H, D) memory, lse (B, H, T) f32). Kernel on a CUDA tensor, plain version
    on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attn_fwd_plain(q, k, v, scale)
    _build.refuse_grad("flash_attn_fwd", q, k, v)
    B, H, T, D = q.shape
    _check("flash_attn_fwd", B, H, T, D, q, k, v)
    W = _width(D)
    if W != D:
        q, k, v = (F.pad(t, (0, W - D)) for t in (q, k, v))
    q, k, v = (_strided(t) for t in (q, k, v))
    o = _out(B, H, T, W, q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, o)  # alive until the launch has read it
    _build.launch("flash_attn_fwd_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), ctypes.addressof(strides), B, H, T, W,
                  float(scale))
    flash_attn_fwd.launches += 1
    return (o[..., :D] if W != D else o), lse


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   do: torch.Tensor, lse: torch.Tensor, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each (B, H, T, D) bf16 as a view of (B, T, H, D) memory,
    from the forward's inputs, its o and lse and the output's gradient do.
    Kernels on a CUDA tensor, plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attn_bwd_plain(q, k, v, o, do, lse, scale)
    _build.refuse_grad("flash_attn_bwd", q, k, v, o, do)
    B, H, T, D = q.shape
    _check("flash_attn_bwd", B, H, T, D, q, k, v, o, do)
    _build.check(lse, "lse", torch.float32, (B, H, T))
    W = _width(D)
    if W != D:
        q, k, v, o, do = (F.pad(t, (0, W - D)) for t in (q, k, v, o, do))
    q, k, v, o, do = (_strided(t) for t in (q, k, v, o, do))
    dq, dk, dv = (_out(B, H, T, W, q) for _ in range(3))
    # lse * log2(e) and di, each row padded with zeros to a whole query tile
    aux = torch.empty(2, B, H, -(-T // AUX_PAD) * AUX_PAD, dtype=torch.float32,
                      device=q.device)
    strides = _strides(q, k, v, o, do, dq, dk, dv)
    _build.launch("flash_attn_bwd_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), do.data_ptr(), lse.data_ptr(), aux.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides), B, H, T, W,
                  float(scale))
    flash_attn_bwd.launches += 1
    if W != D:
        return dq[..., :D], dk[..., :D], dv[..., :D]
    return dq, dk, dv


flash_attn_fwd.launches = 0
flash_attn_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Causal attention whose forward saves (q, k, v, o, lse) and whose
    backward runs the backward kernels; no recomputation through the plain
    math."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attn_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attn_bwd(q, k, v, o, do, lse, ctx.scale), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Causal softmax(q k^T * scale) v over (B, H, T, D), differentiable."""
    return FlashAttention.apply(q, k, v, scale)
