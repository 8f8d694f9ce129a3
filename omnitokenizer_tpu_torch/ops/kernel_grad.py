"""Kernel forward, recomputed backward: the bf16 kernels in a training step
(mirror of `omnitokenizer_tpu.ops.kernel_grad`).

The kernels have no backward. `kernel_fwd_ref_bwd(kernel_fn, ref_fn, *args)`
runs `kernel_fn` as the primal and saves only the inputs; the backward
replays `ref_fn`, the module's plain math, from those inputs and
differentiates it. One more forward inside the backward, and no activation
kept between the passes: the JAX package's `custom_vjp` trade. Gradients
are exactly those of `ref_fn`; the primal differs from it by the kernel's
bf16-level error. `ref_fn` must take the plain route throughout, so that
the backward launches no kernel.

`OMNITOK_TRAIN_KERNEL_FWD` picks the op groups (a comma list of attn, ff
and flat; "1" for all, "0" or "" for none), read at each call as the JAX
package reads it at trace time.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

_DEFAULT = "attn,ff,flat"


def train_kernel_fwd_ops() -> frozenset:
    """The op groups whose training forward runs the kernels."""
    raw = os.environ.get("OMNITOK_TRAIN_KERNEL_FWD", _DEFAULT).strip()
    if raw in ("", "0"):
        return frozenset()
    if raw == "1":
        return frozenset({"attn", "ff", "flat"})
    return frozenset(p.strip() for p in raw.split(",") if p.strip())


class _KernelFwdRefBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel_fn, ref_fn, *args):
        ctx.ref_fn = ref_fn
        ctx.save_for_backward(*args)
        with torch.no_grad():
            return kernel_fn(*args)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        inputs = [a.detach().requires_grad_(n) for a, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = ctx.ref_fn(*inputs)
        wanted = [a for a, n in zip(inputs, needs) if n]
        got = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, None, *(next(got) if n else None for n in needs))


def kernel_fwd_ref_bwd(kernel_fn: Callable, ref_fn: Callable, *args: torch.Tensor) -> torch.Tensor:
    """`kernel_fn(*args)` whose gradient is that of `ref_fn(*args)`,
    recomputed from the saved inputs. Both take the same tensors and return
    one tensor of the same shape and dtype."""
    return _KernelFwdRefBwd.apply(kernel_fn, ref_fn, *args)
