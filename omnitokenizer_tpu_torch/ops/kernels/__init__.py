"""Hand-written CUDA kernels of the serving path and their plain versions.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs its
plain PyTorch version for a CPU tensor. A kernel has no backward: on a CUDA
tensor a wrapper (but vq_argmin, whose integer indices have no gradient)
raises when grad mode is on and an input requires grad; training reaches
the kernels through ops/kernel_grad.py. A wrapper counts its kernel
launches in a `launches` attribute, so a run can show that the main path
went through the kernels.
"""

from __future__ import annotations

from typing import Dict

from . import cosine_mha, geglu_ff, ln_qkv, mha, small_attn, vq_argmin

WRAPPERS = {
    "vq_argmin": vq_argmin.vq_argmin,
    "ln_qkv": ln_qkv.ln_qkv,
    "geglu_ff": geglu_ff.geglu_ff,
    "small_n_attention": small_attn.small_n_attention,
    "cosine_mha": cosine_mha.cosine_mha,
    "mha": mha.mha,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
