"""Nearest-code search: argmin_k(||e_k||^2 - 2 x.e_k) in f32.

Replaces `omnitokenizer_tpu/ops/pallas/vq_kernel.py:vq_argmin_pallas`. The
CUDA kernel is `csrc/vq_argmin.cu`, at any code dim; `vq_argmin_plain` is
its plain version.
"""

from __future__ import annotations

import torch

from . import _build


def vq_argmin_plain(flat: torch.Tensor, embeddings: torch.Tensor) -> torch.Tensor:
    """(M, D), (K, D) -> (M,) int32 nearest-code indices, ties to the lowest
    index. The row term ||x||^2 cannot change the argmin and is left out, as
    in the TPU kernel."""
    x = flat.float()
    e = embeddings.float()
    dist = (e * e).sum(1)[None, :] - 2.0 * (x @ e.t())
    return torch.argmin(dist, dim=1).to(torch.int32)


def vq_argmin(flat: torch.Tensor, embeddings: torch.Tensor) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor."""
    if flat.device.type == "cpu":
        return vq_argmin_plain(flat, embeddings)
    M, D = flat.shape
    K = embeddings.shape[0]
    _build.check(flat, "flat", torch.float32, (M, D))
    _build.check(embeddings, "embeddings", torch.float32, (K, D))
    # the code slices' (distance, index) minima, merged by the kernel
    part = torch.empty(M, dtype=torch.int64, device=flat.device)
    out = torch.empty(M, dtype=torch.int32, device=flat.device)
    _build.launch("vq_argmin_launch", flat.data_ptr(), embeddings.data_ptr(), part.data_ptr(),
                  out.data_ptr(), M, K, D)
    vq_argmin.launches += 1
    return out


vq_argmin.launches = 0
