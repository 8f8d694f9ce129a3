"""Improved precision and recall over Inception pool3 features (mirror of
`omnitokenizer_tpu.eval.prec_recall`; the OpenAI evaluator's
ManifoldEstimator, after Kynkaanniemi et al.).

Distances are SQUARED Euclidean, by the ||u||^2 - 2 u v^T + ||v||^2
expansion clamped at 0, one matmul per (row, column) block. A feature's
manifold radius is its distance to its k-th nearest neighbour, itself
counted at index 0: the (k + 1)-th smallest distance of its row. Precision
is the share of sample features inside ANY reference hypersphere, recall
the share of reference features inside ANY sample hypersphere.

Everything runs where `device` says (the card by default): the distance
blocks, the k-th value and both coverage folds stay there, in f32 with
TF32 off, so a distance is not rounded to 10 mantissa bits before it
meets its radius.
"""

from __future__ import annotations

import contextlib
from typing import Any, Tuple

import torch


@contextlib.contextmanager
def _f32_matmul():
    """TF32 off for the card's f32 matmuls, the caller's setting restored."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _features(x: Any, device) -> torch.Tensor:
    from ..models.wrapper import check_device

    check_device(device)
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def pairwise_sq_dists(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N, D), (M, D) f32 -> (N, M) squared Euclidean distances, clamped >= 0,
    summed as the JAX package sums them: (|u|^2 - (2u) v^T) + |v|^2."""
    nu = (u * u).sum(dim=1)[:, None]
    nv = (v * v).sum(dim=1)[None, :]
    with _f32_matmul():
        return (nu - torch.matmul(2.0 * u, v.T) + nv).clamp_min_(0.0)


def manifold_radii(features: Any, k: int = 3, row_batch: int = 10000,
                   col_batch: int = 10000, device="cuda") -> torch.Tensor:
    """(N,) squared radius of each feature to its k-th nearest neighbour,
    self included at distance 0 (the JAX package's np.partition(d, k)[:, k],
    i.e. torch.kthvalue(d, k + 1)); on `device`."""
    f = _features(features, device)
    n = len(f)
    radii = torch.empty(n, dtype=torch.float32, device=f.device)
    for b1 in range(0, n, row_batch):
        e1 = min(b1 + row_batch, n)
        dist = torch.empty((e1 - b1, n), dtype=torch.float32, device=f.device)
        for b2 in range(0, n, col_batch):
            e2 = min(b2 + col_batch, n)
            dist[:, b2:e2] = pairwise_sq_dists(f[b1:e1], f[b2:e2])
        # the (k + 1)-th smallest of each row: topk of k + 1 (cheaper than a
        # selection over the whole row on the card), its last value
        radii[b1:e1] = torch.topk(dist, k + 1, dim=1, largest=False, sorted=True).values[:, k]
        del dist
    return radii


def precision_recall(ref_features: Any, sample_features: Any, k: int = 3,
                     row_batch: int = 10000, col_batch: int = 10000,
                     device="cuda") -> Tuple[float, float]:
    """-> (precision, recall) with neighbourhood size k; features (N, D) as
    numpy arrays or tensors, moved to `device` once."""
    ref = _features(ref_features, device)
    sample = _features(sample_features, device)
    radii_ref = manifold_radii(ref, k, row_batch, col_batch, device)
    radii_sample = manifold_radii(sample, k, row_batch, col_batch, device)
    ref_covered = torch.zeros(len(ref), dtype=torch.bool, device=ref.device)
    sample_covered = torch.zeros(len(sample), dtype=torch.bool, device=ref.device)
    for b1 in range(0, len(ref), row_batch):
        e1 = min(b1 + row_batch, len(ref))
        for b2 in range(0, len(sample), col_batch):
            e2 = min(b2 + col_batch, len(sample))
            d = pairwise_sq_dists(ref[b1:e1], sample[b2:e2])
            # ref_i inside a sample sphere -> recall; sample_j inside a ref sphere -> precision
            ref_covered[b1:e1] |= (d <= radii_sample[None, b2:e2]).any(dim=1)
            sample_covered[b2:e2] |= (d <= radii_ref[b1:e1, None]).any(dim=0)
    return int(sample_covered.sum()) / len(sample), int(ref_covered.sum()) / len(ref)
