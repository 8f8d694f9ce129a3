"""Frechet distance, the FID/FVD math (a numpy copy of
`omnitokenizer_tpu.eval.frechet`; the reference's fvd/fvd.py:56-112).

The symmetric matrix square root by SVD (not scipy.linalg.sqrtm, so the
numbers are the JAX package's), the trace-sqrt product and the unbiased
covariance, in float64 on the host: the square root of a 400x400 or
2048x2048 covariance is numerically delicate and its time does not matter.
"""

from __future__ import annotations

import numpy as np


def _symmetric_matrix_square_root(mat: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    u, s, vt = np.linalg.svd(mat)
    si = np.where(s < eps, s, np.sqrt(s))
    return (u * si[None, :]) @ vt


def trace_sqrt_product(sigma: np.ndarray, sigma_v: np.ndarray) -> float:
    sqrt_sigma = _symmetric_matrix_square_root(sigma)
    inner = sqrt_sigma @ sigma_v @ sqrt_sigma
    return float(np.trace(_symmetric_matrix_square_root(inner)))


def _cov(m: np.ndarray) -> np.ndarray:
    """Unbiased covariance over rows-as-observations."""
    m = m - m.mean(axis=0, keepdims=True)
    return (m.T @ m) / (m.shape[0] - 1)


def frechet_distance(x1: np.ndarray, x2: np.ndarray) -> float:
    """x1, x2: (N, D) feature matrices (e.g. I3D logits / Inception pools)."""
    x1 = np.asarray(x1, np.float64).reshape(len(x1), -1)
    x2 = np.asarray(x2, np.float64).reshape(len(x2), -1)
    m1, m2 = x1.mean(axis=0), x2.mean(axis=0)
    s1, s2 = _cov(x1), _cov(x2)
    tr = float(np.trace(s1 + s2)) - 2.0 * trace_sqrt_product(s1, s2)
    return tr + float(np.sum((m1 - m2) ** 2))
