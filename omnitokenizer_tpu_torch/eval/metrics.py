"""Pixel metrics, PSNR and SSIM, as torch functions on the inputs' device
(mirror of `omnitokenizer_tpu.eval.metrics`): the standard formulations,
SSIM with an 11x11 Gaussian window of sigma 1.5, K1 = 0.01, K2 = 0.03 and
VALID filtering (no padding)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-sample PSNR over all non-batch axes; inputs on the same scale."""
    mse = (x - y).square().mean(dim=tuple(range(1, x.ndim)))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-0.5 * ((np.arange(size) - size // 2) / sigma) ** 2)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-sample mean SSIM of (B, H, W, C) images."""
    c = x.shape[-1]
    k = torch.from_numpy(_gaussian_kernel()).to(x.device, x.dtype).expand(c, 1, 11, 11)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2

    def filt(img: torch.Tensor) -> torch.Tensor:  # depthwise, VALID
        return F.conv2d(img, k, groups=c)

    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    mu_x, mu_y = filt(x), filt(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = filt(x * x) - mu_x2
    sig_y = filt(y * y) - mu_y2
    sig_xy = filt(x * y) - mu_xy
    s = ((2 * mu_xy + c1) * (2 * sig_xy + c2)) / ((mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2))
    return s.mean(dim=(1, 2, 3))
