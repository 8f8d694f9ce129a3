"""GAN and reconstruction losses (mirror of `omnitokenizer_tpu.training.losses`).

Each loss is an f32 scalar whatever its inputs' type: a bf16 mean near 1
moves in steps of 2^-7. The JAX functions return their inputs' type; the
discriminator logits are cast (they are small) and the L1, L2 and
logit-laplace terms reduce in f32 over their inputs' differences."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    logits_real, logits_fake = logits_real.float(), logits_fake.float()
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    logits_real, logits_fake = logits_real.float(), logits_fake.float()
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def logits_laplace(x: torch.Tensor, x_recon: torch.Tensor, eps: float = 0.1) -> torch.Tensor:
    """L1 in logit-laplace space; inputs in [-0.5, 0.5]."""
    xl = (1 - 2 * eps) * (x + 0.5) + eps
    rl = (1 - 2 * eps) * (x_recon + 0.5) + eps
    return (xl - rl).abs().mean(dtype=torch.float32)


def adopt_weight(step: int, threshold: int = 0, value: float = 0.0) -> float:
    """1.0 once step >= threshold, else `value` (the discriminator's warm-up)."""
    return value if step < threshold else 1.0


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean(dtype=torch.float32)


def l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).square().mean(dtype=torch.float32)
