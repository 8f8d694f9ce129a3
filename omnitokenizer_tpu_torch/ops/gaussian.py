"""Diagonal Gaussian posterior of VAE mode (mirror of
`omnitokenizer_tpu.ops.gaussian`), over channels-last parameter tensors.

Sampling takes an explicit `torch.Generator` or the noise itself. A
generator does not give `jax.random`'s numbers for the same seed, so a test
that compares the two packages hands both the same noise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_params(cls, params: torch.Tensor, dim: int = -1) -> "DiagonalGaussian":
        mean, logvar = params.chunk(2, dim=dim)
        return cls(mean=mean, logvar=logvar.clamp(-30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise; the noise is N(0, 1) in f32 from `generator`
        (on the mean's device) unless given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=torch.float32)
        return self.mean + self.std * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """Per-sample KL to N(0, I), summed over every non-batch axis."""
        m = self.mean.float()
        return 0.5 * (m.square() + self.var.float() - 1.0 - self.logvar.float()).sum(
            dim=tuple(range(1, m.ndim)))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        return 0.5 * (math.log(2.0 * math.pi) + self.logvar
                      + (sample - self.mean).square() / self.var).sum(
            dim=tuple(range(1, self.mean.ndim)))
