"""Timestep samplers for diffusion training (mirror of
`omnitokenizer_tpu.diffusion.timestep_sampler`): uniform, and importance
sampling by the square root of each timestep's loss second moment (a
history of 10 losses a timestep, 0.001 of uniform mixed in).

They run on the host in numpy, on the caller's `np.random.RandomState`, so
one seed draws the same timesteps and weights as the JAX package's copy.
"""

from __future__ import annotations

import numpy as np


class ScheduleSampler:
    """A distribution over timesteps meant to reduce the loss's variance."""

    def weights(self) -> np.ndarray:  # (T,) unnormalized
        raise NotImplementedError

    def sample(self, batch_size: int, rng: np.random.RandomState):
        """-> (indices (B,) int64, importance weights (B,) float32)."""
        w = self.weights()
        p = w / w.sum()
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[indices])
        return indices.astype(np.int64), weights.astype(np.float32)

    def update_with_all_losses(self, ts, losses) -> None:
        pass


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self._weights = np.ones([num_timesteps])

    def weights(self) -> np.ndarray:
        return self._weights


class LossSecondMomentResampler(ScheduleSampler):
    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros([num_timesteps, history_per_term], dtype=np.float64)
        self._loss_counts = np.zeros([num_timesteps], dtype=np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        w = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / len(w)

    def update_with_all_losses(self, ts, losses) -> None:
        for t, loss in zip(np.asarray(ts).tolist(), np.asarray(losses).tolist()):
            if self._loss_counts[t] == self.history_per_term:
                # shift out the oldest loss
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1


def create_named_schedule_sampler(name: str, num_timesteps: int) -> ScheduleSampler:
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
