"""Latent diffusion (mirror of `omnitokenizer_tpu.diffusion`): the Gaussian
process with respacing, its losses and samplers, and the timestep samplers.
Tensors are channels-first, as the reference's DiT and Latte are."""

from .gaussian import (GaussianDiffusion, LossType, MeanType, VarType, create_diffusion,
                       get_named_beta_schedule, space_timesteps)
from .timestep_sampler import (LossSecondMomentResampler, UniformSampler,
                               create_named_schedule_sampler)

__all__ = ["GaussianDiffusion", "LossType", "MeanType", "VarType", "create_diffusion",
           "get_named_beta_schedule", "space_timesteps", "UniformSampler",
           "LossSecondMomentResampler", "create_named_schedule_sampler"]
