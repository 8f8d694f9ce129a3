"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: a small config for both sides and the flax -> numpy tree."""

from __future__ import annotations

import jax
import numpy as np
import torch

from omnitokenizer_tpu.config import TokenizerConfig as JaxConfig
from omnitokenizer_tpu_torch.config import TokenizerConfig as TorchConfig

# 2 spatial blocks (one 't', one 'w'), 2 temporal, width 64, 2 heads of 32,
# a 4x4 token grid with 2x2 windows, 64 codes
SMALL = dict(embedding_dim=64, n_codes=64, resolution=32, sequence_length=5,
             patch_size=8, temporal_patch_size=2, enc_block="tw", dec_block="tt",
             spatial_depth=2, temporal_depth=2, twod_window_size=2, heads=2,
             dim_head=32)


def configs(**kw):
    """The same small f32 config for the JAX package and the port."""
    jcfg = JaxConfig(**SMALL, **kw)
    tcfg = TorchConfig(**SMALL, **kw)
    return jcfg, tcfg


def to_numpy_tree(variables) -> dict:
    """flax variables -> nested dicts of numpy arrays."""
    if hasattr(variables, "items"):
        return {k: to_numpy_tree(v) for k, v in variables.items()}
    return np.asarray(jax.device_get(variables))


def torch_f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
