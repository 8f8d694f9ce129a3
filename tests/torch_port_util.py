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


def reference_state_dict(cfg, seed: int = 0) -> dict:
    """A state_dict in the reference's key scheme for `cfg` (the keys and
    shapes of tests/test_checkpoint.py's synthetic_torch_state_dict), with
    random values at a trained model's scales: LeCun-normal weights, norms
    and scales near 1, small biases, an N(0, 1) codebook."""
    from test_checkpoint import synthetic_torch_state_dict

    rng = np.random.RandomState(seed)
    sd = synthetic_torch_state_dict(cfg)
    if cfg.use_vae:  # the posterior's mean and log-variance
        d = cfg.embedding_dim
        sd["pre_vq_conv.1.weight"] = np.zeros((2 * cfg.codebook_dim, d), np.float32)
        sd["pre_vq_conv.1.bias"] = np.zeros((2 * cfg.codebook_dim,), np.float32)
    out = {}
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if v.dtype != np.float32 or leaf in ("beta", "N", "codebook_usage", "z_avg"):
            out[k] = v
        elif leaf == "embeddings":
            out[k] = rng.standard_normal(v.shape)
        elif v.ndim >= 2:  # Linear and depthwise conv weights, bias tables
            fan_in = int(np.prod(v.shape[1:])) if "bias_table" not in k else 50
            out[k] = rng.standard_normal(v.shape) / np.sqrt(fan_in)
        elif leaf in ("weight", "gamma", "q_scale", "k_scale"):
            out[k] = 1 + 0.1 * rng.standard_normal(v.shape)
        else:
            out[k] = 0.02 * rng.standard_normal(v.shape)
        out[k] = np.asarray(out[k], v.dtype)
    if "codebook.embeddings" in out:
        out["codebook.z_avg"] = out["codebook.embeddings"].copy()
    return out


def write_lightning_ckpt(path, sd: dict, **hparams) -> None:
    """A Lightning-style checkpoint: the state_dict and the argparse
    Namespace of the run under hyper_parameters.args."""
    import argparse

    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "hyper_parameters": {"args": argparse.Namespace(**hparams)}}, str(path))
