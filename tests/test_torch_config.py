"""The port's TokenizerConfig, GPTConfig and Net2NetConfig mirror the JAX
package's field for field."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from omnitokenizer_tpu import config as jax_config
from omnitokenizer_tpu_torch import config as torch_config


def test_tokenizer_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jax_config.TokenizerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(torch_config.TokenizerConfig)}
    assert list(tf) == list(jf)
    for name, default in jf.items():
        if name == "dtype":
            assert default == jnp.float32 and tf[name] == torch.float32
        else:
            assert tf[name] == default, name


def test_flagship_preset_matches():
    j, t = jax_config.imagenet_k600_config(), torch_config.imagenet_k600_config()
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.latent_t, t.latent_hw) == (j.latent_t, j.latent_hw) == (5, 32)


def test_imagenet_only_preset_matches():
    j, t = jax_config.imagenet_only_config(), torch_config.imagenet_only_config()
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.temporal_patch_size, t.spatial_pos) == (2, "rel")
    assert (t.latent_t, t.latent_hw) == (j.latent_t, j.latent_hw) == (9, 32)


@pytest.mark.parametrize("name", ["GPTConfig", "Net2NetConfig"])
def test_lm_config_fields_and_defaults_match(name):
    """The LM's configs: the same fields in the same order with the same
    defaults (a nested GPTConfig compared field for field)."""
    jc, tc = getattr(jax_config, name)(), getattr(torch_config, name)()
    jf, tf = dataclasses.fields(jc), dataclasses.fields(tc)
    assert [f.name for f in tf] == [f.name for f in jf]
    for f in jf:
        j, t = getattr(jc, f.name), getattr(tc, f.name)
        if f.name == "dtype":
            assert j == jnp.float32 and t == torch.float32
        elif f.name == "gpt":
            assert {g.name: getattr(t, g.name) for g in dataclasses.fields(t) if g.name != "dtype"} \
                == {g.name: getattr(j, g.name) for g in dataclasses.fields(j) if g.name != "dtype"}
        else:
            assert t == j, f.name
