"""The port's checkpoint loading against the JAX package's: a Lightning-style
checkpoint in the reference's key scheme (random values, written to
tmp_path) loads into the port with every tensor bit-equal to the JAX
route (its load_tokenizer_checkpoint, then convert.state_dict_from_jax),
and its f32 round trip gives the JAX indices exactly and pixels within
2e-4. Also the config from the hparams, the port's own checkpoint files,
the wrapper's info, the diffusion adapter, and a cnn tokenizer's .ckpt
and msgpack (BatchNorm statistics included)."""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

from omnitokenizer_tpu.config import TokenizerConfig as JaxConfig
from omnitokenizer_tpu.models.wrapper import OmniTokenizerVQGAN as JaxVQGAN
from omnitokenizer_tpu.utils.checkpoint import config_from_args as jax_config_from_args
from omnitokenizer_tpu.utils.checkpoint import load_tokenizer_checkpoint as jax_load
from omnitokenizer_tpu_torch import DiffusionVAEAdapter, OmniTokenizerVQGAN
from omnitokenizer_tpu_torch import TokenizerConfig as TorchConfig
from omnitokenizer_tpu_torch.convert import state_dict_from_jax
from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet
from omnitokenizer_tpu_torch.utils import checkpoint as ck

from torch_port_util import reference_state_dict, to_numpy_tree, write_lightning_ckpt

torch.set_num_threads(1)

# tests/test_checkpoint.py's SMALL (heads of 8, a 8x8 token grid, 4x4 windows)
SMALL = dict(embedding_dim=32, n_codes=64, codebook_dim=8, resolution=32, sequence_length=5,
             patch_size=4, temporal_patch_size=2, enc_block="tw", dec_block="tt",
             spatial_depth=2, temporal_depth=2, twod_window_size=4, dim_head=8, heads=4,
             spatial_pos="rope")
VARIANTS = {"rope": {}, "rel": dict(spatial_pos="rel"), "l2": dict(l2_code=True),
            "vae": dict(use_vae=True)}
PIX = dict(atol=2e-4, rtol=1e-3)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


def _hparams(**kw) -> dict:
    """The run's Namespace: every field config_from_args reads."""
    cfg = JaxConfig(**{**SMALL, **kw})
    return {k: v for k, v in _fields(cfg).items()
            if k not in ("attn_dropout", "ff_dropout", "initialize_vit", "fp32_quant",
                         "attn_bias_mode", "fast_patchify", "flat_temporal")}


@pytest.fixture(scope="module", params=list(VARIANTS))
def ckpt(request, tmp_path_factory):
    kw = VARIANTS[request.param]
    cfg = JaxConfig(**{**SMALL, **kw})
    path = tmp_path_factory.mktemp(request.param) / "tok.ckpt"
    write_lightning_ckpt(path, reference_state_dict(cfg, seed=3), **_hparams(**kw))
    jcfg, variables = jax_load(str(path))
    return str(path), jcfg, variables


def test_reference_checkpoint_loads_bit_equal_to_jax(ckpt):
    path, jcfg, variables = ckpt
    model = OmniTokenizerVQGAN.load_from_checkpoint(path, device="cpu")
    assert _fields(model.cfg) == _fields(jcfg)
    assert model.unfilled == []  # every port parameter and buffer came from the file
    want = state_dict_from_jax(to_numpy_tree(variables), OmniTokenizerNet(model.cfg))
    got = model.net.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_reference_checkpoint_round_trip_matches_jax(ckpt):
    path, jcfg, variables = ckpt
    model = OmniTokenizerVQGAN.load_from_checkpoint(path, device="cpu")
    jm = JaxVQGAN(jcfg, variables)
    x = np.random.RandomState(1).uniform(-0.5, 0.5, (2, 3, 5, 32, 32)).astype(np.float32)
    if jcfg.use_vae:  # the JAX encode without a sample's noise: compare the decode of one z
        z = np.random.RandomState(2).standard_normal((2, 3, 8, 8, 8)).astype(np.float32)
        np.testing.assert_allclose(model.decode(torch.from_numpy(z), False).numpy(),
                                   np.asarray(jm.decode(z, False)), **PIX)
        return
    idx_j = np.asarray(jm.encode(x, is_image=False))
    idx_t = model.encode(x, is_image=False).numpy()
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(model.decode(idx_t, is_image=False).numpy(),
                               np.asarray(jm.decode(idx_j, is_image=False)), **PIX)


@pytest.mark.parametrize("hp", [{}, dict(spatial_depth=2), _hparams(),
                                dict(_hparams(use_vae=True), causal_in_peg=True)],
                         ids=["defaults", "depth_only", "small", "vae"])
def test_config_from_args_matches_jax(hp):
    ns = argparse.Namespace(**hp)
    assert _fields(ck.config_from_args(ns)) == _fields(jax_config_from_args(ns))


def test_wrapper_info_matches_jax(ckpt):
    path, jcfg, variables = ckpt
    model = OmniTokenizerVQGAN.load_from_checkpoint(path, device="cpu")
    jm = JaxVQGAN(jcfg, variables)
    assert model.latent_shape == jm.latent_shape
    assert model.num_params() == jm.num_params()


def test_training_and_saved_checkpoints_load_back(tmp_path):
    from omnitokenizer_tpu_torch.config import LossConfig
    from omnitokenizer_tpu_torch.training.loop import save_state
    from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer

    cfg = TorchConfig(**SMALL)
    state = TokenizerTrainer(cfg, LossConfig(disc_layers=1, disc_channels=8),
                             device="cpu").init_state(seed=5)
    step = str(tmp_path / "checkpoints" / "step_00000000.pt")
    save_state(step, state)
    with pytest.raises(ValueError, match="carries no config"):
        OmniTokenizerVQGAN.load_from_checkpoint(step, device="cpu")
    loaded = OmniTokenizerVQGAN.load_from_checkpoint(step, cfg=cfg, device="cpu")
    assert loaded.unfilled == []
    for k, v in state.net.state_dict().items():
        assert torch.equal(loaded.net.state_dict()[k], v), k

    saved = str(tmp_path / "tok.pt")
    ck.save_tokenizer_checkpoint(saved, loaded.net, cfg)
    again = OmniTokenizerVQGAN.load_from_checkpoint(saved, device="cpu")  # cfg from the sidecar
    assert again.cfg == cfg and again.unfilled == []
    for k, v in state.net.state_dict().items():
        assert torch.equal(again.net.state_dict()[k], v), k


def test_strict_and_partial_loads(tmp_path):
    cfg = JaxConfig(**SMALL)
    sd = reference_state_dict(cfg)
    dropped = "decoder.to_pixels.0.bias"
    del sd[dropped]
    path = tmp_path / "partial.ckpt"
    write_lightning_ckpt(path, sd, **_hparams())
    model = OmniTokenizerVQGAN.load_from_checkpoint(str(path), device="cpu")
    assert model.unfilled == ["decoder.to_pixels.bias"]
    with pytest.raises(KeyError, match="missing checkpoint values"):
        OmniTokenizerVQGAN.load_from_checkpoint(str(path), device="cpu", strict=True)


def test_diffusion_adapter_loads_a_vae_checkpoint(tmp_path):
    cfg = JaxConfig(**SMALL, use_vae=True)
    path = tmp_path / "vae.ckpt"
    write_lightning_ckpt(path, reference_state_dict(cfg), **_hparams(use_vae=True))
    ad = DiffusionVAEAdapter.load_from_checkpoint(str(path), device="cpu")
    z = ad.encode(torch.zeros(1, 3, 32, 32), is_image=True)
    assert tuple(z.shape) == (1, 8, 8, 8)


def cnn_reference_state_dict(cfg, seed: int = 6) -> dict:
    """The reference's keys of a cnn tokenizer: the linear patch embed's and
    to-pixels' keys replaced by the Conv3d + Normalize and ConvTranspose3d +
    Normalize Sequentials, random values, running statistics away from 0
    and 1."""
    rng = np.random.RandomState(seed)
    d, c, p, pt = cfg.embedding_dim, cfg.image_channels, cfg.patch_size, cfg.temporal_patch_size
    new = {}

    def norm(prefix, n):
        new[f"{prefix}.weight"] = 1 + 0.1 * rng.standard_normal(n)
        new[f"{prefix}.bias"] = 0.1 * rng.standard_normal(n)
        new[f"{prefix}.running_mean"] = 0.1 * rng.standard_normal(n)
        new[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, n)

    for sub, kt in (("to_patch_emb_first_frame", 1), ("to_patch_emb", pt)):
        new[f"encoder.{sub}.0.weight"] = rng.standard_normal((d, c, kt, p, p)) / np.sqrt(c * kt * p * p)
        new[f"encoder.{sub}.0.bias"] = 0.1 * rng.standard_normal(d)
        norm(f"encoder.{sub}.1", d)
    for sub, kt in (("to_pixels_first_frame", 1), ("to_pixels", pt)):
        new[f"decoder.{sub}.1.weight"] = rng.standard_normal((d, c, kt, p, p)) / np.sqrt(d)
        new[f"decoder.{sub}.1.bias"] = 0.1 * rng.standard_normal(c)
        norm(f"decoder.{sub}.2", c)
    sd = {k: v for k, v in reference_state_dict(cfg).items()
          if not k.startswith(("encoder.to_patch_emb", "decoder.to_pixels"))}
    sd.update({k: np.asarray(v, np.float32) for k, v in new.items()})
    sd["encoder.to_patch_emb.1.num_batches_tracked"] = np.asarray(7, np.int64)
    return sd


def test_cnn_checkpoint_raises(tmp_path):
    """A cnn tokenizer (BatchNorm) as a reference .ckpt loads with every
    tensor bit-equal to the JAX route's, running statistics included, and
    its f32 round trip equals the JAX one's; the same weights as a JAX
    msgpack with batch_stats load bit-equal in the port and in the JAX
    package. A strict load raises for a missing running statistic."""
    from omnitokenizer_tpu.utils.checkpoint import save_tokenizer_checkpoint as jax_save
    from omnitokenizer_tpu_torch.convert import state_dict_to_jax
    from omnitokenizer_tpu_torch.utils.msgpack_io import write_msgpack

    hp = _hparams(patch_embed="cnn")
    sd = cnn_reference_state_dict(JaxConfig(**SMALL, patch_embed="cnn"))
    path = tmp_path / "cnn.ckpt"
    write_lightning_ckpt(path, sd, **hp)
    jcfg, variables = jax_load(str(path), strict=True)
    model = OmniTokenizerVQGAN.load_from_checkpoint(str(path), device="cpu", strict=True)
    assert model.cfg.patch_embed == "cnn" and model.unfilled == []
    want = state_dict_from_jax(to_numpy_tree(variables), OmniTokenizerNet(model.cfg))
    got = model.net.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    np.testing.assert_array_equal(
        got["decoder.to_pixels_conv_cnorm.norm.var"].numpy(),
        sd["decoder.to_pixels.2.running_var"])
    jm = JaxVQGAN(jcfg, variables)
    x = np.random.RandomState(1).uniform(-0.5, 0.5, (2, 3, 5, 32, 32)).astype(np.float32)
    idx_j = np.asarray(jm.encode(x, is_image=False))
    np.testing.assert_array_equal(model.encode(x, is_image=False).numpy(), idx_j)
    np.testing.assert_allclose(model.decode(idx_j, is_image=False).numpy(),
                               np.asarray(jm.decode(idx_j, is_image=False)), **PIX)

    mp = str(tmp_path / "cnn.msgpack")
    tree = state_dict_to_jax(model.net)
    assert set(tree) == {"params", "buffers", "batch_stats"}
    write_msgpack(mp, tree)
    with open(mp + ".cfg.json", "w") as f:
        json.dump(ck.config_to_json(model.cfg), f)
    again = OmniTokenizerVQGAN.load_from_checkpoint(mp, device="cpu")
    for k, v in got.items():
        assert torch.equal(again.net.state_dict()[k], v), k
    _, jax_vars = jax_load(mp)
    for k, v in state_dict_from_jax(to_numpy_tree(jax_vars), OmniTokenizerNet(model.cfg)).items():
        assert torch.equal(v, got[k]), k
    jax_mp = str(tmp_path / "jax_cnn.msgpack")
    jax_save(jax_mp, variables, jcfg)  # the JAX package's own writer
    from_jax = OmniTokenizerVQGAN.load_from_checkpoint(jax_mp, device="cpu")
    for k, v in got.items():
        assert torch.equal(from_jax.net.state_dict()[k], v), k

    del sd["encoder.to_patch_emb.1.running_var"]
    write_lightning_ckpt(path, sd, **hp)
    with pytest.raises(KeyError, match="to_patch_emb_cnorm.norm.var"):
        OmniTokenizerVQGAN.load_from_checkpoint(str(path), device="cpu", strict=True)


def test_cuda_default_raises_without_a_card(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OmniTokenizerVQGAN.load_from_checkpoint(ckpt[0])
