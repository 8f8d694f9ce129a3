"""The port's VAE mode and diffusion adapter against the JAX package's, in
f32 on the same weights through the bridge. The JAX side runs without a
`gaussian` rng, which gives the posterior's mode; sampled latents come from
different generators in the two packages, so decode parity is held on the
same latents."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.models.diffusion_adapter import DiffusionVAEAdapter as JaxAdapter
from omnitokenizer_tpu.models.wrapper import OmniTokenizerVQGAN as JaxVQGAN
from omnitokenizer_tpu_torch import DiffusionVAEAdapter, OmniTokenizerVQGAN
from omnitokenizer_tpu_torch import TokenizerConfig as TorchConfig
from omnitokenizer_tpu_torch.convert import state_dict_from_jax
from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet

from torch_port_util import configs, to_numpy_tree, torch_f32

torch.set_num_threads(1)

PIX = dict(atol=2e-4, rtol=1e-3)


def _bridge(jm, tcfg):
    net = OmniTokenizerNet(tcfg)
    net.load_state_dict(state_dict_from_jax(to_numpy_tree(jm.variables), net))
    return OmniTokenizerVQGAN(tcfg, net)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs(use_vae=True)
    jm = JaxVQGAN.from_config(jcfg, seed=0)
    return jm, _bridge(jm, tcfg)


def _pixels(is_image, seed=1):
    shape = (2, 3, 32, 32) if is_image else (2, 3, 5, 32, 32)
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _channels_last(x, is_image):
    return x.transpose(0, 2, 3, 1)[:, None] if is_image else x.transpose(0, 2, 3, 4, 1)


@pytest.mark.parametrize("is_image", [False, True], ids=["video", "image"])
def test_vae_round_trip_matches_jax(pair, is_image):
    jm, tm = pair
    xl = _channels_last(_pixels(is_image), is_image)
    apply = jax.jit(jm.net.apply, static_argnums=2)
    recon_j, aux_j = apply(jm.variables, jnp.asarray(xl), is_image)
    with torch.no_grad():
        recon_t, aux_t = tm.net(torch_f32(xl), is_image)
        z_t = tm.net.encode(torch_f32(xl), is_image).numpy()
    # with no rng the JAX encode returns the mode, the posterior's mean
    z_j = np.asarray(aux_j["posterior"].mean)
    assert z_t.shape == z_j.shape == (2, 1 if is_image else 3, 4, 4, 8)
    np.testing.assert_allclose(z_t, z_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(recon_t.numpy(), np.asarray(recon_j), **PIX)
    for key in ("kl_loss", "commitment_loss"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), rtol=1e-4)
    for name in ("mean", "logvar"):
        np.testing.assert_allclose(getattr(aux_t["posterior"], name).numpy(),
                                   np.asarray(getattr(aux_j["posterior"], name)), atol=1e-5)


@pytest.mark.parametrize("is_image", [False, True], ids=["video_channels_last",
                                                       "image_channels_first"])
def test_wrapper_decode_matches_jax(pair, is_image):
    """Image latents go in channels-first, video latents channels-last."""
    jm, tm = pair
    rng = np.random.RandomState(2)
    z = rng.randn(*((2, 8, 4, 4) if is_image else (2, 3, 4, 4, 8))).astype(np.float32)
    want = np.asarray(jm.decode(jnp.asarray(z), is_image))
    got = tm.decode(torch_f32(z), is_image).numpy()
    assert got.shape == ((2, 3, 32, 32) if is_image else (2, 3, 5, 32, 32))
    np.testing.assert_allclose(got, want, **PIX)
    if not is_image:  # the flat (B, N, c) form decodes the same
        flat = tm.decode(torch_f32(z.reshape(2, -1, 8)), is_image).numpy()
        np.testing.assert_array_equal(flat, got)


def test_wrapper_encode_samples_with_its_seed(pair):
    _, tm = pair
    x = torch_f32(_pixels(False))
    a, b = tm.encode(x, False, seed=3), tm.encode(x, False, seed=3)
    assert a.shape == (2, 8, 3, 4, 4) and torch.equal(a, b)
    assert not torch.equal(a, tm.encode(x, False, seed=4))
    mode = tm.net.encode(x.permute(0, 2, 3, 4, 1), False).permute(0, 4, 1, 2, 3)
    assert not torch.equal(a, mode)
    assert tm.encode(torch_f32(_pixels(True)), True).shape == (2, 8, 4, 4)
    recon, aux = tm.reconstruct(x, False)
    assert recon.shape == x.shape and set(aux) == {"commitment_loss", "kl_loss", "posterior"}


def test_vae_bridge_is_strict(pair):
    jm, tm = pair
    tree = to_numpy_tree(jm.variables)
    assert set(tree) == {"params"}
    assert set(tree["params"]) == {"encoder", "pre_vq_conv", "post_vq_conv", "decoder"}
    assert tree["params"]["pre_vq_conv"]["kernel"].shape == (64, 16)
    assert tm.net.codebook is None
    assert not any(k.startswith("codebook") for k in tm.net.state_dict())
    del tree["params"]["pre_vq_conv"]["bias"]
    with pytest.raises(KeyError, match="pre_vq_conv.bias"):
        state_dict_from_jax(tree, OmniTokenizerNet(tm.cfg))


# the config of tests/test_datasets.py::test_diffusion_adapter
ADAPTER = dict(embedding_dim=32, n_codes=64, codebook_dim=8, resolution=32, sequence_length=5,
               patch_size=4, temporal_patch_size=2, enc_block="tw", dec_block="tt",
               spatial_depth=2, temporal_depth=2, twod_window_size=4, dim_head=8, heads=4,
               spatial_pos="rope", use_vae=True)


def test_diffusion_adapter_shapes():
    """The shapes tests/test_datasets.py holds the JAX adapter to."""
    ad = DiffusionVAEAdapter.from_config(TorchConfig(**ADAPTER), seed=0, device="cpu")
    assert ad.latent_channels == 8
    assert ad.latent_shape(True) == (8, 8, 8) and ad.latent_shape(False) == (8, 3, 8, 8)
    x = torch_f32(np.random.RandomState(0).randn(1, 3, 32, 32) * 0.2)
    z = ad.encode(x, is_image=True)
    assert tuple(z.shape) == (1, 8, 8, 8)
    assert tuple(ad.decode(z, is_image=True).shape) == (1, 3, 32, 32)
    v = torch_f32(np.random.RandomState(1).randn(1, 3, 5, 32, 32) * 0.2)
    zv = ad.encode(v, is_image=False)
    assert tuple(zv.shape) == (1, *ad.latent_shape(False))
    assert tuple(ad.decode(zv, is_image=False).shape) == (1, 3, 5, 32, 32)
    with pytest.raises(ValueError, match="use_vae"):
        DiffusionVAEAdapter(OmniTokenizerVQGAN.from_config(
            TorchConfig(**{**ADAPTER, "use_vae": False}), device="cpu"))


@pytest.mark.parametrize("is_image", [False, True], ids=["video", "image"])
def test_diffusion_adapter_decode_matches_jax(pair, is_image):
    jm, tm = pair
    shape = (2, 8, 4, 4) if is_image else (2, 8, 3, 4, 4)
    z = (np.random.RandomState(3).randn(*shape) * 0.18215).astype(np.float32)
    want = np.asarray(JaxAdapter(jm).decode(jnp.asarray(z), is_image))
    got = DiffusionVAEAdapter(tm).decode(torch_f32(z), is_image).numpy()
    np.testing.assert_allclose(got, want, **PIX)
