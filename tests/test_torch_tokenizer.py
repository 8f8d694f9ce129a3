"""The port's whole VQ round trip against the JAX package's
OmniTokenizerNet in f32, on the same weights through the bridge: the
flagship's RoPE spatial positions, and the stage-1 tokenizer's 'rel'
positions (imagenet_only_config: temporal patch 2, the CPB parameters)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.models.wrapper import OmniTokenizerVQGAN as JaxVQGAN
from omnitokenizer_tpu_torch import OmniTokenizerVQGAN
from omnitokenizer_tpu_torch.convert import state_dict_from_jax
from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet

from torch_port_util import configs, to_numpy_tree, torch_f32

torch.set_num_threads(1)


def _pair(**kw):
    jcfg, tcfg = configs(**kw)
    jm = JaxVQGAN.from_config(jcfg, seed=0)
    net = OmniTokenizerNet(tcfg)
    net.load_state_dict(state_dict_from_jax(to_numpy_tree(jm.variables), net))
    return jm, OmniTokenizerVQGAN(tcfg, net)


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def rel_pair():
    """The small config with 'rel' spatial positions; SMALL already has
    imagenet_only_config's temporal patch 2."""
    return _pair(spatial_pos="rel")


@pytest.mark.parametrize("is_image", [False, True], ids=["video", "image"])
def test_round_trip_matches_jax(pair, is_image):
    jm, tm = pair
    rng = np.random.RandomState(1)
    shape = (2, 3, 32, 32) if is_image else (2, 3, 5, 32, 32)
    x = rng.uniform(-1, 1, shape).astype(np.float32)

    idx_j = np.asarray(jm.encode(jnp.asarray(x), is_image))
    idx_t = tm.encode(torch_f32(x), is_image).numpy()
    np.testing.assert_array_equal(idx_t, idx_j)

    recon_j, aux_j = jm.reconstruct(jnp.asarray(x), is_image)
    recon_t, aux_t = tm.reconstruct(torch_f32(x), is_image)
    np.testing.assert_allclose(recon_t.numpy(), np.asarray(recon_j), atol=2e-4, rtol=1e-3)
    np.testing.assert_array_equal(aux_t["encodings"].numpy(), np.asarray(aux_j["encodings"]))
    for key in ("commitment_loss", "perplexity", "avg_usage"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), atol=1e-5, rtol=1e-4)

    dec_j = np.asarray(jm.decode(jnp.asarray(idx_j), is_image))
    dec_t = tm.decode(torch.tensor(idx_j), is_image).numpy()
    np.testing.assert_allclose(dec_t, dec_j, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("is_image", [False, True], ids=["video", "image"])
def test_flat_and_grid_decode_agree(pair, is_image):
    _, tm = pair
    t = 1 if is_image else tm.cfg.latent_t
    grid = torch.from_numpy(
        np.random.RandomState(2).randint(0, tm.cfg.n_codes, (2, t, 4, 4)).astype(np.int32))
    np.testing.assert_array_equal(tm.decode(grid, is_image).numpy(),
                                  tm.decode(grid.reshape(2, -1), is_image).numpy())


def test_bridge_is_strict(pair):
    jm, tm = pair
    tree = to_numpy_tree(jm.variables)
    net = OmniTokenizerNet(tm.cfg)
    tree["params"]["encoder"]["extra_leaf"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra_leaf"):
        state_dict_from_jax(tree, net)
    del tree["params"]["encoder"]["extra_leaf"]
    del tree["params"]["post_vq_conv"]["bias"]
    with pytest.raises(KeyError, match="post_vq_conv.bias"):
        state_dict_from_jax(tree, net)


@pytest.mark.parametrize("is_image", [False, True], ids=["video", "image"])
def test_rel_round_trip_matches_jax(rel_pair, is_image):
    jm, tm = rel_pair
    cpb = [k for k in tm.net.state_dict() if ".spatial_rel_pos_bias." in k]
    # net0..net2 weight and bias in each spatial 't' block: encoder 'tw', decoder 'tt'
    assert len(cpb) == 18 and all("spatial_transformer" in k for k in cpb)
    x = np.random.RandomState(3).uniform(-1, 1, (2, 3, 32, 32) if is_image
                                         else (2, 3, 5, 32, 32)).astype(np.float32)
    recon_j, aux_j = jm.reconstruct(jnp.asarray(x), is_image)
    recon_t, aux_t = tm.reconstruct(torch_f32(x), is_image)
    np.testing.assert_array_equal(aux_t["encodings"].numpy(), np.asarray(aux_j["encodings"]))
    np.testing.assert_allclose(recon_t.numpy(), np.asarray(recon_j), atol=2e-4, rtol=1e-3)
