"""The port's Net2NetTransformer (serving half) against the JAX package's in
f32 on the CPU, over the small tokenizer of torch_port_util.SMALL (a 4x4
token grid, 3 latent frames, 64 codes) and a small GPT, the same random
weights on both sides: build_sequence, encode_to_z and encode_to_c equal;
class-conditional ids (CFG, no CFG, unconditional) and frame-prediction
ids equal at top_k=1 (a draw that is the greedy token on both sides), and
the pixels decoded from them within 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.config import Net2NetConfig as JaxN2NConfig
from omnitokenizer_tpu.models.net2net import Net2NetTransformer as JaxN2N
from omnitokenizer_tpu.models.wrapper import OmniTokenizerVQGAN as JaxVQGAN
from omnitokenizer_tpu_torch import OmniTokenizerVQGAN
from omnitokenizer_tpu_torch.config import Net2NetConfig
from omnitokenizer_tpu_torch.convert import state_dict_from_jax
from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer
from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet

from torch_port_util import configs, gpt_pair, to_numpy_tree

torch.set_num_threads(2)
PIX = dict(atol=2e-4, rtol=1e-3)
CLASSES = 10


@pytest.fixture(scope="module")
def tokenizers():
    jcfg, tcfg = configs()
    jm = JaxVQGAN.from_config(jcfg, seed=0)
    net = OmniTokenizerNet(tcfg)
    net.load_state_dict(state_dict_from_jax(to_numpy_tree(jm.variables), net))
    return jm, OmniTokenizerVQGAN(tcfg, net)


def _pair(tokenizers, unconditional=False, starts_with_sos=True, class_first=False,
          block_size=24, **kw):
    """(JAX Net2Net, port Net2Net) on the same tokenizer and GPT weights."""
    jm, tm = tokenizers
    vocab = 64 + (0 if unconditional else CLASSES + int(starts_with_sos))
    jg, params, tg, gpt = gpt_pair(1, vocab_size=vocab, block_size=block_size)
    args = dict(class_cond_dim=CLASSES, first_stage_vocab_size=64, unconditional=unconditional,
                starts_with_sos=starts_with_sos, class_first=class_first, **kw)
    return (JaxN2N(JaxN2NConfig(gpt=jg, **args), jm, gpt_params=params),
            Net2NetTransformer(Net2NetConfig(gpt=tg, **args), tm, gpt=gpt))


def _video(shape, seed=0):
    return np.random.RandomState(seed).uniform(-0.5, 0.5, shape).astype(np.float32)


@pytest.mark.parametrize("variant", ["sos", "sos-class-first", "no-sos", "unconditional"])
def test_build_sequence_matches_jax(tokenizers, variant):
    kw = {"sos": {}, "sos-class-first": dict(class_first=True),
          "no-sos": dict(starts_with_sos=False), "unconditional": dict(unconditional=True)}
    jn, tn = _pair(tokenizers, **kw[variant])
    assert tn.cfg.starts_with_sos == jn.cfg.starts_with_sos
    assert (tn.cond_vocab, tn.z_offset) == (jn.cond_vocab, jn.z_offset)
    rng = np.random.RandomState(1)
    z = rng.randint(0, 64, (3, 16))
    for labels in (rng.randint(0, CLASSES, (3,)), rng.randint(0, CLASSES, (3, 2))):
        want = jn.build_sequence(jnp.asarray(z), jnp.asarray(labels))
        got = tn.build_sequence(torch.from_numpy(z), torch.from_numpy(labels))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2] == want[2]


@pytest.mark.parametrize("every", [0, 2])
def test_encode_to_z_and_c_match_jax(tokenizers, every):
    jn, tn = _pair(tokenizers, sample_every_n_latent_frames=every)
    for shape, is_image in (((2, 3, 5, 32, 32), False), ((2, 3, 32, 32), True)):
        x = _video(shape)
        want = np.asarray(jn.encode_to_z(jnp.asarray(x), is_image))
        got = tn.encode_to_z(torch.from_numpy(x), is_image)
        np.testing.assert_array_equal(got.numpy(), want)
    labels = np.array([3, 7])
    np.testing.assert_array_equal(tn.encode_to_c(torch.from_numpy(labels)).numpy(),
                                  np.asarray(jn.encode_to_c(jnp.asarray(labels))))
    text = np.random.RandomState(2).randint(0, 100, (2, 7))
    jn.cfg = jn.cfg.__class__(**{**jn.cfg.__dict__, "cond_stage_key": "text"})
    tn.cfg = tn.cfg.replace(cond_stage_key="text")
    np.testing.assert_array_equal(tn.encode_to_c(torch.from_numpy(text)).numpy(),
                                  np.asarray(jn.encode_to_c(jnp.asarray(text))))


@pytest.mark.parametrize("variant", ["cfg", "cfg-class-first-noscale", "no-cfg", "unconditional"])
def test_class_conditional_ids_match_jax(tokenizers, variant):
    """16 steps (one 4x4 image) at top_k=1, with buckets; the pixels of the
    ids through both tokenizers."""
    pair_kw, kw = {"cfg": ({}, dict(use_cfg=True, scale_cfg=True, bucket=5)),
                   "cfg-class-first-noscale": (dict(class_first=True),
                                               dict(use_cfg=True, scale_cfg=False)),
                   "no-cfg": ({}, dict(use_cfg=False, bucket=4)),
                   "unconditional": (dict(unconditional=True), dict(bucket=7))}[variant]
    jn, tn = _pair(tokenizers, **pair_kw)
    cls = np.array([3, 7, 0])
    want = np.asarray(jn.make_class_conditional_sampler(16, top_k=1, **kw)(
        jnp.asarray(cls), jax.random.PRNGKey(0)))
    got = tn.make_class_conditional_sampler(16, top_k=1, **kw)(
        torch.from_numpy(cls), torch.Generator().manual_seed(0))
    assert got.shape == (3, 16) and int(got.min()) >= 0 and int(got.max()) < 64
    np.testing.assert_array_equal(got.numpy(), want)
    pix_j = np.asarray(jn.decode_to_pixels(jnp.asarray(want), is_image=True))
    pix_t = tn.decode_to_pixels(got, is_image=True)
    assert pix_t.shape == (3, 3, 32, 32)
    np.testing.assert_allclose(pix_t.numpy(), pix_j, **PIX)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_frame_prediction_ids_match_jax(tokenizers, int8):
    """2 of 3 latent frames encoded, the third (16 tokens) continued at
    top_k=1 by an unconditional LM, in bucketed windows."""
    jn, tn = _pair(tokenizers, unconditional=True, block_size=48)
    video = _video((2, 3, 5, 32, 32), seed=3)
    want = np.asarray(jn.make_frame_prediction_sampler(3, 2, top_k=1, bucket=8, int8=int8)(
        jnp.asarray(video), jax.random.PRNGKey(0)))
    got = tn.make_frame_prediction_sampler(3, 2, top_k=1, bucket=8, int8=int8)(
        torch.from_numpy(video), torch.Generator().manual_seed(0))
    assert got.shape == (2, 3, 4, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :2].numpy(),
                                  tn.tokenizer.encode(torch.from_numpy(video), False)[:, :2].numpy())
    pix_j = np.asarray(jn.decode_to_pixels(jnp.asarray(want).reshape(2, -1), is_image=False))
    pix_t = tn.decode_to_pixels(got.reshape(2, -1), is_image=False)
    np.testing.assert_allclose(pix_t.numpy(), pix_j, **PIX)
