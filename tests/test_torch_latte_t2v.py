"""The port's LatteT2V and its sample CLI against the JAX package's, f32
on the CPU, at tests/test_reference_parity_latte_t2v.py's COMMON sizes.

A random state_dict in the reference's torch names loads into the port
directly and into the JAX model through its own convert_latte_t2v_state:
forwards within 1e-5 over both FF/bias flavours, the caption mask,
temporal attention off and the joint image-video path (4-dim captions,
3-dim masks). convert.py's maps are that converter and its inverse. The
CLI: the CFG eps within 1e-5 and a 3-step DDIM from shared initial noise
within 1e-4 of the JAX model's; encode_prompts through a tiny random T5
and load_t2v_config with --model_config equal to the JAX CLI's; the CLI
end to end on the CPU from a .pt and from a msgpack, through a small VAE;
its refusals."""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.cli import latte_t2v_sample as jcli
from omnitokenizer_tpu.diffusion import create_diffusion as jax_create_diffusion
from omnitokenizer_tpu.models.latte_t2v import LatteT2V as JaxT2V
from omnitokenizer_tpu.models.latte_t2v import LatteT2VConfig as JaxT2VConfig
from omnitokenizer_tpu.models.latte_t2v import convert_latte_t2v_state
from omnitokenizer_tpu_torch.cli import latte_t2v_sample as tcli
from omnitokenizer_tpu_torch.convert import (latte_t2v_state_dict_from_jax,
                                             latte_t2v_state_dict_to_jax, load_diffusion_state_dict)
from omnitokenizer_tpu_torch.models.latte_t2v import LatteT2V, LatteT2VConfig

from torch_port_util import to_numpy_tree

torch.set_num_threads(1)

COMMON = dict(num_attention_heads=4, attention_head_dim=16, in_channels=4, out_channels=8,
              num_layers=2, cross_attention_dim=64, sample_size=16, patch_size=2,
              norm_elementwise_affine=False, norm_eps=1e-6, caption_channels=24, video_length=4)
FLAVOURS = [("gelu-approximate", True), ("geglu", False)]
TOL = dict(atol=1e-5, rtol=1e-5)


def random_state_dict(cfg, seed: int = 81) -> dict:
    """Every tensor of the port's model (the reference's names) N(0, 0.05^2)."""
    model = LatteT2V(cfg)
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) * 0.05 for k, v in model.state_dict().items()}


def pair(activation_fn="gelu-approximate", attention_bias=True):
    """(JAX model, its params through convert_latte_t2v_state, port model)
    on one random state_dict."""
    kw = dict(activation_fn=activation_fn, attention_bias=attention_bias, **COMMON)
    sd = random_state_dict(LatteT2VConfig(**kw))
    params = convert_latte_t2v_state({k: v.numpy() for k, v in sd.items()})
    model = LatteT2V(LatteT2VConfig(**kw))
    load_diffusion_state_dict(model, {**sd, "pos_embed.pos_embed": torch.zeros(1)})
    return JaxT2V(JaxT2VConfig(**kw)), jax.tree_util.tree_map(jnp.asarray, params), model.eval()


def inputs(B=2, F=4, img=0, L=7, seed=82):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, F + img, 4, 16, 16)).astype(np.float32)
    t = np.array([3, 77][:B])
    if img:
        cap = rng.standard_normal((B, 1 + img, L, 24)).astype(np.float32)
        mask = np.ones((B, 1 + img, L), np.float32)
        mask[:, 0, 5:] = 0  # the video's caption padded
        mask[:, 1:, 4:] = 0  # the images' otherwise
    else:
        cap = rng.standard_normal((B, L, 24)).astype(np.float32)
        mask = np.ones((B, L), np.float32)
        mask[:, 5:] = 0
        mask[B - 1, :] = 0 if B > 1 else mask[B - 1, :]  # every key masked: still finite
    return x, t, cap, mask


def jax_forward(jm, params, x, t, cap, mask, **kw):
    """The JAX model on the port's (B, F, C, H, W) layout."""
    out = jm.apply({"params": params}, jnp.asarray(np.moveaxis(x, 2, -1)), jnp.asarray(t),
                   encoder_hidden_states=jnp.asarray(cap), encoder_attention_mask=jnp.asarray(mask),
                   **kw)
    return np.moveaxis(np.asarray(out), -1, 2)


def port_forward(model, x, t, cap, mask, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cap),
                     torch.from_numpy(mask), **kw).numpy()


@pytest.mark.parametrize("activation_fn,attention_bias", FLAVOURS, ids=["pixart", "geglu"])
def test_forward_matches_jax(activation_fn, attention_bias):
    jm, params, model = pair(activation_fn, attention_bias)
    args = inputs()
    got = port_forward(model, *args)
    assert got.shape == (2, 4, 8, 16, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_forward(jm, params, *args), **TOL)


def test_temporal_attention_off_matches_jax():
    jm, params, model = pair()
    args = inputs()
    got = port_forward(model, *args, enable_temporal_attentions=False)
    np.testing.assert_allclose(
        got, jax_forward(jm, params, *args, enable_temporal_attentions=False), **TOL)
    assert np.abs(got - port_forward(model, *args)).max() > 1e-3


def test_joint_image_video_matches_jax():
    jm, params, model = pair()
    args = inputs(img=2)
    kw = dict(use_image_num=2, train=True)
    got = port_forward(model, *args, **kw)
    assert got.shape == (2, 6, 8, 16, 16)
    np.testing.assert_allclose(got, jax_forward(jm, params, *args, **kw), **TOL)


@pytest.mark.parametrize("activation_fn,attention_bias", FLAVOURS, ids=["pixart", "geglu"])
def test_state_dict_maps_are_the_jax_converter(activation_fn, attention_bias):
    cfg = LatteT2VConfig(activation_fn=activation_fn, attention_bias=attention_bias, **COMMON)
    sd = random_state_dict(cfg)
    params = convert_latte_t2v_state({k: v.numpy() for k, v in sd.items()})
    back = latte_t2v_state_dict_from_jax(params, cfg.patch_size)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    mine = to_numpy_tree(latte_t2v_state_dict_to_jax(sd))
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(mine))
    assert len(flat_got) == len(flat_want)
    for path, v in flat_want:
        np.testing.assert_array_equal(flat_got[path], v)
    with pytest.raises(KeyError, match="extra"):
        latte_t2v_state_dict_from_jax({**params, "extra": np.zeros(2)}, cfg.patch_size)


def _cli_args(**kw):
    base = dict(t5_dir=None, max_token_length=12, caption_channels=24)
    return argparse.Namespace(**{**base, **kw})


def test_cfg_eps_matches_jax():
    """The CLI's guided eps (CFG 7.5 over [uncond, text], learned sigma
    dropped) against the JAX CLI's formula on the JAX model."""
    jm, params, model = pair()
    x, t, cap, mask = inputs(B=1)
    neg = np.zeros_like(cap)
    ctx, m = np.concatenate([neg, cap]), np.concatenate([np.ones_like(mask), mask])
    eps = tcli.guided_eps(model, torch.from_numpy(ctx), torch.from_numpy(m), 7.5, 4)
    with torch.no_grad():
        got = eps(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    out = jax_forward(jm, params, np.concatenate([x, x]), np.concatenate([t, t]), ctx, m)
    u, c = out[:1], out[1:]
    want = (u + 7.5 * (c - u))[:, :, :4]
    assert got.shape == (1, 4, 4, 16, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_ddim_from_shared_noise_matches_jax():
    """3 DDIM steps (eta 0) of the guided eps from one initial noise."""
    jm, params, model = pair()
    _, _, cap, mask = inputs(B=1)
    ctx, m = np.concatenate([np.zeros_like(cap), cap]), np.concatenate([np.ones_like(mask), mask])
    noise = np.random.RandomState(83).standard_normal((1, 4, 4, 16, 16)).astype(np.float32)
    args = argparse.Namespace(num_sampling_steps=3, sample_method="ddim", beta_schedule="linear")
    diffusion = tcli.make_diffusion(args)
    eps = tcli.guided_eps(model, torch.from_numpy(ctx), torch.from_numpy(m), 7.5, 4)
    with torch.no_grad():
        got = diffusion.ddim_sample_loop(eps, noise.shape, noise=torch.from_numpy(noise),
                                         clip_denoised=False).numpy()

    jd = jax_create_diffusion("ddim3", noise_schedule="linear", learn_sigma=False,
                              sigma_small=True)
    jctx, jm_ = jnp.asarray(ctx), jnp.asarray(m)

    def jeps(xl, tt):
        out = jm.apply({"params": params}, jnp.concatenate([xl, xl]), jnp.concatenate([tt, tt]),
                       encoder_hidden_states=jctx, encoder_attention_mask=jm_)
        u, c = jnp.split(out, 2, axis=0)
        return (u + 7.5 * (c - u))[..., :4]

    want = jd.ddim_sample_loop(jeps, (1, 4, 16, 16, 4), jax.random.PRNGKey(0),
                               noise=jnp.asarray(np.moveaxis(noise, 2, -1)), clip_denoised=False)
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 2), atol=1e-4, rtol=1e-4)


def test_encode_prompts_through_t5_matches_jax(tmp_path):
    from transformers import T5Config, T5EncoderModel

    torch.manual_seed(0)
    T5EncoderModel(T5Config(vocab_size=300, d_model=24, d_kv=8, d_ff=32, num_layers=2,
                            num_heads=3)).save_pretrained(str(tmp_path / "t5"))
    args = _cli_args(t5_dir=str(tmp_path / "t5"))
    prompts = ["a corgi &amp; a  cat\n running", "", "snow"]
    emb_t, mask_t = tcli.encode_prompts(args, prompts)
    emb_j, mask_j = jcli.encode_prompts(args, prompts)
    assert emb_t.shape == (3, 12, 24)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(emb_t, emb_j)
    assert tcli.basic_clean(prompts[0]) == jcli.basic_clean(prompts[0]) == "a corgi & a cat running"


def test_byte_fallback_is_seeded():
    args = _cli_args()
    emb, mask = tcli.encode_prompts(args, ["ab", ""])
    table = tcli.byte_table(24)
    np.testing.assert_array_equal(emb[0, :2], table[[ord("a") + 1, ord("b") + 1]])
    np.testing.assert_array_equal(mask[1], [1] + [0] * 11)
    np.testing.assert_array_equal(emb, tcli.encode_prompts(args, ["ab", ""])[0])


def test_load_t2v_config_matches_jax(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"num_layers": 3, "attention_head_dim": 8, "in_channels": 8,
                                "video_length": 99, "unknown": 1}))
    for argv in ([], ["--model_config", str(path), "--video_length", "5"]):
        want = jcli.load_t2v_config(jcli.build_parser().parse_args(argv), jnp.float32)
        got = tcli.load_t2v_config(tcli.build_parser().parse_args(argv), torch.float32)
        assert {k: v for k, v in vars(got).items() if k != "dtype"} == \
               {k: v for k, v in vars(want).items() if k != "dtype"}
    assert got.num_layers == 3 and got.video_length == 5


SMALL_FLAGS = ["--num_layers", "2", "--num_attention_heads", "2", "--attention_head_dim", "16",
               "--caption_channels", "24", "--image_size", "64", "--video_length", "3",
               "--num_sampling_steps", "3", "--max_token_length", "12", "--in_channels", "8",
               "--out_channels", "16", "--text_prompt", "a dog", "a red car", "--device", "cpu"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The small CLI model's random weights as a reference .pt and as a JAX
    msgpack."""
    from omnitokenizer_tpu_torch.utils.msgpack_io import write_msgpack

    root = tmp_path_factory.mktemp("t2v")
    cfg = tcli.load_t2v_config(tcli.build_parser().parse_args(SMALL_FLAGS), torch.float32)
    sd = random_state_dict(cfg, seed=84)
    torch.save({"ema": sd, "model": {k: v * 0 for k, v in sd.items()}}, str(root / "t2v.pt"))
    write_msgpack(str(root / "t2v.msgpack"), {"params": latte_t2v_state_dict_to_jax(sd)})
    return str(root / "t2v.pt"), str(root / "t2v.msgpack")


@pytest.fixture(scope="module")
def vae_ckpt(tmp_path_factory):
    """A small VAE-mode tokenizer: 8 latent channels of a 64^2 clip at patch 8."""
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, TokenizerConfig
    from omnitokenizer_tpu_torch.utils.checkpoint import save_tokenizer_checkpoint

    cfg = TokenizerConfig(embedding_dim=32, n_codes=32, resolution=64, sequence_length=9,
                          patch_size=8, temporal_patch_size=4, enc_block="t", dec_block="t",
                          spatial_depth=1, temporal_depth=1, heads=2, dim_head=16, use_vae=True)
    path = str(tmp_path_factory.mktemp("vae") / "vae.pt")
    save_tokenizer_checkpoint(path, OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cpu").net,
                              cfg)
    return path


def test_cli_end_to_end_on_the_cpu(tmp_path, monkeypatch, ckpts, vae_ckpt):
    """The .pt's EMA and the msgpack's params give the same latents; through
    the VAE, each prompt's clip is the adapter's decode of those latents,
    channels-last in [-0.5, 0.5], handed to the grid writer under its mp4
    name (a spy: an imageio without an mp4 plugin cannot encode them)."""
    from omnitokenizer_tpu_torch.cli.diffusion_common import decode_batch_fn
    from omnitokenizer_tpu_torch.models.diffusion_adapter import DiffusionVAEAdapter
    from omnitokenizer_tpu_torch.utils import media

    pt, mp = ckpts
    z = {}
    for name, ckpt in (("pt", pt), ("msgpack", mp)):
        out = str(tmp_path / name)
        z[name] = tcli.main(SMALL_FLAGS + ["--ckpt", ckpt, "--save_img_path", out])
        np.testing.assert_array_equal(np.load(os.path.join(out, "latents.npy")), z[name])
    assert z["pt"].shape == (2, 3, 8, 8, 8) and np.isfinite(z["pt"]).all()
    assert np.abs(z["pt"]).max() > 0
    np.testing.assert_array_equal(z["pt"], z["msgpack"])

    written = {}
    monkeypatch.setattr(media, "save_video_grid",
                        lambda video, fname: written.setdefault(os.path.basename(fname), video))
    tcli.main(SMALL_FLAGS + ["--ckpt", pt, "--vae_ckpt", vae_ckpt, "--save_img_path",
                             str(tmp_path / "mp4")])
    assert sorted(written) == ["a_dog.mp4", "a_red_car.mp4"]
    adapter = DiffusionVAEAdapter.load_from_checkpoint(vae_ckpt, device="cpu")
    with torch.inference_mode():
        want = decode_batch_fn(adapter, video=True)(torch.from_numpy(z["pt"])).numpy()
    want = np.moveaxis(want, 1, -1)  # (2, 9, 64, 64, 3): 1 + (3 - 1) * 4 frames
    assert want.shape == (2, 9, 64, 64, 3) and np.abs(want).max() <= 0.5
    np.testing.assert_array_equal(written["a_dog.mp4"], want[:1])
    np.testing.assert_array_equal(written["a_red_car.mp4"], want[1:])


def test_cli_refusals(tmp_path, ckpts, vae_ckpt):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(SMALL_FLAGS[:-2] + ["--ckpt", ckpts[0]])
    flags = [f for f in SMALL_FLAGS]
    flags[flags.index("--in_channels") + 1] = "4"
    with pytest.raises(ValueError, match="latent channels"):
        tcli.main(flags + ["--vae_ckpt", vae_ckpt, "--save_img_path", str(tmp_path)])
