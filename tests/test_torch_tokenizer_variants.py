"""The tokenizer's variant configurations in the port against the JAX
package's, f32 on the CPU, on the same weights through the bridge
(convert.state_dict_to_jax, then state_dict_from_jax): every weight
perturbed from its init and BatchNorm's running statistics away from 0 and
1, so that each piece shows.

Round trips at tests/test_reference_parity.py's SMALL over its seven
override sets, einsum bias mode under 'rel' and 'rope', and each pooling
code ('a', 'm', 'l' in the encoder; 'n', 'r' in the decoder after a pool):
indices equal, pixels within 2e-4. The JAX decoder cannot run an up block
(its rearrange shrinks the grid by the up blocks before any of them ran),
so an up config's decode is held against the JAX modules composed here.
Then the pieces: AliBi, Pooling/Up, the einsum Attention, the cnn norm,
and the bf16 dispatch of a biased call (no attention kernel, ln_qkv
still)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from einops import rearrange

from omnitokenizer_tpu.config import TokenizerConfig as JaxConfig
from omnitokenizer_tpu.models.tokenizer import OmniTokenizerNet as JaxNet
from omnitokenizer_tpu.models.wrapper import OmniTokenizerVQGAN as JaxVQGAN
from omnitokenizer_tpu.ops import attention as jattn
from omnitokenizer_tpu.ops import bias as jbias
from omnitokenizer_tpu.ops.gaussian import DiagonalGaussian as JaxGaussian
from omnitokenizer_tpu.ops.transformer import Transformer as JaxTransformer
from omnitokenizer_tpu_torch import OmniTokenizerVQGAN
from omnitokenizer_tpu_torch.config import TokenizerConfig as TorchConfig
from omnitokenizer_tpu_torch.convert import state_dict_from_jax, state_dict_to_jax
from omnitokenizer_tpu_torch.models.tokenizer import CnnNormalize, OmniTokenizerNet, init_weights
from omnitokenizer_tpu_torch.ops import attention as tattn
from omnitokenizer_tpu_torch.ops import bias as tbias
from omnitokenizer_tpu_torch.ops.gaussian import DiagonalGaussian

from torch_port_util import to_numpy_tree, torch_f32

torch.set_num_threads(1)

# tests/test_reference_parity.py's SMALL, with the reference's defaults it
# relies on ('rel' positions, no l2 codes) and a 64^2, 5-frame clip
SMALL = dict(embedding_dim=64, n_codes=64, codebook_dim=8, spatial_depth=2, temporal_depth=2,
             dim_head=16, heads=4, enc_block="tt", dec_block="tt", patch_size=8,
             norm_type="batch", resolution=64, sequence_length=5, spatial_pos="rel",
             l2_code=False)
CONFIGS = {
    "vq_rel": {},
    "vq_rope": dict(spatial_pos="rope"),
    "vq_window": dict(enc_block="tw", dec_block="wt", twod_window_size=4),
    "vq_l2": dict(l2_code=True),
    "vae": dict(use_vae=True, kl_weight=1e-6),
    "vq_defer": dict(defer_temporal_pool=True, defer_spatial_pool=True),
    "vq_cnn": dict(patch_embed="cnn"),
    "einsum_rel": dict(attn_bias_mode="einsum"),
    "einsum_rope": dict(spatial_pos="rope", attn_bias_mode="einsum"),
    "pool_a": dict(enc_block="ta"),
    "pool_m": dict(enc_block="tm"),
    "pool_l": dict(enc_block="tl"),
    "up_n": dict(enc_block="ta", dec_block="nt"),
    "up_r": dict(enc_block="tl", dec_block="rt"),
}
PIX = dict(atol=2e-4, rtol=1e-3)


def perturbed(tree: dict, seed: int) -> dict:
    """`tree` (numpy) with every param moved by N(0, 0.1^2) and BatchNorm's
    running mean N(0, 0.1^2), its variance uniform in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)

    def walk(node, collection, path=()):
        if isinstance(node, dict):
            return {k: walk(v, collection, path + (k,)) for k, v in node.items()}
        a = np.asarray(node)
        if collection == "params":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if collection == "batch_stats":
            return (rng.uniform(0.5, 1.5, a.shape) if path[-1] == "var"
                    else 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return {c: walk(v, c) for c, v in tree.items()}


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, path + (k,)))
        return out
    return {path: tuple(np.shape(tree))}


def has_up(name: str) -> bool:
    return any(c in CONFIGS[name].get("dec_block", "") for c in "nr")


def build(name: str):
    """(JAX wrapper, port wrapper) on the same perturbed weights. The tree
    comes from the port's init through state_dict_to_jax; where the JAX
    package can init the config, the tree's leaves are its init's."""
    kw = {**SMALL, **CONFIGS[name]}
    jcfg, tcfg = JaxConfig(**kw), TorchConfig(**kw)
    net = OmniTokenizerNet(tcfg)
    init_weights(net, torch.Generator().manual_seed(0))
    tree = {c: {k: v for k, v in to_numpy_tree(t).items()}
            for c, t in state_dict_to_jax(net).items()}
    if not has_up(name):
        want = to_numpy_tree(JaxVQGAN.from_config(jcfg, seed=0).variables)
        assert _shapes(tree) == _shapes(want)
    tree = perturbed(tree, seed=1)
    net.load_state_dict(state_dict_from_jax(tree, net))
    jm = JaxVQGAN(jcfg, jax.tree_util.tree_map(jnp.asarray, tree))
    return jm, OmniTokenizerVQGAN(tcfg, net)


def jax_up_decode(jm, z):
    """The decoder of an up config from the JAX package's modules: the
    post-VQ Dense, the temporal stack at the tokens' grid, the spatial stack
    from that grid (its up blocks grow it), the linear to-pixels."""
    cfg, params = jm.cfg, jm.variables["params"]
    dec = params["decoder"]
    x = jm.net.apply(jm.variables, jnp.asarray(z), method=lambda m, v: m.post_vq_conv(v))
    b, t, h, w, d = x.shape

    def stack(name, block, causal, spatial_pos):
        return JaxTransformer(dim=d, depth=len(block), block=block, causal=causal,
                              dim_head=cfg.dim_head, heads=cfg.heads, ff_mult=cfg.ff_mult,
                              peg_causal=cfg.causal_in_peg, window_size=cfg.twod_window_size,
                              spatial_pos=spatial_pos, attn_bias_mode=cfg.attn_bias_mode,
                              dtype=cfg.dtype, name=name)

    x = rearrange(x, "b t h w d -> (b h w) t d")
    x = stack("t", "t" * cfg.temporal_depth, cfg.causal_in_temporal_transformer, "rel").apply(
        {"params": dec["dec_temporal_transformer"]}, x, (b, t, h, w), is_spatial=False)
    x = rearrange(x, "(b h w) t d -> (b t) (h w) d", b=b, h=h, w=w)
    x = stack("s", cfg.dec_block, False, cfg.spatial_pos).apply(
        {"params": dec["dec_spatial_transformer"]}, x, (b, t, h, w), is_spatial=True)
    g = int(x.shape[1] ** 0.5)
    x = np.asarray(rearrange(x, "(b t) (h w) d -> b t h w d", b=b, h=g, w=g))
    p, pt, C = cfg.patch_size, cfg.temporal_patch_size, cfg.image_channels

    def to_pixels(tok, name, kt):
        y = tok @ np.asarray(dec[name]["kernel"]) + np.asarray(dec[name]["bias"])
        return rearrange(y, "b t h w (c pt p1 p2) -> b (t pt) (h p1) (w p2) c", pt=kt, p1=p,
                         p2=p)

    out = to_pixels(x[:, :1], "to_pixels_first_frame", 1)
    if t > 1:
        out = np.concatenate([out, to_pixels(x[:, 1:], "to_pixels", pt)], axis=1)
    return out


def jax_decode(name, jm, idx, is_image):
    """JAX pixels (channels-first) of VQ indices."""
    if not has_up(name):
        return np.asarray(jm.decode(jnp.asarray(idx), is_image))
    z = jm.net.apply(jm.variables, jnp.asarray(idx), method=lambda m, i: m.codebook.lookup(i))
    out = jax_up_decode(jm, z)
    return np.moveaxis(out[:, 0], -1, 1) if is_image else np.moveaxis(out, -1, 1)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return request.param, *build(request.param)


def _inputs(is_image):
    rng = np.random.RandomState(2)
    shape = (2, 3, 64, 64) if is_image else (2, 3, 5, 64, 64)
    return (rng.standard_normal(shape) * 0.25).astype(np.float32)


@pytest.mark.parametrize("is_image", [False, True], ids=["video", "image"])
def test_round_trip_matches_jax(pair, is_image):
    name, jm, tm = pair
    x = _inputs(is_image)
    if tm.cfg.use_vae:
        return _vae_round_trip(jm, tm, x, is_image)
    idx_j = np.asarray(jm.encode(jnp.asarray(x), is_image))
    idx_t = tm.encode(torch_f32(x), is_image).numpy()
    np.testing.assert_array_equal(idx_t, idx_j)
    dec_j = jax_decode(name, jm, idx_j, is_image)
    dec_t = tm.decode(torch.tensor(idx_j), is_image).numpy()
    assert dec_t.shape == dec_j.shape
    np.testing.assert_allclose(dec_t, dec_j, **PIX)
    recon_t, aux_t = tm.reconstruct(torch_f32(x), is_image)
    np.testing.assert_array_equal(aux_t["encodings"].numpy(), idx_j)
    np.testing.assert_allclose(recon_t.numpy(), dec_j, **PIX)
    if not has_up(name):
        recon_j, aux_j = jm.reconstruct(jnp.asarray(x), is_image)
        np.testing.assert_allclose(recon_t.numpy(), np.asarray(recon_j), **PIX)
        np.testing.assert_allclose(float(aux_t["commitment_loss"]),
                                   float(aux_j["commitment_loss"]), atol=1e-5, rtol=1e-4)
    if name == "up_n" and not is_image:  # the up blocks restore the embed's grid
        assert dec_t.shape == x.shape


def _vae_round_trip(jm, tm, x, is_image):
    """The posterior's mean and log-variance, then the decode of one sample
    drawn with shared noise."""
    xl = np.moveaxis(x[:, :, None] if is_image else x, 1, -1)
    h_j = jm.net.apply(jm.variables, jnp.asarray(xl), is_image, method=JaxNet.encode_latent)
    post_j = JaxGaussian.from_params(h_j)
    with torch.no_grad():
        post_t = DiagonalGaussian.from_params(tm.net.encode_latent(torch_f32(xl), is_image))
    np.testing.assert_allclose(post_t.mean.numpy(), np.asarray(post_j.mean), **PIX)
    np.testing.assert_allclose(post_t.logvar.numpy(), np.asarray(post_j.logvar), **PIX)
    noise = np.random.RandomState(4).standard_normal(post_t.mean.shape).astype(np.float32)
    z_j = post_j.mean + post_j.std * jnp.asarray(noise)
    dec_j = jm.net.apply(jm.variables, z_j, is_image, method=JaxNet.decode_latent)
    with torch.no_grad():
        dec_t = tm.net.decode_latent(post_t.sample(noise=torch.from_numpy(noise)), is_image)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), **PIX)


def test_cnn_norm_statistics_are_read():
    """The cnn variant's BatchNorm buffers hold the file's running
    statistics, not the defaults."""
    jm, tm = build("vq_cnn")
    for name in ("to_patch_emb_first_frame_cnorm", "to_patch_emb_cnorm"):
        norm = getattr(tm.net.encoder, name).norm
        stats = jm.variables["batch_stats"]["encoder"][name]["norm"]
        np.testing.assert_array_equal(norm.var.numpy(), np.asarray(stats["var"]))
        np.testing.assert_array_equal(norm.mean.numpy(), np.asarray(stats["mean"]))
        assert not np.allclose(norm.var.numpy(), 1.0)


# ------------------------------------------------------------------ pieces
@pytest.mark.parametrize("heads", [4, 6, 8, 12])
@pytest.mark.parametrize("i,j", [(5, 5), (9, 9), (3, 7), (1, 9)])
def test_alibi_matches_jax(heads, i, j):
    np.testing.assert_array_equal(tbias.alibi_slopes(heads), jbias.alibi_slopes(heads))
    np.testing.assert_array_equal(tbias.alibi_bias(heads, i, j).numpy(),
                                  np.asarray(jbias.alibi_bias(heads, i, j)))


def test_cpb_matches_jax_on_every_pair():
    """The CPB bias from the distinct offsets equals the JAX MLP over every
    (query, key) pair, on a non-square grid too."""
    dim, heads = 32, 4
    jm = jbias.ContinuousPositionBias(dim=dim, heads=heads)
    tree = perturbed(to_numpy_tree(jm.init(jax.random.PRNGKey(0), 3, 5)), seed=5)
    tm = tbias.ContinuousPositionBias(dim, heads)
    tm.load_state_dict(state_dict_from_jax(tree, tm))
    for h, w in ((3, 5), (6, 6)):
        with torch.no_grad():
            got = tm(h, w).numpy()
        np.testing.assert_allclose(got, np.asarray(jm.apply(tree, h, w)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("code", ["a", "m", "l", "n", "r"])
def test_pooling_and_up_match_jax(code):
    dim = 8
    jmod = (jattn.Pooling(code, dim) if code in "aml" else jattn.Up(code, dim))
    tmod = (tattn.Pooling(code, dim) if code in "aml" else tattn.Up(code, dim))
    x = np.random.RandomState(6).standard_normal((2, 16, dim)).astype(np.float32)
    tree = perturbed(to_numpy_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=7)
    if tree.get("params"):
        tmod.load_state_dict(state_dict_from_jax(tree, tmod))
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == ((2, 4, dim) if code in "aml" else (2, 64, dim))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("spatial_pos,causal,is_spatial,n", [
    ("rel", False, True, 16),   # the CPB bias of a 4 x 4 grid
    ("rel", True, False, 5),    # a temporal call: AliBi
    ("rel", True, True, 16),    # both, summed
    ("rope", True, True, 16),   # RoPE and AliBi
], ids=["cpb", "alibi", "cpb+alibi", "rope+alibi"])
def test_einsum_attention_matches_jax(spatial_pos, causal, is_spatial, n):
    dim, heads, dh = 32, 4, 8
    kw = dict(dim=dim, dim_head=dh, heads=heads, causal=causal, spatial_pos=spatial_pos,
              attn_bias_mode="einsum")
    jmod = jattn.Attention(**kw)
    x = np.random.RandomState(8).standard_normal((2, n, dim)).astype(np.float32)
    tree = perturbed(to_numpy_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                             is_spatial=is_spatial)), seed=9)
    tmod = tattn.Attention(**kw, spatial=is_spatial)
    tmod.load_state_dict(state_dict_from_jax(tree, tmod))
    want = np.asarray(jmod.apply(tree, jnp.asarray(x), is_spatial=is_spatial))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), is_spatial=is_spatial).numpy()
        sdpa_mode = tattn.Attention(**{**kw, "attn_bias_mode": "sdpa"}, spatial=is_spatial)
        sdpa_mode.load_state_dict(tmod.state_dict())
        dropped = sdpa_mode(torch.from_numpy(x), is_spatial=is_spatial).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got - dropped).max() > 1e-3  # the bias moved the output


@pytest.mark.parametrize("norm_type", ["group", "batch"])
def test_cnn_normalize_matches_jax(norm_type):
    from omnitokenizer_tpu.models.tokenizer import _CnnNormalize

    jmod = _CnnNormalize(64, norm_type)
    x = np.random.RandomState(10).standard_normal((2, 3, 4, 4, 64)).astype(np.float32) * 2 + 0.5
    tree = perturbed(to_numpy_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=11)
    tmod = CnnNormalize(64, norm_type)
    tmod.load_state_dict(state_dict_from_jax(tree, tmod))
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cnn_group_norm_refuses_channels_the_groups_do_not_divide():
    """The cnn to-pixels norm over 3 channels: flax's GroupNorm(32) raises,
    and so does the port's (it once grouped the flattened tensor)."""
    from omnitokenizer_tpu.models.tokenizer import _CnnNormalize

    x = np.random.RandomState(12).standard_normal((1, 2, 8, 8, 3)).astype(np.float32)
    with pytest.raises(ValueError, match=r"Number of groups \(32\) does not divide"):
        _CnnNormalize(3, "group").init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError, match=r"Number of groups \(32\) does not divide"):
        CnnNormalize(3, "group")(torch.from_numpy(x))


def spy(monkeypatch, calls):
    for name in ("ln_qkv", "small_n_attention", "cosine_mha", "mha"):
        real = getattr(tattn, name)

        def wrapped(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(tattn, name, wrapped)


@pytest.mark.parametrize("spatial_pos,causal,n,is_spatial,want", [
    ("rel", False, 64, True, ["ln_qkv"]),          # CPB: no attention kernel
    ("rel", True, 5, False, ["ln_qkv"]),           # AliBi: no small_n_attention
    ("rel", True, 16, False, ["ln_qkv"]),          # AliBi: no mha either
    ("rope", False, 64, True, ["ln_qkv", "cosine_mha"]),  # rope, no bias: the kernel
], ids=["cpb", "alibi_5", "alibi_16", "rope_unbiased"])
def test_biased_bf16_call_reaches_no_attention_kernel(monkeypatch, spatial_pos, causal, n,
                                                     is_spatial, want):
    calls = []
    spy(monkeypatch, calls)
    torch.manual_seed(0)
    attn = tattn.Attention(512, dim_head=64, heads=8, causal=causal, spatial_pos=spatial_pos,
                           attn_bias_mode="einsum", dtype=torch.bfloat16, spatial=is_spatial)
    attn.prepare_kernels()
    x = torch.randn(2, n, 512).to(torch.bfloat16)
    with torch.no_grad():
        out = attn(x, is_spatial=is_spatial)
        assert calls == want
        monkeypatch.setenv("OMNITOK_TRAIN_KERNEL_FWD", "0")
        ref = attn(x, is_spatial=is_spatial, training=True)
    assert calls == want
    assert attn.train_route(n, is_spatial) is None or not attn.needs_bias(is_spatial)
    assert float((out.float() - ref.float()).abs().max() / ref.float().abs().max()) <= 3e-2


def test_trainer_refuses_the_cnn_embed():
    """The cnn norms serve inference only: BatchNorm reads its running
    statistics, so the port's GAN trainer refuses a cnn model."""
    from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer

    with pytest.raises(NotImplementedError, match="cnn patch embed"):
        TokenizerTrainer(TorchConfig(**{**SMALL, "patch_embed": "cnn"}), device="cpu")
