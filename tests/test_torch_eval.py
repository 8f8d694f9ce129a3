"""The port's reconstruction metrics and feature extractors against the JAX
package's, on the same numpy inputs: PSNR and SSIM within 1e-5 relative,
the Frechet distance within 1e-6, I3D logits and Inception pool features
within 1e-4 relative (f32; both packages load the same random torch-named
.pt written to tmp_path, and I3D's random init is the JAX package's own),
the antialiased preprocessing against jax.image.resize within 1e-5, and
load_pretrained_into_state against the JAX package's with inflation on a
synthetic image-stage checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.eval import frechet as jax_frechet
from omnitokenizer_tpu.eval import i3d as jax_i3d
from omnitokenizer_tpu.eval import inception as jax_inception
from omnitokenizer_tpu.eval import metrics as jax_metrics
from omnitokenizer_tpu_torch.eval import frechet, i3d, inception, metrics

from torch_port_util import to_numpy_tree

torch.set_num_threads(2)
RNG = np.random.RandomState(0)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@torch.no_grad()
def _randomize_bn(model: torch.nn.Module, seed: int) -> None:
    """Random BatchNorm statistics and affine terms, so loading them matters."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            n = m.num_features
            m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
            m.running_var.copy_(1 + 0.2 * torch.rand(n, generator=g))
            m.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
            m.bias.copy_(0.1 * torch.randn(n, generator=g))


def test_psnr_ssim_match_jax():
    x = RNG.uniform(-0.5, 0.5, (3, 32, 40, 3)).astype(np.float32)
    y = np.clip(x + 0.05 * RNG.standard_normal(x.shape), -0.5, 0.5).astype(np.float32)
    for ours, theirs in ((metrics.psnr, jax_metrics.psnr), (metrics.ssim, jax_metrics.ssim)):
        got = ours(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(theirs(jnp.asarray(x), jnp.asarray(y)))
        assert got.shape == want.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    frames = RNG.uniform(-0.5, 0.5, (4, 5, 16, 16, 3)).astype(np.float32)  # PSNR over clips
    np.testing.assert_allclose(metrics.psnr(torch.from_numpy(frames), torch.zeros(4, 5, 16, 16, 3)),
                               jax_metrics.psnr(jnp.asarray(frames), jnp.zeros(frames.shape)),
                               rtol=1e-5)


def test_frechet_distance_matches_jax():
    a = RNG.standard_normal((40, 16))
    b = 0.5 * RNG.standard_normal((40, 16)) + 0.3
    want = jax_frechet.frechet_distance(a, b)
    assert abs(frechet.frechet_distance(a, b) - want) <= 1e-6 * abs(want)
    assert abs(frechet.frechet_distance(a, a)) < 1e-6


def test_i3d_random_init_is_the_jax_init():
    """Without weights both packages draw the same network: every conv
    kernel equal to the JAX tree's (transposed to torch's layout)."""
    variables, pretrained = jax_i3d.load_i3d_variables(None)
    model, loaded = i3d.load_i3d(None, device="cpu")
    assert not pretrained and not loaded
    params = to_numpy_tree(variables["params"])
    n = 0
    for name, unit in i3d._units(model):
        node = params
        for part in name.split("."):
            node = node[part]
        np.testing.assert_array_equal(unit.conv3d.weight.numpy(),
                                      node["conv3d"]["kernel"].transpose(4, 3, 0, 1, 2))
        n += 1
    assert n == 4 + 6 * len(i3d.MIXED)


@pytest.fixture(scope="module")
def i3d_pt(tmp_path_factory):
    """A random torch-named i3d state_dict, as i3d_pretrained_400.pt is laid out."""
    model = i3d.InceptionI3d()
    i3d.init_like_jax(model, seed=5)
    _randomize_bn(model, 6)
    path = tmp_path_factory.mktemp("i3d") / "i3d.pt"
    torch.save(model.state_dict(), path)
    return str(path)


def test_i3d_logits_match_jax(i3d_pt):
    vids = (RNG.rand(2, 16, 64, 64, 3) * 255).astype(np.uint8)
    variables, _ = jax_i3d.load_i3d_variables(i3d_pt)
    model, loaded = i3d.load_i3d(i3d_pt, device="cpu")
    assert loaded
    want = jax_i3d.compute_fvd_logits(vids, variables, batch=2)
    got = i3d.compute_fvd_logits(vids, model, batch=1)
    assert got.shape == want.shape == (2, 400)
    assert _rel(got, want) <= 1e-4


@pytest.fixture(scope="module")
def inception_pt(tmp_path_factory):
    """A random pt_inception-named state_dict."""
    model, _ = inception.load_inception(None, device="cpu", seed=3)
    _randomize_bn(model, 4)
    path = tmp_path_factory.mktemp("inception") / "pt_inception.pt"
    torch.save(model.state_dict(), path)
    return str(path)


def test_inception_features_match_jax(inception_pt):
    imgs = RNG.rand(2, 64, 64, 3).astype(np.float32)
    variables, pretrained = jax_inception.load_inception_variables(inception_pt)
    model, loaded = inception.load_inception(inception_pt, device="cpu")
    assert pretrained and loaded
    want = jax_inception.compute_fid_features(imgs, variables)
    got = inception.compute_fid_features(imgs, model, batch=1)
    assert got.shape == want.shape == (2, 2048)
    assert _rel(got, want) <= 1e-4
    # the sFID tap and the Inception Score head on the same weights
    with torch.no_grad():
        x = inception.preprocess_images(imgs)
        logits = model(x, return_logits=True).numpy()
    apply = jax.jit(lambda v, x: jax_inception.FIDInceptionV3().apply(v, x, return_logits=True))
    assert _rel(logits, apply(variables, jax_inception.preprocess_images(imgs))) <= 1e-4
    sp = inception.compute_spatial_features(imgs, model)
    assert sp.shape == (2, 7 * 17 * 17) and model.Mixed_6d.tap is None
    probs = inception.compute_inception_probs(imgs, model)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)
    assert inception.inception_score(probs) == pytest.approx(jax_inception.inception_score(probs))


@pytest.mark.parametrize("shape,target", [((1, 3, 64, 64, 3), 224), ((1, 2, 256, 256, 3), 224),
                                          ((2, 2, 40, 72, 3), 32)],
                         ids=["up", "down", "nonsquare"])
def test_video_preprocessing_matches_jax_resize(shape, target):
    v = RNG.randint(0, 255, shape).astype(np.uint8)
    np.testing.assert_allclose(i3d.preprocess_videos(v, target).numpy(),
                               np.asarray(jax_i3d.preprocess_videos(v, target)), atol=1e-5)
    np.testing.assert_allclose(i3d.preprocess_videos_styleganv(v, target).numpy(),
                               np.asarray(jax_i3d.preprocess_videos_styleganv(v, target)),
                               atol=1e-5)


@pytest.mark.parametrize("size", [256, 598], ids=["up", "down"])
def test_image_preprocessing_matches_jax_resize(size):
    imgs = RNG.rand(2, size, size, 3).astype(np.float32)
    np.testing.assert_allclose(inception.preprocess_images(imgs).numpy(),
                               np.asarray(jax_inception.preprocess_images(imgs)), atol=1e-5)


@pytest.mark.parametrize("size", [320, 300])
def test_image_preprocessing_within_f32_rounding_of_jax(size):
    """At scale factors near 1 an antialiased f32 resize rounds farther from
    exact than 1e-5 (320 -> 299: torch's f32 result is 3e-5 from its own f64
    result): there the port stays within 1.5x its own f32 rounding of JAX."""
    imgs = RNG.rand(2, size, size, 3).astype(np.float32)
    got = inception.preprocess_images(imgs).numpy()
    from omnitokenizer_tpu_torch.training.loop import resize_bilinear
    exact = 2.0 * resize_bilinear(torch.from_numpy(imgs.astype(np.float64))[:, None], 299)[:, 0] - 1
    exact = exact.numpy()
    want = np.asarray(jax_inception.preprocess_images(imgs))
    assert np.abs(got - want).max() <= 1.5 * np.abs(got - exact).max()


# -- load_pretrained_into_state ---------------------------------------------------------------
class _JitInit:
    """A flax module whose init runs under jax.jit (the same draws; op-by-op
    init is several times slower on the CPU)."""

    def __init__(self, module):
        self.module = module

    def init(self, rngs, x, *static, **kw):
        return jax.jit(lambda r, x: self.module.init(r, x, *static, **kw))(rngs, x)


def _disc_reference_keys(disc, prefix, n_layers, is_3d, rng):
    """The reference's Sequential names of a discriminator's tensors, from the
    port's flax-named ones (the layout convert_discriminator_state reads)."""
    sd = {}
    for key, v in disc.state_dict().items():
        if key == "noise.weight":
            sd[f"{prefix}.noise.weight"] = rng.standard_normal(v.shape)
            continue
        name, *_, leaf = key.split(".")
        block = int(name[len("model"):].split("_")[0])
        conv_idx, norm_idx = ((0, None) if block == 0 else (1, 2) if block < n_layers
                              else (0, 1) if block == n_layers else (0, 1 if is_3d else None))
        if name.endswith("_conv"):
            scale = v[0].numel() ** -0.5 if leaf == "weight" else 0.02
            sd[f"{prefix}.model{block}.{conv_idx}.{leaf}"] = scale * rng.standard_normal(v.shape)
        else:
            ref_leaf = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                        "var": "running_var"}[leaf]
            base = {"scale": 1.0, "var": 1.0}.get(leaf, 0.0)
            sd[f"{prefix}.model{block}.{norm_idx}.{ref_leaf}"] = (
                base + 0.1 * np.abs(rng.standard_normal(v.shape)))
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("init_vgen,init_vdis", [("average", "center"), ("first", None)])
def test_load_pretrained_into_state_matches_jax(tmp_path, init_vgen, init_vdis):
    from omnitokenizer_tpu.config import LossConfig as JaxLoss
    from omnitokenizer_tpu.config import TokenizerConfig as JaxConfig
    from omnitokenizer_tpu.training.trainer import TokenizerTrainer as JaxTrainer
    from omnitokenizer_tpu.utils.inflate import load_pretrained_into_state as jax_load
    from omnitokenizer_tpu_torch.config import LossConfig, TokenizerConfig
    from omnitokenizer_tpu_torch.convert import state_dict_from_jax
    from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer
    from omnitokenizer_tpu_torch.utils.inflate import load_pretrained_into_state

    from torch_port_util import reference_state_dict, write_lightning_ckpt

    small = dict(embedding_dim=32, n_codes=32, codebook_dim=4, resolution=16, sequence_length=5,
                 patch_size=4, temporal_patch_size=4, enc_block="t", dec_block="t",
                 spatial_depth=1, temporal_depth=1, dim_head=8, heads=2, spatial_pos="rope",
                 norm_type="batch")
    loss = dict(disc_layers=2, disc_channels=8, apply_noise=True)
    trainer = TokenizerTrainer(TokenizerConfig(**small), LossConfig(**loss), device="cpu")
    # an image-stage checkpoint: the first-frame patch embed and the 2D
    # discriminator; the clip projections come from inflation
    rng = np.random.RandomState(7)
    sd = {k: v for k, v in reference_state_dict(JaxConfig(**small), seed=8).items()
          if not k.startswith(("encoder.to_patch_emb.", "decoder.to_pixels."))}
    probe = trainer.init_state(seed=0)
    sd.update(_disc_reference_keys(probe.image_disc, "image_discriminator", 2, False, rng))
    path = tmp_path / "stage1.ckpt"
    write_lightning_ckpt(path, sd)

    jtrainer = JaxTrainer(JaxConfig(**small), JaxLoss(**loss))
    nets = jtrainer.net, jtrainer.image_disc, jtrainer.video_disc
    jtrainer.net, jtrainer.image_disc, jtrainer.video_disc = (_JitInit(m) for m in nets)
    try:
        jstate = jax_load(jtrainer, str(path), init_vgen=init_vgen, init_vdis=init_vdis, seed=0)
    finally:
        jtrainer.net, jtrainer.image_disc, jtrainer.video_disc = nets
    state = load_pretrained_into_state(trainer, str(path), init_vgen=init_vgen,
                                       init_vdis=init_vdis, seed=0)

    want = state_dict_from_jax({"params": to_numpy_tree(jstate.params_g),
                                "buffers": to_numpy_tree(jstate.buffers)}, state.net)
    for k, v in state.net.state_dict().items():
        if k not in ("codebook.initialized", "codebook.call_cnt"):
            assert torch.equal(v, want[k]), k
    fresh = trainer.init_state(seed=0)  # what the checkpoint does not hold keeps its init
    for which in ("image", "video"):
        disc = getattr(state, f"{which}_disc")
        want = state_dict_from_jax({"params": to_numpy_tree(jstate.params_d[which]),
                                    "batch_stats": to_numpy_tree(jstate.batch_stats_d[which])},
                                   disc)
        init = getattr(fresh, f"{which}_disc").state_dict()
        from_ckpt = 0
        for k, v in disc.state_dict().items():
            if which == "image" or (init_vdis and not (k.startswith("model3_norm"))):
                assert torch.equal(v, want[k]), f"{which}: {k}"
                from_ckpt += 1
            else:
                assert torch.equal(v, init[k]), f"{which}: {k}"
        assert from_ckpt > 0 or (which == "video" and init_vdis is None)


def test_feature_extractors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for load in (i3d.load_i3d, inception.load_inception):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load()
