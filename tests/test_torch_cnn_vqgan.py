"""The port's legacy CNN VQGAN (omnitokenizer_tpu_torch/models/cnn_vqgan.py)
against the JAX package's (omnitokenizer_tpu/models/cnn_vqgan.py), in f32
on the CPU at a small width, from the same reference-format state_dict
(the TATS `base.VQGAN` key scheme, random values, built here as
tests/test_reference_parity_more.py's reference model names its tensors).

- `convert_cnn_vqgan_state` equals the JAX converter's output mapped onto
  the port's modules (convert.state_dict_from_jax), tensor for tensor, for
  both norm types; the transposed convs' taps are flipped.
- `SamePadConvTranspose3d` against the JAX module and against torch's own
  ConvTranspose3d(stride=s, padding=k-1) on the padded input, at odd
  sizes and mixed strides: shapes equal, values 1e-5.
- Encode indices exact and the decode of the same indices within 2e-4 of
  the JAX model's (relative to its largest pixel), group and batch norms.
- `load_cnn_vqgan_checkpoint` from a Lightning-style `.ckpt` with its
  hparams, and the lazy `VQGAN` export."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.models import cnn_vqgan as jcnn
from omnitokenizer_tpu_torch.convert import state_dict_from_jax
from omnitokenizer_tpu_torch.models import cnn_vqgan as tcnn

from torch_port_util import to_numpy_tree, write_lightning_ckpt

torch.set_num_threads(1)

N_HIDDENS, DOWNSAMPLE, EMB, N_CODES = 32, (2, 4, 4), 16, 128


def _norm_keys(prefix, ch, norm_type, rng):
    sd = {f"{prefix}.weight": 1 + 0.1 * rng.randn(ch), f"{prefix}.bias": 0.1 * rng.randn(ch)}
    if norm_type == "batch":
        sd[f"{prefix}.running_mean"] = 0.1 * rng.randn(ch)
        sd[f"{prefix}.running_var"] = 1 + 0.1 * np.abs(rng.randn(ch))
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(7, np.int64)
    return sd


def _conv(prefix, out, inp, k, rng, transposed=False):
    shape = (inp, out) + (k,) * 3 if transposed else (out, inp) + (k,) * 3
    return {f"{prefix}.weight": rng.randn(*shape) / np.sqrt(inp * k ** 3),
            f"{prefix}.bias": 0.02 * rng.randn(out)}


def _res(prefix, ch, norm_type, rng):
    sd = _norm_keys(f"{prefix}.norm1", ch, norm_type, rng)
    sd.update(_conv(f"{prefix}.conv1.conv", ch, ch, 3, rng))
    sd.update(_norm_keys(f"{prefix}.norm2", ch, norm_type, rng))
    sd.update(_conv(f"{prefix}.conv2.conv", ch, ch, 3, rng))
    return sd


def reference_cnn_state_dict(norm_type="group", seed=0, n_hiddens=N_HIDDENS,
                             downsample=DOWNSAMPLE, emb=EMB, n_codes=N_CODES, channels=3):
    """A state_dict in the reference TATS VQGAN's names (base.py:38-94)."""
    rng = np.random.RandomState(seed)
    levels = int(max(np.log2(downsample)))
    sd = _conv("encoder.conv_first.conv", n_hiddens, channels, 3, rng)
    ch = n_hiddens
    for i in range(levels):
        out = n_hiddens * 2 ** (i + 1)
        sd.update(_conv(f"encoder.conv_blocks.{i}.down.conv", out, ch, 4, rng))
        sd.update(_res(f"encoder.conv_blocks.{i}.res", out, norm_type, rng))
        ch = out
    sd.update(_norm_keys("encoder.final_block.0", ch, norm_type, rng))
    sd.update(_conv("pre_vq_conv.conv", emb, ch, 1, rng))
    sd.update(_conv("post_vq_conv.conv", ch, emb, 1, rng))
    sd.update(_norm_keys("decoder.final_block.0", ch, norm_type, rng))
    for i in range(levels):
        out = n_hiddens * 2 ** (levels - i)
        sd.update(_conv(f"decoder.conv_blocks.{i}.up.convt", out, ch, 4, rng, transposed=True))
        sd.update(_res(f"decoder.conv_blocks.{i}.res1", out, norm_type, rng))
        sd.update(_res(f"decoder.conv_blocks.{i}.res2", out, norm_type, rng))
        ch = out
    sd.update(_conv("decoder.conv_last.conv", channels, ch, 3, rng))
    codes = 0.3 * rng.randn(n_codes, emb)
    sd.update({"codebook.embeddings": codes, "codebook.z_avg": codes.copy(),
               "codebook.N": np.ones(n_codes)})
    return {k: np.asarray(v, np.int64 if k.endswith("num_batches_tracked") else np.float32)
            for k, v in sd.items()}


def _cfg(norm_type):
    from omnitokenizer_tpu.config import TokenizerConfig as JaxConfig
    from omnitokenizer_tpu_torch.config import TokenizerConfig

    kw = dict(embedding_dim=EMB, codebook_dim=EMB, n_codes=N_CODES, norm_type=norm_type)
    return JaxConfig(**kw), TokenizerConfig(**kw)


@pytest.fixture(scope="module", params=["group", "batch"])
def models(request):
    norm_type = request.param
    sd = reference_cnn_state_dict(norm_type, seed=1)
    jcfg, tcfg = _cfg(norm_type)
    jmodel = jcnn.CnnVQGAN(jcfg, n_hiddens=N_HIDDENS, downsample=DOWNSAMPLE)
    variables = jcnn.convert_cnn_vqgan_state(sd, norm_type)
    port = tcnn.CnnVQGAN(tcfg, n_hiddens=N_HIDDENS, downsample=DOWNSAMPLE)
    port.load_state_dict(tcnn.convert_cnn_vqgan_state(sd))
    return dict(sd=sd, jmodel=jmodel, variables=variables, port=port.eval(), norm_type=norm_type)


def test_convert_equals_jax(models):
    port = models["port"]
    want = state_dict_from_jax(to_numpy_tree(models["variables"]), port)
    got = tcnn.convert_cnn_vqgan_state(models["sd"])
    assert set(got) == set(want) == set(port.state_dict())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the transposed convs' taps, flipped and transposed from the file's (in, out, *k)
    w = torch.from_numpy(models["sd"]["decoder.conv_blocks.0.up.convt.weight"])
    assert torch.equal(got["decoder.up0.weight"], w.flip(2, 3, 4).transpose(0, 1))


def _video(seed, b=2, t=4, hw=32):
    return (np.random.RandomState(seed).rand(b, t, hw, hw, 3) - 0.5).astype(np.float32)


def test_encode_indices_and_decode_match_jax(models):
    x = _video(2)
    jmodel, variables, port = models["jmodel"], models["variables"], models["port"]
    want_idx = np.asarray(jmodel.apply(variables, jnp.asarray(x), method="encode",
                                       mutable=["buffers"])[0])
    with torch.no_grad():
        got_idx = port.encode(torch.from_numpy(x))
    assert got_idx.shape == want_idx.shape == (2, 2, 8, 8)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    assert len(np.unique(want_idx)) > 8  # the codes are spread, not one

    want = np.asarray(jmodel.apply(variables, jnp.asarray(want_idx), method="decode"))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(want_idx)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


def test_forward_matches_jax(models):
    """The full pass (the codebook's eval call): reconstruction and the
    codebook's outputs."""
    x = _video(3)
    (want, vq), _ = models["jmodel"].apply(models["variables"], jnp.asarray(x),
                                           mutable=["buffers"])
    with torch.no_grad():
        got, tvq = models["port"](torch.from_numpy(x))
    np.testing.assert_array_equal(tvq["encodings"].numpy(), np.asarray(vq["encodings"]))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-4 * np.abs(np.asarray(want)).max()
    for k in ("commitment_loss", "perplexity"):
        assert abs(float(tvq[k]) - float(vq[k])) <= 1e-5 * abs(float(vq[k])), k


@pytest.mark.parametrize("size,kernel,stride", [((3, 5, 7), 4, (2, 2, 2)),
                                                ((3, 5, 7), 4, (1, 2, 2)),
                                                ((2, 3, 5), 3, (2, 1, 2)),
                                                ((1, 4, 4), 4, (1, 2, 2))])
def test_same_pad_conv_transpose(size, kernel, stride):
    """The transposed conv at odd sizes: against the JAX module (its kernel
    through state_dict_from_jax) and against torch's ConvTranspose3d on the
    replicate-padded input with the reference's (in, out, *k) weight."""
    rng = np.random.RandomState(4)
    cin, cout = 5, 6
    x = rng.randn(2, *size, cin).astype(np.float32)
    jmod = jcnn.SamePadConvTranspose3d(cout, kernel, stride)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"kernel": variables["params"]["kernel"],
                            "bias": jnp.asarray(rng.randn(cout).astype(np.float32))}}
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))

    port = tcnn.SamePadConvTranspose3d(cin, cout, kernel, stride)
    port.load_state_dict(state_dict_from_jax(to_numpy_tree(variables), port))
    with torch.no_grad():
        got = port(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    # torch's own transposed conv with the file's weight (the flip undone)
    ref = torch.nn.ConvTranspose3d(cin, cout, kernel, stride, padding=kernel - 1)
    with torch.no_grad():
        ref.weight.copy_(port.weight.transpose(0, 1).flip(2, 3, 4))
        ref.bias.copy_(port.bias)
        pads = [p for pair in reversed(tcnn.same_pad_amounts((kernel,) * 3, stride)) for p in pair]
        xt = torch.nn.functional.pad(torch.from_numpy(x).movedim(-1, 1), pads, mode="replicate")
        assert np.abs(ref(xt).movedim(1, -1).numpy() - got).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kernel,stride", [(3, 1), (4, (2, 2, 2)), (4, (1, 2, 2)), (1, 1)])
def test_same_pad_conv(kernel, stride):
    x = np.random.RandomState(5).randn(2, 3, 5, 7, 4).astype(np.float32)
    jmod = jcnn.SamePadConv3d(6, kernel, stride)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    port = tcnn.SamePadConv3d(4, 6, kernel, stride)
    port.load_state_dict(state_dict_from_jax(to_numpy_tree(variables), port))
    with torch.no_grad():
        got = port(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("norm_type", ["group", "batch"])
def test_load_cnn_vqgan_checkpoint(tmp_path, norm_type):
    """A Lightning-style .ckpt with its hparams (the reference's args)
    loads with the architecture they give; encode equals the JAX loader's
    model on the same file."""
    sd = reference_cnn_state_dict(norm_type, seed=6)
    path = tmp_path / "cnn_vqgan.ckpt"
    write_lightning_ckpt(path, sd, n_hiddens=N_HIDDENS, downsample=list(DOWNSAMPLE),
                         embedding_dim=EMB, n_codes=N_CODES, norm_type=norm_type)
    port = tcnn.load_cnn_vqgan_checkpoint(str(path), device="cpu")
    assert port.n_hiddens == N_HIDDENS and port.downsample == DOWNSAMPLE
    assert port.cfg.norm_type == norm_type and port.codebook.n_codes == N_CODES
    jmodel, variables = jcnn.load_cnn_vqgan_checkpoint(str(path))
    x = _video(7)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), method="encode",
                                   mutable=["buffers"])[0])
    with torch.no_grad():
        np.testing.assert_array_equal(port.encode(torch.from_numpy(x)).numpy(), want)
    bad = dict(sd)
    del bad["decoder.conv_last.conv.bias"]
    write_lightning_ckpt(path, bad, n_hiddens=N_HIDDENS, downsample=list(DOWNSAMPLE),
                         embedding_dim=EMB, n_codes=N_CODES, norm_type=norm_type)
    with pytest.raises(KeyError, match="decoder.conv_last.conv.bias"):
        tcnn.load_cnn_vqgan_checkpoint(str(path), device="cpu")


def test_training_call_advances_the_codebook():
    """forward(training=True) runs the tokenizer's Codebook's EMA step."""
    _, tcfg = _cfg("group")
    model = tcnn.init_cnn_vqgan(tcnn.CnnVQGAN(tcfg, N_HIDDENS, DOWNSAMPLE),
                                torch.Generator().manual_seed(0))
    before = model.codebook.embeddings.clone()
    with torch.no_grad():
        recon, vq = model(torch.from_numpy(_video(8)), training=True,
                          generator=torch.Generator().manual_seed(1))
    assert recon.shape == (2, 4, 32, 32, 3) and bool(torch.isfinite(recon).all())
    assert int(model.codebook.call_cnt) == 1 and not torch.equal(before, model.codebook.embeddings)


def test_lazy_vqgan_export():
    import omnitokenizer_tpu_torch as port

    assert port.VQGAN is tcnn.CnnVQGAN
    assert port.load_cnn_vqgan_checkpoint is tcnn.load_cnn_vqgan_checkpoint
    assert "VQGAN" in port.__all__
