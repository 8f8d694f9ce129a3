"""The port's msgpack reader and writer (utils/msgpack_io.py) against flax,
and the key maps' inverses, on the CPU. Every file is written by the JAX
package's own writers: save_tokenizer_checkpoint with and without its
.cfg.json sidecar, in f32 and in bfloat16; training/loop.save_state's
step_*.msgpack (a TokenizerTrainState); transformer_train's
(params, opt_state, step) tuple and convert_ckpt's (params, None, 0);
save_diffusion_state's DiffusionTrainState; and a tokenizer whose arrays
are chunked (flax's MAX_CHUNK_SIZE lowered for that write only). The port
reads each with every leaf bit-equal to flax.serialization.msgpack_restore
(dtype, shape and bytes), tuples as dicts keyed '0', '1', ... and None as
None, and the training state's generator and discriminators reach the
port's modules bit-equal. The port's writer gives flax's bytes for the
same tree (numpy or torch leaves, chunked or not), and flax reads them
back. Each key map's inverse (tokenizer, GPT with and without the vtokens
table, DiT, Latte) gives the JAX model's init tree, key for key and shape
for shape, and port -> tree -> port is bit-equal; the JAX package loads
the port-written tokenizer. A truncated file, a foreign extension type and
a tree with a leaf too many or too few raise, naming where."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from omnitokenizer_tpu.config import LossConfig as JaxLossConfig
from omnitokenizer_tpu.config import TrainConfig as JaxTrainConfig
from omnitokenizer_tpu.models import dit as jdit
from omnitokenizer_tpu.models import latte as jlatte
from omnitokenizer_tpu.training import trainer as jtrainer
from omnitokenizer_tpu.training.diffusion_loop import DiffusionTrainState, save_diffusion_state
from omnitokenizer_tpu.training.loop import save_state as jax_save_state
from omnitokenizer_tpu.utils.checkpoint import load_tokenizer_checkpoint as jax_load
from omnitokenizer_tpu.utils.checkpoint import save_tokenizer_checkpoint as jax_save
from omnitokenizer_tpu_torch import convert
from omnitokenizer_tpu_torch.config import LossConfig, TrainConfig
from omnitokenizer_tpu_torch.models import dit as tdit
from omnitokenizer_tpu_torch.models import latte as tlatte
from omnitokenizer_tpu_torch.models.gpt import GPT
from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet, init_weights
from omnitokenizer_tpu_torch.training import trainer as ttrainer
from omnitokenizer_tpu_torch.utils import msgpack_io as M
from omnitokenizer_tpu_torch.utils.checkpoint import load_tokenizer_checkpoint

from torch_port_util import (DIT_SMALL, LATTE_SMALL, configs, gpt_configs, random_diffusion_params,
                             random_gpt_params, to_numpy_tree)

torch.set_num_threads(1)
LOSS = dict(perceptual_weight=1.0, image_gan_weight=1.0, video_gan_weight=1.0, disc_layers=2,
            disc_channels=16)
VTOKENS = dict(vtokens_seq_len=2, vtokens_res=3, vtokens_crop=2)


def assert_bit_equal(got, want, path=""):
    """The port's tree against flax's: dicts key for key, arrays by dtype,
    shape and bytes, Python leaves by value and type."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_bit_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor), path
        assert M._NAMES[got.dtype] == want.dtype.name and tuple(got.shape) == want.shape, path
        raw = got.contiguous().reshape(-1).view(torch.uint8) if got.numel() else got
        assert raw.numpy().tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


class _JitInit:
    """A flax module whose init runs under jax.jit (tests/test_torch_trainer.py)."""

    def __init__(self, module):
        self.module = module

    def init(self, rngs, x, *static, **kw):
        return jax.jit(lambda r, x: self.module.init(r, x, *static, **kw))(rngs, x)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path} of the JAX writers' files, and the trees they hold."""
    root = tmp_path_factory.mktemp("msgpack")
    jcfg, _ = configs()
    trainer = jtrainer.TokenizerTrainer(jcfg, JaxLossConfig(**LOSS), JaxTrainConfig())
    nets = trainer.net, trainer.image_disc, trainer.video_disc
    trainer.net, trainer.image_disc, trainer.video_disc = (_JitInit(m) for m in nets)
    try:
        state = trainer.init_state(seed=0, image_size=32, frames=5)
    finally:
        trainer.net, trainer.image_disc, trainer.video_disc = nets
    variables = {"params": state.params_g, "buffers": state.buffers}
    out = {"cfg": jcfg, "state": state, "variables": variables}
    jax_save(str(root / "tok.msgpack"), variables, cfg=jcfg)
    jax_save(str(root / "bare.msgpack"), variables)
    jax_save(str(root / "bf16.msgpack"), jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, variables))
    jax_save_state(str(root / "checkpoints" / "step_00000000.msgpack"), state)
    mp = pytest.MonkeyPatch()
    mp.setattr(serialization, "MAX_CHUNK_SIZE", 4096)  # every array above 4 KiB in chunks
    try:
        jax_save(str(root / "chunked.msgpack"), variables)
    finally:
        mp.undo()

    gcfg, _ = gpt_configs()
    params = jax.tree_util.tree_map(jnp.asarray, random_gpt_params(gcfg, 1, shapes_only=True))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, weight_decay=0.01))
    for name, tree in (("lm", (params, tx.init(params), 7)), ("lm_none", (params, None, 0))):
        with open(root / f"{name}.msgpack", "wb") as f:  # transformer_train's and convert_ckpt's
            f.write(serialization.to_bytes(tree))
    out["gpt_params"] = params

    dcfg = jdit.DiTConfig(**DIT_SMALL)
    args = (jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32))
    dparams, ema = (jax.tree_util.tree_map(jnp.asarray, random_diffusion_params(
        jdit.DiT(dcfg), args, seed, shapes_only=True)) for seed in (2, 3))
    save_diffusion_state(str(root / "dit.msgpack"), DiffusionTrainState(
        dparams, ema, optax.adamw(1e-4, weight_decay=0.0).init(dparams), jnp.int32(5)))
    out["paths"] = {n: str(root / f"{n}.msgpack") for n in
                    ("tok", "bare", "bf16", "chunked", "lm", "lm_none", "dit")}
    out["paths"]["step"] = str(root / "checkpoints" / "step_00000000.msgpack")
    return out


@pytest.mark.parametrize("name", ["tok", "bare", "bf16", "chunked", "step", "lm", "lm_none",
                                  "dit"])
def test_decoder_reads_jax_files_bit_equal(files, name):
    path = files["paths"][name]
    with open(path, "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    got = M.read_msgpack(path)
    assert_bit_equal(got, want)
    assert_bit_equal(M.msgpack_restore(data), want)
    if name == "chunked":  # the chunked form was written, and comes back whole
        assert M.CHUNKED.encode() in data
        assert tuple(got["params"]["encoder"]["to_patch_emb_proj"]["kernel"].shape) == (384, 64)
    if name == "bf16":
        assert got["params"]["pre_vq_conv"]["kernel"].dtype == torch.bfloat16
    if name in ("lm", "lm_none"):  # a tuple is a dict keyed '0', '1', '2'
        assert set(got) == {"0", "1", "2"} and got["2"] == (7 if name == "lm" else 0)
        assert got["1"] is None if name == "lm_none" else isinstance(got["1"], dict)
    if name == "dit":
        assert set(got) == {"params", "ema_params", "opt_state", "step"}
        assert got["step"].dtype == torch.int32 and int(got["step"]) == 5


def test_tokenizer_loads_bit_equal_to_the_jax_trees(files):
    """The tokenizer from its variables, its bfloat16 copy and its training
    state; the training state's discriminators and LPIPS through
    load_train_state_from_jax; a missing sidecar raises as JAX's loader
    does, and a given cfg takes its place."""
    _, tcfg = configs()
    want = convert.state_dict_from_jax(to_numpy_tree(files["variables"]), OmniTokenizerNet(tcfg))
    for name in ("tok", "step", "chunked"):
        kw = {} if name == "tok" else {"cfg": tcfg}
        cfg, net, unfilled = load_tokenizer_checkpoint(files["paths"][name], **kw)
        assert unfilled == [] and cfg.embedding_dim == tcfg.embedding_dim
        got = net.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    _, net, _ = load_tokenizer_checkpoint(files["paths"]["bf16"], cfg=tcfg)
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k].to(torch.bfloat16).to(v.dtype)), k
    with pytest.raises(ValueError, match="sidecar"):
        load_tokenizer_checkpoint(files["paths"]["bare"])

    state = ttrainer.TokenizerTrainer(tcfg, LossConfig(**LOSS), TrainConfig(),
                                      device="cpu").init_state(1)
    convert.load_train_state_from_jax(M.read_msgpack(files["paths"]["step"]), state)
    jstate = files["state"]
    for module, tree in ((state.image_disc, {"params": jstate.params_d["image"],
                                             "batch_stats": jstate.batch_stats_d["image"]}),
                         (state.video_disc, {"params": jstate.params_d["video"],
                                             "batch_stats": jstate.batch_stats_d["video"]}),
                         (state.lpips, {"params": jstate.lpips_params})):
        ref = convert.state_dict_from_jax(to_numpy_tree(tree), module)
        for k, v in module.state_dict().items():
            assert torch.equal(v, ref[k]), k
    assert state.step == 0


def _flax_tree():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(3, 5).astype(np.float32),
            "nested": {"i": np.arange(70000, dtype=np.int32).reshape(7, 10000),
                       "bf": np.asarray(jnp.asarray(rng.randn(4, 3), jnp.bfloat16)),
                       "s": np.float32(2.5), "u": np.arange(5, dtype=np.uint8),
                       "b": np.array([True, False])},
            "tup": (np.zeros((0, 3), np.float64), None, 3, -200, 2 ** 40, 1.5, True, "x" * 40),
            "empty": {}, "scalar": np.asarray(np.int32(9))}


def _to_torch(x):
    """numpy arrays -> tensors (bfloat16 by its bits), containers kept in order."""
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_torch(v) for v in x)
    if isinstance(x, np.ndarray) and x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("chunk", [None, 1024], ids=["whole", "chunked"])
@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_encoder_gives_flax_bytes(monkeypatch, leaves, chunk):
    tree = _flax_tree()
    if chunk:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(M, "MAX_CHUNK_SIZE", chunk)
    want = serialization.to_bytes(tree)
    if leaves == "torch":  # the same arrays as tensors (a numpy scalar stays one)
        tree = _to_torch(tree)
    got = M.to_bytes(tree)
    assert got == want
    assert_bit_equal(M.msgpack_restore(want), serialization.msgpack_restore(got))


def _tokenizer_net():
    _, tcfg = configs()
    net = OmniTokenizerNet(tcfg)
    init_weights(net, torch.Generator().manual_seed(4))
    with torch.no_grad():  # buffers that differ from their init too
        net.codebook.embeddings.normal_(generator=torch.Generator().manual_seed(5))
        net.codebook.initialized.fill_(1)
    return net


def _jax_init(kind, files):
    """The JAX model's init tree for each inverse map's case (the
    tokenizer's: the JAX trainer's init of its generator)."""
    if kind == "tokenizer":
        return to_numpy_tree(files["variables"])
    if kind in ("gpt", "gpt_vtokens"):
        vt = VTOKENS if kind == "gpt_vtokens" else {}
        jcfg, _ = gpt_configs(vtokens_pos=bool(vt))
        return random_gpt_params(jcfg, 0, shapes_only=True, **vt)
    if kind == "dit":
        return random_diffusion_params(jdit.DiT(jdit.DiTConfig(**DIT_SMALL)), (
            jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32)),
            shapes_only=True)
    return random_diffusion_params(jlatte.Latte(jlatte.LatteConfig(**LATTE_SMALL)), (
        jnp.zeros((1, 3, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)),
        shapes_only=True)


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_shapes(v, prefix + (k,)) if isinstance(v, dict) else
                   {prefix + (k,): tuple(v.shape)})
    return out


@pytest.mark.parametrize("kind", ["tokenizer", "gpt", "gpt_vtokens", "dit", "latte"])
def test_inverse_maps_round_trip(files, kind, tmp_path):
    gen = torch.Generator().manual_seed(6)
    if kind == "tokenizer":
        model = _tokenizer_net()
        to_jax, from_jax = (lambda sd: convert.state_dict_to_jax(model),
                            lambda tree: convert.state_dict_from_jax(tree, model))
    elif kind.startswith("gpt"):
        vt = VTOKENS if kind == "gpt_vtokens" else {}
        model = GPT(gpt_configs(vtokens_pos=bool(vt))[1], **vt)
        to_jax, from_jax = convert.gpt_state_dict_to_jax, convert.gpt_state_dict_from_jax
    else:
        cls, cfg = ((tdit.DiT, tdit.DiTConfig(**DIT_SMALL)) if kind == "dit" else
                    (tlatte.Latte, tlatte.LatteConfig(**LATTE_SMALL)))
        model = cls(cfg)
        to_jax = lambda sd: convert.dit_state_dict_to_jax(sd, cfg.patch_size)  # noqa: E731
        from_jax = lambda tree: convert.dit_state_dict_from_jax(tree, cfg.patch_size)  # noqa: E731
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(generator=gen)
    sd = model.state_dict()
    tree = to_jax(sd)
    assert _shapes(tree) == _shapes(_jax_init(kind, files))
    back = from_jax(tree)
    assert set(back) == {k for k in sd if k not in ("pos_embed", "temp_embed")}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    path = str(tmp_path / "w.msgpack")
    M.write_msgpack(path, tree)  # what flax reads back, leaf for leaf
    with open(path, "rb") as f:
        assert_bit_equal(M.read_msgpack(path), serialization.msgpack_restore(f.read()))
    if kind == "tokenizer":  # the JAX package loads the port's file
        jcfg, _ = configs()
        _, variables = jax_load(path, cfg=jcfg)
        assert_bit_equal(M.read_msgpack(path), to_numpy_tree(variables))


def test_bfloat16_weights_keep_their_bits(tmp_path):
    gpt = GPT(gpt_configs()[1]).to(torch.bfloat16)
    sd = gpt.state_dict()
    tree = convert.gpt_state_dict_to_jax(sd)
    assert tree["block0"]["query"]["kernel"].dtype == torch.bfloat16
    path = str(tmp_path / "bf16.msgpack")
    M.write_msgpack(path, (tree, None, 0))
    with open(path, "rb") as f:
        flax_tree = serialization.msgpack_restore(f.read())
    assert flax_tree["0"]["block0"]["query"]["kernel"].dtype == jnp.bfloat16
    assert_bit_equal(M.read_msgpack(path), flax_tree)
    back = convert.gpt_state_dict_from_jax(M.read_msgpack(path)["0"])  # f32, exactly
    for k, v in sd.items():
        assert torch.equal(back[k], v.float()), k


def test_bad_files_raise_with_the_key_path(files, tmp_path):
    with open(files["paths"]["tok"], "rb") as f:
        data = f.read()
    with pytest.raises(M.MsgpackError, match="truncated"):
        M.msgpack_restore(data[:len(data) // 2])
    with pytest.raises(M.MsgpackError, match="bytes after"):
        M.msgpack_restore(data + b"\xc0")
    with pytest.raises(M.MsgpackError, match="params/w: msgpack ext type 2"):
        M.msgpack_restore(serialization.to_bytes({"params": {"w": 1 + 2j}}))
    with pytest.raises(M.MsgpackError, match="no msgpack form"):
        M.to_bytes({"x": object()})
    _, tcfg = configs()
    tree = to_numpy_tree(files["variables"])
    del tree["params"]["post_vq_conv"]["bias"]
    M.write_msgpack(str(tmp_path / "short.msgpack"), tree)
    with pytest.raises(KeyError, match="post_vq_conv.bias"):
        load_tokenizer_checkpoint(str(tmp_path / "short.msgpack"), cfg=tcfg)
    tree = to_numpy_tree(files["variables"])
    tree["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    M.write_msgpack(str(tmp_path / "long.msgpack"), tree)
    with pytest.raises(KeyError, match="params/extra/kernel"):
        load_tokenizer_checkpoint(str(tmp_path / "long.msgpack"), cfg=tcfg)
