"""The port's host pieces against the JAX package's, on files written here
from numpy seeds: CLIP's BPE ids on a merge table learned here (HTML
entities, non-ASCII text, truncation, context lengths 77 and 256, a .gz
table) and the merge table's default place; every HDF5 / vtokens / frame
folder / stft / smap / text family's samples bit for bit over two passes
from the same seed; CoinRun's frames bit-equal to the JAX renderer at 64^2
on an asset tree written here, its samples with auto-captions and manual
captions equal; the offline wandb run equal to the JAX WandbRun's but for
`_runtime`; and vqgan_train's --ckpt_backend msgpack: a port-written train
state restored by the JAX package's training.loop.load_state against
TokenizerTrainer.init_state's template, every leaf equal, for three
optimizer layouts, and the port's resume of it equal to the state it
wrote, moments included."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.data import coinrun as jax_coinrun
from omnitokenizer_tpu.data import coinrun_text as jax_coinrun_text
from omnitokenizer_tpu.data import hdf5 as jax_hdf5
from omnitokenizer_tpu.data import text_tokenizer as jax_text
from omnitokenizer_tpu_torch.data import coinrun, coinrun_text, hdf5, text_tokenizer

from torch_port_util import (CAPTIONS, to_numpy_tree, write_coinrun, write_host_families,
                             write_merge_table)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_data")
    out = write_host_families(root / "families")
    write_coinrun(root / "coinrun", captions=True)
    out["coinrun"] = str(root / "coinrun")
    out["captions"] = str(root / "captions.json")
    out["bpe"] = write_merge_table(root / "bpe_simple_vocab_16e6.txt")
    return out


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


TEXTS = {
    "plain": "Mugen runs to the right and collects a coin.",
    "html": "Mugen &amp;amp; the bee &lt;3 &quot;slime&quot;",
    "non-ascii": "café au lait, naïve — 東京 über alles ☃",
    "truncation": " ".join(CAPTIONS * 12),
}


@pytest.mark.parametrize("case", list(TEXTS))
def test_bpe_ids_match_jax(data, case):
    text = TEXTS[case]
    port, ref = text_tokenizer.SimpleTokenizer(data["bpe"]), jax_text.SimpleTokenizer(data["bpe"])
    assert port.vocab_size == ref.vocab_size > 512 + 2 + 100  # bytes, merges, sot and eot
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port.decode(ids) == ref.decode(ids)
    for n in (77, 256):
        assert port(text, n) == ref(text, n)
        assert port.tokenize(text, n) == ref.tokenize(text, n)
        assert len(port.tokenize(text, n)) == n
        if len(ids) + 2 > n:
            with pytest.raises(RuntimeError, match="too long"):
                port.tokenize(text, n, truncate_text=False)
    if case == "truncation":
        assert len(ids) + 2 > 256 and port.tokenize(text, 77)[-1] == port.encoder["<|endoftext|>"]


def test_merge_table_default_place(data, tmp_path, monkeypatch):
    import gzip

    monkeypatch.setattr(text_tokenizer, "VOCAB_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="bpe_simple_vocab_16e6.txt") as e:
        text_tokenizer.SimpleTokenizer()
    assert str(tmp_path) in str(e.value)
    with open(data["bpe"], "rb") as f, gzip.open(tmp_path / "bpe_simple_vocab_16e6.txt.gz",
                                                 "wb") as g:
        g.write(f.read())
    text = TEXTS["html"]
    assert (text_tokenizer.SimpleTokenizer().tokenize(text, 77)
            == jax_text.SimpleTokenizer(str(tmp_path / "bpe_simple_vocab_16e6.txt.gz"))
            .tokenize(text, 77))


def _families(data):
    """(port dataset, JAX dataset) of each HDF5 / frame / stft family."""
    v = dict(sequence_length=5, resolution=16)
    return {
        "hdf5": lambda m: m.HDF5Dataset(data["hdf5"], 5, resolution=16, sample_every_n_frames=2,
                                        seed=3),
        "hdf5-test": lambda m: m.HDF5Dataset(data["hdf5"], 4, train=False, resolution=20),
        "text": lambda m: m.HDF5DatasetText(data["text"], 5, resolution=16, text_len=77,
                                            bpe_path=data["bpe"]),
        "smap": lambda m: m.HDF5DatasetSmap(data["hdf5"], data["smap"], 5, resolution=16),
        "vtokens-crop": lambda m: m.HDF5DatasetVtokens(data["vtokens"], 4, resolution=6,
                                                       spatial_length=4, seed=5),
        "vtokens": lambda m: m.HDF5DatasetVtokens(data["vtokens"], 4, resolution=6,
                                                  spatial_length=6),
        "frames": lambda m: m.FrameDataset(data["frames"], 3, resolution=16,
                                           sample_every_n_frames=2),
        "stft": lambda m: m.StftDataset(data["stft"], **v),
    }


@pytest.mark.parametrize("family", ["hdf5", "hdf5-test", "text", "smap", "vtokens-crop",
                                    "vtokens", "frames", "stft"])
def test_family_samples_match_jax(data, family):
    make = _families(data)[family]
    port, ref = make(hdf5), make(jax_hdf5)
    assert len(port) == len(ref) > 0
    for i in list(range(len(port))) * 2:  # two passes: the draws go on in step
        _same(port[i], ref[i])
    if family == "text":
        assert port[0]["text"].dtype == np.int32 and port[0]["text"].shape == (77,)


def test_coinrun_frames_bit_equal(data):
    games = sorted(glob.glob(os.path.join(data["coinrun"], "*.json")))
    for path in games[:2]:
        port, ref = coinrun.Game.from_json(path), jax_coinrun.Game.from_json(path)
        assert port.maze == ref.maze and port.flattened_monster_names == ref.flattened_monster_names
        port.video_res = ref.video_res = 64
        k = port.zoom * 64 / port.maze_w
        pb = coinrun.AssetBank(port, os.path.join(data["coinrun"], "assets"), k, k)
        rb = jax_coinrun.AssetBank(ref, os.path.join(data["coinrun"], "assets"), k, k)
        for f in range(len(port.frames)):
            got = coinrun.draw_game_frame(port, f, pb, k, k)
            np.testing.assert_array_equal(got, jax_coinrun.draw_game_frame(ref, f, rb, k, k))
            assert got.std() > 10  # sprites and background drawn
        for a, b in ((0, -1), (0, 4), (3, 9), (5, 7), (2, 2)):
            assert (coinrun_text.describe_clip(port, a, b)
                    == jax_coinrun_text.describe_clip(ref, a, b))


def test_coinrun_samples_and_captions_match_jax(data, monkeypatch):
    monkeypatch.setattr(jax_text, "REFERENCE_VOCAB", data["bpe"])
    assets = os.path.join(data["coinrun"], "assets")
    for kw in (dict(), dict(get_text_desc=True, text_seq_len=32),
               dict(get_text_desc=True, text_seq_len=256, text_path=data["captions"], seed=7)):
        port = coinrun.CoinRunDataset(data["coinrun"], assets, 6, 64, bpe_path=data["bpe"], **kw)
        ref = jax_coinrun.CoinRunDataset(data["coinrun"], assets, 6, 64, **kw)
        assert len(port) == len(ref) == 4
        for i in [0, 1, 2, 3, 1]:
            _same(port[i], ref[i])
    sample = port[0]  # game00 has a manual caption
    tk = text_tokenizer.SimpleTokenizer(data["bpe"])
    assert sample["text"].dtype == np.int64
    np.testing.assert_array_equal(sample["text"], tk.tokenize("Mugen does a custom thing.", 256))
    long = coinrun.CoinRunDataset(data["coinrun"], assets, 12, 16)[0]["video"]
    assert long.shape == (12, 16, 16, 3) and (long[9:] == -0.5).all()  # zero frames past 9


def test_wandb_history_matches_jax(tmp_path):
    from omnitokenizer_tpu.training.loop import MetricsLogger as JaxLogger
    from omnitokenizer_tpu.utils.wandb_logger import WandbRun as JaxRun
    from omnitokenizer_tpu_torch.training.loop import MetricsLogger
    from omnitokenizer_tpu_torch.utils.wandb_logger import WandbRun

    config = {"lr": 1e-4, "arch": ["t", "w"], "dtype": torch.bfloat16, "n": None}
    runs = []
    for side, cls in (("port", WandbRun), ("jax", JaxRun)):
        run = cls(project="p", name="t", config=config, root=str(tmp_path / side), mode="offline")
        run.log({"loss": 1.5, "vec": [1, 2], "t": torch.tensor(0.25), "a": np.float32(2)}, step=0)
        run.log({"loss": 1.0}, step=5)
        run.log({"loss": 0.5})
        run.finish()
        runs.append(run.dir)
    cfgs = [json.load(open(os.path.join(d, "config.json"))) for d in runs]
    assert cfgs[0] == cfgs[1] and cfgs[0]["dtype"] == "torch.bfloat16"

    def history(d, drop=("_runtime",)):
        return [{k: v for k, v in json.loads(ln).items() if k not in drop}
                for ln in open(os.path.join(d, "history.jsonl"))]

    assert history(runs[0]) == history(runs[1])
    assert [h["_step"] for h in history(runs[0])] == [0, 5, 6]
    # the loggers' mirror: the same records, but for the clock's
    logs = []
    for side, cls in (("port-log", MetricsLogger), ("jax-log", JaxLogger)):
        logger = cls(str(tmp_path / side), log_every=10, wandb_project="omnitokenizer",
                     wandb_config={"x": 1})
        logger.log(1, {"recon_loss": 0.25, "loss": np.float32(3)})
        logger.log(2, {"recon_loss": 0.125})
        logs.append(glob.glob(str(tmp_path / side / "wandb" / "run-*"))[0])
    assert history(logs[0], ("_runtime", "time")) == history(logs[1], ("_runtime", "time"))


# -- vqgan_train --ckpt_backend msgpack ---------------------------------------------------
TINY = dict(embedding_dim=16, n_codes=32, codebook_dim=4, resolution=16, sequence_length=5,
            patch_size=8, temporal_patch_size=2, enc_block="t", dec_block="t", spatial_depth=1,
            temporal_depth=1, dim_head=8, heads=2, norm_type="batch")
LOSS = dict(disc_layers=1, disc_channels=8, apply_noise=True, perceptual_weight=0.0,
            discriminator_iter_start=0)
LAYOUTS = {"clip": dict(grad_clip_val=1.0, grad_clip_val_disc=1.0),
           "no-clip": dict(grad_clip_val=None, grad_clip_val_disc=None),
           "accumulate": dict(grad_clip_val=1.0, grad_clip_val_disc=None, grad_accumulates=2)}


class _JitInit:
    """A flax module whose init runs under jax.jit (the same draws as op by
    op, several times faster on the CPU)."""

    def __init__(self, module):
        self.module = module

    def init(self, rngs, x, *static, **kw):
        return jax.jit(lambda r, x: self.module.init(r, x, *static, **kw))(rngs, x)


@pytest.fixture(scope="module")
def jax_template():
    """The JAX TokenizerTrainState of TINY from init_state (its networks once)."""
    from omnitokenizer_tpu.config import LossConfig, TokenizerConfig, TrainConfig
    from omnitokenizer_tpu.training import trainer as jtrainer

    trainer = jtrainer.TokenizerTrainer(TokenizerConfig(**TINY), LossConfig(**LOSS),
                                        TrainConfig(**LAYOUTS["clip"]))
    nets = trainer.net, trainer.image_disc, trainer.video_disc
    trainer.net, trainer.image_disc, trainer.video_disc = (_JitInit(m) for m in nets)
    try:
        state = trainer.init_state(seed=0, image_size=16, frames=5)
    finally:
        trainer.net, trainer.image_disc, trainer.video_disc = nets
    return state


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ckpt_backend_msgpack_restored_by_jax(jax_template, layout, tmp_path):
    from flax import serialization

    from omnitokenizer_tpu.config import TrainConfig as JaxTrainConfig
    from omnitokenizer_tpu.training import loop as jax_loop
    from omnitokenizer_tpu.training import trainer as jtrainer
    from omnitokenizer_tpu_torch.config import LossConfig, TokenizerConfig, TrainConfig
    from omnitokenizer_tpu_torch.convert import train_state_to_jax
    from omnitokenizer_tpu_torch.training import loop, trainer as ttrainer

    train = dict(lr=1e-3, warmup_steps=1, max_steps=10, **LAYOUTS[layout])
    tr = ttrainer.TokenizerTrainer(TokenizerConfig(**TINY), LossConfig(**LOSS),
                                   TrainConfig(**train), device="cpu")
    video = np.random.RandomState(0).rand(2, 5, 16, 16, 3).astype(np.float32) - 0.5
    root = str(tmp_path / "run")
    steps = train.get("grad_accumulates", 1)  # one optimizer update
    state = loop.train_tokenizer(tr, iter([{"video": video}] * 4), root, max_steps=steps,
                                 img_every=0, seed=11, ckpt_backend="msgpack")
    path = os.path.join(root, "checkpoints", f"step_{steps:08d}.msgpack")
    assert os.listdir(os.path.dirname(path)) == [os.path.basename(path)]
    assert float(state.opt_g.nu[0].abs().max()) > 0 and state.opt_g.count == 1
    want = train_state_to_jax(state, tr.opt_g, tr.opt_d)

    # the JAX loader against init_state's template (the layout's optimizers)
    jtc = JaxTrainConfig(**train)
    opt_g = jtrainer._make_opt(jtrainer._g_schedule(jtc), jtc.grad_clip_val, jtc.grad_accumulates)
    opt_d = jtrainer._make_opt(jtrainer._d_schedule(jtc), jtc.grad_clip_val_disc,
                               jtc.grad_accumulates)
    template = jax_template.replace(opt_g=opt_g.init(jax_template.params_g),
                                    opt_d=opt_d.init(jax_template.params_d))
    restored = jax_loop.load_state(path, template)
    got = to_numpy_tree(serialization.to_state_dict(restored))
    tmpl = to_numpy_tree(serialization.to_state_dict(template))
    flat_want = dict(_leaves(want))
    flat_got, flat_tmpl = dict(_leaves(got)), dict(_leaves(tmpl))
    assert sorted(flat_got) == sorted(flat_tmpl) == sorted(flat_want)
    for k, t in flat_tmpl.items():
        g = flat_got[k]
        assert g.dtype == t.dtype and g.shape == t.shape, k
        np.testing.assert_array_equal(g, np.asarray(flat_want[k]), err_msg="/".join(k))
    assert int(restored.step) == steps and list(np.asarray(restored.rng)) == [0, 11]

    # the port's resume from that file: the state it wrote, moments included
    again = loop.train_tokenizer(tr, iter([]), root, max_steps=steps, img_every=0,
                                 initial_state=tr.init_state(seed=3), ckpt_backend="msgpack")
    assert (again.step, again.seed) == (state.step, state.seed) == (steps, 11)
    for m in state.MODULES:
        for k, v in getattr(state, m).state_dict().items():
            assert torch.equal(getattr(again, m).state_dict()[k], v), (m, k)
    for name in ("opt_g", "opt_d"):
        a, b = getattr(again, name), getattr(state, name)
        assert (a.count, a.lr_count, a.mini_step, a.gradient_step) == (
            b.count, b.lr_count, b.mini_step, b.gradient_step)
        for x, y in zip(a.mu + a.nu + (a.acc or []), b.mu + b.nu + (b.acc or [])):
            assert torch.equal(x, y)


def test_ckpt_backend_orbax_refused(tmp_path):
    from omnitokenizer_tpu_torch.cli import vqgan_train

    with pytest.raises(NotImplementedError, match="tensorstore"):
        vqgan_train.main(["--data_path", str(tmp_path), "--train_datalist", "x",
                          "--ckpt_backend", "orbax", "--device", "cpu"])
