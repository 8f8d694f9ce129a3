"""The port's entry points on the JAX package's own msgpack files, on the
CPU, each against the JAX package's load of the same file. The JAX
package writes every file: save_tokenizer_checkpoint (with its .cfg.json
sidecar) of a tokenizer loaded from a reference-named checkpoint; the
(params, opt_state, step) tuple transformer_train writes; and
save_diffusion_state's DiT and Latte states. Then:
- the f32 tokenizer through load_from_checkpoint: indices exact, pixels
  within 2e-4 of the JAX model's; vqgan_eval's result on the .msgpack
  equals its result on the reference checkpoint;
- the LM: logits within 1e-5 of the JAX GPT's on the params the JAX CLI's
  from_bytes reads; transformer_eval's class samples at top_k=1 (greedy)
  equal to the JAX CLI's on the same two files, PNGs within 1 of 255;
- transformer_train --vqvae X.msgpack: one step, the GPT bit-equal to the
  step from the reference checkpoint of the same tokenizer;
- DiT and Latte through dit_sample's loader from params and ema_params,
  forwards within 1e-5 of the JAX model's; dit_train/latte_train
  --init_from (the params, as the JAX CLI takes them) the same;
- convert_ckpt: .msgpack -> .pt, and the .pt gives the same tensors and
  the same CLI outputs as the .msgpack."""

import argparse
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from PIL import Image

from omnitokenizer_tpu.cli import transformer_eval as jax_eval_cli
from omnitokenizer_tpu.config import GPTConfig as JaxGPTConfig
from omnitokenizer_tpu.models import dit as jdit
from omnitokenizer_tpu.models import latte as jlatte
from omnitokenizer_tpu.models.gpt import GPT as JaxGPT
from omnitokenizer_tpu.models.wrapper import OmniTokenizerVQGAN as JaxVQGAN
from omnitokenizer_tpu.training.diffusion_loop import DiffusionTrainState, save_diffusion_state
from omnitokenizer_tpu.utils.checkpoint import config_from_args
from omnitokenizer_tpu.utils.checkpoint import load_tokenizer_checkpoint as jax_load
from omnitokenizer_tpu.utils.checkpoint import save_tokenizer_checkpoint as jax_save
from omnitokenizer_tpu_torch import OmniTokenizerVQGAN
from omnitokenizer_tpu_torch.cli import (convert_ckpt, dit_sample, dit_train, latte_sample,
                                         latte_train, transformer_eval, transformer_train,
                                         vqgan_eval)
from omnitokenizer_tpu_torch.cli.diffusion_common import build_model
from omnitokenizer_tpu_torch.convert import load_diffusion_checkpoint, load_diffusion_state_dict
from omnitokenizer_tpu_torch.models.gpt import GPT
from omnitokenizer_tpu_torch.utils.gpt_checkpoint import load_gpt_checkpoint

from torch_port_util import (random_diffusion_params, random_gpt_params, reference_state_dict,
                             to_numpy_tree, write_lightning_ckpt)

torch.set_num_threads(2)
# tests/test_torch_transformer_eval.py's tokenizer: a 4x4 grid of 32 codes, 5 frames
TOK_FLAGS = ["--embedding_dim", "16", "--n_codes", "32", "--codebook_dim", "4",
             "--patch_size", "4", "--temporal_patch_size", "2", "--enc_block", "t",
             "--dec_block", "t", "--spatial_depth", "1", "--temporal_depth", "1",
             "--dim_head", "8", "--heads", "2", "--spatial_pos", "rope", "--resolution", "16",
             "--sequence_length", "5", "--norm_type", "batch"]
LM = ["--class_cond_dim", "10", "--block_size", "24", "--n_layer", "2", "--n_head", "2",
      "--n_embd", "32", "--starts_with_sos", "--class_first"]
DIFF = {"dit": ["--model", "DiT-S/2", "--image_size", "32", "--in_channels", "4",
                "--num_classes", "5"],
        "latte": ["--model", "Latte-S/2", "--image_size", "32", "--in_channels", "4",
                  "--num_classes", "5", "--num_frames", "5", "--extras", "2"]}
SAMPLE = ["--diffusion_steps", "8", "--noise_schedule", "squaredcos_cap_v2", "--device", "cpu",
          "--num_sampling_steps", "3", "--num_samples", "2", "--cfg_scale", "2.0"]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_diffusion(kind):
    """The JAX model the CLI flags of DIFF build, and an input for it."""
    if kind == "dit":
        cfg = jdit.dit_config("DiT-S/2", input_size=4, in_channels=4, num_classes=5)
        return jdit.DiT(cfg), (jnp.zeros((2, 4, 4, 4)), jnp.zeros((2,), jnp.int32),
                               jnp.zeros((2,), jnp.int32))
    cfg = jlatte.latte_config("Latte-S/2", input_size=4, num_frames=2, num_classes=5,
                              extras=2).replace(in_channels=4)
    return jlatte.Latte(cfg), (jnp.zeros((2, 2, 4, 4, 4)), jnp.zeros((2,), jnp.int32),
                               jnp.zeros((2,), jnp.int32))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("msgpack_cli")
    hp = vars(vqgan_eval.build_parser().parse_args(TOK_FLAGS + ["--vqgan_ckpt", "x"]))
    write_lightning_ckpt(root / "tok.ckpt",
                         reference_state_dict(config_from_args(argparse.Namespace(**hp)), seed=3),
                         **hp)
    jcfg, variables = jax_load(str(root / "tok.ckpt"))
    jax_save(str(root / "tok.msgpack"), variables, cfg=jcfg)

    gcfg = JaxGPTConfig(vocab_size=43, block_size=24, n_layer=2, n_head=2, n_embd=32)
    params = jax.tree_util.tree_map(jnp.asarray, random_gpt_params(gcfg, 7, shapes_only=True))
    tx = optax.adamw(1e-3, weight_decay=0.01)
    with open(root / "class.msgpack", "wb") as f:  # transformer_train's writer
        f.write(serialization.to_bytes((params, tx.init(params), 3)))

    rng = np.random.RandomState(0)
    lines = []
    for i in range(8):
        Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(root / f"im{i}.png")
        lines.append(f"im{i}.png\t{i % 10}")
    (root / "images.txt").write_text("\n".join(lines) + "\n")

    diffusion = {}
    for kind in ("dit", "latte"):
        model, args = _jax_diffusion(kind)
        p, ema = (jax.tree_util.tree_map(jnp.asarray, random_diffusion_params(
            model, args, s, shapes_only=True)) for s in (4, 5))
        # an SGD state in place of AdamW's moments keeps the file small: no loader reads it
        save_diffusion_state(str(root / f"{kind}.msgpack"), DiffusionTrainState(
            p, ema, optax.sgd(1e-4).init(p), jnp.int32(9)))
        diffusion[kind] = (model, {"params": p, "ema_params": ema})
    return dict(root=root, jcfg=jcfg, variables=variables, gpt_params=params, gcfg=gcfg,
                diffusion=diffusion)


def test_tokenizer_round_trip_matches_jax(files):
    root = files["root"]
    model = OmniTokenizerVQGAN.load_from_checkpoint(str(root / "tok.msgpack"), device="cpu")
    jcfg, variables = jax_load(str(root / "tok.msgpack"))  # the JAX package's own load
    jm = JaxVQGAN(jcfg, variables)
    x = np.random.RandomState(1).uniform(-0.5, 0.5, (2, 3, 5, 16, 16)).astype(np.float32)
    idx_j = np.asarray(jm.encode(x, is_image=False))
    idx_t = model.encode(x, is_image=False).numpy()
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(model.decode(idx_t, is_image=False).numpy(),
                               np.asarray(jm.decode(idx_j, is_image=False)), atol=2e-4, rtol=1e-3)


def test_vqgan_eval_reads_the_msgpack(files, tmp_path):
    root = files["root"]
    flags = TOK_FLAGS + ["--inference_type", "image", "--data_path", str(root),
                         "--val_datalist", str(root / "images.txt"), "--batch_size", "4",
                         "--num_workers", "0", "--sequence_length", "1", "--device", "cpu"]
    res = [vqgan_eval.main(flags + ["--vqgan_ckpt", str(root / name), "--save",
                                    str(tmp_path / name)])
           for name in ("tok.msgpack", "tok.ckpt")]
    assert res[0] == res[1] and res[0]["batches"] == 2


def test_lm_logits_and_greedy_samples_match_jax(files, tmp_path):
    root, gcfg = files["root"], files["gcfg"]
    template = random_gpt_params(gcfg, 0, shapes_only=True)
    with open(root / "class.msgpack", "rb") as f:  # as the JAX CLI reads it
        params, _, _ = serialization.from_bytes((template, None, 0), f.read())
    sd = load_gpt_checkpoint(str(root / "class.msgpack"))
    from torch_port_util import gpt_configs

    gpt = GPT(gpt_configs(vocab_size=43)[1])
    gpt.load_state_dict(sd)
    idx = np.random.RandomState(2).randint(0, 43, (2, 24))
    want = np.asarray(JaxGPT(gcfg).apply({"params": params}, jnp.asarray(idx))[0])
    with torch.no_grad():
        got = gpt.eval()(torch.from_numpy(idx))[0].numpy()
    assert rel(got, want) <= 1e-5

    flags = ["--gpt_ckpt", str(root / "class.msgpack"), "--vqvae", str(root / "tok.msgpack"),
             "--inference_type", "class", "--cfg_ratio", "1.5", "--sequence_length", "1",
             "--n_sample", "3", "--top_k", "1", "--decode_bucket", "4"] + LM
    jax_eval_cli.main(flags + ["--save", str(tmp_path / "jax")])
    assert transformer_eval.main(flags + ["--device", "cpu", "--save",
                                          str(tmp_path / "port")]) == 3
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 3
    for n in names:  # within 1 of 255: the pixels within 2e-4 before the uint8 cast
        got, want = (np.asarray(Image.open(tmp_path / d / n), np.int16) for d in ("port", "jax"))
        assert got.shape == (16, 16, 3) and np.abs(got - want).max() <= 1, n


def test_transformer_train_takes_the_jax_tokenizer(files, tmp_path):
    root = files["root"]
    gpts = []
    for name in ("tok.msgpack", "tok.ckpt"):
        run = tmp_path / name
        state = transformer_train.main(
            ["--vqvae", str(root / name), "--data_path", str(root),
             "--train_datalist", str(root / "images.txt"), "--default_root_dir", str(run),
             "--resolution", "16", "--sequence_length", "1", "--batch_size", "4",
             "--num_workers", "0", "--max_steps", "1", "--device", "cpu"] + LM)
        assert state.step == 1
        gpts.append(torch.load(glob.glob(str(run / "checkpoints" / "step_*.pt"))[0],
                               map_location="cpu"))
    for k, v in gpts[1]["gpt"].items():
        assert torch.equal(gpts[0]["gpt"][k], v), k


@pytest.mark.parametrize("kind", ["dit", "latte"])
def test_diffusion_loaders_match_jax(files, kind, tmp_path):
    root = files["root"]
    jm, trees = files["diffusion"][kind]
    video = kind == "latte"
    rng = np.random.RandomState(3)
    x = rng.randn(*((2, 2, 4, 4, 4) if video else (2, 4, 4, 4))).astype(np.float32)
    t, y = np.array([1, 6]), np.array([0, 4])
    sample_args = dit_sample.build_parser(video).parse_args(DIFF[kind] + ["--ckpt", "x",
                                                                          "--device", "cpu"])
    path = str(root / f"{kind}.msgpack")

    def port(sd):
        model, _ = build_model(sample_args, video, init=False)
        load_diffusion_state_dict(model, sd)
        xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 2 if video else 1)))
        with torch.no_grad():
            out = model.eval()(xt, torch.from_numpy(t), torch.from_numpy(y)).numpy()
        return np.moveaxis(out, 2 if video else 1, -1)

    for field, use_ema in (("ema_params", True), ("params", False)):
        want = np.asarray(jm.apply({"params": trees[field]}, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(y)))
        got = port(load_diffusion_checkpoint(path, 2, use_ema))
        assert rel(got, want) <= 1e-5, field
    # --init_from: the trained params, as the JAX CLI takes them
    train = (latte_train if video else dit_train).main(
        DIFF[kind] + ["--synthetic_data", "--results_dir", str(tmp_path / "run"), "--device",
                      "cpu", "--max_steps", "0", "--init_from", path])
    want = port(load_diffusion_checkpoint(path, 2, use_ema=False))
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 2 if video else 1)))
    with torch.no_grad():
        got = train.model.eval()(xt, torch.from_numpy(t), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(np.moveaxis(got, 2 if video else 1, -1), want)

    # convert_ckpt: the .pt samples what the .msgpack samples, bit for bit
    pt = str(tmp_path / f"{kind}.pt")
    convert_ckpt.main(["--kind", kind, "--src", path, "--dst", pt])
    sample = latte_sample.main if video else dit_sample.main
    outs = []
    for ckpt in (path, pt):
        for ema in ([], ["--no_ema"]):
            out_dir = str(tmp_path / f"s_{os.path.basename(ckpt)}_{len(ema)}")
            assert sample(DIFF[kind] + SAMPLE + ["--ckpt", ckpt, "--sample_dir", out_dir]
                          + ema) == 2
            outs.append(np.load(glob.glob(os.path.join(out_dir, "*.npy"))[0]))
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[1], outs[3])
    assert not np.array_equal(outs[0], outs[1])  # the EMA and the params differ


def test_convert_ckpt_tokenizer_and_gpt(files, tmp_path):
    root = files["root"]
    convert_ckpt.main(["--src", str(root / "tok.msgpack"), "--dst", str(tmp_path / "tok.pt")])
    assert os.path.exists(tmp_path / "tok.pt.cfg.json")
    a = OmniTokenizerVQGAN.load_from_checkpoint(str(root / "tok.msgpack"), device="cpu")
    b = OmniTokenizerVQGAN.load_from_checkpoint(str(tmp_path / "tok.pt"), device="cpu")
    assert b.unfilled == [] and a.cfg == b.cfg
    for k, v in a.net.state_dict().items():
        assert torch.equal(b.net.state_dict()[k], v), k
    convert_ckpt.main(["--kind", "gpt", "--src", str(root / "class.msgpack"), "--dst",
                       str(tmp_path / "gpt.pt")])
    want = load_gpt_checkpoint(str(root / "class.msgpack"))
    got = load_gpt_checkpoint(str(tmp_path / "gpt.pt"))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="sidecar"):  # a JAX file with no config, as JAX raises
        convert_ckpt.main(["--src", str(root / "class.msgpack"), "--dst",
                           str(tmp_path / "x.pt")])
