"""The port's GPT checkpoint loading and its transformer_eval CLI against the
JAX package's, on the CPU: a reference-named GPT state_dict (a Net2Net
Lightning checkpoint with the "transformer." prefix beside the tokenizer's
keys and minGPT's mask buffers, or a bare one) loads bit-equal to the JAX
route (convert_gpt_state, then convert.gpt_state_dict_from_jax), which is
strict; and transformer_eval with --device cpu, at top_k=1 (the greedy
token on both sides), writes the JAX CLI's class PNGs (within 1 of 255),
its npz files, and its frame predictions (within 2e-4)."""

import argparse
import glob
import os

import numpy as np
import pytest
import torch

from omnitokenizer_tpu.cli import transformer_eval as jax_cli
from omnitokenizer_tpu.config import GPTConfig as JaxGPTConfig
from omnitokenizer_tpu.utils.checkpoint import config_from_args
from omnitokenizer_tpu.utils.gpt_checkpoint import load_gpt_torch_checkpoint
from omnitokenizer_tpu_torch.cli import transformer_eval
from omnitokenizer_tpu_torch.cli import vqgan_eval
from omnitokenizer_tpu_torch.convert import gpt_state_dict_from_jax
from omnitokenizer_tpu_torch.models.gpt import GPT
from omnitokenizer_tpu_torch.utils.gpt_checkpoint import load_gpt_checkpoint

from torch_port_util import (gpt_configs, random_gpt_params, reference_state_dict, to_numpy_tree,
                             write_lightning_ckpt)

torch.set_num_threads(2)
# tests/test_torch_cli.py's TINY tokenizer (a 4x4 token grid of 32 codes), 5 frames
TOK_FLAGS = ["--embedding_dim", "16", "--n_codes", "32", "--codebook_dim", "4",
             "--patch_size", "4", "--temporal_patch_size", "2", "--enc_block", "t",
             "--dec_block", "t", "--spatial_depth", "1", "--temporal_depth", "1",
             "--dim_head", "8", "--heads", "2", "--spatial_pos", "rope", "--resolution", "16",
             "--sequence_length", "5", "--norm_type", "batch"]
GPT_FLAGS = ["--n_layer", "2", "--n_head", "2", "--n_embd", "32", "--top_k", "1",
             "--decode_bucket", "4"]


def reference_gpt_state_dict(n_layer: int, vocab: int, block: int, seed: int) -> dict:
    """The reference's minGPT keys at width 32 (numpy, random), with a causal
    mask buffer in each block as minGPT registers it."""
    jcfg, _ = gpt_configs(n_layer=n_layer, vocab_size=vocab, block_size=block)
    params = random_gpt_params(jcfg, seed)
    sd = {k: v.numpy() for k, v in gpt_state_dict_from_jax(params).items()}
    for i in range(n_layer):
        sd[f"blocks.{i}.attn.mask"] = np.tril(np.ones((1, 1, block, block), np.float32))
    return sd


@pytest.mark.parametrize("prefixed", [True, False], ids=["net2net", "bare"])
def test_gpt_checkpoint_loads_bit_equal_to_jax_route(tmp_path, prefixed):
    sd = reference_gpt_state_dict(2, 50, 24, seed=5)
    if prefixed:
        sd = {**{"transformer." + k: v for k, v in sd.items()},
              "first_stage_model.post_vq_conv.weight": np.ones((4, 4), np.float32)}
    path = tmp_path / "gpt.ckpt"
    write_lightning_ckpt(path, sd, n_layer=2)
    got = load_gpt_checkpoint(str(path))
    jcfg = JaxGPTConfig(vocab_size=50, block_size=24, n_layer=2, n_head=2, n_embd=32)
    want = gpt_state_dict_from_jax(to_numpy_tree(load_gpt_torch_checkpoint(str(path), jcfg)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    _, tcfg = gpt_configs()
    GPT(tcfg).load_state_dict(got)  # strict


def test_gpt_conversions_are_strict(tmp_path):
    sd = reference_gpt_state_dict(2, 50, 24, seed=6)
    del sd["blocks.1.mlp.2.bias"]
    write_lightning_ckpt(tmp_path / "gpt.ckpt", sd)
    with pytest.raises(KeyError, match="blocks.1.mlp.2.bias"):
        load_gpt_checkpoint(str(tmp_path / "gpt.ckpt"))
    jcfg, _ = gpt_configs()
    params = random_gpt_params(jcfg, 0)
    with pytest.raises(KeyError, match="no port tensor"):
        gpt_state_dict_from_jax({**params, "extra": {"kernel": np.zeros((2, 2))}})
    del params["block1"]["fc"]
    with pytest.raises(KeyError, match="left unfilled"):
        gpt_state_dict_from_jax(params)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A tokenizer checkpoint self-described by its hparams, a class-
    conditional GPT (32 codes + 10 classes + sos) and an unconditional one,
    and 4 GIF clips of 5 frames with their list."""
    import imageio.v3 as iio

    root = tmp_path_factory.mktemp("lm_cli")
    hp = vars(vqgan_eval.build_parser().parse_args(TOK_FLAGS + ["--vqgan_ckpt", "x"]))
    write_lightning_ckpt(root / "tok.ckpt",
                         reference_state_dict(config_from_args(argparse.Namespace(**hp)), seed=3),
                         **hp)
    write_lightning_ckpt(root / "class.ckpt", {"transformer." + k: v for k, v in
                                               reference_gpt_state_dict(2, 43, 24, 7).items()})
    write_lightning_ckpt(root / "uncond.ckpt", reference_gpt_state_dict(2, 32, 48, 8))
    rng = np.random.RandomState(0)
    for i in range(4):
        iio.imwrite(str(root / f"clip_{i}.gif"), rng.randint(0, 255, (5, 16, 16, 3), np.uint8),
                    loop=0)
    (root / "k600_tiny.txt").write_text("".join(f"clip_{i}.gif\n" for i in range(4)))
    return root


def _both(root, tmp_path, flags):
    """Run the JAX CLI and the port's (--device cpu) with the same flags;
    return their save directories."""
    out = []
    for name, main, own in (("jax", jax_cli.main, []),
                            ("port", transformer_eval.main, ["--device", "cpu"])):
        save = str(tmp_path / name)
        main(flags + own + ["--save", save])
        out.append(save)
    return out


def _class_flags(root):
    return ["--gpt_ckpt", str(root / "class.ckpt"), "--vqvae", str(root / "tok.ckpt"),
            "--inference_type", "class", "--starts_with_sos", "--class_first",
            "--class_cond_dim", "10", "--block_size", "24", "--cfg_ratio", "1.5",
            "--sequence_length", "1", "--n_sample", "10"] + GPT_FLAGS


def test_class_generation_matches_jax_cli(ckpts, tmp_path):
    """10 classes in batches of 8 and 2, CFG with the step ramp: the same
    PNGs, within 1 of 255 (the pixels within 2e-4 before the uint8 cast)."""
    from PIL import Image

    jax_dir, port_dir = _both(ckpts, tmp_path, _class_flags(ckpts))
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) == [f"class{c:04d}.png" for c in range(10)]
    for n in names:
        got = np.asarray(Image.open(os.path.join(port_dir, n)), np.int16)
        want = np.asarray(Image.open(os.path.join(jax_dir, n)), np.int16)
        assert got.shape == (16, 16, 3) and np.abs(got - want).max() <= 1, n


def test_class_generation_npz_and_refusals(ckpts, tmp_path):
    flags = _class_flags(ckpts) + ["--device", "cpu", "--n_sample", "3", "--save_as", "npz",
                                   "--int8", "--save", str(tmp_path / "npz")]
    assert transformer_eval.main(flags) == 3
    files = sorted(glob.glob(str(tmp_path / "npz" / "*.npz")))
    assert len(files) == 3
    img = np.load(files[0])["image"]
    assert img.shape == (3, 16, 16) and np.isfinite(img).all()
    # tensor-parallel decode runs over processes (tests/test_torch_parallel_tp.py); as in
    # the JAX CLI it is refused with --int8, and one process is no group of 2
    with pytest.raises(ValueError, match="mutually exclusive"):
        transformer_eval.main(flags + ["--model_parallel", "2"])
    no_int8 = [f for f in flags if f != "--int8"]
    with pytest.raises(ValueError, match="needs that many processes"):
        transformer_eval.main(no_int8 + ["--model_parallel", "2"])
    # a JAX .msgpack LM is read (tests/test_torch_msgpack_cli.py); one that is not the
    # JAX CLI's (params, opt_state, step) tuple raises, naming what it holds
    from omnitokenizer_tpu_torch.utils.msgpack_io import write_msgpack

    write_msgpack(str(tmp_path / "gpt.msgpack"), {"params": {}})
    with pytest.raises(KeyError, match="entry '0'"):
        transformer_eval.main(flags + ["--gpt_ckpt", str(tmp_path / "gpt.msgpack")])
    if not torch.cuda.is_available():  # the card by default: no CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            transformer_eval.main(_class_flags(ckpts) + ["--save", str(tmp_path / "card")])


def test_frame_prediction_matches_jax_cli(ckpts, tmp_path):
    """The 4 clips in one batch: 2 latent frames encoded, the third
    continued by the unconditional LM; the same npz files."""
    flags = ["--gpt_ckpt", str(ckpts / "uncond.ckpt"), "--vqvae", str(ckpts / "tok.ckpt"),
             "--inference_type", "frame_prediction", "--unconditional", "--block_size", "48",
             "--data_path", str(ckpts), "--val_datalist", str(ckpts / "k600_tiny.txt"),
             "--resolution", "16", "--sequence_length", "5", "--batch_size", "4",
             "--num_workers", "0", "--n_sample", "4"] + GPT_FLAGS
    jax_dir, port_dir = _both(ckpts, tmp_path, flags)
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) == [f"pred{i:05d}.npz" for i in range(4)]
    for n in names:
        got, want = np.load(os.path.join(port_dir, n)), np.load(os.path.join(jax_dir, n))
        assert got["video"].shape == (3, 5, 16, 16)
        np.testing.assert_array_equal(got["ground_truth"], want["ground_truth"])
        np.testing.assert_allclose(got["video"], want["video"], atol=2e-4, rtol=1e-3)
