"""The port's training entry point on the CPU: `train_tokenizer` over a
batch stream (checkpoints, auto-resume that continues where the
checkpoint stopped and matches an unbroken run, metrics.jsonl, the
validation pass, the reconstruction PNGs, the multi-resolution resize
against jax.image.resize's antialiased bilinear), and what the trainer
refuses: a net that went through the serving step, a VAE, a missing card."""

import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu_torch import OmniTokenizerVQGAN
from omnitokenizer_tpu_torch.config import LossConfig, TokenizerConfig, TrainConfig
from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet
from omnitokenizer_tpu_torch.training.loop import (find_latest_checkpoint, load_state,
                                                   resize_bilinear, train_tokenizer, write_png)
from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer

from torch_port_util import SMALL

torch.set_num_threads(1)


def _trainer(**tc):
    return TokenizerTrainer(TokenizerConfig(**SMALL),
                            LossConfig(perceptual_weight=0.0, image_gan_weight=1.0, disc_layers=2,
                                       disc_channels=16),
                            TrainConfig(warmup_lr_init=1e-5, **tc), device="cpu")


def _batches(seed=0):
    g = torch.Generator().manual_seed(seed)
    while True:
        yield {"video": (torch.randn(2, 5, 32, 32, 3, generator=g) * 0.2).numpy()}


def _tensors(state):
    sd = state.state_dict()
    out = {f"{m}.{k}": v for m in state.MODULES for k, v in sd[m].items()}
    for opt in ("opt_g", "opt_d"):
        for f in ("mu", "nu"):
            out.update({f"{opt}.{f}.{i}": t for i, t in enumerate(sd[opt][f])})
    return out


def _assert_same_state(a, b):
    assert a.step == b.step and a.opt_g.count == b.opt_g.count
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_train_checkpoint_and_resume(tmp_path):
    root = str(tmp_path / "run")
    first = train_tokenizer(_trainer(), _batches(), root, max_steps=3, ckpt_every=2,
                            img_every=2, log_every=1, val_batches=_batches(1), val_every=2,
                            val_steps=1)
    assert first.step == 3
    assert sorted(os.listdir(os.path.join(root, "checkpoints"))) == [
        "step_00000002.pt", "step_00000003.pt"]
    assert find_latest_checkpoint(root).endswith("step_00000003.pt")
    # the checkpoint holds the state the run ended with
    _assert_same_state(load_state(find_latest_checkpoint(root), _trainer().init_state(5)),
                       first)
    recs = [json.loads(line) for line in open(os.path.join(root, "metrics.jsonl"))]
    assert [r["step"] for r in recs if "g_total" in r] == [0, 1, 2]
    assert any("val/recon_loss" in r for r in recs)
    assert all(np.isfinite(r["g_total"]) for r in recs if "g_total" in r)
    assert sorted(os.listdir(os.path.join(root, "images", "train"))) == [
        "step_00000000.png", "step_00000001.png", "step_00000002.png"]

    # the resumed run continues at step 3 and draws what an unbroken run
    # draws: the batches it has not seen, the same random streams
    batches = _batches()
    for _ in range(3):
        next(batches)
    resumed = train_tokenizer(_trainer(), batches, root, max_steps=5, img_every=0)
    assert resumed.step == 5
    recs = [json.loads(line) for line in open(os.path.join(root, "metrics.jsonl"))]
    assert [r["step"] for r in recs if "g_total" in r] == [0, 1, 2, 3, 4]
    unbroken = train_tokenizer(_trainer(), _batches(), str(tmp_path / "unbroken"), max_steps=5,
                               img_every=0)
    _assert_same_state(resumed, unbroken)


def test_png_writer(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (w, h) == (7, 5) and not rows[:, 0].any()
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), img)


@pytest.mark.parametrize("size", [16, 24, 48])
def test_resize_matches_jax_bilinear(size):
    x = np.random.RandomState(1).randn(2, 3, 32, 32, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3, size, size, 3), "bilinear")
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    assert np.abs(got - np.asarray(want)).max() <= 1e-5 * np.abs(np.asarray(want)).max()


def test_multi_resolution_steps(tmp_path):
    trainer = _trainer(resolution_scale=[0.5])
    state = train_tokenizer(trainer, _batches(), str(tmp_path), max_steps=1, img_every=0)
    assert state.step == 1


def test_trainer_refuses_a_serving_net():
    bf16 = TokenizerConfig(**SMALL, dtype=torch.bfloat16)
    trainer = TokenizerTrainer(bf16, device="cpu")
    served = OmniTokenizerVQGAN.from_config(bf16, seed=0, device="cpu").serving()
    with pytest.raises(ValueError, match="serving step"):
        trainer.init_state(net=served.net)
    cached = OmniTokenizerNet(bf16)
    cached.prepare_kernels()  # f32 parameters, but a cache of bf16 weights
    with pytest.raises(ValueError, match="serving step"):
        trainer.init_state(net=cached)
    fresh = OmniTokenizerNet(bf16)
    state = trainer.init_state(net=fresh)
    fresh.prepare_kernels()
    with pytest.raises(ValueError, match="serving step"):
        trainer.train_step(state, torch.zeros(1, 5, 32, 32, 3))


def test_trainer_refuses_vae_and_a_missing_card(monkeypatch):
    """A VAE trains now (tests/test_torch_vae_train.py holds its step
    against JAX's); the cnn patch embed is what the trainer still refuses,
    as the JAX package cannot train it either, and a missing card."""
    TokenizerTrainer(TokenizerConfig(**SMALL, use_vae=True), device="cpu")
    with pytest.raises(NotImplementedError, match="cnn patch embed"):
        TokenizerTrainer(TokenizerConfig(**SMALL, patch_embed="cnn"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenizerTrainer(TokenizerConfig(**SMALL))
