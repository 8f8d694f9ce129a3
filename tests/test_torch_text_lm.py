"""Text-conditioned LM training in the port against the JAX package's, on
the CPU in f32 at tests/test_gpt.py's GPT size: a batch of caption ids
(CLIP BPE on a merge table learned here) as the condition column gives
Net2NetTransformer.loss_fn's loss within 1e-5 of the JAX loss and its
acc1 / acc5 equal, for each sos layout, through
convert.gpt_state_dict_from_jax; transformer_train --text_cond
--cond_stage_key text over a tiny CoinRun directory (its auto-captions)
takes 2 steps with the caption ids in the sequence after sos, writes
finite metrics.jsonl rows and the wandb run of --wandb_project; and the
CLI's data checks: a family with no class under --cond_stage_key label,
text without captions, ids outside the condition vocabulary, a block
that cannot hold the sequence, and --ckpt_backend."""

import argparse
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.config import Net2NetConfig as JaxN2NConfig
from omnitokenizer_tpu.models.net2net import Net2NetTransformer as JaxN2N
from omnitokenizer_tpu.utils.checkpoint import config_from_args
from omnitokenizer_tpu_torch.cli import transformer_train, vqgan_eval
from omnitokenizer_tpu_torch.config import Net2NetConfig
from omnitokenizer_tpu_torch.data import text_tokenizer
from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer
from omnitokenizer_tpu_torch.training import lm_loop

from torch_port_util import (CAPTIONS, gpt_pair, reference_state_dict, write_coinrun,
                             write_lightning_ckpt, write_merge_table)

torch.set_num_threads(2)

CODES, N, L, B = 32, 16, 8, 4
CPU_TOKENIZER = types.SimpleNamespace(device=torch.device("cpu"))
# tests/test_torch_lm_train.py's tokenizer: 16^2 clips of 5 frames -> 3 x 4 x 4 = 48 codes
TOK_FLAGS = ["--embedding_dim", "16", "--n_codes", "32", "--codebook_dim", "4",
             "--patch_size", "4", "--temporal_patch_size", "2", "--enc_block", "t",
             "--dec_block", "t", "--spatial_depth", "1", "--temporal_depth", "1",
             "--dim_head", "8", "--heads", "2", "--spatial_pos", "rope", "--resolution", "16",
             "--sequence_length", "5", "--norm_type", "batch"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A CoinRun directory (game JSONs and assets), a merge table and a
    tokenizer checkpoint self-described by its hparams."""
    root = tmp_path_factory.mktemp("text_lm")
    write_coinrun(root / "coinrun", n_games=8, n_frames=7)
    os.makedirs(root / "vocab")
    write_merge_table(root / "vocab" / "bpe_simple_vocab_16e6.txt")
    hp = vars(vqgan_eval.build_parser().parse_args(TOK_FLAGS + ["--vqgan_ckpt", "x"]))
    write_lightning_ckpt(root / "tok.ckpt",
                         reference_state_dict(config_from_args(argparse.Namespace(**hp)), seed=3),
                         **hp)
    return root


@pytest.fixture
def vocab(root, monkeypatch):
    monkeypatch.setattr(text_tokenizer, "VOCAB_DIR", str(root / "vocab"))
    return text_tokenizer.SimpleTokenizer()


@pytest.mark.parametrize("variant", ["sos", "sos-class-first", "no-sos"])
def test_text_loss_matches_jax(vocab, variant):
    kw = {"sos": {}, "sos-class-first": dict(class_first=True),
          "no-sos": dict(starts_with_sos=False)}[variant]
    cond = vocab.vocab_size
    jg, params, tg, gpt = gpt_pair(5, vocab_size=CODES + cond + 1, block_size=32)
    args = dict(class_cond_dim=cond, first_stage_vocab_size=CODES, cond_stage_key="text", **kw)
    jn = JaxN2N(JaxN2NConfig(gpt=jg, **args), None, gpt_params=params)
    tn = Net2NetTransformer(Net2NetConfig(gpt=tg, **args), CPU_TOKENIZER, gpt=gpt)
    text = np.asarray([vocab.tokenize(c, L) for c in CAPTIONS[:B]], np.int64)
    assert (text[:, -1] == vocab.encoder["<|endoftext|>"]).any() and (text == 0).any()
    z = np.random.RandomState(2).randint(0, CODES, (B, N))
    want, wm = jn.loss_fn(params, jnp.asarray(z), jnp.asarray(text, jnp.int32))
    got, gm = tn.loss_fn(torch.from_numpy(z), torch.from_numpy(text))
    got = got.detach()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    for k in ("acc1", "acc5"):
        assert float(gm[k]) == float(wm[k]), k
    inputs, _, prefix = tn.loss_inputs(torch.from_numpy(z), torch.from_numpy(text))
    sos = int(kw.get("starts_with_sos", True))
    col = 0 if kw.get("class_first") or not sos else 1
    assert torch.equal(inputs[:, col:col + L], torch.from_numpy(text) + sos)
    assert prefix == L + sos - 1


def _flags(root, run, extra=(), text=True):
    cond = (["--text_cond", "--cond_stage_key", "text", "--text_seq_len", str(L)] if text
            else [])
    return ["--vqvae", str(root / "tok.ckpt"), "--data_path", str(root / "coinrun"),
            "--train_datalist", "unused", "--default_root_dir", str(run), "--resolution", "16",
            "--sequence_length", "5", "--batch_size", str(B), "--num_workers", "0", *cond,
            "--class_cond_dim", "49408", "--starts_with_sos", "--block_size", "64",
            "--n_layer", "1", "--n_head", "2", "--n_embd", "16", "--lr", "1e-3",
            "--warmup_steps", "1", "--max_steps", "2", "--device", "cpu", *extra]


def test_cli_trains_on_coinrun_captions(root, vocab, tmp_path, monkeypatch):
    seen = []
    real = lm_loop.lm_train_step

    def spy(n2n, opt, state, z_ids, labels, **kw):
        inputs, _, _ = n2n.loss_inputs(z_ids, labels)
        seen.append((z_ids.clone(), labels.clone(), inputs.clone()))
        return real(n2n, opt, state, z_ids, labels, **kw)

    monkeypatch.setattr(lm_loop, "lm_train_step", spy)
    run = tmp_path / "run"
    state = transformer_train.main(_flags(root, run, ["--wandb_project", "omnitokenizer"]))
    assert state.step == 2 and len(seen) == 2
    sot, eot = vocab.encoder["<|startoftext|>"], vocab.encoder["<|endoftext|>"]
    for z, text, inputs in seen:
        assert z.shape == (B, 48) and text.shape == (B, L) and inputs.shape == (B, 1 + L + 47)
        assert torch.equal(inputs[:, 1:1 + L], text + 1) and (inputs[:, 0] == 0).all()
        assert (text[:, 0] == sot).all() and (text == eot).any(1).all()
        assert vocab.decode([t for t in text[0].tolist() if t not in (0, sot, eot)]) \
            .startswith("mugen")
    rows = [json.loads(ln) for ln in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r[k]) for r in rows for k in ("loss", "acc1", "acc5", "grad_norm"))
    (wandb,) = os.listdir(run / "wandb")
    hist = [json.loads(ln) for ln in open(run / "wandb" / wandb / "history.jsonl")]
    assert [h["_step"] for h in hist] == [0, 1] and hist[1]["loss"] == rows[1]["loss"]
    assert os.path.exists(run / "checkpoints" / "step_00000002.pt")


def test_cli_checks_the_data(root, vocab, tmp_path):
    run = tmp_path / "run"
    cases = ((_flags(root, run, text=False), "'coinrun' dataset family gives no class"),
             ([f for f in _flags(root, run) if f != "--text_cond"], "needs captions"),
             (_flags(root, run, ["--class_cond_dim", "100"]), "outside the condition vocabulary"),
             (_flags(root, run, ["--block_size", "40"]), "block_size 40 < 56"),
             (_flags(root, run, ["--ckpt_backend", "msgpack"]), "vqgan_train's"))
    for argv, match in cases:
        with pytest.raises(ValueError, match=match):
            transformer_train.main(argv)
