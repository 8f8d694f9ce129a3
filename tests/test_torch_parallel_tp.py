"""The port's tensor parallelism (the Megatron layout of parallel/tp.py), the
sharded-table argmin and the LM CLIs over processes, on the CPU over gloo,
against the JAX package on its virtual 8-device mesh (tests/conftest.py).

One world of 2 ranks and one of 4 each run tests/torch_parallel_worker.py's
"tp" suite once. Held against the JAX package: the Net2Net loss and its
full gradient under TP 2 and 4 (and 2 x 2 data x model on 4 ranks) against
`tp.shard_params` + `loss_fn` on `tp.tp_mesh` (2 and 4; the odd
vocabulary's on the 2-way mesh alone: GSPMD's result does not depend on
the mesh) (loss 1e-5, acc1 equal,
every gradient 1e-4 of its norm; the key biases', 0 in exact arithmetic,
held to 1e-4 of their weights'), with a vocabulary that splits over the
model axis (48) and the canonical odd case that keeps the head replicated
(43); greedy decode (TP 2 and 4) with the shards and head-sharded KV caches
against the JAX `make_sampler`, replicated and with `cache_sharding` on
`tp_mesh(4)` (tests/test_tp.py's setup, tokens exact); `vq_argmin_sharded` against `make_vq_argmin_sharded` and
`vq_argmin_xla` with ties planted across the slab borders (indices exact).
Held against the port's one process: two TP=2 optimizer steps (the clip's
norm the whole model's; moments 1e-4 of their norm, parameters 1e-5 but
2 lr where a gradient element is below that noise level); the
transformer_train CLI with --model_parallel 2 (its checkpoint the full
model: the same keys and shapes as a one-process run's, the same bars),
and transformer_eval with --model_parallel 2 and with the class split of
two data ranks (the JAX CLI's classes[rank::world] and class%04d names),
whose PNGs equal a one-process run's."""

import argparse
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from omnitokenizer_tpu.config import GPTConfig as JaxGPTConfig
from omnitokenizer_tpu.config import Net2NetConfig as JaxN2NConfig
from omnitokenizer_tpu.models.gpt import make_sampler as jax_make_sampler
from omnitokenizer_tpu.models.net2net import Net2NetTransformer as JaxN2N
from omnitokenizer_tpu.ops.codebook import make_vq_argmin_sharded, vq_argmin_xla
from omnitokenizer_tpu.parallel import tp as jtp
from omnitokenizer_tpu.utils.checkpoint import config_from_args
from omnitokenizer_tpu_torch.cli import transformer_eval, transformer_train, vqgan_eval
from omnitokenizer_tpu_torch.convert import gpt_state_dict_from_jax
from omnitokenizer_tpu_torch.ops.kernels.vq_argmin import vq_argmin_plain
from omnitokenizer_tpu_torch.parallel import tp

from torch_port_util import (check_result, random_gpt_params, reference_state_dict, run_world,
                             to_numpy_tree, write_lightning_ckpt)

torch.set_num_threads(2)

CODES, CLASSES = 32, 10
GPT = dict(block_size=24, n_layer=2, n_head=4, n_embd=32)
N2N = dict(class_cond_dim=CLASSES, first_stage_vocab_size=CODES, starts_with_sos=True,
           class_first=True)
VOCABS = {"even": 48, "odd": CODES + CLASSES + 1}
DECODE = dict(vocab_size=96, block_size=40, n_layer=2, n_head=4, n_embd=32)
# tests/test_torch_lm_train.py's tokenizer and LM flags (2 heads: TP 2 takes 1 a rank)
TOK_FLAGS = ["--embedding_dim", "16", "--n_codes", "32", "--codebook_dim", "4",
             "--patch_size", "4", "--temporal_patch_size", "2", "--enc_block", "t",
             "--dec_block", "t", "--spatial_depth", "1", "--temporal_depth", "1",
             "--dim_head", "8", "--heads", "2", "--spatial_pos", "rope", "--resolution", "16",
             "--sequence_length", "5", "--norm_type", "batch"]
LR = 1e-3


def _jax_loss_grads(spec, params, mp):
    jg = JaxGPTConfig(**spec["gpt"])
    jn = JaxN2N(JaxN2NConfig(gpt=jg, **N2N), None, gpt_params=params)
    mesh = jtp.tp_mesh(mp)
    p_tp = jtp.shard_params(params, mesh)
    z = jax.device_put(jnp.asarray(spec["z"]), NamedSharding(mesh, P("data")))
    labels = jax.device_put(jnp.asarray(spec["labels"]), NamedSharding(mesh, P("data")))

    def loss(p):
        value, m = jn.loss_fn(p, z, labels, None)
        return value, m

    (value, m), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(p_tp)
    g = {k: v.numpy() for k, v in gpt_state_dict_from_jax(to_numpy_tree(grads)).items()}
    return {"loss": float(value), "acc1": float(m["acc1"]), "grads": g}


def _lm_data(root):
    """A tokenizer checkpoint and 8 16x16 PNG images with class labels."""
    from PIL import Image

    hp = vars(vqgan_eval.build_parser().parse_args(TOK_FLAGS + ["--vqgan_ckpt", "x"]))
    write_lightning_ckpt(root / "tok.ckpt",
                         reference_state_dict(config_from_args(argparse.Namespace(**hp)), seed=3),
                         **hp)
    rng = np.random.RandomState(0)
    lines = []
    for i in range(8):
        Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(root / f"im{i}.png")
        lines.append(f"im{i}.png\t{i % CLASSES}")
    (root / "images.txt").write_text("\n".join(lines) + "\n")


def train_flags(root, run_dir, extra=()):
    return ["--vqvae", str(root / "tok.ckpt"), "--data_path", str(root),
            "--train_datalist", str(root / "images.txt"), "--default_root_dir", str(run_dir),
            "--resolution", "16", "--sequence_length", "1", "--batch_size", "4",
            "--num_workers", "0", "--block_size", "24", "--n_layer", "2", "--n_head", "2",
            "--n_embd", "32", "--class_cond_dim", str(CLASSES), "--starts_with_sos",
            "--class_first", "--lr", str(LR), "--warmup_steps", "1", "--max_steps", "2",
            "--device", "cpu"] + list(extra)


def eval_flags(root, save, extra=()):
    return ["--gpt_ckpt", str(root / "gpt.pt"), "--vqvae", str(root / "tok.ckpt"),
            "--inference_type", "class", "--starts_with_sos", "--class_first",
            "--class_cond_dim", str(CLASSES), "--block_size", "24", "--cfg_ratio", "1.5",
            "--sequence_length", "1", "--n_sample", "10", "--n_layer", "2", "--n_head", "2",
            "--n_embd", "32", "--top_k", "1", "--decode_bucket", "4", "--device", "cpu",
            "--save", str(save)] + list(extra)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every rank's inputs and the JAX references, written once."""
    root = tmp_path_factory.mktemp("tp")
    rng = np.random.RandomState(0)
    z, labels = rng.randint(0, CODES, (8, 16)), rng.randint(0, CLASSES, (8,))
    specs, refs = {}, {}
    for name, vocab in VOCABS.items():
        jcfg = JaxGPTConfig(vocab_size=vocab, **GPT)
        params = random_gpt_params(jcfg, seed=4)
        specs[name] = {"gpt": dict(vocab_size=vocab, **GPT), "n2n": N2N, "z": z,
                       "labels": labels, "layouts": [2, 4],
                       "state_dict": gpt_state_dict_from_jax(params)}
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        # GSPMD's result does not depend on the mesh: the odd vocabulary's replicated
        # head is held against the 2-way mesh alone, the split one against both
        refs[name] = {mp: _jax_loss_grads(specs[name], jparams, mp)
                      for mp in ((2, 4) if name == "even" else (2,))}
    torch.save(specs, root / "tp_loss.pt")

    # tests/test_tp.py:175's decode setup, its weights random at a trained model's scale
    jcfg = JaxGPTConfig(**DECODE)
    params = random_gpt_params(jcfg, seed=5)
    cond = np.random.RandomState(0).randint(1, 96, (2, 3))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    key = jax.random.PRNGKey(1)
    tokens = {"ref": np.asarray(jax_make_sampler(jcfg, steps=10, greedy=True)(
        jparams, jnp.asarray(cond), key))}
    mesh = jtp.tp_mesh(4)  # tests/test_tp.py's: ('data', 'model') = (2, 4)
    sample = jax_make_sampler(jcfg, steps=10, greedy=True,
                              cache_sharding=NamedSharding(mesh, P(None, "model")))
    with mesh:
        tokens["tp"] = np.asarray(sample(jtp.shard_params(jparams, mesh), jnp.asarray(cond),
                                         key))
    torch.save({"gpt": DECODE, "state_dict": gpt_state_dict_from_jax(params), "cond": cond},
               root / "tp_decode.pt")

    # the sharded-table argmin: ties across the slab borders of 2 and 4 slabs
    flat = rng.standard_normal((96, 8)).astype(np.float32)
    emb = rng.standard_normal((64, 8)).astype(np.float32)
    emb[40] = emb[21] = emb[5]
    emb[16] = emb[15]
    flat[0:4], flat[4:8] = emb[5], emb[15] + 1e-3
    np.savez(root / "vq.npz", flat=flat, emb=emb)
    vq = {"xla": np.asarray(vq_argmin_xla(jnp.asarray(flat), jnp.asarray(emb)))}
    for mp in (2, 4):
        mesh = jtp.tp_mesh(mp)
        fn = make_vq_argmin_sharded(mesh, "model")
        vq[mp] = np.asarray(jax.jit(fn)(
            jax.device_put(jnp.asarray(flat), NamedSharding(mesh, P())),
            jax.device_put(jnp.asarray(emb), NamedSharding(mesh, P("model", None)))))
    vq["plain"] = vq_argmin_plain(torch.from_numpy(flat), torch.from_numpy(emb)).numpy()
    return {"root": root, "specs": specs, "refs": refs, "tokens": tokens, "vq": vq}


@pytest.fixture(scope="module")
def cli_root(inputs):
    """The CLIs' files, their one-process runs, and the 2-rank runs' flags."""
    root = inputs["root"]
    _lm_data(root)
    transformer_train.main(train_flags(root, root / "one"))
    sd = torch.load(glob.glob(str(root / "one" / "checkpoints" / "*.pt"))[-1])
    torch.save(sd["gpt"], root / "gpt.pt")  # a bare GPT state_dict for transformer_eval
    assert transformer_eval.main(eval_flags(root, root / "eval_one")) == 10
    torch.save({"argv": train_flags(root, root / "tp", ["--model_parallel", "2"])},
               root / "cli_train.pt")
    torch.save({"argvs": [eval_flags(root, root / "eval_tp",
                                     ["--model_parallel", "2", "--distributed"]),
                          eval_flags(root, root / "eval_split", ["--distributed"])]},
               root / "cli_eval.pt")
    return root


@pytest.fixture(scope="module")
def world2(inputs, cli_root):
    return run_world("tp", 2, inputs["root"])


@pytest.fixture(scope="module")
def world4(inputs, world2, tmp_path_factory):
    root = tmp_path_factory.mktemp("tp4")
    for f in ("tp_loss.pt", "tp_decode.pt", "vq.npz"):
        os.link(inputs["root"] / f, root / f)
    return run_world("tp", 4, root)


def hold_state(got_sd, got_mu, want_sd, want_mu, lr_sum: float):
    """A layout's full checkpoint against one process's: the same keys in
    order; Adam's moments 1e-4 of their norm; the parameters 1e-5 relative
    (1e-7 absolute), but 2 lr_sum where the moment lies below that noise
    level (Adam moves such an element by lr * the rounding's sign)."""
    names = list(want_sd)
    assert list(got_sd) == names
    mus = dict(zip(names, want_mu))
    for k, mg, mw in zip(names, got_mu, want_mu):
        mg, mw = np.asarray(mg, np.float64), np.asarray(mw, np.float64)
        if k.endswith("attn.key.bias"):  # 0 in exact arithmetic: rounding alone
            noise = np.inf
            scale = np.linalg.norm(mus[k.replace("bias", "weight")])
            assert max(np.abs(mg).max(), np.abs(mw).max()) <= 1e-4 * scale, k
        else:
            noise = 1e-4 * max(np.linalg.norm(mw), 1e-12)
            assert mg.shape == mw.shape and np.linalg.norm(mg - mw) <= noise, k
        a, b = np.asarray(got_sd[k], np.float64), np.asarray(want_sd[k], np.float64)
        bound = np.where(np.abs(mw) <= noise, 2 * lr_sum, 1e-5 * np.abs(b) + 1e-7)
        assert (np.abs(a - b) <= bound).all(), k


def _hold_grads(got: dict, want: dict, tol: float = 1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if k.endswith("attn.key.bias"):  # 0 in exact arithmetic (softmax's shift)
            scale = np.linalg.norm(want[k.replace("bias", "weight")])
            assert max(np.abs(got[k]).max(), np.abs(w).max()) <= tol * scale, k
            continue
        assert np.linalg.norm(got[k] - w) <= tol * max(np.linalg.norm(w), 1e-12), k


def test_param_dims_follow_jax_specs():
    shapes = {k: v.shape for k, v in gpt_state_dict_from_jax(
        random_gpt_params(JaxGPTConfig(vocab_size=43, **GPT), 0, shapes_only=True)).items()}
    dims = tp.gpt_param_dims(shapes, 2)
    assert dims["blocks.0.attn.query.weight"] == 0 and dims["blocks.0.attn.query.bias"] == 0
    assert dims["blocks.1.mlp.0.weight"] == 0 and dims["blocks.1.mlp.0.bias"] == 0
    assert dims["blocks.0.attn.proj.weight"] == 1 and dims["blocks.0.attn.proj.bias"] is None
    assert dims["blocks.0.mlp.2.weight"] == 1 and dims["blocks.0.mlp.2.bias"] is None
    assert dims["tok_emb.weight"] == 1 and dims["pos_emb"] is None
    assert dims["head.weight"] is None  # 43 does not split: replicated, as shard_params does
    assert tp.gpt_param_dims({"head.weight": (48, 32)}, 2)["head.weight"] == 0
    with pytest.raises(ValueError, match="n_head"):
        tp.check_layout(3, 48, 2)


@pytest.mark.parametrize("vocab", list(VOCABS))
@pytest.mark.parametrize("layout", ["w2/mp2", "w4/mp4", "w4/mp2"])
def test_tp_loss_and_grads_match_jax(inputs, world2, world4, vocab, layout):
    w, mp = layout.split("/")
    res = world2 if w == "w2" else world4
    refs = inputs["refs"][vocab]
    want = refs.get(int(mp[2:]), refs[2])
    for r in range(len(res)):
        got = check_result(res, "tp_loss", r)[f"{vocab}/{mp}"]
        assert got["shards_equal"]  # shard_gpt's shards are shard_state_dict's
        assert abs(float(got["loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert float(got["acc1"]) == want["acc1"]
        _hold_grads(got["grads"], want["grads"])


def test_tp_steps_match_one_process(world2):
    v = check_result(world2, "tp_step")
    got, one = v["tp"], v["one"]
    assert "blocks.0.attn.query.weight" in got["sharded"] and "head.weight" in got["sharded"]
    np.testing.assert_allclose(got["norms"], one["norms"], rtol=1e-4)
    hold_state(got["gpt"], got["mu"], one["gpt"], one["mu"], lr_sum=2 * LR)


@pytest.mark.parametrize("mp", [2, 4])
def test_tp_greedy_decode_matches_jax(inputs, world2, world4, mp):
    toks = inputs["tokens"]
    np.testing.assert_array_equal(toks["tp"], toks["ref"])  # the JAX TP decode itself
    res = world2 if mp == 2 else world4
    for r in range(len(res)):
        got = check_result(res, "tp_decode", r)[f"mp{mp}"]
        assert got["heads"] == DECODE["n_head"] // mp
        np.testing.assert_array_equal(got["tokens"], toks["ref"])


@pytest.mark.parametrize("w", [2, 4])
def test_vq_argmin_sharded_matches_jax(inputs, world2, world4, w):
    vq = inputs["vq"]
    assert (vq["xla"][0:4] == 5).all() and (vq["xla"][4:8] == 15).all()
    np.testing.assert_array_equal(vq[w], vq["xla"])
    np.testing.assert_array_equal(vq["plain"], vq["xla"])
    for r in range(w):
        got = check_result(world2 if w == 2 else world4, "vq_sharded", r)["idx"]
        np.testing.assert_array_equal(got, vq["xla"])


def _ckpt(run_dir):
    return torch.load(sorted(glob.glob(str(run_dir / "checkpoints" / "*.pt")))[-1])


def test_cli_train_model_parallel(cli_root, world2):
    check_result(world2, "cli_train")
    got, one = _ckpt(cli_root / "tp"), _ckpt(cli_root / "one")
    assert got["step"] == one["step"] == 2
    hold_state({k: v.numpy() for k, v in got["gpt"].items()}, got["opt"]["mu"],
               {k: v.numpy() for k, v in one["gpt"].items()}, one["opt"]["mu"], lr_sum=2 * LR)


def _pngs(d):
    from PIL import Image

    return {os.path.basename(p): np.asarray(Image.open(p))
            for p in sorted(glob.glob(str(d / "*.png")))}


def test_cli_eval_model_parallel_and_class_split(cli_root, world2):
    done = [check_result(world2, "cli_eval", r)["done"] for r in range(2)]
    assert done == [[10, 5], [10, 5]]  # TP: each rank decodes all; the split: half each
    one = _pngs(cli_root / "eval_one")
    assert sorted(one) == [f"class{c:04d}.png" for c in range(10)]
    for d in ("eval_tp", "eval_split"):
        got = _pngs(cli_root / d)
        assert sorted(got) == sorted(one), d
        for k in one:
            np.testing.assert_array_equal(got[k], one[k], err_msg=f"{d}/{k}")
