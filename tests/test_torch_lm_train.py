"""The port's LM training against the JAX package's on the CPU, in f32 at
tests/test_gpt.py's GPT size (2 layers, 2 heads, width 32, block 24) over
a 4x4 grid of 32 codes: Net2NetTransformer.loss_fn handed JAX's own pkeep
draws (loss 1e-5, acc1/acc5 equal) for each vocabulary layout; two
optimizer steps against jax.grad of the JAX loss and the optax chain the
JAX transformer_train CLI builds from the same flags (captured from the
CLI itself: gradients 1e-4, parameters 1e-5); adamw's decay mask equal to
the CLI's on every parameter, each port name mapped to its JAX leaf through
convert.gpt_state_dict_from_jax; the same step with the attention forced
through the flash Function (its plain twins on the CPU) 1e-5 against the
materialized step; and the port's transformer_train CLI: its flag set is
the JAX parser's, what it refuses (and that a JAX .msgpack tokenizer
without its config sidecar raises), and 2 steps resumed to 3 equal to an
unbroken 3-step run."""

import argparse
import glob
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnitokenizer_tpu.cli import transformer_train as jax_cli
from omnitokenizer_tpu.config import Net2NetConfig as JaxN2NConfig
from omnitokenizer_tpu.models.net2net import Net2NetTransformer as JaxN2N
from omnitokenizer_tpu.utils.checkpoint import config_from_args
from omnitokenizer_tpu_torch.cli import transformer_train, vqgan_eval
from omnitokenizer_tpu_torch.config import Net2NetConfig
from omnitokenizer_tpu_torch.convert import gpt_state_dict_from_jax
from omnitokenizer_tpu_torch.models import gpt as tgpt
from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer
from omnitokenizer_tpu_torch.ops.kernels import flash_attn
from omnitokenizer_tpu_torch.training import lm_loop

from torch_port_util import (gpt_pair, random_gpt_params, reference_state_dict, to_numpy_tree,
                             write_lightning_ckpt)

torch.set_num_threads(2)

CODES, CLASSES, N, B = 32, 10, 16, 4
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-5
# a stand-in tokenizer: the loss never encodes, the port reads its device
CPU_TOKENIZER = types.SimpleNamespace(device=torch.device("cpu"))
VARIANTS = {"sos-class-first": dict(class_first=True), "sos": {},
            "no-sos": dict(starts_with_sos=False), "unconditional": dict(unconditional=True)}
# tests/test_torch_transformer_eval.py's tokenizer (a 4x4 grid of 32 codes) as
# checkpoint hparams
TOK_FLAGS = ["--embedding_dim", "16", "--n_codes", "32", "--codebook_dim", "4",
             "--patch_size", "4", "--temporal_patch_size", "2", "--enc_block", "t",
             "--dec_block", "t", "--spatial_depth", "1", "--temporal_depth", "1",
             "--dim_head", "8", "--heads", "2", "--spatial_pos", "rope", "--resolution", "16",
             "--sequence_length", "5", "--norm_type", "batch"]
# the optimizer flags of the step test: a warmup from 1e-4, a clip that bites
OPT_FLAGS = ["--lr", "1e-3", "--warmup_lr_init", "1e-4", "--warmup_steps", "2",
             "--max_steps", "10", "--lr_min", "1e-5", "--weight_decay", "0.1",
             "--grad_clip_val", "0.5"]


def _pair(variant: str, pkeep: float = 1.0, seed: int = 1):
    """(JAX Net2Net, port Net2Net, JAX params) over the same GPT weights."""
    kw = VARIANTS[variant]
    uncond, sos = kw.get("unconditional", False), kw.get("starts_with_sos", True)
    vocab = CODES + (0 if uncond else CLASSES + int(sos))
    jg, params, tg, gpt = gpt_pair(seed, vocab_size=vocab)
    args = dict(class_cond_dim=CLASSES, first_stage_vocab_size=CODES, pkeep=pkeep, **kw)
    return (JaxN2N(JaxN2NConfig(gpt=jg, **args), None, gpt_params=params),
            Net2NetTransformer(Net2NetConfig(gpt=tg, **args), CPU_TOKENIZER, gpt=gpt), params)


def _batch(seed: int):
    rng = np.random.RandomState(seed)
    return rng.randint(0, CODES, (B, N)), rng.randint(0, CLASSES, (B,))


def jax_draws(jn, key, shape):
    """The JAX loss's pkeep draws from its key (models/net2net.py:130-136)."""
    k1, k2 = jax.random.split(key)
    keep = jax.random.bernoulli(k1, jn.cfg.pkeep, shape)
    rand = jax.random.randint(k2, shape, 0, jn.cfg.gpt.vocab_size)
    return torch.from_numpy(np.array(keep)), torch.from_numpy(np.array(rand)).long()


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("pkeep", [1.0, 0.6])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_fn_matches_jax(variant, pkeep):
    jn, tn, params = _pair(variant, pkeep)
    z, labels = _batch(2)
    key = jax.random.PRNGKey(7)
    want, wm = jn.loss_fn(params, jnp.asarray(z), jnp.asarray(labels),
                          key if pkeep < 1 else None)
    keep, rand = jax_draws(jn, key, z.shape) if pkeep < 1 else (None, None)
    if pkeep < 1:
        assert 0 < int(keep.sum()) < keep.numel()
    got, gm = tn.loss_fn(torch.from_numpy(z), torch.from_numpy(labels), keep, rand)
    got = got.detach()
    assert abs(float(got) - float(want)) <= LOSS_TOL * abs(float(want))
    for k in ("acc1", "acc5"):
        assert float(gm[k]) == float(wm[k]), k


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def lm_data(tmp_path_factory):
    """A tokenizer checkpoint self-described by its hparams and 16 16x16 PNG
    images with class labels in an image list."""
    from PIL import Image

    root = tmp_path_factory.mktemp("lm_train")
    hp = vars(vqgan_eval.build_parser().parse_args(TOK_FLAGS + ["--vqgan_ckpt", "x"]))
    write_lightning_ckpt(root / "tok.ckpt",
                         reference_state_dict(config_from_args(argparse.Namespace(**hp)), seed=3),
                         **hp)
    rng = np.random.RandomState(0)
    lines = []
    for i in range(16):
        Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(root / f"im{i:02d}.png")
        lines.append(f"im{i:02d}.png\t{i % CLASSES}")
    (root / "images.txt").write_text("\n".join(lines) + "\n")
    return root


def _cli_flags(root, run_dir, extra=()):
    return ["--vqvae", str(root / "tok.ckpt"), "--data_path", str(root),
            "--train_datalist", str(root / "images.txt"), "--default_root_dir", str(run_dir),
            "--resolution", "16", "--sequence_length", "1", "--batch_size", str(B),
            "--num_workers", "0", "--block_size", "24", "--n_layer", "2", "--n_head", "2",
            "--n_embd", "32", "--class_cond_dim", str(CLASSES), "--starts_with_sos",
            "--class_first"] + list(extra)


@pytest.fixture(scope="module")
def jax_chain(lm_data, tmp_path_factory):
    """The optax chain and adamw mask the JAX CLI builds from OPT_FLAGS, taken
    from the CLI itself (it stops at its optax.chain call)."""
    mp = pytest.MonkeyPatch()
    seen = {}
    real_adamw, real_chain = optax.adamw, optax.chain

    def adamw(*a, **kw):
        seen["mask"] = kw["mask"]
        return real_adamw(*a, **kw)

    def chain(*a):
        seen["tx"] = real_chain(*a)
        raise _Captured

    mp.setattr(optax, "adamw", adamw)
    mp.setattr(optax, "chain", chain)
    try:
        with pytest.raises(_Captured):
            jax_cli.main(_cli_flags(lm_data, tmp_path_factory.mktemp("jax_run"), OPT_FLAGS))
    finally:
        mp.undo()
    return seen


def _port_grads(tn, z, labels, keep, rand):
    params = list(tn.gpt.parameters())
    loss, _ = tn.loss_fn(torch.from_numpy(z), torch.from_numpy(labels), keep, rand)
    return dict(zip([n for n, _ in tn.gpt.named_parameters()],
                    torch.autograd.grad(loss, params)))


def _opt_kw():
    a = transformer_train.build_parser().parse_args(["--vqvae", "x"] + OPT_FLAGS)
    return dict(lr=a.lr, max_steps=a.max_steps, warmup_steps=a.warmup_steps,
                warmup_lr_init=a.warmup_lr_init, lr_min=a.lr_min,
                grad_clip_val=a.grad_clip_val, weight_decay=a.weight_decay)


def test_two_steps_match_jax_cli_chain(jax_chain):
    """Two steps of pkeep 0.8 on one batch: the port's gradients against
    jax.grad of the JAX loss on the same draws, and its parameters after
    lm_train_step against the JAX CLI's chain. The key biases' gradient is 0
    in exact arithmetic (softmax's shift invariance): Adam's first step turns
    each side's rounding into +-lr, so that slice is held to |update| <= lr."""
    jn, tn, params = _pair("sos-class-first", pkeep=0.8)
    tx = jax_chain["tx"]
    opt = lm_loop.make_lm_optimizer(tn.gpt, **_opt_kw())
    state = lm_loop.init_lm_state(tn, opt)
    opt_state = tx.init(params)
    z, labels = _batch(3)
    names = [n for n, _ in tn.gpt.named_parameters()]
    grad_fn = jax.jit(jax.grad(
        lambda p, key: jn.loss_fn(p, jnp.asarray(z), jnp.asarray(labels), key)[0]))
    for step in range(2):
        key = jax.random.PRNGKey(100 + step)
        keep, rand = jax_draws(jn, key, z.shape)
        grads = grad_fn(params, key)
        want_g = gpt_state_dict_from_jax(to_numpy_tree(grads))
        got_g = _port_grads(tn, z, labels, keep, rand)
        for n in names:
            if n.endswith("attn.key.bias"):  # 0 but for each side's rounding
                assert max(float(got_g[n].abs().max()), float(want_g[n].abs().max())) <= 1e-6
                continue
            assert rel(got_g[n], want_g[n]) <= GRAD_TOL, (step, n)
        before = {n: p.detach().clone() for n, p in tn.gpt.named_parameters()}
        lm_loop.lm_train_step(tn, opt, state, torch.from_numpy(z), torch.from_numpy(labels),
                              keep, rand)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want_p = gpt_state_dict_from_jax(to_numpy_tree(params))
        lr = opt.schedule(step)
        for n, p in tn.gpt.named_parameters():
            if n.endswith("attn.key.bias"):
                assert float((p.detach() - before[n]).abs().max()) <= lr * (1 + 1e-4), n
                continue
            assert rel(p.detach(), want_p[n]) <= PARAM_TOL, (step, n)
        params = jax.tree_util.tree_map(jnp.asarray, to_numpy_tree(params))
        tn.gpt.load_state_dict({**{n: want_p[n] for n in names
                                   if not n.endswith("attn.key.bias")},
                                **{n: p.detach() for n, p in tn.gpt.named_parameters()
                                   if n.endswith("attn.key.bias")}})
        for n in names:  # the key biases: the JAX side continues from the port's
            if n.endswith("attn.key.bias"):
                i = n.split(".")[1]
                params["block" + i]["key"]["bias"] = jnp.asarray(
                    dict(tn.gpt.named_parameters())[n].detach().numpy())
    assert state.step == 2


def test_decay_mask_matches_jax_cli(jax_chain):
    """adamw's mask on every parameter (with the vtokens table too): the
    port decides on its names, the JAX CLI on its leaves; each port name is
    mapped to its leaf through convert.gpt_state_dict_from_jax."""
    from torch_port_util import gpt_configs

    jcfg, _ = gpt_configs(vtokens_pos=True)
    vt = dict(vtokens_seq_len=2, vtokens_res=3, vtokens_crop=2)
    leaves, treedef = jax.tree_util.tree_flatten(random_gpt_params(jcfg, 0, **vt))
    numbered = jax.tree_util.tree_unflatten(  # every leaf filled with its own index
        treedef, [np.full(x.shape, i, np.float32) for i, x in enumerate(leaves)])
    decisions = jax.tree_util.tree_leaves(jax_chain["mask"](numbered))
    port = gpt_state_dict_from_jax(numbered)
    assert len(port) == len(decisions) and "vtokens_pos_emb" in port
    gpt = tgpt.GPT(gpt_configs(vtokens_pos=True)[1], **vt)
    assert set(port) == {n for n, _ in gpt.named_parameters()}
    for name, t in port.items():
        assert lm_loop.decays(name) == bool(decisions[int(t.flatten()[0])]), name
    assert not lm_loop.decays("blocks.0.ln1.weight") and lm_loop.decays("blocks.0.mlp.0.weight")


def test_step_through_flash_function_matches_materialized(monkeypatch):
    """The gate forced open on the CPU (a test-only patch of models/gpt.py's
    _flash_ok): every layer's attention goes through the flash Function,
    whose plain twins run here; the step's gradients and parameters within
    1e-5 of the materialized step's (the key biases, whose gradient is 0 in
    exact arithmetic, as in the step test)."""
    _, ta, _ = _pair("sos", pkeep=0.8)
    _, tb, _ = _pair("sos", pkeep=0.8)
    z, labels = (torch.from_numpy(a) for a in _batch(4))
    keep, rand = ta.draw_pkeep(tuple(z.shape), torch.Generator().manual_seed(0))
    runs = {}
    for name, tn, forced in (("plain", ta, False), ("flash", tb, True)):
        calls = []
        if forced:
            monkeypatch.setattr(tgpt, "_flash_ok", lambda cfg, T, t: True)
            real = flash_attn.flash_attention
            monkeypatch.setattr(flash_attn, "flash_attention",
                                lambda *a: calls.append(1) or real(*a))
        opt = lm_loop.make_lm_optimizer(tn.gpt, **_opt_kw())
        state = lm_loop.init_lm_state(tn, opt)
        grads = _port_grads(tn, z.numpy(), labels.numpy(), keep, rand)
        lm_loop.lm_train_step(tn, opt, state, z, labels, keep, rand)
        runs[name] = grads, dict(tn.gpt.named_parameters())
        assert len(calls) == (tn.cfg.gpt.n_layer * 2 if forced else 0)  # grads, then the step
    lr = lm_loop.make_lm_optimizer(ta.gpt, **_opt_kw()).schedule(0)
    for n, g in runs["flash"][0].items():
        got, want = runs["flash"][1][n].detach(), runs["plain"][1][n].detach()
        if n.endswith("attn.key.bias"):
            assert max(float(g.abs().max()), float(runs["plain"][0][n].abs().max())) <= 1e-6
            assert float((got - want).abs().max()) <= 2 * lr * (1 + 1e-4), n
            continue
        assert rel(g, runs["plain"][0][n]) <= 1e-5, n
        assert rel(got, want) <= 1e-5, n


def test_flag_set_matches_jax():
    port = {o for a in transformer_train.build_parser()._actions for o in a.option_strings}
    jax_flags = {o for a in jax_cli.build_parser()._actions for o in a.option_strings}
    assert port - jax_flags == {"--device"}
    assert jax_flags - port == set()


def test_cli_refuses_what_it_does_not_port(lm_data, tmp_path):
    base = _cli_flags(lm_data, tmp_path / "run") + ["--device", "cpu", "--max_steps", "1"]
    # refused where the JAX CLI trains wrongly: it never reads the stft, and
    # it would encode vtokens' code grids as pixels
    for extra, match in ((["--cond_stage_key", "stft"], "never reads the stft"),
                         (["--vtokens"], "as pixels")):
        with pytest.raises(NotImplementedError, match=match):
            transformer_train.main(base + extra)
    # tensor and pipeline parallelism run over processes (tests/test_torch_parallel_tp.py,
    # _pp.py); one process is no group of 2, and the JAX CLI's layout checks hold
    for extra, match in ((["--model_parallel", "2"], "groups of 2"),
                         (["--pipeline_stages", "2"], "groups of 2"),
                         (["--model_parallel", "2", "--pipeline_stages", "2"],
                          "mutually exclusive"),
                         (["--model_parallel", "3"], "n_head"),
                         (["--pipeline_stages", "3"], "n_layer")):
        with pytest.raises(ValueError, match=match):
            transformer_train.main(base + extra)
    # a JAX .msgpack tokenizer is read (tests/test_torch_msgpack_cli.py); without its
    # .cfg.json sidecar it raises as the JAX package's loader does
    with pytest.raises(ValueError, match="sidecar"):
        transformer_train.main(base + ["--vqvae", str(tmp_path / "tok.msgpack")])
    with pytest.raises(RuntimeError):  # the card by default: raises on a host without one
        transformer_train.main(_cli_flags(lm_data, tmp_path / "card") + ["--max_steps", "1"])


def _read_state(path):
    return torch.load(path, map_location="cpu")


def test_cli_resume_equals_unbroken_run(lm_data, tmp_path):
    """2 steps, then a resumed run to 3, against an unbroken 3-step run (a
    constant learning rate, so the horizon max_steps sets does not change
    the first steps; pkeep 0.8, whose draws come from (seed, step)): the same
    GPT and optimizer state, metrics logged at steps 0, 1, 2."""
    flags = ["--device", "cpu", "--pkeep", "0.8", "--lr", "1e-3", "--warmup_lr_init", "1e-3",
             "--lr_min", "1e-3", "--weight_decay", "0.1"]
    broken, unbroken = tmp_path / "broken", tmp_path / "unbroken"
    first = transformer_train.main(_cli_flags(lm_data, broken, flags + ["--max_steps", "2"]))
    assert first.step == 2
    assert [os.path.basename(p) for p in glob.glob(str(broken / "checkpoints" / "*.pt"))] == [
        "step_00000002.pt"]
    resumed = transformer_train.main(_cli_flags(lm_data, broken, flags + ["--max_steps", "3"]))
    whole = transformer_train.main(_cli_flags(lm_data, unbroken, flags + ["--max_steps", "3"]))
    assert resumed.step == whole.step == 3
    recs = [json.loads(line) for line in open(broken / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and 0 <= r["acc5"] <= 100 for r in recs)
    a, b = (_read_state(d / "checkpoints" / "step_00000003.pt") for d in (broken, unbroken))
    assert a["step"] == b["step"] == 3
    for k in b["gpt"]:
        assert torch.equal(a["gpt"][k], b["gpt"][k]), k
    for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]):
        assert torch.equal(x, y)
    moved = [k for k, v in b["gpt"].items()
             if not torch.equal(v, _read_state(broken / "checkpoints" /
                                               "step_00000002.pt")["gpt"][k])]
    assert len(moved) == len(b["gpt"])
