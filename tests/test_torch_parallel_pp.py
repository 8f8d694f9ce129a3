"""The port's GPipe pipeline (parallel/pp.py) on the CPU over gloo, against
the JAX package's `pp.make_pp_net2net_loss` on its virtual mesh and the
sequential loss (tests/test_pp.py's setup: 4 layers over 2 stages, 2
microbatches), and the JAX LM's pipeline checkpoint layout.

One world of 2 ranks runs tests/torch_parallel_worker.py's "pp" suite once.
Bars: the loss 1e-5, acc1 equal and acc5 1e-6 (an f32 mean times 100
that XLA's fusions round 1 ulp apart from eager's), with pkeep off and with JAX's own
pkeep draws handed over; every gradient (the stages' slabs and the
replicated embeddings, ln_f and head, the same on both stages) 1e-4 of its
norm against jax.grad of the pipelined JAX loss and of the sequential one;
the pipe's logits 1e-5; two optimizer steps through the pipeline and the
transformer_train CLI with --pipeline_stages 2 against one process
(moments 1e-4 of their norm, parameters 1e-5 but 2 lr where a gradient
element is below that noise level); a JAX-written {"stacked", "rest"}
msgpack read by utils/gpt_checkpoint.py equal to the unstacked params."""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.config import GPTConfig as JaxGPTConfig
from omnitokenizer_tpu.config import Net2NetConfig as JaxN2NConfig
from omnitokenizer_tpu.models.net2net import Net2NetTransformer as JaxN2N
from omnitokenizer_tpu.parallel import pp as jpp
from omnitokenizer_tpu_torch.cli import transformer_train
from omnitokenizer_tpu_torch.convert import gpt_state_dict_from_jax
from omnitokenizer_tpu_torch.parallel import pp
from omnitokenizer_tpu_torch.utils.gpt_checkpoint import load_gpt_checkpoint

from test_torch_parallel_tp import LR, _lm_data, hold_state, train_flags
from torch_port_util import check_result, random_gpt_params, run_world, to_numpy_tree

torch.set_num_threads(2)

GPT = dict(vocab_size=64, block_size=32, n_layer=4, n_head=2, n_embd=16)
N2N = dict(first_stage_vocab_size=48, class_cond_dim=8, starts_with_sos=True)
CASES = {"plain": 1.0, "pkeep": 0.9}


def _jax_refs(params, z, labels, pkeep):
    jg = JaxGPTConfig(**GPT)
    jn = JaxN2N(JaxN2NConfig(gpt=jg, pkeep=pkeep, **N2N), None, gpt_params=params)
    key = jax.random.PRNGKey(3) if pkeep < 1 else None
    (seq_loss, seq_m), seq_grads = jax.jit(jax.value_and_grad(
        lambda p: jn.loss_fn(p, z, labels, key), has_aux=True))(params)
    mesh = jpp.pp_mesh(2)
    stacked, rest = jpp.stack_block_params(params, jg.n_layer)
    stacked = jpp.shard_stacked(stacked, mesh)
    loss_fn = jpp.make_pp_net2net_loss(jn, n_stages=2, n_micro=2, mesh=mesh)
    (loss, m), (gs, gr) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
        stacked, rest, z, labels, key)
    pp_grads = jpp.unstack_block_params(jax.device_get(gs), jax.device_get(gr), jg.n_layer)

    def port(g):
        return {k: v.numpy() for k, v in gpt_state_dict_from_jax(to_numpy_tree(g)).items()}

    if key is not None:
        k1, k2 = jax.random.split(key)
        keep = np.asarray(jax.random.bernoulli(k1, pkeep, z.shape))
        rand = np.asarray(jax.random.randint(k2, z.shape, 0, jg.vocab_size))
    else:
        keep, rand = np.ones(z.shape, bool), np.zeros(z.shape, np.int64)
    return ({"loss": float(loss), "acc1": float(m["acc1"]), "acc5": float(m["acc5"]),
             "seq_loss": float(seq_loss), "seq_acc1": float(seq_m["acc1"]),
             "seq_acc5": float(seq_m["acc5"]),
             "pp_grads": port(pp_grads), "seq_grads": port(seq_grads)}, keep, rand)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp")
    params = random_gpt_params(JaxGPTConfig(**GPT), seed=6)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    z = jax.random.randint(jax.random.PRNGKey(1), (4, 20), 0, 48)
    labels = jax.random.randint(jax.random.PRNGKey(2), (4,), 0, 8)
    specs, refs = {}, {}
    for name, pkeep in CASES.items():
        refs[name], keep, rand = _jax_refs(jparams, z, labels, pkeep)
        specs[name] = {"gpt": GPT, "n2n": dict(N2N, pkeep=pkeep), "z": np.asarray(z),
                       "labels": np.asarray(labels), "keep": keep, "rand": rand, "micro": 2,
                       "state_dict": gpt_state_dict_from_jax(params)}
    torch.save(specs, root / "pp_loss.pt")
    _lm_data(root)
    transformer_train.main(train_flags(root, root / "one"))
    torch.save({"argv": train_flags(root, root / "pp", ["--pipeline_stages", "2",
                                                         "--microbatches", "2"])},
               root / "cli_train.pt")
    return {"root": root, "refs": refs, "results": run_world("pp", 2, root)}


def _hold(got, want, tol=1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("attn.key.bias"):  # 0 in exact arithmetic (softmax's shift)
            scale = np.linalg.norm(want[k.replace("bias", "weight")])
            assert max(np.abs(got[k]).max(), np.abs(w).max()) <= tol * scale, k
            continue
        assert np.linalg.norm(got[k] - w) <= tol * max(np.linalg.norm(w), 1e-12), k


@pytest.mark.parametrize("case", list(CASES))
def test_pp_loss_matches_jax(world, case):
    want = world["refs"][case]
    assert abs(want["loss"] - want["seq_loss"]) <= 1e-5 * abs(want["seq_loss"])
    for r in range(2):
        got = check_result(world["results"], "pp_loss", r)[case]
        assert abs(float(got["loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert float(got["acc1"]) == want["acc1"] == want["seq_acc1"]
        # a mean of 0/1 times 100 in f32: XLA's fusions round it 1 ulp apart from eager's
        for ref in (want["acc5"], want["seq_acc5"]):
            assert abs(float(got["acc5"]) - ref) <= 1e-6 * ref


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["pp_grads", "seq_grads"])
def test_pp_grads_match_jax(world, case, ref):
    got = check_result(world["results"], "pp_loss", 0)[case]["grads"]
    _hold(got, world["refs"][case][ref])
    assert any(k.startswith("blocks.3.") for k in got)  # the last stage's slab came across


def test_pp_replicated_grads_equal_on_every_stage(world):
    a = check_result(world["results"], "pp_loss", 0)["plain"]
    b = check_result(world["results"], "pp_loss", 1)["plain"]
    assert set(a["rest"]) == {"tok_emb.weight", "pos_emb", "ln_f.weight", "ln_f.bias",
                              "head.weight"}
    for k in a["rest"]:
        np.testing.assert_array_equal(a["rest"][k], b["rest"][k], err_msg=k)
    np.testing.assert_array_equal(a["logits"], b["logits"])


def test_pp_logits_match_sequential(world):
    from omnitokenizer_tpu_torch.config import GPTConfig
    from omnitokenizer_tpu_torch.models.gpt import GPT as TorchGPT

    spec = torch.load(world["root"] / "pp_loss.pt", weights_only=False)["plain"]
    gpt = TorchGPT(GPTConfig(**GPT))
    gpt.load_state_dict(spec["state_dict"])
    got = check_result(world["results"], "pp_loss", 0)["plain"]["logits"]
    import types

    from omnitokenizer_tpu_torch.config import Net2NetConfig
    from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer

    n2n = Net2NetTransformer(Net2NetConfig(gpt=gpt.cfg, **spec["n2n"]),
                             types.SimpleNamespace(device=torch.device("cpu")), gpt=gpt)
    inputs, _, _ = n2n.loss_inputs(torch.from_numpy(spec["z"]), torch.from_numpy(spec["labels"]))
    with torch.no_grad():
        want = gpt(inputs)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pp_steps_match_one_process(world):
    v = check_result(world["results"], "pp_step")
    got, one = v["pp"], v["one"]
    np.testing.assert_allclose(got["norms"], one["norms"], rtol=1e-4)
    hold_state(got["gpt"], got["mu"], one["gpt"], one["mu"], lr_sum=2e-3)


def test_cli_train_pipeline_stages(world):
    check_result(world["results"], "cli_train")
    root = world["root"]

    def ckpt(d):
        return torch.load(sorted(glob.glob(str(root / d / "checkpoints" / "*.pt")))[-1])
    got, one = ckpt("pp"), ckpt("one")
    assert got["step"] == one["step"] == 2
    hold_state({k: v.numpy() for k, v in got["gpt"].items()}, got["opt"]["mu"],
               {k: v.numpy() for k, v in one["gpt"].items()}, one["opt"]["mu"], lr_sum=2 * LR)


def test_stack_unstack_round_trip():
    sd = {k: torch.randn(3, 2) for k in ("blocks.0.a.weight", "blocks.1.a.weight", "head.weight")}
    stacked, rest = pp.stack_block_params(sd, 2)
    assert stacked["a.weight"].shape == (2, 3, 2) and set(rest) == {"head.weight"}
    back = pp.unstack_block_params(stacked, rest, 2)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_pipeline_checkpoint_layout_reads(tmp_path):
    """A JAX --pipeline_stages run's (params, opt_state, step) msgpack, its
    params {"stacked", "rest"}, read as the unstacked GPT."""
    from flax import serialization

    params = random_gpt_params(JaxGPTConfig(**GPT), seed=7)
    stacked, rest = jpp.stack_block_params(jax.tree_util.tree_map(jnp.asarray, params),
                                           GPT["n_layer"])
    path = tmp_path / "step_00000003.msgpack"
    path.write_bytes(serialization.to_bytes(({"stacked": stacked, "rest": rest}, None, 3)))
    got = load_gpt_checkpoint(str(path))
    want = gpt_state_dict_from_jax(params)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
