"""The port's W8A8 decode path (ops/int8.py) against the JAX package's in f32
on the CPU: quantize_weight exact, int8_matmul within 1e-6, the card's
padded shapes (M <= 16, K or N off a multiple of 8) equal to the unpadded
product, the GPT's quantized cache equal to quantize_gpt_decode_params',
the int8 forward's logits (full and cached) within 1e-4, and greedy tokens
equal for the three samplers with the int8 weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.models import gpt as jgpt
from omnitokenizer_tpu.ops import int8 as jint8
from omnitokenizer_tpu_torch.models import gpt as tgpt
from omnitokenizer_tpu_torch.ops import int8 as tint8

from torch_port_util import gpt_pair

torch.set_num_threads(2)
# the JAX quant collection's dense names -> the port's module names
DENSE = {"query": "attn.query", "key": "attn.key", "value": "attn.value",
         "proj": "attn.proj", "fc": "mlp.0", "proj_out": "mlp.2"}


@pytest.fixture(scope="module")
def pair():
    """The small GPT of test_torch_gpt.py with int8_decode on, and both
    packages' quantized weights."""
    jcfg, params, tcfg, gpt = gpt_pair(0, int8_decode=True)
    return jcfg, params, jint8.quantize_gpt_decode_params(params, jcfg.n_layer), tcfg, gpt, \
        tint8.quantize_gpt_decode_params(gpt)


def test_quantize_weight_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(48, 37).astype(np.float32) * 0.2
    w[:, 3] = 0  # an all-zero output channel: the 1e-12 floor
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    q, s = tint8.quantize_weight(torch.from_numpy(w.T.copy()))
    assert q.dtype == torch.int8 and q.shape == (37, 48)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", [(16, 64), (3, 5, 40), (1, 33)])
def test_int8_matmul_matches_jax(shape):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[-1], 27).astype(np.float32) * 0.2
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    want = np.asarray(jint8.int8_matmul(jnp.asarray(x), jq, js))
    q, s = tint8.quantize_weight(torch.from_numpy(w.T.copy()))
    got = tint8.int8_matmul(torch.from_numpy(x), q, s)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # the serving cache's zero rows past N change nothing
    padded = tint8.int8_matmul(torch.from_numpy(x), tint8._pad_rows(q), s)
    np.testing.assert_array_equal(padded.numpy(), got.numpy())


@pytest.mark.parametrize("m,k,n", [(1, 32, 9), (2, 64, 9193), (16, 36, 33),
                                   (17, 40, 16), (40, 8, 8)])
def test_padded_int_mm_equals_unpadded(m, k, n):
    """The operands the card's _int_mm takes (rows > 16, K and N multiples of
    8) give the unpadded product exactly."""
    g = torch.Generator().manual_seed(m * 1000 + k)
    xi = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    q = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    xp, qp = tint8._pad_for_int_mm(xi, q)
    assert xp.shape[0] > 16 and xp.shape[1] % 8 == 0 and qp.shape[0] % 8 == 0
    assert xp.shape[1] == qp.shape[1]
    want = xi.int() @ q.int().t()
    np.testing.assert_array_equal(torch._int_mm(xp, qp.t())[:m, :n].numpy(), want.numpy())
    np.testing.assert_array_equal(tint8.int8_mm(xi, q).numpy(), want.numpy())


def test_quantized_cache_matches_jax(pair):
    jcfg, _, jquant, _, _, quant = pair
    assert set(quant) == {f"blocks.{i}.{d}" for i in range(2) for d in DENSE.values()} | {"head"}
    for i in range(jcfg.n_layer):
        for jname, tname in DENSE.items():
            jw, tw = jquant[f"block{i}"][jname], quant[f"blocks.{i}.{tname}"]
            n = tw.s.shape[0]
            assert tw.q.shape[0] % 8 == 0 and not tw.q[n:].any()
            np.testing.assert_array_equal(tw.q[:n].numpy(), np.asarray(jw["q"]).T)
            np.testing.assert_array_equal(tw.s.numpy(), np.asarray(jw["s"]))
            np.testing.assert_array_equal(tw.b.numpy(), np.asarray(jw["b"]))
    head = quant["head"]
    assert head.b is None and head.q.shape == (56, 32)  # vocab 50 padded to 56
    np.testing.assert_array_equal(head.q[:50].numpy(), np.asarray(jquant["head"]["q"]).T)
    np.testing.assert_array_equal(head.s.numpy(), np.asarray(jquant["head"]["s"]))


def test_int8_forward_matches_jax(pair):
    """Full and cached int8 forwards within 1e-4 of JAX's, and the full one
    near the f32 forward (the JAX package's own bar)."""
    jcfg, params, jquant, tcfg, gpt, quant = pair
    jm = jgpt.GPT(jcfg)
    variables = {"params": params, "quant": jquant}
    idx = np.random.RandomState(2).randint(0, 50, (2, 12))
    want, _ = jm.apply(variables, jnp.asarray(idx))
    with torch.no_grad():
        got, _ = gpt(torch.from_numpy(idx), quant=quant)
        f32, _ = gpt(torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert float((got - f32).abs().mean() / f32.abs().mean()) < 0.1
    caches_j, caches_t = jgpt.init_cache(jcfg, 2), tgpt.init_cache(tcfg, 2, "cpu")
    lj, caches_j = jm.apply(variables, jnp.asarray(idx[:, :4]), caches_j, 0)
    with torch.no_grad():
        lt, _ = gpt(torch.from_numpy(idx[:, :4]), caches_t, 0, quant=quant)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=1e-4)
    for t in range(4, 12):
        lj, caches_j = jm.apply(variables, jnp.asarray(idx[:, t:t + 1]), caches_j, t,
                                kv_window=16)
        with torch.no_grad():
            lt, _ = gpt(torch.from_numpy(idx[:, t:t + 1]), caches_t, torch.tensor([t]),
                        kv_window=16, quant=quant)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["plain", "cfg", "hardcfg"])
def test_int8_samplers_greedy_match_jax(pair, kind):
    jcfg, params, jquant, tcfg, gpt, quant = pair
    if kind == "plain":
        jfn = jgpt.make_sampler(jcfg, 12, greedy=True, bucket=4)
        tfn = tgpt.make_sampler(tcfg, 12, greedy=True, bucket=4)
        arg = np.random.RandomState(3).randint(0, 50, (2, 3))
    else:
        make_j = jgpt.make_cfg_sampler if kind == "cfg" else jgpt.make_hardcfg_sampler
        make_t = tgpt.make_cfg_sampler if kind == "cfg" else tgpt.make_hardcfg_sampler
        jfn = make_j(jcfg, 12, greedy=True, class_first=True, bucket=5)
        tfn = make_t(tcfg, 12, greedy=True, class_first=True, bucket=5)
        arg = np.array([[3], [7]])
    want = np.asarray(jfn(params, jnp.asarray(arg), jax.random.PRNGKey(0), quant=jquant))
    got = tfn(gpt, torch.from_numpy(arg), quant=quant)
    np.testing.assert_array_equal(got.numpy(), want)
