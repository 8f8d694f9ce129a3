"""The port's quantizer library (omnitokenizer_tpu_torch/ops/quantizers.py)
against the JAX package's (omnitokenizer_tpu/ops/quantizers.py), in f32 on
the CPU, on the same numpy-seeded inputs: FSQ, LFQ, VectorQuantize
(euclidean and cosine; kmeans init, EMA) and the three residual stacks.

The draws are handed over: the codebooks start from the JAX init's codes,
and kmeans from the sample indices the JAX key draws
(`jax.random.randint(key, (K,), 0, N)`, as the JAX kmeans draws them;
ResidualVQ splits its key a layer). Bars: indices exact; outputs, losses
and the quantizer state after each call within 1e-5 (relative to the
tensor's largest value); the straight-through gradients of a weighted sum
of the outputs plus the loss within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.ops import quantizers as jq
from omnitokenizer_tpu_torch.ops import quantizers as tq

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1e-12), name


def _equal(got, want, name=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)


def _inputs(n, dim, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, dim) * scale).astype(np.float32),
            rng.randn(n, dim).astype(np.float32))  # z and the weights of the summed output


def _torch_grad(fn, z, w):
    zt = torch.tensor(z, requires_grad=True)
    out = fn(zt)
    ((out["embeddings"] * torch.from_numpy(w)).sum() + out["commitment_loss"]).backward()
    return out, zt.grad


def _jax_grad(fn, z, w):
    def loss(zj):
        out = fn(zj)
        return jnp.sum(out["embeddings"] * w) + out["commitment_loss"]
    return fn(jnp.asarray(z)), jax.grad(loss)(jnp.asarray(z))


def _compare(got, want, gz, wz):
    _equal(got["encodings"], want["encodings"], "encodings")
    _close(got["embeddings"], want["embeddings"], "embeddings")
    _close(got["commitment_loss"], want["commitment_loss"], "loss")
    _close(gz, wz, "gradient")


@pytest.mark.parametrize("levels", [(8, 5, 5, 5), (8, 8, 8, 5, 5, 5), (7, 5, 3)])
def test_fsq(levels):
    z, w = _inputs(512, len(levels), 0, scale=2.0)
    want, wz = _jax_grad(jq.FSQ(levels), z, w)
    port = tq.FSQ(levels)
    got, gz = _torch_grad(port, z, w)
    _compare(got, want, gz, wz)
    assert port.codebook_size == jq.FSQ(levels).codebook_size
    idx = got["encodings"]
    _close(port.indices_to_codes(idx), jq.FSQ(levels).indices_to_codes(jnp.asarray(idx.numpy())))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("dim", [8, 14])
def test_lfq(dim, training):
    z, w = _inputs(512, dim, 1, scale=0.05)  # small enough that the entropies are not saturated
    want, wz = _jax_grad(lambda x: jq.LFQ(dim)(x, training=training), z, w)
    got, gz = _torch_grad(lambda x: tq.LFQ(dim)(x, training=training), z, w)
    _compare(got, want, gz, wz)
    _equal(tq.LFQ(dim).indices_to_codes(got["encodings"]),
           jq.LFQ(dim).indices_to_codes(jnp.asarray(got["encodings"].numpy())))


def _state(js) -> tq.VQState:
    return tq.VQState(*(torch.from_numpy(np.array(t)) for t in js))


def _compare_state(got, want):
    for name, g, w in zip(tq.VQState._fields, got, want):
        if name == "initialized":
            assert int(g) == int(w)
        else:
            _close(g, w, name)


def _kmeans_idx(key, k, n):
    return torch.from_numpy(np.array(jax.random.randint(key, (k,), 0, n)))


@pytest.mark.parametrize("cosine", [False, True])
def test_vector_quantize(cosine):
    """Three calls from the JAX init: a training call (kmeans init, EMA), a
    second training call (the EMA alone), an eval call."""
    n, dim, k = 384, 8, 32
    jvq = jq.VectorQuantize(dim, k, use_cosine_sim=cosine)
    tvq = tq.VectorQuantize(dim, k, use_cosine_sim=cosine)
    jstate = jvq.init_state(jax.random.PRNGKey(0))
    tstate = _state(jstate)
    for i, training in enumerate((True, True, False)):
        z, w = _inputs(n, dim, 10 + i)
        key = jax.random.PRNGKey(100 + i)
        res = {}

        def jfn(x):
            out, res["j"] = jvq(x, jstate, training=training, key=key)
            return out

        def tfn(x):
            out, res["t"] = tvq(x, tstate, training=training, kmeans_idx=_kmeans_idx(key, k, n))
            return out

        want, wz = _jax_grad(jfn, z, w)
        jfn(jnp.asarray(z))  # the new state of the concrete call
        got, gz = _torch_grad(tfn, z, w)
        _compare(got, want, gz, wz)
        _compare_state(res["t"], res["j"])
        jstate, tstate = res["j"], res["t"]
    assert int(tstate.initialized) == 1


@pytest.mark.parametrize("cosine", [False, True])
def test_kmeans(cosine):
    samples = np.random.RandomState(3).randn(300, 8).astype(np.float32)
    if cosine:
        samples /= np.linalg.norm(samples, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(4)
    want = jq.kmeans(key, jnp.asarray(samples), 24, iters=10, cosine=cosine)
    got = tq.kmeans(torch.from_numpy(samples), 24, iters=10, cosine=cosine,
                    init_idx=_kmeans_idx(key, 24, 300))
    _close(got, want)


def test_vq_init_state_from_a_generator():
    st = tq.vq_init_state(16, 4, torch.Generator().manual_seed(0))
    assert st.embed.shape == (16, 4) and torch.equal(st.embed, st.embed_avg)
    assert int(st.initialized) == 0 and float(st.cluster_size.abs().sum()) == 0
    again = tq.VectorQuantize(4, 16).init_state(torch.Generator().manual_seed(0))
    assert torch.equal(st.embed, again.embed)


def test_residual_fsq():
    z, w = _inputs(256, 4, 5, scale=2.0)
    want, wz = _jax_grad(jq.ResidualFSQ((8, 5, 5, 5), 3), z, w)
    got, gz = _torch_grad(tq.ResidualFSQ((8, 5, 5, 5), 3), z, w)
    _compare(got, want, gz, wz)


@pytest.mark.parametrize("training", [False, True])
def test_residual_lfq(training):
    z, w = _inputs(256, 8, 6, scale=0.05)
    want, wz = _jax_grad(lambda x: jq.ResidualLFQ(8, 3)(x, training=training), z, w)
    got, gz = _torch_grad(lambda x: tq.ResidualLFQ(8, 3)(x, training=training), z, w)
    _compare(got, want, gz, wz)


@pytest.mark.parametrize("cosine", [False, True])
def test_residual_vq(cosine):
    n, dim, k, depth = 256, 8, 16, 3
    jr = jq.ResidualVQ(dim, k, depth, use_cosine_sim=cosine)
    tr = tq.ResidualVQ(dim, k, depth, use_cosine_sim=cosine)
    jstates = jr.init_state(jax.random.PRNGKey(7))
    key = jax.random.PRNGKey(8)
    idx = [_kmeans_idx(kk, k, n) for kk in jax.random.split(key, depth)]
    z, w = _inputs(n, dim, 9)
    res = {}

    def jfn(x):
        out, res["j"] = jr(x, jstates, training=True, key=key)
        return out

    def tfn(x):
        out, res["t"] = tr(x, [_state(s) for s in jstates], training=True, kmeans_idx=idx)
        return out

    want, wz = _jax_grad(jfn, z, w)
    jfn(jnp.asarray(z))
    got, gz = _torch_grad(tfn, z, w)
    _compare(got, want, gz, wz)
    assert got["encodings"].shape == (n, depth)
    for t, j in zip(res["t"], res["j"]):
        _compare_state(t, j)
