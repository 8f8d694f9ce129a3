"""Each kernel's plain PyTorch version against the JAX package's Pallas
kernel, run in interpret mode on the CPU as the JAX tests run it, on the
same bf16 inputs made with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.ops.codebook import vq_argmin_xla
from omnitokenizer_tpu.ops.pallas.cosine_mha import cosine_mha as jax_cosine_mha
from omnitokenizer_tpu.ops.pallas.geglu_ff import geglu_ff as jax_geglu_ff
from omnitokenizer_tpu.ops.pallas.ln_qkv import ln_qkv as jax_ln_qkv
from omnitokenizer_tpu.ops.pallas.small_attn import small_n_attention as jax_small_n
from omnitokenizer_tpu.ops.rotary import _freqs_cis_2d_np
from omnitokenizer_tpu_torch.ops.kernels.cosine_mha import cosine_mha_plain
from omnitokenizer_tpu_torch.ops.kernels.geglu_ff import geglu_ff_plain, pad_geglu_weights
from omnitokenizer_tpu_torch.ops.kernels.ln_qkv import ln_qkv_plain
from omnitokenizer_tpu_torch.ops.kernels.small_attn import small_n_attention_plain
from omnitokenizer_tpu_torch.ops.kernels.vq_argmin import vq_argmin_plain
from omnitokenizer_tpu_torch.ops.rotary import freqs_cis_2d_np

torch.set_num_threads(1)

REL_TOL = 5e-2  # bf16 inputs and outputs, as tests/test_pallas_kernels.py holds the kernels
TANH_GELU_GAP = 3e-4  # the Pallas geglu_ff uses tanh GELU, the port erf


def bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def test_ln_qkv_plain_matches_pallas():
    rng = np.random.RandomState(0)
    M, D = 40, 128
    x_j, x_t = bf16_pair(rng.randn(M, D))
    gamma = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    wq_j, wq_t = bf16_pair(rng.randn(D, D) * D ** -0.5)
    wkv_j, wkv_t = bf16_pair(rng.randn(D, 2 * D) * D ** -0.5)
    q_j, kv_j = jax_ln_qkv(x_j, jnp.asarray(gamma), wq_j, wkv_j, interpret=True)
    q_t, kv_t = ln_qkv_plain(x_t, torch.from_numpy(gamma), wq_t.t().contiguous(),
                             wkv_t.t().contiguous())
    assert rel_err(f32(q_t), f32(q_j)) <= REL_TOL
    assert rel_err(f32(kv_t), f32(kv_j)) <= REL_TOL


def test_geglu_ff_plain_matches_pallas():
    rng = np.random.RandomState(1)
    M, D = 40, 128
    inner = int(4 * 2 / 3 * D)
    x_j, x_t = bf16_pair(rng.randn(M, D))
    ln_w = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    ln_b = (0.1 * rng.randn(D)).astype(np.float32)
    w1 = (rng.randn(D, 2 * inner) * D ** -0.5).astype(np.float32)
    w2 = (rng.randn(inner, D) * inner ** -0.5).astype(np.float32)
    want = f32(jax_geglu_ff(x_j, jnp.asarray(ln_w), jnp.asarray(ln_b), jnp.asarray(w1),
                            jnp.asarray(w2), interpret=True))
    w1p, w2p = pad_geglu_weights(torch.from_numpy(w1.T.copy()), torch.from_numpy(w2.T.copy()))
    got = f32(geglu_ff_plain(x_t, torch.from_numpy(ln_w), torch.from_numpy(ln_b), w1p, w2p))
    assert got.shape == (M, D)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max() + TANH_GELU_GAP


def _attention_inputs(seed, B, N, heads, dim_head):
    rng = np.random.RandomState(seed)
    HD = heads * dim_head
    q = bf16_pair(rng.randn(B, N, HD))
    kv = bf16_pair(rng.randn(B, N, 2 * HD))
    qs = (1 + 0.1 * rng.randn(dim_head)).astype(np.float32)
    ks = (1 + 0.1 * rng.randn(dim_head)).astype(np.float32)
    return q, kv, qs, ks


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "no_rope"])
def test_cosine_mha_plain_matches_pallas(use_rope):
    heads, dim_head = 2, 32
    (q_j, q_t), (kv_j, kv_t), qs, ks = _attention_inputs(2, 2, 16, heads, dim_head)
    want = f32(jax_cosine_mha(q_j, kv_j, jnp.asarray(qs), jnp.asarray(ks), heads=heads,
                              dim_head=dim_head, scale=8.0, use_rope=use_rope, interpret=True))
    got = f32(cosine_mha_plain(q_t, kv_t, torch.from_numpy(qs), torch.from_numpy(ks),
                               heads, dim_head, 8.0, use_rope))
    assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_small_n_attention_plain_matches_pallas(causal):
    heads, dim_head = 2, 32
    (q_j, q_t), (kv_j, kv_t), qs, ks = _attention_inputs(3, 24, 5, heads, dim_head)
    want = f32(jax_small_n(q_j, kv_j, jnp.asarray(qs), jnp.asarray(ks), heads=heads,
                           dim_head=dim_head, scale=8.0, causal=causal, interpret=True))
    got = f32(small_n_attention_plain(q_t, kv_t, torch.from_numpy(qs), torch.from_numpy(ks),
                                      heads, dim_head, 8.0, causal))
    assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("D", [3, 6, 8, 12, 40])
def test_vq_argmin_plain_matches_xla_exactly(D):
    rng = np.random.RandomState(4)
    flat = rng.randn(300, D).astype(np.float32)
    flat /= np.linalg.norm(flat, axis=1, keepdims=True)
    emb = rng.randn(64, D).astype(np.float32)
    want = np.asarray(vq_argmin_xla(jnp.asarray(flat), jnp.asarray(emb)))
    got = vq_argmin_plain(torch.from_numpy(flat), torch.from_numpy(emb)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("D", [64, 256])
def test_vq_argmin_plain_matches_xla_and_pallas_wide(D):
    """At the wide path's code dims, 2048 codes (the CNN VQGAN's codebook
    size): the plain version's indices equal the JAX XLA search's and the
    Pallas kernel's, run in interpret mode as tests/test_pallas_kernels.py
    runs it."""
    import jax
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from omnitokenizer_tpu.ops.pallas import vq_kernel

    rng = np.random.RandomState(D)
    flat = rng.randn(300, D).astype(np.float32)
    flat /= np.linalg.norm(flat, axis=1, keepdims=True)
    emb = rng.randn(2048, D).astype(np.float32)
    got = vq_argmin_plain(torch.from_numpy(flat), torch.from_numpy(emb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(vq_argmin_xla(jnp.asarray(flat),
                                                                jnp.asarray(emb))))
    m, k, tm = flat.shape[0], emb.shape[0], vq_kernel.TILE_M
    m_pad = -(-m // tm) * tm
    x = jnp.pad(jnp.asarray(flat), ((0, m_pad - m), (0, 0)))
    e = jnp.asarray(emb)
    esq = jnp.sum(e * e, axis=1)[None, :]
    out = pl.pallas_call(
        vq_kernel._vq_kernel,
        grid=(m_pad // tm,),
        in_specs=[
            pl.BlockSpec((tm, D), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((k, D), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, k), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tm, 1), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((m_pad, 1), jnp.int32),
        interpret=True,
    )(x, e, esq)[:m, 0]
    np.testing.assert_array_equal(got, np.asarray(out))


@pytest.mark.parametrize("dim,end", [(64, 1024), (32, 16), (64, 20)])
def test_rotary_tables_match_jax(dim, end):
    for got, want in zip(freqs_cis_2d_np(dim, end), _freqs_cis_2d_np(dim, end)):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
