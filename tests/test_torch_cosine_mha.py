"""The cosine_mha kernels' arithmetic on the CPU, on the same numpy inputs as
the JAX package: the prep pass's plain version (`cosine_prep_plain`)
against the JAX rotary + l2norm math in f32, and the flash kernel's tiled
algorithm emulated in PyTorch (64-key tiles, running max and sum in the
log2 domain, P rounded to bf16 per tile, the f32 output rescaled) against
`cosine_mha_plain` and against the Pallas kernel in interpret mode."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.ops.attention import l2norm as jax_l2norm
from omnitokenizer_tpu.ops.pallas.cosine_mha import cosine_mha as jax_cosine_mha
from omnitokenizer_tpu.ops.rotary import apply_rotary_emb_2d as jax_rope
from omnitokenizer_tpu_torch.ops.kernels.cosine_mha import (TILE, cosine_mha_plain,
                                                          cosine_prep_plain)

torch.set_num_threads(1)

HEADS, SCALE = 2, 8.0
F32_TOL = 1e-5     # f32 elementwise math, another order of operations
PLAIN_TOL = 2e-2   # the kernel's tolerance against its plain version on the card
PALLAS_TOL = 5e-2  # bf16 inputs and outputs, as the other kernel tests hold the Pallas ones

CASES = pytest.mark.parametrize("dim_head,N,use_rope", [
    (dh, n, rope) for dh in (32, 64) for n in (64, 256) for rope in (True, False)])


def _inputs(seed, N, dim_head, B=1):
    rng = np.random.RandomState(seed)
    HD = HEADS * dim_head
    q = rng.randn(B, N, HD).astype(np.float32)
    kv = rng.randn(B, N, 2 * HD).astype(np.float32)
    qs = (1 + 0.1 * rng.randn(dim_head)).astype(np.float32)
    ks = (1 + 0.1 * rng.randn(dim_head)).astype(np.float32)
    return q, kv, qs, ks


def _bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def flash_emulated(q, kv, q_scale, k_scale, heads, dim_head, scale, use_rope, tile=TILE):
    """The flash kernel's arithmetic: q-hat and k-hat from the prep (in q's
    dtype), then per key tile S = q-hat k-hat^T in f32 taken to the log2
    domain, running max m and sum l, P = exp2(S - m) summed unrounded into l
    and rounded to q's dtype for P V, O = O * alpha + P V in f32; O / l
    rounded at the end."""
    B, N, HD = q.shape
    q_hat, k_hat = cosine_prep_plain(q, kv, q_scale, k_scale, heads, dim_head, scale, use_rope)
    qh, kh = (t.float().view(B, N, heads, dim_head).transpose(1, 2) for t in (q_hat, k_hat))
    v = kv.float().view(B, N, 2, heads, dim_head)[:, :, 1].transpose(1, 2)
    m = torch.full((B, heads, N, 1), -torch.inf)
    l, o = torch.zeros(B, heads, N, 1), torch.zeros(B, heads, N, dim_head)
    for k0 in range(0, N, tile):
        s = (qh @ kh[:, :, k0:k0 + tile].transpose(-1, -2)) * math.log2(math.e)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(q.dtype).float() @ v[:, :, k0:k0 + tile]
        m = m_new
    return (o / l).transpose(1, 2).reshape(B, N, HD).to(q.dtype)


@CASES
def test_prep_matches_jax_rotary_l2norm(dim_head, N, use_rope):
    q, kv, qs, ks = _inputs(N + dim_head, N, dim_head)
    B, HD = q.shape[0], HEADS * dim_head
    jq = jnp.asarray(q.reshape(B, N, HEADS, dim_head))
    jk = jnp.asarray(kv.reshape(B, N, 2, HEADS, dim_head)[:, :, 0])
    if use_rope:
        jq, jk = jax_rope(jq, jk)
    want_q = np.asarray(jax_l2norm(jq) * (qs * SCALE)).reshape(B, N, HD)
    want_k = np.asarray(jax_l2norm(jk) * ks).reshape(B, N, HD)
    got_q, got_k = cosine_prep_plain(torch.from_numpy(q), torch.from_numpy(kv),
                                     torch.from_numpy(qs), torch.from_numpy(ks), HEADS,
                                     dim_head, SCALE, use_rope)
    assert got_q.dtype == torch.float32 and got_q.shape == (B, N, HD)
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_k.numpy(), want_k, rtol=F32_TOL, atol=F32_TOL)


@CASES
def test_flash_emulation_matches_plain_and_pallas(dim_head, N, use_rope):
    q, kv, qs, ks = _inputs(2 * N + dim_head, N, dim_head)
    (q_j, q_t), (kv_j, kv_t) = _bf16_pair(q), _bf16_pair(kv)
    qs_t, ks_t = torch.from_numpy(qs), torch.from_numpy(ks)
    got = flash_emulated(q_t, kv_t, qs_t, ks_t, HEADS, dim_head, SCALE, use_rope)
    assert got.dtype == torch.bfloat16 and got.shape == q_t.shape
    plain = cosine_mha_plain(q_t, kv_t, qs_t, ks_t, HEADS, dim_head, SCALE, use_rope)
    assert _rel_err(got.float(), plain.float()) <= PLAIN_TOL
    pallas = jax_cosine_mha(q_j, kv_j, jnp.asarray(qs), jnp.asarray(ks), heads=HEADS,
                            dim_head=dim_head, scale=SCALE, use_rope=use_rope, interpret=True)
    assert _rel_err(got.float(), np.asarray(pallas.astype(jnp.float32))) <= PALLAS_TOL
