"""The cosine_mha kernels' arithmetic on the CPU, on the same numpy inputs as
the JAX package: the prep pass's plain version (`cosine_prep_plain`)
against the JAX rotary + l2norm math in f32, and the flash kernel's tiled
algorithm emulated in PyTorch (64-key tiles, running max and sum in the
log2 domain, P rounded to bf16 per tile, the f32 output rescaled) against
`cosine_mha_plain` and against the Pallas kernel in interpret mode, at N
with whole 64-key tiles and at ragged N (a partial last tile), and the
port's gate against the JAX one."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.ops.attention import l2norm as jax_l2norm
from omnitokenizer_tpu.ops.pallas.cosine_mha import cosine_mha as jax_cosine_mha
from omnitokenizer_tpu.ops.pallas.cosine_mha import cosine_mha_supported as jax_supported
from omnitokenizer_tpu.ops.rotary import apply_rotary_emb_2d as jax_rope
from omnitokenizer_tpu_torch.ops.kernels.cosine_mha import (DIM_HEADS, cosine_mha_plain,
                                                          cosine_mha_supported,
                                                          cosine_prep_plain)

torch.set_num_threads(1)

HEADS, SCALE = 2, 8.0
F32_TOL = 1e-5     # f32 elementwise math, another order of operations
PLAIN_TOL = 2e-2   # the kernel's tolerance against its plain version on the card
PALLAS_TOL = 5e-2  # bf16 inputs and outputs, as the other kernel tests hold the Pallas ones
TILE = 64          # keys a tile of the flash kernel (csrc/cosine_mha.cu kBN)

# whole 64-key tiles, and ragged N: 16 (one partial tile), 144 and 784 (a
# 224^2 image at patch 8)
CASES = pytest.mark.parametrize("dim_head,N,use_rope", [
    (dh, n, rope) for dh in (32, 64) for n in (64, 256, 16, 144, 784)
    for rope in (True, False)])


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
    rounded at the end. Key tiles are read as the kernel's TMA reads them:
    k-hat from the (B*N)-row tensor, so a partial last tile runs on into the
    next batch's rows or zeros past the end, and those keys score -inf; v
    per batch, so its rows past N are zeros."""
    B, N, HD = q.shape
    q_hat, k_hat = cosine_prep_plain(q, kv, q_scale, k_scale, heads, dim_head, scale, use_rope)
    qh = q_hat.float().view(B, N, heads, dim_head).transpose(1, 2)
    # k-hat: (B*N + tile) rows, the batches one after another, then TMA's
    # zeros; v: (B, N + tile) rows, each batch followed by zeros
    kh = torch.cat([k_hat.float().reshape(B * N, HD), torch.zeros(tile, HD)])
    kh = kh.view(-1, heads, dim_head)
    v = torch.cat([kv.float().view(B, N, 2, HD)[:, :, 1], torch.zeros(B, tile, HD)], 1)
    v = v.view(B, -1, heads, dim_head)
    m = torch.full((B, heads, N, 1), -torch.inf)
    l, o = torch.zeros(B, heads, N, 1), torch.zeros(B, heads, N, dim_head)
    rows = torch.arange(B)[:, None] * N + torch.arange(tile)[None, :]  # (B, tile)
    for k0 in range(0, N, tile):
        kt = kh[rows + k0].permute(0, 2, 1, 3)  # (B, heads, tile, dh)
        vt = v[:, k0:k0 + tile].permute(0, 2, 1, 3)
        s = (qh @ kt.transpose(-1, -2)) * math.log2(math.e)
        s = s.masked_fill(torch.arange(k0, k0 + tile) >= N, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(q.dtype).float() @ vt
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
    # two batches, so a partial last tile of the first runs into the second
    q, kv, qs, ks = _inputs(2 * N + dim_head, N, dim_head, B=2)
    (q_j, q_t), (kv_j, kv_t) = _bf16_pair(q), _bf16_pair(kv)
    qs_t, ks_t = torch.from_numpy(qs), torch.from_numpy(ks)
    got = flash_emulated(q_t, kv_t, qs_t, ks_t, HEADS, dim_head, SCALE, use_rope)
    assert got.dtype == torch.bfloat16 and got.shape == q_t.shape
    plain = cosine_mha_plain(q_t, kv_t, qs_t, ks_t, HEADS, dim_head, SCALE, use_rope)
    assert _rel_err(got.float(), plain.float()) <= PLAIN_TOL
    pallas = jax_cosine_mha(q_j, kv_j, jnp.asarray(qs), jnp.asarray(ks), heads=HEADS,
                            dim_head=dim_head, scale=SCALE, use_rope=use_rope, interpret=True)
    assert _rel_err(got.float(), np.asarray(pallas.astype(jnp.float32))) <= PALLAS_TOL


@pytest.mark.parametrize("dim_head", DIM_HEADS)
def test_gate_is_the_jax_gate(dim_head):
    """Every square N in [16, 2048], ragged or not, takes the kernel."""
    for n in range(1, 2101):
        assert cosine_mha_supported(n, dim_head) == jax_supported(n, None, False,
                                                                  backend_check=False), n
