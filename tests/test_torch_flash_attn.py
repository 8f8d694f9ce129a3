"""The causal flash kernel's arithmetic on the CPU, on the same numpy inputs as
the JAX package: the plain forward and backward (`flash_attn_fwd_plain`,
`flash_attn_bwd_plain`) against JAX's stock TPU flash kernel run in TPU
interpret mode (its forward and, through jax.vjp, its dkv and dq kernels),
at whole 128-row blocks and at a ragged T padded as the JAX LM pads it
(`omnitokenizer_tpu/models/gpt.py:119-129`), and against torch autograd of
the materialized math; then the CUDA kernels' tile walk emulated in
PyTorch (csrc/flash_attn.cu: 64-row query and key tiles, the causal skip of
the tiles above the diagonal, the diagonal and tail masks, the running max
and sum in the log2 domain, lse; the dkv walk from the diagonal down with
its 32-query tiles at D = 128, the dq walk up to it) against the plain
versions at ragged T. All f32."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, flash_attention

from omnitokenizer_tpu_torch.ops.kernels import flash_attn as fa

torch.set_num_threads(1)

TOL = 1e-5        # f32, another order of summation: whole-tensor relative
TILE = 64         # query and key rows a tile (csrc/flash_attn.cu kBM, kBN)
LOG2E = 1.4426950408889634


def rel(got, want) -> float:
    """||got - want|| / ||want||; ||got|| where want is exactly 0 (the
    gradients of q and k at T = 1, a softmax over one key)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / norm) if norm else float(np.linalg.norm(got))


def inputs(seed, B, H, T, D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(4)]


def jax_flash(q, k, v, do, scale):
    """The stock kernel as the JAX LM calls it: T padded to the 128 grid, the
    largest block that divides it, the tail sliced off; o and the vjp's
    (dq, dk, dv) in TPU interpret mode."""
    T = q.shape[2]
    Tp = -(-T // 128) * 128
    blk = next(b for b in (512, 384, 256, 128) if Tp % b == 0)
    bs = BlockSizes(block_q=blk, block_k_major=blk, block_k=blk, block_b=1,
                    block_q_major_dkv=blk, block_k_major_dkv=blk, block_k_dkv=blk,
                    block_q_dkv=blk, block_k_major_dq=blk, block_k_dq=blk, block_q_dq=blk)

    def pad(t):
        return jnp.pad(t, ((0, 0), (0, 0), (0, Tp - T), (0, 0)))

    def f(q, k, v):
        return flash_attention(pad(q), pad(k), pad(v), causal=True, sm_scale=scale,
                               block_sizes=bs)[:, :, :T]

    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
        grads = vjp(jnp.asarray(do))
        return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("B,H,T,D", [(1, 2, 256, 96), (1, 2, 384, 64), (1, 2, 300, 96)],
                         ids=["256x96", "384x64", "ragged300x96"])
def test_plain_matches_stock_pallas_kernel(B, H, T, D):
    q, k, v, do = inputs(T + D, B, H, T, D)
    scale = D ** -0.5
    o_jax, g_jax = jax_flash(q, k, v, do, scale)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    o, lse = fa.flash_attn_fwd_plain(tq, tk, tv, scale)
    assert rel(o, o_jax) <= TOL
    for got, want in zip(fa.flash_attn_bwd_plain(tq, tk, tv, o, tdo, lse, scale), g_jax):
        assert rel(got, want) <= TOL


@pytest.mark.parametrize("T,D", [(1, 16), (37, 32), (257, 96)])
def test_plain_matches_autograd(T, D):
    """The twins against torch autograd of the materialized causal softmax,
    in f64 (the twins compute in f32); the Function on the CPU runs them."""
    q, k, v, do = (torch.from_numpy(t).double() for t in inputs(T, 2, 3, T, D))
    scale = D ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    s = (leaves[0] @ leaves[1].transpose(-1, -2)) * scale
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    want = s.softmax(-1) @ leaves[2]
    want_g = torch.autograd.grad(want, leaves, do)
    o, lse = fa.flash_attn_fwd_plain(q, k, v, scale)
    assert rel(o, want.detach()) <= TOL
    assert rel(lse, torch.logsumexp(s, -1).detach()) <= TOL
    for got, w in zip(fa.flash_attn_bwd_plain(q, k, v, o, do, lse, scale), want_g):
        assert rel(got, w) <= TOL
    leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, scale)
    for got, w in zip(torch.autograd.grad(out, leaves, do.float()), want_g):
        assert rel(got, w) <= TOL


# -- the kernels' tile walk ------------------------------------------------------------
def tiles(x, t0, rows):
    """Rows [t0, t0 + rows) of (..., T, D), zero-filled past T (cp.async's zeros)."""
    T = x.shape[-2]
    out = x.new_zeros(x.shape[:-2] + (rows, x.shape[-1]))
    n = max(0, min(rows, T - t0))
    out[..., :n, :] = x[..., t0:t0 + n, :]
    return out


def emulate_fwd(q, k, v, scale, visited):
    """flash_fwd_kernel: a block of 64 queries walks key tiles 0 .. its own."""
    T = q.shape[-2]
    n_tiles = -(-T // TILE)
    o, lse = torch.zeros_like(q), torch.zeros(q.shape[:-1])
    c = scale * LOG2E
    for qt in range(n_tiles):
        rows = torch.arange(qt * TILE, (qt + 1) * TILE)
        qb = tiles(q, qt * TILE, TILE)
        m = torch.full(q.shape[:-2] + (TILE,), -math.inf)
        l, acc = torch.zeros_like(m), torch.zeros(qb.shape)
        for kt in range(qt + 1):  # the tiles above the diagonal are never read
            visited.add((qt, kt))
            s = qb @ tiles(k, kt * TILE, TILE).transpose(-1, -2)
            if kt == qt:
                cols = torch.arange(kt * TILE, (kt + 1) * TILE)
                s = s.masked_fill(cols[None, :] > rows[:, None], -math.inf)
            m_new = torch.maximum(m, s.amax(-1) * c)
            p = torch.exp2(s * c - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ tiles(v, kt * TILE, TILE)
            m = m_new
        n = min(TILE, T - qt * TILE)
        o[..., qt * TILE:qt * TILE + n, :] = (acc / l[..., None])[..., :n, :]
        lse[..., qt * TILE:qt * TILE + n] = ((m + torch.log2(l)) / LOG2E)[..., :n]
    return o, lse


def emulate_bwd(q, k, v, o, do, lse, scale):
    """di, then flash_bwd_dkv_kernel (64 keys a block; query tiles of 64, 32
    at D = 128, from the diagonal to T) and flash_bwd_dq_kernel (64 queries
    a block, key tiles 0 .. its own)."""
    T, D = q.shape[-2:]
    c = scale * LOG2E
    di = (o * do).sum(-1)
    lse2 = lse * LOG2E
    BQ = 64 if D <= 96 else 32
    n_tiles = -(-T // TILE)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def vec(x, t0, rows):
        return tiles(x[..., None], t0, rows)[..., 0]

    for kt in range(n_tiles):
        keys = torch.arange(kt * TILE, (kt + 1) * TILE)
        kb, vb = tiles(k, kt * TILE, TILE), tiles(v, kt * TILE, TILE)
        dkb, dvb = torch.zeros_like(kb), torch.zeros_like(vb)
        for qt in range(kt * TILE // BQ, -(-T // BQ)):
            qs = torch.arange(qt * BQ, (qt + 1) * BQ)
            qb, dob = tiles(q, qt * BQ, BQ), tiles(do, qt * BQ, BQ)
            st = kb @ qb.transpose(-1, -2)  # keys x queries
            ok = (keys[:, None] <= qs[None, :]) & (qs[None, :] < T)
            pt = torch.where(ok, torch.exp2(st * c - vec(lse2, qt * BQ, BQ)[..., None, :]),
                             torch.zeros(()))
            dvb += pt @ dob
            dpt = vb @ dob.transpose(-1, -2)
            dkb += (pt * (dpt - vec(di, qt * BQ, BQ)[..., None, :])) @ qb
        n = min(TILE, T - kt * TILE)
        dk[..., kt * TILE:kt * TILE + n, :] = (dkb * scale)[..., :n, :]
        dv[..., kt * TILE:kt * TILE + n, :] = dvb[..., :n, :]
    for qt in range(n_tiles):
        rows = torch.arange(qt * TILE, (qt + 1) * TILE)
        qb, dob = tiles(q, qt * TILE, TILE), tiles(do, qt * TILE, TILE)
        l2, d_i = vec(lse2, qt * TILE, TILE), vec(di, qt * TILE, TILE)
        dqb = torch.zeros_like(qb)
        for kt in range(qt + 1):
            cols = torch.arange(kt * TILE, (kt + 1) * TILE)
            kb, vb = tiles(k, kt * TILE, TILE), tiles(v, kt * TILE, TILE)
            p = torch.exp2((qb @ kb.transpose(-1, -2)) * c - l2[..., None])
            p = p.masked_fill(cols[None, :] > rows[:, None], 0.0)
            dqb += (p * (dob @ vb.transpose(-1, -2) - d_i[..., None])) @ kb
        n = min(TILE, T - qt * TILE)
        dq[..., qt * TILE:qt * TILE + n, :] = (dqb * scale)[..., :n, :]
    return dq, dk, dv


@pytest.mark.parametrize("T,D", [(1, 16), (63, 32), (64, 64), (257, 96), (300, 128),
                                 (1025, 96)])
def test_tile_walk_matches_plain(T, D):
    """The kernels' walk at whole and ragged tiles: the tiles it reads are
    those at or below the diagonal (the skipped ones are wholly masked), and
    o, lse, dq, dk, dv are the plain versions'."""
    B, H = (1, 1) if T > 300 else (2, 2)
    q, k, v, do = (torch.from_numpy(t) for t in inputs(T + D + 1, B, H, T, D))
    scale = D ** -0.5
    visited = set()
    o, lse = emulate_fwd(q, k, v, scale, visited)
    n_tiles = -(-T // TILE)
    assert visited == {(a, b) for a in range(n_tiles) for b in range(a + 1)}
    want_o, want_lse = fa.flash_attn_fwd_plain(q, k, v, scale)
    assert rel(o, want_o) <= TOL and rel(lse, want_lse) <= TOL
    got = emulate_bwd(q, k, v, o, do, lse, scale)
    for a, b in zip(got, fa.flash_attn_bwd_plain(q, k, v, want_o, do, want_lse, scale)):
        # at T = 1 (a softmax over one key) dq and dk are 0 in exact
        # arithmetic: both sides hold f32 rounding noise of order 1e-8
        assert rel(a, b) <= TOL or (T == 1 and max(a.abs().max(), b.abs().max()) <= 1e-6)


def test_gate_mirrors_jax(monkeypatch):
    """The port's gate is the JAX gate (flash_attention, bf16, T >= 256, a
    TPU) with the card for the TPU, but for the head widths narrowed()
    names: a narrowed shape is one the JAX gate takes."""
    from omnitokenizer_tpu.config import GPTConfig as JaxGPTConfig
    from omnitokenizer_tpu.models import gpt as jgpt
    from omnitokenizer_tpu_torch.config import GPTConfig
    from omnitokenizer_tpu_torch.models import gpt as tgpt

    class CudaLike:  # a CPU tensor that says it lies on the card: only the gate reads it
        def __init__(self, dtype, d):
            self.dtype, self.shape, self.is_cuda = dtype, (1, 1, 1, d), True

    # off a TPU and off the card, neither gate opens
    assert not jgpt._flash_ok(JaxGPTConfig(), 1025, jnp.bfloat16)
    assert not tgpt._flash_ok(GPTConfig(), 1025, torch.zeros(1, 1, 1, 96, dtype=torch.bfloat16))
    monkeypatch.setattr(jgpt.jax, "default_backend", lambda: "tpu")
    for flash in (True, False):
        for T in (1, 255, 256, 1025, 5120):
            for D in (16, 64, 96, 128, 256):
                for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
                    jax_takes = jgpt._flash_ok(JaxGPTConfig(flash_attention=flash), T, jdt)
                    port = tgpt._flash_ok(GPTConfig(flash_attention=flash), T, CudaLike(tdt, D))
                    assert port == (jax_takes and not fa.narrowed(T, D))
                    if fa.narrowed(T, D):
                        assert jgpt._flash_ok(JaxGPTConfig(), T, jnp.bfloat16) and D > 128
