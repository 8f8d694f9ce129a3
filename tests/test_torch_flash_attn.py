"""The causal flash kernel's arithmetic on the CPU, on the same numpy inputs as
the JAX package: the plain forward and backward (`flash_attn_fwd_plain`,
`flash_attn_bwd_plain`) against JAX's stock TPU flash kernel run in TPU
interpret mode (its forward and, through jax.vjp, its dkv and dq kernels),
at whole 128-row blocks and at a ragged T padded as the JAX LM pads it
(`omnitokenizer_tpu/models/gpt.py:119-129`), and against torch autograd of
the materialized math; then the CUDA kernels' tile walk emulated in
PyTorch (csrc/flash_attn.cu: 128-row blocks of two 64-row warpgroups,
warpgroups past T idle; the forward's key tiles of 128 from the diagonal
down, only the first masked, the previous tile's P V added before the
rescale; the dkv walk over query tiles of 64 from the diagonal to T and the
dq walk over key tiles of 64 up to it, tiles wholly above a warpgroup's
diagonal skipped; lse * log2(e) and di in a scratch zero-padded past T)
against the plain versions at ragged T. All f32."""

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
# csrc/flash_attn.cu: 64 rows a consumer warpgroup, two a block; the forward's
# key tiles of 128 (kFwdBN), the backward's query (dkv) and key (dq) tiles of
# 64 (kBwdTile). The sizes are the same at every head width.
WG = 64           # rows a warpgroup
BLOCK = 128       # queries a forward or dq block, keys a dkv block: two warpgroups
FWD_KEYS = 128    # keys a forward tile
BWD_TILE = 64     # queries a dkv tile, keys a dq tile; the scratch pads T to it


def tiles(x, t0, rows):
    """Rows [t0, t0 + rows) of (..., T, D), zero-filled past T (TMA's zeros)."""
    T = x.shape[-2]
    out = x.new_zeros(x.shape[:-2] + (rows, x.shape[-1]))
    n = max(0, min(rows, T - t0))
    out[..., :n, :] = x[..., t0:t0 + n, :]
    return out


def warpgroups(T):
    """(block start, warpgroup start) of every warpgroup that has a row
    before T; the others do no work."""
    return [(b0, b0 + w) for b0 in range(0, T, BLOCK) for w in (0, WG) if b0 + w < T]


def emulate_fwd(q, k, v, scale, visited):
    """flash_fwd_kernel: each warpgroup of a 128-query block walks the key
    tiles of 128 from its block's diagonal tile (masked) down to 0; the next
    tile's softmax runs while the previous tile's P V is in flight, so P V
    is added before O is rescaled."""
    T = q.shape[-2]
    o, lse = torch.zeros_like(q), torch.zeros(q.shape[:-1])
    c = scale * LOG2E
    for q0, q0w in warpgroups(T):
        rows = torch.arange(q0w, q0w + WG)
        qw = tiles(q, q0w, WG)
        for it, kt in enumerate(range(q0 // FWD_KEYS, -1, -1)):
            visited.add((q0w // WG, kt))
            s = (qw @ tiles(k, kt * FWD_KEYS, FWD_KEYS).transpose(-1, -2)) * c
            if it == 0:  # the diagonal tile
                cols = torch.arange(kt * FWD_KEYS, (kt + 1) * FWD_KEYS)
                s = s.masked_fill(cols[None, :] > rows[:, None], -math.inf)
                m = s.amax(-1)
                p = torch.exp2(s - m[..., None])
                l, acc = p.sum(-1), torch.zeros(qw.shape)
            else:
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp2(s - m_new[..., None])
                acc = acc + p_prev @ v_prev
                alpha = torch.exp2(m - m_new)
                acc, l, m = acc * alpha[..., None], l * alpha + p.sum(-1), m_new
            p_prev, v_prev = p, tiles(v, kt * FWD_KEYS, FWD_KEYS)
        acc = acc + p_prev @ v_prev
        n = min(WG, T - q0w)
        o[..., q0w:q0w + n, :] = (acc / l[..., None])[..., :n, :]
        lse[..., q0w:q0w + n] = ((m + torch.log2(l)) / LOG2E)[..., :n]
    return o, lse


def emulate_bwd(q, k, v, o, do, lse, scale, visited_dkv, visited_dq):
    """The di pass into the zero-padded scratch (lse * log2(e), di), then
    flash_bwd_dkv_kernel (a warpgroup owns 64 keys of a 128-key block and
    walks the query tiles of 64 from its block's diagonal to T, skipping a
    tile wholly above its keys) and flash_bwd_dq_kernel (a warpgroup owns 64
    queries of a 128-query block and walks the key tiles of 64 up to its
    block's last row, skipping a tile wholly after its rows)."""
    T = q.shape[-2]
    c = scale * LOG2E
    n_tiles = -(-T // BWD_TILE)
    pad = n_tiles * BWD_TILE - T
    lse2 = torch.nn.functional.pad(lse * LOG2E, (0, pad))
    di = torch.nn.functional.pad((o * do).sum(-1), (0, pad))
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for k0, k0w in warpgroups(T):
        keys = torch.arange(k0w, k0w + WG)
        kw, vw = tiles(k, k0w, WG), tiles(v, k0w, WG)
        dkw, dvw = torch.zeros_like(kw), torch.zeros_like(vw)
        for qt in range(k0 // BWD_TILE, n_tiles):
            i0 = qt * BWD_TILE
            if i0 + BWD_TILE <= k0w:  # every key after every query: skipped
                continue
            visited_dkv.add((k0w // WG, qt))
            qs = torch.arange(i0, i0 + BWD_TILE)
            qb, dob = tiles(q, i0, BWD_TILE), tiles(do, i0, BWD_TILE)
            pt = torch.exp2((kw @ qb.transpose(-1, -2)) * c - lse2[..., None, i0:i0 + BWD_TILE])
            if i0 < k0w + WG or i0 + BWD_TILE > T:
                ok = (keys[:, None] <= qs[None, :]) & (qs[None, :] < T)
                pt = torch.where(ok, pt, torch.zeros(()))
            dvw += pt @ dob
            dpt = vw @ dob.transpose(-1, -2)
            dkw += (pt * (dpt - di[..., None, i0:i0 + BWD_TILE])) @ qb
        n = min(WG, T - k0w)
        dk[..., k0w:k0w + n, :] = (dkw * scale)[..., :n, :]
        dv[..., k0w:k0w + n, :] = dvw[..., :n, :]
    for q0, q0w in warpgroups(T):
        rows = torch.arange(q0w, q0w + WG)
        qw, dow = tiles(q, q0w, WG), tiles(do, q0w, WG)
        l2, d_i = lse2[..., q0w:q0w + WG, None], di[..., q0w:q0w + WG, None]
        dqw = torch.zeros_like(qw)
        for kt in range((min(q0 + BLOCK, T) - 1) // BWD_TILE + 1):
            j0 = kt * BWD_TILE
            if j0 > q0w + WG - 1:  # every key after every row: skipped
                continue
            visited_dq.add((q0w // WG, kt))
            kb, vb = tiles(k, j0, BWD_TILE), tiles(v, j0, BWD_TILE)
            p = torch.exp2((qw @ kb.transpose(-1, -2)) * c - l2)
            if j0 + BWD_TILE - 1 > q0w:
                cols = torch.arange(j0, j0 + BWD_TILE)
                p = p.masked_fill(cols[None, :] > rows[:, None], 0.0)
            dqw += (p * (dow @ vb.transpose(-1, -2) - d_i)) @ kb
        n = min(WG, T - q0w)
        dq[..., q0w:q0w + n, :] = (dqw * scale)[..., :n, :]
    return dq, dk, dv


@pytest.mark.parametrize("T,D", [(1, 16), (63, 32), (64, 64), (257, 96), (300, 128),
                                 (1025, 96), (127, 64), (128, 96), (129, 96), (173, 32),
                                 (200, 128)])
def test_tile_walk_matches_plain(T, D):
    """The kernels' walk at whole and ragged tiles (127, 128, 129 at the
    forward's tile edge; 173 leaves its last block's first warpgroup partial
    and the second idle, 200 the first whole and the second partial): every
    warpgroup with a row before T visits exactly the tiles at or below its
    diagonal (none wholly above it, none it would need skipped), and o, lse,
    dq, dk, dv are the plain versions'."""
    B, H = (1, 1) if T > 300 else (2, 2)
    q, k, v, do = (torch.from_numpy(t) for t in inputs(T + D + 1, B, H, T, D))
    scale = D ** -0.5
    visited = set()
    o, lse = emulate_fwd(q, k, v, scale, visited)
    ws = [w // WG for _, w in warpgroups(T)]
    assert visited == {(w, kt) for w in ws for kt in range(w * WG // FWD_KEYS + 1)}
    assert all(kt * FWD_KEYS <= w * WG + WG - 1 for w, kt in visited)
    want_o, want_lse = fa.flash_attn_fwd_plain(q, k, v, scale)
    assert rel(o, want_o) <= TOL and rel(lse, want_lse) <= TOL
    v_dkv, v_dq = set(), set()
    got = emulate_bwd(q, k, v, o, do, lse, scale, v_dkv, v_dq)
    n_tiles = -(-T // BWD_TILE)
    assert v_dkv == {(w, qt) for w in ws for qt in range(w, n_tiles)}
    assert v_dq == {(w, kt) for w in ws for kt in range(w + 1)}
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
