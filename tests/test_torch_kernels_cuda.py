"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the shapes chip_smoke.py does not reach: the other widths and head
widths the gates take (model widths up to 2048, cosine_mha at head widths
16 to 128, the small-group core at every multiple of 16, mha's flash
branches on zero-padded widths, vq_argmin at any code dim with duplicate
codes), ragged row counts and small groups, the LM's causal flash attention
forward and backward over head widths 16-128, sequence lengths at its tile
edges, ragged ones and the long recipes' 5121, and its backward's determinism,
sequence parallelism's query blocks (cosine_mha at a block's offset, mha's
flash branches with fewer queries than keys), and the wrappers refusing
what the kernels do not take. Skips without a GPU. This file imports
no JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import ctypes

import pytest
import torch
import torch.nn.functional as F

from omnitokenizer_tpu_torch.ops.kernels import _build
from omnitokenizer_tpu_torch.ops.kernels import cosine_mha as cm
from omnitokenizer_tpu_torch.ops.kernels import flash_attn as fa
from omnitokenizer_tpu_torch.ops.kernels import geglu_ff as gf
from omnitokenizer_tpu_torch.ops.kernels import ln_qkv as lq
from omnitokenizer_tpu_torch.ops.kernels import mha as mh
from omnitokenizer_tpu_torch.ops.kernels import small_attn as sa
from omnitokenizer_tpu_torch.ops.kernels import vq_argmin as vq
from omnitokenizer_tpu_torch.ops.attention import sdpa

pytestmark = pytest.mark.cuda

REL_TOL = 2e-2  # bf16 output rounding + another summation order
F32_REL_TOL = 1e-5  # f32 with another summation order


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def randn(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("M,D,dq,dkv", [
    (77, 64, 64, 128), (333, 128, 128, 256), (1000, 512, 512, 1024),
    # the paths' row counts (ragged 128-row tiles past the flagship's 20480)
    (20480 + 33, 256, 256, 512), (20480 + 33, 512, 512, 1024),
    (36864, 256, 256, 512), (36864, 512, 512, 1024),
    # the widths past 512 (the LN pass at 4 and 8 chunks a lane)
    (333, 640, 640, 1280), (4097, 768, 1024, 2048), (1000, 1024, 1024, 2048),
    (20480 + 33, 768, 1024, 2048), (77, 2048, 2048, 4096), (4097, 2048, 512, 1024)])
def test_ln_qkv(gen, M, D, dq, dkv):
    x = randn(gen, M, D)
    gamma = 1 + randn(gen, D, scale=0.1, dtype=torch.float32)
    wq, wkv = randn(gen, dq, D, scale=D ** -0.5), randn(gen, dkv, D, scale=D ** -0.5)
    for got, want in zip(lq.ln_qkv(x, gamma, wq, wkv), lq.ln_qkv_plain(x, gamma, wq, wkv)):
        assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("D", [64, 128, 256, 512, 640, 768, 1024, 2048])
@pytest.mark.parametrize("M", [77, 1000, 20480 + 33])  # ragged 128-row tiles, a full-size M
def test_geglu_ff(gen, M, D):
    inner = int(4 * 2 / 3 * D)
    x = randn(gen, M, D)
    ln_w = 1 + randn(gen, D, scale=0.1, dtype=torch.float32)
    ln_b = randn(gen, D, scale=0.1, dtype=torch.float32)
    w1p, w2p = gf.pad_geglu_weights(randn(gen, 2 * inner, D, scale=D ** -0.5),
                                    randn(gen, D, inner, scale=inner ** -0.5))
    assert rel_err(gf.geglu_ff(x, ln_w, ln_b, w1p, w2p),
                   gf.geglu_ff_plain(x, ln_w, ln_b, w1p, w2p)) <= REL_TOL


# R = 1 and 3 leave a block's stage mostly empty; 4097 ends on a ragged stage
@pytest.mark.parametrize("groups", [1, 3, 37, 4097])
@pytest.mark.parametrize("dim_head", sa.DIM_HEADS)
@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_small_n_attention(gen, dim_head, n, causal, groups):
    heads = 3
    q = randn(gen, groups, n, heads * dim_head)
    kv = randn(gen, groups, n, 2 * heads * dim_head)
    qs = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    ks = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    got = sa.small_n_attention(q, kv, qs, ks, heads, dim_head, 8.0, causal)
    want = sa.small_n_attention_plain(q, kv, qs, ks, heads, dim_head, 8.0, causal)
    assert rel_err(got, want) <= REL_TOL


# squares with whole 64-key tiles (1600 leaves half of the last 128-query
# block past N) and ragged ones: 16 and 144 inside one or three tiles, 784
# (a 224^2 image at patch 8) and 2025, the largest square of the gate
@pytest.mark.parametrize("dim_head", cm.DIM_HEADS)
@pytest.mark.parametrize("N", [64, 256, 1024, 1600, 16, 144, 784, 2025])
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "no_rope"])
def test_cosine_mha(gen, dim_head, N, rope):
    heads, B = 3, 2
    q = randn(gen, B, N, heads * dim_head)
    kv = randn(gen, B, N, 2 * heads * dim_head)
    qs = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    ks = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    got = cm.cosine_mha(q, kv, qs, ks, heads, dim_head, 8.0, rope)
    want = cm.cosine_mha_plain(q, kv, qs, ks, heads, dim_head, 8.0, rope)
    assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("N", [1024, 784])
@pytest.mark.parametrize("dim_head", cm.DIM_HEADS)
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "no_rope"])
def test_cosine_mha_large_logits(gen, dim_head, rope, N):
    """q_scale and k_scale near 3 put the logits up to ~72: the softmax is
    sharp, and P's bf16 rounding and the running max matter."""
    heads, B = 2, 2
    q = randn(gen, B, N, heads * dim_head)
    kv = randn(gen, B, N, 2 * heads * dim_head)
    qs = 3 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    ks = 3 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    got = cm.cosine_mha(q, kv, qs, ks, heads, dim_head, 8.0, rope)
    want = cm.cosine_mha_plain(q, kv, qs, ks, heads, dim_head, 8.0, rope)
    assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("N", [16, 144, 784, 1024])
@pytest.mark.parametrize("dim_head", cm.DIM_HEADS)
def test_cosine_mha_batches_stay_apart(gen, dim_head, N):
    """inf and NaN in the second batch's v leave the first batch's output as
    the plain version gives it on that batch alone: a partial last key tile
    reads no v row of another batch."""
    heads = 2
    q = randn(gen, 2, N, heads * dim_head)
    kv = randn(gen, 2, N, 2 * heads * dim_head)
    kv[1, : N // 2, heads * dim_head:] = float("inf")
    kv[1, N // 2:, heads * dim_head:] = float("nan")
    qs = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    ks = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    got = cm.cosine_mha(q, kv, qs, ks, heads, dim_head, 8.0, True)[:1]
    want = cm.cosine_mha_plain(q[:1], kv[:1], qs, ks, heads, dim_head, 8.0, True)
    assert bool(torch.isfinite(got).all())
    assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("N", [16, 784, 1024])
@pytest.mark.parametrize("dim_head", cm.DIM_HEADS)
def test_cosine_mha_one_batch(gen, dim_head, N):
    heads = 3
    q, kv = randn(gen, 1, N, heads * dim_head), randn(gen, 1, N, 2 * heads * dim_head)
    qs = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    ks = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    assert rel_err(cm.cosine_mha(q, kv, qs, ks, heads, dim_head, 8.0, True),
                   cm.cosine_mha_plain(q, kv, qs, ks, heads, dim_head, 8.0, True)) <= REL_TOL


# sequence parallelism's query blocks: a rank's rows of the grid (2, 4 or 8
# ranks) against the whole grid's kv, RoPE at the block's offset
@pytest.mark.parametrize("dim_head", cm.DIM_HEADS)
@pytest.mark.parametrize("N,ranks", [(256, 2), (1024, 2), (1024, 4), (1024, 8), (1600, 2),
                                     (784, 4), (784, 1)])
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "no_rope"])
def test_cosine_mha_query_block(gen, dim_head, N, ranks, rope):
    """Each block's output equals the plain version's rows of the square
    call (800 and 196 queries end in a partial 128-query tile); 784 in one
    block is the square call itself."""
    heads, B = 3, 2
    q = randn(gen, B, N, heads * dim_head)
    kv = randn(gen, B, N, 2 * heads * dim_head)
    qs = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    ks = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    whole = cm.cosine_mha_plain(q, kv, qs, ks, heads, dim_head, 8.0, rope)
    nq = N // ranks
    for r in range(ranks):
        block = q[:, r * nq:(r + 1) * nq].contiguous()
        got = cm.cosine_mha(block, kv, qs, ks, heads, dim_head, 8.0, rope, q_offset=r * nq)
        assert got.shape == block.shape
        assert rel_err(got, whole[:, r * nq:(r + 1) * nq]) <= REL_TOL
        assert rel_err(got, cm.cosine_mha_plain(block, kv, qs, ks, heads, dim_head, 8.0, rope,
                                                q_offset=r * nq)) <= REL_TOL


def test_cosine_mha_refuses_bad_query_blocks(gen):
    """A block that reaches past the grid, or starts before it."""
    heads, dh = 2, 64
    kv = randn(gen, 1, 1024, 2 * heads * dh)
    qs = torch.ones(dh, device="cuda")
    for nq, off in ((64, 1000), (1024, 1), (512, 768), (256, -128)):
        with pytest.raises(ValueError, match="block"):
            cm.cosine_mha(randn(gen, 1, nq, heads * dh), kv, qs, qs, heads, dh, 8.0, True,
                          q_offset=off)


VQ_TIE_TOL = 1e-5  # relative distance gap allowed for an index mismatch


@pytest.mark.parametrize("M", [1, 1000, 20480 + 33])
@pytest.mark.parametrize("K", [1, 64, 1000, 8192, 8193])
@pytest.mark.parametrize("D", [1, 3, 4, 6, 8, 12, 16, 32, 33, 37, 40, 64, 256])
def test_vq_argmin(gen, D, K, M):
    """Every code repeats with a period of 97, so exact ties lie across
    every chunk, thread, code-tile and code-slice boundary: the kernel gives
    the first occurrence (an index below 97), and differs from the plain
    version only at near-ties between distinct codes."""
    check_period_ties(gen, M, K, D)


def check_period_ties(gen, M, K, D):
    period = min(K, 97)
    z = F.normalize(randn(gen, M, D, dtype=torch.float32), dim=-1).contiguous()
    emb = randn(gen, period, D, dtype=torch.float32)[torch.arange(K) % period].contiguous()
    got = vq.vq_argmin(z, emb)
    assert got.dtype == torch.int32 and got.shape == (M,)
    assert bool((got >= 0).all()) and bool((got < period).all())
    assert_near_ties_only(z, emb, got, vq.vq_argmin_plain(z, emb))


def test_vq_argmin_cnn_vqgan(gen):
    """The CNN VQGAN's codebook search, (16384, 256) rows against (2048,
    256) codes: the period-97 ties, then zero codes at every 61st index."""
    check_period_ties(gen, 16384, 2048, 256)
    check_zero_codes(gen, 16384, 2048, 256)


def assert_near_ties_only(z, emb, got, want):
    bad = (got != want).nonzero().flatten()
    if bad.numel():
        zz, e = z[bad].double(), emb.double()
        d_got = (zz - e[got[bad].long()]).square().sum(-1)
        d_want = (zz - e[want[bad].long()]).square().sum(-1)
        assert float(((d_got - d_want).abs() / d_want.clamp_min(1e-12)).max()) <= VQ_TIE_TOL


@pytest.mark.parametrize("K", [1, 1000])
@pytest.mark.parametrize("D", [100, 2049, 4096])
def test_vq_argmin_wide_code_dims(gen, D, K):
    """Wide code dims: the tiled kernel streams any D through its ring, the
    last step zero-filled, so no code dim is refused."""
    z = F.normalize(randn(gen, 333, D, dtype=torch.float32), dim=-1).contiguous()
    emb = randn(gen, K, D, dtype=torch.float32)
    assert_near_ties_only(z, emb, vq.vq_argmin(z, emb), vq.vq_argmin_plain(z, emb))


@pytest.mark.parametrize("D", [64, 256])
def test_vq_argmin_unaligned_rows(gen, D):
    """Contiguous inputs that start 4 bytes past 16: the tiled kernel's
    4-byte copies, the same indices as from aligned copies of them."""
    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    z = F.normalize(randn(gen, 1000 + 33, D, dtype=torch.float32), dim=-1).contiguous()
    emb = randn(gen, 2048 + 5, D, dtype=torch.float32)
    got = vq.vq_argmin(unaligned(z), unaligned(emb))
    assert torch.equal(got, vq.vq_argmin(z, emb))
    assert_near_ties_only(z, emb, got, vq.vq_argmin_plain(z, emb))


@pytest.mark.parametrize("K", [1000, 2048, 8192, 8193])
@pytest.mark.parametrize("D", [3, 8, 33, 37, 40, 256])
def test_vq_argmin_zero_distance_ties(gen, D, K):
    """Zero codes are at distance exactly 0 from every row, and every other
    code farther: zero codes planted at every 61st index, across chunk,
    thread, tile and slice boundaries, give the first of them."""
    check_zero_codes(gen, 20480 + 33, K, D)


def check_zero_codes(gen, M, K, D):
    z = 1e-3 * F.normalize(randn(gen, M, D, dtype=torch.float32), dim=-1)
    emb = randn(gen, K, D, dtype=torch.float32)
    emb[61::61] = 0
    assert bool((vq.vq_argmin(z, emb) == 61).all())


# the instantiated widths, and widths with no instance, zero-padded to the
# next (24 -> 32, 40 -> 64, 96 and 120 -> 128; at N <= 16 the small branch
# runs at the padded width)
@pytest.mark.parametrize("dim_head", mh.DIM_HEADS + (24, 40, 96, 120))
@pytest.mark.parametrize("N", [8, 9, 17, 64, 100, 1024, 2048])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha(gen, dtype, causal, N, dim_head):
    B, H, dt = 2, 3, getattr(torch, dtype)
    q, k, v = (randn(gen, B, H, N, dim_head, dtype=dt) for _ in range(3))
    got = mh.mha(q, k, v, dim_head ** -0.5, causal)
    want = mh.mha_plain(q, k, v, dim_head ** -0.5, causal)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    assert rel_err(got, want) <= (F32_REL_TOL if dtype == "float32" else REL_TOL)


# the flash branches' query blocks, non-causal: N of Nk queries (a rank's
# rows under sequence parallelism; the f32 VAE's 512 of 1024 at two ranks)
@pytest.mark.parametrize("dim_head", mh.DIM_HEADS + (40,))
@pytest.mark.parametrize("N,Nk", [(512, 1024), (256, 1024), (16, 64), (8, 16), (100, 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_query_block(gen, dtype, N, Nk, dim_head):
    B, H, dt = 2, 3, getattr(torch, dtype)
    q = randn(gen, B, H, N, dim_head, dtype=dt)
    k, v = (randn(gen, B, H, Nk, dim_head, dtype=dt) for _ in range(2))
    got = mh.mha(q, k, v, dim_head ** -0.5)
    want = mh.mha_plain(q, k, v, dim_head ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    assert rel_err(got, want) <= (F32_REL_TOL if dtype == "float32" else REL_TOL)


def test_mha_refuses_causal_query_block(gen):
    q, k = randn(gen, 1, 2, 64, 64), randn(gen, 1, 2, 128, 64)
    with pytest.raises(ValueError, match="causal"):
        mh.mha(q, k, k, 8.0, True)


def bnhd_views(gen, B, H, N, D, dt):
    """q, k and v as the attention module hands them to sdpa: (B, H, N, D)
    views of (B, N, H, D) memory, v inside a fused (B, N, 2*H*D) kv."""
    q, k = (randn(gen, B, N, H, D, dtype=dt).transpose(1, 2) for _ in range(2))
    kv = randn(gen, B, N, 2 * H * D, dtype=dt)
    return q, k, kv[..., H * D:].view(B, N, H, D).transpose(1, 2)


@pytest.mark.parametrize("layout", ["contiguous", "bnhd_views"])
@pytest.mark.parametrize("dim_head", mh.SMALL_DIM_HEADS)
@pytest.mark.parametrize("N", range(8, 17))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_small_branch(gen, dtype, causal, N, dim_head, layout):
    B, H, dt = 5, 3, getattr(torch, dtype)
    if layout == "contiguous":
        q, k, v = (randn(gen, B, H, N, dim_head, dtype=dt) for _ in range(3))
    else:
        q, k, v = bnhd_views(gen, B, H, N, dim_head, dt)
    got = mh.mha(q, k, v, dim_head ** -0.5, causal)
    want = mh.mha_plain(q, k, v, dim_head ** -0.5, causal)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    assert got.stride() == (q.stride() if layout == "bnhd_views" else q.contiguous().stride())
    assert rel_err(got, want) <= (F32_REL_TOL if dtype == "float32" else REL_TOL)


def mha_f64(q, k, v, scale, causal):
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=s.device).triu(1), mh.NEG_INF)
    return s.softmax(-1) @ v.double()


def assert_f32_large_logits(got, q, k, v, scale, causal):
    """At logits near 200 one f32 ulp is 1.5e-5, so two f32 summation orders
    differ by ~1e-5 and the plain version is no yardstick at 1e-5: the kernel
    is held against an f64 result, to 1e-5 or to twice the plain version's
    own error there, whichever is larger."""
    want = mha_f64(q, k, v, scale, causal)
    plain = rel_err(mh.mha_plain(q, k, v, scale, causal), want)
    assert rel_err(got, want) <= max(F32_REL_TOL, 2 * plain)


@pytest.mark.parametrize("dim_head", mh.DIM_HEADS)
@pytest.mark.parametrize("N,causal", [(64, True), (100, False), (1024, False), (2048, True)])
def test_mha_f32_large_logits(gen, dim_head, N, causal):
    q, k, v = (randn(gen, 2, 2, N, dim_head, dtype=torch.float32) for _ in range(3))
    assert_f32_large_logits(mh.mha(q, k, v, 8.0, causal), q, k, v, 8.0, causal)


def test_sdpa_launches_mha_inside_its_gate(gen):
    def qkv(N, normalize=True):  # (B, H, N, D) views of (B, N, H, D) tensors, as
        # Attention passes them: q and k l2-normalized by the cosine attention,
        # so the logits stay within +-scale, or N(0, 1), which puts them near 200
        q, k, v = (randn(gen, 2, N, 2, 64, dtype=torch.float32) for _ in range(3))
        if normalize:
            q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
        return [t.transpose(1, 2) for t in (q, k, v)]

    mh.mha.launches = 0
    q, k, v = qkv(64)
    out = sdpa(q, k, v, 8.0, causal=True)
    assert mh.mha.launches == 1
    assert rel_err(out, mh.mha_plain(q, k, v, 8.0, True)) <= F32_REL_TOL
    q, k, v = qkv(64, normalize=False)
    assert_f32_large_logits(sdpa(q, k, v, 8.0, causal=True), q, k, v, 8.0, True)
    assert mh.mha.launches == 2
    sdpa(q, k, v, 8.0, training=True)   # training takes the plain math
    sdpa(*qkv(5), 8.0)                  # and so does N < 8
    assert mh.mha.launches == 2


def test_wrappers_refuse_bad_input(gen):
    x = randn(gen, 64, 512)
    gamma = torch.ones(512, device="cuda")
    w = randn(gen, 512, 512)
    with pytest.raises(ValueError, match="contiguous"):
        lq.ln_qkv(x.t(), gamma, w, w)
    with pytest.raises(ValueError, match="bfloat16"):
        lq.ln_qkv(x.float(), gamma, w, w)
    with pytest.raises(ValueError, match="unsupported"):  # 99 is no square
        cm.cosine_mha(randn(gen, 1, 99, 64), randn(gen, 1, 99, 128),
                      gamma[:64], gamma[:64], 1, 64, 8.0)
    q = randn(gen, 1, 2, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        mh.mha(q, q.transpose(-1, -2), q, 8.0)
    with pytest.raises(ValueError, match="bfloat16"):
        mh.mha(q, q, q.half(), 8.0)
    with pytest.raises(ValueError, match="unsupported"):
        mh.mha(q[:, :, :5], q[:, :, :5], q[:, :, :5], 8.0)


def test_mha_small_branch_refuses_bad_views(gen):
    """The small branch reads strided views, but only with a unit last
    stride and rows 16 bytes apart."""
    q = randn(gen, 1, 2, 9, 64)
    with pytest.raises(ValueError, match="unit last stride"):
        mh.mha(q, randn(gen, 1, 2, 9, 128)[..., ::2], q, 8.0)
    with pytest.raises(ValueError, match="16-byte"):
        mh.mha(q, q, randn(gen, 1, 2, 9, 68)[..., :64], 8.0)
    assert mh.mha(q, q, q, 8.0).is_contiguous()


def test_mha_flash_refuses_strided_views(gen):
    """The flash branches read dense (B*H, N, D) tensors: the C entry point
    refuses any other strides, whatever the wrapper lets through, but takes
    any stride of a dim of size 1."""
    q = randn(gen, 2, 2, 64, 64)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr())
    for strides, ok in (((8192, 4096, 64) * 4, True), ((8192, 64, 128) * 4, False)):
        st = (ctypes.c_longlong * 12)(*strides)
        if ok:
            _build.launch("mha_launch", *ptrs, ctypes.addressof(st), 2, 2, 64, 64, 64, 8.0, 0, 1)
        else:
            with pytest.raises(RuntimeError, match="CUDA error"):
                _build.launch("mha_launch", *ptrs, ctypes.addressof(st), 2, 2, 64, 64, 64, 8.0, 0, 1)
    one = randn(gen, 2, 1, 64, 64).transpose(0, 1)  # (1, 2, 64, 64), batch stride 4096
    assert one.is_contiguous() and one.stride(0) != one.numel()
    assert rel_err(mh.mha(one, one, one, 8.0), mh.mha_plain(one, one, one, 8.0)) <= REL_TOL


def test_wrappers_refuse_narrowed_widths(gen):
    """Each wrapper raises on the residual narrowing it exports, which the
    modules route to plain math, and on what no gate takes."""
    x = randn(gen, 64, 4096)
    assert lq.narrowed(4096) and gf.narrowed(4096)
    with pytest.raises(ValueError, match="unsupported"):
        lq.ln_qkv(x, torch.ones(4096, device="cuda"), randn(gen, 64, 4096),
                  randn(gen, 128, 4096))
    with pytest.raises(ValueError, match="unsupported"):
        gf.geglu_ff(x, torch.ones(4096, device="cuda"), torch.zeros(4096, device="cuda"),
                    randn(gen, 128, 4096), randn(gen, 4096, 64))
    qs = torch.ones(48, device="cuda")
    assert cm.narrowed(64, 48)
    with pytest.raises(ValueError, match="unsupported"):
        cm.cosine_mha(randn(gen, 1, 64, 96), randn(gen, 1, 64, 192), qs, qs, 2, 48, 8.0)
    assert sa.narrowed(5, 24)
    with pytest.raises(ValueError, match="unsupported"):
        sa.small_n_attention(randn(gen, 4, 5, 48), randn(gen, 4, 5, 96), qs[:24], qs[:24], 2,
                             24, 8.0)
    q = randn(gen, 1, 2, 64, 256)
    assert mh.narrowed(64, 256)
    with pytest.raises(ValueError, match="unsupported"):
        mh.mha(q, q, q, 8.0)
    with pytest.raises(ValueError, match="unsupported"):
        mh.mha(q[..., :12], q[..., :12], q[..., :12], 8.0)  # D % 8 != 0: no gate takes it
    z = randn(gen, 8, 16, dtype=torch.float32)
    with pytest.raises(ValueError, match="expected shape"):
        vq.vq_argmin(z, z[:, :8].contiguous())  # code dims that differ


def test_wrappers_refuse_grad_requiring_inputs(gen):
    """A kernel has no backward: each wrapper but vq_argmin (integer
    indices) raises on an input that requires grad under grad mode, and
    launches under no_grad; a bf16 module's inference call on its
    grad-requiring parameters raises too."""
    from omnitokenizer_tpu_torch.ops.attention import Attention, FeedForward

    x, qs = randn(gen, 64, 128), torch.ones(64, device="cuda")
    g32 = torch.ones(128, device="cuda")
    wq, wkv = randn(gen, 128, 128, scale=0.1), randn(gen, 256, 128, scale=0.1)
    w1p, w2p = gf.pad_geglu_weights(randn(gen, 680, 128, scale=0.1), randn(gen, 128, 340))
    q3, kv3 = randn(gen, 4, 16, 128), randn(gen, 4, 16, 256)
    q4 = randn(gen, 1, 2, 64, 64)
    calls = {
        "ln_qkv": lambda t: lq.ln_qkv(t, g32, wq, wkv),
        "geglu_ff": lambda t: gf.geglu_ff(t, g32, g32, w1p, w2p),
        "small_n_attention": lambda t: sa.small_n_attention(t[:, :8].contiguous(),
                                                            kv3[:, :8].contiguous(),
                                                            qs, qs, 2, 64, 8.0),
        "cosine_mha": lambda t: cm.cosine_mha(t, kv3, qs, qs, 2, 64, 8.0),
        "mha": lambda t: mh.mha(t, q4, q4, 8.0),
    }
    inputs = {"ln_qkv": x, "geglu_ff": x, "small_n_attention": q3, "cosine_mha": q3,
              "mha": q4}
    for name, call in calls.items():
        t = inputs[name].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="has no backward"):
            call(t)
        with torch.no_grad():
            call(t)
    z = randn(gen, 8, 8, dtype=torch.float32).requires_grad_()
    vq.vq_argmin(z, z.detach())
    attn = Attention(128, 64, 2, spatial_pos="rope", dtype=torch.bfloat16).cuda()
    ff = FeedForward(128, dtype=torch.bfloat16).cuda()
    for module in (attn, ff):
        with pytest.raises(RuntimeError, match="has no backward"):
            module(q3)
        with torch.no_grad():
            module(q3)


@pytest.mark.parametrize("route,n,spatial,causal", [
    ("small", 5, False, True), ("small", 8, False, True), ("cosine", 64, True, False),
    ("cosine", 1024, True, False)])
def test_training_route_function(gen, route, n, spatial, causal):
    """The training route on the card: the kernels as the primal (within
    the kernels' bar of the plain math), the gradients of every input equal
    to the plain math's (the backward is that math on the same inputs, on
    the same card), and no kernel launched by the backward."""
    import functools

    from omnitokenizer_tpu_torch.ops import attention as tattn
    from omnitokenizer_tpu_torch.ops.kernel_grad import kernel_fwd_ref_bwd
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    m = tattn.Attention(256, 64, 4, causal=causal, spatial_pos="rope", dtype=torch.bfloat16,
                        spatial=spatial).cuda()
    assert m.train_route(n, spatial) == route
    x = randn(gen, 8, n, 256).requires_grad_()
    args = (x, m.norm_gamma, m.to_q.weight, m.to_kv.weight, m.q_scale, m.k_scale)
    ref = functools.partial(tattn.attention_ref_math, dtype=torch.bfloat16, heads=4,
                            dim_head=64, scale=8.0, causal=causal, use_rope=spatial)
    out = kernel_fwd_ref_bwd(functools.partial(m._train_kernel, route, spatial), ref, *args)
    want = ref(*args)
    assert rel_err(out.detach(), want.detach()) <= REL_TOL
    g = torch.randn(out.shape, generator=gen).to("cuda", out.dtype)
    reset_launch_counts()
    got = torch.autograd.grad(out, args, g)
    assert not any(launch_counts().values())
    for a, b in zip(got, torch.autograd.grad(want, args, g)):
        assert torch.equal(a, b)


# -- causal flash attention (the LM's training forward) ---------------------------------
FLASH_FWD_TOL, FLASH_BWD_TOL = 1e-2, 2e-2  # bf16 outputs against f32 math on bf16 inputs


def flash_inputs(gen, B, H, T, D, scale=1.0):
    """q, k, v, do as the LM hands them over: (B, H, T, D) views of (B, T, H, D)
    memory."""
    return [randn(gen, B, T, H, D, scale=scale).transpose(1, 2) for _ in range(4)]


def check_flash(q, k, v, do, scale):
    o, lse = fa.flash_attn_fwd(q, k, v, scale)
    o_ref, lse_ref = fa.flash_attn_fwd_plain(q, k, v, scale)
    assert rel_err(o, o_ref) <= FLASH_FWD_TOL
    assert float((lse - lse_ref).abs().max()) <= 1e-3 * max(1.0, float(lse_ref.abs().max()))
    grads = fa.flash_attn_bwd(q, k, v, o, do, lse, scale)
    want = fa.flash_attn_bwd_plain(q, k, v, o_ref, do, lse_ref, scale)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert bool(torch.isfinite(got).all())
        if q.shape[2] == 1 and name != "dv":
            # a softmax over one key: dq and dk are 0 in exact arithmetic, and
            # both sides hold only the rounding of do.v - o.do
            assert max(float(got.abs().max()), float(w.abs().max())) <= 1e-4
        else:
            assert rel_err(got, w) <= FLASH_BWD_TOL
    return o, grads


# every width at the tile edges (64, 127-129: the forward's 128-row blocks and
# key tiles) and ragged T; the long-sequence recipes' T = 5121 at their width
FLASH_CASES = [(D, T, B, H) for D in (16, 32, 64, 96, 128)
               for T in (1, 63, 127, 128, 129, 256, 257, 1025, 2048)
               for B, H in ((1, 1), (2, 3))] + [(96, 5121, 1, 1)]


@pytest.mark.parametrize("D,T,B,H", FLASH_CASES,
                         ids=[f"{B}-{H}-{T}-{D}" for D, T, B, H in FLASH_CASES])
def test_flash_attn(gen, D, T, B, H):
    check_flash(*flash_inputs(gen, B, H, T, D), D ** -0.5)


@pytest.mark.parametrize("D,T", [(96, 1025), (128, 300)])
def test_flash_attn_bwd_deterministic(gen, D, T):
    """One writer a row and no atomics: two backward runs on the same inputs
    are bitwise equal."""
    q, k, v, do = flash_inputs(gen, 2, 16, T, D)
    o, lse = fa.flash_attn_fwd(q, k, v, D ** -0.5)
    first = fa.flash_attn_bwd(q, k, v, o, do, lse, D ** -0.5)
    second = fa.flash_attn_bwd(q, k, v, o, do, lse, D ** -0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D,T", [(24, 300), (80, 129), (112, 64)])
def test_flash_attn_padded_widths(gen, D, T):
    """Widths between the instances go to the next one, zero-padded."""
    o, grads = check_flash(*flash_inputs(gen, 2, 2, T, D), D ** -0.5)
    assert o.shape[-1] == D and all(g.shape[-1] == D for g in grads)


def test_flash_attn_contiguous_and_expanded(gen):
    """Contiguous (B, H, T, D) tensors, and a gradient with a zero stride (a
    copy), give what the views give."""
    q, k, v, do = (t.contiguous() for t in flash_inputs(gen, 2, 4, 300, 64))
    check_flash(q, k, v, do, 0.125)
    ones = torch.ones(1, 1, 1, 64, dtype=torch.bfloat16, device="cuda").expand(2, 4, 300, 64)
    o, lse = fa.flash_attn_fwd(q, k, v, 0.125)
    got = fa.flash_attn_bwd(q, k, v, o, ones, lse, 0.125)
    want = fa.flash_attn_bwd(q, k, v, o, ones.contiguous(), lse, 0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 96])
def test_flash_attn_large_logits(gen, D):
    """Logits in the thousands (near where exp overflows f32 without the
    running max): no NaN, and the plain math's answer."""
    q, k, v, do = flash_inputs(gen, 1, 2, 1025, D)
    q, k = q * 30, k * 30
    check_flash(q, k, v, do, D ** -0.5)


def test_flash_attention_function(gen):
    """The autograd Function: one forward and one backward launch, the
    backward's gradients those of flash_attn_bwd, and the result
    deterministic."""
    from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    q, k, v, do = (t.detach().requires_grad_() for t in flash_inputs(gen, 2, 4, 1025, 96))
    reset_launch_counts()
    o = fa.flash_attention(q, k, v, 96 ** -0.5)
    got = torch.autograd.grad(o, (q, k, v), do)
    counts = launch_counts()
    assert counts["flash_attn_fwd"] == 1 and counts["flash_attn_bwd"] == 1
    with torch.no_grad():
        o2, lse = fa.flash_attn_fwd(q, k, v, 96 ** -0.5)
        want = fa.flash_attn_bwd(q, k, v, o2, do, lse, 96 ** -0.5)
    assert torch.equal(o.detach(), o2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_attn_refuses(gen, monkeypatch):
    """The wrappers refuse the narrowed widths, other dtypes and unaligned
    rows' shapes they cannot read; a CUDA input with no kernel library raises
    and never takes the plain route."""
    q = randn(gen, 1, 2, 256, 256)
    assert fa.narrowed(256, 256) and not fa.narrowed(256, 96) and not fa.narrowed(255, 256)
    with pytest.raises(ValueError, match="unsupported"):
        fa.flash_attn_fwd(q, q, q, 0.0625)
    f = randn(gen, 1, 2, 256, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        fa.flash_attn_fwd(f, f, f, 0.125)
    b = randn(gen, 1, 2, 256, 64)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attn_fwd(b.requires_grad_(), b, b, 0.125)

    def no_library():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")

    monkeypatch.setattr(_build, "library", no_library)
    fa.flash_attn_fwd.launches = 0
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_attn_fwd(b.detach(), b.detach(), b.detach(), 0.125)
    assert fa.flash_attn_fwd.launches == 0
