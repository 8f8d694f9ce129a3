"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the shapes chip_smoke.py does not reach: the other instantiated widths,
ragged row counts and small groups, and mha at every instantiated head
width over its branches. Skips without a GPU. This file imports
no JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch
import torch.nn.functional as F

from omnitokenizer_tpu_torch.ops.kernels import cosine_mha as cm
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
    (36864, 256, 256, 512), (36864, 512, 512, 1024)])
def test_ln_qkv(gen, M, D, dq, dkv):
    x = randn(gen, M, D)
    gamma = 1 + randn(gen, D, scale=0.1, dtype=torch.float32)
    wq, wkv = randn(gen, dq, D, scale=D ** -0.5), randn(gen, dkv, D, scale=D ** -0.5)
    for got, want in zip(lq.ln_qkv(x, gamma, wq, wkv), lq.ln_qkv_plain(x, gamma, wq, wkv)):
        assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("D", gf.DIMS)
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


@pytest.mark.parametrize("dim_head", sa.DIM_HEADS)
@pytest.mark.parametrize("n", [1, 5, 8])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_small_n_attention(gen, dim_head, n, causal):
    heads, groups = 3, 37
    q = randn(gen, groups, n, heads * dim_head)
    kv = randn(gen, groups, n, 2 * heads * dim_head)
    qs = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    ks = 1 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    got = sa.small_n_attention(q, kv, qs, ks, heads, dim_head, 8.0, causal)
    want = sa.small_n_attention_plain(q, kv, qs, ks, heads, dim_head, 8.0, causal)
    assert rel_err(got, want) <= REL_TOL


# 1600 = 40^2 is the largest N the gate takes (a square, whole 64-token
# tiles, <= 2048), and leaves half of the last 128-query block past N
@pytest.mark.parametrize("dim_head", cm.DIM_HEADS)
@pytest.mark.parametrize("N", [64, 256, 1024, 1600])
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


@pytest.mark.parametrize("dim_head", cm.DIM_HEADS)
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "no_rope"])
def test_cosine_mha_large_logits(gen, dim_head, rope):
    """q_scale and k_scale near 3 put the logits up to ~72: the softmax is
    sharp, and P's bf16 rounding and the running max matter."""
    heads, B, N = 2, 2, 1024
    q = randn(gen, B, N, heads * dim_head)
    kv = randn(gen, B, N, 2 * heads * dim_head)
    qs = 3 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    ks = 3 + randn(gen, dim_head, scale=0.1, dtype=torch.float32)
    got = cm.cosine_mha(q, kv, qs, ks, heads, dim_head, 8.0, rope)
    want = cm.cosine_mha_plain(q, kv, qs, ks, heads, dim_head, 8.0, rope)
    assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("D", vq.CODE_DIMS)
@pytest.mark.parametrize("K", [64, 1000, 8192])
def test_vq_argmin(gen, D, K):
    z = F.normalize(randn(gen, 1000, D, dtype=torch.float32), dim=-1).contiguous()
    emb = randn(gen, K, D, dtype=torch.float32)
    got, want = vq.vq_argmin(z, emb), vq.vq_argmin_plain(z, emb)
    bad = (got != want).nonzero().flatten()
    if bad.numel():  # only near-ties may differ
        zz, e = z[bad].double(), emb.double()
        d_got = (zz - e[got[bad].long()]).square().sum(-1)
        d_want = (zz - e[want[bad].long()]).square().sum(-1)
        assert float(((d_got - d_want).abs() / d_want).max()) <= 1e-5


@pytest.mark.parametrize("dim_head", mh.DIM_HEADS)
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
    with pytest.raises(ValueError, match="unsupported"):
        cm.cosine_mha(randn(gen, 1, 100, 64), randn(gen, 1, 100, 128),
                      gamma[:64], gamma[:64], 1, 64, 8.0)
    q = randn(gen, 1, 2, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        mh.mha(q, q.transpose(-1, -2), q, 8.0)
    with pytest.raises(ValueError, match="bfloat16"):
        mh.mha(q, q, q.half(), 8.0)
    with pytest.raises(ValueError, match="unsupported"):
        mh.mha(q[:, :, :5], q[:, :, :5], q[:, :, :5], 8.0)
