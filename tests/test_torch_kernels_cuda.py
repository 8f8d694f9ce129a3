"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the shapes chip_smoke.py does not reach: the other instantiated widths,
ragged row counts and small groups. Skips without a GPU. This file imports
no JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch
import torch.nn.functional as F

from omnitokenizer_tpu_torch.ops.kernels import cosine_mha as cm
from omnitokenizer_tpu_torch.ops.kernels import geglu_ff as gf
from omnitokenizer_tpu_torch.ops.kernels import ln_qkv as lq
from omnitokenizer_tpu_torch.ops.kernels import small_attn as sa
from omnitokenizer_tpu_torch.ops.kernels import vq_argmin as vq

pytestmark = pytest.mark.cuda

REL_TOL = 2e-2  # bf16 output rounding + another summation order


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


@pytest.mark.parametrize("M,D,dq,dkv", [(77, 64, 64, 128), (333, 128, 128, 256),
                                        (1000, 512, 512, 1024)])
def test_ln_qkv(gen, M, D, dq, dkv):
    x = randn(gen, M, D)
    gamma = 1 + randn(gen, D, scale=0.1, dtype=torch.float32)
    wq, wkv = randn(gen, dq, D, scale=D ** -0.5), randn(gen, dkv, D, scale=D ** -0.5)
    for got, want in zip(lq.ln_qkv(x, gamma, wq, wkv), lq.ln_qkv_plain(x, gamma, wq, wkv)):
        assert rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("D", gf.DIMS)
def test_geglu_ff(gen, D):
    M, inner = 77, int(4 * 2 / 3 * D)
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


@pytest.mark.parametrize("dim_head", cm.DIM_HEADS)
@pytest.mark.parametrize("N", [64, 256])
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
