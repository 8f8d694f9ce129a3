"""The port's kernel gates against the JAX package's, and the bf16 attention
module's dispatch.

Gates: over a grid of widths, head widths and token counts, the port takes
every shape a JAX gate takes (run with backend_check=False), but for exactly
the residual narrowing each wrapper exports (`narrowed`). vq_argmin has no
gate: like the JAX kernel it takes any code dim.
Dispatch: a bf16 `Attention` on the CPU, its kernel functions replaced by
spies, projects with `ln_qkv` where that kernel takes the width and plainly
elsewhere, and then runs `small_n_attention` or `cosine_mha` whatever made
q and kv, as the JAX module does."""

import types

import jax
import pytest
import torch

from omnitokenizer_tpu.ops.pallas import cosine_mha as jcm
from omnitokenizer_tpu.ops.pallas import geglu_ff as jgf
from omnitokenizer_tpu.ops.pallas import ln_qkv as jlq
from omnitokenizer_tpu.ops.pallas import mha as jmha
from omnitokenizer_tpu.ops.pallas import small_attn as jsa
from omnitokenizer_tpu_torch.ops import attention as tattn
from omnitokenizer_tpu_torch.ops.kernels import cosine_mha as cm
from omnitokenizer_tpu_torch.ops.kernels import geglu_ff as gf
from omnitokenizer_tpu_torch.ops.kernels import ln_qkv as lq
from omnitokenizer_tpu_torch.ops.kernels import mha as mh
from omnitokenizer_tpu_torch.ops.kernels import small_attn as sa

torch.set_num_threads(1)

DIMS = range(8, 4097, 8)         # model widths, past the port's 2048
DIM_HEADS = range(1, 257)        # head widths
TOKENS = range(1, 2101)          # N, past the gates' 2048


def assert_gate(jax_takes, port_takes, narrowed, shapes):
    """The port takes every shape the JAX gate takes but the narrowed ones,
    and a narrowed shape is one the JAX gate takes and the port does not."""
    for shape in shapes:
        if narrowed(*shape):
            assert jax_takes(*shape) and not port_takes(*shape), shape
        elif jax_takes(*shape):
            assert port_takes(*shape), shape


def test_ln_qkv_gate():
    inner = 512
    assert_gate(lambda d: jlq.ln_qkv_supported(jax.numpy.bfloat16, d, backend_check=False),
                lambda d: lq.ln_qkv_supported(d, inner, 2 * inner), lq.narrowed,
                [(d,) for d in DIMS])
    assert lq.narrowed(4096) and not lq.narrowed(2048)


def test_geglu_ff_gate():
    assert_gate(lambda d: jgf.geglu_ff_supported(jax.numpy.bfloat16, d, backend_check=False),
                gf.geglu_ff_supported, gf.narrowed, [(d,) for d in DIMS])
    assert all(gf.geglu_ff_supported(d) for d in (640, 768, 1024, 2048))


@pytest.mark.parametrize("dim_heads", [range(1, 65), range(65, 257)],
                         ids=["dim_head_1-64", "dim_head_65-256"])
def test_cosine_mha_gate(dim_heads):
    squares = [n for n in TOKENS if int(n ** 0.5) ** 2 == n] + [15, 17, 99, 1023, 2050]
    assert_gate(lambda n, dh: jcm.cosine_mha_supported(n, None, False, backend_check=False),
                cm.cosine_mha_supported, cm.narrowed,
                [(n, dh) for n in squares for dh in dim_heads])
    assert [dh for dh in DIM_HEADS if cm.cosine_mha_supported(1024, dh)] == [16, 32, 64, 128]


def test_small_n_gate():
    assert_gate(lambda n, dh: jsa.small_n_supported(n, None, backend_check=False),
                sa.small_n_supported, sa.narrowed,
                [(n, dh) for n in range(1, 20) for dh in DIM_HEADS])
    assert [dh for dh in DIM_HEADS if sa.small_n_supported(5, dh)] == list(range(16, 129, 16))


def test_mha_gate(monkeypatch):
    """`pallas/mha.py:mha_supported` has no backend_check and declines off a
    TPU: its own conditions (MAX_FUSED_N, N >= 8, D % 8 == 0) are evaluated
    here by answering its backend query with "tpu"."""
    monkeypatch.setattr(jmha.jax, "default_backend", lambda: "tpu")

    def jax_takes(n, d):
        return jmha.mha_supported(types.SimpleNamespace(shape=(1, 1, n, d)), None, False)

    shapes = [(n, d) for n in (1, 7, 8, 9, 16, 17, 64, 1024, jmha.MAX_FUSED_N,
                               jmha.MAX_FUSED_N + 1) for d in DIM_HEADS]
    for dtype in mh.DTYPES:
        assert_gate(jax_takes, lambda n, d: mh.mha_supported(n, d, dtype), mh.narrowed, shapes)
    assert mh.narrowed(1024, 256) and not mh.narrowed(1024, 120)


# --------------------------------------------------------------- dispatch
def spy(monkeypatch, calls):
    """Replace the attention module's kernel functions with spies that record
    each call in order and run the real function (its plain version here)."""
    for name in ("ln_qkv", "small_n_attention", "cosine_mha", "mha"):
        real = getattr(tattn, name)

        def wrapped(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(tattn, name, wrapped)


@pytest.mark.parametrize("dim,dim_head,heads,n,causal,rope,want", [
    (768, 64, 2, 5, True, False, ["ln_qkv", "small_n_attention"]),
    (768, 128, 2, 64, False, True, ["ln_qkv", "cosine_mha"]),
    # 96 is outside both packages' ln_qkv gates and inside their attention
    # gates: plain projections, then the attention kernel
    (96, 32, 3, 5, True, False, ["small_n_attention"]),
    (96, 32, 3, 16, False, True, ["cosine_mha"]),
], ids=["768_small_n", "768_cosine", "96_small_n", "96_cosine"])
def test_bf16_attention_dispatch(monkeypatch, dim, dim_head, heads, n, causal, rope, want):
    calls = []
    spy(monkeypatch, calls)
    torch.manual_seed(0)
    attn = tattn.Attention(dim, dim_head=dim_head, heads=heads, causal=causal,
                           spatial_pos="rope" if rope else "rel", dtype=torch.bfloat16)
    with torch.no_grad():
        for p in attn.parameters():
            p.data = p.data.to(torch.bfloat16)
    attn.prepare_kernels()
    x = torch.randn(2, n, dim).to(torch.bfloat16)
    with torch.no_grad():
        out = attn(x, is_spatial=rope)
        assert calls == want
        # the plain route, no kernels: a training call with the kernel-forward
        # op groups off (ops/kernel_grad.py)
        monkeypatch.setenv("OMNITOK_TRAIN_KERNEL_FWD", "0")
        ref = attn(x, is_spatial=rope, training=True)
    assert calls == want
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert float((out.float() - ref.float()).abs().max() / ref.float().abs().max()) <= 3e-2
