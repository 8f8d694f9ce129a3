"""The training route of the bf16 attention and feed-forward modules: the
kernels as the primal, the plain math recomputed as the backward
(ops/kernel_grad.py), on the CPU, where each kernel wrapper runs its plain
version.

- `train_kernel_fwd_ops()` parses OMNITOK_TRAIN_KERNEL_FWD as the JAX one,
  and raises on a token the JAX one would drop.
- The route a bf16 training call takes (flat small-group, spatial
  small-group or cosine attention, geglu feed-forward, or the plain math)
  is the one the JAX modules take, found with spies on the JAX side (its
  gates without their TPU check, its kernel_fwd_ref_bwd recorded).
- Through the Function the gradients of every input equal those of the
  plain math exactly: the backward is that math on the same inputs.
- A bf16 step of the trainer on the CPU runs the training route at every
  't' block and feed-forward, launches no kernel, and its losses are
  finite.
- A kernel wrapper refuses a grad-requiring input under grad mode (the
  guard every CUDA wrapper runs), but not under no_grad."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from omnitokenizer_tpu.ops import attention as jattn
from omnitokenizer_tpu.ops import kernel_grad as jkg
from omnitokenizer_tpu.ops.pallas import cosine_mha as jcm
from omnitokenizer_tpu.ops.pallas import geglu_ff as jgf
from omnitokenizer_tpu.ops.pallas import ln_qkv as jlq
from omnitokenizer_tpu.ops.pallas import small_attn as jsa
from omnitokenizer_tpu_torch.config import LossConfig, TokenizerConfig, TrainConfig
from omnitokenizer_tpu_torch.ops import attention as tattn
from omnitokenizer_tpu_torch.ops import kernel_grad as tkg
from omnitokenizer_tpu_torch.ops.kernels import _build, launch_counts, reset_launch_counts
from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer

from torch_port_util import SMALL

torch.set_num_threads(1)


@pytest.mark.parametrize("raw", [None, "", "0", "1", "attn", "ff,flat", " attn , ff ,", "flat"])
def test_ops_parse_like_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("OMNITOK_TRAIN_KERNEL_FWD", raising=False)
    else:
        monkeypatch.setenv("OMNITOK_TRAIN_KERNEL_FWD", raw)
    assert tkg.train_kernel_fwd_ops() == jkg.train_kernel_fwd_ops()


@pytest.mark.parametrize("raw", ["atn", "attn,gelu", "ff, flat, 2"])
def test_ops_refuse_unknown_tokens(monkeypatch, raw):
    """A misspelt group raises, where the JAX package drops it silently."""
    monkeypatch.setenv("OMNITOK_TRAIN_KERNEL_FWD", raw)
    with pytest.raises(ValueError, match="unknown op groups"):
        tkg.train_kernel_fwd_ops()


@functools.lru_cache(maxsize=None)
def _jax_attention(is_spatial, causal, pos, dim=128, dim_head=64):
    """A bf16 JAX Attention and its variables, built once for each kind
    (its parameters do not depend on the group length), before any gate
    or kernel is replaced."""
    m = jattn.Attention(dim=dim, dim_head=dim_head, heads=2, causal=causal, spatial_pos=pos,
                        dtype=jnp.bfloat16)
    x = jnp.ones((2, 8, dim), jnp.bfloat16)
    return m, m.init(jax.random.PRNGKey(0), x, is_spatial=is_spatial, training=True)


def _jax_route(monkeypatch, n, is_spatial, causal, pos, dim=128, dim_head=64):
    """The kernel a bf16 JAX Attention's training call reaches: its gates
    without the TPU check, its kernel_fwd_ref_bwd recorded and the
    recorded primal run with spies for kernels. The temporal stack reaches
    it as token-flat rows when n <= 8, as the JAX transformer lays it out
    in bf16 on its accelerator."""
    m, variables = _jax_attention(is_spatial, causal, pos, dim, dim_head)
    monkeypatch.setattr(jlq, "ln_qkv_supported",
                        functools.partial(jlq.ln_qkv_supported, backend_check=False))
    monkeypatch.setattr(jsa, "small_n_supported",
                        functools.partial(jsa.small_n_supported, backend_check=False))
    monkeypatch.setattr(jcm, "cosine_mha_supported",
                        functools.partial(jcm.cosine_mha_supported, backend_check=False))
    recorded, fired = [], []
    monkeypatch.setattr(jkg, "kernel_fwd_ref_bwd", lambda kern, ref: recorded.append(kern) or ref)
    inner = 2 * dim_head

    def spy(name, out_shape):
        def f(q, *a, **k):
            fired.append(name)
            return jnp.zeros(out_shape(q), q.dtype)
        return f

    monkeypatch.setattr(jlq, "ln_qkv", lambda x, *a, **k: (
        jnp.zeros((x.shape[0], inner), x.dtype), jnp.zeros((x.shape[0], 2 * inner), x.dtype)))
    for mod, name in ((jsa, "small_n_attention"), (jsa, "small_n_attention_flat"),
                      (jcm, "cosine_mha")):
        monkeypatch.setattr(mod, name, spy(name, lambda q: q.shape))

    x = jnp.ones((2, n, dim), jnp.bfloat16)
    flat = not is_spatial and n <= 8
    xin = x.reshape(-1, dim) if flat else x
    m.apply(variables, xin, is_spatial=is_spatial, training=True,
            n_frames=n if flat else None)
    if not recorded:
        return None
    p = variables["params"]
    recorded[0](xin, p["norm_gamma"], p["to_q_kernel"], p["to_kv_kernel"], p["q_scale"],
                p["k_scale"])
    return {"small_n_attention": "small", "small_n_attention_flat": "small",
            "cosine_mha": "cosine"}[fired[-1]]


@pytest.mark.parametrize("n", [5, 8, 16])
@pytest.mark.parametrize("is_spatial", [True, False], ids=["spatial", "temporal"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("pos", ["rope", "rel"])
def test_training_route_matches_jax(monkeypatch, n, is_spatial, causal, pos):
    m = tattn.Attention(128, 64, 2, causal=causal, spatial_pos=pos, dtype=torch.bfloat16,
                        spatial=is_spatial)
    for raw in ("attn,ff,flat", "attn", "flat", "ff"):
        monkeypatch.setenv("OMNITOK_TRAIN_KERNEL_FWD", raw)
        with monkeypatch.context() as mp:
            want = _jax_route(mp, n, is_spatial, causal, pos)
        assert m.train_route(n, is_spatial) == want, raw
    f32 = tattn.Attention(128, 64, 2, causal=causal, spatial_pos=pos, spatial=is_spatial)
    assert f32.train_route(n, is_spatial) is None


def test_feed_forward_route_matches_jax(monkeypatch):
    for dim in (64, 128, 192, 256):
        for raw in ("attn,ff,flat", "attn,flat"):
            monkeypatch.setenv("OMNITOK_TRAIN_KERNEL_FWD", raw)
            jax_takes = (jgf.geglu_ff_supported(jnp.bfloat16, dim, backend_check=False)
                         and "ff" in jkg.train_kernel_fwd_ops())
            calls = []
            monkeypatch.setattr(tattn, "kernel_fwd_ref_bwd",
                                lambda *a: calls.append(1) or tkg.kernel_fwd_ref_bwd(*a))
            tattn.FeedForward(dim, dtype=torch.bfloat16)(torch.zeros(2, 3, dim, dtype=torch.bfloat16),
                                                          training=True)
            # the port takes every width the JAX gate takes (D % 128), and
            # D % 64 as its inference gate does
            assert bool(calls) == ("ff" in jkg.train_kernel_fwd_ops() and dim % 64 == 0)
            assert not jax_takes or calls


def _inputs(module, shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(*shape, generator=g)).to(torch.bfloat16).requires_grad_()
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return x


ROUTES = [  # (route, causal, rope, spatial, n)
    ("small", True, False, False, 5),     # the flat temporal route
    ("small", False, False, True, 8),     # spatial 'rel' at N = 8
    ("cosine", False, True, True, 16),    # spatial RoPE
]


@pytest.mark.parametrize("route,causal,rope,spatial,n", ROUTES)
def test_attention_function_grads_equal_plain(route, causal, rope, spatial, n):
    m = tattn.Attention(64, 32, 2, causal=causal, spatial_pos="rope" if rope else "rel",
                        dtype=torch.bfloat16, spatial=spatial)
    assert m.train_route(n, spatial) == route
    x = _inputs(m, (3, n, 64), 1)
    args = (x, m.norm_gamma, m.to_q.weight, m.to_kv.weight, m.q_scale, m.k_scale)
    ref = functools.partial(tattn.attention_ref_math, dtype=torch.bfloat16, heads=2,
                            dim_head=32, scale=8.0, causal=causal, use_rope=rope)
    out = tkg.kernel_fwd_ref_bwd(functools.partial(m._train_kernel, route, rope), ref, *args)
    want = ref(*args)
    assert out.grad_fn is not None and out.dtype == want.dtype == torch.bfloat16
    # the primal is the kernels' plain twins: bf16 rounding apart from the math
    assert float((out.float() - want.float()).abs().max()) <= 2e-2 * float(want.float().abs().max())
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(out.dtype)
    got = torch.autograd.grad(out, args, g)
    exp = torch.autograd.grad(want, args, g)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)


def test_feed_forward_function_grads_equal_plain():
    m = tattn.FeedForward(64, dtype=torch.bfloat16)
    x = _inputs(m, (24, 64), 3)
    args = (x, *m._params())
    ref = functools.partial(tattn.feed_forward_ref_math, dtype=torch.bfloat16)
    out = tkg.kernel_fwd_ref_bwd(m._train_kernel, ref, *args)
    want = ref(*args)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)).to(out.dtype)
    for a, b in zip(torch.autograd.grad(out, args, g), torch.autograd.grad(want, args, g)):
        assert torch.equal(a, b)
    # an input that needs no gradient gets none
    w = m.proj_in.weight.detach()
    out = tkg.kernel_fwd_ref_bwd(m._train_kernel, ref, x, m.norm_weight, m.norm_bias, w,
                                 m.proj_out.weight)
    gx, = torch.autograd.grad(out.float().sum(), [x])
    assert gx.shape == x.shape


def test_bf16_step_on_cpu_takes_the_training_route(monkeypatch):
    monkeypatch.delenv("OMNITOK_TRAIN_KERNEL_FWD", raising=False)
    routes = []
    real = tattn.kernel_fwd_ref_bwd

    def spy(kern, ref, *args):
        routes.append(kern.args[0] if isinstance(kern, functools.partial) else "ff")
        return real(kern, ref, *args)

    monkeypatch.setattr(tattn, "kernel_fwd_ref_bwd", spy)
    cfg = TokenizerConfig(**SMALL, dtype=torch.bfloat16)
    trainer = TokenizerTrainer(cfg, LossConfig(perceptual_weight=1.0, image_gan_weight=1.0,
                                               disc_layers=2, disc_channels=16),
                               TrainConfig(warmup_lr_init=1e-5), device="cpu")
    state = trainer.init_state(0)
    video = torch.randn(2, 5, 32, 32, 3, generator=torch.Generator().manual_seed(5)) * 0.2
    reset_launch_counts()
    state, metrics = trainer.train_step(state, video)
    assert all(v == 0 for v in launch_counts().values())
    assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
    # SMALL: spatial 't' blocks take cosine (16 RoPE tokens), enc 1 + dec 2;
    # temporal blocks (3 latent frames) the flat small-group route, 2 + 2;
    # every block's feed-forward, 8
    assert sorted(routes) == sorted(["cosine"] * 3 + ["small"] * 4 + ["ff"] * 8)
    assert state.step == 1 and int(state.net.codebook.call_cnt) == 2


def test_kernel_wrappers_refuse_grad_requiring_inputs():
    x = torch.randn(3, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        _build.refuse_grad("ln_qkv", x)
    with torch.no_grad():
        _build.refuse_grad("ln_qkv", x)
    _build.refuse_grad("ln_qkv", x.detach())
    # the Function's forward runs with grad mode off
    seen = []
    tkg.kernel_fwd_ref_bwd(lambda t: seen.append(torch.is_grad_enabled()) or t * 2,
                           lambda t: t * 2, x)
    assert seen == [False]
