"""The port's layers against the JAX package's flax modules in f32, on the
same weights through convert.state_dict_from_jax and the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.ops import attention as jattn
from omnitokenizer_tpu.ops import norms as jnorms
from omnitokenizer_tpu.ops import peg as jpeg
from omnitokenizer_tpu.ops import transformer as jtrans
from omnitokenizer_tpu.ops import window as jwindow
from omnitokenizer_tpu_torch.convert import state_dict_from_jax
from omnitokenizer_tpu_torch.ops import attention as tattn
from omnitokenizer_tpu_torch.ops import norms as tnorms
from omnitokenizer_tpu_torch.ops import peg as tpeg
from omnitokenizer_tpu_torch.ops import transformer as ttrans
from omnitokenizer_tpu_torch.ops import window as twindow

from torch_port_util import to_numpy_tree

torch.set_num_threads(1)

ATOL = 1e-5
D, HEADS, DIM_HEAD = 64, 2, 32


def bridged(jax_module, torch_module, *args, seed=0, **kwargs):
    """Init the flax module, perturb every parameter so no default ones or
    zeros hide a fault, and load the same values into the torch module."""
    variables = jax_module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    rng = np.random.RandomState(seed)
    tree = to_numpy_tree(variables)

    def perturb(t):
        if isinstance(t, dict):
            return {k: perturb(v) for k, v in t.items()}
        return (t + 0.1 * rng.randn(*t.shape)).astype(np.float32)

    tree["params"] = perturb(tree["params"])
    torch_module.load_state_dict(state_dict_from_jax(tree, torch_module))
    return tree


def run_both(jax_module, torch_module, x, jax_args=(), torch_args=(), seed=0):
    tree = bridged(jax_module, torch_module, jnp.asarray(x), *jax_args, seed=seed)
    want = np.asarray(jax_module.apply(tree, jnp.asarray(x), *jax_args))
    with torch.no_grad():
        got = torch_module(torch.from_numpy(x), *torch_args).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def inputs(*shape, seed=0):
    return np.random.RandomState(seed + 100).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["gamma", "affine"])
def test_layer_norms(kind):
    if kind == "gamma":
        run_both(jnorms.LayerNormGamma(D), tnorms.LayerNormGamma(D), inputs(3, 7, D))
    else:
        run_both(jnorms.LayerNorm(D), tnorms.LayerNorm(D), inputs(3, 7, D))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", ["spatial", "temporal"])
def test_peg(causal, layout):
    video_shape = (2, 3, 4, 4)  # (B, T, H, W)
    # the temporal layout (b h w, t, d) is reshaped to video_shape as it is
    shape = (6, 16, D) if layout == "spatial" else (32, 3, D)
    x = inputs(*shape, seed=1)
    run_both(jpeg.PEG(D, causal=causal), tpeg.PEG(D, causal=causal), x,
             jax_args=(video_shape, True), torch_args=(video_shape, True))


# the rel path's 9 latent frames (mha's small-branch shape) and a ragged
# 12 x 12 grid (cosine_mha's partial last key tile on the card)
@pytest.mark.parametrize("kind", ["spatial_rope", "temporal_causal", "temporal_causal_9",
                                  "spatial_rope_144"])
def test_attention(kind):
    if kind.startswith("spatial_rope"):
        n = 144 if kind.endswith("144") else 16
        kw, x, is_spatial = dict(spatial_pos="rope", causal=False), inputs(3, n, D, seed=2), True
    else:
        n = 9 if kind.endswith("9") else 5
        kw, x, is_spatial = dict(spatial_pos="rel", causal=True), inputs(8, n, D, seed=2), False
    run_both(jattn.Attention(D, dim_head=DIM_HEAD, heads=HEADS, **kw),
             tattn.Attention(D, dim_head=DIM_HEAD, heads=HEADS, **kw), x,
             jax_args=(is_spatial,), torch_args=(is_spatial,))


def test_feed_forward():
    run_both(jattn.FeedForward(D), tattn.FeedForward(D), inputs(4, 9, D, seed=3))


def test_window_attention():
    run_both(jwindow.WindowAttention(D, window_size=2, num_heads=HEADS),
             twindow.WindowAttention(D, window_size=2, num_heads=HEADS),
             inputs(3, 16, D, seed=4))


@pytest.mark.parametrize("kind", ["spatial_tw", "temporal_tt"])
def test_transformer(kind):
    video_shape = (2, 3, 4, 4)
    if kind == "spatial_tw":
        kw = dict(block="tw", depth=2, causal=False, spatial_pos="rope", window_size=2)
        x, is_spatial = inputs(6, 16, D, seed=5), True
    else:
        kw = dict(block="tt", depth=2, causal=True, spatial_pos="rel")
        x, is_spatial = inputs(32, 3, D, seed=5), False
    run_both(jtrans.Transformer(dim=D, dim_head=DIM_HEAD, heads=HEADS, **kw),
             ttrans.Transformer(dim=D, dim_head=DIM_HEAD, heads=HEADS, **kw), x,
             jax_args=(video_shape, is_spatial), torch_args=(video_shape, is_spatial))


def test_rope_tables_first_built_in_inference_mode_serve_autograd():
    """The cached RoPE tables outlive the call that builds them: built first
    under inference_mode, they must still serve a later call that autograd
    records."""
    from omnitokenizer_tpu_torch.ops.rotary import apply_rotary_emb_2d, freqs_cis_2d

    freqs_cis_2d.cache_clear()
    q = torch.from_numpy(inputs(2, 16, HEADS, DIM_HEAD, seed=5))
    with torch.inference_mode():
        apply_rotary_emb_2d(q, q)
    q.requires_grad_(True)
    qr, kr = apply_rotary_emb_2d(q, q)
    (qr.square().sum() + kr.sum()).backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


WIDE_DIM, WIDE_DIM_HEAD = 256, 128
# relative to the largest output: the perturbed weights put outputs near 10
F32_REL_TOL = 1e-5   # f32, another summation order over 256-wide sums
BF16_REL_TOL = 5e-2  # bf16 products and roundings at other places in the two packages


def run_both_dtype(jax_module, torch_module, x, dtype, jax_args=(), torch_args=()):
    """Both modules on the same weights and inputs; in bf16 the torch module
    cast and its kernels' weights built as the wrapper's serving step does."""
    bf16 = dtype == "bfloat16"
    if bf16:
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    tree = bridged(jax_module, torch_module, jnp.asarray(x), *jax_args)
    want = np.asarray(jax_module.apply(tree, jnp.asarray(x, jax_module.dtype), *jax_args)
                      .astype(jnp.float32))
    if bf16:
        with torch.no_grad():
            for p in torch_module.parameters():
                p.data = p.data.to(torch.bfloat16)
        torch_module.prepare_kernels()
    with torch.no_grad():
        got = torch_module(torch.from_numpy(x).to(getattr(torch, dtype)), *torch_args)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= (BF16_REL_TOL if bf16 else F32_REL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["spatial_rope", "temporal_causal"])
def test_attention_wide_head(kind, dtype):
    """dim 256 with 2 heads of 128: in bf16 ln_qkv, then cosine_mha (a 4x4
    grid) or small_n_attention (5 frames), at the head width the port's
    kernels took last."""
    spatial = kind == "spatial_rope"
    kw = dict(spatial_pos="rope" if spatial else "rel", causal=not spatial)
    x = inputs(3, 16 if spatial else 5, WIDE_DIM, seed=6)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    run_both_dtype(
        jattn.Attention(WIDE_DIM, dim_head=WIDE_DIM_HEAD, heads=2, dtype=jdt, **kw),
        tattn.Attention(WIDE_DIM, dim_head=WIDE_DIM_HEAD, heads=2, dtype=getattr(torch, dtype),
                        **kw),
        x, dtype, jax_args=(spatial,), torch_args=(spatial,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feed_forward_wide(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    run_both_dtype(jattn.FeedForward(WIDE_DIM, dtype=jdt),
                   tattn.FeedForward(WIDE_DIM, dtype=getattr(torch, dtype)),
                   inputs(4, 9, WIDE_DIM, seed=7), dtype)
