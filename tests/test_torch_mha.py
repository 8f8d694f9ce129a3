"""The `mha` kernel's plain version against the JAX package's `mha_pallas`
in interpret mode, the TF32 numerics of the kernel's f32 branch emulated in
f32, the port's `sdpa` dispatch, and the two small modules
this slice adds beside it (DiagonalGaussian, ContinuousPositionBias),
each on the same numpy inputs as the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.ops.bias import ContinuousPositionBias as JaxCPB
from omnitokenizer_tpu.ops.gaussian import DiagonalGaussian as JaxGaussian
from omnitokenizer_tpu.ops.pallas.mha import mha_pallas
from omnitokenizer_tpu_torch.convert import state_dict_from_jax
from omnitokenizer_tpu_torch.ops import attention as tattn
from omnitokenizer_tpu_torch.ops.bias import ContinuousPositionBias
from omnitokenizer_tpu_torch.ops.gaussian import DiagonalGaussian
from omnitokenizer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from omnitokenizer_tpu_torch.ops.kernels.mha import mha, mha_plain, mha_supported

from torch_port_util import to_numpy_tree, torch_f32

torch.set_num_threads(1)

REL_TOL = 5e-2  # bf16 inputs, P and outputs, as the other kernel tests hold them


def _qkv(seed, N, D, B=2, H=2):
    """l2-normalized q, k (the cosine attention's inputs) and N(0, 1) v."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, N, D).astype(np.float32) for _ in range(3))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    return q, k, v


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("N", [8, 9, 17, 64])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_plain_matches_pallas(dtype, causal, N, D):
    q, k, v = _qkv(N * D, N, D)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = np.asarray(mha_pallas(jq, jk, jv, 8.0, causal, interpret=True).astype(jnp.float32))
    # the same (rounded) values on the torch side
    tq, tk, tv = (torch_f32(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jq, jk, jv))
    got = mha_plain(tq, tk, tv, 8.0, causal)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 does."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b on TF32 operands in f32: one pass, or three with error
    compensation (x = hi + lo; lo*hi + hi*lo + hi*hi, the small terms first)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _flash_tf32(q, k, v, scale, passes, tile=64):
    """The f32 kernel's arithmetic: online softmax over 64-key tiles, both
    products on TF32 operands, each tile's P V added to the output in f32."""
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l, o = torch.zeros_like(m), torch.zeros_like(q)
    for k0 in range(0, k.shape[-2], tile):
        s = _mm_tf32(q, k[..., k0:k0 + tile, :].transpose(-1, -2), passes) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mm_tf32(p, v[..., k0:k0 + tile, :], passes)
        m = m_new
    return o / l


def test_mha_f32_needs_three_tf32_passes():
    """The f32 VAE's attention shape (N = 1024, D = 64, scale 8 on l2-normalized
    q, k): three TF32 passes stay within the 1e-5 bar of the plain f32 version
    that the card's kernel is held to; one pass does not."""
    q, k, v = (torch_f32(a) for a in _qkv(7, 1024, 64, B=1, H=2))
    want = mha_plain(q, k, v, 8.0)

    def err(passes):
        got = _flash_tf32(q, k, v, 8.0, passes)
        return float((got - want).abs().max() / want.abs().max())

    assert err(3) <= 1e-5
    assert err(1) > 1e-4


def test_mha_gate():
    assert mha_supported(1024, 64, torch.float32)
    assert mha_supported(9, 64, torch.bfloat16)
    assert mha_supported(8, 8, torch.float32) and mha_supported(2048, 32, torch.float32)
    assert not mha_supported(5, 64, torch.float32)      # below N = 8, as the JAX gate
    assert not mha_supported(2049, 64, torch.float32)   # above the JAX gate's 2048
    assert not mha_supported(64, 24, torch.float32)     # no kernel for D = 24
    assert not mha_supported(64, 64, torch.float16)     # nor for float16


@pytest.mark.parametrize("N", [5, 9, 64], ids=["gate_miss", "small", "flash"])
@pytest.mark.parametrize("training", [False, True], ids=["inference", "training"])
def test_sdpa_takes_plain_math_on_the_cpu(monkeypatch, N, training):
    """A CPU tensor never reaches the kernel wrapper, in the gate or out of
    it, and the result is the plain math's."""
    calls = []
    monkeypatch.setattr(tattn, "mha", lambda *a, **kw: calls.append(a))
    q, k, v = (torch_f32(a) for a in _qkv(N, N, 32))
    reset_launch_counts()
    out = tattn.sdpa(q, k, v, 8.0, causal=True, training=training)
    assert not calls and launch_counts()["mha"] == 0
    torch.testing.assert_close(out, mha_plain(q, k, v, 8.0, True), rtol=0, atol=0)


def test_mha_wrapper_runs_plain_on_the_cpu():
    q, k, v = (torch_f32(a).to(torch.bfloat16) for a in _qkv(3, 9, 64))
    reset_launch_counts()
    torch.testing.assert_close(mha(q, k, v, 8.0, True), mha_plain(q, k, v, 8.0, True),
                               rtol=0, atol=0)
    assert mha.launches == 0


def _gaussian_params(seed=0):
    rng = np.random.RandomState(seed)
    p = rng.randn(2, 3, 4, 4, 16).astype(np.float32)
    p[..., 8:] *= 30.0  # logvar past both clip bounds
    return p, rng.randn(2, 3, 4, 4, 8).astype(np.float32)


def test_diagonal_gaussian_matches_jax():
    params, noise = _gaussian_params()
    jg = JaxGaussian.from_params(jnp.asarray(params))
    tg = DiagonalGaussian.from_params(torch_f32(params))
    sample = tg.sample(noise=torch_f32(noise))
    for name in ("mean", "logvar", "std", "var"):
        np.testing.assert_allclose(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                   atol=1e-5, rtol=1e-6, err_msg=name)
    assert float(tg.logvar.min()) == -30.0 and float(tg.logvar.max()) == 20.0
    np.testing.assert_allclose(tg.kl().numpy(), np.asarray(jg.kl()), rtol=1e-5)
    np.testing.assert_allclose(tg.nll(sample).numpy(), np.asarray(jg.nll(jnp.asarray(sample.numpy()))),
                               rtol=1e-5)
    torch.testing.assert_close(tg.mode(), torch_f32(params[..., :8]))
    torch.testing.assert_close(sample, tg.mean + tg.std * torch_f32(noise), rtol=0, atol=0)


def test_diagonal_gaussian_sample_uses_the_generator():
    params, _ = _gaussian_params(1)
    tg = DiagonalGaussian.from_params(torch_f32(params))
    a = tg.sample(torch.Generator().manual_seed(3))
    b = tg.sample(torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, tg.mean)


def test_continuous_position_bias_matches_jax():
    dim, heads = 32, 4
    jm = JaxCPB(dim=dim, heads=heads)
    variables = jm.init(jax.random.PRNGKey(0), 4, 4)
    tree = to_numpy_tree(variables)
    rng = np.random.RandomState(0)
    tree["params"] = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32), tree["params"])
    want = np.asarray(jm.apply(tree, 4, 4))
    tm = ContinuousPositionBias(dim, heads)
    tm.load_state_dict(state_dict_from_jax(tree, tm))
    with torch.no_grad():
        got = tm(4, 4).numpy()
    assert got.shape == (heads, 16, 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
