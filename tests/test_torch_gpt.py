"""The port's GPT and its samplers against the JAX package's, in f32 on the
CPU at tests/test_gpt.py's size (vocab 50, block 24, 2 layers, 2 heads,
width 32), with the same random weights through
convert.gpt_state_dict_from_jax: full-forward logits within 1e-5, the
vtokens crop-box forward, the cached forward (prefill and decode, a write
slot apart from the position, a key mask, a kv window) and its cache within
1e-5, top-k/top-p filtering equal with ties, the decode segments equal,
greedy tokens equal for the three samplers with and without buckets,
top_k=1 sampling equal to greedy, and seeded sampling that follows the
filtered softmax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.models import gpt as jgpt
from omnitokenizer_tpu_torch.models import gpt as tgpt

from torch_port_util import gpt_pair

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
VT = dict(vtokens_seq_len=2, vtokens_res=4, vtokens_crop=3)


@pytest.fixture(scope="module")
def pair():
    return gpt_pair(0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def test_full_forward_matches_jax(pair):
    jcfg, params, _, gpt = pair
    idx = np.random.RandomState(1).randint(0, 50, (2, 24))
    want, _ = jgpt.GPT(jcfg).apply({"params": params}, jnp.asarray(idx))
    with torch.no_grad():
        got, cache = gpt(_t(idx))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vtokens_forward_matches_jax():
    """The crop-box table: the full forward and a cached decode, one box
    past the table's edge (its start clamped as dynamic_slice clamps)."""
    jcfg, params, tcfg, gpt = gpt_pair(3, vtokens=VT, vtokens_pos=True)
    jm = jgpt.GPT(jcfg, **VT)
    idx = np.random.RandomState(2).randint(0, 50, (2, 12))
    cbox = np.array([[0, 3, 1, 4], [3, 6, 2, 5]])
    want, _ = jm.apply({"params": params}, jnp.asarray(idx), cbox=jnp.asarray(cbox))
    with torch.no_grad():
        got, _ = gpt(_t(idx), cbox=_t(cbox))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    caches_j = jgpt.init_cache(jcfg, 2)
    caches_t = tgpt.init_cache(tcfg, 2, "cpu")
    with torch.no_grad():
        for a, b in [(0, 5)] + [(t, t + 1) for t in range(5, 12)]:
            lj, caches_j = jm.apply({"params": params}, jnp.asarray(idx[:, a:b]), caches_j,
                                    a, cbox=jnp.asarray(cbox))
            lt, _ = gpt(_t(idx[:, a:b]), caches_t, torch.tensor([a]), cbox=_t(cbox))
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("slot_shift,key_mask,window", [
    (0, False, None), (0, False, 16), (-1, True, None), (-1, True, 16)],
    ids=["plain", "window", "slot-keymask", "slot-keymask-window"])
def test_cached_forward_matches_jax(pair, slot_shift, key_mask, window):
    """Prefill 4 tokens, then decode one at a time at positions 4.. with the
    write slot `slot_shift` away (the CFG uncond rows' dense past), a random
    key mask (slot 0 always visible), and an attention window."""
    jcfg, params, tcfg, gpt = pair
    jm = jgpt.GPT(jcfg)
    rng = np.random.RandomState(4)
    idx = rng.randint(0, 50, (2, 12))
    km = rng.rand(2, 24) > 0.3
    km[:, 0] = True
    kw = dict(key_mask=jnp.asarray(km)) if key_mask else {}
    kt = dict(key_mask=_t(km)) if key_mask else {}
    caches_j = jgpt.init_cache(jcfg, 2)
    caches_t = tgpt.init_cache(tcfg, 2, "cpu")
    lj, caches_j = jm.apply({"params": params}, jnp.asarray(idx[:, :4]), caches_j, 0, **kw)
    with torch.no_grad():
        lt, _ = gpt(_t(idx[:, :4]), caches_t, 0, **kt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for t in range(4, 12):
        slot = t + slot_shift
        lj, caches_j = jm.apply({"params": params}, jnp.asarray(idx[:, t:t + 1]), caches_j, t,
                                slot=slot, kv_window=window, **kw)
        with torch.no_grad():
            lt, _ = gpt(_t(idx[:, t:t + 1]), caches_t, torch.tensor([t]),
                        slot=torch.tensor([slot]), kv_window=window, **kt)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for (kj, vj), (kt_, vt_) in zip(caches_j, caches_t):
        np.testing.assert_allclose(kt_.numpy(), np.asarray(kj), **TOL)
        np.testing.assert_allclose(vt_.numpy(), np.asarray(vj), **TOL)


@pytest.mark.parametrize("top_k,top_p", [(1, 1.0), (3, 1.0), (7, 1.0), (0, 0.37), (0, 0.83),
                                         (5, 0.61), (0, 1.0)])
def test_filtering_matches_jax_with_ties(top_k, top_p):
    """Logits on a coarse grid, so that many tie (with the k-th logit too)."""
    logits = np.random.RandomState(5).randint(-8, 8, (6, 40)).astype(np.float32) / 4
    want = np.asarray(jgpt.top_k_top_p_filtering(jnp.asarray(logits), top_k=top_k, top_p=top_p))
    got = tgpt.top_k_top_p_filtering(_t(logits), top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(got, want)
    kept = (got > tgpt.NEG_INF / 2).sum(axis=1)
    assert (kept >= 1).all() and (top_p < 1.0 or (kept >= top_k).all())


def test_decode_segments_match_jax():
    for first, n, block, bucket in [(2, 1023, 1025, 256), (2, 1023, 1025, 128),
                                    (2049, 3071, 5120, 512), (3, 7, 24, 2), (2, 0, 24, 4),
                                    (2, 9, 24, None), (1, 30, 5121, 1024)]:
        assert tgpt._decode_segments(first, n, block, bucket) == [
            tuple(s) for s in jgpt._decode_segments(first, n, block, bucket)]


def _greedy(jfn, tfn, params, gpt, arg):
    want = np.asarray(jfn(params, jnp.asarray(arg), jax.random.PRNGKey(0)))
    got = tfn(gpt, _t(arg)).numpy()
    return got, want


@pytest.mark.parametrize("bucket", [None, 3], ids=["one-window", "bucket3"])
def test_sampler_greedy_matches_jax(pair, bucket):
    jcfg, params, tcfg, gpt = pair
    cond = np.random.RandomState(6).randint(0, 50, (2, 3))
    got, want = _greedy(jgpt.make_sampler(jcfg, 12, greedy=True, bucket=bucket),
                        tgpt.make_sampler(tcfg, 12, greedy=True, bucket=bucket),
                        params, gpt, cond)
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("class_first,scale_cfg,bucket", [
    (False, False, None), (True, False, 3), (False, True, 5), (True, True, None)])
def test_cfg_sampler_greedy_matches_jax(pair, class_first, scale_cfg, bucket):
    jcfg, params, tcfg, gpt = pair
    kw = dict(greedy=True, cfg_ratio=1.5, class_first=class_first, scale_cfg=scale_cfg,
              bucket=bucket)
    cls = np.array([[3], [7], [40]])
    got, want = _greedy(jgpt.make_cfg_sampler(jcfg, 14, **kw),
                        tgpt.make_cfg_sampler(tcfg, 14, **kw), params, gpt, cls)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("class_first,bucket", [(False, None), (True, 4)])
def test_hardcfg_sampler_greedy_matches_jax(pair, class_first, bucket):
    jcfg, params, tcfg, gpt = pair
    kw = dict(greedy=True, cfg_ratio=0.5, class_first=class_first, bucket=bucket)
    cls = np.array([[3], [7]])
    got, want = _greedy(jgpt.make_hardcfg_sampler(jcfg, 14, **kw),
                        tgpt.make_hardcfg_sampler(tcfg, 14, **kw), params, gpt, cls)
    np.testing.assert_array_equal(got, want)


def test_top_k_one_sampling_is_greedy(pair):
    """top_k=1 leaves one logit, so Gumbel noise cannot move the draw."""
    jcfg, params, tcfg, gpt = pair
    cond = np.random.RandomState(7).randint(0, 50, (2, 2))
    want = np.asarray(jgpt.make_sampler(jcfg, 10, greedy=True, bucket=4)(
        params, jnp.asarray(cond), jax.random.PRNGKey(0)))
    for seed in (0, 1):
        got = tgpt.make_sampler(tcfg, 10, top_k=1, bucket=4)(
            gpt, _t(cond), torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(got.numpy(), want)
    got = tgpt.make_cfg_sampler(tcfg, 10, top_k=1)(gpt, _t(cond[:, :1]),
                                                   torch.Generator().manual_seed(0))
    want = tgpt.make_cfg_sampler(tcfg, 10, greedy=True)(gpt, _t(cond[:, :1]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sampling_follows_filtered_softmax():
    """40000 Gumbel-max draws from one row of logits: each token's frequency
    within 0.012 (about 5 standard deviations) of the filtered softmax, and
    no token outside the top-k / nucleus drawn."""
    n = 40000
    logits = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, 3.0])
    gen = torch.Generator().manual_seed(0)
    for top_k, top_p in [(0, 1.0), (5, 1.0), (0, 0.8), (6, 0.9)]:
        rows = logits.expand(n, -1)
        noise = tgpt.gumbel_(torch.empty(n, 8), gen)
        toks = tgpt._sample_token(rows, 1.0, top_k, top_p, False, noise)
        freq = torch.bincount(toks, minlength=8).double() / n
        want = torch.softmax(tgpt.top_k_top_p_filtering(logits[None], top_k, top_p)[0].double(), 0)
        assert float((freq - want).abs().max()) < 0.012, (top_k, top_p, freq, want)
        assert bool((freq[want == 0] == 0).all())


def test_seeded_sampler_repeats_and_seeds_differ(pair):
    _, _, tcfg, gpt = pair
    cond = _t(np.random.RandomState(8).randint(0, 50, (2, 2)))
    sample = tgpt.make_sampler(tcfg, 16, top_k=20, top_p=0.95, bucket=4)
    a = sample(gpt, cond, torch.Generator().manual_seed(3))
    b = sample(gpt, cond, torch.Generator().manual_seed(3))
    c = sample(gpt, cond, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 50


def test_sampler_edges(pair):
    """steps=1 runs no decode step; a prefix + steps past the block raises;
    sampling without the caller's generator raises (no global RNG)."""
    _, _, tcfg, gpt = pair
    out = tgpt.make_sampler(tcfg, 1, greedy=True, bucket=4)(gpt, torch.tensor([[0, 4]]))
    assert out.shape == (1, 1)
    with pytest.raises(ValueError, match="exceeds block_size"):
        tgpt.make_sampler(tcfg, 23, greedy=True)(gpt, torch.tensor([[0, 4, 5]]))
    with pytest.raises(ValueError, match="Generator"):
        tgpt.make_sampler(tcfg, 4, top_k=5)(gpt, torch.tensor([[0, 4]]))
