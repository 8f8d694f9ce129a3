"""The port's sequence parallelism of the tokenizer (parallel/tp.py: pixel
rows over a model group) through the configurations the JAX package's SP
runs beside the flagship's, on the CPU over gloo: the einsum biases, pool
blocks, the deferred pools, the cnn patch embed, windows that straddle
ranks, a grid of at most 8 tokens, flat encodings and up blocks; and
ragged rows (the row partition, parallel/tp.py): ranks whose pixel rows
are part of a patch, odd token rows at a pool, windows over ranks of
unequal rows, and ranks that hold no rows.

Worlds of 2, 4 and 8 ranks run tests/torch_parallel_worker.py's
"sp_variants" / "sp_variants4" / "sp_variants8" suites once each, while this process
computes the JAX references: `net.apply` of the JAX package on the same
weights (`convert.state_dict_to_jax` of random port weights, seed 0) with
the pixels placed by `sp_pixel_spec()` over as many host devices as the
world has ranks, as tests/test_tp.py places them, compiled at XLA's
backend optimization level 0. The loss is tests/test_tp.py's (L1
reconstruction + commitment, training=False); where a pool block leaves
the decoder a smaller grid than the pixels, the mean |reconstruction|
stands for the L1 term. Bars, tests/test_tp.py's: pixels rtol 1e-4 / atol
1e-5, indices exact, the loss rtol 1e-5, gradients rtol 5e-4 / atol 1e-5.

Every f32 case holds the SP run of each rank against the JAX SP forward
and against the port's one process (gradients too); the straddling
windows also hold the SP gradient against `jax.value_and_grad` under the
same placement. `up_n` runs where the JAX decoder cannot (an up block),
and `ragged_vae` samples its posterior from a seeded generator (the
rank's rows of one draw for the whole grid): against the port's one
process only. The bf16 cases run the kernels' plain versions on the CPU:
a rank calls each kernel wrapper as often as one process does (spies on
ops/attention.py and ops/codebook.py), and its round trip equals one
process's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from omnitokenizer_tpu.config import TokenizerConfig as JaxConfig
from omnitokenizer_tpu.models.tokenizer import OmniTokenizerNet as JaxNet
from omnitokenizer_tpu.parallel import tp as jtp
from omnitokenizer_tpu_torch.config import TokenizerConfig
from omnitokenizer_tpu_torch.convert import params_from_jax, state_dict_to_jax
from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet, init_weights

from torch_port_util import check_result, start_world

torch.set_num_threads(2)

# tests/test_tp.py's SP config
TEST_TP = dict(embedding_dim=16, n_codes=32, codebook_dim=4, resolution=16, sequence_length=3,
               patch_size=4, temporal_patch_size=2, enc_block="t", dec_block="t",
               spatial_depth=1, temporal_depth=1, dim_head=8, heads=2, spatial_pos="rope")
POOL = dict(TEST_TP, resolution=32, enc_block="ta", spatial_depth=2)  # 4 token rows a rank
# the bf16 cases' widths: those the kernel gates take (D % 64, heads of 32)
BF16 = dict(TEST_TP, embedding_dim=64, dim_head=32)
RAGGED = dict(TEST_TP, resolution=20)
WINDOWS = dict(TEST_TP, enc_block="tw", dec_block="tw", spatial_depth=2, twod_window_size=4)
# name: (config, ranks, batch, options); 'jax': held to the JAX SP forward,
# 'grad': its gradient too, 'flat': the flat indices' decode, 'bf16' with the
# kernel wrappers that its round trip must call
CASES = {
    "einsum_rel": (dict(TEST_TP, attn_bias_mode="einsum", spatial_pos="rel"), 2, 2, "jax"),
    "einsum_rope": (dict(TEST_TP, attn_bias_mode="einsum"), 2, 2, "jax"),
    "pool_a": (POOL, 2, 2, "jax"),
    "pool_m": (dict(POOL, enc_block="tm"), 2, 2, "jax"),
    "pool_l": (dict(POOL, enc_block="tl"), 2, 2, "jax"),
    # half patches: 4 token rows a rank at 32^2, 2 x 2 pooled after the temporal stack
    "defer": (dict(TEST_TP, resolution=32, sequence_length=5, defer_spatial_pool=True,
                   defer_temporal_pool=True), 2, 2, "jax"),
    "cnn_batch": (dict(TEST_TP, patch_embed="cnn"), 2, 2, "jax"),
    # GroupNorm's 32 groups need 32 channels: the embedding's and the pixels'
    "cnn_group": (dict(TEST_TP, patch_embed="cnn", norm_type="group", embedding_dim=32,
                       image_channels=32), 2, 2, "jax"),
    # 6 token rows a rank, windows of 4: rows 4-7 straddle the ranks
    "window": (dict(TEST_TP, resolution=48, enc_block="tw", dec_block="tw", spatial_depth=2,
                    twod_window_size=4), 2, 2, "jax grad"),
    # a 2 x 2 grid: one token row a rank
    "small_rel": (dict(TEST_TP, resolution=8, spatial_pos="rel"), 2, 2, "jax"),
    "flat": (TEST_TP, 2, 2, "jax flat"),
    "up_n": (dict(POOL, dec_block="nt"), 2, 2, ""),
    # 2 token rows a rank, windows of 4: each window spans two ranks
    "window4": (dict(TEST_TP, resolution=32, enc_block="tw", dec_block="tw", spatial_depth=2,
                     twod_window_size=4), 4, 2, "jax"),
    # the small grid's spatial calls on small_n_attention, as the temporal ones
    "bf16_small_rel": (dict(BF16, resolution=8, spatial_pos="rel"), 2, 2,
                       "bf16 ln_qkv geglu_ff small_n_attention"),
    "bf16_pool": (dict(BF16, resolution=64, enc_block="ttaw", dec_block="nttt", spatial_depth=4,
                       twod_window_size=4), 2, 1,
                  "bf16 ln_qkv geglu_ff small_n_attention cosine_mha"),
    # biased calls: the projections' kernel, then the plain math
    "bf16_einsum_rel": (dict(BF16, attn_bias_mode="einsum", spatial_pos="rel"), 2, 2,
                        "bf16 ln_qkv geglu_ff"),
    # ragged rows. 20^2: 5 token rows split 3 / 2, so a rank's 10 pixel rows are 2.5
    # patches; the flat indices' decode too
    "ragged_20": (RAGGED, 2, 2, "jax grad flat"),
    "ragged_20_4": (RAGGED, 4, 2, "jax"),  # 5 token rows over 4 ranks: 2, 1, 1, 1
    "ragged_pool_a": (dict(POOL, resolution=40), 2, 2, "jax"),  # 5 token rows a rank at the pool
    "ragged_pool_l": (dict(POOL, resolution=24, enc_block="tl"), 2, 2, "jax"),  # 3 a rank
    # 3 latent rows a rank after the deferred pool
    "ragged_defer": (dict(TEST_TP, resolution=24, sequence_length=5, defer_spatial_pool=True,
                          defer_temporal_pool=True), 2, 2, "jax"),
    "ragged_einsum_rel": (dict(RAGGED, attn_bias_mode="einsum", spatial_pos="rel"), 2, 2, "jax"),
    "ragged_cnn": (dict(RAGGED, patch_embed="cnn"), 2, 2, "jax"),
    # 6 token rows over 4 ranks (2, 2, 1, 1), windows of 2: rows 4-5 straddle ranks 2 and 3
    "ragged_window2": (dict(WINDOWS, resolution=24, twod_window_size=2), 4, 2, "jax grad"),
    # 12 token rows over 8 ranks (2 x 4, 1 x 4), windows of 4: rows 8-11 span 4 ranks
    "ragged_window4_48": (dict(WINDOWS, resolution=48), 8, 2, "jax"),
    # ranks that hold no rows: 2 token rows over 4 ranks, 1 over 2
    "empty_rel8": (dict(TEST_TP, resolution=8, spatial_pos="rel"), 4, 2, "jax"),
    "empty_rel4": (dict(TEST_TP, resolution=4, spatial_pos="rel"), 2, 2, "jax"),
    "ragged_vae": (dict(RAGGED, use_vae=True), 2, 2, "noise"),
    # 5 x 5 token grids: cosine_mha's query blocks of 15 and 10 of 25 tokens
    "ragged_bf16": (dict(BF16, resolution=20), 2, 1,
                    "bf16 ln_qkv geglu_ff small_n_attention cosine_mha"),
}


def _pixels(kw, batch):
    c = kw.get("image_channels", 3)
    return (np.random.RandomState(1).randn(batch, kw["sequence_length"], kw["resolution"],
                                           kw["resolution"], c) * 0.2).astype(np.float32)


def _port_net(kw):
    net = OmniTokenizerNet(TokenizerConfig(**kw))
    init_weights(net, torch.Generator().manual_seed(0))
    return net


def _compile(fn, *args):
    """fn jitted and compiled at XLA's backend optimization level 0."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _jax_sp(kw, x, tnet, ranks, grads, flat):
    """The JAX package's forward with the pixels under sp_pixel_spec() over
    `ranks` host devices: loss, reconstruction and indices, with `grads`
    the loss's gradient on the port's names, with `flat` the decode of the
    flat indices."""
    net = JaxNet(JaxConfig(**kw))
    variables = state_dict_to_jax(tnet)
    mesh = jtp.tp_mesh(ranks, jax.devices()[:ranks])
    x_sp = jax.device_put(jnp.asarray(x), NamedSharding(mesh, jtp.sp_pixel_spec()))
    params = jax.device_put(variables["params"], NamedSharding(mesh, P()))

    def loss(p, xin):
        recon, aux = net.apply({**variables, "params": p}, xin, False)
        diff = recon - xin if recon.shape == xin.shape else recon
        return jnp.mean(jnp.abs(diff)) + aux["commitment_loss"], (recon, aux["encodings"])

    if grads:
        (value, (recon, enc)), g = _compile(jax.value_and_grad(loss, has_aux=True), params, x_sp)
    else:
        value, (recon, enc) = _compile(loss, params, x_sp)
    ref = {"loss": float(value), "recon": np.asarray(recon), "encodings": np.asarray(enc)}
    if grads:
        ref["grads"] = {k: v.numpy() for k, v in
                        params_from_jax(jax.tree_util.tree_map(np.asarray, g), tnet).items()}
    if flat:
        idx = jnp.asarray(ref["encodings"].reshape(x.shape[0], -1))
        ref["flat_recon"] = np.asarray(_compile(
            lambda v, i: net.apply(v, i, False, method=net.decode), variables, idx))
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both worlds run while this process computes the JAX references."""
    root = tmp_path_factory.mktemp("spv")
    specs, nets = {}, {}
    for name, (kw, ranks, batch, opts) in CASES.items():
        specs[name] = {"cfg": kw, "ranks": ranks, "x": _pixels(kw, batch),
                       "flat": "flat" in opts, "bf16": "bf16" in opts, "noise": "noise" in opts}
        if "bf16" not in opts:
            nets[name] = _port_net(kw)
            specs[name]["state_dict"] = nets[name].state_dict()
    torch.save(specs, root / "spv.pt")
    finish = {n: start_world(f"sp_variants{'' if n == 2 else n}", n, root) for n in (2, 4, 8)}
    try:
        refs = {name: _jax_sp(kw, specs[name]["x"], nets[name], ranks, "grad" in opts,
                              "flat" in opts)
                for name, (kw, ranks, batch, opts) in CASES.items() if "jax" in opts}
    except BaseException:
        for done in finish.values():
            with contextlib.suppress(Exception):
                done(0)  # stops the ranks
        raise
    return {"refs": refs, **{n: done(300) for n, done in finish.items()}}


SP_PIX = dict(rtol=1e-4, atol=1e-5)  # tests/test_tp.py's SP bars


def _hold(got, want, what):
    np.testing.assert_allclose(got["recon"], want["recon"], err_msg=f"{what} recon", **SP_PIX)
    if "encodings" in want:  # a VQ case
        np.testing.assert_array_equal(got["encodings"], want["encodings"], err_msg=what)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5, err_msg=what)
    if "flat_recon" in want:
        np.testing.assert_allclose(got["flat_recon"], want["flat_recon"],
                                   err_msg=f"{what} flat decode", **SP_PIX)
    if "grads" not in want:
        return
    assert set(got["grads"]) == set(want["grads"]) and want["grads"]
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=5e-4, atol=1e-5,
                                   err_msg=f"{what} grad {k}")


def _ranks(world, case):
    n = CASES[case][1]
    return [check_result(world[n], "spv_cases", r)[case] for r in range(n)]


@pytest.mark.parametrize("case", [c for c, v in CASES.items() if "bf16" not in v[3]])
def test_sp_variant_matches_jax_and_one_process(world, case):
    ranks = _ranks(world, case)
    one, want = ranks[0]["one"], world["refs"].get(case)
    if want is not None:
        _hold(one, want, f"{case}: one process vs JAX")
    for r, res in enumerate(ranks):
        if want is not None:
            _hold(res["sp"], want, f"{case}: SP rank {r} vs JAX")
        _hold(res["sp"], one, f"{case}: SP rank {r} vs one process")
        if "flat_recon" in res["sp"]:  # the flat indices' decode is the grid's
            np.testing.assert_array_equal(res["sp"]["flat_recon"], res["sp"]["grid_recon"])


@pytest.mark.parametrize("case", [c for c, v in CASES.items() if "bf16" in v[3]])
def test_sp_bf16_variant_calls_the_kernels(world, case):
    """A rank's round trip calls each kernel wrapper as one process does,
    and equals its round trip (the same plain math on the CPU, on this
    rank's rows)."""
    ranks = _ranks(world, case)
    one = ranks[0]["one"]
    assert all(one["calls"][k] for k in CASES[case][3].split()[1:]), one["calls"]
    for r, res in enumerate(ranks):
        got = res["sp"]
        assert got["calls"] == one["calls"], (r, got["calls"], one["calls"])
        np.testing.assert_array_equal(got["encodings"], one["encodings"])
        np.testing.assert_allclose(got["recon"], one["recon"], rtol=2e-2, atol=2e-2)


def test_window_spans():
    """The grid rows each rank's windows read (ops/window.py:window_span):
    whole windows around its block, at 2, 4 and 8 ranks; at 8 ranks of
    256^2 (4 token rows a rank, windows of 8) two ranks share each span."""
    from omnitokenizer_tpu_torch.ops.window import window_span

    for ranks, rows, ws in ((2, 6, 4), (4, 2, 4), (8, 4, 8), (2, 20, 8)):
        for r in range(ranks):
            lo, hi = window_span((r * rows, (r + 1) * rows), ws)
            assert lo <= r * rows < (r + 1) * rows <= hi and not lo % ws and not hi % ws
            assert hi - lo < rows + 2 * ws
    assert [window_span((4 * r, 4 * r + 4), 8) for r in range(8)] == [
        (8 * (r // 2), 8 * (r // 2) + 8) for r in range(8)]
    assert [window_span((20 * r, 20 * r + 20), 8) for r in range(2)] == [(0, 24), (16, 40)]
