"""The port's sequence parallelism of the tokenizer (parallel/tp.py: pixel
rows over a model group) on the CPU over gloo, against the JAX package and
against the port's one process, and the plain kernel versions' query
blocks that its spatial attention runs.

One world of 2 ranks runs tests/torch_parallel_worker.py's "sp" suite once.
Each case's weights are random (`init_weights`, seed 0), handed to the JAX
package by `convert.state_dict_to_jax`; the pixels come from numpy seeds.
The JAX test's loss, L1 reconstruction + commitment with training=False:
its forward held against `net.apply` of the JAX package (replicated:
tests/test_tp.py holds the JAX SP run to it) and the port's one process;
its gradient (the ranks' gradients averaged) against the port's one
process in every case, and against `jax.value_and_grad` in the JAX test's
own config ('t'). Bars, those of tests/test_tp.py: the reconstruction
rtol 1e-4 / atol 1e-5, encodings exact, the loss rtol 1e-5, every
gradient rtol 5e-4 / atol 1e-5; the VAE's pixels against the JAX package
atol 2e-5 (JAX_PIX). Cases: the JAX test's config
(enc/dec 't', RoPE, a 4 x 4 grid, T=2 latent frames: the temporal PEG's
2 H W + W + 1 = 37-token reach against a rank's 16-token chunk), the dry
run's 'tw' / 'tt' with windows of 4 on an 8 x 8 grid (a rank's temporal
chunk 1.5 frames), 'rel' positions, the VAE, and the JAX test's config
without the causal pads. Each refusal raises with its reason, and what SP
refused before its row partition runs (the configurations SP took on since are
in tests/test_torch_parallel_sp_variants.py)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.config import TokenizerConfig as JaxConfig
from omnitokenizer_tpu.models.tokenizer import OmniTokenizerNet as JaxNet
from omnitokenizer_tpu.ops.pallas.cosine_mha import cosine_mha as pallas_cosine_mha
from omnitokenizer_tpu.ops.pallas.mha import mha_pallas
from omnitokenizer_tpu_torch.config import TokenizerConfig
from omnitokenizer_tpu_torch.convert import params_from_jax, state_dict_to_jax
from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet, init_weights
from omnitokenizer_tpu_torch.ops.kernels import cosine_mha as cm
from omnitokenizer_tpu_torch.ops.kernels import mha as mh
from omnitokenizer_tpu_torch.parallel import tp

from torch_port_util import check_result, start_world

torch.set_num_threads(2)

# tests/test_tp.py's SP config
TEST_TP = dict(embedding_dim=16, n_codes=32, codebook_dim=4, resolution=16, sequence_length=3,
               patch_size=4, temporal_patch_size=2, enc_block="t", dec_block="t",
               spatial_depth=1, temporal_depth=1, dim_head=8, heads=2, spatial_pos="rope")
# __graft_entry__.py's dry-run config (parallel/dryrun.py's)
DRYRUN = dict(embedding_dim=32, n_codes=64, codebook_dim=8, resolution=32, sequence_length=5,
              patch_size=4, temporal_patch_size=2, enc_block="tw", dec_block="tt",
              spatial_depth=2, temporal_depth=2, twod_window_size=4, dim_head=8, heads=4,
              spatial_pos="rope")
CASES = {"t": (TEST_TP, 4), "tw": (DRYRUN, 2), "rel": (dict(TEST_TP, spatial_pos="rel"), 4),
         "vae": (dict(TEST_TP, use_vae=True), 4),
         "noncausal": (dict(TEST_TP, causal_in_peg=False, causal_in_temporal_transformer=False),
                       4)}


def _port_weights(kw):
    tnet = OmniTokenizerNet(TokenizerConfig(**kw))
    init_weights(tnet, torch.Generator().manual_seed(0))
    return tnet


def _jit(fn, *args):
    """fn jitted and compiled at XLA's backend optimization level 0: the
    same program, compiled in about two thirds of the time (the 't'
    gradient: 25 s against 37 s on an 8-core CPU), sums within 4e-7."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _jax_reference(kw, x, tnet, grads):
    """net.apply's loss, reconstruction and encodings on the port weights
    of `tnet`, and with `grads` the loss's gradient on the port's names."""
    net = JaxNet(JaxConfig(**kw))
    variables = state_dict_to_jax(tnet)

    def loss(params, xin):
        recon, aux = net.apply({**variables, "params": params}, xin, False)
        value = jnp.mean(jnp.abs(recon - xin)) + aux["commitment_loss"]
        return value, (recon, aux.get("encodings", jnp.zeros(())))

    args = (variables["params"], jnp.asarray(x))
    if grads:
        (value, (recon, enc)), g = _jit(jax.value_and_grad(loss, has_aux=True), *args)
    else:
        value, (recon, enc) = _jit(loss, *args)
    ref = {"loss": float(value), "recon": np.asarray(recon)}
    if "use_vae" not in kw:
        ref["encodings"] = np.asarray(enc)
    if grads:
        ref["grads"] = {k: v.numpy() for k, v in
                        params_from_jax(jax.tree_util.tree_map(np.asarray, g), tnet).items()}
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks run while this process computes the JAX references."""
    root = tmp_path_factory.mktemp("sp")
    specs, nets = {}, {}
    for name, (kw, batch) in CASES.items():
        x = (np.random.RandomState(1).randn(batch, kw["sequence_length"], kw["resolution"],
                                            kw["resolution"], 3) * 0.2).astype(np.float32)
        nets[name] = _port_weights(kw)
        specs[name] = {"cfg": kw, "state_dict": nets[name].state_dict(), "x": x}
    torch.save(specs, root / "sp.pt")
    finish = start_world("sp", 2, root)
    try:
        refs = {name: _jax_reference(spec["cfg"], spec["x"], nets[name], name in JAX_GRADS)
                for name, spec in specs.items()}
    except BaseException:
        with contextlib.suppress(Exception):
            finish(0)  # stops the ranks
        raise
    return {"refs": refs, "results": finish(300)}


SP_PIX = dict(rtol=1e-4, atol=1e-5)  # tests/test_tp.py's SP bars
# The port's one-process f32 VAE is 1.18e-5 from the JAX package's on one
# pixel near 0.01 (two f32 programs summing in other orders), past 1e-5 +
# 1e-4 * 0.01: its pixels against the JAX package get atol 2e-5.
JAX_PIX = {"vae": dict(rtol=1e-4, atol=2e-5)}
JAX_GRADS = ("t",)  # the JAX test's gradient (tests/test_tp.py:142); one jit of ~25 s


def _hold(got, want, what, pix=SP_PIX):
    np.testing.assert_allclose(got["recon"], want["recon"], err_msg=f"{what} recon", **pix)
    if "encodings" in want:
        np.testing.assert_array_equal(got["encodings"], want["encodings"], err_msg=what)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5, err_msg=what)
    if "grads" not in want:
        return
    assert set(got["grads"]) == set(want["grads"]) and want["grads"]
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=5e-4, atol=1e-5,
                                   err_msg=f"{what} grad {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_sp_matches_jax_and_one_process(world, case):
    res = world["results"]
    jax_pix = JAX_PIX.get(case, SP_PIX)
    one = check_result(res, "sp_cases", 0)[case]["one"]
    _hold(one, world["refs"][case], f"{case}: one process vs JAX", jax_pix)
    for r in range(2):
        got = check_result(res, "sp_cases", r)[case]["sp"]
        _hold(got, world["refs"][case], f"{case}: SP rank {r} vs JAX", jax_pix)
        _hold(got, one, f"{case}: SP rank {r} vs one process")


@pytest.mark.parametrize("what,reason", [
    ("odd_rows", "pixel rows do not divide"), ("bf16_training", "bf16 training-route"),
    ("trainer", "GAN trainer")])
def test_sp_refusals(world, what, reason):
    for r in range(2):
        msg = check_result(world["results"], "sp_refusals", r)[what]
        assert msg is not None, f"{what}: nothing raised"
        assert "sequence parallelism" in msg and reason in msg, msg


@pytest.mark.parametrize("what", ["rows", "pool_rows"])
def test_sp_runs_what_it_refused(world, what):
    """A rank's pixel rows that are part of a patch, and odd token rows at a
    pool, refused before the row partition (parallel/tp.py): every rank's
    run equals one process's, loss and gradient too."""
    one = check_result(world["results"], "sp_ragged", 0)[what]["one"]
    for r in range(2):
        _hold(check_result(world["results"], "sp_ragged", r)[what]["sp"], one,
              f"{what}: SP rank {r} vs one process")


# -- the plain versions' query blocks --------------------------------------------------------
BF16_REL_TOL = 5e-2  # bf16 inputs and outputs, as tests/test_torch_kernels_ref.py holds them


def _bf16(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "no_rope"])
@pytest.mark.parametrize("n,blocks", [(64, 2), (256, 4)])
def test_cosine_mha_plain_query_block(use_rope, n, blocks):
    """Each block at its offset equals the rows of the square call and of
    the Pallas kernel in interpret mode on the whole grid."""
    heads, dh, B = 2, 32, 2
    rng = np.random.RandomState(3)
    q_j, q_t = _bf16(rng.standard_normal((B, n, heads * dh)))
    kv_j, kv_t = _bf16(rng.standard_normal((B, n, 2 * heads * dh)))
    qs, ks = ((1 + 0.1 * rng.standard_normal(dh)).astype(np.float32) for _ in range(2))
    args = (torch.from_numpy(qs), torch.from_numpy(ks), heads, dh, 8.0, use_rope)
    whole = cm.cosine_mha_plain(q_t, kv_t, *args).float().numpy()
    pallas = np.asarray(pallas_cosine_mha(q_j, kv_j, jnp.asarray(qs), jnp.asarray(ks),
                                          heads=heads, dim_head=dh, scale=8.0,
                                          use_rope=use_rope, interpret=True).astype(jnp.float32))
    nq = n // blocks
    for r in range(blocks):
        rows = slice(r * nq, (r + 1) * nq)
        block = q_t[:, rows].contiguous()
        got = cm.cosine_mha_plain(block, kv_t, *args, q_offset=r * nq).float().numpy()
        # the same f32 math on a block of the rows: at most a bf16 rounding apart
        np.testing.assert_allclose(got, whole[:, rows], rtol=1e-2, atol=1e-2)
        assert _rel(got, pallas[:, rows]) <= BF16_REL_TOL
        q_hat, k_hat = cm.cosine_prep_plain(block, kv_t, *args, q_offset=r * nq)
        assert q_hat.shape == block.shape and k_hat.shape == (B, n, heads * dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_plain_query_block(dtype):
    """mha_plain with Nq < Nk equals the rows of the square call and of the
    Pallas kernel in interpret mode on the whole N."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 3, 64, 16, generator=g).to(dtype) for _ in range(3))
    whole = mh.mha_plain(q, k, v, 0.25)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = np.asarray(mha_pallas(*(jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v)),
                                   0.25, interpret=True).astype(jnp.float32))
    for r in range(4):
        rows = slice(16 * r, 16 * (r + 1))
        got = mh.mha_plain(q[:, :, rows], k, v, 0.25)
        assert torch.equal(got, whole[:, :, rows])
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), pallas[:, :, rows], rtol=1e-5, atol=1e-5)
        else:
            assert _rel(got.float().numpy(), pallas[:, :, rows]) <= BF16_REL_TOL


# -- the row partition (parallel/tp.py), plain Python -----------------------------------------
@pytest.mark.parametrize("rows,n", [(5, 2), (5, 4), (2, 4), (1, 2), (33, 2), (40, 16), (32, 8)])
def test_even_spans(rows, n):
    """End to end from row 0 to the last, the first rows % n ranks one row
    longer, the empty ranks last; equal blocks where n divides the rows."""
    equal = tuple((r * (rows // n), (r + 1) * (rows // n)) for r in range(n))
    spans = tp.even_spans(rows, n)
    sizes = [hi - lo for lo, hi in spans]
    assert len(spans) == n and spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert sizes == [rows // n + (r < rows % n) for r in range(n)]
    if rows % n == 0:
        assert spans == equal


def _cfg(**kw):
    return TokenizerConfig(**{**TEST_TP, **kw})


# config, pixel rows, ranks -> (pixel spans, the encoder's spans at each grid, the
# reconstruction's spans)
PARTITIONS = {
    # 5 token rows: 3 / 2, 10 pixel rows a rank are 2.5 patches
    "20_2": (_cfg(), 20, 2, ((0, 12), (12, 20)), [((0, 3), (3, 5))] * 2, ((0, 12), (12, 20))),
    "20_4": (_cfg(), 20, 4, ((0, 8), (8, 12), (12, 16), (16, 20)),
             [((0, 2), (2, 3), (3, 4), (4, 5))] * 2, ((0, 8), (8, 12), (12, 16), (16, 20))),
    # the pool's coarse grid (5 rows) split, the finer one twice it: whole 2 x 2 cells
    "ta_40": (_cfg(enc_block="ta", spatial_depth=2), 40, 2, ((0, 24), (24, 40)),
              [((0, 6), (6, 10))] * 2 + [((0, 3), (3, 5))], ((0, 12), (12, 20))),
    # the deferred pool drops the odd 9th token row: the rank of the row before it holds it
    "defer_odd_36": (_cfg(patch_size=8, defer_spatial_pool=True), 36, 2, ((0, 16), (16, 36)),
                     [((0, 4), (4, 9))] * 2 + [((0, 2), (2, 4))], ((0, 16), (16, 32))),
    # ranks without rows come last
    "empty_8_4": (_cfg(), 8, 4, ((0, 4), (4, 8), (8, 8), (8, 8)),
                  [((0, 1), (1, 2), (2, 2), (2, 2))] * 2, ((0, 4), (4, 8), (8, 8), (8, 8))),
}


@pytest.mark.parametrize("case", list(PARTITIONS))
def test_row_partition(case):
    cfg, rows, n, pixels, encoder, recon = PARTITIONS[case]
    part = tp.row_partition(cfg, rows, n)
    assert part.pixels == pixels and list(part.encoder) == encoder and part.recon == recon
    assert part.latent == tp.even_spans(encoder[-1][-1][1], n) == part.decoder[0]
    for grids in (part.encoder, part.decoder):  # each grid's spans: 2x the next coarser one's
        for a, b in zip(grids, grids[1:]):
            fine, coarse = (a, b) if a[-1][1] >= b[-1][1] else (b, a)
            if fine != coarse:
                assert [lo for lo, _ in fine] == [2 * lo for lo, _ in coarse]


@pytest.mark.parametrize("res,ranks", [(256, 2), (256, 4), (256, 8), (128, 16)])
def test_row_partition_is_equal_blocks_where_they_divide(res, ranks):
    """The flagship's stacks where n divides the rows into whole patches:
    equal blocks at every grid, so nothing moves."""
    cfg = TokenizerConfig(resolution=res)
    part = tp.row_partition(cfg, res, ranks)
    for spans in (part.pixels, part.recon) + part.encoder + part.decoder:
        rows = spans[-1][1] // ranks
        assert spans == tuple((r * rows, (r + 1) * rows) for r in range(ranks))


def test_row_partition_of_the_card_cases():
    """chip_smoke.py phase 18c's two partitions: the flagship's widths with
    spatial 'tttt' at 264^2 over 2 ranks (33 token rows: 17 / 16), and the
    flagship at 320^2 over 16 (40 token rows: 3 x 8, 2 x 8; 24 or 16 pixel
    rows a rank against the equal blocks' 20)."""
    part = tp.row_partition(TokenizerConfig(resolution=264, enc_block="tttt"), 264, 2)
    assert part.encoder[0] == ((0, 17), (17, 33)) and part.pixels == ((0, 136), (136, 264))
    part = tp.row_partition(TokenizerConfig(resolution=320), 320, 16)
    assert [hi - lo for lo, hi in part.encoder[0]] == [3] * 8 + [2] * 8
    assert [hi - lo for lo, hi in part.pixels] == [24] * 8 + [16] * 8


def test_rescale_refuses_spans_that_cut_a_pool_cell():
    assert tp.rescale(((0, 4), (4, 6)), 3) == ((0, 2), (2, 3))
    with pytest.raises(ValueError, match="cut a 2 x 2 pool cell"):
        tp.rescale(((0, 3), (3, 6)), 3)
