"""The port's data parallelism on the CPU over gloo: two ranks, each with its
rows of the global batch, against one process on the concatenated batch
(the JAX trainers' GSPMD semantics, tests/test_multiprocess.py).

One world of 2 ranks runs every check of tests/torch_parallel_worker.py's
"dp" suite once (a spawn costs a torch import a rank); the tests below read
its results. Bars: one GAN step (VQ with BatchNorm and GroupNorm
discriminators, the discriminator noise and DiffAugment, random restarts;
the VAE; the step's two codebook advances): every metric 1e-5 relative,
the gradient norms 1e-4, both gradients (Adam's first moment) 1e-4 of
their norm, every parameter, codebook buffer and BatchNorm statistic 1e-5
relative (plus 1e-7 absolute for values near 0), but where a gradient
element lies below that 1e-4 noise level (the conv biases a BatchNorm
follows: 0 in exact arithmetic): Adam's first update is lr * sign(g), so
such an element may land 2 lr away; the Codebook's three grouped calls
(init from the gathered rows, restarts, EMA) and the quantizers': buffers
1e-6, indices exact; the DiT step: loss 1e-5, parameters and EMA 1e-5;
three DiT steps on the loss-second-moment sampler: its draws exact, its
loss history and the last loss 1e-5, the last gradient norm 1e-4.
Every rank ends with the same values."""

import os
import re

import numpy as np
import pytest
import torch

from omnitokenizer_tpu_torch.ops.codebook import code_sums
from omnitokenizer_tpu_torch.parallel import mesh

from torch_port_util import check_result, run_world

torch.set_num_threads(2)

GAN_CASES = ["gan_vq_batch", "gan_vq_group", "gan_vq_restart", "gan_vae_batch"]
LR0 = 1e-5  # the warmup's first learning rate


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    return {"root": root, "results": run_world("dp", 2, root)}


def close(got, want, rtol, atol=0.0, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if want.shape != got.shape:  # a rank's rows against the global batch's first rows
        want = want[:got.shape[0]]
    err = np.abs(got - want)
    bound = rtol * np.abs(want) + atol
    assert (err <= bound).all(), f"{what}: max err {err.max():.3e} (bound {bound.max():.3e})"


def test_launch_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "OMNITOK_COORD",
              "OMNITOK_NPROCS", "OMNITOK_PROC_ID", "OMNITOK_NO_DIST"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "4")  # an allocation alone starts no job
    assert mesh.launch_env() is None
    monkeypatch.setenv("OMNITOK_COORD", "localhost:1234")
    with pytest.raises(RuntimeError, match="refusing to guess"):
        mesh.launch_env()
    monkeypatch.setenv("OMNITOK_NPROCS", "2")
    monkeypatch.setenv("OMNITOK_PROC_ID", "1")
    assert mesh.launch_env() == ("tcp://localhost:1234", 2, 1)
    monkeypatch.setenv("OMNITOK_NO_DIST", "1")
    assert mesh.launch_env() is None
    monkeypatch.delenv("OMNITOK_NO_DIST")
    monkeypatch.delenv("OMNITOK_COORD")
    for k, v in (("RANK", "3"), ("WORLD_SIZE", "4"), ("MASTER_ADDR", "h"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    assert mesh.launch_env() == ("env://", 4, 3)


def test_backend_rule(monkeypatch):
    """NCCL for CUDA ranks while this host has a card for each; gloo when
    more of them share the host (NCCL refuses two ranks on one card) and for
    CPU ranks. The neighbours are counted by host name on the rendezvous
    store."""
    import socket

    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.default_backend("cpu", 1) == "gloo"
    assert mesh.default_backend("cuda", 1) == mesh.default_backend("cuda", 2) == "nccl"
    assert mesh.default_backend("cuda", 3) == "gloo"
    store = dist.HashStore()
    store.set("omnitok_host/1", "elsewhere")
    store.set("omnitok_host/2", socket.gethostname())
    assert mesh.ranks_on_host(store, 0, 3) == 2


def test_code_sums_match_index_add():
    """code_sums on the CPU against index_add_ (the codebook's old sum), with
    empty codes and one code holding most rows. (The card's sort-based form
    is held bit-equal run to run by chip_smoke.py phase 16a.)"""
    rng = np.random.RandomState(0)
    rows = torch.from_numpy(rng.standard_normal((5000, 8)).astype(np.float32))
    idx = torch.from_numpy(np.where(rng.rand(5000) < 0.5, 3, rng.randint(0, 97, 5000)))
    want = torch.zeros(100, 8).index_add_(0, idx, rows)
    got = code_sums(idx, rows, 100)
    assert got.shape == (100, 8)
    assert (got[97:] == 0).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_placement(world):
    for r in range(2):
        v = check_result(world["results"], "placement", r)
        np.testing.assert_array_equal(v["rows"], np.arange(12).reshape(6, 2)[3 * r:3 * r + 3])
        np.testing.assert_array_equal(v["replicated"], np.zeros(3))
        np.testing.assert_array_equal(v["draws"], v["draws_full"][2 * r:2 * r + 2])
        np.testing.assert_array_equal(v["grid"], [r, 2, 0, 1])
        np.testing.assert_array_equal(v["bf16"], [1.5, 2.5, 4.0, 1.5])


def test_codebook_group_equals_one_call(world):
    v = check_result(world["results"], "codebook")
    dp, one = v["dp"], v["one"]
    for step, (a, b) in enumerate(zip(dp["outs"], one["outs"])):
        np.testing.assert_array_equal(a["encodings"], b["encodings"][:2])
        for k in ("commitment_loss", "perplexity", "avg_usage", "batch_usage"):
            close(a[k], b[k], 1e-6, 1e-7, f"step {step} {k}")
    for k, want in one["buffers"].items():
        close(dp["buffers"][k], want, 1e-6, 1e-6, k)
    other = check_result(world["results"], "codebook", 1)["dp"]
    np.testing.assert_array_equal(other["outs"][2]["encodings"], one["outs"][2]["encodings"][2:])
    for k in one["buffers"]:
        np.testing.assert_array_equal(other["buffers"][k], dp["buffers"][k])


@pytest.mark.parametrize("name", ["euclid", "cosine", "residual"])
def test_quantizers_group_equal_one_call(world, name):
    res = check_result(world["results"], "quantizers")[name]
    dp, one = res["dp"], res["one"]
    enc_dp = dp["enc"] if name == "residual" else np.stack(dp["enc"])
    enc_one = one["enc"] if name == "residual" else np.stack(one["enc"])
    if name == "residual":
        np.testing.assert_array_equal(enc_dp, enc_one[:4])
    else:
        np.testing.assert_array_equal(enc_dp, enc_one[:, :4])
    flat = lambda t: [x for part in t for x in (part if isinstance(part, list) else [part])]  # noqa
    for a, b in zip(flat(dp["state"]), flat(one["state"])):
        close(a, b, 1e-6, 1e-6, f"{name} state")


def _bn_biases(disc: dict) -> set:
    """The conv biases a BatchNorm follows (their gradient is 0 in exact
    arithmetic)."""
    out = set()
    for k in disc:
        m = re.match(r"(image|video)\.model(\d+)_conv\.bias$", k)
        if m and f"{m.group(1)}.model{m.group(2)}_norm.norm.mean" in disc:
            out.add(k)
    return out


@pytest.mark.parametrize("case", GAN_CASES)
def test_dp_gan_step_equals_one_process(world, case):
    v = check_result(world["results"], case)
    dp, one = v["dp"], v["one"]
    (a,), (b,) = dp["metrics"], one["metrics"]
    assert set(a) == set(b)
    for k in a:
        close(a[k], b[k], 1e-4 if k.startswith("grad_norm") else 1e-5, 1e-7, k)
    zero = _bn_biases(one["disc"])
    for mu, params in (("g_mu", "net"), ("d_mu", "disc")):
        for k, want in one[mu].items():
            got = dp[mu][k]
            if k in zero:  # rounding alone, on both sides: tiny beside its conv's weight
                scale = np.linalg.norm(one[mu][k.replace("bias", "weight")])
                assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-4 * scale, k
                noise = np.inf
            else:
                noise = 1e-4 * max(np.linalg.norm(want), 1e-12)
                assert np.linalg.norm(got - want) <= noise, k
            # below the gradient's noise level the update's sign is the rounding's
            flip = np.abs(want) <= noise
            err = np.abs(dp[params][k].astype(np.float64) - one[params][k])
            bound = np.where(flip, 2 * LR0, 1e-5 * np.abs(one[params][k]) + 1e-7)
            assert (err <= bound).all(), f"{k}: max err {err.max():.3e}"
    for part in ("net", "disc"):  # the buffers: codebook, BatchNorm statistics
        for k, want in one[part].items():
            if k not in one["g_mu"] and k not in one["d_mu"]:
                close(dp[part][k], want, 1e-5, 1e-7, k)
    assert zero or "group" in case


@pytest.mark.parametrize("case", GAN_CASES)
def test_dp_ranks_agree(world, case):
    res = world["results"]
    a, b = check_result(res, case, 0)["dp"], check_result(res, case, 1)["dp"]
    assert a["metrics"] == b["metrics"]
    for part in ("net", "disc"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)


def test_dit_dp_step_equals_one_process(world):
    v = check_result(world["results"], "dit")
    dp, one = v["dp"], v["one"]
    close(dp["loss"], one["loss"], 1e-5, 0, "loss")
    close(dp["grad_norm"], one["grad_norm"], 1e-4, 0, "grad_norm")
    for part in ("model", "ema"):
        for k, want in one[part].items():
            close(dp[part][k], want, 1e-5, 1e-7, f"{part} {k}")
    other = check_result(world["results"], "dit", 1)["dp"]
    for k in dp["ema"]:
        np.testing.assert_array_equal(other["ema"][k], dp["ema"][k])


def test_dit_dp_loss_second_moment_sampler_equals_one_process(world):
    """Three DP steps on the loss-second-moment sampler: every rank draws the
    one process's timesteps and holds its loss history (the global batch's
    losses gathered), the same on both ranks."""
    v = check_result(world["results"], "dit")
    dp, one = v["lsm_dp"], v["lsm_one"]
    np.testing.assert_array_equal(dp["ts"], one["ts"])
    close(dp["history"], one["history"], 1e-5, 0, "loss history")
    close(dp["loss"], one["loss"], 1e-5, 0, "loss")
    close(dp["grad_norm"], one["grad_norm"], 1e-4, 0, "grad_norm")
    other = check_result(world["results"], "dit", 1)["lsm_dp"]
    np.testing.assert_array_equal(other["ts"], dp["ts"])
    np.testing.assert_array_equal(other["history"], dp["history"])


def test_vqgan_train_cli_over_two_ranks(world):
    """vqgan_train on 2 ranks: 2 steps, a resume to 3 (rank 0's checkpoint
    read by both), the same state on both ranks."""
    res = world["results"]
    a, b = check_result(res, "vqgan_train", 0), check_result(res, "vqgan_train", 1)
    assert list(a["steps"]) == list(b["steps"]) == [2, 3]
    assert a["ckpts"] == ["step_00000002.pt", "step_00000003.pt"]
    for k in a["net"]:
        np.testing.assert_array_equal(a["net"][k], b["net"][k], err_msg=k)


def test_dit_cli_over_two_ranks(world, tmp_path):
    """dit_train on 2 ranks: one state, the same EMA on both ranks; dit_sample
    on 2 ranks: the JAX CLI's per-rank files (latents_{rank:02d}_*), rank r's
    draws those of one process seeded seed + 1000 r (one class: the rotation
    moves nothing)."""
    from omnitokenizer_tpu_torch.cli import dit_sample

    from torch_parallel_worker import DIT_SAMPLE

    res = world["results"]
    a, b = check_result(res, "dit_cli", 0), check_result(res, "dit_cli", 1)
    assert a["made"] == b["made"] == 2 and a["states"] == ["state_000000002.pt"]
    for k in a["ema"]:
        np.testing.assert_array_equal(a["ema"][k], b["ema"][k], err_msg=k)
    root = world["root"]
    files = sorted(os.listdir(root / "dit_samples"))
    assert files == ["latents_00_00000.npy", "latents_01_00000.npy"]
    for r in range(2):
        out = tmp_path / f"seed{r}"
        dit_sample.main(DIT_SAMPLE + ["--ckpt", str(root / "dit_run" / "state_000000002.pt"),
                                      "--sample_dir", str(out), "--seed", str(1000 * r)])
        np.testing.assert_array_equal(np.load(root / "dit_samples" / files[r]),
                                      np.load(out / "latents_00_00000.npy"))


def test_dryrun_multichip():
    from omnitokenizer_tpu_torch.parallel.dryrun import dryrun_multichip

    env = {k: os.environ.pop(k) for k in ("OMNITOK_NO_DIST",) if k in os.environ}
    try:
        dryrun_multichip(2, device="cpu", timeout=240)
    finally:
        os.environ.update(env)
