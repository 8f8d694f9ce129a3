"""The port's generation metrics against the JAX package's, on the CPU:
eval/prec_recall.py on random features (radii within 1e-5 relative over
several row and column blocks; precision and recall equal, with every
compared distance shown to lie more than 1e-4 relative from its radius,
so the equality is no luck of rounding), and cli/metrics_eval.py's JSON
against the JAX CLI's on the same inputs and the same random
torch-named I3D and pt_inception .pt files: directories of .npz (both
layouts), .npy and .gif clips, float in the model range and uint8, one
clip longer than its pair; PSNR and SSIM within 1e-4, FVD, FID and sFID
within 1e-3 relative and IS within 1e-4 relative (the features
themselves are held to 1e-4 in test_torch_eval.py), precision and recall
within 2/N of N frames (a random network's features lie close together);
the evaluator's batch mode; --metrics selection; LPIPS skipped
without weights as the JAX CLI skips it. And download.resolve_checkpoint
on paths, cache hits and unknown names."""

import json
import os

import imageio.v3 as iio
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.cli import metrics_eval as jax_cli
from omnitokenizer_tpu.eval import prec_recall as jax_pr
from omnitokenizer_tpu_torch import download
from omnitokenizer_tpu_torch.cli import metrics_eval
from omnitokenizer_tpu_torch.eval import prec_recall

torch.set_num_threads(2)
# the directory run takes every metric but those the batch run takes (each JAX
# Inception function compiles anew in every call: the two runs share none)
DIR_METRICS = "psnr,ssim,fvd,lpips,is,sfid"
BATCH_METRICS = "fid,prec_recall"


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _features(seed, n, d=16):
    """Clouds around 4 shared centres, so that the two sets' hyperspheres
    overlap partly."""
    centres = np.random.RandomState(99).randn(4, d) * 3
    rng = np.random.RandomState(seed)
    return (centres[rng.randint(0, 4, n)] + rng.randn(n, d)).astype(np.float32)


def _margin(u, v, radii, axis_of_radius):
    """The least |d - r| / r over every compared (distance, radius) pair,
    in float64."""
    d = ((u[:, None, :].astype(np.float64) - v[None, :, :]) ** 2).sum(-1)
    r = radii[None, :] if axis_of_radius == 1 else radii[:, None]
    return float((np.abs(d - r) / r).min())


def test_precision_recall_matches_jax():
    ref, sample = _features(0, 50), _features(1, 45)
    kw = dict(row_batch=16, col_batch=12)  # 4 x 4 blocks
    radii_j = [jax_pr.manifold_radii(f, 3, **kw) for f in (ref, sample)]
    radii_t = [prec_recall.manifold_radii(f, 3, device="cpu", **kw).numpy()
               for f in (ref, sample)]
    for got, want in zip(radii_t, radii_j):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # the (k + 1)-th smallest distance, self at index 0
    d = ((ref[:, None].astype(np.float64) - ref[None]) ** 2).sum(-1)
    np.testing.assert_allclose(radii_t[0], np.sort(d, axis=1)[:, 3], rtol=1e-5)
    # no distance near its radius in either fold: the comparisons cannot flip
    assert _margin(ref, sample, radii_j[1], 1) > 1e-4   # ref_i vs a sample sphere
    assert _margin(ref, sample, radii_j[0], 0) > 1e-4   # sample_j vs a ref sphere
    want = jax_pr.precision_recall(ref, sample, **kw)
    got = prec_recall.precision_recall(ref, sample, device="cpu", **kw)
    assert got == want and 0 < want[0] < 1 and 0 < want[1] < 1
    # one block each way gives the same
    assert prec_recall.precision_recall(ref, sample, device="cpu") == want


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """gen/ and gt/ with 4 pairs in sorted-name order (npz (T, H, W, C), npz
    (C, T, H, W), npy, gif), the first gen clip a frame longer; the
    evaluator's uint8 batches; random torch-named I3D and Inception files."""
    from omnitokenizer_tpu_torch.eval.i3d import InceptionI3d, init_like_jax
    from omnitokenizer_tpu_torch.eval.inception import load_inception

    root = tmp_path_factory.mktemp("metrics")
    rng = np.random.RandomState(0)
    for d in ("gen", "gt"):
        os.makedirs(root / d)
        frames = 10 if d == "gen" else 9
        clip = rng.uniform(-0.5, 0.5, (frames, 32, 32, 3)).astype(np.float32)
        np.savez(root / d / "a.npz", video=clip)
        np.savez(root / d / "b.npz",
                 video=np.moveaxis(rng.uniform(-0.5, 0.5, (9, 32, 32, 3)), -1, 0))
        np.save(root / d / "c.npy", rng.uniform(-0.5, 0.5, (9, 32, 32, 3)).astype(np.float32))
        iio.imwrite(str(root / d / "d.gif"), rng.randint(0, 255, (9, 32, 32, 3), np.uint8),
                    loop=0)
    for name in ("ref", "sample"):
        np.savez(root / f"{name}.npz", rng.randint(0, 255, (24, 32, 32, 3), np.uint8))
    for d in ("gen", "gt"):  # the first two pairs' frames as the CLI casts them, as batches
        a = np.load(root / d / "a.npz")["video"][:9]
        b = np.moveaxis(np.load(root / d / "b.npz")["video"], 0, -1)
        frames = [(np.clip(c.astype(np.float32) + 0.5, 0, 1) * 255).astype(np.uint8)
                  for c in (a, b)]
        np.savez(root / f"{d}_frames.npz", np.concatenate(frames))
    i3d = InceptionI3d()
    init_like_jax(i3d, seed=2)
    torch.save(i3d.state_dict(), root / "i3d.pt")
    inc, _ = load_inception(None, device="cpu", seed=1)
    torch.save(inc.state_dict(), root / "inception.pt")
    return root


def _both(tmp_path, flags):
    out = {}
    for name, main, own in (("jax", jax_cli.main, []), ("port", metrics_eval.main,
                                                         ["--device", "cpu"])):
        save = str(tmp_path / f"{name}.json")
        main(flags + own + ["--save", save])
        with open(save) as f:
            out[name] = json.load(f)
    assert set(out["port"]) == set(out["jax"])
    return out["jax"], out["port"]


def _check(want, got, keys, frames=1):
    for k in keys:
        w, g = want[k], got[k]
        assert (w is None) == (g is None), k
        if w is None:
            continue
        if k in ("psnr", "ssim"):
            assert abs(g - w) <= 1e-4, k
        elif k in ("is", "is_std"):
            assert _rel(g, w) <= 1e-4, k
        elif k == "clips":
            assert g == w, k
        elif k in ("precision", "recall"):
            # the Inception features agree to 1e-4 (test_torch_eval.py), and a random
            # network's features sit close together: a distance may lie that near its
            # radius. The distance math is held equal in test_precision_recall_matches_jax.
            assert abs(g - w) <= 2 / frames, (k, g, w)
        else:
            assert _rel(g, w) <= 1e-3, (k, g, w)


def test_directory_mode_matches_jax(inputs, tmp_path, capsys):
    """DIR_METRICS over the first two pairs (18 frames a side, the longer
    clip cut to its pair's 9); then PSNR and SSIM over all four pairs; then
    the port's FID and precision/recall of the same two pairs equal to its
    batch mode's on the same uint8 frames (which the next test holds to the
    JAX CLI's)."""
    flags = ["--gen_dir", str(inputs / "gen"), "--gt_dir", str(inputs / "gt"),
             "--i3d_path", str(inputs / "i3d.pt"), "--inception_path",
             str(inputs / "inception.pt"), "--metrics", DIR_METRICS, "--max_clips", "2"]
    want, got = _both(tmp_path / "all", flags)
    assert capsys.readouterr().out.count("no VGG backbone weights; skipping lpips") == 2
    assert got["clips"] == 2 and got["lpips"] is None and got["fid"] is None
    for k in ("psnr", "ssim", "fvd", "is", "sfid"):
        assert got[k] is not None and np.isfinite(got[k]), k
    _check(want, got, want)
    want, got = _both(tmp_path / "pairs", ["--gen_dir", str(inputs / "gen"), "--gt_dir",
                                           str(inputs / "gt"), "--metrics", "psnr,ssim"])
    assert got["clips"] == 4 and got["fvd"] is None
    _check(want, got, want)
    port = ["--inception_path", str(inputs / "inception.pt"), "--metrics", BATCH_METRICS,
            "--device", "cpu"]
    dirs = metrics_eval.main(port + ["--gen_dir", str(inputs / "gen"), "--gt_dir",
                                     str(inputs / "gt"), "--max_clips", "2"])
    batch = metrics_eval.main(port + ["--ref_npz", str(inputs / "gt_frames.npz"),
                                      "--sample_npz", str(inputs / "gen_frames.npz")])
    for k in ("fid", "precision", "recall"):
        assert dirs[k] == batch[k] and dirs[k] is not None, k


def test_batch_mode_and_selection_match_jax(inputs, tmp_path):
    flags = ["--ref_npz", str(inputs / "ref.npz"), "--sample_npz", str(inputs / "sample.npz"),
             "--inception_path", str(inputs / "inception.pt"), "--metrics", BATCH_METRICS,
             "--max_clips", "18"]
    want, got = _both(tmp_path / "batch", flags)
    assert got["clips"] == 18 and got["is"] is None and got["sfid"] is None
    _check(want, got, want, frames=18)
    # directory mode, PSNR alone in the unit range
    flags = ["--gen_dir", str(inputs / "gen"), "--gt_dir", str(inputs / "gt"),
             "--metrics", "psnr", "--range", "unit", "--max_clips", "3"]
    want, got = _both(tmp_path / "psnr", flags)
    assert got["clips"] == 3 and got["ssim"] is None and got["fvd"] is None
    _check(want, got, want)
    with pytest.raises(ValueError, match="unpaired"):
        metrics_eval.main(["--ref_npz", str(inputs / "ref.npz"), "--sample_npz",
                           str(inputs / "sample.npz"), "--metrics", "psnr", "--device", "cpu"])
    if not torch.cuda.is_available():  # the card by default: no CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            metrics_eval.main(["--gen_dir", str(inputs / "gen"), "--gt_dir", str(inputs / "gt")])


def test_resolve_checkpoint(tmp_path, monkeypatch):
    own = tmp_path / "mine.msgpack"
    own.write_bytes(b"\x80")
    assert download.resolve_checkpoint(str(own)) == str(own)
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / "imagenet_k600.ckpt").write_bytes(b"")
    assert download.resolve_checkpoint("imagenet_k600", str(cache)) == str(
        cache / "imagenet_k600.ckpt")
    monkeypatch.chdir(tmp_path)
    os.makedirs("ckpts_pub")
    open(os.path.join("ckpts_pub", "ucf_class_lm.ckpt"), "wb").close()
    assert download.resolve_checkpoint("ucf_class_lm", str(cache)) == os.path.join(
        "./ckpts_pub", "ucf_class_lm.ckpt")
    with pytest.raises(FileNotFoundError, match="known model name"):
        download.resolve_checkpoint("no_such_model", str(cache))
    with pytest.raises(FileNotFoundError, match="nothing is fetched"):
        download.resolve_checkpoint("ffhq", str(cache))
    assert download._MODEL_ZOO == __import__("omnitokenizer_tpu.download",
                                             fromlist=["_MODEL_ZOO"])._MODEL_ZOO
