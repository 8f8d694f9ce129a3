"""The port's CLIs against the JAX package's: vqgan_eval of both packages on
the same tiny dataset and the same Lightning-style checkpoint (reference
key scheme, random values) gives the same result.json: PSNR and SSIM
within 1e-4, codebook usage and batch count exact, in image mode (the
port's rFID runs on a random torch-named pt_inception .pt) and in video
mode with rFVD on a random torch-named I3D .pt, FVD within 1e-3 relative. The port's vqgan_train runs 2 GAN steps at the JAX CLI test's
TINY flags on the CPU, checkpoints, resumes, and its checkpoint feeds the
port's vqgan_eval. The flag sets and the configs they build agree with
the JAX package's, and every flag of the recipes in scripts/recons is
accepted."""

import dataclasses
import glob
import json
import os
import re

import numpy as np
import pytest
import torch

from omnitokenizer_tpu.cli import vqgan_eval as jax_eval
from omnitokenizer_tpu.cli import vqgan_train as jax_train
from omnitokenizer_tpu.cli import args as JA
from omnitokenizer_tpu_torch.cli import args as PA
from omnitokenizer_tpu_torch.cli import vqgan_eval, vqgan_train

from torch_port_util import reference_state_dict, write_lightning_ckpt

torch.set_num_threads(2)

# tests/test_vqgan_cli.py's TINY flags
TINY = [
    "--embedding_dim", "16", "--n_codes", "32", "--codebook_dim", "4",
    "--patch_size", "4", "--temporal_patch_size", "2",
    "--enc_block", "t", "--dec_block", "t",
    "--spatial_depth", "1", "--temporal_depth", "1",
    "--dim_head", "8", "--heads", "2", "--spatial_pos", "rope",
    "--resolution", "16", "--sequence_length", "1",
    "--perceptual_weight", "0", "--image_gan_weight", "0.1",
    "--video_gan_weight", "0", "--gan_feat_weight", "0.1",
    "--disc_layers", "1", "--batch_size", "8", "--num_workers", "0",
    "--norm_type", "batch",
]
# the clips' variant: 9 frames (the fewest I3D takes), batches of 2
VIDEO = list(TINY)
VIDEO[VIDEO.index("--sequence_length") + 1] = "9"
VIDEO[VIDEO.index("--batch_size") + 1] = "2"


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """16 PNG images and 4 GIF clips of 16x16, with their lists."""
    import imageio.v3 as iio
    from PIL import Image

    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.RandomState(0)
    for i in range(16):
        Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(root / f"img_{i:03d}.png")
    (root / "imagenet_tiny.txt").write_text("".join(f"img_{i:03d}.png\t{i % 3}\n" for i in range(16)))
    for i in range(4):
        iio.imwrite(str(root / f"clip_{i}.gif"), rng.randint(0, 255, (9, 16, 16, 3), np.uint8),
                    loop=0)
    (root / "k600_tiny.txt").write_text("".join(f"clip_{i}.gif\n" for i in range(4)))
    return root


def _ckpt(path, flags):
    """A Lightning-style checkpoint for the config the flags describe."""
    cfg = JA.tokenizer_config_from(jax_eval.build_parser().parse_args(
        flags + ["--vqgan_ckpt", "x"]))
    write_lightning_ckpt(path, reference_state_dict(cfg, seed=11))
    return str(path)


def _both_evals(tmp_path, flags, extra, port_extra=()):
    """result.json of the JAX CLI and of the port's (--device cpu)."""
    out = {}
    for name, main, own in (("jax", jax_eval.main, []),
                            ("port", vqgan_eval.main, ["--device", "cpu", *port_extra])):
        save = str(tmp_path / name)
        main(flags + extra + own + ["--save", save])
        with open(os.path.join(save, "result.json")) as f:
            out[name] = json.load(f)
    return out["jax"], out["port"]


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def test_vqgan_eval_image_matches_jax(data, tmp_path):
    from omnitokenizer_tpu_torch.eval.inception import load_inception

    inc, _ = load_inception(None, device="cpu", seed=1)
    torch.save(inc.state_dict(), tmp_path / "inception.pt")
    lists = ["--data_path", str(data), "--train_datalist", str(data / "imagenet_tiny.txt"),
             "--val_datalist", str(data / "imagenet_tiny.txt")]
    ckpt = _ckpt(tmp_path / "tok.ckpt", TINY)
    # rFID on the port's side only (the Inception features themselves are
    # held to JAX's in test_torch_eval.py): the PNG trees written without
    # PIL, read back with it
    want, got = _both_evals(tmp_path, TINY + lists,
                            ["--vqgan_ckpt", ckpt, "--inference_type", "image"],
                            ["--inception_path", str(tmp_path / "inception.pt")])
    assert got["batches"] == want["batches"] == 2  # 16 images, one pass
    assert got["codebook_usage"] == want["codebook_usage"] > 0
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4
    assert want["fid"] is None and np.isfinite(got["fid"]) and got["fid"] >= 0
    assert got["fvd"] is None and want["fvd"] is None
    for tree in ("inputs", "recons"):  # the same PNG trees, pixel for pixel
        from PIL import Image

        names = sorted(os.listdir(tmp_path / "jax" / tree))
        assert names == sorted(os.listdir(tmp_path / "port" / tree)) and len(names) == 16
        a = np.asarray(Image.open(tmp_path / "jax" / tree / names[0]))
        b = np.asarray(Image.open(tmp_path / "port" / tree / names[0]))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_vqgan_eval_video_matches_jax(data, tmp_path):
    from omnitokenizer_tpu_torch.eval.i3d import InceptionI3d, init_like_jax

    i3d = InceptionI3d()
    init_like_jax(i3d, seed=2)
    torch.save(i3d.state_dict(), tmp_path / "i3d.pt")
    lists = ["--data_path", str(data), "--train_datalist", str(data / "k600_tiny.txt"),
             "--val_datalist", str(data / "k600_tiny.txt")]
    ckpt = _ckpt(tmp_path / "tok.ckpt", VIDEO)
    want, got = _both_evals(tmp_path, VIDEO + lists, [
        "--vqgan_ckpt", ckpt, "--inference_type", "video", "--replacewithgt", "0",
        "--i3d_path", str(tmp_path / "i3d.pt")])
    assert got["batches"] == want["batches"] == 2
    assert got["codebook_usage"] == want["codebook_usage"] > 0
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4
    assert got["ssim"] is None and want["ssim"] is None
    assert _rel(got["fvd"], want["fvd"]) <= 1e-3


def test_vqgan_train_resumes_and_feeds_eval(data, tmp_path):
    lists = ["--data_path", str(data), "--train_datalist", str(data / "imagenet_tiny.txt"),
             "--val_datalist", str(data / "imagenet_tiny.txt")]
    run = str(tmp_path / "run")
    common = TINY + lists + ["--default_root_dir", run, "--warmup_steps", "1", "--lr", "1e-4",
                             "--device", "cpu"]
    state = vqgan_train.main(common + ["--max_steps", "2"])
    assert state.step == 2
    assert os.path.exists(os.path.join(run, "checkpoints", "step_00000002.pt"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert [r["step"] for r in rows] == [0, 1] and np.isfinite(rows[-1]["recon_loss"])

    resumed = vqgan_train.main(common + ["--max_steps", "3"])  # auto-resume
    assert resumed.step == 3
    ckpt = sorted(glob.glob(os.path.join(run, "checkpoints", "step_*.pt")))[-1]
    assert ckpt.endswith("step_00000003.pt")

    save = str(tmp_path / "eval")
    result = vqgan_eval.main(TINY + lists + ["--vqgan_ckpt", ckpt, "--inference_type", "image",
                                             "--save", save, "--max_batches", "1",
                                             "--device", "cpu"])
    assert result["batches"] == 1 and np.isfinite(result["psnr"])
    assert 0 < result["codebook_usage"] <= 1
    assert len(glob.glob(os.path.join(save, "recons", "*.png"))) == 8


def test_flag_sets_and_configs_match_jax():
    for build_port, build_jax in ((vqgan_eval.build_parser, jax_eval.build_parser),
                                  (vqgan_train.build_parser, jax_train.build_parser)):
        port_flags = {o for a in build_port()._actions for o in a.option_strings}
        jax_flags = {o for a in build_jax()._actions for o in a.option_strings}
        # the port adds --device and has every JAX flag
        assert port_flags - jax_flags == {"--device"}
        assert jax_flags - port_flags == set()
    argv = TINY + ["--bf16", "--use_vae", "--lr", "3e-4", "--freeze_trans",
                   "--ema_advances_per_step", "1"]
    pa = PA.normalize_precision(vqgan_train.build_parser().parse_args(argv))
    ja = JA.normalize_precision(jax_train.build_parser().parse_args(argv))
    assert _fields(PA.tokenizer_config_from(pa)) == _fields(JA.tokenizer_config_from(ja))
    assert PA.tokenizer_config_from(pa).dtype == torch.bfloat16
    assert _fields(PA.loss_config_from(pa)) == _fields(JA.loss_config_from(ja))
    assert _fields(PA.train_config_from(pa)) == _fields(JA.train_config_from(ja))
    assert pa.device == "cuda"  # the card unless the caller asks for the CPU


def _recipe_commands(path):
    text = open(path).read().replace("\\\n", " ")
    for line in text.splitlines():
        m = re.search(r"python(?:3)? -m omnitokenizer_tpu\.cli\.(\w+)", line)
        if m and m.group(1) in ("vqgan_eval", "vqgan_train"):
            yield m.group(1), re.findall(r"(--[A-Za-z0-9_\-]+)", line[m.end():])


@pytest.mark.parametrize("script", sorted(glob.glob("scripts/recons/*.sh")),
                         ids=lambda p: os.path.basename(p))
def test_port_accepts_the_recipes_flags(script):
    mods = {"vqgan_eval": vqgan_eval, "vqgan_train": vqgan_train}
    cmds = list(_recipe_commands(script))
    assert cmds
    for cli, flags in cmds:
        known = {o for a in mods[cli].build_parser()._actions for o in a.option_strings}
        assert not set(flags) - known, f"{script}: {cli} lacks {set(flags) - known}"


def test_eval_script_config_is_the_released_config():
    """The released tokenizer's eval flags (scripts/recons/eval_video.sh)
    build imagenet_k600_config() field for field, but commitment_weight:
    the flag's default is the reference's 0.25, the config's 1.0 is the
    stage-2 recipe's; a loss weight, which no eval reads."""
    from omnitokenizer_tpu_torch import imagenet_k600_config

    flags = ("--inference_type video --patch_embed linear --patch_size 8 "
             "--temporal_patch_size 4 --spatial_depth 4 --temporal_depth 4 "
             "--embedding_dim 512 --disc_layers 3 --enc_block ttww --dec_block tttt "
             "--twod_window_size 8 --causal_in_temporal_transformer --causal_in_peg "
             "--dim_head 64 --heads 8 --apply_noise --apply_blur --spatial_pos rope "
             "--n_codes 8192 --codebook_dim 8 --l2_code --no_random_restart "
             "--batch_size 8 --loader_type joint --resolution 256 --sequence_length 17 "
             "--norm_type batch --replacewithgt 0 --vqgan_ckpt x").split()
    cfg = PA.tokenizer_config_from(vqgan_eval.build_parser().parse_args(flags))
    ref = imagenet_k600_config()
    diff = {k for k, v in _fields(cfg).items() if _fields(ref)[k] != v}
    assert diff == {"commitment_weight"}
    assert (cfg.commitment_weight, ref.commitment_weight) == (0.25, 1.0)
    assert cfg.dtype == ref.dtype == torch.float32
