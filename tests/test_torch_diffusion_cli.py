"""The port's DiT/Latte train and sample CLIs on the CPU (--device cpu), at
tests/test_diffusion_cli.py's TINY flags on synthetic latents: dit_train
for 2 steps, a resume to 3, then dit_sample (DDIM, CFG) writing latents;
latte_train / latte_sample with and without --use_image_num; dit_sample
through a small random VAE adapter writing PNGs, and dit_train's step on
pixels encoded through it; --init_from a reference checkpoint. The
synthetic latents are the JAX CLI's draws. The CLIs run on the card by
default and raise without one."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from omnitokenizer_tpu_torch.cli import (diffusion_common, dit_sample, dit_train, latte_sample,
                                         latte_train)

torch.set_num_threads(1)

TINY = [
    "--model", "DiT-S/2", "--image_size", "32", "--in_channels", "4",
    "--num_classes", "5", "--synthetic_data", "--global_batch_size", "4",
    "--diffusion_steps", "8", "--noise_schedule", "squaredcos_cap_v2", "--device", "cpu",
]
LTINY = [
    "--model", "Latte-S/2", "--image_size", "32", "--in_channels", "4",
    "--num_classes", "5", "--num_frames", "5", "--extras", "2",
    "--synthetic_data", "--global_batch_size", "2",
    "--diffusion_steps", "8", "--noise_schedule", "squaredcos_cap_v2", "--device", "cpu",
]
SAMPLE = ["--diffusion_steps", "8", "--noise_schedule", "squaredcos_cap_v2", "--device", "cpu",
          "--num_sampling_steps", "4"]


def _metrics(root):
    return [json.loads(line) for line in open(os.path.join(root, "metrics.jsonl"))]


def test_dit_train_resume_and_sample(tmp_path):
    results = str(tmp_path / "dit")
    state = dit_train.main(TINY + ["--results_dir", results, "--max_steps", "2",
                                   "--ckpt_every", "2", "--log_every", "1"])
    assert state.step == 2
    ckpt = os.path.join(results, "state_000000002.pt")
    assert os.path.exists(ckpt)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = dit_train.main(TINY + ["--results_dir", results, "--max_steps", "3",
                                   "--ckpt_every", "3", "--log_every", "1"])
    assert state.step == 3 and os.path.exists(os.path.join(results, "state_000000003.pt"))
    # resumed from the step-2 state: one more step moved every parameter from it
    moved = [not torch.equal(before[k], v) for k, v in state.model.state_dict().items()]
    assert sum(moved) > 0.9 * len(moved)
    lines = _metrics(results)
    assert [l["step"] for l in lines] == [1, 2, 3] and all(np.isfinite(l["loss"]) for l in lines)

    samples = str(tmp_path / "dit_samples")
    made = dit_sample.main(["--model", "DiT-S/2", "--image_size", "32", "--in_channels", "4",
                            "--num_classes", "5", "--ckpt", ckpt, "--num_samples", "3",
                            "--per_proc_batch_size", "2", "--ddim", "--cfg_scale", "2.0",
                            "--sample_dir", samples] + SAMPLE)
    assert made == 3
    latents = sorted(glob.glob(os.path.join(samples, "latents_*.npy")))
    assert len(latents) == 2
    z = np.load(latents[0])
    assert z.shape == (2, 4, 4, 4) and np.isfinite(z).all()  # channels-first


@pytest.mark.parametrize("use_image_num", [0, 2])
def test_latte_train_and_sample(tmp_path, use_image_num):
    results = str(tmp_path / "latte")
    state = latte_train.main(LTINY + ["--results_dir", results, "--max_steps", "2",
                                      "--ckpt_every", "2", "--log_every", "1",
                                      "--use_image_num", str(use_image_num)])
    assert state.step == 2 and all(np.isfinite(l["loss"]) for l in _metrics(results))
    state = latte_train.main(LTINY + ["--results_dir", results, "--max_steps", "3",
                                      "--ckpt_every", "3", "--log_every", "1",
                                      "--use_image_num", str(use_image_num)])
    assert state.step == 3
    samples = str(tmp_path / "latte_samples")
    made = latte_sample.main(["--model", "Latte-S/2", "--image_size", "32", "--in_channels",
                              "4", "--num_classes", "5", "--num_frames", "5", "--extras", "2",
                              "--ckpt", os.path.join(results, "state_000000003.pt"),
                              "--num_samples", "1", "--per_proc_batch_size", "1",
                              "--cfg_scale", "2.0", "--sample_dir", samples] + SAMPLE)
    assert made == 1
    z = np.load(glob.glob(os.path.join(samples, "latents_*.npy"))[0])
    assert z.shape == (1, 2, 4, 4, 4) and np.isfinite(z).all()  # latent frames 1 + (5-1)//4


def test_synthetic_latents_are_the_jax_cli_draws():
    from omnitokenizer_tpu.cli import diffusion_common as jcommon
    from omnitokenizer_tpu.models.dit import dit_config as jdit_config
    from omnitokenizer_tpu.models.latte import latte_config as jlatte_config
    from omnitokenizer_tpu_torch.models.dit import dit_config
    from omnitokenizer_tpu_torch.models.latte import latte_config

    for video, ours, theirs in ((False, dit_config("DiT-S/2", input_size=4),
                                 jdit_config("DiT-S/2", input_size=4)),
                                (True, latte_config("Latte-S/2", input_size=4, num_frames=2),
                                 jlatte_config("Latte-S/2", input_size=4, num_frames=2))):
        got = diffusion_common.synthetic_latents(np.random.RandomState(3), 2, ours, video)
        want = jcommon.synthetic_latents(np.random.RandomState(3), 2, theirs, video)
        np.testing.assert_array_equal(np.moveaxis(got, 2 if video else 1, -1), want)


@pytest.fixture(scope="module")
def vae_ckpt(tmp_path_factory):
    """A small VAE-mode tokenizer (8 latent channels, patch 8) with random
    weights, saved as a checkpoint the adapter loads."""
    from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, TokenizerConfig
    from omnitokenizer_tpu_torch.utils.checkpoint import save_tokenizer_checkpoint

    cfg = TokenizerConfig(embedding_dim=32, n_codes=32, resolution=32, sequence_length=5,
                          patch_size=8, temporal_patch_size=4, enc_block="t", dec_block="t",
                          spatial_depth=1, temporal_depth=1, heads=2, dim_head=16, use_vae=True)
    path = str(tmp_path_factory.mktemp("vae") / "vae.pt")
    save_tokenizer_checkpoint(path, OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cpu").net,
                              cfg)
    return path


def test_dit_through_the_vae(tmp_path, vae_ckpt):
    """dit_train's step on pixel batches encoded through the adapter, then
    dit_sample decoding its samples into PNGs: byte for byte utils/media's
    to_uint8 of the adapter's decode of the same latents (the run without a
    VAE writes them), each inside the grid's 1-pixel black border."""
    from omnitokenizer_tpu_torch.models.diffusion_adapter import DiffusionVAEAdapter

    flags = ["--model", "DiT-S/2", "--image_size", "32", "--in_channels", "8",
             "--num_classes", "5", "--diffusion_steps", "8", "--noise_schedule",
             "squaredcos_cap_v2", "--device", "cpu"]
    results = str(tmp_path / "run")
    args = dit_train.build_parser().parse_args(flags + ["--results_dir", results, "--max_steps",
                                                        "2", "--ckpt_every", "2",
                                                        "--log_every", "1"])
    model, _ = diffusion_common.build_model(args, video=False)
    adapter = DiffusionVAEAdapter.load_from_checkpoint(vae_ckpt, device="cpu")
    rng = np.random.RandomState(0)
    batches = [{"video": rng.uniform(-0.5, 0.5, (2, 1, 32, 32, 3)).astype(np.float32),
                "label": np.array([1, 3])}]  # one batch, read twice: two epochs
    state = dit_train.train(args, model, adapter, batches)
    assert state.step == 2 and all(np.isfinite(l["loss"]) for l in _metrics(results))

    samples = str(tmp_path / "png")
    made = dit_sample.main(flags[:-6] + ["--ckpt", os.path.join(results, "state_000000002.pt"),
                                         "--vae_ckpt", vae_ckpt, "--num_samples", "2",
                                         "--per_proc_batch_size", "2", "--classes", "4",
                                         "--sample_dir", samples] + SAMPLE)
    assert made == 2
    pngs = sorted(glob.glob(os.path.join(samples, "*.png")))
    assert [os.path.basename(p) for p in pngs] == ["00_00000_c4.png", "00_00001_c4.png"]
    from PIL import Image

    from omnitokenizer_tpu_torch.utils.media import to_uint8

    latents = str(tmp_path / "latents")
    dit_sample.main(flags[:-6] + ["--ckpt", os.path.join(results, "state_000000002.pt"),
                                  "--num_samples", "2", "--per_proc_batch_size", "2",
                                  "--classes", "4", "--sample_dir", latents] + SAMPLE)
    z = torch.from_numpy(np.load(os.path.join(latents, "latents_00_00000.npy")))
    with torch.inference_mode():
        pixels = diffusion_common.decode_batch_fn(adapter, False)(z).float().numpy()
    want = to_uint8(np.moveaxis(pixels, 1, -1))  # (2, 32, 32, 3)
    for i, png in enumerate(pngs):
        img = np.asarray(Image.open(png))
        assert img.shape == (34, 34, 3) and img.dtype == np.uint8 and img.std() > 0
        assert np.array_equal(img[1:33, 1:33], want[i])
        border = np.ones((34, 34), bool)
        border[1:33, 1:33] = False
        assert not img[border].any()


def test_encode_decode_layouts(vae_ckpt):
    """The seam: pixels x2 into the VAE, latents channels-first per frame,
    decoded pixels x0.5 within [-0.5, 0.5]."""
    from omnitokenizer_tpu_torch.models.diffusion_adapter import DiffusionVAEAdapter

    ad = DiffusionVAEAdapter.load_from_checkpoint(vae_ckpt, device="cpu")
    clip = torch.rand(1, 3, 5, 32, 32, generator=torch.Generator().manual_seed(1)) - 0.5
    z = diffusion_common.encode_batch_fn(ad, True)(clip)
    assert z.shape == (1, 2, 8, 4, 4)
    torch.testing.assert_close(z, ad.encode(clip * 2, is_image=False).permute(0, 2, 1, 3, 4))
    x = diffusion_common.decode_batch_fn(ad, True)(z)
    assert x.shape == clip.shape and float(x.abs().max()) <= 0.5
    want = (ad.decode(z.permute(0, 2, 1, 3, 4), is_image=False) * 0.5).clamp(-0.5, 0.5)
    torch.testing.assert_close(x, want)


def test_init_from_a_reference_checkpoint(tmp_path):
    """--init_from reads a reference train-script .pt (its EMA) into the
    parameters before the first step; the fixed pos_embed is recomputed."""
    from omnitokenizer_tpu_torch.models.dit import dit_config
    from torch_port_util import reference_diffusion_state_dict

    sd = reference_diffusion_state_dict(dit_config("DiT-S/2", input_size=4, in_channels=4,
                                                   num_classes=5))
    path = str(tmp_path / "ref.pt")
    torch.save({"ema": {k: torch.from_numpy(v) for k, v in sd.items()}, "model": {}}, path)
    state = dit_train.main(TINY + ["--results_dir", str(tmp_path / "run"), "--max_steps", "0",
                                   "--init_from", path])
    assert state.step == 0
    got = state.model.state_dict()
    assert set(got) == set(sd) - {"pos_embed"}
    for k, v in got.items():
        assert torch.equal(v, torch.from_numpy(sd[k])), k


def test_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dit_train.main([f for f in TINY if f not in ("--device", "cpu")]
                       + ["--results_dir", str(tmp_path), "--max_steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dit_sample.main(["--model", "DiT-S/2", "--ckpt", str(tmp_path / "x.pt")])
