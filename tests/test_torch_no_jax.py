"""The port imports no JAX: with jax and flax made unimportable, the package
imports and runs CPU round trips: VQ with RoPE and 'rel' positions in f32
and bf16, and the VAE through the diffusion adapter; and a bf16 GAN
training step through the trainer. Its entry-point modules (checkpoints,
CLIs, data, eval, native, inflation, media) import, `vqgan_eval.evaluate`
runs over an in-memory batch, and `vqgan_train` takes one step on PNG
files, with neither JAX nor the JAX package loaded. The LM's modules (the
GPT and its samplers, int8, Net2Net, the GPT checkpoints, transformer_eval,
the flash attention wrapper, the training loop and transformer_train)
import with JAX, flax and optax unimportable, and generate on the CPU:
class-conditional CFG ids with int8 and buckets, frame prediction, and the
CLI writing PNGs; the flash Function's gradients; transformer_train takes
a step on PNG files. The diffusion modules (the Gaussian process, the
timestep samplers, DiT, Latte, the training loop, the five CLIs) import
with JAX, flax and optax unimportable, and train, resume and sample. The
checkpoint interchange and the generation metrics (the msgpack reader and
writer, the key maps and their inverses, the loaders, convert_ckpt,
download, prec_recall, metrics_eval) import and run with jax, flax, optax
and the msgpack package unimportable: a tokenizer, a GPT and a DiT state
written in the JAX package's format, read back through the CLIs' loaders
and convert_ckpt, and metrics_eval over .npz directories. The tokenizer's
variants (einsum biases, cnn, deferred pools, pooling and up blocks) and
LatteT2V with its sample CLI run with jax, flax, optax, msgpack and
transformers unimportable: round trips in f32 and bf16, a cnn msgpack with
its BatchNorm statistics, and the CLI from random weights and from a
msgpack in bf16. VAE training (the trainer's VAE step), the CNN VQGAN (a round trip, a
Lightning checkpoint through load_cnn_vqgan_checkpoint) and the quantizer
library (FSQ, LFQ, VectorQuantize with kmeans, the residual stacks) run with
jax, flax and msgpack unimportable. The host pieces (CLIP's BPE, CoinRun
and its captions, the HDF5 families, the wandb run) run with jax, flax,
optax and msgpack unimportable: transformer_train on CoinRun captions, and
vqgan_train with --ckpt_backend msgpack and --wandb_project, resumed.
Sequence parallelism's entry points and the profiling utilities run with
jax, flax and optax unimportable."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
torch.set_num_threads(1)
from omnitokenizer_tpu_torch import DiffusionVAEAdapter, OmniTokenizerVQGAN, TokenizerConfig
from omnitokenizer_tpu_torch.ops.kernels.mha import mha
cfg = TokenizerConfig(embedding_dim=64, n_codes=64, resolution=32, sequence_length=5,
                      temporal_patch_size=2, enc_block="tw", dec_block="tt", spatial_depth=2,
                      temporal_depth=2, twod_window_size=2, heads=2, dim_head=32)
video = torch.rand(1, 3, 5, 32, 32, generator=torch.Generator().manual_seed(0)) * 2 - 1
for dtype in (torch.float32, torch.bfloat16):
    for pos in ("rope", "rel"):
        model = OmniTokenizerVQGAN.from_config(cfg.replace(dtype=dtype, spatial_pos=pos), seed=0,
                                               device="cpu")
        recon, aux = model.reconstruct(video, is_image=False)
        assert recon.shape == video.shape and bool(torch.isfinite(recon.float()).all())
        assert aux["encodings"].shape == (1, 3, 4, 4)
vae = DiffusionVAEAdapter.from_config(cfg.replace(use_vae=True), seed=0, device="cpu")
z = vae.encode(video, is_image=False)
assert z.shape == (1, 8, 3, 4, 4)
assert vae.decode(z, is_image=False).shape == video.shape
assert mha.launches == 0
from omnitokenizer_tpu_torch.config import LossConfig, TrainConfig
from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer
trainer = TokenizerTrainer(cfg.replace(dtype=torch.bfloat16),
                           LossConfig(perceptual_weight=1.0, image_gan_weight=1.0, disc_layers=2,
                                      disc_channels=16),
                           TrainConfig(warmup_lr_init=1e-5), device="cpu")
state, metrics = trainer.train_step(trainer.init_state(0), video.permute(0, 2, 3, 4, 1))
assert state.step == 1 and all(bool(torch.isfinite(v)) for v in metrics.values())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "omnitokenizer_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


ENTRY_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import argparse, importlib, os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
MODULES = ["utils.checkpoint", "utils.inflate", "utils.media", "cli.args", "cli.vqgan_eval",
           "cli.vqgan_train", "data.loader", "data.image", "data.video", "native.build",
           "eval.frechet", "eval.metrics", "eval.i3d", "eval.inception"]
for m in MODULES:
    importlib.import_module("omnitokenizer_tpu_torch." + m)
from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, TokenizerConfig
from omnitokenizer_tpu_torch.cli import vqgan_eval, vqgan_train
from omnitokenizer_tpu_torch.training.loop import write_png
cfg = TokenizerConfig(embedding_dim=64, n_codes=64, resolution=32, sequence_length=5,
                      temporal_patch_size=2, enc_block="tw", dec_block="tt", spatial_depth=2,
                      temporal_depth=2, twod_window_size=2, heads=2, dim_head=32)
model = OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cpu")
rng = np.random.RandomState(0)
with tempfile.TemporaryDirectory() as root:
    batches = [{"video": rng.uniform(-0.5, 0.5, (2, 5, 32, 32, 3)).astype(np.float32)}]
    args = argparse.Namespace(inference_type="video", save=os.path.join(root, "eval"),
                              max_batches=None, replacewithgt=0, infer_downsample=None,
                              save_videos=False, i3d_path=None, inception_path=None)
    res = vqgan_eval.evaluate(model, iter(batches), args)
    assert res["batches"] == 1 and np.isfinite(res["psnr"]) and 0 < res["codebook_usage"] <= 1
    for i in range(4):
        write_png(os.path.join(root, f"im{i}.png"), rng.randint(0, 255, (16, 16, 3), np.uint8))
    with open(os.path.join(root, "imagenet.txt"), "w") as f:
        f.write("".join(f"im{i}.png\t0\n" for i in range(4)))
    state = vqgan_train.main([
        "--embedding_dim", "16", "--n_codes", "32", "--codebook_dim", "4", "--patch_size", "4",
        "--temporal_patch_size", "2", "--enc_block", "t", "--dec_block", "t",
        "--spatial_depth", "1", "--temporal_depth", "1", "--dim_head", "8", "--heads", "2",
        "--spatial_pos", "rope", "--resolution", "16", "--sequence_length", "1",
        "--image_gan_weight", "0.1", "--video_gan_weight", "0", "--disc_layers", "1",
        "--batch_size", "2", "--num_workers", "0", "--norm_type", "batch", "--max_steps", "1",
        "--data_path", root, "--train_datalist", os.path.join(root, "imagenet.txt"),
        "--val_datalist", os.path.join(root, "imagenet.txt"),
        "--default_root_dir", os.path.join(root, "run"), "--device", "cpu"])
    assert state.step == 1
    assert os.path.exists(os.path.join(root, "run", "checkpoints", "step_00000001.pt"))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "omnitokenizer_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_entry_points_run_without_jax():
    res = subprocess.run([sys.executable, "-c", ENTRY_SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


LM_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
import glob, os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from omnitokenizer_tpu_torch import (GPT, GPTConfig, Net2NetConfig, Net2NetTransformer,
                                     OmniTokenizerVQGAN, TokenizerConfig)
from omnitokenizer_tpu_torch.cli import transformer_eval, transformer_train
from omnitokenizer_tpu_torch.models.gpt import init_weights
from omnitokenizer_tpu_torch.ops.kernels.flash_attn import flash_attention
from omnitokenizer_tpu_torch.training import lm_loop
from omnitokenizer_tpu_torch.training.loop import write_png
from omnitokenizer_tpu_torch.ops import int8
from omnitokenizer_tpu_torch.utils import gpt_checkpoint
from omnitokenizer_tpu_torch.utils.checkpoint import save_tokenizer_checkpoint
cfg = TokenizerConfig(embedding_dim=64, n_codes=64, resolution=32, sequence_length=5,
                      temporal_patch_size=2, enc_block="tw", dec_block="tt", spatial_depth=2,
                      temporal_depth=2, twod_window_size=2, heads=2, dim_head=32)
tok = OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cpu")
gcfg = GPTConfig(vocab_size=75, block_size=24, n_layer=2, n_head=2, n_embd=32)
n2n = Net2NetTransformer(Net2NetConfig(gpt=gcfg, class_cond_dim=10, first_stage_vocab_size=64,
                                       class_first=True), tok)
sample = n2n.make_class_conditional_sampler(16, top_k=8, bucket=4, int8=True)
ids = sample(torch.tensor([1, 2]), torch.Generator().manual_seed(0))
assert ids.shape == (2, 16) and 0 <= int(ids.min()) and int(ids.max()) < 64
assert n2n.decode_to_pixels(ids, is_image=True).shape == (2, 3, 32, 32)
un = Net2NetTransformer(Net2NetConfig(gpt=gcfg.replace(vocab_size=64, block_size=48),
                                      unconditional=True, first_stage_vocab_size=64), tok)
video = torch.rand(1, 3, 5, 32, 32, generator=torch.Generator().manual_seed(0)) - 0.5
grid = un.make_frame_prediction_sampler(3, 2, top_k=4, top_p=0.9, bucket=8)(
    video, torch.Generator().manual_seed(1))
assert grid.shape == (1, 3, 4, 4)
with tempfile.TemporaryDirectory() as root:
    save_tokenizer_checkpoint(os.path.join(root, "tok.pt"), tok.net, cfg)
    torch.save({"state_dict": {"transformer." + k: v for k, v in n2n.gpt.state_dict().items()}},
               os.path.join(root, "gpt.ckpt"))
    n = transformer_eval.main([
        "--gpt_ckpt", os.path.join(root, "gpt.ckpt"), "--vqvae", os.path.join(root, "tok.pt"),
        "--starts_with_sos", "--class_first", "--class_cond_dim", "10", "--block_size", "24",
        "--n_layer", "2", "--n_head", "2", "--n_embd", "32", "--sequence_length", "1",
        "--n_sample", "2", "--top_k", "8", "--decode_bucket", "4", "--int8",
        "--save", os.path.join(root, "gen"), "--device", "cpu"])
    assert n == 2 and len(glob.glob(os.path.join(root, "gen", "*.png"))) == 2
    rng = np.random.RandomState(0)
    for i in range(4):
        write_png(os.path.join(root, f"im{i}.png"), rng.randint(0, 255, (32, 32, 3), np.uint8))
    with open(os.path.join(root, "images.txt"), "w") as f:
        f.write("".join(f"im{i}.png\t{i}\n" for i in range(4)))
    state = transformer_train.main([
        "--vqvae", os.path.join(root, "tok.pt"), "--data_path", root,
        "--train_datalist", os.path.join(root, "images.txt"),
        "--default_root_dir", os.path.join(root, "lm"), "--resolution", "32",
        "--sequence_length", "1", "--batch_size", "2", "--num_workers", "0", "--block_size", "24",
        "--n_layer", "2", "--n_head", "2", "--n_embd", "32", "--class_cond_dim", "10",
        "--starts_with_sos", "--class_first", "--pkeep", "0.9", "--max_steps", "1",
        "--device", "cpu"])
    assert state.step == 1
    assert os.path.exists(os.path.join(root, "lm", "checkpoints", "step_00000001.pt"))
q = torch.randn(1, 2, 8, 16, requires_grad=True)
assert torch.autograd.grad(flash_attention(q, q, q, 0.25).sum(), q)[0].shape == q.shape
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax",
                                                              "omnitokenizer_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_lm_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", LM_SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


DIFFUSION_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
import glob, importlib, os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
MODULES = ["diffusion", "diffusion.gaussian", "diffusion.timestep_sampler", "models.dit",
           "models.latte", "training.diffusion_loop", "convert", "cli.diffusion_common",
           "cli.dit_sample", "cli.latte_sample", "cli.dit_train", "cli.latte_train"]
for m in MODULES:
    importlib.import_module("omnitokenizer_tpu_torch." + m)
from omnitokenizer_tpu_torch.cli import dit_sample, dit_train, latte_train
from omnitokenizer_tpu_torch.models.dit import DiT, DiTConfig
flags = ["--model", "DiT-S/2", "--image_size", "32", "--in_channels", "4", "--num_classes", "5",
         "--diffusion_steps", "8", "--noise_schedule", "squaredcos_cap_v2", "--device", "cpu"]
with tempfile.TemporaryDirectory() as root:
    run = os.path.join(root, "run")
    train = ["--synthetic_data", "--global_batch_size", "2", "--results_dir", run, "--log_every", "1"]
    assert dit_train.main(flags + train + ["--max_steps", "1"]).step == 1
    assert dit_train.main(flags + train + ["--max_steps", "2"]).step == 2
    n = dit_sample.main(flags + ["--ckpt", os.path.join(run, "state_000000002.pt"), "--num_samples",
                                 "2", "--num_sampling_steps", "3", "--sample_dir",
                                 os.path.join(root, "s")])
    assert n == 2 and len(glob.glob(os.path.join(root, "s", "*.npy"))) == 1
    state = latte_train.main(["--model", "Latte-S/2", "--image_size", "32", "--in_channels", "4",
                              "--num_classes", "5", "--num_frames", "5", "--diffusion_steps", "8",
                              "--noise_schedule", "squaredcos_cap_v2", "--device", "cpu", "--synthetic_data", "--global_batch_size", "1",
                              "--use_image_num", "1", "--results_dir", os.path.join(root, "l"),
                              "--max_steps", "1"])
    assert state.step == 1
m = DiT(DiTConfig(input_size=8, hidden_size=32, depth=2, num_heads=2, num_classes=10,
                  dtype=torch.bfloat16)).serving()
out = m(torch.randn(2, 4, 8, 8), torch.tensor([1, 2]), torch.tensor([3, 4]))
assert out.dtype == torch.bfloat16 and out.shape == (2, 8, 8, 8)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax",
                                                              "omnitokenizer_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_diffusion_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", DIFFUSION_SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


INTERCHANGE_SCRIPT = r"""
import sys
for name in ("jax", "flax", "optax", "msgpack"):
    sys.modules[name] = None
import importlib, json, os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
MODULES = ["utils.msgpack_io", "convert", "utils.checkpoint", "utils.gpt_checkpoint",
           "cli.convert_ckpt", "download", "eval.prec_recall", "cli.metrics_eval",
           "cli.transformer_eval", "cli.transformer_train", "cli.dit_sample", "cli.dit_train"]
for m in MODULES:
    importlib.import_module("omnitokenizer_tpu_torch." + m)
from omnitokenizer_tpu_torch import GPT, GPTConfig, OmniTokenizerVQGAN, TokenizerConfig, convert
from omnitokenizer_tpu_torch.cli import convert_ckpt, dit_sample, metrics_eval
from omnitokenizer_tpu_torch.download import resolve_checkpoint
from omnitokenizer_tpu_torch.eval.prec_recall import precision_recall
from omnitokenizer_tpu_torch.models.dit import DiT, dit_config
from omnitokenizer_tpu_torch.utils.checkpoint import config_to_json
from omnitokenizer_tpu_torch.utils.gpt_checkpoint import load_gpt_checkpoint
from omnitokenizer_tpu_torch.utils.msgpack_io import read_msgpack, write_msgpack
cfg = TokenizerConfig(embedding_dim=64, n_codes=64, resolution=32, sequence_length=5,
                      temporal_patch_size=2, enc_block="tw", dec_block="tt", spatial_depth=2,
                      temporal_depth=2, twod_window_size=2, heads=2, dim_head=32)
tok = OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cpu")
gpt = GPT(GPTConfig(vocab_size=50, block_size=24, n_layer=2, n_head=2, n_embd=32))
dcfg = dit_config("DiT-S/2", input_size=4, in_channels=4, num_classes=5)
dit = DiT(dcfg)
with tempfile.TemporaryDirectory() as root:
    p = lambda name: os.path.join(root, name)  # noqa: E731
    write_msgpack(p("tok.msgpack"), convert.state_dict_to_jax(tok.net))
    with open(p("tok.msgpack.cfg.json"), "w") as f:
        json.dump(config_to_json(cfg), f)
    back = OmniTokenizerVQGAN.load_from_checkpoint(p("tok.msgpack"), device="cpu")
    assert all(torch.equal(back.net.state_dict()[k], v) for k, v in tok.net.state_dict().items())
    write_msgpack(p("gpt.msgpack"), (convert.gpt_state_dict_to_jax(gpt.state_dict()), None, 0))
    sd = load_gpt_checkpoint(p("gpt.msgpack"))
    assert all(torch.equal(sd[k], v) for k, v in gpt.state_dict().items())
    tree = convert.dit_state_dict_to_jax(dit.state_dict(), 2)
    write_msgpack(p("dit.msgpack"), {"params": tree, "ema_params": tree, "opt_state": {},
                                     "step": np.asarray(3, np.int32)})
    assert int(read_msgpack(p("dit.msgpack"))["step"]) == 3
    convert_ckpt.main(["--src", p("tok.msgpack"), "--dst", p("tok.pt")])
    convert_ckpt.main(["--kind", "dit", "--src", p("dit.msgpack"), "--dst", p("dit.pt")])
    assert dit_sample.main(["--model", "DiT-S/2", "--image_size", "32", "--in_channels", "4",
                            "--num_classes", "5", "--ckpt", p("dit.msgpack"), "--num_samples",
                            "1", "--num_sampling_steps", "2", "--diffusion_steps", "8",
                            "--noise_schedule", "squaredcos_cap_v2", "--sample_dir", p("s"),
                            "--device", "cpu"]) == 1
    assert resolve_checkpoint(p("tok.pt")) == p("tok.pt")
    rng = np.random.RandomState(0)
    for d in ("gen", "gt"):
        os.makedirs(p(d))
        for i in range(2):
            np.savez(os.path.join(p(d), f"{i}.npz"),
                     video=rng.uniform(-0.5, 0.5, (3, 16, 16, 3)).astype(np.float32))
    res = metrics_eval.main(["--gen_dir", p("gen"), "--gt_dir", p("gt"), "--metrics",
                             "psnr,ssim", "--device", "cpu"])
    assert res["clips"] == 2 and np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
prec, rec = precision_recall(rng.randn(30, 8), rng.randn(20, 8), device="cpu")
assert 0 <= prec <= 1 and 0 <= rec <= 1
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "msgpack",
                                                              "omnitokenizer_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_interchange_and_metrics_run_without_jax():
    res = subprocess.run([sys.executable, "-c", INTERCHANGE_SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


VARIANTS_SCRIPT = r"""
import sys
for name in ("jax", "flax", "optax", "msgpack", "transformers"):
    sys.modules[name] = None
import json, os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, TokenizerConfig, convert
from omnitokenizer_tpu_torch.cli import latte_t2v_sample
from omnitokenizer_tpu_torch.models.latte_t2v import LatteT2V
from omnitokenizer_tpu_torch.ops.bias import alibi_bias
from omnitokenizer_tpu_torch.utils.checkpoint import config_to_json
from omnitokenizer_tpu_torch.utils.msgpack_io import write_msgpack
cfg = TokenizerConfig(embedding_dim=64, n_codes=64, resolution=32, sequence_length=5,
                      temporal_patch_size=2, enc_block="ta", dec_block="nt", spatial_depth=2,
                      temporal_depth=2, heads=2, dim_head=32, spatial_pos="rel")
video = torch.rand(1, 3, 5, 32, 32, generator=torch.Generator().manual_seed(0)) * 2 - 1
for kw in (dict(attn_bias_mode="einsum"), dict(patch_embed="cnn", enc_block="tt", dec_block="tt"),
           dict(defer_temporal_pool=True, defer_spatial_pool=True, enc_block="tt",
                dec_block="tt"), {}):
    for dtype in (torch.float32, torch.bfloat16):
        model = OmniTokenizerVQGAN.from_config(cfg.replace(dtype=dtype, **kw), seed=0,
                                               device="cpu")
        recon, aux = model.reconstruct(video, is_image=False)
        assert recon.shape == video.shape and bool(torch.isfinite(recon.float()).all()), kw
assert alibi_bias(6, 5, 5).shape == (6, 5, 5)
with tempfile.TemporaryDirectory() as root:
    cnn = cfg.replace(patch_embed="cnn", enc_block="tt", dec_block="tt")
    tok = OmniTokenizerVQGAN.from_config(cnn, seed=0, device="cpu")
    path = os.path.join(root, "cnn.msgpack")
    write_msgpack(path, convert.state_dict_to_jax(tok.net))
    with open(path + ".cfg.json", "w") as f:
        json.dump(config_to_json(cnn), f)
    back = OmniTokenizerVQGAN.load_from_checkpoint(path, device="cpu")
    assert all(torch.equal(back.net.state_dict()[k], v) for k, v in tok.net.state_dict().items())
    flags = ["--num_layers", "1", "--num_attention_heads", "2", "--attention_head_dim", "8",
             "--caption_channels", "16", "--image_size", "32", "--video_length", "2",
             "--num_sampling_steps", "2", "--max_token_length", "6", "--device", "cpu",
             "--save_img_path", root]
    z = latte_t2v_sample.main(flags)
    assert z.shape == (1, 2, 4, 4, 4) and np.isfinite(z).all()
    model = LatteT2V(latte_t2v_sample.load_t2v_config(
        latte_t2v_sample.build_parser().parse_args(flags), torch.float32))
    write_msgpack(os.path.join(root, "t2v.msgpack"),
                  {"params": convert.latte_t2v_state_dict_to_jax(model.state_dict())})
    z = latte_t2v_sample.main(flags + ["--ckpt", os.path.join(root, "t2v.msgpack"), "--bf16"])
    assert np.isfinite(z).all()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "msgpack",
                                                              "transformers", "omnitokenizer_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_variants_and_t2v_run_without_jax():
    res = subprocess.run([sys.executable, "-c", VARIANTS_SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


LAST_SLICE_SCRIPT = r"""
import sys
for name in ("jax", "flax", "optax", "msgpack"):
    sys.modules[name] = None
import argparse, os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from omnitokenizer_tpu_torch import VQGAN, TokenizerConfig, load_cnn_vqgan_checkpoint
from omnitokenizer_tpu_torch.config import LossConfig, TrainConfig
from omnitokenizer_tpu_torch.models.cnn_vqgan import convert_cnn_vqgan_state, init_cnn_vqgan
from omnitokenizer_tpu_torch.ops import quantizers as Q
from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer

cfg = TokenizerConfig(embedding_dim=64, n_codes=64, resolution=32, sequence_length=5,
                      temporal_patch_size=2, enc_block="tw", dec_block="tt", spatial_depth=2,
                      temporal_depth=2, twod_window_size=2, heads=2, dim_head=32,
                      use_vae=True, kl_weight=1e-6)
trainer = TokenizerTrainer(cfg, LossConfig(perceptual_weight=1.0, image_gan_weight=1.0,
                                           disc_layers=2, disc_channels=16),
                           TrainConfig(warmup_lr_init=1e-5), device="cpu")
video = torch.rand(1, 5, 32, 32, 3, generator=torch.Generator().manual_seed(0)) - 0.5
state, metrics = trainer.train_step(trainer.init_state(0), video)
assert state.step == 1 and state.net.codebook is None and "perplexity" not in metrics
assert all(bool(torch.isfinite(v)) for v in metrics.values())

model = init_cnn_vqgan(VQGAN(TokenizerConfig(embedding_dim=16, codebook_dim=16, n_codes=32,
                                             norm_type="group"),
                             n_hiddens=32, downsample=(2, 4, 4)), torch.Generator().manual_seed(0))
x = torch.rand(1, 4, 16, 16, 3) - 0.5
with torch.no_grad():
    idx = model.encode(x)
    assert idx.shape == (1, 2, 4, 4) and model.decode(idx).shape == x.shape
with tempfile.TemporaryDirectory() as root:
    path = os.path.join(root, "cnn.ckpt")
    ref = {}  # the reference's names for this small model
    names = {"encoder.conv_first.conv": "encoder.conv_first.conv", "pre_vq_conv.conv": "pre_vq_conv.conv",
             "post_vq_conv.conv": "post_vq_conv.conv", "decoder.conv_last.conv": "decoder.conv_last.conv",
             "encoder.final_norm": "encoder.final_block.0", "decoder.final_norm": "decoder.final_block.0"}
    for i in range(2):
        names[f"encoder.down{i}.conv"] = f"encoder.conv_blocks.{i}.down.conv"
        names[f"encoder.res{i}"] = f"encoder.conv_blocks.{i}.res"
        names[f"decoder.res{i}a"] = f"decoder.conv_blocks.{i}.res1"
        names[f"decoder.res{i}b"] = f"decoder.conv_blocks.{i}.res2"
    leaf = {"scale": "weight", "bias": "bias", "weight": "weight"}  # GroupNorm's scale
    for k, v in model.state_dict().items():
        if k.startswith("codebook."):
            if k.split(".")[1] in ("embeddings", "N", "z_avg", "codebook_usage"):
                ref[k] = v
            continue
        if k.startswith("decoder.up"):
            i, l = k[len("decoder.up"):].split(".")
            ref[f"decoder.conv_blocks.{i}.up.convt.{l}"] = (
                v.transpose(0, 1).flip(2, 3, 4) if l == "weight" else v)
            continue
        base = max((b for b in names if k.startswith(b + ".")), key=len)
        ref[names[base] + k[len(base):-len(k.rsplit(".", 1)[1])] + leaf[k.rsplit(".", 1)[1]]] = v
    torch.save({"state_dict": ref, "hyper_parameters": {"args": argparse.Namespace(
        n_hiddens=32, downsample=[2, 4, 4], embedding_dim=16, n_codes=32,
        norm_type="group")}}, path)
    loaded = load_cnn_vqgan_checkpoint(path, device="cpu")
    with torch.no_grad():
        assert torch.equal(loaded.encode(x), idx)

z = torch.randn(256, 8, generator=torch.Generator().manual_seed(1))
assert Q.FSQ((8, 5, 5, 5))(z[:, :4])["encodings"].shape == (256,)
assert Q.LFQ(8)(z, training=True)["encodings"].max() < 256
vq = Q.VectorQuantize(8, 16)
out, st = vq(z, vq.init_state(torch.Generator().manual_seed(2)), training=True,
             generator=torch.Generator().manual_seed(3))
assert int(st.initialized) == 1 and out["encodings"].shape == (256,)
rvq = Q.ResidualVQ(8, 16, 3, use_cosine_sim=True)
out, states = rvq(z, rvq.init_state(torch.Generator().manual_seed(4)), training=True,
                  generators=[torch.Generator().manual_seed(5 + i) for i in range(3)])
assert out["encodings"].shape == (256, 3) and len(states) == 3
assert Q.ResidualFSQ((8, 5, 5, 5), 2)(z[:, :4])["encodings"].shape == (256, 2)
assert Q.ResidualLFQ(8, 2)(z, training=True)["encodings"].shape == (256, 2)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "msgpack",
                "omnitokenizer_tpu") and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_vae_training_cnn_vqgan_and_quantizers_run_without_jax():
    res = subprocess.run([sys.executable, "-c", LAST_SLICE_SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


PARALLEL_SCRIPT = r"""
import sys
for m in ("jax", "flax", "optax"):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
from omnitokenizer_tpu_torch.parallel import dryrun, mesh, pp, tp
from omnitokenizer_tpu_torch.ops.codebook import Codebook, vq_argmin_sharded
from omnitokenizer_tpu_torch.ops.kernels.vq_argmin import vq_argmin_plain
from omnitokenizer_tpu_torch.training import lm_loop
group = mesh.init_distributed("cpu", world_of_one=True)
assert group is not None and mesh.world() == 1 and mesh.rank() == 0
g = torch.Generator().manual_seed(0)
flat, emb = torch.randn(64, 8, generator=g), torch.randn(32, 8, generator=g)
assert torch.equal(vq_argmin_sharded(flat, emb, group), vq_argmin_plain(flat, emb))
z = torch.randn(2, 2, 4, 4, 8, generator=g)
a, b = Codebook(32, 8), Codebook(32, 8)
b.load_state_dict(a.state_dict())
out_a = a(z, training=True, generator=torch.Generator().manual_seed(1), group=group)
out_b = b(z, training=True, generator=torch.Generator().manual_seed(1))
assert torch.equal(out_a["encodings"], out_b["encodings"])
assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
sd = {f"blocks.{i}.w": torch.full((2,), float(i)) for i in range(4)}
stacked, rest = pp.stack_block_params(sd, 4)
assert torch.equal(pp.unstack_block_params(stacked, rest, 4)["blocks.3.w"], sd["blocks.3.w"])
assert tp.gpt_param_dims({"head.weight": (9193, 8)}, 2)["head.weight"] is None
mesh.shutdown()
assert callable(dryrun.dryrun_multichip)  # run over 2 processes: tests/test_torch_parallel_dp.py
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax",
                                                             "omnitokenizer_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_parallel_runs_without_jax():
    """parallel/ (mesh, tp, pp, dryrun) and the grouped codebook import and run
    with jax, flax and optax unimportable: a world of one over gloo (the
    grouped codebook bit-equal to the ungrouped one, the sharded argmin equal
    to the plain search). (The dry run's ranks import the port alone.)"""
    res = subprocess.run([sys.executable, "-c", PARALLEL_SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


HOST_SCRIPT = r"""
import sys
for name in ("jax", "flax", "optax", "msgpack"):
    sys.modules[name] = None
import glob, json, os, tempfile
import h5py
import numpy as np
import torch
from PIL import Image
torch.set_num_threads(1)
from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, TokenizerConfig
from omnitokenizer_tpu_torch.cli import transformer_train, vqgan_train
from omnitokenizer_tpu_torch.data import coinrun, hdf5, text_tokenizer
from omnitokenizer_tpu_torch.data.coinrun_text import describe_clip
from omnitokenizer_tpu_torch.training.loop import write_png
from omnitokenizer_tpu_torch.utils.checkpoint import save_tokenizer_checkpoint
from omnitokenizer_tpu_torch.utils.wandb_logger import WandbRun

cfg = TokenizerConfig(embedding_dim=32, n_codes=32, resolution=32, sequence_length=5,
                      temporal_patch_size=2, enc_block="t", dec_block="t", spatial_depth=1,
                      temporal_depth=1, heads=2, dim_head=16)
rng = np.random.RandomState(0)
with tempfile.TemporaryDirectory() as root:
    text_tokenizer.VOCAB_DIR = root
    with open(os.path.join(root, text_tokenizer.VOCAB_NAME), "w") as f:
        f.write("#version: 0.2\nm u\nmu g\nmug e\nmuge n</w>\nr u\nru n\n")
    tk = text_tokenizer.SimpleTokenizer()
    assert tk.encode("Mugen runs") == [tk.encoder["mugen</w>"], tk.encoder["run"],
                                       tk.encoder["s</w>"]]
    game = {"zoom": 5.5, "world_theme_n": 0, "agent_theme_n": 0,
            "background_themes": ["bg.png"], "ground_themes": ["Grass"],
            "agent_themes": ["Beige"], "monster_names": {"ground": ["bee"]},
            "maze": ["A" * 64, "S" * 64] + ["." * 30 + "1=" + "." * 32] * 11,
            "frames": [{"agent": {"x": 28.0 + i, "y": 2.0, "vx": 1.0, "time_alive": i},
                        "monsters": [{"m_id": 0, "x": 33.0, "y": 2.0}]} for i in range(6)]}
    data = os.path.join(root, "coinrun_train")
    os.makedirs(data)
    for i in range(4):
        with open(os.path.join(data, f"g{i}.json"), "w") as f:
            json.dump(game, f)
    paths = coinrun.asset_paths(coinrun.Game(**game))
    rels = [paths["background"], *paths["world"].values(), *paths["alien"].values()]
    rels += [p.replace(".png", s + ".png") for p in paths["monster"].values()
             for s in ("", "_move", "_dead")]
    for rel in rels:
        p = os.path.join(data, "assets", rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (12, 12, 4), np.uint8), "RGBA").save(p)
    sample = coinrun.CoinRunDataset(data, os.path.join(data, "assets"), 5, 32,
                                    get_text_desc=True, text_seq_len=8)[0]
    assert sample["video"].shape == (5, 32, 32, 3) and sample["text"].shape == (8,)
    assert describe_clip(coinrun.Game(**game)) == "Mugen runs to the right."
    save_tokenizer_checkpoint(os.path.join(root, "tok.pt"),
                              OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cpu").net, cfg)
    state = transformer_train.main([
        "--vqvae", os.path.join(root, "tok.pt"), "--data_path", data, "--train_datalist", "x",
        "--default_root_dir", os.path.join(root, "lm"), "--resolution", "32",
        "--sequence_length", "5", "--batch_size", "2", "--num_workers", "0", "--text_cond",
        "--cond_stage_key", "text", "--text_seq_len", "8", "--class_cond_dim", "49408",
        "--starts_with_sos", "--block_size", "57", "--n_layer", "1", "--n_head", "2",
        "--n_embd", "32", "--max_steps", "1", "--device", "cpu"])
    assert state.step == 1

    h5 = os.path.join(root, "clips.h5")
    with h5py.File(h5, "w") as f:
        f["train_data"] = rng.randint(0, 256, (12, 40, 36, 3)).astype(np.uint8)
        f["train_idx"] = np.asarray([0, 6, 12])
        f.create_dataset("train_text", data=["a dog", "a cat"], dtype=h5py.string_dtype())
    s = hdf5.HDF5DatasetText(h5, 4, resolution=32)[1]
    assert s["video"].shape == (4, 32, 32, 3) and s["text"].shape == (77,)

    for i in range(4):
        write_png(os.path.join(root, f"im{i}.png"), rng.randint(0, 255, (32, 32, 3), np.uint8))
    with open(os.path.join(root, "images.txt"), "w") as f:
        f.write("".join(f"im{i}.png\t{i}\n" for i in range(4)))
    run = os.path.join(root, "vq")
    flags = ["--data_path", root, "--train_datalist", os.path.join(root, "images.txt"),
             "--val_datalist", "none", "--default_root_dir", run, "--resolution", "32",
             "--sequence_length", "1", "--batch_size", "2", "--num_workers", "0",
             "--embedding_dim", "32", "--n_codes", "32", "--enc_block", "t", "--dec_block", "t",
             "--spatial_depth", "1", "--temporal_depth", "1", "--heads", "2",
             "--dim_head", "16", "--disc_layers", "1", "--disc_channels", "32",
             "--ckpt_backend", "msgpack", "--wandb_project", "omnitokenizer", "--device", "cpu"]
    vqgan_train.main(flags + ["--max_steps", "1"])
    state = vqgan_train.main(flags + ["--max_steps", "2"])
    assert state.step == 2 and state.opt_g.count == 2
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(run, "checkpoints", "*")))
    assert names == ["step_00000001.msgpack", "step_00000002.msgpack"], names
    hist = glob.glob(os.path.join(run, "wandb", "run-*", "history.jsonl"))
    assert sum(len(open(h).readlines()) for h in hist) == 2
    run = WandbRun(project="p", config={"a": 1}, root=root, mode="offline")
    run.log({"x": 1.0})
    run.finish()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "msgpack",
                "omnitokenizer_tpu") and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_host_pieces_run_without_jax():
    res = subprocess.run([sys.executable, "-c", HOST_SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


SP_PROFILING_SCRIPT = r"""
import sys
for name in ("jax", "flax", "optax"):
    sys.modules[name] = None
import tempfile
import torch
torch.set_num_threads(1)
from omnitokenizer_tpu_torch import OmniTokenizerVQGAN, TokenizerConfig
from omnitokenizer_tpu_torch.parallel import mesh, tp
from omnitokenizer_tpu_torch.utils import profiling, trace_analysis
group = mesh.init_distributed("cpu", world_of_one=True)
assert tp.seq_parallel(group) is None  # a model group of one runs the one-process path
x = torch.rand(1, 3, 16, 16, 3, generator=torch.Generator().manual_seed(0))
assert torch.equal(tp.sp_gather(tp.sp_shard_pixels(x, group), group, 2), x)
cfg = TokenizerConfig(embedding_dim=16, n_codes=32, codebook_dim=4, resolution=16,
                      sequence_length=3, patch_size=4, temporal_patch_size=2, enc_block="t",
                      dec_block="t", spatial_depth=1, temporal_depth=1, dim_head=8, heads=2)
model = OmniTokenizerVQGAN.from_config(cfg, seed=0, device="cpu")
with tempfile.TemporaryDirectory() as d:
    with profiling.trace(d):
        with profiling.annotate("round_trip"):
            recon, _ = model.net(x, False, sp=tp.seq_parallel(group))
    events = trace_analysis.load_trace_events(d)
assert "round_trip" in {e.get("name") for e in events}
assert trace_analysis.op_table(events)[0]["name"] == "TOTAL"
mesh.shutdown()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax",
                                                             "omnitokenizer_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_sp_and_profiling_run_without_jax():
    """parallel/tp.py's sequence-parallel entry points and the profiling
    utilities (utils/profiling.py, utils/trace_analysis.py) import and run
    with jax, flax and optax unimportable: a model group of one runs the
    one-process forward, traced and read back. (The SP ranks of
    tests/test_torch_parallel_sp.py import the port alone.)"""
    res = subprocess.run([sys.executable, "-c", SP_PROFILING_SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
