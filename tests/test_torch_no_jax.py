"""The port imports no JAX: with jax and flax made unimportable, the package
imports and runs CPU round trips: VQ with RoPE and 'rel' positions in f32
and bf16, and the VAE through the diffusion adapter; and a bf16 GAN
training step through the trainer."""

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
