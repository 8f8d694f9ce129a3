"""The training loop (mirror of `omnitokenizer_tpu.training.loop`):
metrics logging, periodic checkpoints with auto-resume, the validation
pass, reconstruction grids and the multi-resolution resize.

    trainer = TokenizerTrainer(cfg, LossConfig(...), TrainConfig(...))
    state = train_tokenizer(trainer, batches, root_dir, max_steps=1000)

`batches` yields dicts with 'video', channels-last (B, T, H, W, C) or
(B, H, W, C) float32 arrays or tensors. Under `root_dir` the loop writes
checkpoints/step_XXXXXXXX.pt (torch.save of the state's state_dict; with
ckpt_backend='msgpack' step_XXXXXXXX.msgpack, the JAX package's
TokenizerTrainState with both optimizers' moments) every `ckpt_every`
steps and at the end, metrics.jsonl (one JSON record a logged
step), and images/train/step_XXXXXXXX.png (input above reconstruction, the
first sample's frames side by side) on a 1, 2, 4, ..., img_every, then
every img_every schedule. A run resumes from the newest checkpoint.

A VAE run's validation pass and grids decode a sample of the posterior,
its noise from a generator seeded 0 afresh at each forward, where the JAX
loop hands its forward `jax.random.PRNGKey(0)`: the same draw every call
on either side, but not the same numbers (a `torch.Generator` does not
reproduce `jax.random`). Its log and checkpoints carry what a VAE step
has: no perplexity or usage, no codebook.

Under data parallelism (a trainer built with a process group) each rank
passes its own batches (the loader strides the data by rank); the state is
rank 0's on every rank at the start and after a resume (broadcast), and
rank 0 alone logs, dumps grids, runs the validation pass and writes the
checkpoints.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import struct
import time
import zlib
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import mesh
from .trainer import TokenizerTrainState, TokenizerTrainer


def save_state(path: str, state: TokenizerTrainState) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)


def load_state(path: str, state: TokenizerTrainState) -> TokenizerTrainState:
    """Load a checkpoint into `state` (its modules on their device)."""
    device = next(state.net.parameters()).device
    state.load_state_dict(torch.load(path, map_location=device))
    return state


def check_ckpt_backend(backend: Optional[str]) -> None:
    """None (torch.save) and msgpack are written; orbax is refused."""
    if backend == "orbax":
        raise NotImplementedError(
            "--ckpt_backend orbax is not ported: Orbax writes through tensorstore, which the "
            "port does not use (ROADMAP.md, \"Not to port\"); msgpack writes the JAX "
            "package's train state, the default a torch.save .pt")
    if backend not in (None, "msgpack"):
        raise ValueError(f"unknown --ckpt_backend {backend!r}")


def save_state_msgpack(path: str, state: TokenizerTrainState, trainer: TokenizerTrainer) -> None:
    """The state as the JAX package's TokenizerTrainState msgpack (its
    training/loop.py save_state): modules, both optimizers, step and seed."""
    from ..convert import train_state_to_jax
    from ..utils.msgpack_io import write_msgpack

    write_msgpack(path, train_state_to_jax(state, trainer.opt_g, trainer.opt_d))


def load_state_msgpack(path: str, state: TokenizerTrainState,
                       trainer: TokenizerTrainer) -> TokenizerTrainState:
    """The inverse of save_state_msgpack into `state`, moments included."""
    from ..convert import load_full_train_state_from_jax
    from ..utils.msgpack_io import read_msgpack

    load_full_train_state_from_jax(read_msgpack(path), state, trainer.opt_g, trainer.opt_d)
    return state


def find_latest_checkpoint(root: str, ext: str = "pt") -> Optional[str]:
    """The newest checkpoints/step_*.<ext> under root."""
    cands = glob.glob(os.path.join(root, "checkpoints", f"step_*.{ext}"))
    if not cands:
        return None
    return max(cands, key=lambda p: int(re.findall(r"step_(\d+)", p)[0]))


def write_png(path: str, rgb: np.ndarray) -> None:
    """A (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip((img + 0.5) * 255.0, 0, 255).astype(np.uint8)


def dump_recon_grid(root: str, split: str, step: int, inputs: np.ndarray,
                    recons: np.ndarray) -> str:
    """Input strip above reconstruction strip; a clip (B, T, H, W, C) shows
    its first sample's frames side by side."""
    def strip(x):
        x = np.asarray(x)
        return np.concatenate(list(x[0]), axis=1) if x.ndim == 5 else x[0]

    grid = np.concatenate([_to_uint8(strip(inputs)), _to_uint8(strip(recons))], axis=0)
    out_dir = os.path.join(root, "images", split)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"step_{step:08d}.png")
    write_png(path, grid)
    return path


class MetricsLogger:
    """metrics.jsonl under root, and a short line on stdout every log_every;
    with wandb_project, each record mirrored into a wandb run
    (utils/wandb_logger.py: an offline run directory under root/wandb
    without the wandb package) whose config is wandb_config."""

    def __init__(self, root: str, log_every: int = 50, wandb_project: Optional[str] = None,
                 wandb_config: Optional[Dict[str, Any]] = None):
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, "metrics.jsonl")
        self.log_every = log_every
        self._f = open(self.path, "a")
        self._t0 = time.time()
        self._wandb = None
        if wandb_project:
            from ..utils.wandb_logger import WandbRun

            self._wandb = WandbRun(project=wandb_project, config=wandb_config, root=root)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 2)}
        rec.update({k: float(v) for k, v in metrics.items() if np.ndim(v) == 0})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if k != "step"}, step=step)
        if step % self.log_every == 0:
            keys = ("recon_loss", "perceptual_loss", "discloss", "perplexity", "avg_usage",
                    "g_total", "loss", "grad_norm")  # the tokenizer's, then the diffusion's
            short = {k: round(v, 4) for k, v in rec.items() if k in keys}
            print(f"[step {step}] {short}", flush=True)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def _log_schedule(every: int):
    """Steps 1, 2, 4, ..., every, then every multiple of every."""
    exp = {2 ** n for n in range(int(math.log2(max(every, 2))) + 1)}

    def should_log(step: int) -> bool:
        return step in exp or (every > 0 and step % every == 0)

    return should_log


def resize_bilinear(video: torch.Tensor, size) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, h, w, C) for size = h = w or (h, w),
    bilinear with an antialiasing filter when it shrinks, as
    jax.image.resize(..., "bilinear") does (F.interpolate's default does not
    filter)."""
    h, w = (size, size) if isinstance(size, int) else size
    B, T, H, W, C = video.shape
    x = video.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).reshape(B, T, h, w, C)


def _eval_forward(trainer: TokenizerTrainer, net, video: torch.Tensor):
    """The net's inference forward; a VAE samples its posterior from a
    generator seeded 0 (the JAX loop's PRNGKey(0))."""
    gen = (torch.Generator(device=video.device).manual_seed(0) if trainer.cfg.use_vae
           else None)
    return net(video, video.shape[1] == 1, generator=gen)


def _video(batch: Dict[str, Any], device: torch.device) -> torch.Tensor:
    video = torch.as_tensor(batch["video"], dtype=torch.float32).to(device)
    return video[:, None] if video.ndim == 4 else video


def train_tokenizer(trainer: TokenizerTrainer, batches: Iterable[Dict[str, Any]],
                    root_dir: str, max_steps: int, ckpt_every: int = 3000,
                    img_every: int = 1000, log_every: int = 50, resume: bool = True,
                    seed: int = 0, initial_state: Optional[TokenizerTrainState] = None,
                    val_batches: Optional[Iterable[Dict[str, Any]]] = None,
                    val_every: int = 2000, val_steps: int = 8,
                    wandb_project: Optional[str] = None,
                    wandb_config: Optional[Dict[str, Any]] = None,
                    ckpt_backend: Optional[str] = None) -> TokenizerTrainState:
    """Run the GAN step over a batch stream up to `max_steps`; returns the
    final state. ckpt_backend 'msgpack' writes and resumes from the JAX
    package's step_*.msgpack in place of step_*.pt; wandb_project mirrors
    the log into a wandb run."""
    check_ckpt_backend(ckpt_backend)
    ext = "msgpack" if ckpt_backend == "msgpack" else "pt"
    state = initial_state if initial_state is not None else trainer.init_state(seed=seed)
    group = trainer.group
    lead = mesh.rank_in(group) == 0
    ckpt = find_latest_checkpoint(root_dir, ext) if resume else None
    if ckpt:
        print(f"auto-resuming from {ckpt}")
        if ext == "msgpack":
            load_state_msgpack(ckpt, state, trainer)
        else:
            load_state(ckpt, state)
    if group is not None:  # rank 0's state everywhere
        for m in state.MODULES:
            mesh.replicate(getattr(state, m), group)
        mesh.replicate(state.opt_g.mu + state.opt_g.nu + state.opt_d.mu + state.opt_d.nu, group)

    def write_ckpt(step_label: int) -> None:
        if lead:
            path = os.path.join(root_dir, "checkpoints", f"step_{step_label:08d}.{ext}")
            if ext == "msgpack":
                save_state_msgpack(path, state, trainer)
            else:
                save_state(path, state)
        mesh.barrier(group)

    logger = MetricsLogger(root_dir, log_every, wandb_project, wandb_config) if lead else None
    # multi-resolution training: a random scale a step, bilinear resize
    res_scales = list(trainer.train_cfg.resolution_scale or [])
    res_rng = np.random.RandomState(seed + 17)
    should_log_img = _log_schedule(img_every)
    val_it = iter(val_batches) if val_batches is not None else None
    net = state.net

    start = state.step
    it = iter(batches)
    for step in range(start, max_steps):
        video = _video(next(it), trainer.device)
        if res_scales:
            s = float(res_rng.choice(res_scales))
            if s != 1.0:
                video = resize_bilinear(video, int(video.shape[2] * s))
        state, metrics = trainer.train_step(state, video)
        if lead:
            logger.log(step, metrics)

        if step % ckpt_every == 0 and step > start:
            write_ckpt(step)

        if not lead:
            continue
        if val_it is not None and step > start and step % val_every == 0:
            vals = []
            with torch.no_grad():
                for _ in range(val_steps):
                    vv = _video(next(val_it), trainer.device)
                    recon, aux = _eval_forward(trainer, net, vv)
                    vals.append({"val/recon_loss": float((recon.float() - vv).abs().mean()),
                                 "val/commitment_loss": float(aux["commitment_loss"])})
            agg = {k: float(np.mean([m[k] for m in vals])) for k in vals[0]}
            logger.log(step, agg)
            print(f"[val @ {step}] {agg}", flush=True)

        if img_every and should_log_img(step):
            with torch.no_grad():
                recons, _ = _eval_forward(trainer, net, video)
            dump_recon_grid(root_dir, "train", step, video.cpu().numpy(),
                            recons.float().cpu().numpy())

    write_ckpt(state.step)
    if lead:
        logger.close()
    return state
