"""The training loop (mirror of `omnitokenizer_tpu.training.loop`):
metrics logging, periodic checkpoints with auto-resume, the validation
pass, reconstruction grids and the multi-resolution resize.

    trainer = TokenizerTrainer(cfg, LossConfig(...), TrainConfig(...))
    state = train_tokenizer(trainer, batches, root_dir, max_steps=1000)

`batches` yields dicts with 'video', channels-last (B, T, H, W, C) or
(B, H, W, C) float32 arrays or tensors. Under `root_dir` the loop writes
checkpoints/step_XXXXXXXX.pt (torch.save of the state's state_dict) every
`ckpt_every` steps and at the end, metrics.jsonl (one JSON record a logged
step), and images/train/step_XXXXXXXX.png (input above reconstruction, the
first sample's frames side by side) on a 1, 2, 4, ..., img_every, then
every img_every schedule. A run resumes from the newest checkpoint.
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


def find_latest_checkpoint(root: str) -> Optional[str]:
    """The newest checkpoints/step_*.pt under root."""
    cands = glob.glob(os.path.join(root, "checkpoints", "step_*.pt"))
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
    """metrics.jsonl under root, and a short line on stdout every log_every."""

    def __init__(self, root: str, log_every: int = 50):
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, "metrics.jsonl")
        self.log_every = log_every
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 2)}
        rec.update({k: float(v) for k, v in metrics.items() if np.ndim(v) == 0})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if step % self.log_every == 0:
            keys = ("recon_loss", "perceptual_loss", "discloss", "perplexity", "avg_usage",
                    "g_total")
            short = {k: round(v, 4) for k, v in rec.items() if k in keys}
            print(f"[step {step}] {short}", flush=True)

    def close(self) -> None:
        self._f.close()


def _log_schedule(every: int):
    """Steps 1, 2, 4, ..., every, then every multiple of every."""
    exp = {2 ** n for n in range(int(math.log2(max(every, 2))) + 1)}

    def should_log(step: int) -> bool:
        return step in exp or (every > 0 and step % every == 0)

    return should_log


def resize_bilinear(video: torch.Tensor, size: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, size, size, C), bilinear with an
    antialiasing filter when it shrinks, as jax.image.resize(..., "bilinear")
    does (F.interpolate's default does not filter)."""
    B, T, H, W, C = video.shape
    x = video.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1).reshape(B, T, size, size, C)


def _video(batch: Dict[str, Any], device: torch.device) -> torch.Tensor:
    video = torch.as_tensor(batch["video"], dtype=torch.float32).to(device)
    return video[:, None] if video.ndim == 4 else video


def train_tokenizer(trainer: TokenizerTrainer, batches: Iterable[Dict[str, Any]],
                    root_dir: str, max_steps: int, ckpt_every: int = 3000,
                    img_every: int = 1000, log_every: int = 50, resume: bool = True,
                    seed: int = 0, initial_state: Optional[TokenizerTrainState] = None,
                    val_batches: Optional[Iterable[Dict[str, Any]]] = None,
                    val_every: int = 2000, val_steps: int = 8) -> TokenizerTrainState:
    """Run the GAN step over a batch stream up to `max_steps`; returns the
    final state."""
    state = initial_state if initial_state is not None else trainer.init_state(seed=seed)
    ckpt = find_latest_checkpoint(root_dir) if resume else None
    if ckpt:
        print(f"auto-resuming from {ckpt}")
        load_state(ckpt, state)

    def write_ckpt(step_label: int) -> None:
        save_state(os.path.join(root_dir, "checkpoints", f"step_{step_label:08d}.pt"), state)

    logger = MetricsLogger(root_dir, log_every)
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
        logger.log(step, metrics)

        if step % ckpt_every == 0 and step > start:
            write_ckpt(step)

        if val_it is not None and step > start and step % val_every == 0:
            vals = []
            with torch.no_grad():
                for _ in range(val_steps):
                    vv = _video(next(val_it), trainer.device)
                    recon, aux = net(vv, vv.shape[1] == 1)
                    vals.append({"val/recon_loss": float((recon.float() - vv).abs().mean()),
                                 "val/commitment_loss": float(aux["commitment_loss"])})
            agg = {k: float(np.mean([m[k] for m in vals])) for k in vals[0]}
            logger.log(step, agg)
            print(f"[val @ {step}] {agg}", flush=True)

        if img_every and should_log_img(step):
            with torch.no_grad():
                recons, _ = net(video, video.shape[1] == 1)
            dump_recon_grid(root_dir, "train", step, video.cpu().numpy(),
                            recons.float().cpu().numpy())

    write_ckpt(state.step)
    logger.close()
    return state
