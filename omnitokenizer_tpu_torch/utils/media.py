"""Media output helpers: video grids, image strips (mirror of
`omnitokenizer_tpu.utils.media`; the reference's utils.py:225-246,
save_video_grid).

Input convention: channels-last float video in [-0.5, 0.5] or uint8.
imageio and PIL are imported only by the functions that write files.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def to_uint8(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x
    return np.clip((x + 0.5) * 255.0, 0, 255).astype(np.uint8)


def make_video_grid(video: np.ndarray, nrow: Optional[int] = None,
                    padding: int = 1) -> np.ndarray:
    """(B, T, H, W, C) -> (T, grid_H, grid_W, C) uint8 grid."""
    video = to_uint8(video)
    b, t, h, w, c = video.shape
    nrow = nrow or math.ceil(math.sqrt(b))
    ncol = math.ceil(b / nrow)
    grid = np.zeros((t, (padding + h) * nrow + padding,
                     (padding + w) * ncol + padding, c), np.uint8)
    for i in range(b):
        r, cl = i // ncol, i % ncol
        sr, sc = (padding + h) * r + padding, (padding + w) * cl + padding
        grid[:, sr:sr + h, sc:sc + w] = video[i]
    return grid


def save_video_grid(video: np.ndarray, fname: str, nrow: Optional[int] = None,
                    fps: int = 6):
    """Write an mp4/gif grid of clips (utils.py:225-246)."""
    import imageio

    grid = make_video_grid(video, nrow)
    imageio.mimsave(fname, list(grid), fps=fps)


def save_image_grid(images: np.ndarray, fname: str, nrow: Optional[int] = None):
    """(B, H, W, C) -> single PNG grid."""
    from PIL import Image

    grid = make_video_grid(images[:, None], nrow)[0]
    Image.fromarray(grid).save(fname)
