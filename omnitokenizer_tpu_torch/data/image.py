"""Annotation-file image dataset, ImageNet-style (mirror of
`omnitokenizer_tpu.data.image`).

The reference's semantics (its data.py:52-117): lines of "relpath\\tlabel";
a bicubic resize to (res, res), or a 1.5x resize and a random crop when
training with resizecrop; normalized to [-0.5, 0.5]. Returns channels-last
(H, W, C) float32. PIL is imported when a sample is read, so the module
imports on a host without it.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..native import normalize_u8


class ImageDataset:
    exts = ("jpg", "jpeg", "png", "bmp", "webp")

    def __init__(self, data_folder: str, data_list: str, train: bool = True,
                 resolution: int = 256, resizecrop: bool = False, seed: int = 1234):
        self.train = train
        self.data_folder = data_folder
        self.resolution = resolution
        self.resizecrop = resizecrop
        self.rng = np.random.RandomState(seed)
        with open(data_list) as f:
            self.annotations = [ln for ln in (l.strip() for l in f) if ln]

    def __len__(self) -> int:
        return len(self.annotations)

    @property
    def n_classes(self) -> int:
        return 1000

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image

        parts = self.annotations[idx].split("\t")
        rel, label = parts[0], int(parts[1]) if len(parts) > 1 else -1
        img = Image.open(os.path.join(self.data_folder, rel)).convert("RGB")

        res = self.resolution
        if self.train and self.resizecrop:
            big = int(res * 1.5)
            img = img.resize((big, big), Image.BICUBIC)
            x = self.rng.randint(0, big - res + 1)
            y = self.rng.randint(0, big - res + 1)
            img = img.crop((x, y, x + res, y + res))
        else:
            img = img.resize((res, res), Image.BICUBIC)
        return {"video": normalize_u8(np.asarray(img)), "label": label, "path": rel}
