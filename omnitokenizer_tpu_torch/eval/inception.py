"""The FID InceptionV3 (pool3, 2048-d), pytorch-fid's feature extractor
(mirror of `omnitokenizer_tpu.eval.inception`): TF-ported weights,
average pools with count_include_pad=False, a max pool in the last
InceptionE.

The modules carry pt_inception-2015-12-05's torch names
(`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_mean`, ...,
`fc.*`), so those weights load with `load_state_dict`. Without them the
network runs from a random init (torch's, from a seed; not the JAX
package's): the plumbing runs, the numbers mean nothing.

Inputs are channels-last (B, H, W, 3) in [0, 1]; `preprocess_images`
resizes them to 299 and scales them to [-1, 1]. On the card, keep
`torch.backends.cudnn.allow_tf32` off (the CLIs do).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.wrapper import check_device
from ..training.loop import resize_bilinear


class BasicConv2d(nn.Module):
    """Conv2d without bias, BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel=1, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nip(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, pad 1, count_include_pad=False."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64)
        self.branch5x5_1 = BasicConv2d(in_ch, 48)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_nip(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192)
        self.branch7x7_1 = BasicConv2d(in_ch, c7)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192)
        self.tap: Optional[torch.Tensor] = None  # the 1x1 branch, when kept

    def forward(self, x, keep_tap: bool = False):
        b1 = self.branch1x1(x)
        if keep_tap:
            self.tap = b1
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([b1, b7, bd, self.branch_pool(_avg_pool_nip(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, pool_type: str):  # Mixed_7b 'avg', Mixed_7c 'max'
        super().__init__()
        self.pool_type = pool_type
        self.branch1x1 = BasicConv2d(in_ch, 320)
        self.branch3x3_1 = BasicConv2d(in_ch, 384)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = (_avg_pool_nip(x) if self.pool_type == "avg"
              else F.max_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class FIDInceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1008):  # pt_inception-2015-12-05's head
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor, return_logits: bool = False,
                keep_tap: bool = False) -> torch.Tensor:
        """(B, 299, 299, 3) in [-1, 1] -> (B, 2048) pool3 features, or the
        (B, num_classes) logits of the Inception Score. keep_tap keeps
        Mixed_6d's 1x1 branch in `Mixed_6d.tap` (the sFID features)."""
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, stride=2)
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, stride=2)
        x = self.Mixed_6a(self.Mixed_5d(self.Mixed_5c(self.Mixed_5b(x))))
        x = self.Mixed_6c(self.Mixed_6b(x))
        x = self.Mixed_6e(self.Mixed_6d(x, keep_tap=keep_tap))
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pool = x.mean(dim=(2, 3))
        return self.fc(pool) if return_logits else pool


def load_inception(path: Optional[str] = None, device="cuda", seed: int = 0
                   ) -> Tuple[FIDInceptionV3, bool]:
    """(the network in eval mode on `device`, whether weights were loaded)
    from a pt_inception-2015-12-05 state_dict; its fc loads only at the
    1008-way head's shape, as the JAX loader does. Without `path`, a random
    init from `seed`."""
    check_device(device)
    with torch.random.fork_rng(devices=[]):  # torch's init, seeded, leaving the global stream
        torch.manual_seed(seed)
        model = FIDInceptionV3()
    if path is not None:
        sd = {k: v for k, v in torch.load(path, map_location="cpu").items()
              if not k.endswith("num_batches_tracked")}
        if "fc.weight" in sd and sd["fc.weight"].shape != model.fc.weight.shape:
            sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
        model.load_state_dict(sd, strict=False)
        missing = [k for k in model.state_dict() if k not in sd and not k.startswith("fc.")
                   and not k.endswith("num_batches_tracked")]
        if missing:
            raise KeyError(f"{path} lacks {missing[:5]} (+{max(0, len(missing) - 5)} more)")
    return model.eval().requires_grad_(False).to(device), path is not None


def preprocess_images(images01, size: int = 299, device="cpu") -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> 299^2 by JAX's antialiased bilinear resize,
    in [-1, 1]."""
    x = torch.as_tensor(np.asarray(images01, np.float32)).to(device)
    if tuple(x.shape[1:3]) != (size, size):
        x = resize_bilinear(x[:, None], size)[:, 0]
    return 2.0 * x - 1.0


@torch.no_grad()
def _batched(images01, model: FIDInceptionV3, batch: int, fn) -> np.ndarray:
    device = next(model.parameters()).device
    return np.concatenate([fn(preprocess_images(images01[i:i + batch], device=device)).cpu()
                           .numpy() for i in range(0, len(images01), batch)], axis=0)


def compute_fid_features(images01, model: FIDInceptionV3, batch: int = 32) -> np.ndarray:
    """(N, 2048) pool3 features of (N, H, W, 3) images in [0, 1]."""
    return _batched(images01, model, batch, model)


def compute_spatial_features(images01, model: FIDInceptionV3, batch: int = 32) -> np.ndarray:
    """The first 7 channels of Mixed_6d's 1x1 branch (TF's 'mixed_6/conv:0'),
    flattened channels-last to (N, 17 * 17 * 7) = (N, 2023): the sFID
    features."""
    def tap(x):
        model(x, keep_tap=True)
        sp = model.Mixed_6d.tap[:, :7].permute(0, 2, 3, 1)
        model.Mixed_6d.tap = None
        return sp.reshape(sp.shape[0], -1)

    return _batched(images01, model, batch, tap)


def compute_inception_probs(images01, model: FIDInceptionV3, batch: int = 32) -> np.ndarray:
    """Softmax class probabilities for the Inception Score."""
    return _batched(images01, model, batch,
                    lambda x: torch.softmax(model(x, return_logits=True), dim=-1))


def inception_score(probs: np.ndarray, splits: int = 1) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))), mean and std over `splits` chunks."""
    n = probs.shape[0]
    scores = []
    for k in range(splits):
        part = probs[k * (n // splits):(k + 1) * (n // splits)]
        py = np.mean(part, axis=0, keepdims=True)
        kl = np.sum(part * (np.log(part + 1e-12) - np.log(py + 1e-12)), axis=1)
        scores.append(float(np.exp(np.mean(kl))))
    return float(np.mean(scores)), float(np.std(scores))
