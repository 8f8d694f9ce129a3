"""InceptionI3d (Kinetics-400), the FVD feature extractor (mirror of
`omnitokenizer_tpu.eval.i3d`; the reference's fvd/pytorch_i3d.py and
fvd/fvd.py:18-34).

The modules carry the reference's torch names (`<EndPoint>.conv3d.*`,
`<EndPoint>.bn.*`, `Mixed_*.{b0,b1a,b1b,b2a,b2b,b3b}.*`, `logits.conv3d.*`),
so `i3d_pretrained_400.pt` loads with `load_state_dict`. Without weights the
network takes the JAX package's random init (LeCun-normal kernels drawn
from np.random.RandomState(seed) in the flax tree's order), so both
packages compute the same random features; an FVD from them is a pipeline
check, not a metric.

Eval only: BatchNorm uses its running statistics. Convolutions pad as
TF's SAME does (asymmetric, zeros), and so do the max pools, before a
VALID window. On the card, keep `torch.backends.cudnn.allow_tf32` off
(the CLIs do): the convolutions are cuDNN's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.wrapper import check_device
from ..training.loop import resize_bilinear


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF SAME padding of one dim (the reference's pytorch_i3d.py:93-98)."""
    pad = max(k - s, 0) if size % s == 0 else max(k - (size % s), 0)
    return pad // 2, pad - pad // 2


def _pad_same_3d(x: torch.Tensor, ks: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    """Zero padding of an (N, C, T, H, W) tensor; F.pad takes the last dim first."""
    pads = [_same_pad(n, k, s) for n, k, s in zip(x.shape[2:], ks, strides)]
    return F.pad(x, [p for pair in reversed(pads) for p in pair])


def max_pool_same(x: torch.Tensor, ks: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    return F.max_pool3d(_pad_same_3d(x, ks, strides), tuple(ks), tuple(strides))


class Unit3D(nn.Module):
    """SAME-padded Conv3d, BatchNorm (eps 1e-5) and ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, use_bias: bool = False, relu: bool = True):
        super().__init__()
        self.kernel, self.stride, self.relu = tuple(kernel), tuple(stride), relu
        self.conv3d = nn.Conv3d(in_ch, out_ch, self.kernel, self.stride, bias=use_bias)
        self.bn = nn.BatchNorm3d(out_ch, eps=1e-5) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(_pad_same_3d(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class InceptionModule(nn.Module):
    def __init__(self, in_ch: int, out: Sequence[int]):  # [b0, b1a, b1b, b2a, b2b, b3b]
        super().__init__()
        self.b0 = Unit3D(in_ch, out[0])
        self.b1a = Unit3D(in_ch, out[1])
        self.b1b = Unit3D(out[1], out[2], (3, 3, 3))
        self.b2a = Unit3D(in_ch, out[3])
        self.b2b = Unit3D(out[3], out[4], (3, 3, 3))
        self.b3b = Unit3D(in_ch, out[5])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


MIXED = {
    "Mixed_3b": [64, 96, 128, 16, 32, 32],
    "Mixed_3c": [128, 128, 192, 32, 96, 64],
    "Mixed_4b": [192, 96, 208, 16, 48, 64],
    "Mixed_4c": [160, 112, 224, 24, 64, 64],
    "Mixed_4d": [128, 128, 256, 24, 64, 64],
    "Mixed_4e": [112, 144, 288, 32, 64, 64],
    "Mixed_4f": [256, 160, 320, 32, 128, 128],
    "Mixed_5b": [256, 160, 320, 32, 128, 128],
    "Mixed_5c": [384, 192, 384, 48, 128, 128],
}


class InceptionI3d(nn.Module):
    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        ch = 192
        for name, out in MIXED.items():
            self.add_module(name, InceptionModule(ch, out))
            ch = out[0] + out[2] + out[4] + out[5]
        self.logits = Unit3D(ch, num_classes, use_bn=False, use_bias=True, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) in [-1, 1] -> (B, num_classes) logits, averaged over
        time (the reference's pytorch_i3d.py:354-364)."""
        x = self.Conv3d_1a_7x7(x.permute(0, 4, 1, 2, 3))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        x = self.logits(F.avg_pool3d(x, (2, 7, 7), stride=1))
        return x[:, :, :, 0, 0].mean(dim=2)


def _units(model: nn.Module):
    return [(name, m) for name, m in model.named_modules() if isinstance(m, Unit3D)]


@torch.no_grad()
def init_like_jax(model: InceptionI3d, seed: int = 0) -> None:
    """The JAX package's random init: the conv kernels LeCun-normal from one
    np.random.RandomState(seed), drawn in the flax tree's order (units sorted
    by path) at the flax kernel layout (kt, kh, kw, I, O); zero biases and
    identity BatchNorms."""
    rng = np.random.RandomState(seed)
    for _, unit in sorted(_units(model), key=lambda nm: tuple(nm[0].split("."))):
        o, i, *k = unit.conv3d.weight.shape
        flax = rng.standard_normal((*k, i, o)) / math.sqrt(i * int(np.prod(k)))
        unit.conv3d.weight.copy_(torch.from_numpy(flax.astype(np.float32).transpose(4, 3, 0, 1, 2)))
        if unit.conv3d.bias is not None:
            unit.conv3d.bias.zero_()
        if unit.bn is not None:
            unit.bn.reset_parameters()


def load_i3d(path: Optional[str] = None, device="cuda", num_classes: int = 400,
             seed: int = 0) -> Tuple[InceptionI3d, bool]:
    """(the network in eval mode on `device`, whether weights were loaded).
    Without `path`, the JAX package's random init from `seed`."""
    check_device(device)
    model = InceptionI3d(num_classes)
    init_like_jax(model, seed)
    if path is not None:
        sd = torch.load(path, map_location="cpu")
        model.load_state_dict({k: v for k, v in sd.items()
                               if not k.endswith("num_batches_tracked")}, strict=False)
        missing = [k for k in model.state_dict()
                   if k not in sd and not k.endswith("num_batches_tracked")]
        if missing:
            raise KeyError(f"{path} lacks {missing[:5]} (+{max(0, len(missing) - 5)} more)")
    return model.eval().requires_grad_(False).to(device), path is not None


def preprocess_videos(videos_uint8, target: int = 224, device="cpu") -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> (B, T, target, target, 3) float32 in [-1, 1]
    (the reference's fvd.py:18-29), resized by JAX's antialiased bilinear
    resize: the port follows the JAX package here; the reference's torch
    code does not antialias."""
    x = torch.as_tensor(np.asarray(videos_uint8)).to(device, torch.float32)
    x = resize_bilinear(x, target)
    return 2.0 * x / 255.0 - 1.0


def preprocess_videos_styleganv(videos_uint8, target: int = 224, device="cpu") -> torch.Tensor:
    """The styleganv protocol (the reference's fvd/styleganv/fvd.py:38-62):
    the shorter side to `target` (antialiased bilinear), a center crop of
    target^2, then [0, 1] -> [-1, 1]."""
    x = torch.as_tensor(np.asarray(videos_uint8)).to(device, torch.float32) / 255.0
    H, W = x.shape[2:4]
    scale = target / min(H, W)
    nh, nw = (target, math.ceil(W * scale)) if H < W else (math.ceil(H * scale), target)
    x = resize_bilinear(x, (nh, nw))
    h0, w0 = (nh - target) // 2, (nw - target) // 2
    return (x[:, :, h0:h0 + target, w0:w0 + target] - 0.5) * 2.0


@torch.no_grad()
def compute_fvd_logits(videos_uint8, model: InceptionI3d, batch: int = 16,
                       preprocess=None) -> np.ndarray:
    """I3D logits of (N, T, H, W, 3) uint8 clips for FVD (the reference's
    fvd.py:31-34,131-139), `batch` clips at a time on the model's device.
    `preprocess` overrides the 224 resize (e.g. preprocess_videos_styleganv)."""
    pre = preprocess or preprocess_videos
    device = next(model.parameters()).device
    outs = [model(pre(videos_uint8[i:i + batch], device=device)).cpu().numpy()
            for i in range(0, len(videos_uint8), batch)]
    return np.concatenate(outs, axis=0)
