"""LPIPS perceptual distance: VGG16 features and learned linear heads
(mirror of `omnitokenizer_tpu.models.lpips`).

Inputs are channels-last (B, H, W, 3) in [-1, 1]; the reference's scaling
layer's shift and scale are baked in. The convolutions compute in the
module's dtype; parameters are f32. `load_lpips_variables` reads the
weights from files on disk and downloads nothing: a torchvision VGG16
state_dict for the backbone, and the reference's `vgg.pth` for the five
heads; what it does not find stays random (heads of ones), and it reports
`pretrained=False`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# VGG16's conv widths per slice, a max-pool between slices
SLICES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
CHNS = (64, 128, 256, 512, 512)
# indices of the convs in torchvision's vgg16().features
TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_FILE = "vgg16-397923af.pth"  # torchvision's file name in the hub cache
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The VGG16 conv trunk; returns the five slices' relu outputs."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = [c for s in SLICES for c in s]
        for i, (cin, cout) in enumerate(zip([3] + widths[:-1], widths)):
            self.add_module(f"conv{i}", nn.Conv2d(cin, cout, 3, padding=1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs, i = [], 0
        for si, chans in enumerate(SLICES):
            if si > 0:
                x = F.max_pool2d(x, 2, 2)
            for _ in chans:
                conv = getattr(self, f"conv{i}")
                x = F.relu(F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype),
                                    conv.bias.to(self.dtype), padding=1))
                i += 1
            outs.append(x)
        return outs


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (x.square().sum(1, keepdim=True).sqrt() + eps)


class LPIPS(nn.Module):
    """Perceptual distance of two channels-last batches; (B, 1, 1, 1)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = VGG16Features(dtype)
        for i, c in enumerate(CHNS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.net((x.movedim(-1, 1) - self.shift) / self.scale)
        fy = self.net((y.movedim(-1, 1) - self.shift) / self.scale)
        total = 0.0
        for i in range(len(CHNS)):
            diff = (_unit_normalize(fx[i]) - _unit_normalize(fy[i])).square()
            w = getattr(self, f"lin{i}")
            total = total + (diff * w.view(1, -1, 1, 1)).sum(1, keepdim=True).mean(
                (2, 3), keepdim=True)
        return total


def vgg16_cache_path() -> str:
    """Where torchvision keeps its VGG16 weights ($TORCH_HOME/hub/checkpoints)."""
    return os.path.join(torch.hub.get_dir(), "checkpoints", VGG16_FILE)


@torch.no_grad()
def load_lpips_variables(model: LPIPS, vgg16_torch_path: Optional[str] = None,
                         lin_path: Optional[str] = None,
                         generator: Optional[torch.Generator] = None) -> Tuple[LPIPS, bool]:
    """Fill `model`: random LeCun-normal convs from `generator` and heads of
    ones, then the backbone from a torchvision VGG16 state_dict (the path
    given, else torchvision's cache if it holds one) and the heads from the
    reference's `vgg.pth` (keys lin{i}.model.1.weight, shape (1, C, 1, 1))
    if `lin_path` names one. Returns (model, whether both were found)."""
    for i in range(len(TORCHVISION_CONVS)):
        conv = getattr(model.net, f"conv{i}")
        fan_in = conv.weight[0].numel()
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator) * fan_in ** -0.5)
        conv.bias.zero_()
    for i in range(len(CHNS)):
        getattr(model, f"lin{i}").fill_(1.0)

    pretrained = True
    if lin_path and os.path.exists(lin_path):
        lins = torch.load(lin_path, map_location="cpu")
        for i in range(len(CHNS)):
            getattr(model, f"lin{i}").copy_(lins[f"lin{i}.model.1.weight"].reshape(-1))
    else:
        pretrained = False

    if vgg16_torch_path is None and os.path.exists(vgg16_cache_path()):
        vgg16_torch_path = vgg16_cache_path()
    if vgg16_torch_path and os.path.exists(vgg16_torch_path):
        sd = torch.load(vgg16_torch_path, map_location="cpu")
        for ci, ti in enumerate(TORCHVISION_CONVS):
            conv = getattr(model.net, f"conv{ci}")
            conv.weight.copy_(sd[f"features.{ti}.weight"])
            conv.bias.copy_(sd[f"features.{ti}.bias"])
    else:
        pretrained = False
    return model, pretrained
