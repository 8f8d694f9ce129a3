"""The legacy CNN (TATS-style) 3D-conv VQGAN (mirror of
`omnitokenizer_tpu.models.cnn_vqgan`), kept for the pre-transformer
checkpoints: encoder -> 1x1x1 pre-VQ conv -> codebook -> 1x1x1 post-VQ conv
-> decoder. Exported as `VQGAN`, the reference's name.

The public methods take and return channels-last tensors, (B, T, H, W, C),
as the JAX module does; inside, the convs run channels-first. The convs are
torch's Conv3d / ConvTranspose3d (cuDNN on the card; the JAX module runs
them outside any Pallas kernel); keep `torch.backends.cudnn.allow_tf32`
off on the card, or an f32 conv rounds to TF32. The codebook is the
tokenizer's `ops/codebook.Codebook`, whose search runs the `vq_argmin`
kernel on a CUDA tensor.

The port's modules carry the flax names (encoder.down0.conv.weight,
decoder.res0a.norm1.scale, ...), so `convert.state_dict_from_jax` maps a
JAX CnnVQGAN's variables onto them. `SamePadConvTranspose3d.weight` holds
the JAX module's kernel: the reference ConvTranspose3d's taps flipped, as
the weight of a VALID conv over the stride-dilated input
(`convert_cnn_vqgan_state` flips them, as the JAX converter does).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import TokenizerConfig
from ..ops.codebook import Codebook
from .discriminator import BatchNorm, GroupNorm

def _triple(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def same_pad_amounts(kernel: Sequence[int], stride: Sequence[int]) -> list:
    """(front, back) a dim: a total of k - s, front-heavy (base.py:393-398)."""
    return [((k - s) // 2 + (k - s) % 2, (k - s) // 2) for k, s in zip(kernel, stride)]


def _same_pad(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Replicate-pad the (T, H, W) dims of (B, C, T, H, W) by
    same_pad_amounts (the JAX modules' padding_type, which no caller sets
    to another value)."""
    pads = [p for pair in reversed(same_pad_amounts(kernel, stride)) for p in pair]
    return F.pad(x, pads, mode="replicate")


class SamePadConv3d(nn.Module):
    """Same-padded Conv3d: replicate-pad k - s a dim (front-heavy), then a
    VALID conv of stride s."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride=1):
        super().__init__()
        self.kernel, self.stride = _triple(kernel_size), _triple(stride)
        self.conv = nn.Conv3d(in_channels, out_channels, self.kernel, stride=self.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_same_pad(x, self.kernel, self.stride))


class SamePadConvTranspose3d(nn.Module):
    """The JAX module's transposed conv: pad as SamePadConv3d, dilate the
    input by the stride and run a VALID conv with `weight` (out, in, *k).
    That equals torch's ConvTranspose3d(stride=s, padding=k - 1) on the
    padded input with `weight` transposed and flipped back, which is how it
    runs."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride=1):
        super().__init__()
        self.kernel, self.stride = _triple(kernel_size), _triple(stride)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _same_pad(x, self.kernel, self.stride)
        w = self.weight.transpose(0, 1).flip(2, 3, 4)  # ConvTranspose3d's (in, out, *k)
        return F.conv_transpose3d(x, w, self.bias, stride=self.stride,
                                  padding=tuple(k - 1 for k in self.kernel))


def normalize(channels: int, norm_type: str) -> nn.Module:
    """GroupNorm(32 groups, eps 1e-6) or a BatchNorm (eps 1e-5) that reads
    its running statistics (`_normalize`, JAX cnn_vqgan.py:88-93)."""
    return GroupNorm(channels, 32, 1e-6) if norm_type == "group" else BatchNorm(channels)


def _norm(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return mod(x, train=False)


class ResBlock(nn.Module):
    """norm -> SiLU -> conv3 -> norm -> SiLU -> conv3, plus the input (a
    conv3 shortcut where the width changes)."""

    def __init__(self, in_channels: int, out_channels: int, norm_type: str = "group"):
        super().__init__()
        self.norm1 = normalize(in_channels, norm_type)
        self.conv1 = SamePadConv3d(in_channels, out_channels, 3)
        self.norm2 = normalize(out_channels, norm_type)
        self.conv2 = SamePadConv3d(out_channels, out_channels, 3)
        if in_channels != out_channels:
            self.conv_shortcut = SamePadConv3d(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(_norm(self.norm1, x)))
        h = self.conv2(F.silu(_norm(self.norm2, h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


def _log2s(factors: Sequence[int]) -> np.ndarray:
    return np.array([int(math.log2(d)) for d in factors])


class CnnEncoder(nn.Module):
    """conv_first, then per level a stride-2 conv4 (stride 1 on the dims
    already reduced) and a ResBlock, doubling the width; final norm, SiLU."""

    def __init__(self, n_hiddens: int, downsample: Sequence[int] = (4, 8, 8),
                 image_channels: int = 3, norm_type: str = "group"):
        super().__init__()
        n_times = _log2s(downsample)
        self.levels = int(n_times.max())
        self.conv_first = SamePadConv3d(image_channels, n_hiddens, 3)
        ch = n_hiddens
        for i in range(self.levels):
            out = n_hiddens * 2 ** (i + 1)
            stride = tuple(2 if d > 0 else 1 for d in n_times)
            setattr(self, f"down{i}", SamePadConv3d(ch, out, 4, stride))
            setattr(self, f"res{i}", ResBlock(out, out, norm_type))
            n_times, ch = n_times - 1, out
        self.out_channels = ch
        self.final_norm = normalize(ch, norm_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_first(x)
        for i in range(self.levels):
            h = getattr(self, f"res{i}")(getattr(self, f"down{i}")(h))
        return F.silu(_norm(self.final_norm, h))


class CnnDecoder(nn.Module):
    """final norm, SiLU, then per level a stride-2 transposed conv4 and two
    ResBlocks, halving the width; conv_last to the image channels."""

    def __init__(self, n_hiddens: int, upsample: Sequence[int] = (4, 8, 8),
                 image_channels: int = 3, norm_type: str = "group"):
        super().__init__()
        n_times = _log2s(upsample)
        self.levels = int(n_times.max())
        ch = n_hiddens * 2 ** self.levels
        self.final_norm = normalize(ch, norm_type)
        for i in range(self.levels):
            out = n_hiddens * 2 ** (self.levels - i)
            stride = tuple(2 if d > 0 else 1 for d in n_times)
            setattr(self, f"up{i}", SamePadConvTranspose3d(ch, out, 4, stride))
            setattr(self, f"res{i}a", ResBlock(out, out, norm_type))
            setattr(self, f"res{i}b", ResBlock(out, out, norm_type))
            n_times, ch = n_times - 1, out
        self.conv_last = SamePadConv3d(ch, image_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(_norm(self.final_norm, x))
        for i in range(self.levels):
            h = getattr(self, f"up{i}")(h)
            h = getattr(self, f"res{i}b")(getattr(self, f"res{i}a")(h))
        return self.conv_last(h)


class CnnVQGAN(nn.Module):
    """The TATS assembly (base.py:38-94). `cfg` gives embedding_dim (the
    codes' width), n_codes, image_channels, norm_type and the codebook's
    restart; `downsample` is the (t, h, w) reduction."""

    def __init__(self, cfg: TokenizerConfig, n_hiddens: int = 512,
                 downsample: Sequence[int] = (4, 8, 8)):
        super().__init__()
        self.cfg, self.n_hiddens, self.downsample = cfg, n_hiddens, tuple(downsample)
        self.encoder = CnnEncoder(n_hiddens, downsample, cfg.image_channels, cfg.norm_type)
        self.decoder = CnnDecoder(n_hiddens, downsample, cfg.image_channels, cfg.norm_type)
        width = self.encoder.out_channels
        self.pre_vq_conv = SamePadConv3d(width, cfg.embedding_dim, 1)
        self.post_vq_conv = SamePadConv3d(cfg.embedding_dim, width, 1)
        self.codebook = Codebook(cfg.n_codes, cfg.embedding_dim,
                                 no_random_restart=cfg.no_random_restart,
                                 restart_thres=cfg.restart_thres)

    def encode_latent(self, x: torch.Tensor) -> torch.Tensor:
        """pixels (B, T, H, W, C) -> pre-VQ latents (B, t, h, w, D)."""
        return self.pre_vq_conv(self.encoder(x.movedim(-1, 1))).movedim(1, -1)

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        """codes' embeddings (B, t, h, w, D) -> pixels (B, T, H, W, C)."""
        return self.decoder(self.post_vq_conv(z.movedim(-1, 1))).movedim(1, -1)

    def encode(self, x: torch.Tensor, include_embeddings: bool = False):
        """Indices (B, t, h, w) [and the straight-through embeddings]."""
        vq = self.codebook(self.encode_latent(x))
        if include_embeddings:
            return vq["embeddings"], vq["encodings"]
        return vq["encodings"]

    def decode(self, encodings: torch.Tensor) -> torch.Tensor:
        return self.decode_latent(self.codebook.lookup(encodings))

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None, group=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(x_recon, the codebook's dict); training=True advances the
        codebook, drawing its init and restart rows from `generator`, over
        every rank's rows given a process `group` (JAX threads `axis_name`)."""
        vq = self.codebook(self.encode_latent(x), training=training, generator=generator,
                           group=group)
        return self.decode_latent(vq["embeddings"]), vq


@torch.no_grad()
def init_cnn_vqgan(model: CnnVQGAN, generator: torch.Generator) -> CnnVQGAN:
    """Random weights from `generator`, shaped like the JAX init:
    LeCun-normal conv kernels, zero biases, unit norm scales, BatchNorm's
    statistics at mean 0 and variance 1, an N(0, 1) codebook marked
    initialized."""
    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, nn.Conv3d):
            normal_(m.weight, m.weight[0].numel() ** -0.5)
            m.bias.zero_()
        elif isinstance(m, SamePadConvTranspose3d):
            normal_(m.weight, m.weight[0].numel() ** -0.5)
            m.bias.zero_()
        elif isinstance(m, Codebook):
            normal_(m.embeddings, 1.0)
            m.z_avg.copy_(m.embeddings)
            m.N.fill_(1.0)
            m.initialized.fill_(1)
    return model


# -- the reference's TATS checkpoints ---------------------------------------------------------
_NORM_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def convert_cnn_vqgan_state(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A reference `base.VQGAN` state_dict (base.py:38-94 names:
    encoder.conv_blocks.{i}.{down,res}, decoder.conv_blocks.{i}.{up,res1,res2},
    the final_block Sequential's index 0 a Normalize, SamePadConv3d's
    '.conv', SamePadConvTranspose3d's '.convt') -> the port CnnVQGAN's
    state_dict, as the JAX `convert_cnn_vqgan_state` maps it: the transposed
    convs' taps flipped, the codebook marked initialized, its usage zero
    where the file has none, num_batches_tracked dropped."""
    out: Dict[str, np.ndarray] = {}

    def norm(path: str, leaf: str, v):
        if leaf in _NORM_LEAVES:
            out[f"{path}.{_NORM_LEAVES[leaf]}"] = v

    def res(path: str, parts, v):
        sub, rest = parts[0], parts[1:]
        if sub in ("norm1", "norm2"):
            norm(f"{path}.{sub}", rest[-1], v)
        else:  # conv1 / conv2 / conv_shortcut, a SamePadConv3d's '.conv'
            out[f"{path}.{sub}.conv.{rest[-1]}"] = v

    for k, v in sd.items():
        v = np.asarray(v, np.float32)
        parts = k.split(".")
        root = parts[0]
        if root == "codebook":
            if parts[1] in ("embeddings", "N", "z_avg", "codebook_usage"):
                out[f"codebook.{parts[1]}"] = v
        elif root in ("pre_vq_conv", "post_vq_conv"):
            out[f"{root}.conv.{parts[-1]}"] = v
        elif root == "encoder":
            if parts[1] == "conv_first":
                out[f"encoder.conv_first.conv.{parts[-1]}"] = v
            elif parts[1] == "final_block":
                norm("encoder.final_norm", parts[-1], v)
            elif parts[1] == "conv_blocks":
                i, sub = parts[2], parts[3]
                if sub == "down":
                    out[f"encoder.down{i}.conv.{parts[-1]}"] = v
                else:
                    res(f"encoder.res{i}", parts[4:], v)
        elif root == "decoder":
            if parts[1] == "final_block":
                norm("decoder.final_norm", parts[-1], v)
            elif parts[1] == "conv_last":
                out[f"decoder.conv_last.conv.{parts[-1]}"] = v
            elif parts[1] == "conv_blocks":
                i, sub = parts[2], parts[3]
                if sub == "up":  # ConvTranspose3d (in, out, *k): flipped, (out, in, *k)
                    leaf = parts[-1]
                    out[f"decoder.up{i}.{leaf}"] = (
                        np.ascontiguousarray(v[:, :, ::-1, ::-1, ::-1].transpose(1, 0, 2, 3, 4))
                        if leaf == "weight" else v)
                elif sub in ("res1", "res2"):
                    res(f"decoder.res{i}{'a' if sub == 'res1' else 'b'}", parts[4:], v)
        # the discriminators and the perceptual model are not the VQGAN's
    n_codes = out["codebook.embeddings"].shape[0]
    out.setdefault("codebook.codebook_usage", np.zeros(n_codes, np.float32))
    state = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in out.items()}
    state["codebook.initialized"] = torch.ones((), dtype=torch.int32)
    state["codebook.call_cnt"] = torch.ones((), dtype=torch.int32)
    return state


def load_cnn_vqgan_checkpoint(path: str, device="cuda") -> CnnVQGAN:
    """A CnnVQGAN from a reference Lightning `.ckpt`, its architecture from
    the embedded hparams (n_hiddens, downsample, embedding_dim, n_codes,
    norm_type; the loader's defaults 240, (4, 4, 4), 256, 2048, 'group',
    base.py:245-269), on the card unless `device` says otherwise. Every
    tensor of the model comes from the file: one it lacks raises."""
    from ..utils.checkpoint import load_torch_state_dict

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu'")
    sd, args = load_torch_state_dict(path)

    def get(name, default):
        return getattr(args, name, default) if args is not None else default

    cfg = TokenizerConfig(embedding_dim=get("embedding_dim", 256),
                          codebook_dim=get("embedding_dim", 256), n_codes=get("n_codes", 2048),
                          norm_type=get("norm_type", "group"),
                          no_random_restart=get("no_random_restart", False),
                          restart_thres=get("restart_thres", 1.0))
    model = CnnVQGAN(cfg, n_hiddens=get("n_hiddens", 240),
                     downsample=tuple(get("downsample", (4, 4, 4))))
    state = convert_cnn_vqgan_state(sd)
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    unused = sorted(set(state) - set(want))
    if missing or unused:
        raise KeyError(f"{path}: model tensors the file lacks {missing[:5]}, file tensors the "
                       f"model lacks {unused[:5]}")
    for k, v in state.items():
        if v.shape != want[k].shape:
            raise ValueError(f"{path}: {k} {tuple(v.shape)} != {tuple(want[k].shape)}")
    model.load_state_dict(state)
    return model.to(device).eval()
