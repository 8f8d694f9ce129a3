"""DiT, the diffusion transformer over latent images with adaLN-Zero
conditioning (mirror of `omnitokenizer_tpu.models.dit`).

Channels-first, as the reference torch DiT is: x (B, C, H, W), t (B,), y
(B,) -> (B, out_C, H, W). The modules carry the reference's torch names
(x_embedder.proj, t_embedder.mlp.{0,2}, y_embedder.embedding_table,
blocks.{i}.{attn.qkv, attn.proj, mlp.fc1, mlp.fc2, adaLN_modulation.1},
final_layer.{linear, adaLN_modulation.1}), so a published state_dict loads
with load_state_dict once its pos_embed is dropped: the fixed 2D sin-cos
table is recomputed here, as the JAX package recomputes it.

The parameters stay f32 and a call computes in cfg.dtype, casting them as
flax's Dense layers do (`serving()` casts them once, for sampling). The
patch embedding is the conv's weight applied to the patches as one matmul,
which does not round to TF32 in f32 where cuDNN's conv would. Attention is
F.scaled_dot_product_attention (no Pallas kernel in the JAX package: a
plain einsum and softmax). GELU is tanh's; LayerNorms are eps 1e-6 without
an affine.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


@dataclass(frozen=True)
class DiTConfig:
    input_size: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    class_dropout_prob: float = 0.1
    num_classes: int = 1000
    learn_sigma: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def num_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    def replace(self, **kw) -> "DiTConfig":
        return dataclasses.replace(self, **kw)


# -- fixed sin-cos embeddings: the reference's [sin, cos] per-axis concat and
#    w-first meshgrid, kept so that converted checkpoints line up -------------
def sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", np.asarray(pos).reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape(2, -1)
    emb_h = sincos_1d(embed_dim // 2, grid[0])
    emb_w = sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)  # (H*W, D)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """(B,) -> (B, dim) f32 sinusoid, cat[cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense semantics: input, weight and bias (if any) cast to `dtype`."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without an affine, eps 1e-6, f32 statistics."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class PatchEmbed(nn.Module):
    """(B, C, H, W) -> (B, N, D): a p x p stride-p conv as one matmul over
    the patches, each flattened (C, p, p) as the conv's weight is."""

    def __init__(self, patch: int, in_channels: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        p = self.patch
        B, C, H, W = x.shape
        x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(B, (H // p) * (W // p), C * p * p)
        w = self.proj.weight.reshape(self.proj.out_channels, -1)
        return F.linear(x.to(dtype), w.to(dtype), self.proj.bias.to(dtype))


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, freq_size: int = 256):
        super().__init__()
        self.freq_size = freq_size
        self.mlp = nn.Sequential(nn.Linear(freq_size, hidden_size), nn.SiLU(),
                                 nn.Linear(hidden_size, hidden_size))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = timestep_embedding(t, self.freq_size).to(dtype)
        return dense(F.silu(dense(h, self.mlp[0], dtype)), self.mlp[2], dtype)


class LabelEmbedder(nn.Module):
    """Class id -> vector; the null class (num_classes) stands for a dropped
    label, forced by `force_drop_ids == 1` or drawn with probability
    dropout_prob from `generator` in training (given a process group, this
    rank's rows of one draw for the global batch)."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float):
        super().__init__()
        self.num_classes, self.dropout_prob = num_classes, dropout_prob
        self.embedding_table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, labels: torch.Tensor, dtype: torch.dtype, train: bool = False,
                force_drop_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, group=None) -> torch.Tensor:
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids == 1, self.num_classes, labels)
        elif train and self.dropout_prob > 0:
            drop = mesh.draw_rows(lambda shape: torch.rand(shape, generator=generator,
                                                           device=labels.device),
                                  labels.shape, group) < self.dropout_prob
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table.weight.to(dtype)[labels]


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        qkv = dense(x, self.qkv, dtype).reshape(B, N, 3, H, D // H).permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return dense(y.transpose(1, 2).reshape(B, N, D), self.proj, dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(F.gelu(dense(x, self.fc1, dtype), approximate="tanh"), self.fc2, dtype)


class DiTBlock(nn.Module):
    """adaLN-Zero block: a 6-way modulation of attention and MLP from c."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 6 * hidden_size))

    def forward(self, x: torch.Tensor, c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        mod = dense(F.silu(c), self.adaLN_modulation[1], dtype)
        sh_msa, sc_msa, gate_msa, sh_mlp, sc_mlp, gate_mlp = mod.chunk(6, dim=-1)
        x = x + gate_msa[:, None] * self.attn(modulate(layer_norm(x), sh_msa, sc_msa), dtype)
        return x + gate_mlp[:, None] * self.mlp(modulate(layer_norm(x), sh_mlp, sc_mlp), dtype)


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden_size, patch_size * patch_size * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))

    def forward(self, x: torch.Tensor, c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        shift, scale = dense(F.silu(c), self.adaLN_modulation[1], dtype).chunk(2, dim=-1)
        return dense(modulate(layer_norm(x), shift, scale), self.linear, dtype)


def unpatchify(x: torch.Tensor, patch: int, channels: int) -> torch.Tensor:
    """(B, N, p*p*c) -> (B, c, H, W), each token's outputs ordered (p, p, c)."""
    B, N, _ = x.shape
    h = w = math.isqrt(N)
    x = x.reshape(B, h, w, patch, patch, channels).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(B, channels, h * patch, w * patch)


class DiffusionTransformer(nn.Module):
    """What DiT and Latte share: the embedders, the blocks and the final
    layer; `serving()` for sampling."""

    cfg: object

    def _build(self, cfg, depth: int) -> None:
        D = cfg.hidden_size
        self.x_embedder = PatchEmbed(cfg.patch_size, cfg.in_channels, D)
        self.t_embedder = TimestepEmbedder(D)
        self.blocks = nn.ModuleList(DiTBlock(D, cfg.num_heads, cfg.mlp_ratio)
                                    for _ in range(depth))
        self.final_layer = FinalLayer(D, cfg.patch_size, cfg.out_channels)
        grid = cfg.input_size // cfg.patch_size
        self.register_buffer("pos_embed", torch.tensor(sincos_2d(D, grid), dtype=torch.float32)[None],
                             persistent=False)

    def serving(self) -> "DiffusionTransformer":
        """A copy for inference whose parameters are already cfg.dtype, so
        a sampling step casts none of them."""
        served = copy.deepcopy(self).eval().requires_grad_(False)
        return served.to(self.cfg.dtype)

    def _final(self, h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return unpatchify(self.final_layer(h, c, cfg.dtype), cfg.patch_size, cfg.out_channels)


class DiT(DiffusionTransformer):
    """x (B, C, H, W), t (B,), y (B,) -> (B, out_C, H, W)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self._build(cfg, cfg.depth)
        self.y_embedder = (LabelEmbedder(cfg.num_classes, cfg.hidden_size, cfg.class_dropout_prob)
                           if cfg.num_classes else None)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
                train: bool = False, force_drop_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, group=None) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        if tuple(x.shape[1:]) != (cfg.in_channels, cfg.input_size, cfg.input_size):
            raise ValueError(f"expected (B, {cfg.in_channels}, {cfg.input_size}, "
                             f"{cfg.input_size}), got {tuple(x.shape)}")
        h = self.x_embedder(x, dt) + self.pos_embed.to(dt)
        c = self.t_embedder(t, dt)
        if y is not None and self.y_embedder is not None:
            c = c + self.y_embedder(y, dt, train, force_drop_ids, generator, group)
        for block in self.blocks:
            h = block(h, c, dt)
        return self._final(h, c)


def forward_with_cfg(model: nn.Module, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                     cfg_scale: float, cfg_channels: int = 3, channel_axis: int = 1,
                     **kw) -> torch.Tensor:
    """Classifier-free guidance. `x` is a doubled batch whose first half is
    used twice; `y` holds the labels, then the null class. Guidance acts on
    the first `cfg_channels` channels only (the reference's quirk: 3 for
    DiT, 4 for Latte on channel_axis 2)."""
    half = x[: x.shape[0] // 2]
    out = model(torch.cat([half, half], 0), t, y, **kw)
    eps, rest = out.split([cfg_channels, out.shape[channel_axis] - cfg_channels], channel_axis)
    cond_eps, uncond_eps = eps.chunk(2, dim=0)
    half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
    return torch.cat([torch.cat([half_eps, half_eps], 0), rest], channel_axis)


def init_weights(model: DiffusionTransformer, generator: torch.Generator) -> DiffusionTransformer:
    """The JAX package's init, drawn from `generator` on its device:
    LeCun-normal Linear weights and zero biases, a Xavier-uniform patch
    embedding, N(0, 0.02) timestep MLP and label table, and every adaLN
    modulation and the final linear zero, so that a fresh model outputs
    exactly 0."""
    dev = generator.device

    def normal_(w: torch.Tensor, std: float) -> None:
        w.copy_(torch.randn(w.shape, generator=generator, device=dev) * std)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                normal_(mod.weight, mod.in_features ** -0.5)
                mod.bias.zero_()
        w = model.x_embedder.proj.weight
        fan_in, fan_out = w[0].numel(), w.shape[0]
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        w.copy_((torch.rand(w.shape, generator=generator, device=dev) * 2 - 1) * bound)
        model.x_embedder.proj.bias.zero_()
        for lin in (model.t_embedder.mlp[0], model.t_embedder.mlp[2]):
            normal_(lin.weight, 0.02)
        if getattr(model, "y_embedder", None) is not None:
            normal_(model.y_embedder.embedding_table.weight, 0.02)
        for block in list(model.blocks) + [model.final_layer]:
            block.adaLN_modulation[1].weight.zero_()
            block.adaLN_modulation[1].bias.zero_()
        model.final_layer.linear.weight.zero_()
        model.final_layer.linear.bias.zero_()
    return model


# -- registry ------------------------------------------------------------------
SIZES = {
    "XL": dict(depth=28, hidden_size=1152, num_heads=16),
    "L": dict(depth=24, hidden_size=1024, num_heads=16),
    "B": dict(depth=12, hidden_size=768, num_heads=12),
    "S": dict(depth=12, hidden_size=384, num_heads=6),
}


def dit_config(name: str, **kw) -> DiTConfig:
    """'DiT-XL/2' etc.; kw overrides (in_channels=8 for the OmniTokenizer VAE)."""
    arch, patch = name.replace("DiT-", "").split("/")
    return DiTConfig(patch_size=int(patch), **SIZES[arch], **kw)


DiT_models = {f"DiT-{a}/{p}": (lambda a=a, p=p: dit_config(f"DiT-{a}/{p}"))
              for a in SIZES for p in (2, 4, 8)}

