"""Latte, the latent video diffusion transformer: spatial and temporal
adaLN-Zero blocks in turn (mirror of `omnitokenizer_tpu.models.latte`).

Channels-first per frame, as the reference Latte is: x (B, F, C, H, W), t
(B,), y (B,) -> (B, F, out_C, H, W). Block 2i attends over the N patches
of each frame, block 2i+1 over the F frames of each patch; the temporal
sin-cos table is added once, before the first temporal block, to the video
frames only. `extras`: 1 unconditional, 2 class labels, 78 a (77, 768)
text embedding through SiLU + Linear. The module names are the reference's
(blocks.{i} for both kinds, text_embedding_projection.1), so its state_dict
loads once pos_embed and temp_embed are dropped.

`use_image_num > 0` is the joint image-video variant (latte_img): the last
`use_image_num` frames are independent images with their own labels
(`y_image`, (B, use_image_num)); they ride the spatial blocks and bypass
the temporal blocks and the temporal table.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dit import SIZES, DiffusionTransformer, LabelEmbedder, dense, forward_with_cfg as _cfg
from .dit import sincos_1d


@dataclass(frozen=True)
class LatteConfig:
    input_size: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_frames: int = 16
    class_dropout_prob: float = 0.1
    num_classes: int = 1000
    learn_sigma: bool = True
    extras: int = 1  # 1 unconditional, 2 class, 78 text embedding
    dtype: torch.dtype = torch.float32

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    def replace(self, **kw) -> "LatteConfig":
        return dataclasses.replace(self, **kw)


class Latte(DiffusionTransformer):
    def __init__(self, cfg: LatteConfig):
        super().__init__()
        if cfg.depth % 2:
            raise ValueError("Latte pairs spatial and temporal blocks; depth must be even")
        self.cfg = cfg
        self._build(cfg, cfg.depth)
        D = cfg.hidden_size
        self.y_embedder = (LabelEmbedder(cfg.num_classes, D, cfg.class_dropout_prob)
                           if cfg.extras == 2 else None)
        if cfg.extras == 78:
            self.text_embedding_projection = nn.Sequential(nn.SiLU(), nn.Linear(77 * 768, D))
        self.register_buffer("temp_embed",
                             torch.tensor(sincos_1d(D, np.arange(cfg.num_frames)),
                                          dtype=torch.float32),
                             persistent=False)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
                text_embedding: Optional[torch.Tensor] = None, train: bool = False,
                force_drop_ids: Optional[torch.Tensor] = None,
                y_image: Optional[torch.Tensor] = None, use_image_num: int = 0,
                generator: Optional[torch.Generator] = None, group=None) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        B, Fr, C, H, W = x.shape
        Fv = Fr - use_image_num  # the video frames
        N = (cfg.input_size // cfg.patch_size) ** 2

        h = self.x_embedder(x.reshape(B * Fr, C, H, W), dt) + self.pos_embed.to(dt)
        t_emb = self.t_embedder(t, dt)  # (B, D)
        cond, cond_spatial = None, None
        if cfg.extras == 2:
            cond = self.y_embedder(y, dt, train, force_drop_ids, generator, group)
            if use_image_num and y_image is not None:
                # each frame's label: the video's for its Fv frames, then each image's own
                y_img = self.y_embedder(y_image.reshape(-1), dt, train, force_drop_ids,
                                        generator, group)
                cond_spatial = torch.cat([cond[:, None].expand(B, Fv, -1),
                                          y_img.reshape(B, use_image_num, -1)], 1)
                cond_spatial = cond_spatial.reshape(B * Fr, -1)
        elif cfg.extras == 78:
            emb = text_embedding.reshape(B, -1).to(dt)
            cond = dense(F.silu(emb), self.text_embedding_projection[1], dt)

        t_spatial = t_emb.repeat_interleave(Fr, 0)
        if cond_spatial is not None:
            c_spatial = t_spatial + cond_spatial
        else:
            c_spatial = t_spatial if cond is None else (t_emb + cond).repeat_interleave(Fr, 0)
        c_temp = (t_emb if cond is None else t_emb + cond).repeat_interleave(N, 0)

        temp = self.temp_embed.to(dt)
        for i in range(0, cfg.depth, 2):
            h = self.blocks[i](h, c_spatial, dt)
            h = h.reshape(B, Fr, N, -1).transpose(1, 2).reshape(B * N, Fr, -1)
            hv, hi = h[:, :Fv], h[:, Fv:]
            if i == 0:
                hv = hv + temp[None, :Fv]
            hv = self.blocks[i + 1](hv, c_temp, dt)
            h = torch.cat([hv, hi], 1) if use_image_num else hv
            h = h.reshape(B, N, Fr, -1).transpose(1, 2).reshape(B * Fr, N, -1)

        # the reference's final layer sees the timestep (and class) only:
        # text conditioning is not added
        out = self._final(h, c_spatial if cfg.extras == 2 else t_spatial)
        return out.reshape(B, Fr, cfg.out_channels, H, W)


def forward_with_cfg(model: nn.Module, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                     cfg_scale: float, cfg_channels: int = 4, **kw) -> torch.Tensor:
    """CFG on the first `cfg_channels` channels of each frame (axis 2)."""
    return _cfg(model, x, t, y, cfg_scale, cfg_channels, channel_axis=2, **kw)


def latte_config(name: str, **kw) -> LatteConfig:
    """'Latte-XL/2' or 'Latte-XL/2-omnitokenizer' (in_channels 8) etc."""
    base = name.replace("Latte-", "")
    if base.endswith("-omnitokenizer"):
        base = base[: -len("-omnitokenizer")]
        kw.setdefault("in_channels", 8)
    arch, patch = base.split("/")
    return LatteConfig(patch_size=int(patch), **SIZES[arch], **kw)


Latte_models = {name: (lambda name=name: latte_config(name))
                for a in SIZES for p in (2, 4, 8) for name in (f"Latte-{a}/{p}",)}
Latte_models["Latte-XL/2-omnitokenizer"] = lambda: latte_config("Latte-XL/2-omnitokenizer")
