"""VQ codebook, inference half (mirror of `omnitokenizer_tpu.ops.codebook`).

Nearest-code search (the `vq_argmin` kernel on a CUDA tensor), lookup, the
straight-through embeddings and the batch statistics. The EMA updates, the
data-dependent init and the random restart are training and come later
(ROADMAP.md); the buffers they keep are registered so that a JAX
checkpoint loads whole.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .kernels.vq_argmin import vq_argmin


class Codebook(nn.Module):
    def __init__(self, n_codes: int, embedding_dim: int):
        super().__init__()
        self.n_codes, self.embedding_dim = n_codes, embedding_dim
        # the values come from a checkpoint or from models.tokenizer.init_weights
        self.register_buffer("embeddings", torch.zeros(n_codes, embedding_dim))
        self.register_buffer("N", torch.zeros(n_codes))
        self.register_buffer("z_avg", torch.zeros(n_codes, embedding_dim))
        self.register_buffer("codebook_usage", torch.zeros(n_codes))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.int32))
        self.register_buffer("call_cnt", torch.zeros((), dtype=torch.int32))

    def lookup(self, encodings: torch.Tensor) -> torch.Tensor:
        """indices [...] -> embeddings [..., D]."""
        return self.embeddings[encodings.long()]

    def forward(self, z: torch.Tensor, training: bool = False) -> Dict[str, torch.Tensor]:
        """z (B, T, H, W, D) channels-last latents -> dict(embeddings,
        encodings, commitment_loss, perplexity, avg_usage, batch_usage)."""
        if training:
            raise NotImplementedError(
                "codebook EMA training is not ported yet (see ROADMAP.md)")
        bshape = z.shape[:-1]
        flat = z.reshape(-1, self.embedding_dim).float().contiguous()
        emb = self.embeddings.float().contiguous()

        indices = vq_argmin(flat, emb)
        quantized = emb[indices.long()].reshape(z.shape)

        z32 = z.float()
        commitment_loss = 0.25 * (z32 - quantized).square().mean()
        counts = torch.bincount(indices.long(), minlength=self.n_codes).float()
        avg_probs = counts / indices.shape[0]
        perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())
        avg_usage = (self.codebook_usage > 1.0 / self.n_codes).float().mean()
        # straight-through form, kept for its rounding: z + (q - z)
        embeddings_st = z32 + (quantized - z32)
        return dict(
            embeddings=embeddings_st.to(z.dtype),
            encodings=indices.reshape(bshape),
            commitment_loss=commitment_loss,
            perplexity=perplexity,
            avg_usage=avg_usage,
            batch_usage=avg_probs,
        )
