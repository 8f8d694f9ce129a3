"""EMA vector-quantization codebook (mirror of `omnitokenizer_tpu.ops.codebook`).

Nearest-code search (the `vq_argmin` kernel on a CUDA tensor, in both
halves), lookup, the straight-through embeddings and the batch statistics.
A training call also advances the codebook, in place and outside autograd:
the data-dependent init from the first training batch (gated on
`initialized`), the EMA of the code counts `N` and sums `z_avg` with
decay 0.99, the Laplace-smoothed weight normalization, the optional random
restart of dead codes, and the usage EMA (its first call takes the batch's
usage). Counts and sums are scatter-adds (`index_add_`), no one-hot.
Random rows come from the caller's `torch.Generator`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .kernels.vq_argmin import vq_argmin


def tile_to_codes(flat: torch.Tensor, n_codes: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Repeat the rows (plus noise of std 0.01 / sqrt(D)) until there are
    at least n_codes of them, then take a random n_codes of them."""
    m, d = flat.shape
    if m < n_codes:
        flat = flat.repeat(-(-n_codes // m), 1)
        noise = torch.randn(flat.shape, generator=generator, device=flat.device)
        flat = flat + (0.01 / d ** 0.5) * noise
    perm = torch.randperm(flat.shape[0], generator=generator, device=flat.device)
    return flat[perm[:n_codes]]


class Codebook(nn.Module):
    DECAY = 0.99        # the EMA of N and z_avg
    USAGE_SIGMA = 0.99  # the EMA of codebook_usage

    def __init__(self, n_codes: int, embedding_dim: int, no_random_restart: bool = True,
                 restart_thres: float = 1.0):
        super().__init__()
        self.n_codes, self.embedding_dim = n_codes, embedding_dim
        self.no_random_restart, self.restart_thres = no_random_restart, restart_thres
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

    def forward(self, z: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """z (B, T, H, W, D) channels-last latents -> dict(embeddings,
        encodings, commitment_loss, perplexity, avg_usage, batch_usage).
        training=True searches the (initialized) codes and then advances
        the buffers; `generator` draws the init and restart rows."""
        bshape = z.shape[:-1]
        flat = z.reshape(-1, self.embedding_dim).float()
        emb = self.embeddings
        if training:
            # the first training batch initializes the codes from its rows
            cand = tile_to_codes(flat.detach(), self.n_codes, generator)
            fresh = self.initialized == 0
            emb = torch.where(fresh, cand, emb)
            z_avg = torch.where(fresh, cand, self.z_avg)
            n_state = torch.where(fresh, torch.ones_like(self.N), self.N)

        indices = vq_argmin(flat.detach().contiguous(), emb.float().contiguous())
        idx = indices.long()
        quantized = emb[idx].reshape(z.shape).float()

        z32 = z.float()
        commitment_loss = 0.25 * (z32 - quantized).square().mean()
        counts = torch.zeros(self.n_codes, device=z.device).index_add_(
            0, idx, torch.ones_like(idx, dtype=torch.float32))
        avg_probs = counts / indices.shape[0]
        perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())

        usage = self.codebook_usage
        if training:
            with torch.no_grad():
                usage = self._advance(flat.detach(), idx, counts, avg_probs, n_state, z_avg,
                                      generator)
        avg_usage = (usage > 1.0 / self.n_codes).float().mean()
        # straight-through form, kept for its rounding: z + (q - z)
        embeddings_st = z32 + (quantized - z32).detach()
        return dict(
            embeddings=embeddings_st.to(z.dtype),
            encodings=indices.reshape(bshape),
            commitment_loss=commitment_loss,
            perplexity=perplexity,
            avg_usage=avg_usage,
            batch_usage=avg_probs,
        )

    def _advance(self, flat, idx, counts, batch_usage, n_state, z_avg, generator) -> torch.Tensor:
        """The EMA step, written into the buffers; returns the new usage."""
        decay = self.DECAY
        encode_sum = torch.zeros(self.n_codes, self.embedding_dim,
                                 device=flat.device).index_add_(0, idx, flat)
        new_n = n_state * decay + counts * (1.0 - decay)
        new_z_avg = z_avg * decay + encode_sum * (1.0 - decay)
        n = new_n.sum()
        weights = (new_n + 1e-7) / (n + self.n_codes * 1e-7) * n
        new_emb = new_z_avg / weights[:, None]
        if not self.no_random_restart:
            k_rand = tile_to_codes(flat, self.n_codes, generator)
            live = (new_n[:, None] >= self.restart_thres).float()
            new_emb = new_emb * live + k_rand * (1.0 - live)
        sigma = self.USAGE_SIGMA
        new_usage = torch.where(self.call_cnt == 0, batch_usage,
                                sigma * self.codebook_usage + (1 - sigma) * batch_usage)
        self.embeddings.copy_(new_emb)
        self.N.copy_(new_n)
        self.z_avg.copy_(new_z_avg)
        self.codebook_usage.copy_(new_usage)
        self.initialized.fill_(1)
        self.call_cnt.add_(1)
        return new_usage
