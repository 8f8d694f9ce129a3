"""EMA vector-quantization codebook (mirror of `omnitokenizer_tpu.ops.codebook`).

Nearest-code search (the `vq_argmin` kernel on a CUDA tensor, in both
halves), lookup, the straight-through embeddings and the batch statistics.
A training call also advances the codebook, in place and outside autograd:
the data-dependent init from the first training batch (gated on
`initialized`), the EMA of the code counts `N` and sums `z_avg` with
decay 0.99, the Laplace-smoothed weight normalization, the optional random
restart of dead codes, and the usage EMA (its first call takes the batch's
usage). Counts are an integer histogram and the code sums a sorted
accumulation (`code_sums`): no one-hot, and no float atomics, so a card
run is deterministic. Random rows come from the
caller's `torch.Generator`.

Data parallelism (the JAX `axis_name` path, ops/codebook.py:124-220): a
training call given a process group holds this rank's rows; the counts
and sums are all-reduced, the usage and perplexity come from the global
counts, the commitment loss is the global mean, and the init and restart
rows are drawn from every rank's rows gathered in rank order with the
generator every rank shares, so N ranks hold the codebook one call on the
concatenated rows would. `vq_argmin_sharded` searches a table split over
a group (JAX `make_vq_argmin_sharded`).

Sequence parallelism: `sp_group` is the model group whose ranks hold a
block of every frame's rows. The commitment loss, counts, usage and
perplexity of an inference call are that group's; a training call's
statistics are its `group`'s (data x model), the model group by default.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..parallel import mesh
from .kernels.vq_argmin import vq_argmin


def code_sums(idx: torch.Tensor, rows: torch.Tensor, n_codes: int) -> torch.Tensor:
    """(n_codes, D) f32 sums of `rows` by code `idx`, without float atomics.
    On the card an accumulating index_put_: it sorts the indices and sums
    each code's rows in their order (two runs bit-equal, chip_smoke.py phase
    16a), where index_add_ adds with atomics in any order. On the CPU
    index_add_, which adds in row order."""
    out = torch.zeros(n_codes, rows.shape[1], device=rows.device)
    if rows.is_cuda:
        return out.index_put_((idx,), rows.float(), accumulate=True)
    return out.index_add_(0, idx, rows.float())


def vq_argmin_sharded(flat: torch.Tensor, emb_shard: torch.Tensor, group) -> torch.Tensor:
    """Nearest-code indices with the code table split over `group` (JAX
    ops/codebook.py:54-79): rank r holds codes r*K/S .. (r+1)*K/S - 1 and
    scans them as a plain product (||e||^2 - 2 x.e, the row term left out
    as vq_argmin leaves it), then an all-gather of the per-slab (min
    distance, global index) pairs picks the winner, ties to the lowest
    index. `flat` (M, D) is the same on every rank; returns (M,) int32."""
    x, e = flat.float(), emb_shard.float()
    d = (e * e).sum(1)[None, :] - 2.0 * (x @ e.t())
    ld, li = torch.min(d, dim=1)  # the first minimum: the lowest index in the slab
    gi = li.to(torch.int32) + mesh.rank_in(group) * e.shape[0]
    lds = torch.stack(mesh.all_gather(ld.contiguous(), group))  # (S, M)
    gis = torch.stack(mesh.all_gather(gi.contiguous(), group))
    win = torch.argmin(lds, dim=0)  # the lowest slab among equal minima
    return torch.gather(gis, 0, win[None, :])[0]


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
                generator: Optional[torch.Generator] = None,
                group=None, sp_group=None) -> Dict[str, torch.Tensor]:
        """z (B, T, H, W, D) channels-last latents -> dict(embeddings,
        encodings, commitment_loss, perplexity, avg_usage, batch_usage).
        training=True searches the (initialized) codes and then advances
        the buffers; `generator` draws the init and restart rows; `group`
        makes the statistics and the advance those of every rank's rows;
        `sp_group` those of an inference call (sequence parallelism)."""
        bshape = z.shape[:-1]
        flat = z.reshape(-1, self.embedding_dim).float()
        emb = self.embeddings
        if not training or group is None:
            group = sp_group
        all_rows = None
        if training:
            # the first training batch initializes the codes from its rows
            all_rows = flat.detach()
            if group is not None:  # every rank's rows, whatever their counts
                sizes = mesh.counts_of(flat.shape[0], group, flat.device)
                all_rows = torch.cat(mesh.all_gather(all_rows, group, sizes))
            cand = tile_to_codes(all_rows, self.n_codes, generator)
            fresh = self.initialized == 0
            emb = torch.where(fresh, cand, emb)
            z_avg = torch.where(fresh, cand, self.z_avg)
            n_state = torch.where(fresh, torch.ones_like(self.N), self.N)

        indices = vq_argmin(flat.detach().contiguous(), emb.float().contiguous())
        idx = indices.long()
        quantized = emb[idx].reshape(z.shape).float()

        z32 = z.float()
        sq = (z32 - quantized).square()
        counts, rows = torch.bincount(idx, minlength=self.n_codes).float(), idx.shape[0]
        if group is None:
            commitment_loss = 0.25 * sq.mean()
        else:
            # every rank's counts and rows, in one collective: ranks may hold unequal rows
            both = mesh.all_reduce_(torch.cat([counts, counts.new_tensor([rows])]), group)
            counts, total = both[:-1], int(both[-1].item())
            # the group's mean as the mean of each rank's mean weighted by its share
            # of the rows; that weight is exactly 1 under equal blocks, where this
            # is the mean of the ranks' means bit for bit (a world of one: the plain mean)
            weight = rows * mesh.size_of(group) / total
            local = sq.mean() * weight if rows else sq.sum()  # a rank with no rows adds 0
            commitment_loss = mesh.mean_over(0.25 * local, group)
            rows = total
        avg_probs = counts / rows
        perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())

        usage = self.codebook_usage
        if training:
            with torch.no_grad():
                usage = self._advance(flat.detach(), idx, counts, avg_probs, n_state, z_avg,
                                      generator, group, all_rows)
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

    def _advance(self, flat, idx, counts, batch_usage, n_state, z_avg, generator, group,
                 all_rows) -> torch.Tensor:
        """The EMA step, written into the buffers; returns the new usage."""
        decay = self.DECAY
        encode_sum = mesh.all_reduce_(code_sums(idx, flat, self.n_codes), group)
        new_n = n_state * decay + counts * (1.0 - decay)
        new_z_avg = z_avg * decay + encode_sum * (1.0 - decay)
        n = new_n.sum()
        weights = (new_n + 1e-7) / (n + self.n_codes * 1e-7) * n
        new_emb = new_z_avg / weights[:, None]
        if not self.no_random_restart:
            k_rand = tile_to_codes(all_rows, self.n_codes, generator)
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
