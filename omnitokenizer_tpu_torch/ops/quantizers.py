"""The external quantizer library (mirror of `omnitokenizer_tpu.ops.quantizers`,
the vendored lucidrains quantizers): FSQ, LFQ, VectorQuantize (euclidean or
cosine codebooks, kmeans init, EMA) and their residual stacks, as plain
torch functions over explicit state.

Draws are inputs: kmeans takes its initial sample indices (`kmeans_idx`)
or a `torch.Generator`, and a codebook's initial codes come from a
generator or are handed over, so a test can give the port the JAX
package's own draws. Where the JAX package psums the code counts and sums
over a mesh axis (`axis_name`), the port all-reduces them over a
`torch.distributed` process group, and only when the caller passes one.
No quantizer runs a kernel of its own (the JAX package gives none of them
a Pallas kernel); on the card keep TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`), or the distance and
similarity products round to TF32 and the indices move.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import mesh
from .codebook import code_sums


def _st(raw: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    """The straight-through estimator: raw's gradient, quantized's value."""
    return raw + (quantized - raw).detach()


def _l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """t / max(||t||, eps) over the last axis, as the JAX l2norm computes
    it (sqrt of the clamped sum of squares: a zero row has zero gradient)."""
    return t / torch.sqrt(torch.clamp_min((t * t).sum(-1, keepdim=True), eps * eps))


def _all_reduce(t: torch.Tensor, group: Any) -> torch.Tensor:
    return mesh.all_reduce_(t, group)


# -- FSQ ------------------------------------------------------------------------------------
class FSQ:
    """Finite scalar quantization: a bounded tanh grid a dim, rounded;
    levels (8, 5, 5, 5) make prod(levels) codes."""

    def __init__(self, levels: Sequence[int]):
        self.levels = tuple(levels)
        self._basis = np.concatenate([[1], np.cumprod(self.levels[:-1])]).astype(np.int64)

    @property
    def codebook_size(self) -> int:
        return int(np.prod(self.levels))

    @property
    def dim(self) -> int:
        return len(self.levels)

    def _consts(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        levels = torch.tensor(self.levels, dtype=torch.float32, device=device)
        return levels, torch.floor(levels / 2), torch.tensor(self._basis, device=device)

    def _bound(self, z: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
        half = (levels - 1) * (1 + 1e-3) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        shift = torch.tan(offset / half)
        return torch.tanh(z + shift) * half - offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """z (..., dim) -> the grid values, normalized to [-1, 1], straight
        through."""
        levels, half_width, _ = self._consts(z.device)
        bounded = self._bound(z, levels)
        return _st(bounded, torch.round(bounded)) / half_width

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        _, half_width, basis = self._consts(zhat.device)
        return ((zhat * half_width + half_width) * basis.float()).sum(-1).to(torch.int32)

    def indices_to_codes(self, idx: torch.Tensor) -> torch.Tensor:
        levels, half_width, basis = self._consts(idx.device)
        codes = torch.remainder(idx.long()[..., None] // basis, levels.long())
        return (codes - half_width) / half_width

    def __call__(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        zhat = self.quantize(z)
        return dict(embeddings=zhat, encodings=self.codes_to_indices(zhat.detach()),
                    commitment_loss=torch.zeros((), device=z.device))


# -- LFQ ------------------------------------------------------------------------------------
class LFQ:
    """Lookup-free quantization: the codes are sign bits (index bits most
    significant first); the loss is the commitment term plus, in training,
    the per-sample (confidence) entropy less the batch (diversity) entropy,
    both over per-bit Bernoulli posteriors sigmoid(4 * inv_temperature * z)."""

    def __init__(self, dim: int, entropy_loss_weight: float = 0.1, diversity_gamma: float = 1.0,
                 commitment_weight: float = 0.25, inv_temperature: float = 100.0):
        self.dim = dim
        self.entropy_loss_weight, self.diversity_gamma = entropy_loss_weight, diversity_gamma
        self.commitment_weight, self.inv_temperature = commitment_weight, inv_temperature
        self._mask = 2 ** np.arange(dim - 1, -1, -1, dtype=np.int64)

    @property
    def codebook_size(self) -> int:
        return 2 ** self.dim

    def indices_to_codes(self, idx: torch.Tensor) -> torch.Tensor:
        bits = (idx.long()[..., None] & torch.tensor(self._mask, device=idx.device)) > 0
        return torch.where(bits, 1.0, -1.0)

    def __call__(self, z: torch.Tensor, training: bool = False) -> Dict[str, torch.Tensor]:
        q = torch.where(z > 0, 1.0, -1.0)
        mask = torch.tensor(self._mask, device=z.device)
        indices = ((q > 0).long() * mask).sum(-1).to(torch.int32)
        quantized = _st(z, q)

        flat, q_flat = z.reshape(-1, self.dim).float(), q.reshape(-1, self.dim)
        loss = self.commitment_weight * (flat - q_flat.detach()).square().mean()
        if training:
            p = torch.sigmoid(4 * self.inv_temperature * flat)
            eps = 1e-8
            per_sample = -(p * torch.log(p + eps) + (1 - p) * torch.log(1 - p + eps))
            pbar = p.mean(0)
            batch = -(pbar * torch.log(pbar + eps) + (1 - pbar) * torch.log(1 - pbar + eps)).sum()
            loss = loss + self.entropy_loss_weight * (per_sample.sum(-1).mean()
                                                      - self.diversity_gamma * batch)
        return dict(embeddings=quantized, encodings=indices, commitment_loss=loss)


# -- VectorQuantize ---------------------------------------------------------------------------
class VQState(NamedTuple):
    embed: torch.Tensor         # (K, D)
    cluster_size: torch.Tensor  # (K,)
    embed_avg: torch.Tensor     # (K, D)
    initialized: torch.Tensor   # () int32


def vq_init_state(n_codes: int, dim: int, generator: Optional[torch.Generator] = None,
                  device: Any = None) -> VQState:
    """N(0, 1) codes drawn from `generator` (on `device`); zero cluster
    sizes; not initialized."""
    embed = torch.randn(n_codes, dim, generator=generator, device=device)
    return VQState(embed, torch.zeros(n_codes, device=embed.device), embed.clone(),
                   torch.zeros((), dtype=torch.int32, device=embed.device))


def kmeans_step(samples: torch.Tensor, means: torch.Tensor, cosine: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd step: each sample to its nearest mean (largest dot product
    when cosine), each mean to the average of its samples (renormalized
    when cosine; an empty cluster keeps its mean). -> (means, assignment)."""
    if cosine:
        assign = torch.argmax(samples @ means.t(), dim=1)
    else:
        d = ((samples * samples).sum(1, keepdim=True) - 2 * samples @ means.t()
             + (means * means).sum(1))
        assign = torch.argmin(d, dim=1)
    # the sums as one-hot products, as the JAX kmeans forms them: a GEMM is
    # deterministic on the card, where index_add_'s float atomics are not, and
    # one moved mean moves the next step's assignments
    onehot = torch.zeros(samples.shape[0], means.shape[0], device=samples.device).scatter_(
        1, assign[:, None], 1.0)
    counts, sums = onehot.sum(0), onehot.t() @ samples
    new = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1)[:, None], means)
    if cosine:
        new = new / torch.clamp_min(new.norm(dim=-1, keepdim=True), 1e-12)
    return new, assign


def kmeans(samples: torch.Tensor, n_clusters: int, iters: int = 10, cosine: bool = False,
           generator: Optional[torch.Generator] = None,
           init_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """kmeans (no ++ seeding) for the codebook init: the means start at the
    samples `init_idx` (else n_clusters drawn uniformly, with replacement,
    from `generator`), then `iters` Lloyd steps."""
    if init_idx is None:
        init_idx = torch.randint(0, samples.shape[0], (n_clusters,), generator=generator,
                                 device=samples.device)
    means = samples[init_idx.to(samples.device).long()]
    for _ in range(iters):
        means, _ = kmeans_step(samples, means, cosine)
    return means


class VectorQuantize:
    """An EMA vector quantizer, euclidean or cosine (inputs and codes
    l2-normalized: the CosineSimCodebook's semantics); with kmeans_init
    the first training call initializes the codes by kmeans on its batch."""

    def __init__(self, dim: int, codebook_size: int, decay: float = 0.8,
                 commitment_weight: float = 1.0, use_cosine_sim: bool = False,
                 kmeans_init: bool = True, kmeans_iters: int = 10, eps: float = 1e-5):
        self.dim, self.codebook_size, self.decay = dim, codebook_size, decay
        self.commitment_weight, self.use_cosine_sim = commitment_weight, use_cosine_sim
        self.kmeans_init, self.kmeans_iters, self.eps = kmeans_init, kmeans_iters, eps

    def init_state(self, generator: Optional[torch.Generator] = None,
                   device: Any = None) -> VQState:
        return vq_init_state(self.codebook_size, self.dim, generator, device=device)

    def __call__(self, z: torch.Tensor, state: VQState, training: bool = False,
                 generator: Optional[torch.Generator] = None,
                 kmeans_idx: Optional[torch.Tensor] = None,
                 group: Any = None) -> Tuple[Dict[str, torch.Tensor], VQState]:
        """z (..., dim) -> (dict(embeddings straight through, encodings,
        commitment_loss), the new state). A training call on an
        uninitialized state first takes kmeans of its batch as the codes
        (the JAX step computes the candidates on every training call and
        keeps them only then; the port runs kmeans only then), then
        advances the EMA of the cluster sizes and sums by `decay`, their
        counts all-reduced over `group` where given."""
        bshape = z.shape[:-1]
        flat = z.reshape(-1, self.dim).float()
        flat_n = _l2norm(flat) if self.use_cosine_sim else flat

        embed = state.embed
        if training and self.kmeans_init and int(state.initialized) == 0:
            embed = kmeans(flat_n.detach(), self.codebook_size, self.kmeans_iters,
                           self.use_cosine_sim, generator, kmeans_idx)

        if self.use_cosine_sim:
            lookup = embed / torch.clamp_min(embed.norm(dim=-1, keepdim=True), 1e-12)
            indices = torch.argmax(flat_n @ lookup.t(), dim=1)
        else:
            lookup = embed
            d = ((flat_n * flat_n).sum(1, keepdim=True) - 2 * flat_n @ embed.t()
                 + (embed * embed).sum(1))
            indices = torch.argmin(d, dim=1)
        quantized = lookup[indices]
        commit = self.commitment_weight * (flat_n - quantized.detach()).square().mean()

        new_state = state
        if training:
            with torch.no_grad():
                # no float atomics: the sums are deterministic on the card too
                counts = _all_reduce(torch.bincount(indices, minlength=self.codebook_size)
                                     .float(), group)
                sums = _all_reduce(code_sums(indices, flat_n, self.codebook_size), group)
                cs = state.cluster_size * self.decay + counts * (1 - self.decay)
                ea = state.embed_avg * self.decay + sums * (1 - self.decay)
                n = cs.sum()
                smoothed = (cs + self.eps) / (n + self.codebook_size * self.eps) * n
                new_embed = ea / torch.clamp_min(smoothed[:, None], 1e-12)
                if self.use_cosine_sim:
                    new_embed = new_embed / torch.clamp_min(
                        new_embed.norm(dim=-1, keepdim=True), 1e-12)
                new_state = VQState(new_embed, cs, ea, torch.ones_like(state.initialized))

        quant_st = _st(flat_n, quantized).reshape(*bshape, self.dim)
        return dict(embeddings=quant_st, encodings=indices.to(torch.int32).reshape(bshape),
                    commitment_loss=commit), new_state


# -- residual stacks --------------------------------------------------------------------------
def _residual(z: torch.Tensor, calls) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, list]:
    """Each call quantizes the residual left by the ones before it: -> (the
    embeddings' sum, the stacked indices, the summed losses, the calls'
    extra outputs)."""
    residual, total = z, torch.zeros_like(z)
    loss = torch.zeros((), device=z.device)
    indices, extras = [], []
    for call in calls:
        out, extra = call(residual)
        total = total + out["embeddings"]
        residual = residual - out["embeddings"].detach()
        loss = loss + out["commitment_loss"]
        indices.append(out["encodings"])
        extras.append(extra)
    return total, torch.stack(indices, dim=-1), loss, extras


class ResidualFSQ:
    def __init__(self, levels: Sequence[int], num_quantizers: int):
        self.layers = [FSQ(levels) for _ in range(num_quantizers)]

    def __call__(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        total, idx, _, _ = _residual(z, [lambda r, q=q: (q(r), None) for q in self.layers])
        return dict(embeddings=total, encodings=idx,
                    commitment_loss=torch.zeros((), device=z.device))


class ResidualLFQ:
    def __init__(self, dim: int, num_quantizers: int, **kw):
        self.layers = [LFQ(dim, **kw) for _ in range(num_quantizers)]

    def __call__(self, z: torch.Tensor, training: bool = False) -> Dict[str, torch.Tensor]:
        total, idx, loss, _ = _residual(
            z, [lambda r, q=q: (q(r, training=training), None) for q in self.layers])
        return dict(embeddings=total, encodings=idx, commitment_loss=loss)


class ResidualVQ:
    def __init__(self, dim: int, codebook_size: int, num_quantizers: int, **kw):
        self.layers = [VectorQuantize(dim, codebook_size, **kw) for _ in range(num_quantizers)]

    def init_state(self, generator: Optional[torch.Generator] = None,
                   device: Any = None) -> List[VQState]:
        return [q.init_state(generator, device) for q in self.layers]

    def __call__(self, z: torch.Tensor, states: Sequence[VQState], training: bool = False,
                 generators: Optional[Sequence[torch.Generator]] = None,
                 kmeans_idx: Optional[Sequence[torch.Tensor]] = None,
                 group: Any = None) -> Tuple[Dict[str, torch.Tensor], List[VQState]]:
        """The stack of VectorQuantize calls; layer i takes generators[i] or
        kmeans_idx[i] for its kmeans draw."""
        n = len(self.layers)
        gens = list(generators) if generators is not None else [None] * n
        idxs = list(kmeans_idx) if kmeans_idx is not None else [None] * n
        calls = [lambda r, q=q, s=s, g=g, i=i: q(r, s, training, g, i, group)
                 for q, s, g, i in zip(self.layers, states, gens, idxs)]
        total, idx, loss, new_states = _residual(z, calls)
        return dict(embeddings=total, encodings=idx, commitment_loss=loss), new_states
