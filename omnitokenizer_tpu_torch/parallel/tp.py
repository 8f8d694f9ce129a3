"""Megatron tensor parallelism of the GPT (mirror of
`omnitokenizer_tpu.parallel.tp`, its :39-100), on the port's torch names,
and the tokenizer's sequence parallelism (its :103-107, `sp_pixel_spec`).

The JAX package declares PartitionSpecs and lets GSPMD insert the
collectives; here each rank of a tensor-parallel group holds its shards
and `models/gpt.py` says the collectives (`parallel.mesh` copy_to /
reduce_from / gather_from):

  * attn.query/key/value and mlp.0 are column-parallel: their weights'
    output rows (and their biases) are split, so a rank computes its
    n_head / tp heads and its 4 C / tp hidden units;
  * attn.proj and mlp.2 are row-parallel: their weights' input columns are
    split, the partial products are all-reduced and the bias (replicated)
    is added once, after the sum;
  * tok_emb is split on C (its lookups are gathered), the head on the
    vocabulary (the logits are gathered);
  * everything else is replicated, and so is any of the above whose split
    dimension does not divide by the group's size (`shard_params`'s
    fallback: the canonical odd vocabulary 9193 keeps a replicated head).

The activations between the blocks are replicated, so every rank computes
the same loss, and a replicated parameter's gradient is the same on every
rank. The optimizer's moments are zeros like the local shards (the
optimizer's init over this rank's parameters, as JAX's `sharded_opt_init`
inherits the params' shardings), and the clip's global norm counts a
sharded gradient's squares over the group and a replicated one's once
(`global_norm`). `shard_state_dict` cuts a full state_dict (a checkpoint,
or `convert.gpt_state_dict_from_jax`'s carry-over) to a rank's shards;
`gather_state_dict` puts the shards back together for a checkpoint.

Sequence parallelism (SP): the JAX package shards the pixel rows of
(B, T, H, W, C) over the model axis and lets GSPMD insert the collectives.
Here a model group of n ranks (`mesh.grid(n).inner`) takes H/n pixel rows
a rank (`sp_shard_pixels`, JAX's equal blocks), and the tokenizer says
each collective itself once it is handed the group's `SeqParallel` (`sp=`
on OmniTokenizerNet and its modules).

The rows a rank computes come from `row_partition`: the coarsest token
grid the stacks reach (the encoder's after its pool blocks and deferred
spatial pool, the decoder's input) is split as evenly as it goes, rank r
taking g // n + (r < g % n) rows, so any empty ranks come last; every finer
grid's span is the coarse span times its factor, which keeps each pool
cell and each patch on one rank, and the deferred pool's odd last row
(flax's VALID pool drops it) stays with the rank that holds the row before
it. Where n divides the rows into whole patches and pool cells, the spans
are the equal blocks, and nothing moves. Otherwise the encoder first moves
its pixel rows to the partition's pixel spans, and the decoder moves its
reconstruction back to equal blocks (`mesh.rows_of` both ways); latents and
index grids stay on the partition (the even split of the latent rows).
Inside the stacks:

  * a spatial 't' block's PEG reads one halo row of tokens from each
    neighbour (`mesh.halo`), zeros at the frame's top and bottom;
  * a temporal block's PEG sees the reference's scrambled (B, T, H, W)
    reinterpretation of the (b h w) t tokens, in which a rank's tokens are
    one contiguous chunk of each batch element's volume, and a 3 x 3 x 3
    stencil there reaches up to 2 H W + W + 1 tokens back: it gathers that
    PEG's input over the group and computes the frames of the volume that
    its chunk touches, then keeps the chunk;
  * a spatial 't' block's attention projects its own rows and gathers K/V
    (`mesh.gather_summed`, whose backward sums over the group and keeps
    its block); its queries carry their global RoPE positions, an
    'einsum' call its rows of the CPB bias, and a grid of at most 8 tokens
    gathers q too for the small-group kernel;
  * 'w' windows that straddle two or more ranks' rows take the rows they
    miss from their owners (`mesh.rows_of`, sends and receives); whole
    windows stay local;
  * pool and up blocks, the deferred pools and their repeats, the patch
    embeds and to-pixels, feed-forwards, norms, the temporal attention,
    the pre- and post-VQ projections and the codebook search are per
    token, per patch or inside a rank's rows, and stay local; the cnn
    embed's GroupNorm sums its statistics and counts over the group;
  * the commitment loss is the group's summed squared error over its
    element count, a VAE's KL its sum over B.

Every gather takes each rank's row count (`mesh.all_gather` pads the
blocks to the longest and trims them). A rank that holds no rows of a grid
launches no kernel there but joins every collective, in the same order.
Every rank computes the same loss; the ranks' gradients averaged
(`mesh.average_grads_` over the group, or over data x model) are the
one-process gradient. `sp_gather` puts the rows back together. Refused
under SP, each with its reason: pixel rows that do not divide by n (the
JAX package's placement refuses them too), a bf16 training-route call,
and the GAN trainer.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import mesh

# the column-parallel weights and biases (their output dimension, torch's dim 0)
_COL_PARALLEL = re.compile(r"(attn\.(query|key|value)|mlp\.0)\.(weight|bias)$")
# the row-parallel weights (their input dimension, torch's dim 1); their biases replicate
_ROW_PARALLEL = re.compile(r"(attn\.proj|mlp\.2)\.weight$")


def gpt_param_dims(shapes: Dict[str, torch.Size], n: int) -> Dict[str, Optional[int]]:
    """The dimension each GPT tensor is split on over n ranks (None:
    replicated), the JAX `gpt_param_specs` in torch's (out, in) layout,
    with `shard_params`'s fallback where a dimension does not divide."""
    dims = {}
    for name, shape in shapes.items():
        d = None
        if _COL_PARALLEL.search(name):
            d = 0
        elif _ROW_PARALLEL.search(name):
            d = 1
        elif name == "tok_emb.weight":  # (V, C): split on C
            d = 1
        elif name == "head.weight":  # (V, C): split on the vocabulary
            d = 0
        if d is not None and shape[d] % n:
            d = None
        dims[name] = d
    return dims


def _shard(t: torch.Tensor, dim: Optional[int], rank: int, n: int) -> torch.Tensor:
    if dim is None or n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size)


def check_layout(n_head: int, n_embd: int, n: int) -> None:
    """The JAX CLI's checks: head-aligned shards, n_embd and 4 n_embd divide."""
    if n_head % n:
        raise ValueError(f"n_head {n_head} must divide by --model_parallel {n} "
                         "(head-aligned tensor-parallel shards)")
    if n_embd % n or (4 * n_embd) % n:
        raise ValueError(f"n_embd {n_embd} and 4*n_embd must divide by --model_parallel {n}")


def shard_state_dict(sd: Dict[str, torch.Tensor], rank: int, n: int) -> Dict[str, torch.Tensor]:
    """A full GPT state_dict -> rank `rank`'s shards of it (copies)."""
    dims = gpt_param_dims({k: v.shape for k, v in sd.items()}, n)
    return {k: _shard(v, dims[k], rank, n).clone() for k, v in sd.items()}


def shard_gpt(gpt: nn.Module, group: Any) -> nn.Module:
    """Cut a full GPT's parameters to this rank's shards, in place (on any
    device, the meta device too), and wire the group into its forward.
    A group of one leaves the GPT as it is."""
    n, r = mesh.size_of(group), mesh.rank_in(group)
    if n == 1:
        return gpt
    cfg = gpt.cfg
    check_layout(cfg.n_head, cfg.n_embd, n)
    if cfg.int8_decode:
        raise ValueError("int8 decode and tensor parallelism are mutually exclusive")
    dims = gpt_param_dims({k: p.shape for k, p in gpt.named_parameters()}, n)
    for name, p in list(gpt.named_parameters()):
        if dims[name] is None:
            continue
        owner = gpt.get_submodule(name.rsplit(".", 1)[0]) if "." in name else gpt
        leaf = name.rsplit(".", 1)[-1]
        with torch.no_grad():
            setattr(owner, leaf, nn.Parameter(_shard(p.detach(), dims[name], r, n).clone(),
                                              requires_grad=p.requires_grad))
    gpt.set_tensor_parallel(group, dims)
    return gpt


def sharded_mask(gpt: nn.Module) -> List[bool]:
    """Whether each parameter (in gpt.parameters() order) is split."""
    dims = getattr(gpt, "tp_dims", None) or {}
    return [dims.get(n) is not None for n, _ in gpt.named_parameters()]


def global_norm(grads: List[torch.Tensor], mask: List[bool], group: Any) -> torch.Tensor:
    """The global norm of the whole (unsharded) gradient: the split
    gradients' squares summed over the group, the replicated ones' once."""
    sq = torch.stack([g.float().square().sum() for g in grads])
    m = torch.tensor(mask, device=sq.device)
    split = mesh.all_reduce_(torch.where(m, sq, torch.zeros_like(sq)).sum(), group)
    return (split + torch.where(m, torch.zeros_like(sq), sq).sum()).sqrt()


def gather_state_dict(tensors: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                      group: Any) -> Dict[str, torch.Tensor]:
    """Every rank's shards of `tensors` (named as in `dims`) put back
    together along their split dimension; replicated ones as they are."""
    out = {}
    for k, v in tensors.items():
        d = dims.get(k)
        out[k] = v if d is None else torch.cat(mesh.all_gather(v.detach(), group), dim=d)
    return out


# -- sequence parallelism of the tokenizer --------------------------------------------------
Spans = Tuple[Tuple[int, int], ...]  # each rank's rows [lo, hi) of a grid, in rank order


def even_spans(rows: int, n: int) -> Spans:
    """`rows` split over n ranks as evenly as it goes: rank r takes
    rows // n + (r < rows % n) of them, so the empty ranks come last."""
    out, lo = [], 0
    for r in range(n):
        hi = lo + rows // n + (r < rows % n)
        out.append((lo, hi))
        lo = hi
    return tuple(out)


def rescale(spans: Spans, rows: int) -> Spans:
    """The spans of a neighbouring grid of `rows` rows: twice the rows
    (an up block, or the finer side of a pool, whose odd last row a VALID
    pool drops: it goes with the row before it), or half of them (each
    2-row cell on one rank)."""
    have = spans[-1][1]
    if rows == have:
        return spans
    if rows >= 2 * have:
        out = [(2 * lo, 2 * hi) for lo, hi in spans]
        if rows > 2 * have:  # the odd last row
            k = max([r for r, (lo, hi) in enumerate(spans) if hi > lo] or [0])
            out = [(lo + (r > k), hi + (r >= k)) for r, (lo, hi) in enumerate(out)]
        return tuple(out)
    if any(b % 2 and b != have for span in spans for b in span):
        raise ValueError(f"sequence parallelism: the spans {spans} cut a 2 x 2 pool cell")
    return tuple((lo // 2, hi // 2) for lo, hi in spans)


def _walk(grids: Sequence[int], n: int) -> Tuple[Spans, ...]:
    """Each grid's spans: the first coarsest grid split evenly, every other
    one rescaled from its neighbour towards it."""
    c = grids.index(min(grids))
    out = [None] * len(grids)
    out[c] = even_spans(grids[c], n)
    for i in range(c - 1, -1, -1):
        out[i] = rescale(out[i + 1], grids[i])
    for i in range(c + 1, len(grids)):
        out[i] = rescale(out[i - 1], grids[i])
    return tuple(out)


def _block_grids(block: str, rows: int) -> List[int]:
    """The rows after each block of a stack ('n'/'r' double, 'a'/'m'/'l' halve)."""
    out = []
    for blk in block:
        rows = 2 * rows if blk in "nr" else rows // 2 if blk in "aml" else rows
        out.append(rows)
    return out


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Each rank's span of rows at every grid of a round trip: `encoder`
    at the embed's token grid, after each spatial block and after the
    deferred spatial pool; `decoder` at its input grid, after the deferred
    repeat and after each spatial block; and the pixel rows of each end."""

    pixels: Spans
    encoder: Tuple[Spans, ...]
    decoder: Tuple[Spans, ...]
    recon: Spans

    @property
    def latent(self) -> Spans:
        """The latents' and indices' rows: the even split of the latent grid."""
        return even_spans(self.decoder[0][-1][1], len(self.pixels))


def encoder_spans(cfg: Any, pixel_rows: int, n: int) -> Tuple[Spans, Tuple[Spans, ...]]:
    """(pixel spans, token spans at each encoder grid) of a frame of
    `pixel_rows` rows over n ranks."""
    from ..models.tokenizer import patch_sizes  # which imports this module

    p = patch_sizes(cfg)[0]
    if pixel_rows % p:
        raise ValueError(f"sequence parallelism: {pixel_rows} pixel rows are not whole "
                         f"patches of {p}")
    grids = [pixel_rows // p] + _block_grids(cfg.enc_block, pixel_rows // p)
    if cfg.patch_embed == "linear" and cfg.defer_spatial_pool:
        grids.append(grids[-1] // 2)  # flax's VALID pool
    spans = _walk(grids, n)
    return tuple((lo * p, hi * p) for lo, hi in spans[0]), spans


def decoder_spans(cfg: Any, latent_rows: int, n: int) -> Tuple[Tuple[Spans, ...], Spans]:
    """(token spans at each decoder grid, pixel spans of the
    reconstruction) of a latent grid of `latent_rows` rows over n ranks."""
    from ..models.tokenizer import patch_sizes  # which imports this module

    grids = [latent_rows]
    if cfg.patch_embed == "linear" and cfg.defer_spatial_pool:
        grids.append(2 * latent_rows)
    grids += _block_grids(cfg.dec_block, grids[-1])
    spans = _walk(grids, n)
    p = patch_sizes(cfg, decoder=True)[0]
    return spans, tuple((lo * p, hi * p) for lo, hi in spans[-1])


def row_partition(cfg: Any, pixel_rows: int, n: int) -> RowPartition:
    """The partition of a round trip of frames of `pixel_rows` rows over n
    ranks (`cfg` a TokenizerConfig)."""
    pixels, enc = encoder_spans(cfg, pixel_rows, n)
    dec, recon = decoder_spans(cfg, enc[-1][-1][1], n)
    return RowPartition(pixels=pixels, encoder=enc, decoder=dec, recon=recon)


@dataclasses.dataclass(frozen=True)
class SeqParallel:
    """A model group of `size` ranks; rank `rank` holds rows spans[rank] of
    the current grid, `cols` columns wide (the stacks set both for the
    modules they call)."""

    group: Any
    rank: int
    size: int
    spans: Optional[Spans] = None
    cols: int = 0

    def at(self, spans: Spans, cols: int = 0) -> "SeqParallel":
        """This group at a grid of these spans and columns."""
        return dataclasses.replace(self, spans=tuple(map(tuple, spans)), cols=cols)

    def refuse(self, what: str, why: str) -> None:
        raise ValueError(f"sequence parallelism: {what} is not supported ({why})")


def seq_parallel(group: Any) -> Optional[SeqParallel]:
    """The SP context of a model group; None for no group or a group of
    one, which runs the one-process path."""
    n = mesh.size_of(group)
    return None if n == 1 else SeqParallel(group, mesh.rank_in(group), n)


def sp_shard_pixels(x: torch.Tensor, group: Any) -> torch.Tensor:
    """This rank's block of pixel rows of x (B, T, H, W, C)."""
    n, r = mesh.size_of(group), mesh.rank_in(group)
    if x.shape[2] % n:
        raise ValueError(f"sequence parallelism: {x.shape[2]} pixel rows do not divide "
                         f"over {n} ranks")
    h = x.shape[2] // n
    return x.narrow(2, r * h, h)


def sp_gather(x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """Every rank's rows of x along `dim`, in rank order, whatever their
    counts: the whole reconstruction (dim 2 of (B, T, H, W, C)), latents
    or grid of indices (dim 2 of (B, t, h, w)). The counts are gathered
    first."""
    if group is None:
        return x
    return mesh.gather_from(x, dim, group, mesh.counts_of(x.shape[dim], group, x.device))
