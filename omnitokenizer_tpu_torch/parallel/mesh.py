"""Process groups, placement and collectives (mirror of
`omnitokenizer_tpu.parallel.mesh` and the JAX CLIs' multi-process bring-up,
`cli/args.apply_platform_env`).

Where the JAX package runs one jitted step over a `Mesh(('data',))` and
lets XLA insert the collectives, the port runs one process a rank and says
each collective itself, over `torch.distributed`:

    group = init_distributed(device)        # None: one process, no group
    rows = shard_batch(global_batch, group) # this rank's rows
    replicate(module, group)                # rank 0's parameters everywhere

A job is launched with torchrun (RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT) or with the JAX CLIs' variables: OMNITOK_COORD (host:port of
rank 0), OMNITOK_NPROCS and OMNITOK_PROC_ID. OMNITOK_NO_DIST opts out.
As in the JAX package, merely running inside a batch allocation starts no
job, and a coordinator without a process count and id is refused, not
guessed. The backend is NCCL for CUDA tensors and gloo for CPU ones, but
where the launch puts more CUDA ranks on one host than it has cards (NCCL
refuses two ranks on one device) the ranks talk over gloo: each rank posts
its host name to the rendezvous store and counts its neighbours. gloo
carries broadcast and all_reduce of CUDA tensors only, so under gloo every
collective here stages a CUDA tensor through host memory; the compute
stays on the card.

`grid(n_inner)` lays the world out as a (data, inner) grid, the inner axis
innermost (the JAX `tp_mesh`'s ('data', 'model') and the pipeline's
stages): ranks d * n_inner .. d * n_inner + n_inner - 1 share data row d.

The autograd-aware collectives (`mean_over`, `sum_over`, `copy_to`,
`reduce_from`, `gather_from`, and sequence parallelism's `gather_summed`,
`halo` and `rows_of`) make a cross-rank quantity differentiable: each rank's
gradient is what the one-process program computes for that rank's inputs
once the ranks' gradients are summed. The gathers and the halo take each
rank's row count, which may differ from rank to rank and be 0.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

# -- bring-up -------------------------------------------------------------------------------
def launch_env() -> Optional[tuple]:
    """(init_method, world size, rank) of a launched job, or None: torchrun's
    variables or OMNITOK_COORD with OMNITOK_NPROCS and OMNITOK_PROC_ID."""
    if os.environ.get("OMNITOK_NO_DIST"):
        return None
    coord = os.environ.get("OMNITOK_COORD")
    if coord:
        nprocs, pid = os.environ.get("OMNITOK_NPROCS"), os.environ.get("OMNITOK_PROC_ID")
        if nprocs is None or pid is None:
            raise RuntimeError(
                "OMNITOK_COORD is set but OMNITOK_NPROCS/OMNITOK_PROC_ID are not: refusing to "
                "guess (every host would come up as an independent 1-process job)")
        return f"tcp://{coord}", int(nprocs), int(pid)
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    return None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


TIMEOUT = datetime.timedelta(minutes=30)


def ranks_on_host(store: Any, rank: int, world: int) -> int:
    """How many of the world's ranks run on this host: each posts its host
    name to the rendezvous store, then reads every rank's."""
    host = socket.gethostname()
    store.set(f"omnitok_host/{rank}", host)
    keys = [f"omnitok_host/{r}" for r in range(world)]
    store.wait(keys)
    return sum(store.get(k).decode() == host for k in keys)


def default_backend(device: Any, ranks_here: int) -> str:
    """NCCL for CUDA ranks unless more of them (`ranks_here`) share this
    host than it has cards; gloo then, and for CPU ranks."""
    if torch.device(device).type == "cuda" and ranks_here <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device: Any = "cuda", world_of_one: bool = False) -> Optional[Any]:
    """The default process group of a launched job (see `launch_env`), or
    with `world_of_one` and no launch a world of one on a local port; None
    when neither. A CUDA rank takes card LOCAL_RANK (modulo the cards)."""
    if dist.is_initialized():
        return dist.group.WORLD
    env = launch_env()
    if env is None:
        if not world_of_one:
            return None
        env = (f"tcp://localhost:{free_port()}", 1, 0)
    init, world, rank = env
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the ranks on the CPU")
    store, rank, world = next(dist.rendezvous(init, rank, world, timeout=TIMEOUT))
    store.set_timeout(TIMEOUT)
    backend = "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
        backend = default_backend(dev, ranks_on_host(store, rank, world))
    dist.init_process_group(backend, store=store, world_size=world, rank=rank, timeout=TIMEOUT)
    return dist.group.WORLD


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    """This process's rank in the world; 0 without a job (JAX's process_index)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The world's ranks; 1 without a job (JAX's process_count)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_group() -> Any:
    """The default group of a job of more than one rank, else None."""
    return dist.group.WORLD if world() > 1 else None


def size_of(group: Any) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_in(group: Any) -> int:
    return 0 if group is None else dist.get_rank(group)


@dataclasses.dataclass
class Grid:
    """A (data, inner) layout of the world: `inner` groups the ranks of one
    data row (a tensor-parallel group, or a pipeline's stages), `data` the
    ranks at one inner position across rows."""

    data: Any
    inner: Any
    data_rank: int
    data_size: int
    inner_rank: int
    inner_size: int


def grid(n_inner: int) -> Grid:
    """Split the world into world / n_inner data rows of n_inner ranks, the
    inner axis innermost. Every rank builds every group, in one order."""
    n = world()
    if n % n_inner:
        raise ValueError(f"{n} ranks do not divide into groups of {n_inner}")
    me = rank()
    inner = data = None
    for d in range(n // n_inner):
        ranks = list(range(d * n_inner, (d + 1) * n_inner))
        g = dist.new_group(ranks)
        if me in ranks:
            inner = g
    for i in range(n_inner):
        ranks = list(range(i, n, n_inner))
        g = dist.new_group(ranks)
        if me in ranks:
            data = g
    return Grid(data=data, inner=inner, data_rank=me // n_inner, data_size=n // n_inner,
                inner_rank=me % n_inner, inner_size=n_inner)


# -- collectives ------------------------------------------------------------------------------
def _staged(t: torch.Tensor, group: Any) -> bool:
    """gloo with a CUDA tensor: the hop goes through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _gloo(group: Any) -> bool:
    return dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group: Any) -> torch.Tensor:
    """What gloo moves for a copy-only hop: a 16-bit float as its bytes."""
    if _gloo(group) and t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.uint8)
    return t


def all_reduce_(t: torch.Tensor, group: Any, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all_reduce over `group` (identity without one). Under gloo
    a 16-bit float is summed in f32 (on the host), then rounded back."""
    if group is None:
        return t
    if _gloo(group) and (t.is_cuda or t.dtype in (torch.bfloat16, torch.float16)):
        wide = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype
        host = t.detach().to("cpu", wide)
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group: Any, sizes: Optional[Sequence[int]] = None,
               dim: int = 0) -> List[torch.Tensor]:
    """Every rank's `t`, in rank order: one shape on all ranks, or with
    `sizes` each rank's length along `dim` (the rest of the shape one).
    Unequal blocks are padded to the longest, gathered, then trimmed, on
    gloo and NCCL alike (NCCL's all_gather takes equal blocks)."""
    if group is None:
        return [t]
    longest = None if sizes is None or len(set(sizes)) == 1 else max(sizes)
    if longest is not None and t.shape[dim] < longest:
        pad = list(t.shape)
        pad[dim] = longest - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    wire = _wire(src, group)
    out = [torch.empty_like(wire) for _ in range(size_of(group))]
    dist.all_gather(out, wire, group=group)
    out = [o.view(t.dtype) for o in out]
    if staged:
        out = [o.to(t.device) for o in out]
    return out if longest is None else [o.narrow(dim, 0, n) for o, n in zip(out, sizes)]


def counts_of(n: int, group: Any, device: Any = "cpu") -> List[int]:
    """Every rank's count `n` (a row count), in rank order."""
    if group is None:
        return [n]
    return [int(c) for c in all_gather(torch.tensor([n], device=device), group)]


def broadcast_(t: torch.Tensor, src: int, group: Any) -> torch.Tensor:
    """In place from `src`, a rank of `group`."""
    if group is None:
        return t
    gsrc = dist.get_global_rank(group, src)
    if _staged(t, group) or not t.is_contiguous():
        host = t.contiguous().cpu() if _staged(t, group) else t.contiguous()
        dist.broadcast(_wire(host, group), gsrc, group=group)
        return t.copy_(host)
    dist.broadcast(_wire(t, group), gsrc, group=group)
    return t


def send(t: torch.Tensor, dst: int, group: Any) -> None:
    """Point-to-point to `dst`, a rank of `group`."""
    t = t.detach().contiguous()
    dist.send(_wire(t.cpu() if _staged(t, group) else t, group),
              dist.get_global_rank(group, dst), group=group)


def recv(shape: Sequence[int], dtype: torch.dtype, device: Any, src: int, group: Any
         ) -> torch.Tensor:
    """A tensor of `shape` from `src`, a rank of `group`."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if _staged(out, group):
        host = torch.empty(tuple(shape), dtype=dtype)
        dist.recv(_wire(host, group), dist.get_global_rank(group, src), group=group)
        return out.copy_(host)
    dist.recv(_wire(out, group), dist.get_global_rank(group, src), group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient is summed over the group too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _CopyTo(torch.autograd.Function):
    """Identity forward (the input of a column-parallel product); the
    gradient is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group forward (a row-parallel product's partial sums);
    the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _block(x: torch.Tensor, dim: int, group: Any, sizes: Optional[Sequence[int]]) -> tuple:
    """(start, length) of this rank's block along `dim` of the gathered
    whole: equal blocks of x's length, or those of `sizes`."""
    r = rank_in(group)
    if sizes is None:
        return r * x.shape[dim], x.shape[dim]
    return sum(sizes[:r]), sizes[r]


class _GatherFrom(torch.autograd.Function):
    """Concatenate every rank's shard along `dim`; the gradient of the
    replicated result is the same on every rank, so each takes its slice."""

    @staticmethod
    def forward(ctx, x, dim, group, sizes):
        ctx.dim, ctx.block = dim, _block(x, dim, group, sizes)
        return torch.cat(all_gather(x, group, sizes, dim), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, *ctx.block).contiguous(), None, None, None


class _GatherSummed(torch.autograd.Function):
    """Concatenate every rank's block along `dim` where each rank's own
    computation reads the whole (sequence parallelism: a rank's queries
    attend to every rank's keys). Each rank's gradient of the result is its
    own part, so the backward sums it over the group (an all_reduce of the
    whole gradient: gloo has no reduce-scatter) and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group, sizes):
        ctx.dim, ctx.group, ctx.block = dim, group, _block(x, dim, group, sizes)
        return torch.cat(all_gather(x, group, sizes, dim), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.narrow(ctx.dim, *ctx.block).contiguous(), None, None, None


class _Halo(torch.autograd.Function):
    """(before, after): the previous rank's last k rows of x along `dim` and
    the next rank's first k rows, zeros at the frame's two ends: past the
    group's ends, and past the last rank that holds rows (`sizes`: each
    rank's rows, 0 or at least k; an empty rank's halos are zeros). The
    backward adds each halo's gradient onto the rows it was read from."""

    @staticmethod
    def forward(ctx, x, dim, k, group, sizes):
        n, r = size_of(group), rank_in(group)
        held = [True] * n if sizes is None else [s > 0 for s in sizes]
        ctx.dim, ctx.k, ctx.group, ctx.shape, ctx.held = dim, k, group, x.shape, held
        if held[r]:
            ends = torch.stack([x.narrow(dim, 0, k), x.narrow(dim, x.shape[dim] - k, k)])
        else:
            ends = x.new_zeros((2,) + x.shape[:dim] + (k,) + x.shape[dim + 1:])
        every = all_gather(ends, group)
        zero = torch.zeros_like(every[0][0])
        before = every[r - 1][1] if held[r] and r > 0 else zero
        after = every[r + 1][0] if held[r] and r < n - 1 and held[r + 1] else zero
        return before, after

    @staticmethod
    def backward(ctx, g_before, g_after):
        n, r, dim, k, held = size_of(ctx.group), rank_in(ctx.group), ctx.dim, ctx.k, ctx.held
        every = all_gather(torch.stack([g_before, g_after]), ctx.group)
        gx = g_before.new_zeros(ctx.shape)
        if held[r] and r > 0:  # this rank's first rows were the previous rank's `after`
            gx.narrow(dim, 0, k).add_(every[r - 1][1])
        if held[r] and r < n - 1 and held[r + 1]:  # its last rows the next rank's `before`
            gx.narrow(dim, ctx.shape[dim] - k, k).add_(every[r + 1][0])
        return gx, None, None, None, None


def _p2p(sends: list, recvs: list, like: torch.Tensor, group: Any) -> List[torch.Tensor]:
    """One batch of point-to-point hops over `group`: `sends` as (tensor,
    dst) and `recvs` as (shape, src), ranks of the group, every tensor of
    like's dtype; returns the received tensors, in the order of `recvs`, on
    like's device. A batch cannot deadlock, whatever each rank's order of
    sends and receives; under gloo a CUDA tensor hops through host memory."""
    dev = torch.device("cpu") if _staged(like, group) else like.device
    bufs = [torch.empty(tuple(shape), dtype=like.dtype, device=dev) for shape, _ in recvs]
    ops = [dist.P2POp(dist.irecv, _wire(b, group), dist.get_global_rank(group, src), group)
           for b, (_, src) in zip(bufs, recvs)]
    ops += [dist.P2POp(dist.isend, _wire(t.detach().to(dev).contiguous(), group),
                       dist.get_global_rank(group, dst), group) for t, dst in sends]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(like.device) for b in bufs]


def _overlap(want: tuple, have: tuple) -> tuple:
    """Rows [lo, hi) of the whole that span `want` and span `have` share
    (lo >= hi: none)."""
    return max(want[0], have[0]), min(want[1], have[1])


class _Rows(torch.autograd.Function):
    """Rows want[r] = (lo, hi) along `dim` of the whole that the group's
    blocks make end to end, rank r holding rows have[r], on every rank r at
    once: each rank sends its rows to the ranks whose span reaches them and
    receives those of its span from their owners. The backward sends each
    borrowed row's gradient back to its owner, which adds it to its own."""

    @staticmethod
    def forward(ctx, x, dim, want, have, group):
        me = rank_in(group)
        ctx.dim, ctx.want, ctx.have, ctx.group, ctx.shape = dim, want, have, group, x.shape
        base = have[me][0]
        sends, recvs = [], []
        for s in range(len(want)):
            if s == me:
                continue
            a, b = _overlap(want[s], have[me])  # what rank s reads of my rows
            if a < b:
                sends.append((x.narrow(dim, a - base, b - a), s))
            a, b = _overlap(want[me], have[s])  # what I read of rank s's rows
            if a < b:
                recvs.append(([b - a if d == dim else k for d, k in enumerate(x.shape)], s))
        got = dict(zip([s for _, s in recvs], _p2p(sends, recvs, x, group)))
        a, b = _overlap(want[me], have[me])
        got[me] = x.narrow(dim, a - base, b - a) if a < b else x.narrow(dim, 0, 0)
        return torch.cat([got[s] for s in sorted(got)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, want, have, group = ctx.dim, ctx.want, ctx.have, ctx.group
        me = rank_in(group)
        lo, base = want[me][0], have[me][0]
        sends, recvs = [], []
        for s in range(len(want)):
            if s == me:
                continue
            c, d = _overlap(want[me], have[s])  # the gradient of rank s's rows that I read
            if c < d:
                sends.append((g.narrow(dim, c - lo, d - c), s))
            a, b = _overlap(want[s], have[me])  # that of my rows that rank s read
            if a < b:
                recvs.append(([b - a if i == dim else k for i, k in enumerate(g.shape)], s, a))
        got = _p2p(sends, [(shape, s) for shape, s, _ in recvs], g, group)
        gx = g.new_zeros(ctx.shape)
        a, b = _overlap(want[me], have[me])
        if a < b:
            gx.narrow(dim, a - base, b - a).add_(g.narrow(dim, a - lo, b - a))
        for (_, _, start), piece in zip(recvs, got):
            gx.narrow(dim, start - base, piece.shape[dim]).add_(piece)
        return gx, None, None, None, None


def _sizes(sizes: Optional[Sequence[int]]) -> Optional[tuple]:
    return None if sizes is None else tuple(int(s) for s in sizes)


def gather_summed(x: torch.Tensor, dim: int, group: Any,
                  sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's block of x along `dim`, in rank order (`sizes`: each
    rank's length, if they differ); the backward sums the gradient over the
    group and keeps this rank's block (see _GatherSummed). x itself
    without a group. A profiler trace shows the call as the range
    "sp.gather"."""
    if group is None:
        return x
    with record_function("sp.gather"):
        return _GatherSummed.apply(x, dim, group, _sizes(sizes))


def rows_of(x: torch.Tensor, dim: int, spans: Sequence[tuple], group: Any,
            have: Sequence[tuple]) -> torch.Tensor:
    """Rows spans[rank] = (lo, hi) along `dim` of the whole that the group's
    blocks of x make end to end, rank r holding rows have[r], a span of each
    for every rank of the group (each rank passes the same lists): its own
    rows and the others', one batch of sends and receives; differentiable
    (see _Rows). A profiler trace shows the call as the range "sp.rows"."""
    with record_function("sp.rows"):
        return _Rows.apply(x, dim, tuple(map(tuple, spans)), tuple(map(tuple, have)), group)


def halo(x: torch.Tensor, dim: int, k: int, group: Any,
         sizes: Optional[Sequence[int]] = None) -> tuple:
    """The k rows along `dim` before this rank's block (the previous rank's
    last ones) and after it (the next rank's first ones), zeros beyond the
    frame's ends; differentiable. `sizes`: each rank's rows, 0 (a rank that
    holds none, after the last that holds some) or at least k; every rank
    holds at least k by default. A profiler trace shows the call as the
    range "sp.halo"."""
    with record_function("sp.halo"):
        return _Halo.apply(x, dim, k, group, _sizes(sizes))


def sum_over(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of x over the group's ranks, differentiable as `mean_over`."""
    return x if group is None else _AllReduceSum.apply(x, group)


def mean_over(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The mean of x over the group's ranks, differentiable: a global mean
    from per-rank means of equal-sized shards (x itself without a group)."""
    return x if group is None else _AllReduceSum.apply(x, group) / size_of(group)


def copy_to(x: torch.Tensor, group: Any) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Any) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group: Any,
                sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's block of x along `dim` (`sizes`: each rank's length, if
    they differ); each rank's gradient is its block's."""
    return x if group is None else _GatherFrom.apply(x, dim, group, _sizes(sizes))


# -- placement --------------------------------------------------------------------------------
def rank_rows(x: torch.Tensor, group: Any) -> torch.Tensor:
    """This rank's block of x's leading axis, split evenly over the group."""
    n = size_of(group)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"a leading axis of {x.shape[0]} does not split over {n} ranks")
    b = x.shape[0] // n
    return x[rank_in(group) * b:(rank_in(group) + 1) * b]


def shard_batch(batch: Any, group: Any) -> Any:
    """Every tensor of `batch` (a tensor, or a dict/list of them) cut to this
    rank's rows of its leading (global batch) axis."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, group) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, group) for v in batch)
    return rank_rows(batch, group) if isinstance(batch, torch.Tensor) else batch


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int], group: Any
              ) -> torch.Tensor:
    """This rank's rows of one draw for the whole group: `draw` takes the
    global shape (the leading axis times the ranks), so N ranks together
    hold what one process drawing for the concatenated batch holds."""
    shape = tuple(shape)
    n = size_of(group)
    if n == 1:
        return draw(shape)
    return rank_rows(draw((shape[0] * n,) + shape[1:]), group)


def replicate(tensors: Any, group: Any, src: int = 0) -> None:
    """Broadcast from `src` (a rank of the group), in place: a module's
    parameters and buffers, or an iterable of tensors."""
    if group is None:
        return
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    with torch.no_grad():
        for t in tensors:
            broadcast_(t.data, src, group)


def average_grads_(grads: Iterable[torch.Tensor], group: Any, mean: bool = True) -> None:
    """Each gradient summed over the group and divided by its ranks, in
    place: the gradient of the global mean loss from per-rank means (with
    mean=False the sum)."""
    if group is None:
        return
    grads = list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])  # one collective for all of them
    all_reduce_(flat, group)
    if mean:
        flat.div_(size_of(group))
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def broadcast_object(obj: Any, group: Any = None, src: int = 0) -> Any:
    """A picklable object from `src`; the object itself without a job."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src) if group else src,
                               group=group)
    return box[0]


def barrier(group: Any = None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)
