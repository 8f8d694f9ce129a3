"""minGPT-style LM with a KV cache, and its samplers (mirror of
`omnitokenizer_tpu.models.gpt`).

    gpt = GPT(cfg).to("cuda")
    init_weights(gpt, torch.Generator().manual_seed(0))
    logits, _ = gpt(idx)                              # full causal forward
    caches = init_cache(cfg, batch, "cuda")
    logits, caches = gpt(prefix, caches, pos=0)       # prefill: writes the cache
    sample = make_cfg_sampler(cfg, steps=1024, top_k=2048, bucket=256)
    tokens = sample(gpt, cls, torch.Generator("cuda").manual_seed(0))

Module names are the reference's torch ones (tok_emb, pos_emb,
blocks.{i}.ln1/ln2, blocks.{i}.attn.{query,key,value,proj},
blocks.{i}.mlp.{0,2}, ln_f, head), so a reference checkpoint is a plain
state_dict (utils/gpt_checkpoint.py). The parameters stay f32; a call
computes in `cfg.dtype`, casting them as the JAX package's Dense layers do,
and the samplers cast them once, before the loop.

The JAX package compiles a sampler into one lax.scan per attention window.
Here a decode step is a function of static buffers (the token, the step
index, the KV cache, the noise, the output tokens). On the card each
window's step is captured once as a CUDA graph and replayed for every step
of its segment; on the CPU, or with cuda_graphs=False, the same step runs
eagerly. Positions live on the device as a tensor, so the masks, the
position embedding and the in-place cache write (index_copy_) of one
captured step serve every step of its segment.

The full forward (no cache) is the training forward. In bf16 on the card,
from 256 tokens, its attention is the causal flash kernel with its backward
kernels (ops/kernels/flash_attn.py), as the JAX package's is the stock TPU
flash kernel behind the same gate (`_flash_ok`); elsewhere it materializes
the (B, H, T, T) f32 scores. Serving's cached calls keep the plain math.

Tensor parallelism (parallel/tp.py, the JAX Megatron layout): after
`tp.shard_gpt(gpt, group)` a rank holds its shards and the forwards say
the collectives: the column-parallel inputs pass `mesh.copy_to` (their
gradient summed over the group), the row-parallel partial products are
summed by `mesh.reduce_from` before their bias, and the C-split embedding
and the vocabulary-split head gather their outputs. A rank's attention
runs its n_head / tp heads (through the flash kernels behind `_flash_ok`
in training), and its KV caches hold those heads.

Sampling is Gumbel-max, as jax.random.categorical is, with the noise drawn
from the caller's torch.Generator outside the graphs, in chunks: the same
distribution as the JAX samplers, not the same draws. The eager loop and
the graphs draw the same noise, so on one card they give the same tokens.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import GPTConfig
from ..ops.int8 import int8_matmul
from ..ops.kernels import flash_attn
from ..parallel import mesh

NEG_INF = -1e9
NOISE_CHUNK = 64  # decode steps of Gumbel noise drawn at a time

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def _positions(start, T: int, device) -> torch.Tensor:
    """(T,) long positions start .. start + T - 1; `start` is an int or a
    one-element device tensor (a captured step's position)."""
    if isinstance(start, torch.Tensor):
        start = start.reshape(1)
        return start if T == 1 else start + torch.arange(T, device=device)
    return torch.arange(start, start + T, device=device)


def _flash_ok(cfg: GPTConfig, seq_len: int, t: torch.Tensor) -> bool:
    """The gate of the causal flash kernel in the full forward, the JAX
    package's (`models/gpt.py:_flash_ok`) with the card in place of the TPU:
    cfg.flash_attention, bf16 compute, a sequence long enough to tile, a
    CUDA tensor, and a head width the kernel takes (`flash_attn.narrowed`)."""
    return (cfg.flash_attention and t.dtype == torch.bfloat16 and seq_len >= flash_attn.MIN_T
            and t.is_cuda and not flash_attn.narrowed(seq_len, t.shape[-1]))


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        C = cfg.n_embd
        self.key = nn.Linear(C, C)
        self.query = nn.Linear(C, C)
        self.value = nn.Linear(C, C)
        self.proj = nn.Linear(C, C)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then x + mlp(ln2(x)), exact GELU."""

    def __init__(self, cfg: GPTConfig, index: int):
        super().__init__()
        self.cfg = cfg
        self.prefix = f"blocks.{index}."
        self.tp = None  # the tensor-parallel group (parallel/tp.py)
        C = cfg.n_embd
        self.ln1 = nn.LayerNorm(C, eps=1e-5)
        self.ln2 = nn.LayerNorm(C, eps=1e-5)
        self.attn = CausalSelfAttention(cfg)
        self.mlp = nn.Sequential(nn.Linear(C, 4 * C), nn.GELU(), nn.Linear(4 * C, C))

    def _dense(self, name: str, lin: nn.Linear, x: torch.Tensor, quant) -> torch.Tensor:
        """A Linear in cfg.dtype or, in int8 serving, a W8A8 product reading
        the quantized cache (ops/int8.py)."""
        dt = self.cfg.dtype
        qw = quant.get(self.prefix + name) if (self.cfg.int8_decode and quant) else None
        if qw is not None:
            return (int8_matmul(x, qw.q, qw.s) + qw.b).to(dt)
        return F.linear(x, lin.weight.to(dt), lin.bias.to(dt))

    def _row_dense(self, name: str, lin: nn.Linear, x: torch.Tensor, quant) -> torch.Tensor:
        """A row-parallel Linear under tensor parallelism: the partial
        products summed over the group, then the (replicated) bias once."""
        if self.tp is None:
            return self._dense(name, lin, x, quant)
        dt = self.cfg.dtype
        return mesh.reduce_from(F.linear(x, lin.weight.to(dt)), self.tp) + lin.bias.to(dt)

    def _norm(self, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        return F.layer_norm(x, ln.normalized_shape, ln.weight.to(dt), ln.bias.to(dt), ln.eps)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                slots: Optional[torch.Tensor] = None, kv_window: Optional[int] = None,
                quant=None) -> torch.Tensor:
        """x (B, T, C). `hidden` (bool, True = masked to NEG_INF) broadcasts
        over the (B, H, T, keys) scores: the causal mask, and in a cached
        call the key mask too (GPT.forward builds it once for every layer).
        With cache = (k, v) of (B, H, block, hd) the call writes its keys and
        values in place at `slots` (T,) and attends cache[:, :, :kv_window]."""
        cfg = self.cfg
        B, T, C = x.shape
        hd = C // cfg.n_head
        a = self.attn
        H = a.query.weight.shape[0] // hd  # this rank's heads
        h = mesh.copy_to(self._norm(self.ln1, x), self.tp)
        q, k, v = (self._dense("attn." + n, getattr(a, n), h, quant).view(B, T, H, hd)
                   .transpose(1, 2) for n in ("query", "key", "value"))
        if cache is not None:
            k_cache, v_cache = cache
            k_cache.index_copy_(2, slots, k)
            v_cache.index_copy_(2, slots, v)
            k = k_cache if kv_window is None else k_cache[:, :, :kv_window]
            v = v_cache if kv_window is None else v_cache[:, :, :kv_window]
        scale = 1.0 / math.sqrt(hd)
        if cache is None and _flash_ok(cfg, T, q):
            # the (B, T, H, D) projections as they are; the output in that layout too
            y = flash_attn.flash_attention(q, k, v, scale)
        else:
            # scores in f32 (a bf16 product rounds them once, as it leaves cuBLAS)
            sim = torch.matmul(q, k.transpose(-1, -2)).float() * scale
            attn = torch.softmax(sim.masked_fill(hidden, NEG_INF), dim=-1).to(cfg.dtype)
            y = torch.matmul(attn, v)
        y = y.transpose(1, 2).reshape(B, T, H * hd)
        x = x + self._row_dense("attn.proj", a.proj, y, quant)
        h = self._dense("mlp.0", self.mlp[0], mesh.copy_to(self._norm(self.ln2, x), self.tp),
                        quant)
        return x + self._row_dense("mlp.2", self.mlp[2], F.gelu(h), quant)


class GPT(nn.Module):
    """The LM. `vtokens_seq_len`, `vtokens_res` and `vtokens_crop` size the
    learned (seq, res, res, n_embd) table that cfg.vtokens_pos adds through
    per-sample crop boxes."""

    def __init__(self, cfg: GPTConfig, vtokens_seq_len: int = 0, vtokens_res: int = 0,
                 vtokens_crop: int = 0):
        super().__init__()
        self.cfg = cfg
        self.vtokens = (vtokens_seq_len, vtokens_res, vtokens_crop)
        C = cfg.n_embd
        self.tok_emb = nn.Embedding(cfg.vocab_size, C)
        self.pos_emb = nn.Parameter(torch.zeros(1, cfg.block_size, C))
        if cfg.vtokens_pos and vtokens_seq_len:
            self.vtokens_pos_emb = nn.Parameter(
                torch.zeros(vtokens_seq_len, vtokens_res, vtokens_res, C))
        self.blocks = nn.ModuleList(TransformerBlock(cfg, i) for i in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(C, eps=1e-5)
        self.head = nn.Linear(C, cfg.vocab_size, bias=False)
        self.tp, self.tp_dims = None, None  # set by parallel.tp.shard_gpt

    def set_tensor_parallel(self, group, dims) -> None:
        """The tensor-parallel group and each parameter's split dimension
        (parallel.tp.shard_gpt, which cut the parameters)."""
        self.tp, self.tp_dims = group, dims
        for block in self.blocks:
            block.tp = group

    @property
    def n_local_heads(self) -> int:
        """The attention heads this rank computes (and caches)."""
        if not len(self.blocks):
            return self.cfg.n_head
        return self.blocks[0].attn.query.weight.shape[0] // (self.cfg.n_embd // self.cfg.n_head)

    def _split(self, name: str) -> bool:
        return self.tp is not None and self.tp_dims.get(name) is not None

    def _vtokens(self, cbox: torch.Tensor) -> torch.Tensor:
        """(B, 4) [y0, y1, x0, x1] boxes -> (B, seq * crop * crop, C) crops of
        the vtokens table, the start clamped as jax.lax.dynamic_slice does."""
        seq, res, crop = self.vtokens
        crop = crop or res
        start = cbox.long().clamp(0, res - crop)
        ar = torch.arange(crop, device=cbox.device)
        ys, xs = start[:, 0, None] + ar, start[:, 2, None] + ar  # (B, crop)
        crops = self.vtokens_pos_emb[:, ys[:, :, None], xs[:, None, :]]  # (seq, B, crop, crop, C)
        return crops.transpose(0, 1).reshape(cbox.shape[0], -1, self.cfg.n_embd)

    def forward(self, idx: torch.Tensor, cache: Optional[Cache] = None, pos=None,
                cbox: Optional[torch.Tensor] = None, slot=None,
                key_mask: Optional[torch.Tensor] = None, kv_window: Optional[int] = None,
                quant=None) -> Tuple[torch.Tensor, Optional[Cache]]:
        """idx (B, T) tokens -> (f32 logits (B, T, vocab), cache).

        Without a cache: the full causal forward. With one (init_cache): the
        tokens sit at positions pos .. pos + T - 1 (an int, or a one-element
        long tensor on the device) and write the cache in place at slot ..
        slot + T - 1 (slot defaults to pos); `key_mask` (B, block) bool marks
        the cache slots each row may attend (True = visible), ANDed with the
        causal mask; `kv_window` (static int) restricts attention to slots
        [0, kv_window), the caller guaranteeing slot + T <= kv_window.
        `quant` is the W8A8 cache of ops/int8.quantize_gpt_decode_params,
        read when cfg.int8_decode is set."""
        cfg = self.cfg
        dt = cfg.dtype
        B, T = idx.shape
        dev = idx.device
        x = F.embedding(idx, self.tok_emb.weight.to(dt))
        if self._split("tok_emb.weight"):  # this rank's slice of C: gather the rest
            x = mesh.gather_from(x, -1, self.tp)
        if cache is None:
            positions = None
            x = x + self.pos_emb[:, :T].to(dt)
            hidden = torch.ones(T, T, dtype=torch.bool, device=dev).triu_(1)
        else:
            positions = _positions(pos, T, dev)
            slots = positions if slot is None else _positions(slot, T, dev)
            x = x + self.pos_emb[0].index_select(0, positions).to(dt)
            W = cfg.block_size if kv_window is None else kv_window
            # query i (at cache depth slot + i) attends keys j <= slot + i
            hidden = torch.arange(W, device=dev) > slots[:, None]  # (T, W)
            if key_mask is not None:
                hidden = hidden | ~key_mask[:, None, None, :W]
        if cfg.vtokens_pos and cbox is not None:
            flat = self._vtokens(cbox)
            pe = flat[:, :T] if positions is None else flat.index_select(1, positions)
            x = x + pe.to(dt)
        for i, block in enumerate(self.blocks):
            layer = None if cache is None else cache[i]
            x = block(x, hidden, layer, None if cache is None else slots, kv_window, quant)
        x = F.layer_norm(x, self.ln_f.normalized_shape, self.ln_f.weight.to(dt),
                         self.ln_f.bias.to(dt), self.ln_f.eps)
        qw = quant.get("head") if (cfg.int8_decode and quant) else None
        if qw is not None:
            logits = int8_matmul(x, qw.q, qw.s)
        elif self._split("head.weight"):  # this rank's slice of the vocabulary
            logits = mesh.gather_from(F.linear(mesh.copy_to(x, self.tp), self.head.weight.to(dt)),
                                      -1, self.tp)
        else:
            logits = F.linear(x, self.head.weight.to(dt))
        return logits.float(), cache


def init_cache(cfg: GPTConfig, batch: int, device="cuda", heads: Optional[int] = None) -> Cache:
    """Per-layer (k, v), each (B, H, block, hd) in cfg.dtype, written in
    place by the cached forward; `heads` a tensor-parallel rank's H."""
    hd = cfg.n_embd // cfg.n_head
    shape = (batch, heads or cfg.n_head, cfg.block_size, hd)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device)) for _ in range(cfg.n_layer)]


@torch.no_grad()
def init_weights(gpt: GPT, generator: torch.Generator) -> GPT:
    """minGPT's init: Linear and Embedding weights N(0, 0.02), Linear biases
    0, LayerNorm (1, 0); the position tables stay 0. Drawn in module order
    from `generator`, on its device, then copied to the module's."""
    for mod in gpt.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            w = torch.randn(mod.weight.shape, generator=generator, device=generator.device)
            mod.weight.copy_(w * 0.02)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return gpt


# -- logit filtering and sampling ---------------------------------------------
def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0
                          ) -> torch.Tensor:
    """(B, V) logits -> the same with NEG_INF outside the top k (ties with the
    k-th logit kept) and outside the nucleus of mass top_p (the first token
    past the threshold kept); the sort is stable, as jnp.argsort's is."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p < 1.0:
        sort_idx = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = torch.gather(logits, -1, sort_idx)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove = F.pad((cum > top_p)[..., :-1], (1, 0), value=False)
        sorted_logits = sorted_logits.masked_fill(remove, NEG_INF)
        logits = torch.empty_like(logits).scatter_(-1, sort_idx, sorted_logits)
    return logits


def gumbel_(buf: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Fill `buf` with Gumbel(0, 1) noise, -log(-log(u)), u uniform in
    [0, 1) from `generator` (u = 0 gives -inf: never drawn)."""
    return buf.uniform_(generator=generator).log_().neg_().log_().neg_()


def _sample_token(logits: torch.Tensor, temperature: float, top_k: Optional[int],
                  top_p: float, greedy: bool, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, V) logits -> (B,) tokens: argmax of the filtered logits, plus
    Gumbel noise unless greedy."""
    logits = logits / temperature
    if top_k or top_p < 1.0:
        logits = top_k_top_p_filtering(logits, top_k=top_k or 0, top_p=top_p)
    if greedy:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(logits + noise, dim=-1)


# -- samplers -----------------------------------------------------------------
def _cast_params_once(gpt: GPT, cfg: GPTConfig) -> GPT:
    """The GPT as the sampler runs it: `cfg` (its dtype and int8_decode) over
    gpt's parameters cast to cfg.dtype once, before the loop, so no step
    casts a weight. The master parameters are untouched; those already in
    the dtype are shared, not copied."""
    if gpt.cfg == cfg and all(p.dtype == cfg.dtype for p in gpt.parameters()):
        return gpt
    with torch.device("meta"):
        served = GPT(cfg, *gpt.vtokens)
    if gpt.tp is not None:
        from ..parallel.tp import shard_gpt

        shard_gpt(served, gpt.tp)
    served.load_state_dict({k: v.to(cfg.dtype) if v.is_floating_point() else v
                            for k, v in gpt.state_dict().items()}, assign=True)
    return served.eval()


def _decode_segments(first_pos: int, n_iters: int, block_size: int,
                     bucket: Optional[int]) -> List[Tuple[int, int, Optional[int]]]:
    """Split `n_iters` decode iterations (cache writes at first_pos + i) into
    (offset, count, window) segments: a segment's iterations attend only
    cache slots [0, window), the written prefix rounded up to a multiple of
    256 (None: the whole block). One captured step per distinct window."""
    if not bucket or n_iters <= 0:
        return [(0, n_iters, None)]
    segs = []
    off = 0
    while off < n_iters:
        n = min(bucket, n_iters - off)
        win = min(block_size, -(-(first_pos + off + n) // 256) * 256)
        segs.append((off, n, win))
        off += n
    return segs


class _Noise:
    """Gumbel noise for the decode steps, NOISE_CHUNK steps at a time, in a
    static buffer that a captured step reads at its step index; refilled
    from the generator outside the graphs."""

    def __init__(self, shape: Sequence[int], generator, device, greedy: bool):
        if generator is None and not greedy:
            raise ValueError("sampling draws from the caller's torch.Generator: pass one")
        self.generator = generator
        self.buf = None if greedy else torch.empty(NOISE_CHUNK, *shape, device=device)

    def first(self) -> Optional[torch.Tensor]:
        """The noise of the token sampled from the prefill's logits."""
        if self.buf is None:
            return None
        return gumbel_(torch.empty_like(self.buf[0]), self.generator)

    def refill(self, step: int) -> None:
        if self.buf is not None and step % NOISE_CHUNK == 0:
            gumbel_(self.buf, self.generator)

    def at(self, i: torch.Tensor) -> Optional[torch.Tensor]:
        if self.buf is None:
            return None
        return self.buf.index_select(0, torch.remainder(i, NOISE_CHUNK))[0]


class SampleFn:
    """A sampler: `sample(gpt, cond, generator=None, quant=None)`. After a
    call on the card, `timing` holds (window, timed steps, start event, end
    event) for each segment; the timed steps are the graph replays (with
    graphs) or every step (eager)."""

    def __init__(self, run: Callable, cuda_graphs: bool):
        self.run = run
        self.cuda_graphs = cuda_graphs
        self.timing: list = []

    def __call__(self, gpt: GPT, cond: torch.Tensor, generator=None, quant=None) -> torch.Tensor:
        with torch.no_grad():
            return self.run(self, gpt, cond, generator, quant)

    def segment_ms(self) -> List[Tuple[Optional[int], int, float]]:
        """(window, timed steps, ms a step) of the last call's segments."""
        torch.cuda.synchronize()
        return [(win, n, start.elapsed_time(end) / n) for win, n, start, end in self.timing if n]


def _run_segments(fn: SampleFn, segs, step_for_win: Callable[[Optional[int]], Callable],
                  noise: _Noise, device: torch.device) -> None:
    """Run every decode step of `segs`. On the card with graphs, each
    segment's first step runs eagerly on a side stream (the warm-up), then
    the step is captured once and replayed for the rest of the segment; a
    failed capture raises. Otherwise every step runs eagerly."""
    graphs = fn.cuda_graphs and device.type == "cuda"
    fn.timing = []
    if graphs:
        pool, side = torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)
    for off, n, win in segs:
        step = step_for_win(win)
        graph = None
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for s in range(off, off + n):
            noise.refill(s)
            if graph is not None:
                graph.replay()
            elif graphs:
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    step()
                torch.cuda.current_stream(device).wait_stream(side)
                if s + 1 < off + n:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool, stream=side):
                        step()
                    start.record()
            else:
                if s == off and device.type == "cuda":
                    start.record()
                step()
        if device.type == "cuda":
            end.record()
            timed = n - 1 if graphs else n
            fn.timing.append((win, timed, start, end))


def _check_length(L: int, steps: int, block_size: int) -> None:
    if L + steps - 1 > block_size:
        raise ValueError(f"prefix {L} + steps {steps} exceeds block_size {block_size}")


def _decode(fn: SampleFn, cfg: GPTConfig, steps: int, L: int, bucket: Optional[int],
            first: torch.Tensor, step_logits: Callable, pick: Callable, generator,
            greedy: bool) -> torch.Tensor:
    """The decode loop the samplers share: the token drawn from `first`
    (B, V) logits, then steps - 1 steps that feed the token back through
    step_logits(tok, i, window) -> (B, V) logits, i the step index on the
    device, and draw the next with pick(logits, noise). Returns (B, steps)."""
    B, dev = first.shape[0], first.device
    noise = _Noise((B, cfg.vocab_size), generator, dev, greedy)
    i = torch.zeros(1, dtype=torch.long, device=dev)
    tok = pick(first, noise.first())
    out = torch.empty(B, steps, dtype=torch.long, device=dev)

    def step_for_win(win):
        def step():
            nxt = pick(step_logits(tok, i, win), noise.at(i))
            out.index_copy_(1, i, tok[:, None])
            tok.copy_(nxt)
            i.add_(1)
        return step

    _run_segments(fn, _decode_segments(L, steps - 1, cfg.block_size, bucket), step_for_win,
                  noise, dev)
    out[:, steps - 1] = tok
    return out


def make_sampler(cfg: GPTConfig, steps: int, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: float = 1.0, greedy: bool = False,
                 bucket: Optional[int] = None, cuda_graphs: bool = True) -> SampleFn:
    """The analogue of the reference's sample_with_past:
    sample(gpt, cond, generator, quant=None) -> (B, steps) tokens after the
    (B, L) prefix `cond`. `bucket` segments the attention window
    (_decode_segments)."""

    def run(fn, gpt, cond, generator, quant):
        gpt = _cast_params_once(gpt, cfg)
        B, L = cond.shape
        _check_length(L, steps, cfg.block_size)
        caches = init_cache(cfg, B, cond.device, gpt.n_local_heads)
        logits, _ = gpt(cond, caches, 0, quant=quant)

        def step_logits(tok, i, win):
            return gpt(tok[:, None], caches, L + i, kv_window=win, quant=quant)[0][:, -1]

        def pick(logits, noise):
            return _sample_token(logits, temperature, top_k, top_p, greedy, noise)

        return _decode(fn, cfg, steps, L, bucket, logits[:, -1], step_logits, pick, generator,
                       greedy)

    return SampleFn(run, cuda_graphs)


def _cfg_blend(cfg_ratio: float, temperature: float, scale_cfg: bool, device):
    """blend(lc, lu, n) = (1 + t) lc / temperature - t lu / temperature,
    t = cfg_ratio (times the step n with scale_cfg), in f32 on the device."""
    ratio_t = torch.full((), cfg_ratio, dtype=torch.float32, device=device)

    def blend(lc, lu, n: torch.Tensor):
        t = ratio_t * n.float() if scale_cfg else ratio_t
        return (1.0 + t) * (lc / temperature) - t * (lu / temperature)
    return blend


def _class_prefix(cls: torch.Tensor, class_first: bool):
    """(B, 1) raw class ids -> (the (B, 2) prefix of class + 1 and sos, sos)."""
    c = cls.long() + 1
    sos = torch.zeros_like(c)
    return torch.cat([c, sos] if class_first else [sos, c], dim=1), sos


def make_cfg_sampler(cfg: GPTConfig, steps: int, temperature: float = 1.0,
                     top_k: Optional[int] = None, top_p: float = 1.0,
                     cfg_ratio: float = 1.5, class_first: bool = False,
                     scale_cfg: bool = False, greedy: bool = False,
                     bucket: Optional[int] = None, cuda_graphs: bool = True) -> SampleFn:
    """The analogue of sample_with_past_cfg: sample(gpt, cls, generator,
    quant=None) -> (B, steps), `cls` (B, 1) raw class ids (shifted by one
    and joined to sos inside). The cond and uncond streams share one cache
    of 2B rows [cond | uncond] and one write depth: the uncond rows' past is
    sos at slot 0 and their tokens from slot 2 on, with positions 2 + i as
    the cond rows', so their key mask hides the never-written slot 1 (the
    reference's dense uncond past, the same key set under softmax). The
    logits blend as (1 + t) cond - t uncond."""

    def run(fn, gpt, cls, generator, quant):
        gpt = _cast_params_once(gpt, cfg)
        B, dev = cls.shape[0], cls.device
        prefix, sos = _class_prefix(cls, class_first)
        L = prefix.shape[1]
        _check_length(L, steps, cfg.block_size)
        caches = init_cache(cfg, 2 * B, dev, gpt.n_local_heads)
        lc, _ = gpt(prefix, [(k[:B], v[:B]) for k, v in caches], 0, quant=quant)
        lu, _ = gpt(sos, [(k[B:], v[B:]) for k, v in caches], 0, quant=quant)
        blend = _cfg_blend(cfg_ratio, temperature, scale_cfg, dev)
        visible = torch.arange(cfg.block_size, device=dev) != 1
        row_mask = torch.cat([torch.ones(B, cfg.block_size, dtype=torch.bool, device=dev),
                              visible.expand(B, -1)])

        def step_logits(tok, i, win):
            logits, _ = gpt(torch.cat([tok, tok])[:, None], caches, L + i, key_mask=row_mask,
                            kv_window=win, quant=quant)
            return blend(logits[:B, -1], logits[B:, -1], i + 1)

        def pick(logits, noise):
            return _sample_token(logits, 1.0, top_k, top_p, greedy, noise)

        first = blend(lc[:, -1], lu[:, -1], torch.zeros(1, device=dev))
        return _decode(fn, cfg, steps, L, bucket, first, step_logits, pick, generator, greedy)

    return SampleFn(run, cuda_graphs)


def make_hardcfg_sampler(cfg: GPTConfig, steps: int, temperature: float = 1.0,
                         top_k: Optional[int] = None, top_p: float = 1.0,
                         cfg_ratio: float = 1.5, class_first: bool = False,
                         greedy: bool = False, bucket: Optional[int] = None,
                         cuda_graphs: bool = True) -> SampleFn:
    """The analogue of sample_with_past_hardcfg: the uncond stream reads
    [sos, x_0 .. x_{n-1}] at its own dense positions 0 .. n from a cache of
    its own, and the guidance grows with the step, t = cfg_ratio * n."""

    def run(fn, gpt, cls, generator, quant):
        gpt = _cast_params_once(gpt, cfg)
        B, dev = cls.shape[0], cls.device
        prefix, sos = _class_prefix(cls, class_first)
        L = prefix.shape[1]
        _check_length(L, steps, cfg.block_size)
        cc, cu = (init_cache(cfg, B, dev, gpt.n_local_heads),
                  init_cache(cfg, B, dev, gpt.n_local_heads))
        lc, _ = gpt(prefix, cc, 0, quant=quant)
        lu, _ = gpt(sos, cu, 0, quant=quant)
        blend = _cfg_blend(cfg_ratio, temperature, True, dev)

        def step_logits(tok, i, win):
            lc, _ = gpt(tok[:, None], cc, L + i, kv_window=win, quant=quant)
            lu, _ = gpt(tok[:, None], cu, 1 + i, kv_window=win, quant=quant)
            return blend(lc[:, -1], lu[:, -1], i + 1)

        def pick(logits, noise):
            return _sample_token(logits, 1.0, top_k, top_p, greedy, noise)

        first = blend(lc[:, -1], lu[:, -1], torch.zeros(1, device=dev))
        return _decode(fn, cfg, steps, L, bucket, first, step_logits, pick, generator, greedy)

    return SampleFn(run, cuda_graphs)
