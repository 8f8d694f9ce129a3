"""GPipe pipeline parallelism of the GPT (mirror of
`omnitokenizer_tpu.parallel.pp`, its :34-170).

The JAX package shards the blocks' stacked parameters over a ('stage',)
mesh and lets `jax.grad` of a shard_map'ed schedule run the backward; the
port runs one process a stage and says the hops, point to point:

  * stage s of S holds blocks s * n_layer / S .. (s + 1) * n_layer / S - 1
    (its slab); the embeddings, ln_f and the head are replicated on every
    stage, applied outside the pipe (stage 0 embeds, the last stage runs
    ln_f and the head);
  * the forward is the M + S - 1 step schedule: at step t stage s runs
    microbatch t - s, stage 0 injecting microbatch t at step t, each stage
    handing its output to the next (send / recv);
  * the last stage computes the loss over the whole batch from its outputs
    (the JAX pipe replicates them and every stage computes it; here the
    last stage broadcasts the loss and metrics);
  * the backward is GPipe's: the last stage backpropagates the loss, each
    stage hands each microbatch's input gradient back to the one before
    it, microbatches in reverse; the replicated parameters' gradients are
    then summed over the stages (each has its part: the embeddings on
    stage 0, ln_f and the head on the last), so they are equal everywhere.

`stack_block_params` / `unstack_block_params` convert between a GPT
state_dict and the JAX layout {"stacked": per-block tensors stacked on a
leading (n_layer,) axis, "rest": the others}.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import mesh

_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)$")


def stack_block_params(sd: Dict[str, torch.Tensor], n_layer: int
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """{'blocks.{i}.X': ...} -> ({'X': (n_layer, ...)}, the non-block rest)."""
    suffixes = sorted({m.group(2) for k in sd for m in [_BLOCK.match(k)] if m})
    stacked = {x: torch.stack([sd[f"blocks.{i}.{x}"] for i in range(n_layer)])
               for x in suffixes}
    rest = {k: v for k, v in sd.items() if not _BLOCK.match(k)}
    return stacked, rest


def unstack_block_params(stacked: Dict[str, torch.Tensor], rest: Dict[str, torch.Tensor],
                         n_layer: int) -> Dict[str, torch.Tensor]:
    """The inverse of stack_block_params: a plain GPT state_dict."""
    out = dict(rest)
    for x, v in stacked.items():
        for i in range(n_layer):
            out[f"blocks.{i}.{x}"] = v[i]
    return out


class PipelineGPT:
    """This rank's stage of a GPT pipelined over `group` (its ranks are the
    stages, in order) with `n_micro` microbatches a batch. The GPT given
    is cut to this stage's blocks in place; `gpt` keeps the replicated
    embeddings, ln_f and head."""

    def __init__(self, gpt: nn.Module, group: Any, n_micro: int):
        cfg = gpt.cfg
        self.S, self.s = mesh.size_of(group), mesh.rank_in(group)
        if cfg.n_layer % self.S:
            raise ValueError(f"n_layer {cfg.n_layer} must divide by --pipeline_stages {self.S}")
        if getattr(gpt, "vtokens_pos_emb", None) is not None or gpt.tp is not None:
            raise ValueError("the pipeline runs the plain GPT (no vtokens table, no tensor "
                             "parallelism)")
        self.per = cfg.n_layer // self.S
        self.first = self.s * self.per
        gpt.blocks = nn.ModuleList(list(gpt.blocks)[self.first:self.first + self.per])
        self.gpt, self.cfg, self.group, self.M = gpt, cfg, group, n_micro

    # -- names ----------------------------------------------------------------------------
    def global_name(self, name: str) -> str:
        m = _BLOCK.match(name)
        return f"blocks.{int(m.group(1)) + self.first}.{m.group(2)}" if m else name

    def named_parameters(self) -> List[Tuple[str, nn.Parameter]]:
        """(the full GPT's name, parameter) of this stage's parameters."""
        return [(self.global_name(n), p) for n, p in self.gpt.named_parameters()]

    def block_mask(self) -> List[bool]:
        """Whether each parameter (gpt.parameters() order) is in this stage's slab."""
        return [bool(_BLOCK.match(n)) for n, _ in self.gpt.named_parameters()]

    def load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load this stage's tensors from a full GPT state_dict."""
        local = {n: sd[self.global_name(n)] for n in self.gpt.state_dict()}
        self.gpt.load_state_dict(local)

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """Every stage's blocks and the replicated rest, on every rank."""
        mine = {self.global_name(n): v.detach().cpu()
                for n, v in self.gpt.state_dict().items() if _BLOCK.match(n)}
        out = {n: v.detach().cpu() for n, v in self.gpt.state_dict().items()
               if not _BLOCK.match(n)}
        for part in _gather_objects(mine, self.group):
            out.update(part)
        return out

    # -- the pipe ---------------------------------------------------------------------------
    def _embed(self, idx: torch.Tensor) -> torch.Tensor:
        dt, g = self.cfg.dtype, self.gpt
        return F.embedding(idx, g.tok_emb.weight.to(dt)) + g.pos_emb[:, :idx.shape[1]].to(dt)

    def _slab(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        hidden = torch.ones(T, T, dtype=torch.bool, device=x.device).triu_(1)
        for block in self.gpt.blocks:
            x = block(x, hidden)
        return x

    def _head(self, y: torch.Tensor) -> torch.Tensor:
        dt, g = self.cfg.dtype, self.gpt
        h = F.layer_norm(y, g.ln_f.normalized_shape, g.ln_f.weight.to(dt), g.ln_f.bias.to(dt),
                         g.ln_f.eps)
        return F.linear(h, g.head.weight.to(dt)).float()

    def _forward(self, idx: torch.Tensor, grad: bool):
        """The M + S - 1 steps: -> (this stage's per-microbatch inputs (its
        received activations) and outputs)."""
        B, T = idx.shape
        if B % self.M:
            raise ValueError(f"batch {B} must divide by --microbatches {self.M}")
        mb, S, s = B // self.M, self.S, self.s
        shape = (mb, T, self.cfg.n_embd)
        dev = idx.device
        ins: List[Optional[torch.Tensor]] = [None] * self.M
        outs: List[Optional[torch.Tensor]] = [None] * self.M
        with torch.set_grad_enabled(grad):
            for t in range(self.M + S - 1):
                m = t - s
                if not 0 <= m < self.M:
                    continue
                if s == 0:
                    x = self._embed(idx[m * mb:(m + 1) * mb])
                else:
                    x = mesh.recv(shape, self.cfg.dtype, dev, s - 1, self.group)
                    x.requires_grad_(grad)
                    ins[m] = x
                y = self._slab(x)
                if s < S - 1:
                    mesh.send(y, s + 1, self.group)
                outs[m] = y
        return ins, outs

    def logits(self, idx: torch.Tensor) -> torch.Tensor:
        """The full GPT forward (B, T) -> f32 logits (B, T, V) through the
        pipe, on every stage (the last stage's, broadcast)."""
        with torch.no_grad():
            _, outs = self._forward(idx, grad=False)
            B, T = idx.shape
            out = torch.empty(B, T, self.cfg.vocab_size, device=idx.device)
            if self.s == self.S - 1:
                out = self._head(torch.cat(outs))
            return mesh.broadcast_(out, self.S - 1, self.group)

    def forward_backward(self, idx: torch.Tensor,
                         loss_tail: Callable[[torch.Tensor], Tuple[torch.Tensor, Dict]]
                         ) -> Dict[str, torch.Tensor]:
        """One forward and GPipe backward of `loss_tail(logits)` over the
        batch `idx` (B, T): the gradients land in the parameters' .grad
        (accumulated), the replicated ones summed over the stages. Returns
        the loss's metrics (0-d f32), the same on every stage."""
        S, s = self.S, self.s
        ins, outs = self._forward(idx, grad=True)
        names: List[str] = []
        if s == S - 1:
            loss, metrics = loss_tail(self._head(torch.cat(outs)))
            names = sorted(metrics)
            loss.backward()
            vec = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
        for m in reversed(range(self.M)):
            if s < S - 1:
                g = mesh.recv(outs[m].shape, outs[m].dtype, idx.device, s + 1, self.group)
                torch.autograd.backward(outs[m], g)
            if s > 0:
                mesh.send(ins[m].grad, s - 1, self.group)
        rest = [p for n, p in self.gpt.named_parameters() if not _BLOCK.match(n)]
        for p in rest:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mesh.average_grads_([p.grad for p in rest], self.group, mean=False)
        names = mesh.broadcast_object(names, self.group, S - 1)
        if s != S - 1:
            vec = torch.empty(len(names), device=idx.device)
        mesh.broadcast_(vec, S - 1, self.group)
        return {k: vec[i] for i, k in enumerate(names)}


def _gather_objects(obj: Any, group: Any) -> List[Any]:
    import torch.distributed as dist

    if group is None:
        return [obj]
    out = [None] * mesh.size_of(group)
    dist.all_gather_object(out, obj, group=group)
    return out
