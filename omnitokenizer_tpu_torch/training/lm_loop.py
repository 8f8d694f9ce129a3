"""LM training over a frozen tokenizer's codes (mirror of the JAX package's
`cli/transformer_train.py` step and loop).

    opt = make_lm_optimizer(n2n.gpt, lr=1e-3, max_steps=100_000, lr_min=1e-3)
    state = train_lm(n2n, opt, batches, root_dir, max_steps=100_000)

A step encodes the batch's pixels with the frozen tokenizer under no_grad
(on the card, through its kernels), takes `Net2NetTransformer.loss_fn`'s
gradients of the f32 master weights (the GPT computes in cfg.dtype: in
bf16 on the card its attention is the causal flash kernel, forward and
backward) and applies the optimizer: clip_by_global_norm -> adamw(b1 0.9,
b2 0.95, weight decay masked by `decays`) -> warmup-cosine, in MultiSteps
when gradients accumulate. The pkeep draws of a step come from a generator
seeded from (seed, step), so a resumed run draws what an unbroken one would.

Under `root_dir` the loop writes metrics.jsonl (one record a step) and
checkpoints/step_XXXXXXXX.pt (torch.save of the GPT's state_dict, the
optimizer state and the step; step_N resumes at step N) every `ckpt_every`
steps and at the end, and resumes from the newest. A resumed run skips the
batches the steps before it consumed, so a deterministic batch stream gives
what an unbroken run would.

Parallelism (`LMParallel`, the JAX CLI's --model_parallel and
--pipeline_stages): the ranks form a (data, model) grid, the model axis a
tensor-parallel group (parallel/tp.py) or a pipeline's stages
(parallel/pp.py). A data row's ranks take the same rows; the data rows
split the global batch, their losses are the global mean and their
gradients are averaged, and the pkeep draws are a row's rows of the one
draw for the global batch. The clip's global norm is the whole model's.
Checkpoints hold the full GPT and the full optimizer state (the shards
put back together), written by rank 0 alone; every rank reads them and
takes its shards, so a run resumes under any layout.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..models.gpt import GPT
from ..models.net2net import Net2NetTransformer
from ..parallel import mesh, tp
from ..parallel.pp import PipelineGPT
from .loop import MetricsLogger, find_latest_checkpoint
from .trainer import OptaxAdam, OptState, warmup_cosine_decay

STEP_SEED = 1_000_003  # (seed, step) -> the step's generator seed


def decays(name: str) -> bool:
    """Whether adamw's weight decay reaches the GPT parameter `name` (the JAX
    CLI's mask, lm_transformer.py's split): not a bias, a LayerNorm, the
    token or position embeddings, or anything named *_norm."""
    return not (name.endswith("bias") or "ln" in name or "tok_emb" in name
                or name.endswith("pos_emb") or "_norm" in name)


def make_lm_optimizer(gpt: GPT, lr: float, max_steps: int, warmup_steps: int = 0,
                      warmup_lr_init: float = 0.0, lr_min: float = 0.0,
                      grad_clip_val: Optional[float] = 1.0, weight_decay: float = 0.01,
                      accumulates: int = 1) -> OptaxAdam:
    """The JAX CLI's chain: clip_by_global_norm(grad_clip_val or 1) ->
    adamw(warmup-cosine, b1 0.9, b2 0.95, weight_decay, mask) in MultiSteps
    when accumulates > 1; the warmup clamped to [1, max_steps - 1]."""
    schedule = warmup_cosine_decay(warmup_lr_init, lr, max(min(warmup_steps, max_steps - 1), 1),
                                   max(max_steps, 2), lr_min)
    return OptaxAdam(schedule, grad_clip_val or 1.0, accumulates, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=weight_decay,
                     decay_mask=[decays(n) for n, _ in gpt.named_parameters()])


@dataclasses.dataclass
class LMTrainState:
    """The GPT (its f32 master weights), the optimizer's state, the step and
    the seed of the pkeep draws."""

    gpt: GPT
    opt: OptState
    step: int = 0
    seed: int = 0

    def params(self) -> List[torch.Tensor]:
        return list(self.gpt.parameters())

    def state_dict(self) -> Dict[str, Any]:
        return {"gpt": self.gpt.state_dict(), "opt": self.opt.state_dict(), "step": self.step,
                "seed": self.seed}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.gpt.load_state_dict(sd["gpt"])
        self.opt.load_state_dict(sd["opt"])
        self.step, self.seed = int(sd["step"]), int(sd["seed"])


@dataclasses.dataclass
class LMParallel:
    """Where this rank sits: its data row (`data` groups the ranks at its
    model position across rows) and its tensor-parallel group (`model`) or
    pipeline stage (`pipe`). The default is one process."""

    data: Any = None
    data_rank: int = 0
    data_size: int = 1
    model: Any = None
    pipe: Optional[PipelineGPT] = None

    def param_names(self, gpt: GPT) -> List[str]:
        """The full GPT's name of each of this rank's parameters."""
        if self.pipe is not None:
            return [n for n, _ in self.pipe.named_parameters()]
        return [n for n, _ in gpt.named_parameters()]


def setup_parallel(n2n: Net2NetTransformer, opt: OptaxAdam, model_parallel: int = 1,
                   pipeline_stages: int = 1, microbatches: int = 2) -> LMParallel:
    """Lay the world out as (data, model) with model_parallel or
    pipeline_stages ranks on the model axis, make every rank's GPT rank 0's,
    and cut it to this rank's shards or stage; the optimizer's norm becomes
    the whole model's. Without a process group: one process (both 1)."""
    if model_parallel > 1 and pipeline_stages > 1:
        raise ValueError("--pipeline_stages and --model_parallel are mutually exclusive")
    gpt = n2n.gpt
    if model_parallel > 1:
        tp.check_layout(gpt.cfg.n_head, gpt.cfg.n_embd, model_parallel)
    if mesh.world() == 1 and max(model_parallel, pipeline_stages) == 1:
        return LMParallel()
    inner = max(model_parallel, pipeline_stages)
    g = mesh.grid(inner)
    mesh.replicate(gpt, mesh.world_group())
    par = LMParallel(data=g.data if g.data_size > 1 else None, data_rank=g.data_rank,
                     data_size=g.data_size)
    if model_parallel > 1:
        tp.shard_gpt(gpt, g.inner)
        par.model = g.inner
        mask = tp.sharded_mask(gpt)
        opt.norm_fn = lambda grads: tp.global_norm(grads, mask, g.inner)
    elif pipeline_stages > 1:
        if gpt.cfg.n_layer % pipeline_stages:
            raise ValueError("n_layer must divide by --pipeline_stages")
        par.pipe = PipelineGPT(gpt, g.inner, microbatches)
        mask = par.pipe.block_mask()
        opt.norm_fn = lambda grads: tp.global_norm(grads, mask, g.inner)
    if opt.decay_mask is not None:  # the mask follows this rank's parameters
        names = par.param_names(gpt)
        opt.decay_mask = [decays(n) for n in names]
    return par


def init_lm_state(n2n: Net2NetTransformer, opt: OptaxAdam, seed: int = 0) -> LMTrainState:
    return LMTrainState(n2n.gpt, opt.init(list(n2n.gpt.parameters())), 0, seed)


def full_state_dict(state: LMTrainState, par: LMParallel) -> Dict[str, Any]:
    """The checkpoint of a one-process run: the full GPT's state_dict and
    the optimizer's moments in the full GPT's parameter order (shards put
    back together, stages gathered). Every rank of the layout calls it."""
    if par.model is None and par.pipe is None:
        return state.state_dict()
    gpt, names = state.gpt, par.param_names(state.gpt)
    opt = state.opt.state_dict()
    moments = {k: dict(zip(names, opt[k])) for k in ("mu", "nu", "acc") if opt[k] is not None}
    if par.model is not None:
        full = tp.gather_state_dict(gpt.state_dict(), gpt.tp_dims, par.model)
        moments = {k: tp.gather_state_dict(v, gpt.tp_dims, par.model) for k, v in moments.items()}
    else:
        full = par.pipe.full_state_dict()
        moments = {k: _merge(v, par.pipe.group) for k, v in moments.items()}
    with torch.device("meta"):
        order = list(GPT(gpt.cfg).state_dict())  # a one-process GPT's: parameters alone
    for k, v in moments.items():
        opt[k] = [v[n].cpu() for n in order]
    return {"gpt": {k: full[k].cpu() for k in order}, "opt": opt, "step": state.step,
            "seed": state.seed}


def _merge(named: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    import torch.distributed as dist

    parts = [None] * mesh.size_of(group)
    dist.all_gather_object(parts, {k: v.cpu() for k, v in named.items()}, group=group)
    out = {}
    for p in parts:
        out.update(p)
    return out


def load_full_state_dict(state: LMTrainState, sd: Dict[str, Any], par: LMParallel) -> None:
    """Load a full (one-process) checkpoint into this rank's shards or stage."""
    if par.model is None and par.pipe is None:
        state.load_state_dict(sd)
        return
    gpt = state.gpt
    with torch.device("meta"):
        order = [n for n, _ in GPT(gpt.cfg).named_parameters()]
    names = par.param_names(gpt)
    opt = dict(sd["opt"])
    for k in ("mu", "nu", "acc"):
        if opt.get(k) is not None:
            by_name = dict(zip(order, opt[k]))
            opt[k] = [by_name[n] for n in names]
    if par.model is not None:
        n, r = mesh.size_of(par.model), mesh.rank_in(par.model)
        gpt.load_state_dict(tp.shard_state_dict(sd["gpt"], r, n))
        for k in ("mu", "nu", "acc"):
            if opt.get(k) is not None:
                shards = tp.shard_state_dict(dict(zip(names, opt[k])), r, n)
                opt[k] = [shards[x] for x in names]
    else:
        par.pipe.load_full_state_dict(sd["gpt"])
    state.opt.load_state_dict(opt)
    state.step, state.seed = int(sd["step"]), int(sd["seed"])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed * STEP_SEED + step)


def lm_train_step(n2n: Net2NetTransformer, opt: OptaxAdam, state: LMTrainState,
                  z_ids: torch.Tensor, labels, keep: Optional[torch.Tensor] = None,
                  rand_ids: Optional[torch.Tensor] = None,
                  par: Optional[LMParallel] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step of the GPT on codebook ids z_ids (B, N) and their
    condition (under `par`, this data row's rows of the global batch); with
    cfg.pkeep < 1 and no draws given, the step draws them from its (seed,
    step) generator. Returns the loss's metrics and the gradients' global
    norm; `state` advances in place."""
    par = par or LMParallel()
    if keep is None and n2n.cfg.pkeep < 1.0:
        shape = (z_ids.shape[0] * par.data_size,) + tuple(z_ids.shape[1:])
        keep, rand_ids = n2n.draw_pkeep(shape, step_generator(state.seed, state.step,
                                                              z_ids.device), z_ids.device)
        keep, rand_ids = mesh.rank_rows(keep, par.data), mesh.rank_rows(rand_ids, par.data)
    params = state.params()
    if par.pipe is not None:
        inputs, target, prefix = n2n.loss_inputs(z_ids, labels, keep, rand_ids)
        metrics = par.pipe.forward_backward(
            inputs, lambda logits: n2n.loss_from_logits(logits, target, prefix))
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        for p in params:
            p.grad = None
    else:
        loss, metrics = n2n.loss_fn(z_ids, labels, keep, rand_ids)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    mesh.average_grads_(grads, par.data)
    metrics = {k: mesh.mean_over(v, par.data) for k, v in metrics.items()}
    updates = opt.update(grads, state.opt, params)
    if updates is not None:
        with torch.no_grad():
            torch._foreach_add_(params, updates)
    metrics["grad_norm"] = (opt.norm_fn or OptaxAdam.global_norm)(grads)
    state.step += 1
    return metrics


def encode_batch(n2n: Net2NetTransformer, batch: Dict[str, Any]):
    """(z_ids (B, N), condition) of a loader batch: its channels-last
    'video' (B, T, H, W, C) or images (B, H, W, C), arrays or tensors,
    encoded by the frozen tokenizer; the condition its 'text' ids (B, L)
    when cond_stage_key is 'text' (as the JAX CLI takes them), else its
    'label' class ids (B,) (zeros without one). A host-side condition is
    checked against the condition vocabulary: a family with no class gives
    label -1."""
    video = torch.as_tensor(batch["video"], dtype=torch.float32).to(n2n.device)
    x = torch.movedim(video, -1, 1)
    with torch.no_grad():
        z_ids = n2n.encode_to_z(x, x.ndim == 4)
    key = "text" if n2n.cfg.cond_stage_key == "text" else "label"
    if key == "text" and "text" not in batch:
        raise ValueError("--cond_stage_key text needs captions in the batch: a CoinRun directory "
                         "or a caption HDF5, with --text_cond")
    cond = batch.get(key)
    cond = torch.zeros(len(x), dtype=torch.long) if cond is None else cond
    if not isinstance(cond, torch.Tensor) and not n2n.cfg.unconditional:
        ids = np.asarray(cond)
        if ids.size and (ids.min() < 0 or ids.max() >= n2n.cond_vocab):
            raise ValueError(f"the batch's {key} ids span [{ids.min()}, {ids.max()}], outside the "
                             f"condition vocabulary [0, {n2n.cond_vocab}) (--class_cond_dim)"
                             + ("; label -1 is a dataset family with no class"
                                if key == "label" and ids.min() < 0 else ""))
    return z_ids, torch.as_tensor(cond).to(n2n.device).long()


def train_lm(n2n: Net2NetTransformer, opt: OptaxAdam, batches: Iterable[Dict[str, Any]],
             root_dir: str, max_steps: int, ckpt_every: int = 3000, log_every: int = 50,
             resume: bool = True, seed: int = 0, par: Optional[LMParallel] = None,
             wandb_project: Optional[str] = None,
             wandb_config: Optional[Dict[str, Any]] = None) -> LMTrainState:
    """Train the GPT over a batch stream (this data row's, under `par`) up
    to `max_steps` (or the stream's end); returns the final state. Rank 0
    alone logs (into a wandb run too, with wandb_project) and writes the
    checkpoints."""
    par = par or LMParallel()
    state = init_lm_state(n2n, opt, seed)
    ckpt = find_latest_checkpoint(root_dir) if resume else None
    it = iter(batches)
    if ckpt:
        load_full_state_dict(state, torch.load(ckpt, map_location=n2n.device), par)
        print(f"auto-resumed from {ckpt} at step {state.step}")
        for _ in range(state.step):  # the batches the steps before consumed
            next(it, None)
    lead = mesh.rank() == 0
    logger = MetricsLogger(root_dir, log_every, wandb_project, wandb_config) if lead else None

    def ckpt_path() -> str:
        return os.path.join(root_dir, "checkpoints", f"step_{state.step:08d}.pt")

    def write() -> None:
        sd = full_state_dict(state, par)  # a collective under a layout: every rank
        if lead:
            os.makedirs(os.path.dirname(ckpt_path()), exist_ok=True)
            tmp = ckpt_path() + ".tmp"
            torch.save(sd, tmp)
            os.replace(tmp, ckpt_path())
        mesh.barrier()

    while state.step < max_steps:
        batch = next(it, None)
        if batch is None:
            break
        z_ids, labels = encode_batch(n2n, batch)
        metrics = lm_train_step(n2n, opt, state, z_ids, labels, par=par)
        if lead:
            logger.log(state.step - 1, metrics)
        if state.step % ckpt_every == 0:
            write()
    # a final checkpoint, so a run whose max_steps is off the cadence resumes
    if state.step > 0 and not mesh.broadcast_object(os.path.exists(ckpt_path())):
        write()
    if lead:
        logger.close()
    return state
