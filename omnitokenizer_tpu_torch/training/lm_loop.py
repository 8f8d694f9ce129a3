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
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, List, Optional

import torch

from ..models.gpt import GPT
from ..models.net2net import Net2NetTransformer
from .loop import MetricsLogger, find_latest_checkpoint, save_state
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


def init_lm_state(n2n: Net2NetTransformer, opt: OptaxAdam, seed: int = 0) -> LMTrainState:
    return LMTrainState(n2n.gpt, opt.init(list(n2n.gpt.parameters())), 0, seed)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed * STEP_SEED + step)


def lm_train_step(n2n: Net2NetTransformer, opt: OptaxAdam, state: LMTrainState,
                  z_ids: torch.Tensor, labels, keep: Optional[torch.Tensor] = None,
                  rand_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step of the GPT on codebook ids z_ids (B, N) and their
    condition; with cfg.pkeep < 1 and no draws given, the step draws them
    from its (seed, step) generator. Returns the loss's metrics and the
    gradients' global norm; `state` advances in place."""
    if keep is None and n2n.cfg.pkeep < 1.0:
        keep, rand_ids = n2n.draw_pkeep(tuple(z_ids.shape),
                                        step_generator(state.seed, state.step, z_ids.device),
                                        z_ids.device)
    params = state.params()
    loss, metrics = n2n.loss_fn(z_ids, labels, keep, rand_ids)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    updates = opt.update(grads, state.opt, params)
    if updates is not None:
        with torch.no_grad():
            torch._foreach_add_(params, updates)
    metrics["grad_norm"] = OptaxAdam.global_norm(grads)
    state.step += 1
    return metrics


def encode_batch(n2n: Net2NetTransformer, batch: Dict[str, Any]):
    """(z_ids (B, N), class ids (B,)) of a loader batch: its channels-last
    'video' (B, T, H, W, C) or images (B, H, W, C), arrays or tensors,
    encoded by the frozen tokenizer, and its 'label' (zeros without one)."""
    video = torch.as_tensor(batch["video"], dtype=torch.float32).to(n2n.device)
    x = torch.movedim(video, -1, 1)
    with torch.no_grad():
        z_ids = n2n.encode_to_z(x, x.ndim == 4)
    labels = batch.get("label")
    labels = torch.zeros(len(x), dtype=torch.long) if labels is None else labels
    return z_ids, torch.as_tensor(labels).to(n2n.device).long()


def train_lm(n2n: Net2NetTransformer, opt: OptaxAdam, batches: Iterable[Dict[str, Any]],
             root_dir: str, max_steps: int, ckpt_every: int = 3000, log_every: int = 50,
             resume: bool = True, seed: int = 0) -> LMTrainState:
    """Train the GPT over a batch stream up to `max_steps` (or the stream's
    end); returns the final state."""
    state = init_lm_state(n2n, opt, seed)
    ckpt = find_latest_checkpoint(root_dir) if resume else None
    it = iter(batches)
    if ckpt:
        state.load_state_dict(torch.load(ckpt, map_location=n2n.device))
        print(f"auto-resumed from {ckpt} at step {state.step}")
        for _ in range(state.step):  # the batches the steps before consumed
            next(it, None)
    logger = MetricsLogger(root_dir, log_every)

    def ckpt_path() -> str:
        return os.path.join(root_dir, "checkpoints", f"step_{state.step:08d}.pt")

    while state.step < max_steps:
        batch = next(it, None)
        if batch is None:
            break
        z_ids, labels = encode_batch(n2n, batch)
        metrics = lm_train_step(n2n, opt, state, z_ids, labels)
        logger.log(state.step - 1, metrics)
        if state.step % ckpt_every == 0:
            save_state(ckpt_path(), state)
    # a final checkpoint, so a run whose max_steps is off the cadence resumes
    if state.step > 0 and not os.path.exists(ckpt_path()):
        save_state(ckpt_path(), state)
    logger.close()
    return state
