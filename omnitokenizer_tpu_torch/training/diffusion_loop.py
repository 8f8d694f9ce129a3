"""DiT/Latte diffusion training (mirror of
`omnitokenizer_tpu.training.diffusion_loop`): the reference's recipe,
AdamW (lr 1e-4, weight decay 0, optional global-norm clipping) and an EMA
of the parameters (0.9999) updated after each optimizer step, starting as
a copy of them.

    opt = OptaxAdam(lambda _: 1e-4, None, b1=0.9, b2=0.999, weight_decay=0.0)
    state = init_diffusion_state(model, opt)
    step = make_diffusion_train_step(loss_model_fn, diffusion, opt)
    state, loss, aux = step(state, x0, t, weights, generator, {"y": y})

Checkpoints are torch.save files of the state's state_dict ("model" and
"ema" are reference-named state_dicts, so a sampler reads either). The JAX
package's state_*.msgpack files are read by the sample and train CLIs
through `convert.load_diffusion_checkpoint` (params or ema_params).

Data parallelism (`group`; the JAX dit_train's GSPMD step over a
('data',) mesh): each rank holds its rows of the global batch, its noise
and label-dropout draws are its rows of the one draw for the global batch,
the loss is the global mean and the gradients are averaged over the ranks
before the optimizer, so every rank applies the same update and the EMA
stays equal everywhere. The timestep sampler is one sampler for the
global batch: every rank draws the global batch's timesteps from one rng
and keeps its rows (`sample_timesteps`), and feeds the sampler every
rank's losses (`update_sampler`), so the samplers stay equal.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..parallel import mesh
from .trainer import OptaxAdam, OptState


@dataclasses.dataclass
class DiffusionTrainState:
    """The parameters (`model`), their EMA (`ema`, a copy that takes no
    gradient), the optimizer's state and the step."""

    model: nn.Module
    ema: nn.Module
    opt: OptState
    step: int = 0

    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    def ema_params(self) -> List[torch.Tensor]:
        return list(self.ema.parameters())

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "ema": self.ema.state_dict(),
                "opt": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        self.ema.load_state_dict(sd["ema"])
        self.opt.load_state_dict(sd["opt"])
        self.step = int(sd["step"])


def init_diffusion_state(model: nn.Module, opt: OptaxAdam) -> DiffusionTrainState:
    ema = copy.deepcopy(model).requires_grad_(False)
    return DiffusionTrainState(model, ema, opt.init(list(model.parameters())), 0)


def make_diffusion_train_step(loss_model_fn: Callable, diffusion, opt: OptaxAdam,
                              ema_decay: float = 0.9999, group=None) -> Callable:
    """`loss_model_fn(model, x_t, t, generator, **cond) -> output` applies
    the label dropout itself (with a `group`, it gets group= among the
    cond and hands it to the model). The step returns (state, loss, aux):
    the weighted mean loss, each loss term's mean, the per-example loss
    (`per_t_loss`, this rank's) and the gradients' global norm. `noise`
    stands in for training_losses' draw."""
    def step(state: DiffusionTrainState, x0: torch.Tensor, t: torch.Tensor,
             weights: torch.Tensor, generator: Optional[torch.Generator] = None,
             cond: Optional[Dict[str, Any]] = None, noise: Optional[torch.Tensor] = None):
        params = state.params()

        def model_fn(x_t, tt, **kw):
            return loss_model_fn(state.model, x_t, tt, generator, **kw)

        if group is not None:
            cond = {**(cond or {}), "group": group}
            if noise is None:
                noise = mesh.draw_rows(lambda shape: torch.randn(
                    shape, generator=generator, device=x0.device, dtype=x0.dtype),
                    x0.shape, group)
        terms = diffusion.training_losses(model_fn, x0, t, generator, model_kwargs=cond,
                                          noise=noise)
        loss = mesh.mean_over((terms["loss"] * weights).mean(), group)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        mesh.average_grads_(grads, group)
        updates = opt.update(grads, state.opt, params)
        with torch.no_grad():
            torch._foreach_add_(params, updates)
            ema = state.ema_params()
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
        aux = {k: mesh.mean_over(v.detach().mean(), group) for k, v in terms.items()}
        aux["per_t_loss"] = terms["loss"].detach()
        aux["grad_norm"] = OptaxAdam.global_norm(grads)
        state.step += 1
        return state, loss.detach(), aux

    return step


def sample_timesteps(sampler, rows: int, rng, group=None):
    """(this rank's timesteps, their weights, the global batch's timesteps):
    one draw of `rows` a rank for the whole group, the same on every rank."""
    ts, weights = sampler.sample(rows * mesh.size_of(group), rng)
    return mesh.rank_rows(ts, group), mesh.rank_rows(weights, group), ts


def update_sampler(sampler, ts, per_t_loss: torch.Tensor, group=None) -> None:
    """Update with the global batch's timesteps `ts` and losses (every rank's
    `per_t_loss`, in rank order): the reference's update_with_local_losses
    all-gather, so every rank's sampler is that of one process."""
    losses = torch.cat(mesh.all_gather(per_t_loss.detach().float(), group))
    sampler.update_with_all_losses(ts, losses.cpu().numpy())


def save_diffusion_state(path: str, state: DiffusionTrainState) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)


def load_diffusion_state(path: str, state: DiffusionTrainState) -> DiffusionTrainState:
    """Load a checkpoint into `state` (its modules on their device)."""
    device = next(state.model.parameters()).device
    state.load_state_dict(torch.load(path, map_location=device))
    return state
