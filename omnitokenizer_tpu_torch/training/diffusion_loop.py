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
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

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
                              ema_decay: float = 0.9999) -> Callable:
    """`loss_model_fn(model, x_t, t, generator, **cond) -> output` applies
    the label dropout itself. The step returns (state, loss, aux): the
    weighted mean loss, each loss term's mean, the per-example loss
    (`per_t_loss`) and the gradients' global norm. `noise` stands in for
    training_losses' draw."""
    def step(state: DiffusionTrainState, x0: torch.Tensor, t: torch.Tensor,
             weights: torch.Tensor, generator: Optional[torch.Generator] = None,
             cond: Optional[Dict[str, Any]] = None, noise: Optional[torch.Tensor] = None):
        params = state.params()

        def model_fn(x_t, tt, **kw):
            return loss_model_fn(state.model, x_t, tt, generator, **kw)

        terms = diffusion.training_losses(model_fn, x0, t, generator, model_kwargs=cond,
                                          noise=noise)
        loss = (terms["loss"] * weights).mean()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        updates = opt.update(grads, state.opt, params)
        with torch.no_grad():
            torch._foreach_add_(params, updates)
            ema = state.ema_params()
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
        aux = {k: v.detach().mean() for k, v in terms.items()}
        aux["per_t_loss"] = terms["loss"].detach()
        aux["grad_norm"] = OptaxAdam.global_norm(grads)
        state.step += 1
        return state, loss.detach(), aux

    return step


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
