"""Gaussian (IDDPM-family) diffusion: schedules, losses, DDPM/DDIM sampling
(mirror of `omnitokenizer_tpu.diffusion.gaussian`).

The coefficient tables are built in float64 numpy and kept as one f32 (T, K)
tensor, one row gathered a step for the whole batch. Respacing rebuilds the
betas over the kept steps; the model then receives the original process's
timesteps (`timestep_map`), as the reference's SpacedDiffusion does.

Tensors are channels-first: (B, C, H, W) images, and for Latte (B, F, C, H,
W) clips with `channel_axis=2`; a learned-variance model's 2C outputs split
on that axis. Randomness comes from an explicit `torch.Generator`, and every
sampler also takes its draws ready made: `noise` (the initial latents) and
`step_noise` (a tensor indexed by loop step, or a callable of it), so that
two implementations can be handed the same draws. The sampling loops are
Python loops over the steps, in place of the JAX package's lax.scan.
"""

from __future__ import annotations

import enum
import math
from typing import Any, Callable, Dict, Optional, Sequence, Set, Union

import numpy as np
import torch


class MeanType(enum.Enum):
    """What the network predicts."""

    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class VarType(enum.Enum):
    """Output-variance handling."""

    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class LossType(enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"

    def is_vb(self):
        return self in (LossType.KL, LossType.RESCALED_KL)


# -- beta schedules (float64, as the reference builds them) -----------------
def get_beta_schedule(name: str, *, beta_start: float, beta_end: float, num_steps: int) -> np.ndarray:
    if name == "quad":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_steps, dtype=np.float64) ** 2
    elif name == "linear":
        betas = np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    elif name == "const":
        betas = beta_end * np.ones(num_steps, dtype=np.float64)
    elif name == "jsd":
        betas = 1.0 / np.linspace(num_steps, 1, num_steps, dtype=np.float64)
    else:
        raise NotImplementedError(name)
    return betas


def betas_for_alpha_bar(num_steps: int, alpha_bar: Callable[[float], float],
                        max_beta: float = 0.999) -> np.ndarray:
    t = np.arange(num_steps, dtype=np.float64)
    a1 = np.array([alpha_bar(float(i) / num_steps) for i in t])
    a2 = np.array([alpha_bar(float(i + 1) / num_steps) for i in t])
    return np.minimum(1.0 - a2 / a1, max_beta)


def get_named_beta_schedule(schedule_name: str, num_steps: int) -> np.ndarray:
    if schedule_name == "linear":
        scale = 1000.0 / num_steps
        return get_beta_schedule("linear", beta_start=scale * 1e-4, beta_end=scale * 0.02,
                                 num_steps=num_steps)
    if schedule_name == "squaredcos_cap_v2":
        return betas_for_alpha_bar(num_steps, lambda s: math.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """The original timesteps to keep: "ddimN" (an even stride), or counts
    per equal section ("250", "10,15,20" or a list)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


# -- probability helpers ------------------------------------------------------
def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) in nats, elementwise."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a 255-bin discretized Gaussian; x in [-1, 1]."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def mean_flat(x):
    """Mean over all non-batch axes."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def _bcast(v, ndim):
    """(B,) -> (B, 1, 1, ...) against a (B, ...) tensor."""
    return v.reshape(v.shape[0], *([1] * (ndim - 1)))


# the columns of the stacked coefficient table
_COLS = (
    "betas",
    "alphas_cumprod",
    "alphas_cumprod_prev",
    "alphas_cumprod_next",
    "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod",
    "posterior_variance",
    "posterior_log_variance_clipped",
    "posterior_mean_coef1",
    "posterior_mean_coef2",
    "fixed_large_variance",
    "fixed_large_log_variance",
    "log_betas",
)
_COL = {name: i for i, name in enumerate(_COLS)}

ModelFn = Callable[..., torch.Tensor]
StepNoise = Union[None, torch.Tensor, Sequence[torch.Tensor], Callable[[int], torch.Tensor]]


class GaussianDiffusion:
    """The diffusion process over channels-first tensors.

    `model_fn(x, t, **model_kwargs) -> out`, with 2C channels on
    `channel_axis` when var_type is LEARNED/LEARNED_RANGE. With
    `use_timesteps` the indices 0..S-1 address the spaced process and the
    model receives `timestep_map[t]`."""

    def __init__(self, *, betas: np.ndarray, mean_type: MeanType = MeanType.EPSILON,
                 var_type: VarType = VarType.LEARNED_RANGE, loss_type: LossType = LossType.MSE,
                 use_timesteps: Optional[Set[int]] = None, channel_axis: int = 1):
        betas = np.asarray(betas, dtype=np.float64)
        if not (betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D schedule in (0, 1]")
        self.original_num_steps = len(betas)
        if use_timesteps is not None:
            # the betas over the kept steps, so that alphas_cumprod equals
            # the base process's at every kept index
            keep = set(use_timesteps)
            timestep_map, new_betas, last = [], [], 1.0
            for i, acp in enumerate(np.cumprod(1.0 - betas)):
                if i in keep:
                    new_betas.append(1.0 - acp / last)
                    last = acp
                    timestep_map.append(i)
            betas = np.array(new_betas, dtype=np.float64)
            self.timestep_map = np.array(timestep_map, dtype=np.int64)
        else:
            self.timestep_map = np.arange(len(betas), dtype=np.int64)

        self.mean_type, self.var_type, self.loss_type = mean_type, var_type, loss_type
        self.channel_axis = channel_axis
        self.num_timesteps = int(betas.shape[0])

        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        post_logvar = (np.log(np.append(post_var[1], post_var[1:])) if len(post_var) > 1
                       else np.array([]))
        tables = {
            "betas": betas,
            "alphas_cumprod": acp,
            "alphas_cumprod_prev": acp_prev,
            "alphas_cumprod_next": acp_next,
            "sqrt_alphas_cumprod": np.sqrt(acp),
            "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - acp),
            "log_one_minus_alphas_cumprod": np.log(1.0 - acp),
            "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / acp),
            "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / acp - 1.0),
            "posterior_variance": post_var,
            "posterior_log_variance_clipped": post_logvar,
            "posterior_mean_coef1": betas * np.sqrt(acp_prev) / (1.0 - acp),
            "posterior_mean_coef2": (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
            "fixed_large_variance": np.append(post_var[1], betas[1:]),
            "fixed_large_log_variance": np.log(np.append(post_var[1], betas[1:])),
            "log_betas": np.log(betas),
        }
        for k, v in tables.items():  # the float64 tables, for inspection
            setattr(self, k, v)
        self._coef = torch.from_numpy(np.stack([tables[n] for n in _COLS], axis=1)).float()
        self._tmap = torch.from_numpy(self.timestep_map)
        self._on: Dict[torch.device, tuple] = {}

    # -- coefficient access --------------------------------------------------
    def _tables(self, device) -> tuple:
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = (self._coef.to(device), self._tmap.to(device))
        return self._on[device]

    def _c(self, t: torch.Tensor, name: str, ndim: int) -> torch.Tensor:
        """One coefficient at (B,) timesteps, broadcastable against ndim."""
        return _bcast(self._tables(t.device)[0][t, _COL[name]], ndim)

    def map_t(self, t: torch.Tensor) -> torch.Tensor:
        """Spaced index -> the original process's timestep the model sees."""
        return self._tables(t.device)[1][t]

    def _call_model(self, model_fn: ModelFn, x, t, model_kwargs):
        return model_fn(x, self.map_t(t), **(model_kwargs or {})).to(x.dtype)

    # -- q process -----------------------------------------------------------
    def q_mean_variance(self, x_start, t):
        mean = self._c(t, "sqrt_alphas_cumprod", x_start.ndim) * x_start
        variance = 1.0 - self._c(t, "alphas_cumprod", x_start.ndim)
        log_variance = self._c(t, "log_one_minus_alphas_cumprod", x_start.ndim)
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        if noise.shape != x_start.shape:
            raise ValueError(f"noise {tuple(noise.shape)} != x_start {tuple(x_start.shape)}")
        return (self._c(t, "sqrt_alphas_cumprod", x_start.ndim) * x_start
                + self._c(t, "sqrt_one_minus_alphas_cumprod", x_start.ndim) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        mean = (self._c(t, "posterior_mean_coef1", x_t.ndim) * x_start
                + self._c(t, "posterior_mean_coef2", x_t.ndim) * x_t)
        return (mean, self._c(t, "posterior_variance", x_t.ndim),
                self._c(t, "posterior_log_variance_clipped", x_t.ndim))

    # -- p process -----------------------------------------------------------
    def predict_xstart_from_eps(self, x_t, t, eps):
        return (self._c(t, "sqrt_recip_alphas_cumprod", x_t.ndim) * x_t
                - self._c(t, "sqrt_recipm1_alphas_cumprod", x_t.ndim) * eps)

    def predict_eps_from_xstart(self, x_t, t, pred_xstart):
        return ((self._c(t, "sqrt_recip_alphas_cumprod", x_t.ndim) * x_t - pred_xstart)
                / self._c(t, "sqrt_recipm1_alphas_cumprod", x_t.ndim))

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        c1 = self._c(t, "posterior_mean_coef1", x_t.ndim)
        c2 = self._c(t, "posterior_mean_coef2", x_t.ndim)
        return (xprev - c2 * x_t) / c1

    def _split_learned_var(self, model_output, x):
        ax = self.channel_axis % model_output.ndim
        if model_output.shape[ax] != 2 * x.shape[ax]:
            raise ValueError(f"a learned-variance model outputs 2x channels on axis {ax}; got "
                             f"{tuple(model_output.shape)} for x {tuple(x.shape)}")
        return torch.chunk(model_output, 2, dim=ax)

    def p_mean_variance(self, model_fn: ModelFn, x, t, clip_denoised: bool = True,
                        denoised_fn=None, model_kwargs=None, model_output=None
                        ) -> Dict[str, torch.Tensor]:
        """p(x_{t-1} | x_t) and pred_xstart; `model_output` stands in for
        the network call (the vb term of training_losses)."""
        if model_output is None:
            model_output = self._call_model(model_fn, x, t, model_kwargs)

        if self.var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
            model_output, var_values = self._split_learned_var(model_output, x)
            if self.var_type == VarType.LEARNED:
                model_log_variance = var_values
            else:
                min_log = self._c(t, "posterior_log_variance_clipped", x.ndim)
                max_log = self._c(t, "log_betas", x.ndim)
                frac = (var_values + 1.0) / 2.0
                model_log_variance = frac * max_log + (1.0 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.var_type == VarType.FIXED_LARGE:
            model_variance = self._c(t, "fixed_large_variance", x.ndim)
            model_log_variance = self._c(t, "fixed_large_log_variance", x.ndim)
        else:  # FIXED_SMALL
            model_variance = self._c(t, "posterior_variance", x.ndim)
            model_log_variance = self._c(t, "posterior_log_variance_clipped", x.ndim)
        model_variance = model_variance.expand(x.shape)
        model_log_variance = model_log_variance.expand(x.shape)

        def process_xstart(x0):
            if denoised_fn is not None:
                x0 = denoised_fn(x0)
            return x0.clamp(-1.0, 1.0) if clip_denoised else x0

        if self.mean_type == MeanType.START_X:
            pred_xstart = process_xstart(model_output)
        elif self.mean_type == MeanType.EPSILON:
            pred_xstart = process_xstart(self.predict_xstart_from_eps(x, t, model_output))
        else:  # PREVIOUS_X: the model outputs the posterior mean
            pred_xstart = process_xstart(self._predict_xstart_from_xprev(x, t, model_output))
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart}

    # -- single reverse steps --------------------------------------------------
    @staticmethod
    def _noise(x, noise, generator):
        if noise is not None:
            return noise.to(x.device, x.dtype)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    def p_sample(self, model_fn, x, t, generator=None, clip_denoised=True, denoised_fn=None,
                 model_kwargs=None, noise=None):
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn, model_kwargs)
        noise = self._noise(x, noise, generator)
        nonzero = _bcast((t != 0).to(x.dtype), x.ndim)
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(self, model_fn, x, t, generator=None, clip_denoised=True, denoised_fn=None,
                    model_kwargs=None, eta=0.0, noise=None):
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn, model_kwargs)
        eps = self.predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = self._c(t, "alphas_cumprod", x.ndim)
        alpha_bar_prev = self._c(t, "alphas_cumprod_prev", x.ndim)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        sample = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                  + torch.sqrt((1 - alpha_bar_prev - sigma ** 2).clamp(min=0.0)) * eps)
        if eta != 0.0:  # eta 0 is deterministic: no draw
            nonzero = _bcast((t != 0).to(x.dtype), x.ndim)
            sample = sample + nonzero * sigma * self._noise(x, noise, generator)
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(self, model_fn, x, t, clip_denoised=True, denoised_fn=None,
                            model_kwargs=None):
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn, model_kwargs)
        eps = self.predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_next = self._c(t, "alphas_cumprod_next", x.ndim)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
                     + torch.sqrt(1 - alpha_bar_next) * eps)
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    # -- sampling loops --------------------------------------------------------
    def _loop(self, step_fn, shape, generator, noise, step_noise: StepNoise, device):
        """Step k = 0..S-1 samples the spaced index S-1-k with step_noise's
        k-th draw (drawn from `generator` where step_noise is None)."""
        if noise is None:
            img = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        else:
            img = noise.to(device, torch.float32)
        for k, i in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((shape[0],), i, dtype=torch.long, device=img.device)
            nz = step_noise(k) if callable(step_noise) else (
                None if step_noise is None else step_noise[k])
            img = step_fn(img, t, nz)["sample"]
        return img

    def p_sample_loop(self, model_fn, shape, generator=None, noise=None, step_noise=None,
                      clip_denoised=True, denoised_fn=None, model_kwargs=None, device=None):
        """Ancestral (DDPM) sampling from x_T = `noise` (or a draw)."""
        def step(x, t, nz):
            return self.p_sample(model_fn, x, t, generator, clip_denoised, denoised_fn,
                                 model_kwargs, noise=nz)
        return self._loop(step, shape, generator, noise, step_noise, device)

    def ddim_sample_loop(self, model_fn, shape, generator=None, noise=None, step_noise=None,
                         clip_denoised=True, denoised_fn=None, model_kwargs=None, eta=0.0,
                         device=None):
        def step(x, t, nz):
            return self.ddim_sample(model_fn, x, t, generator, clip_denoised, denoised_fn,
                                    model_kwargs, eta, noise=nz)
        return self._loop(step, shape, generator, noise, step_noise, device)

    # -- losses --------------------------------------------------------------
    def vb_terms_bpd(self, model_fn, x_start, x_t, t, clip_denoised=True, model_kwargs=None,
                     model_output=None):
        """KL(q(x_{t-1} | x_t, x_0) || p(x_{t-1} | x_t)) in bits; the
        decoder's NLL at t = 0."""
        true_mean, _, true_logvar = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised=clip_denoised,
                                   model_kwargs=model_kwargs, model_output=model_output)
        kl = mean_flat(normal_kl(true_mean, true_logvar, out["mean"], out["log_variance"]))
        kl = kl / math.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model_fn, x_start, t, generator=None, model_kwargs=None,
                        noise=None) -> Dict[str, Any]:
        """Per-example loss terms; `noise` stands in for the draw."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        x_t = self.q_sample(x_start, t, noise)
        terms: Dict[str, Any] = {}
        if self.loss_type.is_vb():
            terms["loss"] = self.vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised=False,
                                              model_kwargs=model_kwargs)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output = self._call_model(model_fn, x_t, t, model_kwargs)
        if self.var_type in (VarType.LEARNED, VarType.LEARNED_RANGE):
            mean_out, var_values = self._split_learned_var(model_output, x_t)
            # the variance learns through the vb term only: the mean is detached
            frozen = torch.cat([mean_out.detach(), var_values], dim=self.channel_axis)
            terms["vb"] = self.vb_terms_bpd(None, x_start, x_t, t, clip_denoised=False,
                                            model_output=frozen)["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
            model_output = mean_out

        if self.mean_type == MeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        else:
            target = x_start if self.mean_type == MeanType.START_X else noise
        if not model_output.shape == target.shape == x_start.shape:
            raise ValueError(f"model output {tuple(model_output.shape)} != x_start "
                             f"{tuple(x_start.shape)}")
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms

    def prior_bpd(self, x_start):
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long,
                       device=x_start.device)
        qt_mean, _, qt_logvar = self.q_mean_variance(x_start, t)
        zero = torch.zeros_like(qt_mean)
        return mean_flat(normal_kl(qt_mean, qt_logvar, zero, zero)) / math.log(2.0)


def create_diffusion(timestep_respacing: Optional[Union[str, Sequence[int]]] = None,
                     noise_schedule: str = "linear", use_kl: bool = False,
                     sigma_small: bool = False, predict_xstart: bool = False,
                     learn_sigma: bool = True, rescale_learned_sigmas: bool = False,
                     diffusion_steps: int = 1000, channel_axis: int = 1) -> GaussianDiffusion:
    """The reference's create_diffusion with its defaults (linear schedule,
    1000 steps, learned-range variance, MSE)."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    return GaussianDiffusion(
        betas=betas,
        mean_type=MeanType.START_X if predict_xstart else MeanType.EPSILON,
        var_type=(VarType.LEARNED_RANGE if learn_sigma
                  else (VarType.FIXED_SMALL if sigma_small else VarType.FIXED_LARGE)),
        loss_type=loss_type,
        use_timesteps=space_timesteps(diffusion_steps, timestep_respacing),
        channel_axis=channel_axis,
    )
