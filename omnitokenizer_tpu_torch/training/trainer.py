"""Two-optimizer GAN training of the tokenizer (mirror of
`omnitokenizer_tpu.training.trainer`).

One step, as the JAX step computes it:
 * the generator pass: a training forward of the net (the bf16 kernels as
   the primal, ops/kernel_grad.py; the codebook's EMA advances), the
   reconstruction, perceptual, GAN and feature-matching losses, with both
   discriminators in train mode and their BatchNorm updates thrown away;
 * the generator's optimizer, then, with ema_advances_per_step=2, a
   re-encode of the batch with the updated parameters on the inference
   route (no grad), which advances the codebook a second time;
 * the discriminator pass on the detached frames and clips, the BatchNorm
   statistics chained real -> fake, and its optimizer.

The optimizers are optax's chain clip_by_global_norm -> scale_by_adam(b1=0.5,
b2=0.9, eps=1e-8) -> the learning rate of a warmup-cosine schedule, inside
optax.MultiSteps when grad_accumulates > 1, written out here (`OptaxAdam`).
The skip gates multiply the updates by 0 or 1 after the optimizer ran, so
Adam's moments advance on a skipped step; the discriminator's gate is its
own. Every random draw comes from a `torch.Generator` seeded from (seed,
step, purpose): a resumed run draws what an unbroken one would.

The parameters stay f32 and the compute runs in cfg.dtype; a net that
went through the serving step (`OmniTokenizerVQGAN.serving()`, which casts
the parameters, or `prepare_kernels()`, which caches detached bf16
weights) is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import LossConfig, TokenizerConfig, TrainConfig
from ..models.discriminator import NLayerDiscriminator, NLayerDiscriminator3D
from ..models.lpips import LPIPS, load_lpips_variables
from ..models.tokenizer import OmniTokenizerNet, init_weights
from ..ops.attention import Attention, FeedForward
from ..ops.diffaug import diff_augment, diff_augment_video
from .losses import adopt_weight, hinge_d_loss, l1, l2, logits_laplace, vanilla_d_loss

# one stream a purpose, as the JAX step splits its key
STREAMS = ("frame", "codebook", "codebook2", "noise1", "noise2", "noise3", "aug_d", "aug_g")


# -- schedules and the optimizer chain ---------------------------------------
def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from init to peak over
    warmup_steps, then a cosine to end_value at decay_steps (counted from
    step 0); in float32, as optax computes it."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(cos_steps)))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def _warmup_cosine(tc: TrainConfig, peak: float, warm: int, end: float):
    # the horizon counts the warmup; warmup is clamped below it
    total = max(tc.max_steps, 2)
    warm = min(max(warm, 1), total - 1)
    return warmup_cosine_decay(tc.warmup_lr_init, peak, warm, total, end)


def g_schedule(tc: TrainConfig):
    return _warmup_cosine(tc, tc.lr, tc.warmup_steps, tc.lr_min)


def d_schedule(tc: TrainConfig):
    warm = tc.dis_warmup_steps if tc.dis_warmup_steps > 0 else tc.warmup_steps
    end = tc.lr_min * tc.dis_lr_multiplier if tc.dis_minlr_multiplier else tc.lr_min
    return _warmup_cosine(tc, tc.lr * tc.dis_lr_multiplier, warm, end)


@dataclasses.dataclass
class OptState:
    """The chain's state: Adam's moments and count, the schedule's count,
    and MultiSteps' mini-step, emitted steps and gradient mean."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0
    lr_count: int = 0
    mini_step: int = 0
    gradient_step: int = 0
    acc: Optional[List[torch.Tensor]] = None

    def state_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for f in dataclasses.fields(self):
            cur, new = getattr(self, f.name), sd[f.name]
            if isinstance(cur, list):
                for t, v in zip(cur, new):
                    t.copy_(v)
            else:
                setattr(self, f.name, new)


class OptaxAdam:
    """optax.chain(clip_by_global_norm(clip), scale_by_adam(0.5, 0.9, 1e-8),
    scale_by_learning_rate(schedule)), in optax.MultiSteps(k) when k > 1:
    the gradients' running mean over k mini-steps, the chain run on the
    k-th, whose updates are emitted; zero updates before it."""

    b1, b2, eps = 0.5, 0.9, 1e-8  # the reference's Adam(betas=(0.5, 0.9))

    def __init__(self, schedule: Callable[[int], float], clip: Optional[float],
                 accumulates: int = 1):
        self.schedule, self.clip, self.k = schedule, clip, accumulates

    def init(self, params: List[torch.Tensor]) -> OptState:
        def zeros():
            return [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params]
        return OptState(mu=zeros(), nu=zeros(), acc=zeros() if self.k > 1 else None)

    @staticmethod
    def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
        return torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()

    def _chain(self, grads: List[torch.Tensor], st: OptState) -> List[torch.Tensor]:
        if self.clip is not None:
            norm = self.global_norm(grads)
            factor = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            grads = torch._foreach_mul(grads, factor)
        torch._foreach_mul_(st.mu, self.b1)
        torch._foreach_add_(st.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(st.nu, self.b2)
        torch._foreach_addcmul_(st.nu, grads, grads, value=1 - self.b2)
        st.count += 1
        denom = torch._foreach_div(st.nu, 1 - self.b2 ** st.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(st.mu, 1 - self.b1 ** st.count)
        torch._foreach_div_(updates, denom)
        torch._foreach_mul_(updates, -self.schedule(st.lr_count))
        st.lr_count += 1
        return updates

    def update(self, grads: List[torch.Tensor], st: OptState) -> Optional[List[torch.Tensor]]:
        """The updates of this step (None: MultiSteps emits none), advancing
        `st` in place."""
        if self.k == 1:
            return self._chain(grads, st)
        # the running mean: acc += (g - acc) / (mini_step + 1)
        diff = torch._foreach_sub(grads, st.acc)
        torch._foreach_div_(diff, st.mini_step + 1)
        torch._foreach_add_(st.acc, diff)
        emit = st.mini_step == self.k - 1
        st.mini_step = (st.mini_step + 1) % self.k
        if not emit:
            return None
        st.gradient_step += 1
        updates = self._chain(st.acc, st)
        torch._foreach_zero_(st.acc)
        return updates


# -- state --------------------------------------------------------------------
@dataclasses.dataclass
class TokenizerTrainState:
    """Everything a step reads and writes: the modules (their parameters and
    buffers: the codebook, the discriminators' running statistics), both
    optimizers' states, the step and the seed of the random streams."""

    step: int
    seed: int
    net: OmniTokenizerNet
    image_disc: NLayerDiscriminator
    video_disc: NLayerDiscriminator3D
    lpips: LPIPS
    opt_g: OptState
    opt_d: OptState

    MODULES = ("net", "image_disc", "video_disc", "lpips")

    def g_params(self) -> List[torch.Tensor]:
        return list(self.net.parameters())

    def d_params(self) -> List[torch.Tensor]:
        return list(self.image_disc.parameters()) + list(self.video_disc.parameters())

    def state_dict(self) -> Dict[str, Any]:
        sd = {"step": self.step, "seed": self.seed,
              "opt_g": self.opt_g.state_dict(), "opt_d": self.opt_d.state_dict()}
        sd.update({m: getattr(self, m).state_dict() for m in self.MODULES})
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step, self.seed = int(sd["step"]), int(sd["seed"])
        for m in self.MODULES:
            getattr(self, m).load_state_dict(sd[m])
        self.opt_g.load_state_dict(sd["opt_g"])
        self.opt_d.load_state_dict(sd["opt_d"])


def check_trainable(net: OmniTokenizerNet) -> None:
    """Refuse a net that went through the serving step: bf16-cast master
    weights, or a serving cache of detached bf16 weights."""
    cast = [n for n, p in net.named_parameters() if p.dtype != torch.float32]
    cached = [n for n, m in net.named_modules()
              if isinstance(m, (Attention, FeedForward)) and m.kernel_weights is not None]
    if cast or cached:
        raise ValueError(
            "this net went through the serving step (OmniTokenizerVQGAN.serving() or "
            "prepare_kernels()); training needs f32 parameters and no serving cache: "
            f"{len(cast)} cast parameters (first {cast[:1]}), {len(cached)} cached modules "
            f"(first {cached[:1]})")


def _transformer_param(name: str) -> bool:
    return any(part.endswith("_transformer") for part in name.split("."))


@torch.no_grad()
def init_discriminator(disc: torch.nn.Module, generator: torch.Generator) -> None:
    """LeCun-normal conv kernels and zero biases (flax's Conv init, not
    truncated); norms and noise weights keep their ones and zeros."""
    for m in disc.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * m.weight[0].numel() ** -0.5)
            m.bias.zero_()


class TokenizerTrainer:
    """Builds the state and runs the GAN step for a config triple, on the
    card unless `device` says otherwise. `lpips_vgg16_path` and
    `lpips_lin_path` name the perceptual net's weights (see
    models.lpips.load_lpips_variables)."""

    def __init__(self, cfg: TokenizerConfig, loss_cfg: LossConfig = LossConfig(),
                 train_cfg: TrainConfig = TrainConfig(), device: Any = "cuda",
                 lpips_vgg16_path: Optional[str] = None, lpips_lin_path: Optional[str] = None):
        if cfg.use_vae:
            raise NotImplementedError(
                "VAE training is not ported: the JAX trainer runs a VAE's generator with "
                "training=False, the inference route (see ROADMAP.md)")
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
        self.cfg, self.loss_cfg, self.train_cfg = cfg, loss_cfg, train_cfg
        self.device = torch.device(device)
        self.lpips_paths = dict(vgg16_torch_path=lpips_vgg16_path, lin_path=lpips_lin_path)
        self.lpips_pretrained: Optional[bool] = None
        self.opt_g = OptaxAdam(g_schedule(train_cfg), train_cfg.grad_clip_val,
                               train_cfg.grad_accumulates)
        self.opt_d = OptaxAdam(d_schedule(train_cfg), train_cfg.grad_clip_val_disc,
                               train_cfg.grad_accumulates)
        self._d_loss = hinge_d_loss if loss_cfg.disc_loss_type == "hinge" else vanilla_d_loss

    def _discriminators(self):
        cfg, lc = self.cfg, self.loss_cfg
        kw = dict(input_nc=cfg.image_channels, ndf=lc.disc_channels, n_layers=lc.disc_layers,
                  norm_type=cfg.norm_type, use_sigmoid=lc.sigmoid_in_disc,
                  activation=lc.activation_in_disc, apply_noise=lc.apply_noise,
                  dtype=cfg.dtype)
        return NLayerDiscriminator(**kw), NLayerDiscriminator3D(**kw)

    def init_state(self, seed: int = 0, net: Optional[OmniTokenizerNet] = None
                   ) -> TokenizerTrainState:
        """Random weights from `seed` (a given `net` keeps its own), zeroed
        optimizer states, step 0."""
        gen = torch.Generator().manual_seed(seed)
        if net is None:
            net = OmniTokenizerNet(self.cfg)
            init_weights(net, gen)
        check_trainable(net)
        image_disc, video_disc = self._discriminators()
        init_discriminator(image_disc, gen)
        init_discriminator(video_disc, gen)
        lpips, self.lpips_pretrained = load_lpips_variables(LPIPS(self.cfg.dtype),
                                                            generator=gen, **self.lpips_paths)
        lpips.requires_grad_(False)
        mods = [m.to(self.device) for m in (net, image_disc, video_disc, lpips)]
        state = TokenizerTrainState(step=0, seed=seed, net=mods[0], image_disc=mods[1],
                                    video_disc=mods[2], lpips=mods[3],
                                    opt_g=None, opt_d=None)
        state.opt_g = self.opt_g.init(state.g_params())
        state.opt_d = self.opt_d.init(state.d_params())
        return state

    def generators(self, state: TokenizerTrainState) -> Callable[[str], torch.Generator]:
        """A fresh generator for each purpose of this step: one purpose
        called twice draws the same values, as one JAX key used twice."""
        def gen(name: str) -> torch.Generator:
            seed = ((state.seed * 1_000_003 + state.step) * len(STREAMS)
                    + STREAMS.index(name)) % (2 ** 63)
            return torch.Generator(device=self.device).manual_seed(seed)
        return gen

    @staticmethod
    def _apply(params: List[torch.Tensor], updates: Optional[List[torch.Tensor]],
               gate: torch.Tensor) -> None:
        if updates is not None:
            with torch.no_grad():
                torch._foreach_mul_(updates, gate)
                torch._foreach_add_(params, updates)

    def _g_losses(self, state, video, gen, disc_factor):
        """The generator's forward: the reconstruction (the codebook
        advances), then every loss of the generator pass."""
        lc = self.loss_cfg
        net, image_disc, video_disc = state.net, state.image_disc, state.video_disc
        B, T = video.shape[:2]
        is_image = T == 1
        zero = torch.zeros((), device=self.device)
        frame_idx = torch.randint(0, T, (B,), generator=gen("frame"), device=self.device)
        batch_idx = torch.arange(B, device=self.device)

        x_recon, aux = net(video, is_image, training=True, generator=gen("codebook"))
        if lc.recon_loss_type == "l1":
            recon_loss = l1(x_recon, video) * lc.l1_weight
        else:
            recon_loss = l2(x_recon, video) * lc.l1_weight
            recon_loss = recon_loss + logits_laplace(video, x_recon) * lc.logitslaplace_weight

        frames, frames_recon = video[batch_idx, frame_idx], x_recon[batch_idx, frame_idx]
        if lc.apply_allframes:
            frames = video.reshape(-1, *video.shape[2:])
            frames_recon = x_recon.reshape(-1, *x_recon.shape[2:])

        perceptual_loss = zero
        if lc.perceptual_weight > 0:
            perceptual_loss = state.lpips(frames, frames_recon).mean() * lc.perceptual_weight

        noise = self._noise(gen)
        logits_image_fake, pred_image_fake = image_disc(frames_recon, True, noise("noise1"))
        g_image_loss = -logits_image_fake.mean()
        g_video_loss = zero
        if not is_image:
            logits_video_fake, pred_video_fake = video_disc(x_recon, True, noise("noise1"))
            g_video_loss = -logits_video_fake.mean()
        aeloss = disc_factor * (lc.image_gan_weight * g_image_loss
                                + lc.video_gan_weight * g_video_loss)

        # feature matching; the real features carry no gradient
        feat_weights = 4.0 / (3 + 1)
        image_feat, video_feat = zero, zero
        if lc.image_gan_weight > 0:
            with torch.no_grad():
                _, pred_image_real = image_disc(frames, True, noise("noise1"))
            for f, r in zip(pred_image_fake[:-1], pred_image_real[:-1]):
                image_feat = image_feat + feat_weights * l1(f, r)
        if lc.video_gan_weight > 0 and not is_image:
            with torch.no_grad():
                _, pred_video_real = video_disc(video, True, noise("noise1"))
            for f, r in zip(pred_video_fake[:-1], pred_video_real[:-1]):
                video_feat = video_feat + feat_weights * l1(f, r)
        gan_feat_loss = disc_factor * lc.gan_feat_weight * (image_feat + video_feat)

        commitment_loss = aux["commitment_loss"]
        g_total = recon_loss + commitment_loss + aeloss + perceptual_loss + gan_feat_loss
        metrics = dict(recon_loss=recon_loss, commitment_loss=commitment_loss, aeloss=aeloss,
                       perceptual_loss=perceptual_loss, gan_feat_loss=gan_feat_loss,
                       perplexity=aux["perplexity"], avg_usage=aux["avg_usage"], g_total=g_total)
        return metrics, x_recon, frames, frames_recon

    def _d_losses(self, state, video, x_recon, frames, frames_recon, gen, disc_factor):
        """The discriminator's forward on the detached frames and clips; the
        BatchNorm statistics advance real -> fake."""
        lc = self.loss_cfg
        image_disc, video_disc = state.image_disc, state.video_disc
        noise = self._noise(gen)

        def prep(x, name, fn):
            return fn(x.detach(), gen(name)) if lc.apply_diffaug else x.detach()

        lr_real, _ = image_disc(prep(frames, "aug_d", diff_augment), True,
                               noise("noise2"), update_stats=True)
        lr_fake, _ = image_disc(prep(frames_recon, "aug_g", diff_augment), True,
                               noise("noise3"), update_stats=True)
        d_image_loss = self._d_loss(lr_real, lr_fake)
        d_video_loss = torch.zeros((), device=self.device)
        if video.shape[1] > 1:
            lv_real, _ = video_disc(prep(video, "aug_d", diff_augment_video), True,
                                    noise("noise2"), update_stats=True)
            lv_fake, _ = video_disc(prep(x_recon, "aug_g", diff_augment_video), True,
                                    noise("noise3"), update_stats=True)
            d_video_loss = self._d_loss(lv_real, lv_fake)
        discloss = disc_factor * (lc.image_gan_weight * d_image_loss
                                  + lc.video_gan_weight * d_video_loss)
        return dict(discloss=discloss, d_image_loss=d_image_loss, d_video_loss=d_video_loss)

    def _noise(self, gen):
        return lambda name: gen(name) if self.loss_cfg.apply_noise else None

    def _g_update(self, state, grads, metrics) -> Dict[str, torch.Tensor]:
        """The generator's gates, freeze and optimizer step."""
        tc = self.train_cfg
        gate = torch.ones((), device=self.device)
        if state.step > 100_000:  # the skip gates look at the losses after step 100k
            if tc.recloss_check_thres is not None:
                gate = gate * (1 - (metrics["recon_loss"] > tc.recloss_check_thres).float())
            if tc.perloss_check_thres is not None:
                gate = gate * (1 - (metrics["perceptual_loss"] > tc.perloss_check_thres).float())
        torch._foreach_div_(grads, tc.grad_accumulates)
        if tc.freeze_trans:
            for (name, _), g in zip(state.net.named_parameters(), grads):
                if _transformer_param(name):
                    g.zero_()
        norm = OptaxAdam.global_norm(grads)
        self._apply(state.g_params(), self.opt_g.update(grads, state.opt_g), gate)
        return dict(optim_gen=gate, grad_norm_g=norm)

    def _codebook_again(self, state, video, gen) -> None:
        """The D pass's re-encode with the updated parameters (inference
        route), which advances the codebook a second time."""
        with torch.no_grad():
            h = state.net.encode_latent(video, video.shape[1] == 1)
            state.net.quantize(h, training=True, generator=gen("codebook2"))

    def _d_update(self, state, grads, metrics) -> Dict[str, torch.Tensor]:
        """The discriminator's own gate and optimizer step."""
        tc = self.train_cfg
        gate = torch.ones((), device=self.device)
        if tc.disloss_check_thres is not None:
            gate = 1 - (metrics["discloss"] < tc.disloss_check_thres).float()
        torch._foreach_div_(grads, tc.grad_accumulates)
        norm = OptaxAdam.global_norm(grads)
        self._apply(state.d_params(), self.opt_d.update(grads, state.opt_d), gate)
        return dict(optim_disc=gate, grad_norm_d=norm)

    def train_step(self, state: TokenizerTrainState, video: torch.Tensor
                   ) -> Tuple[TokenizerTrainState, Dict[str, torch.Tensor]]:
        """One G + D step on `video`, channels-last (B, T, H, W, C), T >= 1.
        Advances `state` in place and returns it with the step's metrics
        (0-d tensors: the JAX step's, and the global norms of both
        gradients before clipping)."""
        check_trainable(state.net)
        video = video.to(self.device, torch.float32)
        gen = self.generators(state)
        disc_factor = adopt_weight(state.step, self.loss_cfg.discriminator_iter_start)

        metrics, x_recon, frames, frames_recon = self._g_losses(state, video, gen, disc_factor)
        g_grads = self._grads(metrics["g_total"], state.g_params())
        metrics.update(self._g_update(state, g_grads, metrics))
        del g_grads
        if self.train_cfg.ema_advances_per_step == 2:
            self._codebook_again(state, video, gen)
        metrics.update(self._d_losses(state, video, x_recon, frames, frames_recon, gen,
                                      disc_factor))
        d_grads = self._grads(metrics["discloss"], state.d_params())
        metrics.update(self._d_update(state, d_grads, metrics))
        state.step += 1
        return state, {k: torch.as_tensor(v, device=self.device).detach().float()
                       for k, v in metrics.items()}

    @staticmethod
    def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
        """d loss / d params, zeros where a parameter does not reach it."""
        if not loss.requires_grad:
            return [torch.zeros_like(p) for p in params]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
