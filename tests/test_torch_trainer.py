"""One GAN step of the port's TokenizerTrainer against the JAX package's
TokenizerTrainer.train_step, in f32 on the CPU at the SMALL size, from the
same state (the JAX trainer's initial state through
convert.load_train_state_from_jax, its codebook marked initialized) and
the same clips.

The draws that two PRNGs cannot share are off, through the configs a
user has: no discriminator noise, no DiffAugment, every frame to LPIPS and
the image discriminator (no random frame pick), and an initialized
codebook (no data-dependent init); the restart is off by default. The
gradients are read from Adam's first moment after the step (mu = (1 - b1)
g on a first step, no clipping), so the optimizer is the one under test
too; the parameters after the step are not compared: Adam's first update
is lr * sign(g), which flips where g is near zero.

Bars: every metric the JAX step returns within 1e-5 relative; each G and
D gradient within 1e-4 of its norm (but for the biases a BatchNorm
follows, whose gradient is zero); the codebook buffers after the step
within 1e-5, with ema_advances_per_step=2 (the JAX step itself) and 1
(the JAX net's own training forward: the one codebook update an
ema_advances_per_step=1 step makes); the discriminators' BatchNorm
statistics within 1e-5. The JAX step is built and run once for the
module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.config import LossConfig as JaxLossConfig
from omnitokenizer_tpu.config import TrainConfig as JaxTrainConfig
from omnitokenizer_tpu.training import trainer as jtrainer
from omnitokenizer_tpu_torch.config import LossConfig, TrainConfig
from omnitokenizer_tpu_torch.convert import load_train_state_from_jax, state_dict_from_jax
from omnitokenizer_tpu_torch.models.discriminator import BatchNorm
from omnitokenizer_tpu_torch.training import trainer as ttrainer

from torch_port_util import configs, to_numpy_tree

torch.set_num_threads(1)

LOSS = dict(perceptual_weight=1.0, image_gan_weight=1.0, video_gan_weight=1.0,
            gan_feat_weight=4.0, disc_layers=2, disc_channels=16, apply_noise=False,
            apply_diffaug=False, apply_allframes=True)
TRAIN = dict(lr=1e-4, warmup_steps=10, max_steps=1000, warmup_lr_init=1e-5,
             grad_clip_val=None, grad_clip_val_disc=None, ema_advances_per_step=2)
CODEBOOK = ("embeddings", "N", "z_avg", "codebook_usage")


def _adam_mu(opt_state):
    return next(s for s in opt_state if hasattr(s, "mu")).mu


class _JitInit:
    """A flax module whose init runs under jax.jit: the JAX init_state
    initializes each network op by op otherwise, several times slower on
    the CPU for the one state the module needs (the same draws either
    way)."""

    def __init__(self, module):
        self.module = module

    def init(self, rngs, x, *static, **kw):
        return jax.jit(lambda r, x: self.module.init(r, x, *static, **kw))(rngs, x)


@pytest.fixture(scope="module")
def jax_run():
    jcfg, tcfg = configs()
    trainer = jtrainer.TokenizerTrainer(jcfg, JaxLossConfig(**LOSS), JaxTrainConfig(**TRAIN))
    nets = trainer.net, trainer.image_disc, trainer.video_disc
    trainer.net, trainer.image_disc, trainer.video_disc = (_JitInit(m) for m in nets)
    try:
        state = trainer.init_state(seed=0, image_size=32, frames=5)
    finally:
        trainer.net, trainer.image_disc, trainer.video_disc = nets
    buffers = to_numpy_tree(state.buffers)
    buffers["codebook"]["initialized"] = np.asarray(1, np.int32)
    state = state.replace(buffers=jax.tree_util.tree_map(jnp.asarray, buffers))
    video = (np.random.RandomState(0).randn(2, 5, 32, 32, 3) * 0.2).astype(np.float32)
    tree = {k: to_numpy_tree(getattr(state, k)) for k in
            ("params_g", "buffers", "params_d", "batch_stats_d", "lpips_params")}
    tree["step"] = int(state.step)
    new_state, metrics = jax.jit(trainer.train_step)(state, jnp.asarray(video))
    # the codebook after the generator pass alone: the JAX net's training
    # forward, which is all an ema_advances_per_step=1 step advances it by
    _, mutated = jax.jit(lambda p, b, v: trainer.net.apply(
        {"params": p, "buffers": b}, v, False, training=True,
        rngs={"codebook": jax.random.PRNGKey(1), "gaussian": jax.random.PRNGKey(2)},
        mutable=["buffers"]))(state.params_g, state.buffers, jnp.asarray(video))
    return dict(cfg=tcfg, tree=tree, video=video,
                metrics={k: float(v) for k, v in metrics.items()},
                new=to_numpy_tree({"buffers": new_state.buffers,
                                   "batch_stats_d": new_state.batch_stats_d,
                                   "mu_g": _adam_mu(new_state.opt_g),
                                   "mu_d": _adam_mu(new_state.opt_d)}),
                ema1_buffers=to_numpy_tree(mutated["buffers"]))


def _port_step(jax_run, **train):
    trainer = ttrainer.TokenizerTrainer(jax_run["cfg"], LossConfig(**LOSS),
                                        TrainConfig(**{**TRAIN, **train}), device="cpu")
    state = trainer.init_state(0)
    load_train_state_from_jax(jax_run["tree"], state)
    state, metrics = trainer.train_step(state, torch.from_numpy(jax_run["video"]))
    return state, metrics


@pytest.fixture(scope="module")
def port_run(jax_run):
    return _port_step(jax_run)


def test_metrics_match(jax_run, port_run):
    _, metrics = port_run
    for key, want in jax_run["metrics"].items():
        got = float(metrics[key])
        assert abs(got - want) <= 1e-5 * abs(want), (key, got, want)


def _before_batchnorm(module):
    """Biases of the convs a BatchNorm follows: their gradient is zero in
    exact arithmetic (the norm takes the batch mean out), so both sides
    hold rounding noise there."""
    return {f"{name[:-len('_norm')]}_conv.bias" for name, m in module.named_children()
            if isinstance(getattr(m, "norm", None), BatchNorm)}


def _assert_grads(port_mu, module, jax_mu, fill):
    """Adam's first moment of both, mapped onto the port's names; g = mu / (1 - b1).
    Each gradient within 1e-4 of its norm; the exactly-zero ones hold f32
    rounding noise of a sum over every position of the layer (eps 1.2e-7
    times the root of thousands of terms): within 1e-5 of the module's
    whole gradient norm on both sides."""
    want = state_dict_from_jax({"params": jax_mu, **fill}, module)
    names = [n for n, _ in module.named_parameters()]
    assert len(names) == len(port_mu)
    total = float(torch.stack([want[n].double().norm() for n in names]).norm())
    zero = _before_batchnorm(module)
    for name, got in zip(names, port_mu):
        w = want[name].double()
        if name in zero:
            assert max(float(got.norm()), float(w.norm())) <= 1e-5 * total, name
            continue
        err = float((got.double() - w).norm())
        assert err <= 1e-4 * max(float(w.norm()), 1e-12), (name, err, float(w.norm()))


def test_generator_gradients_match(jax_run, port_run):
    state, _ = port_run
    _assert_grads(state.opt_g.mu, state.net, jax_run["new"]["mu_g"],
                  {"buffers": jax_run["tree"]["buffers"]})


def test_discriminator_gradients_match(jax_run, port_run):
    state, _ = port_run
    n_image = len(list(state.image_disc.parameters()))
    for which, mus in (("image", state.opt_d.mu[:n_image]), ("video", state.opt_d.mu[n_image:])):
        _assert_grads(mus, getattr(state, f"{which}_disc"), jax_run["new"]["mu_d"][which],
                      {"batch_stats": jax_run["tree"]["batch_stats_d"][which]})


def _assert_codebook(codebook, want):
    for name in CODEBOOK:
        got, w = getattr(codebook, name).numpy(), want[name]
        assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), name
    assert int(codebook.initialized) == 1 and int(codebook.call_cnt) == int(want["call_cnt"])


def test_codebook_after_the_step_ema2(jax_run, port_run):
    state, _ = port_run
    _assert_codebook(state.net.codebook, jax_run["new"]["buffers"]["codebook"])
    assert int(state.net.codebook.call_cnt) == 2


def test_codebook_after_the_step_ema1(jax_run):
    state, _ = _port_step(jax_run, ema_advances_per_step=1)
    _assert_codebook(state.net.codebook, jax_run["ema1_buffers"]["codebook"])
    assert int(state.net.codebook.call_cnt) == 1


def test_batch_stats_after_the_step(jax_run, port_run):
    state, _ = port_run
    for which, stats in jax_run["new"]["batch_stats_d"].items():
        disc = getattr(state, f"{which}_disc")
        for layer, sub in stats.items():
            norm = getattr(disc, layer).norm
            for stat in ("mean", "var"):
                got, w = getattr(norm, stat).numpy(), sub["norm"][stat]
                assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), (which, layer, stat)


def test_freeze_trans_zeroes_the_jax_subtrees(jax_run, port_run):
    """The port's `*_transformer` name rule picks the parameters the JAX
    trainer zeroes."""
    state, _ = port_run
    ones = jax.tree_util.tree_map(np.ones_like, jax_run["tree"]["params_g"])
    zeroed = to_numpy_tree(jtrainer._zero_transformer_grads(ones))
    mapped = state_dict_from_jax({"params": zeroed, "buffers": jax_run["tree"]["buffers"]},
                                 state.net)
    for name, _ in state.net.named_parameters():
        assert ttrainer._transformer_param(name) == (float(mapped[name].max()) == 0.0), name
