"""The trainer's optimizer chain and schedules against optax, given the
same gradients: the warmup-cosine schedules with the JAX trainer's clamps,
then clip_by_global_norm -> scale_by_adam(0.5, 0.9) -> the learning rate,
with and without optax.MultiSteps(k=2), over several steps, and the
diffusion trainer's optax.adamw (with and without a weight decay and
clipping). Updates within 1e-6 relative (of each tensor's largest update). The gates and
freeze_trans act on the port's whole step: a G-gated step advances Adam's
moments and leaves the parameters; the D gate is the D gate alone; frozen
transformer parameters stay while the others move."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from omnitokenizer_tpu.config import TrainConfig as JaxTrainConfig
from omnitokenizer_tpu.training import trainer as jtrainer
from omnitokenizer_tpu_torch.config import LossConfig, TokenizerConfig, TrainConfig
from omnitokenizer_tpu_torch.training import trainer as ttrainer

from torch_port_util import SMALL

torch.set_num_threads(1)

SCHEDULES = [
    dict(lr=1e-4, warmup_steps=10, max_steps=1000, warmup_lr_init=1e-5),
    dict(lr=5e-5, lr_min=1e-6, warmup_steps=3, max_steps=20, dis_warmup_steps=0),
    dict(lr=2e-4, warmup_steps=50, max_steps=30, dis_minlr_multiplier=False),  # warmup clamped
    dict(lr=1e-3, warmup_steps=0, max_steps=1, dis_lr_multiplier=0.5),  # horizon clamped
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedules_match_optax(kw):
    jtc, ttc = JaxTrainConfig(**kw), TrainConfig(**kw)
    for jsched, tsched in ((jtrainer._g_schedule(jtc), ttrainer.g_schedule(ttc)),
                           (jtrainer._d_schedule(jtc), ttrainer.d_schedule(ttc))):
        for count in list(range(0, 60)) + [999, 1000, 5000]:
            want = float(jsched(count))
            assert tsched(count) == pytest.approx(want, rel=1e-6, abs=1e-12), count


SHAPES = [(3, 4), (5,), (2, 3, 2)]


@pytest.mark.parametrize("clip", [None, 1.0, 0.05], ids=["no-clip", "clip-1", "clip-tight"])
@pytest.mark.parametrize("accum", [1, 2])
def test_chain_matches_optax(clip, accum):
    tc = TrainConfig(lr=1e-3, warmup_steps=3, max_steps=12, warmup_lr_init=1e-4)
    tx = jtrainer._make_opt(jtrainer._g_schedule(JaxTrainConfig(lr=1e-3, warmup_steps=3,
                                                                max_steps=12,
                                                                warmup_lr_init=1e-4)),
                            clip, accum)
    ours = ttrainer.OptaxAdam(ttrainer.g_schedule(tc), clip, accum)
    rng = np.random.RandomState(0)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jstate = tx.init([jnp.asarray(p) for p in params])
    update = jax.jit(tx.update)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = ours.init(tparams)
    for step in range(10):
        grads = [(rng.randn(*s) * (0.1 + step)).astype(np.float32) for s in SHAPES]
        jup, jstate = update([jnp.asarray(g) for g in grads], jstate)
        tup = ours.update([torch.from_numpy(g) for g in grads], tstate)
        if tup is None:  # a MultiSteps mini-step: optax emits zeros
            assert accum > 1 and all(float(jnp.abs(u).max()) == 0 for u in jup)
            continue
        for a, b in zip(tup, jup):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max(), step
    assert tstate.count == (10 // accum)


@pytest.mark.parametrize("wd,clip", [(0.0, None), (1e-4, None), (0.05, 0.5)],
                         ids=["wd0", "wd-default", "wd-clip"])
def test_adamw_matches_optax(wd, clip):
    """The diffusion trainer's chain: [clip_by_global_norm ->] optax.adamw(lr,
    b1 0.9, b2 0.999, eps 1e-8, weight_decay), over several steps with the
    parameters moving."""
    parts = ([optax.clip_by_global_norm(clip)] if clip else []) + [optax.adamw(1e-3, weight_decay=wd)]
    tx = optax.chain(*parts)
    ours = ttrainer.OptaxAdam(lambda _: 1e-3, clip, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
    rng = np.random.RandomState(1)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = ours.init(tparams)
    for step in range(8):
        grads = [(rng.randn(*s) * (0.1 + step)).astype(np.float32) for s in SHAPES]
        jup, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, jup)
        tup = ours.update([torch.from_numpy(g) for g in grads], tstate, tparams)
        torch._foreach_add_(tparams, tup)
        for a, b in zip(tup, jup):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max(), step
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="weight decay"):
        ttrainer.OptaxAdam(lambda _: 1e-3, None, weight_decay=0.1).update(
            [torch.zeros(2)], ours.init([torch.zeros(2)]))


def _small_trainer(**tc):
    cfg = TokenizerConfig(**SMALL)
    return ttrainer.TokenizerTrainer(
        cfg, LossConfig(perceptual_weight=0.0, image_gan_weight=1.0, video_gan_weight=1.0,
                        apply_noise=False, disc_layers=2, disc_channels=16),
        TrainConfig(warmup_lr_init=1e-4, **tc), device="cpu")


def _video():
    return torch.randn(2, 5, 32, 32, 3, generator=torch.Generator().manual_seed(3)) * 0.2


def _snapshot(params):
    return [p.detach().clone() for p in params]


def _moved(before, after):
    return [not torch.equal(a, b) for a, b in zip(before, after)]


def test_g_gate_advances_moments_and_keeps_parameters():
    trainer = _small_trainer(recloss_check_thres=0.0, disloss_check_thres=None)
    state = trainer.init_state(0)
    state.step = 100_001  # the gate looks at the loss only after step 100k
    g0, d0 = _snapshot(state.g_params()), _snapshot(state.d_params())
    state, m = trainer.train_step(state, _video())
    assert float(m["optim_gen"]) == 0.0 and float(m["optim_disc"]) == 1.0
    assert not any(_moved(g0, state.g_params()))
    assert state.opt_g.count == 1 and any(float(t.abs().max()) > 0 for t in state.opt_g.mu)
    assert all(_moved(d0, state.d_params()))  # the D step is its own


def test_d_gate_skips_only_the_discriminator():
    trainer = _small_trainer(disloss_check_thres=1e9)
    state = trainer.init_state(0)
    g0, d0 = _snapshot(state.g_params()), _snapshot(state.d_params())
    state, m = trainer.train_step(state, _video())
    assert float(m["optim_gen"]) == 1.0 and float(m["optim_disc"]) == 0.0
    assert not any(_moved(d0, state.d_params())) and state.opt_d.count == 1
    assert sum(_moved(g0, state.g_params())) > 0.9 * len(g0)


def test_freeze_trans_keeps_the_transformers():
    trainer = _small_trainer(freeze_trans=True, disloss_check_thres=None)
    state = trainer.init_state(0)
    names = [n for n, _ in state.net.named_parameters()]
    g0 = _snapshot(state.g_params())
    state, _ = trainer.train_step(state, _video())
    moved = dict(zip(names, _moved(g0, state.g_params())))
    frozen = [n for n in names if ttrainer._transformer_param(n)]
    assert frozen and not any(moved[n] for n in frozen)
    assert all(moved[n] for n in ("encoder.to_patch_emb_proj.weight", "pre_vq_conv.weight",
                                  "decoder.to_pixels.weight"))
