"""The port's Gaussian diffusion, timestep samplers and training step
against the JAX package's, on the CPU.

Float64 numpy: the named schedules, space_timesteps, every coefficient
table and timestep_map equal. f32: p_mean_variance for the four variance
types (and the three mean types), given the same model output, and
training_losses for MSE, RESCALED_MSE, KL, RESCALED_KL and a fixed
variance, given the same noise, within 1e-5 of each term's largest
magnitude; q_sample and prior_bpd too. With tests/test_dit_latte.py's
small DiT (every weight random) as the model: the learned-sigma loss's
gradients against jax.grad within 1e-4 of each gradient's norm, the vb
term giving the mean half of the output no gradient on either side; a
DDPM and a DDIM (eta 0) loop over 8 respaced steps handed the draws the
JAX loop makes within 1e-4; one training step against JAX's (training
losses, jax.value_and_grad, optax.adamw and the EMA) with the loss within
1e-5, the gradients (read from Adam's first moment) within 1e-4 of their
norm, and the parameters and EMA after the step within 1e-5 whole-tensor
(the key bias, whose gradient is 0 in exact arithmetic, within one
learning rate of where it was).
The schedule samplers draw the JAX package's timesteps and weights from one
RandomState seed."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnitokenizer_tpu import diffusion as jd
from omnitokenizer_tpu.diffusion import timestep_sampler as jts
from omnitokenizer_tpu.models import dit as jdit
from omnitokenizer_tpu.training import diffusion_loop as jloop
from omnitokenizer_tpu_torch import convert
from omnitokenizer_tpu_torch import diffusion as td
from omnitokenizer_tpu_torch.diffusion import timestep_sampler as tts
from omnitokenizer_tpu_torch.models import dit as tdit
from omnitokenizer_tpu_torch.training import diffusion_loop as tloop
from omnitokenizer_tpu_torch.training.trainer import OptaxAdam

from torch_port_util import DIT_SMALL, random_diffusion_params

torch.set_num_threads(1)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale > 0 else 1.0))


def cf(x):  # channels-last numpy -> channels-first tensor
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def cl(x):  # channels-first tensor -> channels-last numpy
    return np.moveaxis(x.detach().numpy(), 1, -1)


# -- schedules and tables (float64) ---------------------------------------------------
@pytest.mark.parametrize("name,steps", [("linear", 1000), ("linear", 40),
                                        ("squaredcos_cap_v2", 100)])
def test_schedules_and_tables_equal(name, steps):
    betas = td.get_named_beta_schedule(name, steps)
    np.testing.assert_array_equal(betas, jd.get_named_beta_schedule(name, steps))
    for spacing in (None, {0, 3, 7, steps - 1}):
        ours = td.GaussianDiffusion(betas=betas, use_timesteps=spacing)
        theirs = jd.GaussianDiffusion(betas=betas, use_timesteps=spacing)
        np.testing.assert_array_equal(ours.timestep_map, theirs.timestep_map)
        for col in td.gaussian._COLS:
            np.testing.assert_allclose(getattr(ours, col), getattr(theirs, col), rtol=1e-12,
                                       atol=0)


@pytest.mark.parametrize("spec", ["250", "ddim50", "10,15,20", [4, 2], "1000", "8"])
def test_space_timesteps_equal(spec):
    assert td.space_timesteps(1000, spec) == jd.space_timesteps(1000, spec)
    d, j = td.create_diffusion(spec), jd.create_diffusion(spec)
    np.testing.assert_array_equal(d.timestep_map, j.timestep_map)
    assert d.num_timesteps == j.num_timesteps
    t = np.arange(d.num_timesteps)
    np.testing.assert_array_equal(d.map_t(torch.from_numpy(t)).numpy(),
                                  np.asarray(j.map_t(jnp.asarray(t))))


# -- the process, given the same model output / noise -------------------------------
def pair(var, mean=jd.MeanType.EPSILON, loss=jd.LossType.MSE, spacing=(0, 5, 11, 20, 39)):
    betas = jd.get_named_beta_schedule("linear", 40)
    kw = dict(betas=betas, use_timesteps=set(spacing))
    j = jd.GaussianDiffusion(mean_type=mean, var_type=var, loss_type=loss, **kw)
    t = td.GaussianDiffusion(mean_type=td.MeanType(mean.value), var_type=td.VarType(var.value),
                             loss_type=td.LossType(loss.value), **kw)
    return j, t


ARR = np.random.RandomState(0)
X = ARR.randn(4, 3, 3, 2).astype(np.float32)
T = np.array([0, 1, 3, 4])


@pytest.mark.parametrize("mean", list(jd.MeanType))
@pytest.mark.parametrize("var", list(jd.VarType))
def test_p_mean_variance_matches_jax(var, mean):
    j, t = pair(var, mean)
    learned = var in (jd.VarType.LEARNED, jd.VarType.LEARNED_RANGE)
    out = np.random.RandomState(1).uniform(-1, 1, X.shape[:-1] + (4 if learned else 2,))
    out = out.astype(np.float32)
    want = j.p_mean_variance(None, jnp.asarray(X), jnp.asarray(T), clip_denoised=True,
                             model_output=jnp.asarray(out))
    got = t.p_mean_variance(None, cf(X), torch.from_numpy(T), clip_denoised=True,
                            model_output=cf(out))
    for key in ("mean", "variance", "log_variance", "pred_xstart"):
        assert rel(cl(got[key]), want[key]) <= 1e-5, key


def test_q_sample_and_prior_bpd_match_jax():
    j, t = pair(jd.VarType.LEARNED_RANGE)
    noise = np.random.RandomState(2).randn(*X.shape).astype(np.float32)
    assert rel(cl(t.q_sample(cf(X), torch.from_numpy(T), cf(noise))),
               j.q_sample(jnp.asarray(X), jnp.asarray(T), jnp.asarray(noise))) <= 1e-6
    assert rel(t.prior_bpd(cf(X)).numpy(), j.prior_bpd(jnp.asarray(X))) <= 1e-5


def jax_toy(x, t, **_):  # a model of x and the timestep, channels-last, 2C outputs
    a = jnp.tanh(0.7 * x + 0.001 * t[:, None, None, None])
    return jnp.concatenate([a, jnp.sin(1.3 * x)], axis=-1)


def torch_toy(x, t, **_):
    a = torch.tanh(0.7 * x + 0.001 * t[:, None, None, None])
    return torch.cat([a, torch.sin(1.3 * x)], dim=1)


@pytest.mark.parametrize("kw", [dict(), dict(rescale_learned_sigmas=True), dict(use_kl=True),
                                dict(learn_sigma=False), dict(predict_xstart=True),
                                dict(learn_sigma=False, sigma_small=True)],
                         ids=["mse", "rescaled_mse", "rescaled_kl", "fixed_large", "start_x",
                              "fixed_small"])
def test_training_losses_match_jax(kw):
    j, t = jd.create_diffusion("10", diffusion_steps=100, **kw), td.create_diffusion(
        "10", diffusion_steps=100, **kw)
    learned = kw.get("learn_sigma", True)
    jm = jax_toy if learned else (lambda x, tt: jax_toy(x, tt)[..., :2])
    tm = torch_toy if learned else (lambda x, tt: torch_toy(x, tt)[:, :2])
    noise = np.random.RandomState(3).randn(*X.shape).astype(np.float32)
    ts = np.array([0, 4, 9, 2])
    want = j.training_losses(jm, jnp.asarray(X), jnp.asarray(ts), None, noise=jnp.asarray(noise))
    got = t.training_losses(tm, cf(X), torch.from_numpy(ts), noise=cf(noise))
    assert set(got) == set(want)
    # START_X at t = 0: the decoder NLL differences two nearly equal f32
    # CDFs of a small variance, and the JAX package's own f32 value sits 2e-5
    # from the float64 one there (the port's 4.4e-6)
    tol = 5e-5 if kw == dict(predict_xstart=True) else 1e-5
    for key in want:
        assert rel(got[key].numpy(), want[key]) <= tol, key


def test_kl_loss_type_matches_jax():
    betas = jd.get_named_beta_schedule("linear", 40)
    j = jd.GaussianDiffusion(betas=betas, loss_type=jd.LossType.KL)
    t = td.GaussianDiffusion(betas=betas, loss_type=td.LossType.KL)
    noise = np.random.RandomState(4).randn(*X.shape).astype(np.float32)
    ts = np.array([0, 13, 39, 1])
    want = j.training_losses(jax_toy, jnp.asarray(X), jnp.asarray(ts), None,
                             noise=jnp.asarray(noise))
    got = t.training_losses(torch_toy, cf(X), torch.from_numpy(ts), noise=cf(noise))
    assert rel(got["loss"].numpy(), want["loss"]) <= 1e-5


# -- with the small DiT as the model --------------------------------------------------
@pytest.fixture(scope="module")
def dit():
    jcfg, tcfg = jdit.DiTConfig(**DIT_SMALL), tdit.DiTConfig(**DIT_SMALL)
    params = random_diffusion_params(jdit.DiT(jcfg), (jnp.zeros((2, 8, 8, 4)),
                                                      jnp.zeros((2,), jnp.int32),
                                                      jnp.zeros((2,), jnp.int32)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return jdit.DiT(jcfg), jparams, tcfg, params


def port_dit(dit):
    _, _, tcfg, params = dit
    model = tdit.DiT(tcfg)
    model.load_state_dict(convert.dit_state_dict_from_jax(params, tcfg.patch_size))
    return model


def grads_by_port_name(jax_tree, patch):
    return convert.dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree), patch)


def test_learned_sigma_gradients_match_jax(dit):
    jm, jparams, tcfg, _ = dit
    model = port_dit(dit)
    j, t = jd.create_diffusion(None), td.create_diffusion(None)
    rng = np.random.RandomState(5)
    x0 = (0.5 * rng.randn(2, 8, 8, 4)).astype(np.float32)
    noise = rng.randn(2, 8, 8, 4).astype(np.float32)
    ts, y = np.array([12, 930]), np.array([3, 8])

    def jloss(p):
        fn = lambda x, tt: jm.apply({"params": p}, x, tt, jnp.asarray(y))  # noqa: E731
        return jnp.mean(j.training_losses(fn, jnp.asarray(x0), jnp.asarray(ts), None,
                                          noise=jnp.asarray(noise))["loss"])

    want_loss, want = jax.value_and_grad(jloss)(jparams)
    terms = t.training_losses(lambda x, tt: model(x, tt, torch.from_numpy(y)), cf(x0),
                              torch.from_numpy(ts), noise=cf(noise))
    loss = terms["loss"].mean()
    loss.backward()
    assert rel(loss.item(), want_loss) <= 1e-5
    want = grads_by_port_name(want, tcfg.patch_size)
    for name, p in model.named_parameters():
        err = (p.grad - want[name]).norm() / want[name].norm()
        assert float(err) <= 1e-4, name

    # the vb term reaches the variance half of the output only, on both sides
    out = (0.3 * rng.randn(2, 8, 8, 8)).astype(np.float32)
    jgrad = jax.grad(lambda o: jnp.sum(j.training_losses(
        lambda *_: o, jnp.asarray(x0), jnp.asarray(ts), None, noise=jnp.asarray(noise))["vb"]))(
        jnp.asarray(out))
    o = cf(out).requires_grad_(True)
    t.training_losses(lambda *_: o, cf(x0), torch.from_numpy(ts),
                      noise=cf(noise))["vb"].sum().backward()
    assert float(o.grad[:, :4].abs().max()) == 0.0 and float(o.grad[:, 4:].abs().max()) > 0
    assert rel(cl(o.grad), jgrad) <= 1e-5


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_sampling_loops_match_jax(dit, sampler):
    """8 respaced steps of the 1000-step linear process, CFG-free, no
    clipping (the CLIs' settings), the JAX loop's own draws handed over."""
    jm, jparams, tcfg, _ = dit
    model = port_dit(dit).eval()
    spacing = "ddim8" if sampler == "ddim" else "8"
    j, t = jd.create_diffusion(spacing), td.create_diffusion(spacing)
    y = np.array([2, 7])
    shape = (2, 8, 8, 4)
    key = jax.random.PRNGKey(11)
    jfn = lambda x, tt: jm.apply({"params": jparams}, x, tt, jnp.asarray(y))  # noqa: E731
    jloop_fn = j.ddim_sample_loop if sampler == "ddim" else j.p_sample_loop
    want = jloop_fn(jfn, shape, key, clip_denoised=False)
    # the draws of JAX's _scan_loop: the initial noise, then one a step
    k, nkey = jax.random.split(key)
    init = jax.random.normal(nkey, shape, jnp.float32)
    steps = [jax.random.normal(kk, shape, jnp.float32) for kk in jax.random.split(k, 8)]
    tloop_fn = t.ddim_sample_loop if sampler == "ddim" else t.p_sample_loop
    with torch.no_grad():
        got = tloop_fn(lambda x, tt: model(x, tt, torch.from_numpy(y)), (2, 4, 8, 8),
                       noise=cf(init), step_noise=[cf(s) for s in steps], clip_denoised=False)
    assert np.isfinite(np.asarray(want)).all()
    assert rel(cl(got), want) <= 1e-4


@pytest.mark.parametrize("wd,clip", [(0.0, None), (0.05, 1e-3)], ids=["adamw", "wd-clip"])
def test_train_step_matches_jax(dit, wd, clip):
    jm, jparams, tcfg, _ = dit
    model = port_dit(dit)
    j, t = jd.create_diffusion(None), td.create_diffusion(None)
    rng = np.random.RandomState(6)
    x0 = (0.5 * rng.randn(3, 8, 8, 4)).astype(np.float32)
    y = np.array([1, 4, 9])
    ts, weights = jts.UniformSampler(1000).sample(3, rng)
    key = jax.random.PRNGKey(7)
    noise = jax.random.normal(jax.random.split(key)[0], x0.shape, jnp.float32)

    parts = ([optax.clip_by_global_norm(clip)] if clip else []) + [
        optax.adamw(1e-4, weight_decay=wd)]
    tx = optax.chain(*parts)
    jstate = jloop.DiffusionTrainState(jparams, jparams, tx.init(jparams), jnp.int32(0))
    jstep = jloop.make_diffusion_train_step(
        lambda p, x_t, tt, rng_, y=None: jm.apply({"params": p}, x_t, tt, y), j, tx)
    jnew, jloss, jaux = jstep(jstate, jnp.asarray(x0), jnp.asarray(ts), jnp.asarray(weights),
                              key, {"y": jnp.asarray(y)})

    opt = OptaxAdam(lambda _: 1e-4, clip, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
    state = tloop.init_diffusion_state(model, opt)
    step = tloop.make_diffusion_train_step(lambda m, x_t, tt, gen, y=None: m(x_t, tt, y), t, opt)
    state, loss, aux = step(state, cf(x0), torch.from_numpy(ts), torch.from_numpy(weights),
                            None, {"y": torch.from_numpy(y)}, noise=cf(noise))
    assert state.step == 1
    assert rel(loss.item(), jloss) <= 1e-5
    assert rel(aux["grad_norm"].item(), jaux["grad_norm"]) <= 1e-4

    def adam_mu(s):
        if hasattr(s, "mu"):
            return s.mu
        return next((m for m in map(adam_mu, s) if m is not None), None) if isinstance(
            s, tuple) else None

    mu = grads_by_port_name(adam_mu(jnew.opt_state), tcfg.patch_size)
    names = [n for n, _ in model.named_parameters()]
    for name, got in zip(names, state.opt.mu):
        assert float((got - mu[name]).norm() / mu[name].norm()) <= 1e-4, name
    # The key bias (the middle third of attn.qkv.bias) has a zero gradient in
    # exact arithmetic: a shift of every key by q.b leaves the softmax as it
    # is. Adam's first step normalizes each side's rounding noise there to
    # about +-lr, so that slice is held to |update| <= lr on both sides, and
    # the rest of every tensor to 1e-5.
    D = tcfg.hidden_size
    before = grads_by_port_name(jparams, tcfg.patch_size)
    for which, theirs in (("model", jnew.params), ("ema", jnew.ema_params)):
        want = grads_by_port_name(theirs, tcfg.patch_size)
        ours = dict(getattr(state, which).named_parameters())
        for name in names:
            a, b = ours[name].detach(), want[name]
            if name.endswith("attn.qkv.bias"):
                for moved in (a, b):
                    assert float((moved[D:2 * D] - before[name][D:2 * D]).abs().max()) <= 1.01e-4
                a, b = torch.cat([a[:D], a[2 * D:]]), torch.cat([b[:D], b[2 * D:]])
            assert float((a - b).norm() / b.norm()) <= 1e-5, (which, name)


def test_train_state_round_trip(dit, tmp_path):
    model = port_dit(dit)
    opt = OptaxAdam(lambda _: 1e-4, None, b1=0.9, b2=0.999, weight_decay=0.0)
    state = tloop.init_diffusion_state(model, opt)
    step = tloop.make_diffusion_train_step(lambda m, x_t, tt, gen, y=None: m(x_t, tt, y),
                                           td.create_diffusion(None), opt)
    x0, ts = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0)), torch.tensor([5, 6])
    state, _, _ = step(state, x0, ts, torch.ones(2), torch.Generator().manual_seed(1),
                       {"y": torch.tensor([1, 2])})
    path = str(tmp_path / "state_000000001.pt")
    tloop.save_diffusion_state(path, state)
    other = tloop.init_diffusion_state(port_dit(dit), opt)
    tloop.load_diffusion_state(path, other)
    assert other.step == 1 and other.opt.count == 1
    for a, b in zip(state.ema_params() + state.params() + state.opt.nu,
                    other.ema_params() + other.params() + other.opt.nu):
        assert torch.equal(a, b)


# -- timestep samplers ------------------------------------------------------------------
def test_schedule_samplers_draw_like_jax():
    for name in ("uniform", "loss-second-moment"):
        ours, theirs = (tts.create_named_schedule_sampler(name, 20),
                        jts.create_named_schedule_sampler(name, 20))
        r1, r2 = np.random.RandomState(9), np.random.RandomState(9)
        for _ in range(30):  # past the resampler's warm-up
            a, b = ours.sample(16, r1), theirs.sample(16, r2)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            losses = np.abs(np.sin(a[0] * 0.37)) + 0.1
            ours.update_with_all_losses(a[0], losses)
            theirs.update_with_all_losses(b[0], losses)
        np.testing.assert_array_equal(ours.weights(), theirs.weights())
    with pytest.raises(NotImplementedError):
        tts.create_named_schedule_sampler("nope", 10)
