"""VAE training (the recipe's stage 3, scripts/recons/train.sh): one GAN step
of the port's TokenizerTrainer with use_vae=True against the JAX package's
TokenizerTrainer.train_step, in f32 on the CPU at the SMALL size, from the
same state and clips, and the entry points around it.

The JAX trainer's init_state reads a `buffers` collection that a VAE does
not have (it builds no codebook): the test wraps the JAX net's init to add
a placeholder collection, `{"pad": zeros(1)}`, which the VAE's forward
never reads. No file of the JAX package changes. The JAX step samples the
posterior with `jax.random.normal` on the "gaussian" key of its 10-way
split; the test draws the same numbers through the JAX net's own
make_rng and hands them to the port's step (`posterior_noise`).

The KL weight is 1e-3, above the recipe's 1e-6, so that the KL term's
gradient shows at the gradient bar; the draws two PRNGs cannot share are
off as in tests/test_torch_trainer.py, whose bars hold here: every metric
within 1e-5 relative, to the larger of its value and 0.1 (aeloss, a mean
of random logits of either sign, sits at 0.019 while the discriminator
losses of the same logits sit near 1: 4e-7 apart in f32, 2.1e-5 of its
value); each G and D gradient, read from Adam's first moment, within
1e-4 of its norm; the discriminators' BatchNorm statistics within 1e-5.

Also: the VAE case of load_pretrained_into_state against the JAX
package's (a VQ stage's checkpoint seeds a VAE whose pre-VQ head keeps
its init values), and from a port .pt and a JAX msgpack; the sdpa route
of a recorded inference-route call (kernel_fwd_ref_bwd under the attn
group, the plain math with OMNITOK_TRAIN_KERNEL_FWD=0, equal gradients);
the trainer's refusals; and vqgan_train --use_vae for two steps on the
CPU, resumed to three, equal to an unbroken three-step run."""

import glob
import json
import os

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
from omnitokenizer_tpu_torch.ops import attention as tattn
from omnitokenizer_tpu_torch.training import trainer as ttrainer

from test_torch_trainer import LOSS, TRAIN, _JitInit, _adam_mu, _assert_grads
from torch_port_util import configs, reference_state_dict, to_numpy_tree, write_lightning_ckpt

torch.set_num_threads(1)

VAE = dict(use_vae=True, kl_weight=1e-3)


class _VaeInit(_JitInit):
    """The jitted init, plus the placeholder `buffers` collection that the
    JAX init_state reads and a VAE does not have."""

    def init(self, rngs, x, *static, **kw):
        return {**super().init(rngs, x, *static, **kw), "buffers": {"pad": jnp.zeros(1)}}


def _jax_trainer():
    jcfg, tcfg = configs(**VAE)
    return jtrainer.TokenizerTrainer(jcfg, JaxLossConfig(**LOSS), JaxTrainConfig(**TRAIN)), tcfg


def _wrapped(trainer, fn):
    """fn() with the JAX trainer's inits jitted and the net's padded."""
    nets = trainer.net, trainer.image_disc, trainer.video_disc
    trainer.net, trainer.image_disc, trainer.video_disc = (
        _VaeInit(nets[0]), _JitInit(nets[1]), _JitInit(nets[2]))
    try:
        return fn()
    finally:
        trainer.net, trainer.image_disc, trainer.video_disc = nets


@pytest.fixture(scope="module")
def jax_run():
    trainer, tcfg = _jax_trainer()
    state = _wrapped(trainer, lambda: trainer.init_state(seed=0, image_size=32, frames=5))
    video = (np.random.RandomState(0).randn(2, 5, 32, 32, 3) * 0.2).astype(np.float32)
    tree = {k: to_numpy_tree(getattr(state, k)) for k in
            ("params_g", "params_d", "batch_stats_d", "lpips_params")}
    tree["buffers"] = {}  # the placeholder has no port tensor
    tree["step"] = int(state.step)
    # the step's posterior noise: the net's make_rng("gaussian") on the 9th
    # key of the step's split, as the step's forward draws it
    k_gauss = jax.random.split(state.rng, 10)[8]
    shape = (2, 3, 4, 4, tcfg.codebook_dim)
    noise = trainer.net.apply(
        {"params": state.params_g, "buffers": state.buffers}, rngs={"gaussian": k_gauss},
        method=lambda m: jax.random.normal(m.make_rng("gaussian"), shape, jnp.float32))
    # op by op: XLA's compile of the whole jitted VAE step on the CPU reads
    # the first frame's to-pixels gradient 5.3e-4 away from this step run op
    # by op and from jax.jit(jax.grad) of the same losses alone (5e-6 from
    # both); the VQ step's jit agrees with them (tests/test_torch_trainer.py)
    new_state, metrics = trainer.train_step(state, jnp.asarray(video))
    return dict(cfg=tcfg, tree=tree, video=video, noise=np.asarray(noise),
                metrics={k: float(v) for k, v in metrics.items()},
                new=to_numpy_tree({"batch_stats_d": new_state.batch_stats_d,
                                   "mu_g": _adam_mu(new_state.opt_g),
                                   "mu_d": _adam_mu(new_state.opt_d)}))


@pytest.fixture(scope="module")
def port_run(jax_run):
    trainer = ttrainer.TokenizerTrainer(jax_run["cfg"], LossConfig(**LOSS), TrainConfig(**TRAIN),
                                        device="cpu")
    state = trainer.init_state(0)
    load_train_state_from_jax(jax_run["tree"], state)
    return trainer.train_step(state, torch.from_numpy(jax_run["video"]),
                              posterior_noise=torch.from_numpy(jax_run["noise"]))


def test_vae_metrics_match(jax_run, port_run):
    _, metrics = port_run
    assert "perplexity" not in jax_run["metrics"] and "avg_usage" not in jax_run["metrics"]
    assert set(jax_run["metrics"]) <= set(metrics)
    assert "perplexity" not in metrics and "avg_usage" not in metrics
    for key, want in jax_run["metrics"].items():
        got = float(metrics[key])
        assert abs(got - want) <= 1e-5 * max(abs(want), 0.1), (key, got, want)


def test_vae_generator_gradients_match(jax_run, port_run):
    state, _ = port_run
    assert state.net.codebook is None and "codebook" not in str(list(state.state_dict()["net"]))
    _assert_grads(state.opt_g.mu, state.net, jax_run["new"]["mu_g"], {})


def test_vae_discriminator_gradients_match(jax_run, port_run):
    state, _ = port_run
    n_image = len(list(state.image_disc.parameters()))
    for which, mus in (("image", state.opt_d.mu[:n_image]), ("video", state.opt_d.mu[n_image:])):
        _assert_grads(mus, getattr(state, f"{which}_disc"), jax_run["new"]["mu_d"][which],
                      {"batch_stats": jax_run["tree"]["batch_stats_d"][which]})


def test_vae_batch_stats_after_the_step(jax_run, port_run):
    state, _ = port_run
    for which, stats in jax_run["new"]["batch_stats_d"].items():
        disc = getattr(state, f"{which}_disc")
        for layer, sub in stats.items():
            norm = getattr(disc, layer).norm
            for stat in ("mean", "var"):
                got, w = getattr(norm, stat).numpy(), sub["norm"][stat]
                assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), (which, layer, stat)


def test_vae_step_draws_its_noise_from_the_gaussian_stream(jax_run):
    """Without posterior_noise the step samples from its "gaussian"
    stream: the same draw for the same (seed, step), and a step with that
    draw handed over equals it."""
    trainer = ttrainer.TokenizerTrainer(jax_run["cfg"], LossConfig(**LOSS), TrainConfig(**TRAIN),
                                        device="cpu")
    video = torch.from_numpy(jax_run["video"])
    state = trainer.init_state(0)
    noise = torch.randn(jax_run["noise"].shape, generator=trainer.generators(state)("gaussian"))
    runs = []
    for given in (None, noise):
        st = trainer.init_state(0)
        load_train_state_from_jax(jax_run["tree"], st)
        runs.append(trainer.train_step(st, video, posterior_noise=given)[1])
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


def test_trainer_refusals(jax_run):
    """A VAE trains; the cnn patch embed still does not (its BatchNorm
    reads running statistics only), as the JAX package cannot train it."""
    cfg = jax_run["cfg"]
    ttrainer.TokenizerTrainer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="cnn patch embed"):
        ttrainer.TokenizerTrainer(cfg.replace(use_vae=False, patch_embed="cnn"), device="cpu")


# -- sdpa on a recorded inference-route call ---------------------------------------------------
def _vae_net(cfg):
    from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet, init_weights

    net = OmniTokenizerNet(cfg)
    init_weights(net, torch.Generator().manual_seed(0))
    return net


@pytest.mark.parametrize("ops,routed", [("attn", 3), ("attn,ff,flat", 3), ("0", 0),
                                        ("ff,flat", 0)])
def test_sdpa_recorded_call_route(monkeypatch, jax_run, ops, routed):
    """A VAE forward with training=False under autograd: each spatial 't'
    block's sdpa (N = 16 tokens, inside the mha gate; the temporal calls at
    N = 3 are below it) goes through kernel_fwd_ref_bwd where the attn
    group is on, and takes the plain math where it is off; the gradients
    are the plain math's either way, and a call under no_grad never takes
    the Function."""
    calls = []
    real = tattn.kernel_fwd_ref_bwd

    def spy(kern, ref, *args):
        calls.append((kern.func.__name__, ref.func.__name__, tuple(a.shape for a in args)))
        return real(kern, ref, *args)

    monkeypatch.setattr(tattn, "kernel_fwd_ref_bwd", spy)
    net = _vae_net(jax_run["cfg"])
    video = torch.from_numpy(jax_run["video"])
    noise = torch.from_numpy(jax_run["noise"])

    def grads(env):
        monkeypatch.setenv("OMNITOK_TRAIN_KERNEL_FWD", env)
        net.zero_grad()
        recon, aux = net(video, False, training=False, noise=noise)
        ((recon - video).abs().mean() + aux["commitment_loss"]).backward()
        return [p.grad.clone() for p in net.parameters()]

    want = grads("0")
    assert not calls
    got = grads(ops)
    assert len(calls) == routed
    assert all(c[:2] == ("_mha_kernel", "mha_plain") and c[2][0][-2:] == (16, 32)
               for c in calls)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    calls.clear()
    monkeypatch.setenv("OMNITOK_TRAIN_KERNEL_FWD", ops)
    with torch.no_grad():
        net(video, False, training=False, noise=noise)
    assert not calls


# -- the pretrained load (the recipe's stage 3 seeds a VAE from the VQ stage) ------------------
def _disc_keys(state):
    from test_torch_eval import _disc_reference_keys

    rng = np.random.RandomState(7)
    sd = _disc_reference_keys(state.image_disc, "image_discriminator", LOSS["disc_layers"],
                              False, rng)
    sd.update(_disc_reference_keys(state.video_disc, "video_discriminator", LOSS["disc_layers"],
                                   True, rng))
    return sd


@pytest.fixture(scope="module")
def stage2(tmp_path_factory, jax_run):
    """A VQ stage's Lightning checkpoint (codebook, a codebook_dim pre-VQ
    head, both discriminators), and the port's VAE trainer."""
    from omnitokenizer_tpu.config import TokenizerConfig as JaxConfig
    from torch_port_util import SMALL

    trainer = ttrainer.TokenizerTrainer(jax_run["cfg"], LossConfig(**LOSS), TrainConfig(**TRAIN),
                                        device="cpu")
    sd = reference_state_dict(JaxConfig(**SMALL), seed=8)
    assert sd["pre_vq_conv.1.weight"].shape[0] == jax_run["cfg"].codebook_dim
    sd.update(_disc_keys(trainer.init_state(0)))
    path = tmp_path_factory.mktemp("stage2") / "stage2.ckpt"
    write_lightning_ckpt(path, sd)
    return trainer, str(path)


def test_vae_load_pretrained_matches_jax(stage2):
    from omnitokenizer_tpu.utils.inflate import load_pretrained_into_state as jax_load
    from omnitokenizer_tpu_torch.utils.inflate import load_pretrained_into_state

    trainer, path = stage2
    jtr, _ = _jax_trainer()
    jstate = _wrapped(jtr, lambda: jax_load(jtr, path, init_vgen="keep", init_vdis="keep",
                                            seed=0))
    state = load_pretrained_into_state(trainer, path, init_vgen="keep", init_vdis="keep", seed=0)
    fresh = trainer.init_state(seed=0)

    want = state_dict_from_jax({"params": to_numpy_tree(jstate.params_g)}, state.net)
    head = {"pre_vq_conv.weight", "pre_vq_conv.bias"}
    init = fresh.net.state_dict()
    for k, v in state.net.state_dict().items():
        # the VAE's head keeps the init values (of each package's own init)
        assert torch.equal(v, init[k] if k in head else want[k]), k
    for which in ("image", "video"):
        disc = getattr(state, f"{which}_disc")
        want = state_dict_from_jax({"params": to_numpy_tree(jstate.params_d[which]),
                                    "batch_stats": to_numpy_tree(jstate.batch_stats_d[which])},
                                   disc)
        for k, v in disc.state_dict().items():
            assert torch.equal(v, want[k]), f"{which}: {k}"


def test_vae_load_pretrained_from_pt_and_msgpack(stage2, tmp_path):
    """The port's own .pt and a JAX package msgpack (a VQ tokenizer's
    variables) seed the VAE as the .ckpt does; they refuse inflation."""
    from omnitokenizer_tpu_torch.convert import state_dict_to_jax
    from omnitokenizer_tpu_torch.training.loop import save_state
    from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer
    from omnitokenizer_tpu_torch.utils.inflate import load_pretrained_into_state
    from omnitokenizer_tpu_torch.utils.msgpack_io import write_msgpack

    trainer, path = stage2
    vq_trainer = TokenizerTrainer(trainer.cfg.replace(use_vae=False), LossConfig(**LOSS),
                                  TrainConfig(**TRAIN), device="cpu")
    vq = load_pretrained_into_state(vq_trainer, path, init_vgen="keep", init_vdis="keep", seed=0)
    pt, mp = str(tmp_path / "step_00000001.pt"), str(tmp_path / "vq.msgpack")
    save_state(pt, vq)
    write_msgpack(mp, state_dict_to_jax(vq.net))

    want = load_pretrained_into_state(trainer, path, init_vgen="keep", init_vdis="keep", seed=0)
    for src, discs in ((pt, True), (mp, False)):
        got = load_pretrained_into_state(trainer, src, init_vgen="keep", init_vdis="keep", seed=0)
        for name in ("net",) + (("image_disc", "video_disc") if discs else ()):
            a, b = getattr(got, name).state_dict(), getattr(want, name).state_dict()
            assert all(torch.equal(a[k], b[k]) for k in b), (src, name)
        with pytest.raises(ValueError, match="inflates a reference-named"):
            load_pretrained_into_state(trainer, src, init_vgen="average", seed=0)


# -- vqgan_train --use_vae -----------------------------------------------------------------------
def _train_flags(data, run):
    from test_torch_cli import TINY

    return TINY + ["--use_vae", "--kl_weight", "1e-6", "--data_path", str(data),
                   "--train_datalist", str(data / "imagenet_tiny.txt"),
                   "--default_root_dir", run, "--warmup_steps", "1", "--lr", "1e-4",
                   "--device", "cpu"]


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("vae_data")
    rng = np.random.RandomState(0)
    for i in range(16):
        Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(root / f"img_{i:03d}.png")
    (root / "imagenet_tiny.txt").write_text("".join(f"img_{i:03d}.png\t0\n" for i in range(16)))
    return root


def _state_equal(a, b):
    a, b = a.state_dict(), b.state_dict()
    for name in ttrainer.TokenizerTrainState.MODULES:
        assert all(torch.equal(a[name][k], b[name][k]) for k in b[name]), name
    for opt in ("opt_g", "opt_d"):
        assert all(torch.equal(x, y) for x, y in zip(a[opt]["mu"], b[opt]["mu"])), opt
        assert all(torch.equal(x, y) for x, y in zip(a[opt]["nu"], b[opt]["nu"])), opt
    assert a["step"] == b["step"]


def _tiny_vae_trainer(pngs, run, extra=()):
    from omnitokenizer_tpu_torch.cli import args as PA
    from omnitokenizer_tpu_torch.cli import vqgan_train

    args = PA.normalize_precision(vqgan_train.build_parser().parse_args(
        _train_flags(pngs, run) + list(extra)))
    return ttrainer.TokenizerTrainer(PA.tokenizer_config_from(args), PA.loss_config_from(args),
                                     PA.train_config_from(args), device="cpu"), args


def test_vae_train_tokenizer_resumes_like_an_unbroken_run(pngs, tmp_path):
    """train_tokenizer on a VAE trainer: 2 steps, then a resume to 3 on the
    batches the first run has not seen, equal to an unbroken 3-step run."""
    from omnitokenizer_tpu_torch.training.loop import train_tokenizer

    def batches():
        g = torch.Generator().manual_seed(0)
        while True:
            yield {"video": torch.rand(4, 16, 16, 3, generator=g) - 0.5}

    trainer, _ = _tiny_vae_trainer(pngs, str(tmp_path / "x"))
    broken, whole = str(tmp_path / "broken"), str(tmp_path / "whole")
    train_tokenizer(trainer, batches(), broken, max_steps=2, img_every=1, log_every=1)
    it = batches()
    for _ in range(2):
        next(it)
    resumed = train_tokenizer(trainer, it, broken, max_steps=3, img_every=0)
    unbroken = train_tokenizer(trainer, batches(), whole, max_steps=3, img_every=0)
    assert resumed.step == 3 and resumed.net.codebook is None
    _state_equal(resumed, unbroken)
    with open(os.path.join(broken, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(r["commitment_loss"]) and "perplexity" not in r for r in rows)
    assert len(glob.glob(os.path.join(broken, "images", "train", "*.png"))) == 2


def test_vqgan_train_use_vae_two_steps_and_resume(pngs, tmp_path):
    """vqgan_train --use_vae: 2 steps, then an auto-resume to 3. The CLI's
    loader starts afresh on a resume (the JAX CLI's does too), so the
    resumed run equals the step-2 checkpoint taken one step on the
    loader's first batch."""
    from omnitokenizer_tpu_torch.cli import vqgan_train
    from omnitokenizer_tpu_torch.data.loader import VideoData
    from omnitokenizer_tpu_torch.training.loop import load_state

    run = str(tmp_path / "run")
    assert vqgan_train.main(_train_flags(pngs, run) + ["--max_steps", "2"]).step == 2
    ckpt = os.path.join(run, "checkpoints", "step_00000002.pt")
    saved = torch.load(ckpt)
    assert not any("codebook" in k for k in saved["net"])
    resumed = vqgan_train.main(_train_flags(pngs, run) + ["--max_steps", "3"])

    trainer, args = _tiny_vae_trainer(pngs, run, ["--max_steps", "3"])  # its lr schedule
    state = load_state(ckpt, trainer.init_state(seed=1))
    video = torch.as_tensor(next(iter(VideoData(args, train=True)))["video"])
    state, _ = trainer.train_step(state, video[:, None] if video.ndim == 4 else video)
    assert resumed.step == 3
    _state_equal(resumed, state)


def test_vqgan_train_use_vae_from_a_vq_stage(pngs, tmp_path):
    """--use_vae --pretrained <VQ stage .ckpt> --init_vgen keep --init_vdis
    keep (the recipe's stage 3, at a tiny size): the VAE starts from the
    checkpoint's weights but for its pre-VQ head."""
    from omnitokenizer_tpu_torch.cli import vqgan_train
    from test_torch_cli import TINY, _ckpt

    ckpt = _ckpt(tmp_path / "stage2.ckpt", TINY)
    state = vqgan_train.main(_train_flags(pngs, str(tmp_path / "run"))
                             + ["--pretrained", ckpt, "--init_vgen", "keep", "--init_vdis",
                                "keep", "--max_steps", "1"])
    assert state.step == 1 and state.net.codebook is None
