"""The port's training pieces against the JAX package's, in f32 on the CPU:
the loss configs, the GAN losses (and their f32 result on bf16 inputs),
DiffAugment given JAX's own draws, the 2D/3D discriminators (group and
batch norm, train and eval, the running statistics after two train-mode
calls), LPIPS with a random backbone, and the codebook's training half (the
EMA after one and two calls; the data-dependent init and the random restart
given JAX's candidate rows). Weights and buffers go through
convert.state_dict_from_jax; inputs come from a numpy seed. Tolerances:
1e-5 relative (losses, diffaug, discriminators, statistics), 2^-7 relative
(losses of bf16 inputs), 1e-5 (LPIPS), 1e-6 (codebook buffers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu import config as jax_config
from omnitokenizer_tpu.models import discriminator as jdisc
from omnitokenizer_tpu.models.lpips import LPIPS as JaxLPIPS
from omnitokenizer_tpu.ops import codebook as jcb
from omnitokenizer_tpu.ops import diffaug as jaug
from omnitokenizer_tpu.training import losses as jlosses
from omnitokenizer_tpu_torch import config as torch_config
from omnitokenizer_tpu_torch.convert import state_dict_from_jax
from omnitokenizer_tpu_torch.models import discriminator as tdisc
from omnitokenizer_tpu_torch.models.lpips import LPIPS, load_lpips_variables
from omnitokenizer_tpu_torch.ops import codebook as tcb
from omnitokenizer_tpu_torch.ops import diffaug as taug
from omnitokenizer_tpu_torch.training import losses as tlosses

from torch_port_util import to_numpy_tree, torch_f32

torch.set_num_threads(1)


def assert_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("name", ["LossConfig", "TrainConfig"])
def test_train_config_fields_and_defaults_match(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jax_config, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(torch_config, name))}
    assert tf == jf and list(tf) == list(jf)


@pytest.mark.parametrize("fn", ["hinge_d_loss", "vanilla_d_loss", "logits_laplace", "l1", "l2"])
def test_losses_match(fn):
    rng = np.random.RandomState(0)
    a, b = rng.randn(3, 7).astype(np.float32), rng.randn(3, 7).astype(np.float32)
    want = getattr(jlosses, fn)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tlosses, fn)(torch_f32(a), torch_f32(b))
    assert_rel(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("fn", ["hinge_d_loss", "vanilla_d_loss", "logits_laplace", "l1", "l2"])
def test_losses_of_bf16_inputs_are_f32(fn):
    """bf16 inputs give an f32 loss: the JAX function's bf16 scalar is it
    rounded, within two bf16 steps (2^-7 relative: the JAX logit losses
    round each term, then the mean; half a step each at most)."""
    rng = np.random.RandomState(1)
    a = (rng.randn(64, 33) * 0.25).astype(np.float32)
    b = (rng.randn(64, 33) * 0.25).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = getattr(jlosses, fn)(ja, jb)
    ta, tb = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16) for x in (ja, jb))
    got = getattr(tlosses, fn)(ta, tb)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 2 ** -7 * abs(float(got))
    if fn.endswith("_d_loss"):  # the logits are cast before any arithmetic
        assert torch.equal(got, getattr(tlosses, fn)(ta.float(), tb.float()))


def test_adopt_weight_matches():
    for step, thres, value in ((5, 10, 0.0), (10, 10, 0.0), (15, 10, 0.5), (0, 0, 0.3)):
        assert tlosses.adopt_weight(step, thres, value) == float(
            jlosses.adopt_weight(jnp.asarray(step), thres, value))


def jax_draws(key, B, H, W):
    """JAX's DiffAugment draws for the full policy, replayed key by key."""
    sx, sy, ch, cw = int(H * 0.125 + 0.5), int(W * 0.125 + 0.5), int(H * 0.2 + 0.5), int(W * 0.2 + 0.5)
    subs = []
    for _ in range(5):
        key, sub = jax.random.split(key)
        subs.append(sub)
    u = [jax.random.uniform(s, (B, 1, 1, 1)) for s in subs[:3]]
    (tkx, tky), (ckx, cky) = jax.random.split(subs[3]), jax.random.split(subs[4])
    d = dict(brightness=u[0] - 0.5, saturation=u[1] * 2.0, contrast=u[2] + 0.5,
             tx=jax.random.randint(tkx, (B, 1, 1), -sx, sx + 1),
             ty=jax.random.randint(tky, (B, 1, 1), -sy, sy + 1),
             ox=jax.random.randint(ckx, (B, 1, 1), 0, H + (1 - ch % 2)),
             oy=jax.random.randint(cky, (B, 1, 1), 0, W + (1 - cw % 2)))
    return {k: torch.from_numpy(np.array(v).reshape(B)) for k, v in d.items()}


@pytest.mark.parametrize("video", [False, True], ids=["frames", "clips"])
def test_diffaug_matches_given_jax_draws(video):
    rng = np.random.RandomState(1)
    shape = (2, 3, 16, 16, 3) if video else (4, 16, 16, 3)
    x = rng.randn(*shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    if video:
        want = jax.jit(jaug.diff_augment_video)(key, jnp.asarray(x))
        got = taug.apply_augment(torch_f32(x).reshape(6, 16, 16, 3), jax_draws(key, 6, 16, 16))
        got = got.reshape(shape)
    else:
        want = jax.jit(jaug.diff_augment)(key, jnp.asarray(x))
        got = taug.apply_augment(torch_f32(x), jax_draws(key, 4, 16, 16))
    assert_rel(got.numpy(), want, 1e-5)


def test_diffaug_draws_in_range():
    g = torch.Generator().manual_seed(0)
    d = taug.augment_draws(4000, 32, 32, g)
    assert -0.5 <= d["brightness"].min() and d["brightness"].max() < 0.5
    assert 0 <= d["saturation"].min() and d["saturation"].max() < 2
    assert 0.5 <= d["contrast"].min() and d["contrast"].max() < 1.5
    assert set(d["tx"].tolist()) == set(range(-4, 5))
    assert set(d["ox"].tolist()) == set(range(0, 33))  # cut of 6 (even): [0, H + 1)
    # a constant image keeps its value under the identity color draws, and
    # translation and cutout only zero pixels
    d = taug.augment_draws(3, 8, 8, torch.Generator().manual_seed(1))
    d.update(brightness=torch.zeros(3), saturation=torch.ones(3), contrast=torch.ones(3))
    y = taug.apply_augment(torch.ones(3, 8, 8, 3), d)
    assert set(y.unique().tolist()) == {0.0, 1.0}


DISC_CASES = [("2d", "group", 32), ("2d", "batch", 16), ("3d", "batch", 16)]


def _disc_pair(kind, norm, ndf, apply_noise=True):
    kw = dict(ndf=ndf, n_layers=2, norm_type=norm, apply_noise=apply_noise)
    if kind == "2d":
        jm, tm, shape = jdisc.NLayerDiscriminator(**kw), tdisc.NLayerDiscriminator(**kw), (2, 32, 32, 3)
    else:
        jm, tm, shape = jdisc.NLayerDiscriminator3D(**kw), tdisc.NLayerDiscriminator3D(**kw), (2, 5, 32, 32, 3)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    tree = to_numpy_tree(variables)
    # non-trivial norm and noise parameters and running statistics
    rng = np.random.RandomState(4)
    for path in ("params", "batch_stats"):
        for k, sub in tree.get(path, {}).items():
            if "norm" in k:
                for leaf, v in sub["norm"].items():
                    sub["norm"][leaf] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
                    if leaf == "var":
                        sub["norm"][leaf] = np.abs(sub["norm"][leaf])
    if apply_noise:
        tree["params"]["noise"]["weight"] = rng.randn(3).astype(np.float32)
    tm.load_state_dict(state_dict_from_jax(tree, tm))
    return jm, tm, tree, x


@pytest.mark.parametrize("kind,norm,ndf", DISC_CASES)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator_forward_matches(kind, norm, ndf, train):
    jm, tm, tree, x = _disc_pair(kind, norm, ndf)
    (jl, jf), _ = jm.apply(tree, jnp.asarray(x), train=train, mutable=["batch_stats"])
    tl, tf = tm(torch_f32(x), train=train)
    assert len(tf) == len(jf)
    for got, want in zip(tf + [tl], list(jf) + [jl]):
        assert_rel(got.detach().numpy(), want, 1e-5)


@pytest.mark.parametrize("kind,ndf", [("2d", 8), ("3d", 32)])
def test_discriminator_group_norm_refuses_widths_32_does_not_divide(kind, ndf):
    """flax's GroupNorm(32) raises on channels that 32 does not divide, and
    so does the port's: the 2D stack's 16 channels after its first conv at
    ndf 8, the 3D stack's last norm over its one logit channel."""
    x = np.random.RandomState(2).randn(*((2, 32, 32, 3) if kind == "2d" else
                                         (1, 5, 32, 32, 3))).astype(np.float32)
    cls = "NLayerDiscriminator" if kind == "2d" else "NLayerDiscriminator3D"
    kw = dict(ndf=ndf, n_layers=2, norm_type="group")
    msg = r"Number of groups \(32\) does not divide the number of channels \((16|1)\)"
    with pytest.raises(ValueError, match=msg):
        getattr(jdisc, cls)(**kw).init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    with pytest.raises(ValueError, match=msg):
        getattr(tdisc, cls)(**kw)(torch_f32(x), train=False)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_batchnorm_running_stats_after_two_calls(kind):
    jm, tm, tree, x = _disc_pair(kind, "batch", 16)
    x2 = (x * 0.5 + 0.3).astype(np.float32)
    stats = tree["batch_stats"]
    for xi in (x, x2):
        _, upd = jm.apply({"params": tree["params"], "batch_stats": stats}, jnp.asarray(xi),
                          train=True, mutable=["batch_stats"])
        stats = to_numpy_tree(upd["batch_stats"])
        tm(torch_f32(xi), train=True, update_stats=True)
    for name, sub in stats.items():
        norm = getattr(tm, name).norm
        assert_rel(norm.mean.numpy(), sub["norm"]["mean"], 1e-5)
        assert_rel(norm.var.numpy(), sub["norm"]["var"], 1e-5)
    # a train-mode call without update_stats leaves them alone
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm(torch_f32(x), train=True)
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())


def test_lpips_random_backbone_matches():
    rng = np.random.RandomState(5)
    x, y = (rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    jm = JaxLPIPS()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    tree = to_numpy_tree(variables)
    for i in range(5):  # heads other than the init's ones
        tree["params"][f"lin{i}"] = rng.uniform(0, 1, tree["params"][f"lin{i}"].shape).astype(np.float32)
    want = jm.apply(tree, jnp.asarray(x), jnp.asarray(y))
    tm = LPIPS()
    tm.load_state_dict(state_dict_from_jax(tree, tm))
    got = tm(torch_f32(x), torch_f32(y))
    assert got.shape == (2, 1, 1, 1)
    assert_rel(got.detach().numpy(), want, 1e-5)


def test_lpips_loader_reports_random_weights(tmp_path):
    missing = str(tmp_path / "absent.pth")
    _, pretrained = load_lpips_variables(LPIPS(), vgg16_torch_path=missing, lin_path=missing,
                                         generator=torch.Generator().manual_seed(0))
    assert pretrained is False
    # the heads from a file in the reference's layout, the backbone from a
    # torchvision-layout state_dict
    from omnitokenizer_tpu_torch.models.lpips import CHNS, TORCHVISION_CONVS
    lins = {f"lin{i}.model.1.weight": torch.full((1, c, 1, 1), 0.5) for i, c in enumerate(CHNS)}
    ref = LPIPS()
    vgg = {}
    for ci, ti in enumerate(TORCHVISION_CONVS):
        conv = getattr(ref.net, f"conv{ci}")
        vgg[f"features.{ti}.weight"] = torch.full_like(conv.weight, 0.01 * ci)
        vgg[f"features.{ti}.bias"] = torch.full_like(conv.bias, 0.1)
    torch.save(lins, tmp_path / "vgg.pth")
    torch.save(vgg, tmp_path / "vgg16.pth")
    m, pretrained = load_lpips_variables(LPIPS(), vgg16_torch_path=str(tmp_path / "vgg16.pth"),
                                         lin_path=str(tmp_path / "vgg.pth"))
    assert pretrained is True
    assert float(m.lin3[0]) == 0.5
    assert float(m.net.conv4.weight[0, 0, 0, 0]) == pytest.approx(0.04)


# -- codebook, training half ---------------------------------------------------
K, D = 32, 8


def _codebook_pair(initialized, no_random_restart=True, restart_thres=1.0):
    rng = np.random.RandomState(6)
    emb = rng.randn(K, D).astype(np.float32)
    bufs = dict(embeddings=emb, N=rng.uniform(0.5, 3, K).astype(np.float32),
                z_avg=(emb * 1.5).astype(np.float32),
                codebook_usage=rng.uniform(0, 0.1, K).astype(np.float32),
                initialized=np.asarray(initialized, np.int32), call_cnt=np.asarray(0, np.int32))
    jm = jcb.Codebook(n_codes=K, embedding_dim=D, no_random_restart=no_random_restart,
                      restart_thres=restart_thres)
    tm = tcb.Codebook(K, D, no_random_restart=no_random_restart, restart_thres=restart_thres)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in bufs.items()})
    return jm, tm, {"buffers": bufs}


def _z(m, seed):
    z = np.random.RandomState(seed).randn(1, 1, 1, m, D).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _run_both(jm, tm, variables, zs, monkeypatch):
    """Each z through both codebooks in training mode; the port's random
    rows are the ones the JAX codebook drew."""
    drawn = []
    real = jcb._tile_to_codes

    def record(flat, n_codes, key):
        out = real(flat, n_codes, key)
        drawn.append(torch.from_numpy(np.array(out)))
        return out

    monkeypatch.setattr(jcb, "_tile_to_codes", record)
    monkeypatch.setattr(tcb, "tile_to_codes", lambda flat, n, gen: drawn.pop(0))
    outs = []
    for i, z in enumerate(zs):
        jout, mut = jm.apply(variables, jnp.asarray(z), training=True,
                             rngs={"codebook": jax.random.PRNGKey(10 + i)}, mutable=["buffers"])
        variables = to_numpy_tree(mut)
        tout = tm(torch_f32(z), training=True)
        assert not drawn
        outs.append((jout, tout, variables["buffers"],
                     {k: v.clone() for k, v in tm.state_dict().items()}))
    return outs


def _assert_codebook(jout, tout, bufs, got, tol=1e-6):
    np.testing.assert_array_equal(tout["encodings"].numpy(), np.asarray(jout["encodings"]))
    for key in ("commitment_loss", "perplexity", "avg_usage", "batch_usage"):
        assert_rel(tout[key].numpy(), jout[key], 1e-5)
    assert_rel(tout["embeddings"].detach().numpy(), jout["embeddings"], 1e-6)
    for name in ("embeddings", "N", "z_avg", "codebook_usage"):
        assert_rel(got[name].numpy(), bufs[name], tol)
    for name in ("initialized", "call_cnt"):
        assert int(got[name]) == int(bufs[name])


def test_codebook_ema_after_one_and_two_calls(monkeypatch):
    jm, tm, variables = _codebook_pair(initialized=1)
    outs = _run_both(jm, tm, variables, [_z(200, 7), _z(200, 8)], monkeypatch)
    assert len(outs) == 2
    for out in outs:
        _assert_codebook(*out)


@pytest.mark.parametrize("rows", [12, 200], ids=["tiled", "subset"])
def test_codebook_init_and_restart_given_the_same_rows(monkeypatch, rows):
    jm, tm, variables = _codebook_pair(initialized=0, no_random_restart=False,
                                       restart_thres=3.0)
    out, = _run_both(jm, tm, variables, [_z(rows, 9)], monkeypatch)
    _assert_codebook(*out)


def test_codebook_draws_from_the_generator():
    tm = tcb.Codebook(K, D)
    flat = torch_f32(_z(12, 11).reshape(12, D))
    a = tcb.tile_to_codes(flat, K, torch.Generator().manual_seed(0))
    b = tcb.tile_to_codes(flat, K, torch.Generator().manual_seed(0))
    assert a.shape == (K, D) and torch.equal(a, b)
    # tiled rows stay within the noise of their source rows
    dist = torch.cdist(a, flat).min(1).values
    assert float(dist.max()) < 0.01 * 6 / D ** 0.5
    out = tm(torch_f32(_z(12, 11)), training=True, generator=torch.Generator().manual_seed(0))
    assert int(tm.initialized) == 1 and int(tm.call_cnt) == 1
    assert torch.isfinite(tm.embeddings).all() and out["encodings"].shape == (1, 1, 1, 12)
