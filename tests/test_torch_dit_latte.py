"""The port's DiT and Latte against the JAX package's, f32 on the CPU, at
tests/test_dit_latte.py's sizes with every weight random (the JAX init
zeroes the adaLN-Zero ones, and a model that outputs 0 compares nothing):
the same params through convert.dit_state_dict_from_jax, the same inputs
(channels-last on the JAX side, channels-first in the port). Forwards
within 1e-5 of the output's largest magnitude: DiT with labels, forced
drops and without labels; Latte with extras 1, 2 and 78, use_image_num 1
and forced drops; the CFG forwards. A reference-named torch state_dict,
pos_embed included, gives the same output through the JAX package's
convert_dit_state / convert_latte_state as through the port's loader. The
port's own init outputs exactly 0; the sin-cos tables, the timestep
embedding and the registries equal the JAX ones; serving() in bf16
computes what the f32-master model computes in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnitokenizer_tpu.models import dit as jdit
from omnitokenizer_tpu.models import latte as jlatte
from omnitokenizer_tpu_torch import convert
from omnitokenizer_tpu_torch.models import dit as tdit
from omnitokenizer_tpu_torch.models import latte as tlatte

from torch_port_util import (DIT_SMALL, LATTE_SMALL, random_diffusion_params,
                             reference_diffusion_state_dict)

torch.set_num_threads(1)
TOL = 1e-5


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def dit_pair(seed=0, **kw):
    jcfg, tcfg = jdit.DiTConfig(**{**DIT_SMALL, **kw}), tdit.DiTConfig(**{**DIT_SMALL, **kw})
    x = jnp.zeros((2, 8, 8, 4))
    y = jnp.zeros((2,), jnp.int32) if jcfg.num_classes else None
    params = random_diffusion_params(jdit.DiT(jcfg), (x, jnp.zeros((2,), jnp.int32), y), seed)
    model = tdit.DiT(tcfg)
    model.load_state_dict(convert.dit_state_dict_from_jax(params, tcfg.patch_size))
    return jdit.DiT(jcfg), params, model.eval()


def latte_pair(seed=0, **kw):
    jcfg, tcfg = (jlatte.LatteConfig(**{**LATTE_SMALL, **kw}),
                  tlatte.LatteConfig(**{**LATTE_SMALL, **kw}))
    init_kw = {}
    if jcfg.extras == 78:
        init_kw["text_embedding"] = jnp.zeros((1, 77, 768))
    x = jnp.zeros((1, 3, 8, 8, 4))
    params = random_diffusion_params(jlatte.Latte(jcfg), (x, jnp.zeros((1,), jnp.int32),
                                                          jnp.zeros((1,), jnp.int32)),
                                     seed, **init_kw)
    model = tlatte.Latte(tcfg)
    model.load_state_dict(convert.latte_state_dict_from_jax(params, tcfg.patch_size))
    return jlatte.Latte(jcfg), params, model.eval()


def images(n, seed=1):
    return np.random.RandomState(seed).randn(n, 8, 8, 4).astype(np.float32)


def clips(n, frames=3, seed=1):
    return np.random.RandomState(seed).randn(n, frames, 8, 8, 4).astype(np.float32)


def t_dit(x):  # channels-last numpy -> the port's channels-first tensor
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def t_latte(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 2)))


@pytest.mark.parametrize("case", ["labels", "force_drop", "no_labels"])
def test_dit_forward_matches_jax(case):
    jm, params, model = dit_pair(num_classes=0 if case == "no_labels" else 10)
    x = images(3)
    t = np.array([0, 17, 999])
    y = None if case == "no_labels" else np.array([1, 9, 4])
    drop = np.array([1, 0, 1]) if case == "force_drop" else None
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                    None if y is None else jnp.asarray(y),
                    force_drop_ids=None if drop is None else jnp.asarray(drop))
    with torch.no_grad():
        got = model(t_dit(x), torch.from_numpy(t), None if y is None else torch.from_numpy(y),
                    force_drop_ids=None if drop is None else torch.from_numpy(drop))
    assert got.shape == (3, 8, 8, 8)
    assert rel(np.moveaxis(got.numpy(), 1, -1), want) <= TOL


@pytest.mark.parametrize("case", ["extras1", "extras2", "extras78", "image_num1", "force_drop"])
def test_latte_forward_matches_jax(case):
    extras = {"extras1": 1, "extras78": 78}.get(case, 2)
    jm, params, model = latte_pair(extras=extras)
    use_image_num = 1 if case == "image_num1" else 0
    rng = np.random.RandomState(2)
    x = clips(2, frames=3 + use_image_num)
    t = np.array([5, 640])
    y = np.array([3, 7])
    kw_j, kw_t = {}, {}
    if extras == 78:
        text = rng.randn(2, 77, 768).astype(np.float32)
        kw_j["text_embedding"], kw_t["text_embedding"] = jnp.asarray(text), torch.from_numpy(text)
    if use_image_num:
        y_image = np.array([[2], [8]])
        kw_j.update(use_image_num=1, y_image=jnp.asarray(y_image))
        kw_t.update(use_image_num=1, y_image=torch.from_numpy(y_image))
    if case == "force_drop":
        drop = np.array([0, 1])
        kw_j["force_drop_ids"], kw_t["force_drop_ids"] = jnp.asarray(drop), torch.from_numpy(drop)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), **kw_j)
    with torch.no_grad():
        got = model(t_latte(x), torch.from_numpy(t), torch.from_numpy(y), **kw_t)
    assert got.shape == (2, x.shape[1], 8, 8, 8)
    assert rel(np.moveaxis(got.numpy(), 2, -1), want) <= TOL


def test_forward_with_cfg_matches_jax():
    x, t, y = images(4, seed=3), np.array([4, 4, 4, 4]), np.array([1, 2, 10, 10])
    jm, params, model = dit_pair()
    want = jdit.forward_with_cfg(lambda p, *a: jm.apply(p, *a), {"params": params},
                                 jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), 4.0, 3)
    with torch.no_grad():
        got = tdit.forward_with_cfg(model, t_dit(x), torch.from_numpy(t), torch.from_numpy(y),
                                    4.0, 3)
    assert rel(np.moveaxis(got.numpy(), 1, -1), want) <= TOL
    np.testing.assert_array_equal(got[:2, :3].numpy(), got[2:, :3].numpy())

    xv = clips(2, seed=4)
    jl, lparams, lmodel = latte_pair()
    want = jlatte.forward_with_cfg(lambda p, *a: jl.apply(p, *a), {"params": lparams},
                                   jnp.asarray(xv), jnp.asarray(t[:2]), jnp.asarray(y[1:3]), 7.0, 4)
    with torch.no_grad():
        got = tlatte.forward_with_cfg(lmodel, t_latte(xv), torch.from_numpy(t[:2]),
                                      torch.from_numpy(y[1:3]), 7.0, 4)
    assert rel(np.moveaxis(got.numpy(), 2, -1), want) <= TOL


@pytest.mark.parametrize("kind", ["dit", "latte", "latte_text"])
def test_reference_state_dict_loads_like_jax(kind, tmp_path):
    """The reference's names load with no key map beyond the fixed tables,
    from a train-script checkpoint ({'ema', 'model'}: the EMA is read)."""
    if kind == "dit":
        jcfg, tcfg = jdit.DiTConfig(**DIT_SMALL), tdit.DiTConfig(**DIT_SMALL)
        sd = reference_diffusion_state_dict(tcfg)
        jm, model, params = jdit.DiT(jcfg), tdit.DiT(tcfg), jdit.convert_dit_state(sd)
        x, conv = images(2), t_dit
    else:
        extras = 78 if kind == "latte_text" else 2
        jcfg = jlatte.LatteConfig(**{**LATTE_SMALL, "extras": extras})
        tcfg = tlatte.LatteConfig(**{**LATTE_SMALL, "extras": extras})
        sd = reference_diffusion_state_dict(tcfg, latte=True)
        jm, model, params = jlatte.Latte(jcfg), tlatte.Latte(tcfg), jlatte.convert_latte_state(sd)
        x, conv = clips(2), t_latte
    path = tmp_path / "ckpt.pt"
    torch.save({"model": {k: torch.zeros(v.shape) for k, v in sd.items()},
                "ema": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    convert.load_diffusion_state_dict(model, convert.load_torch_diffusion_state_dict(str(path)))
    t, y = np.array([3, 500]), np.array([1, 6])
    kw_j, kw_t = {}, {}
    if kind == "latte_text":
        text = np.random.RandomState(5).randn(2, 77, 768).astype(np.float32)
        kw_j["text_embedding"], kw_t["text_embedding"] = jnp.asarray(text), torch.from_numpy(text)
    want = jm.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)}, jnp.asarray(x),
                    jnp.asarray(t), jnp.asarray(y), **kw_j)
    with torch.no_grad():
        got = model(conv(x), torch.from_numpy(t), torch.from_numpy(y), **kw_t)
    axis = 1 if kind == "dit" else 2
    assert rel(np.moveaxis(got.numpy(), axis, -1), want) <= TOL
    with pytest.raises(RuntimeError):  # strict: a missing tensor raises
        convert.load_diffusion_state_dict(model, {k: v for k, v in sd.items()
                                                  if k != "final_layer.linear.bias"})


def test_jax_conversion_is_strict():
    _, params, _ = dit_pair()
    params = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        convert.dit_state_dict_from_jax(params, 2)


def test_init_outputs_zero():
    """adaLN-Zero: the port's own init (the JAX one) outputs exactly 0."""
    g = torch.Generator().manual_seed(0)
    dit = tdit.init_weights(tdit.DiT(tdit.DiTConfig(**DIT_SMALL)), g)
    latte = tdit.init_weights(tlatte.Latte(tlatte.LatteConfig(**LATTE_SMALL)), g)
    with torch.no_grad():
        out = dit(t_dit(images(2)), torch.tensor([5, 9]), torch.tensor([0, 3]))
        outv = latte(t_latte(clips(1)), torch.tensor([5]), torch.tensor([0]))
    assert float(out.abs().max()) == 0.0 and float(outv.abs().max()) == 0.0
    assert float(dit.blocks[0].attn.qkv.weight.detach().abs().max()) > 0


def test_fixed_tables_match_jax():
    np.testing.assert_array_equal(tdit.sincos_2d(16, 4), jdit.sincos_2d(16, 4))
    np.testing.assert_array_equal(tdit.sincos_1d(32, np.arange(5)), jdit.sincos_1d(32, np.arange(5)))
    # f32 cos/sin of arguments up to 999, where one ulp of the argument is
    # 6e-5: the two libraries' exp and sin differ by about that much
    t = np.array([0, 1, 17, 999])
    for dim in (8, 256, 9):
        np.testing.assert_allclose(tdit.timestep_embedding(torch.from_numpy(t), dim).numpy(),
                                   np.asarray(jdit.timestep_embedding(jnp.asarray(t), dim)),
                                   rtol=0, atol=1e-4)


def test_registries_match_jax():
    def fields(cfg):
        return {k: v for k, v in vars(cfg).items() if k != "dtype"}

    for name in jdit.DiT_models:
        assert fields(tdit.DiT_models[name]()) == fields(jdit.DiT_models[name]())
    for name in jlatte.Latte_models:
        assert fields(tlatte.Latte_models[name]()) == fields(jlatte.Latte_models[name]())
    assert tlatte.latte_config("Latte-XL/2-omnitokenizer").in_channels == 8


def test_label_dropout_draws_null_class():
    """Training dropout at probability 1 is the null class; from the caller's generator."""
    _, _, model = dit_pair(class_dropout_prob=1.0)
    x, t = t_dit(images(2)), torch.tensor([3, 3])
    with torch.no_grad():
        dropped = model(x, t, torch.tensor([1, 2]), train=True,
                        generator=torch.Generator().manual_seed(0))
        null = model(x, t, torch.tensor([10, 10]))
    torch.testing.assert_close(dropped, null, rtol=0, atol=0)


def test_bf16_serving_matches_bf16_forward():
    _, _, model = dit_pair()
    model.cfg = model.cfg.replace(dtype=torch.bfloat16)
    served = model.serving()
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in served.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x, t, y = t_dit(images(2)), torch.tensor([1, 800]), torch.tensor([2, 5])
    with torch.no_grad():
        torch.testing.assert_close(served(x, t, y), model(x, t, y), rtol=0, atol=0)
