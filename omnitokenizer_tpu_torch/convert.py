"""Weights from the JAX package's variable tree to the port's state_dict.

`state_dict_from_jax(variables, model)` takes a flax variable tree (the
collections "params", "buffers" and "batch_stats") as nested dicts of numpy
arrays (the caller converts the JAX arrays; this package never imports
JAX) and returns a state_dict for `model`: the tokenizer, a discriminator
or LPIPS. The port names its submodules after the flax scopes, so a key is
the flax path joined by dots, with these renames of the last element:

    kernel            -> weight, (in, out) transposed to nn.Linear's (out, in);
                         a conv's (*k, in, out) to (out, in, *k)
    <name>_conv_kernel -> <name>_conv.weight, as it is: the cnn decoder's
                         ConvTranspose3d, kept in torch's (E, C, kt, p, p)
    <name>_conv_bias  -> <name>_conv.bias
    <name>_kernel     -> <name>.weight, transposed as a dense kernel
    dsconv_kernel     -> dsconv.weight, (3, 3, 3, 1, d) -> (d, 1, 3, 3, 3)
    dsconv_bias       -> dsconv.bias

The "batch_stats" collection (BatchNorm's running mean and var) fills the
port's buffers of the same names.

`load_train_state_from_jax` fills a trainer state (training/trainer.py)
from the JAX trainer's: the generator's params and codebook buffers, the
discriminators' params and BatchNorm statistics, the LPIPS params and the
step. `train_state_to_jax` writes the whole JAX TokenizerTrainState,
optimizers included, and `load_full_train_state_from_jax` reads it back
(vqgan_train --ckpt_backend msgpack).

It is strict: a JAX leaf that maps to no port tensor, a port tensor left
unfilled, or a shape that disagrees raises.

`gpt_state_dict_from_jax(params)` turns the JAX LM's params (block{i}/query/
kernel, ...) into the state_dict of the port's GPT, whose modules carry the
reference's torch names (blocks.{i}.attn.query.weight, ...); it is strict in
the same way. `dit_state_dict_from_jax` does the same for DiT and Latte.

A leaf may be a numpy array (a JAX array the caller converted) or a CPU
tensor as `utils.msgpack_io` reads it from the JAX package's files,
bfloat16 included. Each map has its inverse, the port's weights as the JAX
package's tree (`state_dict_to_jax`, `gpt_state_dict_to_jax`,
`dit_state_dict_to_jax`), which `utils.msgpack_io.write_msgpack` writes in
the JAX package's own file format. An inverse's leaves are numpy arrays,
but a bfloat16 tensor stays a tensor (numpy has no bfloat16).
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn


COLLECTIONS = ("params", "buffers", "batch_stats")


def _np(value: Any) -> np.ndarray:
    """A leaf as numpy: a tensor (bfloat16 through f32, which holds it
    exactly), or np.asarray of anything else."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


def _own(t: torch.Tensor) -> torch.Tensor:
    """`t` (a view, maybe permuted) in its own C-order memory: one copy, by
    torch."""
    return t.contiguous() if not t.is_contiguous() else t.clone()


def _out(t: torch.Tensor) -> Any:
    """A (permuted) port tensor as an inverse map's leaf: numpy, or a
    bfloat16 tensor."""
    t = _own(t)
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _t32(value: Any) -> torch.Tensor:
    """A leaf as an f32 CPU tensor, sharing the leaf's memory where it can
    (the caller copies it once, transposed or not)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().float()
    with warnings.catch_warnings():  # a read-only array: read here, never written
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))


def _nest(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    """{path: leaf} -> nested dicts."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_key(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    *scope, last = path
    if last == "dsconv_kernel":
        return ".".join(scope + ["dsconv", "weight"]), value.transpose(4, 3, 0, 1, 2)
    if last == "dsconv_bias":
        return ".".join(scope + ["dsconv", "bias"]), value
    if last.endswith(("_conv_kernel", "_conv_bias")):
        name, leaf = last.rsplit("_", 1)
        return ".".join(scope + [name, "weight" if leaf == "kernel" else "bias"]), value
    if last == "kernel" and value.ndim > 2:  # a conv: (*k, in, out) -> (out, in, *k)
        n = value.ndim
        return ".".join(scope + ["weight"]), value.transpose(n - 1, n - 2, *range(n - 2))
    if last == "kernel":
        return ".".join(scope + ["weight"]), value.T
    if last.endswith("_kernel"):
        return ".".join(scope + [last[:-len("_kernel")], "weight"]), value.T
    return ".".join(path), value


def state_dict_from_jax(variables: Dict[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """flax variables (nested dicts of numpy arrays) -> `model`'s state_dict."""
    return _from_jax(variables, model.state_dict())


def params_from_jax(params: Dict[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """A tree shaped as `model`'s flax params (an optimizer's moments, say)
    -> a tensor for each of `model`'s named parameters."""
    return _from_jax({"params": params}, dict(model.named_parameters()))


def _from_jax(variables: Dict[str, Any], want: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    unknown = set(variables) - set(COLLECTIONS)
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for collection in COLLECTIONS:
        for path, value in _leaves(variables.get(collection, {})):
            key, arr = _port_key(path, _np(value))
            if key not in want:
                unused.append("/".join((collection,) + path))
                continue
            if tuple(arr.shape) != tuple(want[key].shape):
                raise ValueError(f"{key}: JAX shape {tuple(arr.shape)} "
                                 f"!= port shape {tuple(want[key].shape)}")
            out[key] = torch.tensor(arr, dtype=want[key].dtype)  # the one copy
    if unused:
        raise KeyError(f"JAX leaves with no port tensor: {unused}")
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"port tensors left unfilled: {missing}")
    return out


def load_train_state_from_jax(tree: Dict[str, Any], state) -> None:
    """Fill a `training.trainer.TokenizerTrainState` from the JAX trainer's
    state as nested dicts of numpy arrays: keys params_g, buffers, params_d
    and batch_stats_d (each {"image", "video"}), lpips_params and step."""
    def load(module, variables):
        module.load_state_dict(state_dict_from_jax(variables, module))

    load(state.net, {"params": tree["params_g"], "buffers": tree["buffers"]})
    for which in ("image", "video"):
        load(getattr(state, f"{which}_disc"),
             {"params": tree["params_d"][which], "batch_stats": tree["batch_stats_d"][which]})
    load(state.lpips, {"params": tree["lpips_params"]})
    state.step = int(tree["step"])


# -- the JAX TokenizerTrainState (omnitokenizer_tpu/training/trainer.py:38-47) --------------
# Its optimizers are optax chains: clip_by_global_norm (when a clip is set),
# scale_by_adam, scale_by_learning_rate, in MultiSteps when gradients
# accumulate. Serialized, a chain is a dict keyed '0', '1', ... of its
# states: {} for the clip, {count, mu, nu} for Adam, {count} for the
# schedule; MultiSteps is {mini_step, gradient_step, inner_opt_state,
# acc_grads, skip_state: {}}. Counts are int32 0-d arrays. The port's
# streams come from a seed where the JAX step splits a key: `rng` holds
# the seed as jax.random.PRNGKey(seed) does, [seed >> 32, seed & 0xffffffff].
def _i32(x: int) -> np.ndarray:
    return np.asarray(x, np.int32)


def _opt_to_jax(opt, st, moments) -> Dict[str, Any]:
    """An OptaxAdam (training/trainer.py) and its OptState as optax's tree;
    `moments(list)` maps a list in parameter order to the params tree."""
    chain = [] if opt.clip is None else [{}]
    chain += [{"count": _i32(st.count), "mu": moments(st.mu), "nu": moments(st.nu)},
              {"count": _i32(st.lr_count)}]
    inner = {str(i): c for i, c in enumerate(chain)}
    if opt.k == 1:
        return inner
    return {"mini_step": _i32(st.mini_step), "gradient_step": _i32(st.gradient_step),
            "inner_opt_state": inner, "acc_grads": moments(st.acc), "skip_state": {}}


def _opt_from_jax(tree: Dict[str, Any], opt, st, moments) -> None:
    """The inverse of _opt_to_jax into `st`; `moments(tree)` maps a params
    tree to a list in parameter order."""
    def fill(dst, tree_):
        with torch.no_grad():
            for t, v in zip(dst, moments(tree_)):
                t.copy_(v)

    if opt.k > 1:
        st.mini_step, st.gradient_step = int(tree["mini_step"]), int(tree["gradient_step"])
        fill(st.acc, tree["acc_grads"])
        tree = tree["inner_opt_state"]
    first = 0 if opt.clip is None else 1
    if len(tree) != first + 2:
        raise KeyError(f"an optax chain of {len(tree)} states; this optimizer's has {first + 2}")
    adam = tree[str(first)]
    st.count, st.lr_count = int(adam["count"]), int(tree[str(first + 1)]["count"])
    fill(st.mu, adam["mu"])
    fill(st.nu, adam["nu"])


def _module_moments(modules: Dict[str, nn.Module]):
    """(to_jax, from_jax) of moment lists over the parameters of `modules`
    in order; keyed by name when there are several (the discriminators'
    {"image", "video"}), else the one module's params tree."""
    names = {k: [n for n, _ in m.named_parameters()] for k, m in modules.items()}

    def to_jax(values):
        out, it = {}, iter(values)
        for k, m in modules.items():
            sd = {n: next(it) for n in names[k]}
            out[k] = state_dict_to_jax(m, sd).get("params", {})
        return out if len(modules) > 1 else out[next(iter(modules))]

    def from_jax(tree):
        values = []
        for k, m in modules.items():
            got = params_from_jax(tree[k] if len(modules) > 1 else tree, m)
            values += [got[n] for n in names[k]]
        return values

    return to_jax, from_jax


def train_state_to_jax(state, opt_g, opt_d) -> Dict[str, Any]:
    """A `training.trainer.TokenizerTrainState` as the JAX trainer's state
    tree (to be written by utils.msgpack_io.write_msgpack); opt_g and
    opt_d are the trainer's OptaxAdam chains."""
    net = state_dict_to_jax(state.net)
    discs = {w: state_dict_to_jax(getattr(state, f"{w}_disc")) for w in ("image", "video")}
    g_moments, _ = _module_moments({"net": state.net})
    d_moments, _ = _module_moments({w: getattr(state, f"{w}_disc") for w in ("image", "video")})
    seed = int(state.seed)
    return {"step": _i32(state.step), "params_g": net["params"], "buffers": net.get("buffers", {}),
            "opt_g": _opt_to_jax(opt_g, state.opt_g, g_moments),
            "params_d": {w: d["params"] for w, d in discs.items()},
            "batch_stats_d": {w: d.get("batch_stats", {}) for w, d in discs.items()},
            "opt_d": _opt_to_jax(opt_d, state.opt_d, d_moments),
            "lpips_params": state_dict_to_jax(state.lpips)["params"],
            "rng": np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)}


def load_full_train_state_from_jax(tree: Dict[str, Any], state, opt_g, opt_d) -> None:
    """The inverse of train_state_to_jax: the modules and the step
    (load_train_state_from_jax), both optimizers' moments and counts, and
    the seed from `rng`."""
    load_train_state_from_jax(tree, state)
    _, g_from = _module_moments({"net": state.net})
    _, d_from = _module_moments({w: getattr(state, f"{w}_disc") for w in ("image", "video")})
    _opt_from_jax(tree["opt_g"], opt_g, state.opt_g, g_from)
    _opt_from_jax(tree["opt_d"], opt_d, state.opt_d, d_from)
    hi, lo = (int(x) for x in _np(tree["rng"]).reshape(-1))
    state.seed = (hi << 32) | lo


def state_dict_to_jax(model: nn.Module, sd: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, Any]:
    """The inverse of state_dict_from_jax for the tokenizer, a
    discriminator or LPIPS: `model`'s state_dict (or `sd`, tensors under
    its keys) as the JAX module's variables {"params": ..., "buffers":
    ..., ["batch_stats": ...]}. Any conv's (out, in, *k) weight is a
    `kernel` (*k, in, out) but for the tokenizer's own below. A Linear of an attention or
    feed-forward block was a raw `<name>_kernel` parameter of its flax
    module (ops/attention.py), any other Linear a Dense `kernel`; PEG's
    depthwise conv was `dsconv_kernel`, (d, 1, 3, 3, 3) -> (3, 3, 3, 1, d);
    the cnn embed's conv a Conv `kernel`, (E, C, kt, p, p) -> (kt, p, p, C,
    E), and the cnn decoder's `<name>_conv_kernel` and `_bias` raw
    parameters of the Decoder; BatchNorm's running statistics were
    "batch_stats"."""
    from .models.discriminator import BatchNorm
    from .models.tokenizer import PatchConv, PatchUnconv
    from .ops.attention import Attention, FeedForward

    buffers = {n for n, _ in model.named_buffers()}
    flat: Dict[Tuple[str, ...], Any] = {}
    for key, value in (model.state_dict() if sd is None else sd).items():
        *scope, leaf = key.split(".")
        arr = value.detach().cpu()
        module = model.get_submodule(".".join(scope)) if scope else model
        if key in buffers:
            collection = "batch_stats" if isinstance(module, BatchNorm) else "buffers"
            flat[(collection, *scope, leaf)] = _out(arr)
            continue
        if isinstance(module, PatchUnconv):
            path = (*scope[:-1], f"{scope[-1]}_{'kernel' if leaf == 'weight' else 'bias'}")
        elif isinstance(module, PatchConv):
            path = (*scope, "kernel" if leaf == "weight" else "bias")
            arr = arr.permute(2, 3, 4, 1, 0) if leaf == "weight" else arr
        elif scope and scope[-1] == "dsconv":
            path = (*scope[:-1], f"dsconv_{'kernel' if leaf == 'weight' else 'bias'}")
            arr = arr.permute(2, 3, 4, 1, 0) if leaf == "weight" else arr
        elif isinstance(module, nn.Linear):
            owner = model.get_submodule(".".join(scope[:-1]))
            if leaf == "bias":
                path = (*scope, "bias")
            elif isinstance(owner, (Attention, FeedForward)):
                path = (*scope[:-1], f"{scope[-1]}_kernel")
            else:
                path = (*scope, "kernel")
            arr = arr.T if leaf == "weight" else arr
        elif isinstance(module, nn.modules.conv._ConvNd) and leaf == "weight":
            path = (*scope, "kernel")
            arr = arr.permute(*range(2, arr.ndim), 1, 0)
        else:
            path = (*scope, leaf)
        flat[("params",) + path] = _out(arr)
    return _nest(flat)


# the JAX GPT's scopes -> the port's (the reference's torch) module names
_GPT_SCOPES = {"query": "attn.query", "key": "attn.key", "value": "attn.value",
               "proj": "attn.proj", "fc": "mlp.0", "proj_out": "mlp.2", "ln1": "ln1", "ln2": "ln2"}
_GPT_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight", "embedding": "weight"}


def gpt_keys(n_layer: int) -> set:
    """Every state_dict key of the port's GPT with `n_layer` blocks (without
    the optional vtokens table)."""
    keys = {"tok_emb.weight", "pos_emb", "ln_f.weight", "ln_f.bias", "head.weight"}
    for i in range(n_layer):
        for scope in _GPT_SCOPES.values():
            keys |= {f"blocks.{i}.{scope}.weight", f"blocks.{i}.{scope}.bias"}
    return keys


def gpt_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX GPT's params (nested dicts of numpy arrays) -> the port GPT's
    state_dict, Dense kernels transposed to nn.Linear's (out, in). A leaf
    that maps to no port tensor, or a tensor of the blocks found left
    unfilled, raises."""
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for path, value in _leaves(params):
        t = _t32(value)
        if path in (("pos_emb",), ("vtokens_pos_emb",)):
            key = path[0]
        elif len(path) == 2 and path[0] in ("tok_emb", "ln_f", "head") and path[1] in _GPT_LEAVES:
            key = f"{path[0]}.{_GPT_LEAVES[path[1]]}"
        elif (len(path) == 3 and path[0].startswith("block") and path[0][5:].isdigit()
              and path[1] in _GPT_SCOPES and path[2] in _GPT_LEAVES):
            key = f"blocks.{int(path[0][5:])}.{_GPT_SCOPES[path[1]]}.{_GPT_LEAVES[path[2]]}"
        else:
            unused.append("/".join(path))
            continue
        out[key] = _own(t.T if path[-1] == "kernel" else t)
    if unused:
        raise KeyError(f"JAX leaves with no port tensor: {unused}")
    n_layer = len({k.split(".")[1] for k in out if k.startswith("blocks.")})
    missing = sorted(gpt_keys(n_layer) - set(out))
    if missing:
        raise KeyError(f"port tensors left unfilled: {missing}")
    return out


def gpt_state_dict_to_jax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of gpt_state_dict_from_jax: the port GPT's state_dict as
    the JAX GPT's params (nn.Linear weights transposed back to kernels)."""
    scopes = {v: k for k, v in _GPT_SCOPES.items()}
    flat: Dict[Tuple[str, ...], Any] = {}
    for key, value in sd.items():
        arr = value.detach().cpu()
        m = re.fullmatch(r"blocks\.(\d+)\.(.+)\.(weight|bias)", key)
        if key in ("pos_emb", "vtokens_pos_emb"):
            path = (key,)
        elif key == "tok_emb.weight":
            path = ("tok_emb", "embedding")
        elif key in ("ln_f.weight", "ln_f.bias"):
            path = ("ln_f", "scale" if key.endswith("weight") else "bias")
        elif key == "head.weight":
            path, arr = ("head", "kernel"), arr.T
        elif m and m.group(2) in scopes:
            scope, leaf = scopes[m.group(2)], m.group(3)
            if leaf == "bias":
                path = (f"block{m.group(1)}", scope, "bias")
            elif scope in ("ln1", "ln2"):
                path = (f"block{m.group(1)}", scope, "scale")
            else:
                path, arr = (f"block{m.group(1)}", scope, "kernel"), arr.T
        else:
            raise KeyError(f"{key}: no JAX GPT leaf")
        flat[path] = _out(arr)
    return _nest(flat)


# the JAX DiT/Latte scopes -> the port's (the reference's torch) module names
_DIT_SCOPES = {("t_embed", "fc1"): "t_embedder.mlp.0", ("t_embed", "fc2"): "t_embedder.mlp.2",
               ("final", "adaLN"): "final_layer.adaLN_modulation.1",
               ("final", "linear"): "final_layer.linear", ("text_proj",): "text_embedding_projection.1"}
_DIT_BLOCK = {"adaLN": "adaLN_modulation.1", "qkv": "attn.qkv", "proj": "attn.proj",
              "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def dit_state_dict_from_jax(params: Dict[str, Any], patch_size: int) -> Dict[str, torch.Tensor]:
    """The JAX DiT's (or Latte's) params, nested dicts of numpy arrays ->
    the port model's state_dict: Dense kernels transposed to nn.Linear's
    (out, in), the patch embedding's (p*p*C, D) kernel to the conv's (D, C,
    p, p). A leaf that maps to no port tensor raises; load the result
    strictly to find a tensor left unfilled."""
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for path, value in _leaves(params):
        arr, scope, leaf = _t32(value), path[:-1], path[-1]
        if scope == ("x_embed",):
            key = "x_embedder.proj"
            if leaf == "kernel":
                p = patch_size
                arr = arr.reshape(p, p, -1, arr.shape[-1]).permute(3, 2, 0, 1)
        elif scope == ("y_embed", "table") and leaf == "embedding":
            out["y_embedder.embedding_table.weight"] = _own(arr)
            continue
        elif scope in _DIT_SCOPES:
            key = _DIT_SCOPES[scope]
        elif (len(scope) == 2 and scope[0].startswith("block_") and scope[0][6:].isdigit()
              and scope[1] in _DIT_BLOCK):
            key = f"blocks.{int(scope[0][6:])}.{_DIT_BLOCK[scope[1]]}"
        else:
            unused.append("/".join(path))
            continue
        if leaf not in ("kernel", "bias"):
            unused.append("/".join(path))
            continue
        if leaf == "kernel" and scope != ("x_embed",):
            arr = arr.T
        out[f"{key}.{'weight' if leaf == 'kernel' else 'bias'}"] = _own(arr)
    if unused:
        raise KeyError(f"JAX leaves with no port tensor: {unused}")
    return out


latte_state_dict_from_jax = dit_state_dict_from_jax


def dit_state_dict_to_jax(sd: Dict[str, torch.Tensor], patch_size: int) -> Dict[str, Any]:
    """The inverse of dit_state_dict_from_jax: a port DiT's (or Latte's)
    state_dict as the JAX model's params; the fixed sin-cos tables are no
    params there and are left out."""
    scopes = {v: k for k, v in _DIT_SCOPES.items()}
    blocks = {v: k for k, v in _DIT_BLOCK.items()}
    flat: Dict[Tuple[str, ...], Any] = {}
    for key, value in sd.items():
        if key in ("pos_embed", "temp_embed"):
            continue
        arr, (module, leaf) = value.detach().cpu(), key.rsplit(".", 1)
        m = re.fullmatch(r"blocks\.(\d+)\.(.+)", module)
        if key == "y_embedder.embedding_table.weight":
            flat[("y_embed", "table", "embedding")] = _out(arr)
            continue
        if module == "x_embedder.proj":
            scope = ("x_embed",)
            if leaf == "weight":  # (D, C, p, p) -> (p * p * C, D)
                D, C = value.shape[:2]
                arr = arr.permute(2, 3, 1, 0).reshape(patch_size * patch_size * C, D)
        elif module in scopes:
            scope = scopes[module]
        elif m and m.group(2) in blocks:
            scope = (f"block_{m.group(1)}", blocks[m.group(2)])
        else:
            raise KeyError(f"{key}: no JAX DiT/Latte leaf")
        if leaf == "weight" and module != "x_embedder.proj":
            arr = arr.T
        flat[scope + ("kernel" if leaf == "weight" else "bias",)] = _out(arr)
    return _nest(flat)


latte_state_dict_to_jax = dit_state_dict_to_jax


# the JAX LatteT2V's scopes -> the port's (the reference's torch) module names
_T2V_ROOT = {("t_embed", "fc1"): "adaln_single.emb.timestep_embedder.linear_1",
             ("t_embed", "fc2"): "adaln_single.emb.timestep_embedder.linear_2",
             ("adaln_linear",): "adaln_single.linear",
             ("caption_linear_1",): "caption_projection.linear_1",
             ("caption_linear_2",): "caption_projection.linear_2", ("proj_out",): "proj_out"}
_T2V_BLOCK = {**{(a, n): f"{a}.{n}" for a in ("attn1", "attn2") for n in ("to_q", "to_k", "to_v")},
              **{(a, "to_out"): f"{a}.to_out.0" for a in ("attn1", "attn2")},
              ("ff", "proj_in"): "ff.net.0.proj", ("ff", "proj_out"): "ff.net.2",
              **{(f"norm{k}", "ln"): f"norm{k}" for k in (1, 2, 3)}}
_T2V_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_T2V_BLOCKS = {"spatial": "transformer_blocks", "temporal": "temporal_transformer_blocks"}


def latte_t2v_state_dict_from_jax(params: Dict[str, Any], patch_size: int
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX LatteT2V's params (nested dicts of numpy arrays, as
    `omnitokenizer_tpu.models.latte_t2v.convert_latte_t2v_state` makes them)
    -> the reference-named state_dict of the port's LatteT2V: Dense kernels
    transposed to nn.Linear's (out, in), the patch kernel's (p*p*C, D) to
    the conv's (D, C, p, p), LayerNorm scales to weights. A leaf that maps
    to no port tensor raises; load the result strictly to find a tensor
    left unfilled."""
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for path, value in _leaves(params):
        arr, (*scope, leaf) = _t32(value), path
        scope = tuple(scope)
        block = re.fullmatch(r"(spatial|temporal)_(\d+)", scope[0]) if scope else None
        if path == ("pos_embed_proj_kernel",):
            p = patch_size
            out["pos_embed.proj.weight"] = _own(arr.reshape(p, p, -1, arr.shape[-1])
                                                .permute(3, 2, 0, 1))
            continue
        if path in (("pos_embed_proj_bias",), ("scale_shift_table",)):
            key = {"pos_embed_proj_bias": "pos_embed.proj.bias"}.get(leaf, leaf)
        elif scope in _T2V_ROOT and leaf in ("kernel", "bias"):
            key = f"{_T2V_ROOT[scope]}.{_T2V_LEAVES[leaf]}"
        elif block and scope[1:] == () and leaf == "scale_shift_table":
            key = f"{_T2V_BLOCKS[block.group(1)]}.{block.group(2)}.scale_shift_table"
        elif block and scope[1:] in _T2V_BLOCK and leaf in _T2V_LEAVES:
            key = (f"{_T2V_BLOCKS[block.group(1)]}.{block.group(2)}."
                   f"{_T2V_BLOCK[scope[1:]]}.{_T2V_LEAVES[leaf]}")
        else:
            unused.append("/".join(path))
            continue
        out[key] = _own(arr.T if leaf == "kernel" else arr)
    if unused:
        raise KeyError(f"JAX leaves with no port tensor: {unused}")
    return out


def latte_t2v_state_dict_to_jax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of latte_t2v_state_dict_from_jax: a reference-named
    LatteT2V state_dict as the JAX model's params (the fixed sin-cos buffer
    pos_embed.pos_embed, where a state_dict holds it, is no param there)."""
    root = {v: k for k, v in _T2V_ROOT.items()}
    blocks = {v: k for k, v in _T2V_BLOCK.items()}
    kinds = {v: k for k, v in _T2V_BLOCKS.items()}
    flat: Dict[Tuple[str, ...], Any] = {}
    for key, value in sd.items():
        arr = torch.as_tensor(value).detach().cpu()
        if key == "pos_embed.pos_embed":
            continue
        if key == "pos_embed.proj.weight":  # (D, C, p, p) -> (p * p * C, D)
            D, C, p, _ = arr.shape
            flat[("pos_embed_proj_kernel",)] = _out(arr.permute(2, 3, 1, 0).reshape(p * p * C, D))
            continue
        module, _, leaf = key.rpartition(".")
        m = re.fullmatch(r"(transformer_blocks|temporal_transformer_blocks)\.(\d+)\.?(.*)", module)
        if key in ("pos_embed.proj.bias", "scale_shift_table"):
            path = ("pos_embed_proj_bias",) if key == "pos_embed.proj.bias" else (key,)
        elif module in root:
            path = root[module] + ("kernel" if leaf == "weight" else "bias",)
        elif m and m.group(3) == "" and leaf == "scale_shift_table":
            path = (f"{kinds[m.group(1)]}_{m.group(2)}", "scale_shift_table")
        elif m and m.group(3) in blocks:
            scope = blocks[m.group(3)]
            name = ("scale" if leaf == "weight" else "bias") if scope[1] == "ln" else (
                "kernel" if leaf == "weight" else "bias")
            path = (f"{kinds[m.group(1)]}_{m.group(2)}",) + scope + (name,)
        else:
            raise KeyError(f"{key}: no JAX LatteT2V leaf")
        flat[path] = _out(arr.T if path[-1] == "kernel" else arr)
    return _nest(flat)


def load_torch_diffusion_state_dict(path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A reference DiT/Latte checkpoint as its state_dict, read as the
    reference's find_model reads it: a raw state_dict, or the train
    scripts' dict with 'ema' and 'model' entries (the EMA unless use_ema is
    False). Loads with weights_only=False: the train scripts pickle their
    argparse Namespace beside the weights."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and ("ema" in ckpt or "model" in ckpt):
        ckpt = ckpt["ema" if (use_ema and "ema" in ckpt) else "model"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: torch.as_tensor(v) for k, v in ckpt.items()}


def diffusion_state_field(raw: Any, field: str, where: str) -> Dict[str, Any]:
    """The `field` tree (params or ema_params) of a JAX DiffusionTrainState
    as msgpack_io reads it (params, ema_params, opt_state, step)."""
    if not isinstance(raw, dict) or not isinstance(raw.get(field), dict):
        have = sorted(raw) if isinstance(raw, dict) else type(raw).__name__
        raise KeyError(f"{where}: no '{field}' tree (a DiffusionTrainState has params, "
                       f"ema_params, opt_state, step; the file has {have})")
    return raw[field]


def diffusion_state_dict_from_msgpack(path: str, patch_size: int, use_ema: bool = True
                                      ) -> Dict[str, torch.Tensor]:
    """A JAX DiffusionTrainState file (training/diffusion_loop.py's
    state_*.msgpack) -> the reference-named state_dict of its ema_params
    (params unless use_ema)."""
    from .utils.msgpack_io import read_msgpack

    field = "ema_params" if use_ema else "params"
    return dit_state_dict_from_jax(diffusion_state_field(read_msgpack(path), field, path),
                                   patch_size)


def load_diffusion_checkpoint(path: str, patch_size: int, use_ema: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """A JAX state_*.msgpack (diffusion_state_dict_from_msgpack) or a torch
    file (load_torch_diffusion_state_dict) as a reference-named state_dict."""
    if path.endswith(".msgpack"):
        return diffusion_state_dict_from_msgpack(path, patch_size, use_ema)
    return load_torch_diffusion_state_dict(path, use_ema)


def load_diffusion_state_dict(model: nn.Module, sd: Dict[str, Any]) -> None:
    """Load a reference-named DiT/Latte/LatteT2V state_dict into the port's
    model, strictly, but for the fixed sin-cos tables (pos_embed,
    temp_embed; LatteT2V's pos_embed.pos_embed), which the model
    recomputes."""
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()
                           if k not in ("pos_embed", "temp_embed", "pos_embed.pos_embed")})
