"""Weights from the JAX package's variable tree to the port's state_dict.

`state_dict_from_jax(variables, model)` takes a flax variable tree (the
collections "params", "buffers" and "batch_stats") as nested dicts of numpy
arrays (the caller converts the JAX arrays; this package never imports
JAX) and returns a state_dict for `model`: the tokenizer, a discriminator
or LPIPS. The port names its submodules after the flax scopes, so a key is
the flax path joined by dots, with these renames of the last element:

    kernel            -> weight, (in, out) transposed to nn.Linear's (out, in);
                         a conv's (*k, in, out) to (out, in, *k)
    <name>_kernel     -> <name>.weight, transposed as a dense kernel
    dsconv_kernel     -> dsconv.weight, (3, 3, 3, 1, d) -> (d, 1, 3, 3, 3)
    dsconv_bias       -> dsconv.bias

`load_train_state_from_jax` fills a trainer state (training/trainer.py)
from the JAX trainer's: the generator's params and codebook buffers, the
discriminators' params and BatchNorm statistics, the LPIPS params and the
step. The optimizer states are not mapped.

It is strict: a JAX leaf that maps to no port tensor, a port tensor left
unfilled, or a shape that disagrees raises.

`gpt_state_dict_from_jax(params)` turns the JAX LM's params (block{i}/query/
kernel, ...) into the state_dict of the port's GPT, whose modules carry the
reference's torch names (blocks.{i}.attn.query.weight, ...); it is strict in
the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


COLLECTIONS = ("params", "buffers", "batch_stats")


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
    unknown = set(variables) - set(COLLECTIONS)
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for collection in COLLECTIONS:
        for path, value in _leaves(variables.get(collection, {})):
            key, arr = _port_key(path, np.asarray(value))
            if key not in want:
                unused.append("/".join((collection,) + path))
                continue
            if tuple(arr.shape) != tuple(want[key].shape):
                raise ValueError(f"{key}: JAX shape {tuple(arr.shape)} "
                                 f"!= port shape {tuple(want[key].shape)}")
            out[key] = torch.tensor(np.array(arr), dtype=want[key].dtype)
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
        arr = np.asarray(value, np.float32)
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
        out[key] = torch.tensor(np.array(arr.T if path[-1] == "kernel" else arr))
    if unused:
        raise KeyError(f"JAX leaves with no port tensor: {unused}")
    n_layer = len({k.split(".")[1] for k in out if k.startswith("blocks.")})
    missing = sorted(gpt_keys(n_layer) - set(out))
    if missing:
        raise KeyError(f"port tensors left unfilled: {missing}")
    return out


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
        arr, scope, leaf = np.asarray(value, np.float32), path[:-1], path[-1]
        if scope == ("x_embed",):
            key = "x_embedder.proj"
            if leaf == "kernel":
                p = patch_size
                arr = arr.reshape(p, p, -1, arr.shape[-1]).transpose(3, 2, 0, 1)
        elif scope == ("y_embed", "table") and leaf == "embedding":
            out["y_embedder.embedding_table.weight"] = torch.tensor(arr)
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
        out[f"{key}.{'weight' if leaf == 'kernel' else 'bias'}"] = torch.tensor(np.array(arr))
    if unused:
        raise KeyError(f"JAX leaves with no port tensor: {unused}")
    return out


latte_state_dict_from_jax = dit_state_dict_from_jax


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


def load_diffusion_state_dict(model: nn.Module, sd: Dict[str, Any]) -> None:
    """Load a reference-named DiT/Latte state_dict into the port's model,
    strictly, but for the fixed sin-cos tables (pos_embed, temp_embed),
    which the model recomputes."""
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()
                           if k not in ("pos_embed", "temp_embed")})
