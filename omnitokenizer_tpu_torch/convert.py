"""Weights from the JAX package's variable tree to the port's state_dict.

`state_dict_from_jax(variables, model)` takes the flax {"params", "buffers"}
tree as nested dicts of numpy arrays (the caller converts the JAX arrays;
this package never imports JAX) and returns a state_dict for `model`. The
port names its submodules after the flax scopes, so a key is the flax path
joined by dots, with these renames of the last element:

    kernel            -> weight, (in, out) transposed to nn.Linear's (out, in)
    <name>_kernel     -> <name>.weight, transposed the same way
    dsconv_kernel     -> dsconv.weight, (3, 3, 3, 1, d) -> (d, 1, 3, 3, 3)
    dsconv_bias       -> dsconv.bias

It is strict: a JAX leaf that maps to no port tensor, a port tensor left
unfilled, or a shape that disagrees raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


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
    if last == "kernel":
        return ".".join(scope + ["weight"]), value.T
    if last.endswith("_kernel"):
        return ".".join(scope + [last[:-len("_kernel")], "weight"]), value.T
    return ".".join(path), value


def state_dict_from_jax(variables: Dict[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """flax variables (nested dicts of numpy arrays) -> `model`'s state_dict."""
    unknown = set(variables) - {"params", "buffers"}
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for collection in ("params", "buffers"):
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
