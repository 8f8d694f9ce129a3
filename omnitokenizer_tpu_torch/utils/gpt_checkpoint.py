"""The reference's GPT checkpoints (mirror of
`omnitokenizer_tpu.utils.gpt_checkpoint`).

A Net2Net Lightning checkpoint holds the GPT under the prefix
"transformer." beside the tokenizer; a bare minGPT state_dict has no
prefix. The port's GPT carries the reference's torch names
(tok_emb.weight, pos_emb, blocks.{i}.{ln1,ln2}.{weight,bias},
blocks.{i}.attn.{key,query,value,proj}.{weight,bias},
blocks.{i}.mlp.{0,2}.{weight,bias}, ln_f.{weight,bias}, head.weight), so a
checkpoint loads with no key map and no transpose.

The JAX package's own `.msgpack` GPT files (transformer_train's
`step_*.msgpack`, the tuple (params, opt_state, step), stored as a dict
keyed '0', '1', '2') are read without flax (`utils.msgpack_io`): the
params, entry '0', through `convert.gpt_state_dict_from_jax`. The
optimizer state is not read. A pipeline-parallel run's params (the JAX
CLI's --pipeline_stages) are {"stacked": the blocks' tree with a leading
(n_layer,) axis on every leaf, "rest": the embeddings, ln_f and head}:
they are unstacked into block0 .. block{n_layer - 1} first.
"""

from __future__ import annotations

import re
from typing import Dict

import torch

from ..convert import gpt_keys, gpt_state_dict_from_jax
from .checkpoint import load_torch_state_dict

PREFIX = "transformer."


def gpt_state_dict_from_reference(sd: Dict) -> Dict[str, torch.Tensor]:
    """A reference state_dict (numpy or torch values), with or without the
    Net2Net prefix -> the port GPT's state_dict in f32. With the prefix,
    only the prefixed keys are the GPT's; keys the GPT has no tensor for
    (the tokenizer's, minGPT's causal-mask buffers) are left out. A GPT
    tensor the file lacks raises."""
    if any(k.startswith(PREFIX) for k in sd):
        sd = {k[len(PREFIX):]: v for k, v in sd.items() if k.startswith(PREFIX)}
    blocks = {int(m.group(1)) for k in sd for m in [re.match(r"blocks\.(\d+)\.", k)] if m}
    want = gpt_keys(max(blocks) + 1 if blocks else 0)
    missing = sorted(want - set(sd))
    if missing:
        raise KeyError(f"GPT tensors not in the checkpoint: {missing}")
    keep = want | ({"vtokens_pos_emb"} & set(sd))
    return {k: torch.as_tensor(sd[k]).float().clone() for k in sorted(keep)}


def gpt_state_dict_from_msgpack(path: str) -> Dict[str, torch.Tensor]:
    """A JAX transformer_train `.msgpack` -> the port GPT's state_dict."""
    from .msgpack_io import read_msgpack

    raw = read_msgpack(path)
    params = raw.get("0") if isinstance(raw, dict) else None
    if isinstance(params, dict) and {"stacked", "rest"} <= set(params):
        params = unstack_jax_pipeline(params["stacked"], params["rest"])
    if not isinstance(params, dict):
        have = sorted(raw) if isinstance(raw, dict) else type(raw).__name__
        raise KeyError(f"{path}: not the JAX LM's (params, opt_state, step) tuple: entry '0' "
                       f"is no params tree (the file has {have})")
    try:
        return gpt_state_dict_from_jax(params)
    except KeyError as e:
        raise KeyError(f"{path}: {e}") from None


def unstack_jax_pipeline(stacked: Dict, rest: Dict) -> Dict:
    """The JAX pipeline layout -> the plain JAX GPT tree (block{i} = every
    stacked leaf's row i, beside the rest), as pp.unstack_block_params."""
    def leaves(t):
        return [x for v in t.values() for x in (leaves(v) if isinstance(v, dict) else [v])]

    def row(t, i):
        return {k: row(v, i) if isinstance(v, dict) else v[i] for k, v in t.items()}

    n_layer = len(leaves(stacked)[0])
    out = dict(rest)
    out.update({f"block{i}": row(stacked, i) for i in range(n_layer)})
    return out


def load_gpt_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference Lightning GPT checkpoint (or a bare state_dict), or a JAX
    `.msgpack` -> the port GPT's state_dict, for GPT.load_state_dict."""
    if path.endswith(".msgpack"):
        return gpt_state_dict_from_msgpack(path)
    sd, _ = load_torch_state_dict(path)
    return gpt_state_dict_from_reference(sd)
