"""Tokenizer checkpoints (mirror of `omnitokenizer_tpu.utils.checkpoint`):
the released Lightning `.ckpt` files, the training loop's own
`checkpoints/step_*.pt`, `save_tokenizer_checkpoint`'s files, and the JAX
package's `.msgpack` files (its `save_tokenizer_checkpoint`'s variables
and its training loop's `step_*.msgpack` states).

A released checkpoint is a Lightning dict {"state_dict", "hyper_parameters":
{"args": argparse.Namespace}}. `config_from_args` reads the architecture from
that namespace with the reference's defaults for absent flags, and
`map_tokenizer_key` is the JAX package's map from a reference key to a flax
path and a layout transform. The port names its modules after the flax
scopes, so a reference key reaches a port key by composing that map with
`convert._port_key`; the two transposes cancel (a Linear weight goes
(out, in) -> flax (in, out) -> port (out, in), a depthwise PEG kernel
(d, 1, 3, 3, 3) -> (3, 3, 3, 1, d) -> (d, 1, 3, 3, 3)).

A `.msgpack` file is read as the JAX loader reads it: the config from its
`<path>.cfg.json` sidecar (or the caller's `cfg`), the generator's half
of a training state, and every leaf through `convert.state_dict_from_jax`
(strict both ways), read by `utils.msgpack_io` without flax.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TokenizerConfig
from ..convert import _port_key, state_dict_from_jax

# -- reading ------------------------------------------------------------------
def _split_lightning(ckpt: Dict[str, Any]) -> Tuple[Dict[str, np.ndarray], Any]:
    """A loaded Lightning dict (or a bare state_dict) -> (state_dict as
    numpy, the hparams' args namespace or None)."""
    args = None
    if "state_dict" in ckpt:
        sd = ckpt["state_dict"]
        hp = ckpt.get("hyper_parameters", {})
        if isinstance(hp, dict) and "args" in hp:
            args = hp["args"]
    else:
        sd = ckpt
    return ({k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
             for k, v in sd.items()}, args)


def load_torch_state_dict(path: str) -> Tuple[Dict[str, np.ndarray], Any]:
    """(state_dict as numpy, the hparams' args namespace or None). Loads with
    weights_only=False, as Lightning pickles an argparse Namespace."""
    return _split_lightning(torch.load(path, map_location="cpu", weights_only=False))


def config_from_args(args: Any) -> TokenizerConfig:
    """A reference argparse namespace -> TokenizerConfig, with the reference's
    defaults for the flags an older checkpoint lacks."""

    def get(name, default):
        return getattr(args, name, default)

    spatial_depth = get("spatial_depth", 4)
    return TokenizerConfig(
        embedding_dim=get("embedding_dim", 512),
        n_codes=get("n_codes", 8192),
        codebook_dim=get("codebook_dim", 8),
        resolution=get("resolution", 256),
        sequence_length=get("sequence_length", 17),
        image_channels=get("image_channels", 3),
        patch_embed=get("patch_embed", "linear"),
        patch_size=get("patch_size", 8),
        temporal_patch_size=get("temporal_patch_size", 2),
        defer_temporal_pool=get("defer_temporal_pool", False),
        defer_spatial_pool=get("defer_spatial_pool", False),
        enc_block=get("enc_block", "t" * spatial_depth),
        dec_block=get("dec_block", "t" * spatial_depth),
        spatial_depth=spatial_depth,
        temporal_depth=get("temporal_depth", 4),
        twod_window_size=get("twod_window_size", 4),
        spatial_pos=get("spatial_pos", "rel"),
        causal_in_temporal_transformer=get("causal_in_temporal_transformer", False),
        causal_in_peg=get("causal_in_peg", False),
        dim_head=get("dim_head", 64),
        heads=get("heads", 8),
        ff_mult=get("ff_mult", 4.0),
        norm_type=get("norm_type", "group"),
        gen_upscale=get("gen_upscale", None),
        use_vae=get("use_vae", False),
        l2_code=get("l2_code", False),
        use_external_codebook=get("use_external_codebook", False),
        no_random_restart=get("no_random_restart", False),
        restart_thres=get("restart_thres", 1.0),
        commitment_weight=get("commitment_weight", 0.25),
        kl_weight=get("kl_weight", 1e-6),
    )


# -- the key map ---------------------------------------------------------------
def _map_cnn_norm(base: List[str], leaf: str):
    """A Normalize (SyncBatchNorm or GroupNorm) of a cnn patch embed or
    to-pixels Sequential -> the flax path of its `norm`; the running
    statistics are batch_stats."""
    if leaf in ("weight", "bias"):
        return base + ["norm", "scale" if leaf == "weight" else "bias"], None
    if leaf in ("running_mean", "running_var"):
        return ["__batch_stats__"] + base + ["norm", leaf[len("running_"):]], None
    if leaf == "num_batches_tracked":
        return None, None
    raise KeyError(f"unmapped cnn-norm leaf {leaf}")


def _map_transformer_key(parts: List[str], block_str: str):
    """['layers', i, j, ...rest] inside a Transformer -> (flax path, transform)."""
    i, j, rest = int(parts[1]), parts[2], parts[3:]
    blk = block_str[i]
    if j == "0":  # PEG
        assert rest[0] == "dsconv"
        leaf = {"weight": "kernel", "bias": "bias"}[rest[1]]
        return [f"layers_{i}_peg", f"dsconv_{leaf}"], "dwconv" if rest[1] == "weight" else None
    if j == "1":  # self-attention, window attention, pooling or up
        base = f"layers_{i}_attn"
        if blk in ("l", "r"):  # the Linear of a pool or up block
            leaf = {"weight": "kernel", "bias": "bias"}[rest[-1]]
            return [base, "pool" if blk == "l" else "up", leaf], "T" if leaf == "kernel" else None
        if blk == "t":
            if rest[0] == "norm":
                return (None, None) if rest[1] == "beta" else ([base, "norm_gamma"], None)
            if rest[0] == "context_norm":
                return None, None  # unused in self-attention
            if rest[0] in ("to_q", "to_kv", "to_out"):
                return [base, f"{rest[0]}_kernel"], "T"
            if rest[0] in ("q_scale", "k_scale"):
                return [base, rest[0]], None
            if rest[0] == "spatial_rel_pos_bias":  # net.0.0 / net.1.0 / net.2
                layer = {"0": "net0", "1": "net1", "2": "net2"}[rest[2]]
                leaf = rest[-1]
                return ([base, "spatial_rel_pos_bias", layer,
                         {"weight": "kernel", "bias": "bias"}[leaf]],
                        "T" if leaf == "weight" else None)
        elif blk == "w":
            if rest[0] == "norm":
                return (None, None) if rest[1] == "beta" else ([base, "norm", "gamma"], None)
            if rest[0] == "relative_position_bias_table":
                return [base, "relative_position_bias_table"], None
            if rest[0] == "relative_position_index":
                return None, None  # a static buffer, recomputed
            if rest[0] in ("qkv", "proj"):
                leaf = {"weight": "kernel", "bias": "bias"}[rest[1]]
                return [base, rest[0], leaf], "T" if leaf == "kernel" else None
        raise KeyError(f"unmapped attention key {parts}")
    if j == "3":  # FeedForward Sequential: 0 LayerNorm, 1 Linear, 4 Linear
        sub, leaf = rest[0], rest[1]
        if sub == "0":
            return [f"layers_{i}_ff", f"norm_{leaf}"], None
        if sub == "1":
            return [f"layers_{i}_ff", "proj_in_kernel"], "T"
        if sub == "4":
            return [f"layers_{i}_ff", "proj_out_kernel"], "T"
    raise KeyError(f"unmapped transformer key {parts}")


def map_tokenizer_key(key: str, cfg: TokenizerConfig):
    """A reference state_dict key -> (flax path, or None to skip; transform)."""
    parts = key.split(".")
    root = parts[0]
    if root in ("image_discriminator", "video_discriminator", "perceptual_model"):
        return None, None
    if root == "codebook":
        name = parts[1]
        if name in ("embeddings", "N", "z_avg", "codebook_usage"):
            return ["__buffers__", "codebook", name], None
        return None, None
    if root in ("pre_vq_conv", "post_vq_conv"):  # Sequential: Rearrange, Linear, Rearrange
        leaf = {"weight": "kernel", "bias": "bias"}[parts[2]]
        return [root, leaf], "T" if leaf == "kernel" else None
    if root in ("encoder", "decoder"):
        sub = parts[1]
        if sub in ("to_patch_emb_first_frame", "to_patch_emb") and cfg.patch_embed == "cnn":
            idx, leaf = parts[2], parts[3]  # Sequential: 0 Conv3d, 1 Normalize, 2 Rearrange
            if idx == "0":
                return ([root, f"{sub}_conv", "kernel" if leaf == "weight" else "bias"],
                        "conv3d" if leaf == "weight" else None)
            if idx == "1":
                return _map_cnn_norm([root, f"{sub}_cnorm"], leaf)
        if sub in ("to_pixels_first_frame", "to_pixels") and cfg.patch_embed == "cnn":
            # Sequential: 0 Rearrange, 1 ConvTranspose3d (its torch layout kept), 2 Normalize
            idx, leaf = parts[2], parts[3]
            if idx == "1":
                return [root, f"{sub}_conv_{'kernel' if leaf == 'weight' else 'bias'}"], None
            if idx == "2":
                return _map_cnn_norm([root, f"{sub}_conv_cnorm"], leaf)
        if sub in ("to_patch_emb_first_frame", "to_patch_emb"):
            idx, leaf = parts[2], parts[3]
            if idx in ("1", "3"):  # the LayerNorms around the patch Linear
                return [root, f"{sub}_norm1" if idx == "1" else f"{sub}_norm2", leaf], None
            if idx == "2":  # the patch Linear
                return ([root, f"{sub}_proj", "kernel" if leaf == "weight" else "bias"],
                        "T" if leaf == "weight" else None)
        if sub in ("to_pixels_first_frame", "to_pixels"):
            leaf = {"weight": "kernel", "bias": "bias"}[parts[3]]
            return [root, sub, leaf], "T" if leaf == "kernel" else None
        if sub.endswith("_transformer"):
            block = cfg.enc_block if root == "encoder" else cfg.dec_block
            if "temporal" in sub:
                block = "t" * cfg.temporal_depth
            if parts[2] == "norm_out":
                return (None, None) if parts[3] == "beta" else (
                    [root, sub, "norm_out", "gamma"], None)
            path, tf = _map_transformer_key(parts[2:], block)
            return (None, None) if path is None else ([root, sub] + path, tf)
        if sub in ("temporal_pool", "spatial_pool", "temporal_up", "spatial_up"):
            return None, None  # parameter-free
    raise KeyError(f"unmapped tokenizer key: {key}")


def _flax_value(val: np.ndarray, tf: Optional[str]) -> np.ndarray:
    """The JAX converter's layout transform of a reference tensor."""
    if tf == "T":
        return val.T
    if tf in ("dwconv", "conv3d"):  # (out, in, kt, kh, kw) -> (kt, kh, kw, in, out)
        return np.transpose(val, (2, 3, 4, 1, 0))
    assert tf is None, tf
    return val


def port_key(key: str, val: np.ndarray, cfg: TokenizerConfig
             ) -> Tuple[Optional[str], Optional[np.ndarray]]:
    """A reference key and tensor -> (port state_dict key, tensor in the
    port's layout), or (None, None) for a key the tokenizer does not read."""
    path, tf = map_tokenizer_key(key, cfg)
    if path is None:
        return None, None
    if path[0] in ("__buffers__", "__batch_stats__"):
        path = path[1:]
    return _port_key(tuple(path), _flax_value(np.asarray(val, np.float32), tf))


# -- filling a port state_dict ---------------------------------------------------
def _fill(want: Dict[str, torch.Tensor], got: Dict[str, np.ndarray], strict: bool
          ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """`want` with the tensors of `got` (shape-checked, cast to want's
    dtype); returns it and the keys left at their init values."""
    out = dict(want)
    for key, val in got.items():
        if key not in want:
            continue  # a leaf the port's tree has not (the JAX merge drops it too)
        if tuple(val.shape) != tuple(want[key].shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint {tuple(val.shape)} "
                             f"vs model {tuple(want[key].shape)}")
        out[key] = torch.tensor(np.array(val), dtype=want[key].dtype)
    unfilled = sorted(k for k in want if k not in got)
    if unfilled and strict:
        raise KeyError(f"missing checkpoint values for {unfilled[:10]} "
                       f"(+{max(0, len(unfilled) - 10)} more)")
    return out, unfilled


def convert_tokenizer_state(sd: Dict[str, np.ndarray], cfg: TokenizerConfig,
                            template: Dict[str, torch.Tensor], strict: bool = False
                            ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A reference state_dict -> the port tokenizer's state_dict, starting
    from `template` (the net's own state_dict). With strict=False a key the
    checkpoint lacks keeps its template value (Lightning's strict=False) and
    is named in the returned list; strict=True raises on it and on a
    reference key the map does not know."""
    got: Dict[str, np.ndarray] = {}
    unmapped = []
    for key, val in sd.items():
        try:
            k, v = port_key(key, val, cfg)
        except KeyError:
            unmapped.append(key)
            continue
        if k is not None:
            got[k] = v
    if unmapped and strict:
        raise KeyError(f"unmapped reference keys: {unmapped[:10]} "
                       f"(+{max(0, len(unmapped) - 10)} more)")
    if "codebook.embeddings" in got:  # a loaded codebook is initialized
        for name in ("initialized", "call_cnt"):
            if f"codebook.{name}" in template:
                got[f"codebook.{name}"] = np.ones((), np.int32)
    return _fill(template, got, strict)


# -- the config sidecar ------------------------------------------------------------
def _cfg_sidecar_path(path: str) -> str:
    return path + ".cfg.json"


def config_to_json(cfg: TokenizerConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).replace("torch.", "")
    return d


def config_from_json(d: dict) -> TokenizerConfig:
    d = dict(d)
    d["dtype"] = getattr(torch, d.get("dtype", "float32"))
    return TokenizerConfig(**d)


# -- top level ------------------------------------------------------------------------
def load_tokenizer_checkpoint(path: str, cfg: Optional[TokenizerConfig] = None,
                              strict: bool = False):
    """-> (cfg, OmniTokenizerNet on the CPU, the keys left at init values).

    Reads a reference Lightning `.ckpt` (or a bare reference state_dict), the
    training loop's `checkpoints/step_*.pt` (its generator half, "net"), a
    `save_tokenizer_checkpoint` file, or a JAX `.msgpack` (variables or a
    training state). Without `cfg` the architecture comes from the Lightning
    hparams or from the `<path>.cfg.json` sidecar."""
    from ..models.tokenizer import OmniTokenizerNet, init_weights

    if path.endswith(".msgpack"):
        return load_jax_tokenizer_checkpoint(path, cfg)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    native = "net" in ckpt  # the port's own keys
    sd, args = ({k: v.numpy() for k, v in ckpt["net"].items()}, None) if native else (
        _split_lightning(ckpt))
    if cfg is None and os.path.exists(_cfg_sidecar_path(path)):
        with open(_cfg_sidecar_path(path)) as f:
            cfg = config_from_json(json.load(f))
    if cfg is None:
        if args is None:
            raise ValueError(f"{path} carries no config (no hparams, no .cfg.json sidecar): "
                             "pass cfg")
        cfg = config_from_args(args)

    net = OmniTokenizerNet(cfg)
    init_weights(net, torch.Generator().manual_seed(0))
    template = net.state_dict()
    if native:
        state, unfilled = _fill(template, sd, strict)
    else:
        state, unfilled = convert_tokenizer_state(sd, cfg, template, strict=strict)
    net.load_state_dict(state)
    return cfg, net, unfilled


def load_jax_tokenizer_checkpoint(path: str, cfg: Optional[TokenizerConfig] = None):
    """-> (cfg, OmniTokenizerNet on the CPU, []) from a JAX `.msgpack`, as
    the JAX package's load_tokenizer_checkpoint reads it
    (`omnitokenizer_tpu/utils/checkpoint.py:374-391`): the config from the
    sidecar unless given, and a training state's generator half (params_g,
    buffers). Every tensor comes from the file: a leaf with no port tensor or
    a port tensor the file lacks raises."""
    from ..models.tokenizer import OmniTokenizerNet
    from .msgpack_io import read_msgpack

    if cfg is None and os.path.exists(_cfg_sidecar_path(path)):
        with open(_cfg_sidecar_path(path)) as f:
            cfg = config_from_json(json.load(f))
    if cfg is None:
        raise ValueError(f"{path}: a JAX msgpack checkpoint without a .cfg.json sidecar "
                         "needs an explicit config (pass cfg)")
    raw = read_msgpack(path)
    if not isinstance(raw, dict):
        raise KeyError(f"{path}: a {type(raw).__name__}, not a tree of variables")
    if "params_g" in raw:  # a training state (training/loop.save_state): its generator
        raw = {"params": raw["params_g"], "buffers": raw["buffers"]}
    net = OmniTokenizerNet(cfg)
    try:
        net.load_state_dict(state_dict_from_jax(raw, net))
    except (KeyError, ValueError) as e:
        raise type(e)(f"{path}: {e}") from None
    return cfg, net, []


def save_tokenizer_checkpoint(path: str, net: torch.nn.Module,
                              cfg: Optional[TokenizerConfig] = None) -> None:
    """torch.save of {"net": the tokenizer's state_dict}; with `cfg`, a JSON
    sidecar (<path>.cfg.json) makes the file self-describing, as the
    hparams of a Lightning checkpoint do."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"net": {k: v.detach().cpu() for k, v in net.state_dict().items()}}, path)
    if cfg is not None:
        with open(_cfg_sidecar_path(path), "w") as f:
            json.dump(config_to_json(cfg), f, indent=1)
