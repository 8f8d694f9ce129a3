"""Weight inflation, cross-stage surgery and the discriminators' key map
(mirror of `omnitokenizer_tpu.utils.inflate`; the reference's
utils.py:11-121 and vqgan_train.py:36-99).

The transforms work on reference-named state_dicts of numpy arrays before
any conversion, so they stay the reference recipes' byte for byte. A
discriminator's keys go to the flax names of the JAX converter and from
there to the port's modules (`convert._port_key`), which carry those
names. `load_pretrained_into_state` also reads the port's own `.pt` files
and the JAX package's `.msgpack` files, without inflation.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..convert import _leaves, _np, _port_key


def inflate_gen(sd: Dict[str, np.ndarray], temporal_patch_size: int,
                strategy: str = "average") -> Dict[str, np.ndarray]:
    """image-stage -> video-stage generator inflation (utils.py:11-75):
    build to_patch_emb.* / to_pixels.0.* from the first-frame versions by
    tiling across the temporal patch ('average' divides by pt, 'first'
    zero-pads the non-leading slots)."""
    out = dict(sd)
    pt = temporal_patch_size

    pe0_w = sd["encoder.to_patch_emb_first_frame.1.weight"]
    pe0_b = sd["encoder.to_patch_emb_first_frame.1.bias"]
    pe1_w = sd["encoder.to_patch_emb_first_frame.2.weight"]
    pe1_b = sd["encoder.to_patch_emb_first_frame.2.bias"]
    pe2_w = sd["encoder.to_patch_emb_first_frame.3.weight"]
    pe2_b = sd["encoder.to_patch_emb_first_frame.3.bias"]
    pd0_w = sd["decoder.to_pixels_first_frame.0.weight"]
    pd0_b = sd["decoder.to_pixels_first_frame.0.bias"]

    if strategy == "average":
        tile0 = lambda t: np.concatenate([t / pt] * pt, axis=0)
        tile1 = lambda t: np.concatenate([t / pt] * pt, axis=-1)
    elif strategy == "first":
        tile0 = lambda t: np.concatenate([t] + [np.zeros_like(t)] * (pt - 1), axis=0)
        tile1 = lambda t: np.concatenate([t] + [np.zeros_like(t)] * (pt - 1), axis=-1)
    else:
        raise NotImplementedError(strategy)

    out["encoder.to_patch_emb.1.weight"] = tile0(pe0_w)
    out["encoder.to_patch_emb.1.bias"] = tile0(pe0_b)
    out["encoder.to_patch_emb.2.weight"] = tile1(pe1_w)  # (dim, in) cat on in
    out["encoder.to_patch_emb.2.bias"] = pe1_b
    out["encoder.to_patch_emb.3.weight"] = pe2_w
    out["encoder.to_patch_emb.3.bias"] = pe2_b
    out["decoder.to_pixels.0.weight"] = tile0(pd0_w)  # (out, dim) cat on out
    out["decoder.to_pixels.0.bias"] = tile0(pd0_b)
    return out


def inflate_dis(sd: Dict[str, np.ndarray], strategy: str = "center",
                kt: int = 4) -> Dict[str, np.ndarray]:
    """2D image discriminator -> 3D video discriminator (utils.py:78-121):
    conv kernels (O,I,K,K) -> (O,I,kt,K,K) by 'average' tiling or placing the
    2D kernel at one temporal slot."""
    out = {k: v for k, v in sd.items() if "video_discriminator" not in k}
    for k, v in sd.items():
        if not k.startswith("image_discriminator"):
            continue
        nk = "video_discriminator" + k[len("image_discriminator"):]
        if "weight" in k and v.ndim == 4:
            if strategy == "average":
                nv = np.repeat(v[:, :, None], kt, axis=2) / kt
            else:
                slot = {"center": 1, "first": 0, "last": kt - 1}[strategy]
                nv = np.zeros((v.shape[0], v.shape[1], kt, v.shape[2], v.shape[3]),
                              v.dtype)
                nv[:, :, slot] = v
            out[nk] = nv
        else:
            out[nk] = v
    return out


# --------------------------------------------------------------------------
# discriminator torch -> flax conversion
# --------------------------------------------------------------------------

def convert_discriminator_state(
    sd: Dict[str, np.ndarray], prefix: str, n_layers: int = 3, is_3d: bool = False,
):
    """Map `prefix`.model{n}.{i}.* to the flax NLayerDiscriminator tree.

    Torch Sequential layouts (base.py:450-542): block0 [conv, act]; middle
    blocks [blur/id, conv, norm, act]; penultimate [conv, norm, act]; final
    2D [conv] / 3D [conv, norm, act].  Conv kernels (O,I,*K) -> (*K,I,O).
    """
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, name, leaf, val):
        tree.setdefault(name, {})[leaf] = val

    def conv_kernel(v):
        if is_3d:
            return np.transpose(v, (2, 3, 4, 1, 0))
        return np.transpose(v, (2, 3, 1, 0))

    n_blocks = n_layers + 2
    for k, v in sd.items():
        if not k.startswith(prefix + "."):
            continue
        rest = k[len(prefix) + 1:]
        v = np.asarray(v, np.float32)
        if rest.startswith("noise."):
            params["noise"] = {"weight": v}
            continue
        parts = rest.split(".")
        block = int(parts[0][len("model"):])
        idx = int(parts[1])
        leaf = parts[2]
        # which sub-layer is the conv / norm for this block?
        if block == 0:
            conv_idx, norm_idx = 0, None
        elif block < n_layers:
            conv_idx, norm_idx = 1, 2
        elif block == n_layers:
            conv_idx, norm_idx = 0, 1
        else:  # final block
            conv_idx, norm_idx = 0, (1 if is_3d else None)

        if idx == conv_idx:
            if leaf == "weight":
                put(params, f"model{block}_conv", "kernel", conv_kernel(v))
            else:
                put(params, f"model{block}_conv", "bias", v)
        elif norm_idx is not None and idx == norm_idx:
            name = f"model{block}_norm"
            if leaf == "weight":
                params.setdefault(name, {}).setdefault("norm", {})["scale"] = v
            elif leaf == "bias":
                params.setdefault(name, {}).setdefault("norm", {})["bias"] = v
            elif leaf == "running_mean":
                stats.setdefault(name, {}).setdefault("norm", {})["mean"] = v
            elif leaf == "running_var":
                stats.setdefault(name, {}).setdefault("norm", {})["var"] = v
            # num_batches_tracked dropped
    return params, stats


# --------------------------------------------------------------------------
# the pretrained load with its surgery (the reference's vqgan_train.py:36-99)
# --------------------------------------------------------------------------

def _merge_partial(module: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Overwrite the tensors of `module` that the flax tree `tree` holds
    (shape-checked); the rest keep their values."""
    want = module.state_dict()
    for path, value in _leaves(tree):
        key, arr = _port_key(path, _np(value))
        if key not in want:
            raise KeyError(f"{'/'.join(path)} has no tensor in {type(module).__name__}")
        if tuple(arr.shape) != tuple(want[key].shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(want[key].shape)}")
        want[key] = torch.tensor(np.array(arr), dtype=want[key].dtype)
    module.load_state_dict(want)


def _vq_head_mismatch(cfg, rows: Optional[int]) -> bool:
    """A VAE's pre-VQ projection has 2 * codebook_dim outputs (the
    posterior's mean and log-variance); a VQ stage's has codebook_dim, and
    cannot seed it (the reference's vqgan_train.py:57-59)."""
    return cfg.use_vae and rows is not None and rows != 2 * cfg.codebook_dim


def _load_reference(trainer, state, sd, init_vgen, init_vdis, no_init_idis) -> None:
    """The reference recipe's load: inflation, the VAE's head, the
    discriminators, from a reference-named state_dict of numpy arrays."""
    from .checkpoint import convert_tokenizer_state

    cfg = trainer.cfg
    if init_vgen and init_vgen != "keep":
        sd = inflate_gen(sd, cfg.temporal_patch_size, strategy=init_vgen)
    if init_vdis and init_vdis != "keep":
        sd = inflate_dis(sd, strategy=init_vdis)
    w = sd.get("pre_vq_conv.1.weight")
    if _vq_head_mismatch(cfg, None if w is None else w.shape[0]):
        sd = {k: v for k, v in sd.items() if not k.startswith("pre_vq_conv.1.")}

    net_sd, _ = convert_tokenizer_state(sd, cfg, state.net.state_dict(), strict=False)
    state.net.load_state_dict(net_sd)
    n_layers = trainer.loss_cfg.disc_layers
    for on, prefix, disc, is_3d in ((not no_init_idis, "image_discriminator",
                                     state.image_disc, False),
                                    (init_vdis is not None, "video_discriminator",
                                     state.video_disc, True)):
        if on:
            params, stats = convert_discriminator_state(sd, prefix, n_layers, is_3d=is_3d)
            if params:  # the running statistics sit beside the parameters
                _merge_partial(disc, params)
                _merge_partial(disc, stats)


def _load_port(trainer, state, ckpt, no_init_idis, init_vdis) -> None:
    """A port checkpoint ({"net": ..., ["image_disc", "video_disc"]}: the
    training loop's step_*.pt or save_tokenizer_checkpoint's file), in the
    port's own keys."""
    from .checkpoint import _fill

    net = {k: v.numpy() for k, v in ckpt["net"].items()}
    w = net.get("pre_vq_conv.weight")
    if _vq_head_mismatch(trainer.cfg, None if w is None else w.shape[0]):
        net = {k: v for k, v in net.items() if not k.startswith("pre_vq_conv.")}
    state.net.load_state_dict(_fill(state.net.state_dict(), net, strict=False)[0])
    for on, name in ((not no_init_idis, "image_disc"), (init_vdis is not None, "video_disc")):
        if on and name in ckpt:
            getattr(state, name).load_state_dict(ckpt[name])


def _load_jax(trainer, state, raw, no_init_idis, init_vdis) -> None:
    """A JAX package msgpack: a training state (params_g, buffers, params_d,
    batch_stats_d) or a tokenizer's variables."""
    if "params_g" in raw:
        net = {"params": raw["params_g"], "buffers": raw.get("buffers", {})}
        discs = {w: (raw["params_d"][w], raw["batch_stats_d"].get(w, {}))
                 for w in ("image", "video")}
    else:
        net, discs = raw, {}
    params = dict(net["params"])
    head = params.get("pre_vq_conv", {}).get("kernel")
    if _vq_head_mismatch(trainer.cfg, None if head is None else head.shape[-1]):
        params.pop("pre_vq_conv")
    _merge_partial(state.net, params)
    for collection in ("buffers", "batch_stats"):
        tree = net.get(collection) or {}
        if trainer.cfg.use_vae:  # a VQ stage's codebook: a VAE has none
            tree = {k: v for k, v in tree.items() if k != "codebook"}
        _merge_partial(state.net, tree)
    for on, which in ((not no_init_idis, "image"), (init_vdis is not None, "video")):
        if on and which in discs:
            params_d, stats_d = discs[which]
            disc = getattr(state, f"{which}_disc")
            _merge_partial(disc, params_d)
            _merge_partial(disc, stats_d)


def load_pretrained_into_state(trainer, path: str, init_vgen: Optional[str] = None,
                               init_vdis: Optional[str] = None, no_init_idis: bool = False,
                               seed: int = 0):
    """A TokenizerTrainState seeded from a (possibly image-stage) checkpoint,
    with the reference's cross-stage surgery:
      * init_vgen 'average'/'first': inflate the patch-embed and to-pixels
        weights to the current temporal_patch_size; 'keep': as they are;
      * init_vdis 'center'/'average'/'first'/'last': inflate the 2D
        discriminator into the 3D one; 'keep': the checkpoint's video
        discriminator; None: a fresh one;
      * a VAE seeded from a VQ stage (the recipe's stage 3): the VQ stage's
        pre_vq_conv (codebook_dim outputs, not the posterior's
        2 * codebook_dim) and its codebook are dropped, and the VAE's head
        keeps its init values.
    The checkpoint is a reference Lightning `.ckpt` (or a bare reference
    state_dict), as the JAX package reads it, or, beyond the JAX package, a
    port `.pt` or a JAX package `.msgpack` (a training state or a
    tokenizer's variables), whose keys are no reference's: those two take
    init_vgen and init_vdis None or 'keep' (the inflations read reference
    names). Tensors the checkpoint lacks keep their init values from
    `seed`."""
    from .checkpoint import _split_lightning

    state = trainer.init_state(seed=seed)
    if path.endswith(".msgpack"):
        from .msgpack_io import read_msgpack

        ckpt, kind = read_msgpack(path), "jax"
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        kind = "port" if "net" in ckpt else "reference"
    if kind == "reference":
        _load_reference(trainer, state, _split_lightning(ckpt)[0], init_vgen, init_vdis,
                        no_init_idis)
        return state
    inflate = [f"{n}={v}" for n, v in (("init_vgen", init_vgen), ("init_vdis", init_vdis))
               if v not in (None, "keep")]
    if inflate:
        raise ValueError(f"{path}: {', '.join(inflate)} inflates a reference-named state_dict "
                         "(a Lightning .ckpt); a port .pt or a JAX .msgpack takes None or 'keep'")
    load = _load_jax if kind == "jax" else _load_port
    load(trainer, state, ckpt, no_init_idis, init_vdis)
    return state
