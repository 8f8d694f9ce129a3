"""Weight inflation, cross-stage surgery and the discriminators' key map
(mirror of `omnitokenizer_tpu.utils.inflate`; the reference's
utils.py:11-121 and vqgan_train.py:36-99).

The transforms work on reference-named state_dicts of numpy arrays before
any conversion, so they stay the reference recipes' byte for byte. A
discriminator's keys go to the flax names of the JAX converter and from
there to the port's modules (`convert._port_key`), which carry those
names.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..convert import _leaves, _port_key


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
        key, arr = _port_key(path, np.asarray(value))
        if key not in want:
            raise KeyError(f"{'/'.join(path)} has no tensor in {type(module).__name__}")
        if tuple(arr.shape) != tuple(want[key].shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(want[key].shape)}")
        want[key] = torch.tensor(np.array(arr), dtype=want[key].dtype)
    module.load_state_dict(want)


def load_pretrained_into_state(trainer, path: str, init_vgen: Optional[str] = None,
                               init_vdis: Optional[str] = None, no_init_idis: bool = False,
                               seed: int = 0):
    """A TokenizerTrainState seeded from a (possibly image-stage) reference
    checkpoint, with the reference's cross-stage surgery:
      * init_vgen 'average'/'first': inflate the patch-embed and to-pixels
        weights to the current temporal_patch_size; 'keep': as they are;
      * init_vdis 'center'/'average'/'first'/'last': inflate the 2D
        discriminator into the 3D one; 'keep': the checkpoint's video
        discriminator; None: a fresh one.
    Tensors the checkpoint lacks keep their init values from `seed`. (The
    JAX function's VAE case, which drops a VQ-stage pre_vq_conv, is not here:
    the port's trainer does not train a VAE.)"""
    from .checkpoint import convert_tokenizer_state, load_torch_state_dict

    cfg = trainer.cfg
    sd, _ = load_torch_state_dict(path)
    if init_vgen and init_vgen != "keep":
        sd = inflate_gen(sd, cfg.temporal_patch_size, strategy=init_vgen)
    if init_vdis and init_vdis != "keep":
        sd = inflate_dis(sd, strategy=init_vdis)

    state = trainer.init_state(seed=seed)
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
    return state
