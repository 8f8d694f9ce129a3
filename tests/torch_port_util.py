"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: a small config for both sides, the flax -> numpy tree, and a
small GPT with random weights on both sides."""

from __future__ import annotations

import os

import jax
import numpy as np
import torch

from omnitokenizer_tpu.config import TokenizerConfig as JaxConfig
from omnitokenizer_tpu_torch.config import TokenizerConfig as TorchConfig

# 2 spatial blocks (one 't', one 'w'), 2 temporal, width 64, 2 heads of 32,
# a 4x4 token grid with 2x2 windows, 64 codes
SMALL = dict(embedding_dim=64, n_codes=64, resolution=32, sequence_length=5,
             patch_size=8, temporal_patch_size=2, enc_block="tw", dec_block="tt",
             spatial_depth=2, temporal_depth=2, twod_window_size=2, heads=2,
             dim_head=32)


def configs(**kw):
    """The same small f32 config for the JAX package and the port."""
    jcfg = JaxConfig(**SMALL, **kw)
    tcfg = TorchConfig(**SMALL, **kw)
    return jcfg, tcfg


def to_numpy_tree(variables) -> dict:
    """flax variables -> nested dicts of numpy arrays."""
    if hasattr(variables, "items"):
        return {k: to_numpy_tree(v) for k, v in variables.items()}
    return np.asarray(jax.device_get(variables))


def torch_f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def reference_state_dict(cfg, seed: int = 0) -> dict:
    """A state_dict in the reference's key scheme for `cfg` (the keys and
    shapes of tests/test_checkpoint.py's synthetic_torch_state_dict), with
    random values at a trained model's scales: LeCun-normal weights, norms
    and scales near 1, small biases, an N(0, 1) codebook."""
    from test_checkpoint import synthetic_torch_state_dict

    rng = np.random.RandomState(seed)
    sd = synthetic_torch_state_dict(cfg)
    if cfg.use_vae:  # the posterior's mean and log-variance
        d = cfg.embedding_dim
        sd["pre_vq_conv.1.weight"] = np.zeros((2 * cfg.codebook_dim, d), np.float32)
        sd["pre_vq_conv.1.bias"] = np.zeros((2 * cfg.codebook_dim,), np.float32)
    out = {}
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if v.dtype != np.float32 or leaf in ("beta", "N", "codebook_usage", "z_avg"):
            out[k] = v
        elif leaf == "embeddings":
            out[k] = rng.standard_normal(v.shape)
        elif v.ndim >= 2:  # Linear and depthwise conv weights, bias tables
            fan_in = int(np.prod(v.shape[1:])) if "bias_table" not in k else 50
            out[k] = rng.standard_normal(v.shape) / np.sqrt(fan_in)
        elif leaf in ("weight", "gamma", "q_scale", "k_scale"):
            out[k] = 1 + 0.1 * rng.standard_normal(v.shape)
        else:
            out[k] = 0.02 * rng.standard_normal(v.shape)
        out[k] = np.asarray(out[k], v.dtype)
    if "codebook.embeddings" in out:
        out["codebook.z_avg"] = out["codebook.embeddings"].copy()
    return out


def write_lightning_ckpt(path, sd: dict, **hparams) -> None:
    """A Lightning-style checkpoint: the state_dict and the argparse
    Namespace of the run under hyper_parameters.args."""
    import argparse

    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "hyper_parameters": {"args": argparse.Namespace(**hparams)}}, str(path))


# tests/test_gpt.py's size: vocab 50, block 24, 2 layers, 2 heads, width 32
GPT_SMALL = dict(vocab_size=50, block_size=24, n_layer=2, n_head=2, n_embd=32)


def gpt_configs(**kw):
    """The same small f32 GPT config for the JAX package and the port."""
    from omnitokenizer_tpu.config import GPTConfig as JaxGPTConfig
    from omnitokenizer_tpu_torch.config import GPTConfig as TorchGPTConfig

    args = {**GPT_SMALL, **kw}
    return JaxGPTConfig(**args), TorchGPTConfig(**args)


def _init_shapes(init, shapes_only: bool) -> dict:
    """The params of `init()`, as numpy arrays, or with shapes_only as
    jax.eval_shape's abstract leaves (no init runs, which is much faster for
    a wide model; the dicts then come in sorted key order, so the same seed
    fills other values than the concrete init's order does)."""
    if shapes_only:
        return jax.eval_shape(init)["params"]
    return to_numpy_tree(init()["params"])


def random_gpt_params(jcfg, seed: int = 0, shapes_only: bool = False, **vtokens) -> dict:
    """The JAX GPT's param tree (nested dicts of numpy arrays) with random
    values from a numpy seed: kernels and embeddings LeCun-normal, LayerNorm
    scales near 1, small biases, position tables N(0, 0.5) so that a wrong
    position shows. `vtokens` are GPT's vtokens_* fields; see _init_shapes
    for `shapes_only`."""
    from omnitokenizer_tpu.models.gpt import GPT as JaxGPT

    idx = jax.numpy.zeros((1, 4), jax.numpy.int32)
    cbox = jax.numpy.zeros((1, 4), jax.numpy.int32) if vtokens else None
    shapes = _init_shapes(lambda: JaxGPT(jcfg, **vtokens).init(jax.random.PRNGKey(0), idx,
                                                               cbox=cbox), shapes_only)
    rng = np.random.RandomState(seed)

    def fill(path, v):
        if isinstance(v, dict):
            return {k: fill(path + (k,), x) for k, x in v.items()}
        leaf = path[-1]
        if leaf in ("pos_emb", "vtokens_pos_emb"):
            out = 0.5 * rng.standard_normal(v.shape)
        elif leaf == "scale":
            out = 1 + 0.1 * rng.standard_normal(v.shape)
        elif leaf == "bias":
            out = 0.05 * rng.standard_normal(v.shape)
        elif leaf == "embedding":
            out = rng.standard_normal(v.shape)
        else:  # a Dense kernel (in, out)
            out = rng.standard_normal(v.shape) / np.sqrt(v.shape[0])
        return np.asarray(out, np.float32)

    return fill((), shapes)


def gpt_pair(seed: int = 0, vtokens: dict = None, **kw):
    """(JAX config, JAX params as jnp arrays, port config, port GPT in f32 on
    the CPU) holding the same random weights."""
    from omnitokenizer_tpu_torch.convert import gpt_state_dict_from_jax
    from omnitokenizer_tpu_torch.models.gpt import GPT

    jcfg, tcfg = gpt_configs(**kw)
    params = random_gpt_params(jcfg, seed, **(vtokens or {}))
    gpt = GPT(tcfg, **(vtokens or {}))
    gpt.load_state_dict(gpt_state_dict_from_jax(params))
    return jcfg, jax.tree_util.tree_map(jax.numpy.asarray, params), tcfg, gpt.eval()


# tests/test_dit_latte.py's sizes: DiT at width 32, 2 blocks of 2 heads, an 8x8
# latent in 4 channels, 10 classes; Latte the same with 4 blocks over 3 frames
DIT_SMALL = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=2,
                 num_heads=2, num_classes=10)
LATTE_SMALL = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=4,
                   num_heads=2, num_frames=3, num_classes=10, extras=2)


def random_diffusion_params(jax_model, example_args: tuple, seed: int = 0,
                            shapes_only: bool = False, **init_kw) -> dict:
    """A JAX DiT's or Latte's param tree (nested dicts of numpy arrays) with
    every tensor random from a numpy seed, the adaLN-Zero ones included (the
    JAX init zeroes them, and a model that outputs 0 compares nothing):
    kernels N(0, 1/fan_in), biases N(0, 0.05^2), embedding tables N(0, 1)."""
    shapes = _init_shapes(lambda: jax_model.init(jax.random.PRNGKey(0), *example_args,
                                                 **init_kw), shapes_only)
    rng = np.random.RandomState(seed)

    def fill(path, v):
        if isinstance(v, dict):
            return {k: fill(path + (k,), x) for k, x in v.items()}
        if path[-1] == "bias":
            out = 0.05 * rng.standard_normal(v.shape)
        elif path[-1] == "embedding":
            out = rng.standard_normal(v.shape)
        else:  # a Dense kernel (in, out)
            out = rng.standard_normal(v.shape) / np.sqrt(v.shape[0])
        return np.asarray(out, np.float32)

    return fill((), shapes)


def reference_diffusion_state_dict(cfg, latte: bool = False, seed: int = 0) -> dict:
    """A state_dict in the reference torch DiT's (or Latte's) key scheme,
    pos_embed (and temp_embed) included, random numpy values."""
    rng = np.random.RandomState(seed)
    D, p, C = cfg.hidden_size, cfg.patch_size, cfg.in_channels
    out_c = 2 * C if cfg.learn_sigma else C
    shapes = {"x_embedder.proj.weight": (D, C, p, p), "x_embedder.proj.bias": (D,),
              "t_embedder.mlp.0.weight": (D, 256), "t_embedder.mlp.0.bias": (D,),
              "t_embedder.mlp.2.weight": (D, D), "t_embedder.mlp.2.bias": (D,),
              "final_layer.linear.weight": (p * p * out_c, D),
              "final_layer.linear.bias": (p * p * out_c,),
              "final_layer.adaLN_modulation.1.weight": (2 * D, D),
              "final_layer.adaLN_modulation.1.bias": (2 * D,),
              "pos_embed": (1, (cfg.input_size // p) ** 2, D)}
    if latte:
        shapes["temp_embed"] = (1, cfg.num_frames, D)
    if (cfg.extras == 2) if latte else cfg.num_classes:
        shapes["y_embedder.embedding_table.weight"] = (cfg.num_classes + 1, D)
    if latte and cfg.extras == 78:
        shapes["text_embedding_projection.1.weight"] = (D, 77 * 768)
        shapes["text_embedding_projection.1.bias"] = (D,)
    hidden = int(D * cfg.mlp_ratio)
    for i in range(cfg.depth):
        for name, shape in (("attn.qkv", (3 * D, D)), ("attn.proj", (D, D)),
                            ("mlp.fc1", (hidden, D)), ("mlp.fc2", (D, hidden)),
                            ("adaLN_modulation.1", (6 * D, D))):
            shapes[f"blocks.{i}.{name}.weight"] = shape
            shapes[f"blocks.{i}.{name}.bias"] = shape[:1]
    sd = {}
    for k, shape in shapes.items():
        if k.endswith(".bias"):
            v = 0.05 * rng.standard_normal(shape)
        elif k in ("y_embedder.embedding_table.weight", "pos_embed", "temp_embed"):
            v = rng.standard_normal(shape)  # the sin-cos tables are dropped on load
        else:  # Linear and conv weights (out, in, ...)
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        sd[k] = np.asarray(v, np.float32)
    return sd


def run_world(suite: str, world: int, workdir, timeout: float = 600.0) -> list:
    """Start `world` gloo ranks of tests/torch_parallel_worker.py's SUITE on
    the CPU and return each rank's results ({check: {"ok": ...} or
    {"error": traceback}}); a rank that exits non-zero fails the caller."""
    return start_world(suite, world, workdir)(timeout)


def start_world(suite: str, world: int, workdir):
    """`run_world` in two halves: start the ranks now, and return the call
    that waits up to its `timeout` for them and returns their results, so
    the caller can work while they run."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "OMNITOK_COORD"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "torch_parallel_worker.py"),
                               suite, str(r), str(world), str(port), str(workdir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def finish(timeout: float = 600.0) -> list:
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        rcs = [p.returncode for p in procs]
        assert not any(rcs), f"ranks exited {rcs}:\n" + "\n".join(o[-3000:] for o in outs)
        return [torch.load(os.path.join(str(workdir), f"{suite}_rank{r}.pt"),
                           weights_only=False) for r in range(world)]

    return finish


def check_result(results: list, check: str, rank: int = 0):
    """One check's values on one rank; raises with the rank's traceback if
    the check raised there."""
    res = results[rank][check]
    assert "error" not in res, res.get("error")
    return res["ok"]


# -- host data: the special dataset families, CoinRun and CLIP's BPE ------------------------
CORPUS = ("mugen runs to the right jumps climbs a ladder collects a coin coins gets killed "
          "kills a monster stays in place is in power-up mode the left and slime bee snail "
          "video caption of a dog walking on grass playing with a ball in the park")


def write_merge_table(path, corpus: str = CORPUS, n_merges: int = 160) -> str:
    """A CLIP-format BPE merge table learned from `corpus` (a version line,
    then one 'a b' merge a line): each round merges the most frequent
    adjacent pair of the words (ties to the first in sorted order), as BPE
    training does, over byte-unicode symbols with '</w>' ending a word."""
    from collections import Counter

    words = Counter(tuple(w[:-1]) + (w[-1] + "</w>",) for w in corpus.lower().split())
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in words.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        best = max(sorted(pairs), key=lambda p: pairs[p])
        merges.append(best)
        out = Counter()
        for w, c in words.items():
            new, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    new.append(w[i] + w[i + 1])
                    i += 2
                else:
                    new.append(w[i])
                    i += 1
            out[tuple(new)] += c
        words = out
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return str(path)


MONSTERS = {"ground": ["slimeBlock"], "walking": ["snail"], "flying": ["bee"]}


def coinrun_game(seed: int, n_frames: int = 9, world: int = 0, agent: int = 0) -> dict:
    """A CoinRun trace in game.py's asdict format from a numpy seed: a maze
    of every tile kind, an agent that walks, jumps, climbs, eats coins,
    powers up and dies, and monsters of each kind, one dying."""
    rng = np.random.RandomState(seed)
    h, w = 13, 64
    maze = [list("." * w) for _ in range(h)]
    maze[0] = list("A" * w)
    maze[1] = list("S" * w)
    for x in range(2, w, 3):
        maze[2 + rng.randint(0, 6)][x] = "S1a2b#$&%^|="[rng.randint(0, 12)]
    coins = [(x, y) for y in range(h) for x in range(w) if maze[y][x] in "12"]
    frames = []
    for i in range(n_frames):
        killed = i >= n_frames - 2
        frames.append({
            "frame_id": i, "file_name": f"f{i}.png", "state_time": i,
            "coins_eaten": [list(c) for c in coins[:i // 3]],
            "agent": {"x": 4.0 + 0.7 * i + 0.1 * rng.rand(), "y": 2.0 + (i % 3 == 1),
                      "vx": (-0.3 if i == 2 else 0.3) * (i % 4 != 3),
                      "vy": 0.2 * (i % 3 == 1), "time_alive": 3 * i, "ladder": i == 5,
                      "spring": int(i == 6), "is_killed": killed,
                      "killed_animation_frame_cnt": 8 * (i - n_frames + 3) if killed else 0,
                      "power_up_mode": i == 4},
            "monsters": [{"m_id": m, "x": 6.0 + 2 * m - 0.1 * i, "y": 2.0 + (m == 2),
                          "vx": 0.1 if m == 1 else -0.1, "vy": 0.1 * (m == 2 and i % 2),
                          "theme": m, "is_jumping": m == 2, "time": i, "anim_freq": 2,
                          "is_dead": m == 0 and i >= 3,
                          "monster_dying_frame_cnt": max(0, 6 - i) if m == 0 else 0}
                         for m in range(3)],
        })
    return {"game_id": seed, "level_seed": seed, "rl_agent_seed": 0, "zoom": 5.5, "bgzoom": 0.4,
            "world_theme_n": world, "agent_theme_n": agent,
            "background_themes": ["backgrounds/bg_a.png", "backgrounds/bg_b.png"],
            "ground_themes": ["Planet", "Grass"], "agent_themes": ["Yellow", "Blue"],
            "monster_names": MONSTERS, "video_res": 1024, "maze_w": w, "maze_h": h,
            "maze": ["".join(r) for r in maze], "frames": frames}


def write_coinrun(root, n_games: int = 4, n_frames: int = 9, captions: bool = False) -> None:
    """`n_games` game JSONs under `root` (the themes alternating) and an
    asset tree under root/assets: a coloured RGBA PNG at every path of
    data/coinrun.py's asset_paths for those themes (alpha 0, 255 and
    between), but for one alien pose, which takes the pose-less fallback.
    With `captions`, root.parent/captions.json holds manual captions for
    the first two games (two for the second)."""
    import json as _json

    from PIL import Image

    from omnitokenizer_tpu_torch.data.coinrun import Game, asset_paths

    root = os.fspath(root)
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(100)
    files = set()
    for i in range(n_games):
        game = coinrun_game(i, n_frames, world=i % 2, agent=(i // 2) % 2)
        with open(os.path.join(root, f"game{i:02d}.json"), "w") as f:
            _json.dump(game, f)
        paths = asset_paths(Game(**game))
        files.add(paths["background"])
        files.update(paths["world"].values())
        for pose, rel in paths["alien"].items():
            files.add(rel if pose != "duck" else rel.replace("_duck", ""))
        for rel in paths["monster"].values():
            base, ext = os.path.splitext(rel)
            files.update(base + s + ext for s in ("", "_move", "_dead"))
    for rel in sorted(files):
        p = os.path.join(root, "assets", rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        hw = (24, 24) if "backgrounds" in rel else (10 + rng.randint(0, 8), 8 + rng.randint(0, 8))
        rgba = rng.randint(0, 256, hw + (4,)).astype(np.uint8)
        rgba[..., 3] = np.where(rng.rand(*hw) < 0.3, 0, np.where(rng.rand(*hw) < 0.5, 255,
                                                                 rgba[..., 3]))
        Image.fromarray(rgba, "RGBA").save(p)
    if captions:
        caps = {"game00": ["Mugen does a custom thing."],
                "game01": ["Mugen waits &amp; sees.", "Mugen jumps over a snail twice."]}
        with open(os.path.join(os.path.dirname(root), "captions.json"), "w") as f:
            _json.dump(caps, f)


CAPTIONS = ["a dog walking on grass", "Mugen &amp; the bee", "café au lait, naïve!",
            "  playing   with a ball in the park at 3pm  ", "x" * 90]


def write_h5_clips(path, lengths=(9, 4, 12, 10, 7), hw=(20, 24), seed: int = 0,
                   text: bool = False, channels: bool = True) -> None:
    """An HDF5 of clips in the JAX package's layout, both splits: every
    video's frames end to end in <split>_data (uint8, (N, H, W, 3), or
    (N, H, W) without `channels`), <split>_idx the start of each then N,
    and with `text` <split>_text a caption a video."""
    import h5py

    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for split in ("train", "test"):
            n = sum(lengths)
            shape = (n,) + tuple(hw) + ((3,) if channels else ())
            f[f"{split}_data"] = rng.randint(0, 256, shape).astype(np.uint8)
            f[f"{split}_idx"] = np.cumsum((0,) + tuple(lengths)).astype(np.int64)
            if text:
                f.create_dataset(f"{split}_text", data=CAPTIONS[:len(lengths)],
                                 dtype=h5py.string_dtype())


def write_host_families(root) -> dict:
    """Files of every HDF5 / frame-folder / stft family under `root`; the
    path each family reads."""
    import h5py
    from PIL import Image

    root = os.fspath(root)
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(1)
    out = {"hdf5": os.path.join(root, "clips.h5"), "text": os.path.join(root, "text.h5"),
           "smap": os.path.join(root, "smap.h5"), "vtokens": os.path.join(root, "vtokens.h5"),
           "frames": os.path.join(root, "frames"), "stft": os.path.join(root, "stft")}
    write_h5_clips(out["hdf5"])
    write_h5_clips(out["text"], seed=2, text=True)
    write_h5_clips(out["smap"], seed=3, channels=False)
    with h5py.File(out["vtokens"], "w") as f:
        for split in ("train", "test"):
            lengths = (8, 3, 11, 9)
            f[f"{split}_data"] = rng.randint(0, 32, (sum(lengths), 6, 6)).astype(np.int64)
            f[f"{split}_idx"] = np.cumsum((0,) + lengths).astype(np.int64)
    for c, n in enumerate((7, 12, 4, 9)):
        d = os.path.join(out["frames"], f"clip{c}")
        os.makedirs(d)
        for i in range(n):
            ext = ".png" if (i + c) % 2 else ".jpg"
            Image.fromarray(rng.randint(0, 256, (18, 22, 3), np.uint8)).save(
                os.path.join(d, f"{i:03d}{ext}"))
    os.makedirs(out["stft"])
    for i, t in enumerate((8, 3, 11, 6)):
        np.savez(os.path.join(out["stft"], f"s{i}.npz"), stft=rng.randn(t + 1, 5),
                 video=rng.randint(0, 256, (t, 18, 22, 3)).astype(np.uint8))
    return out
