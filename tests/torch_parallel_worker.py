"""One rank of the port's multi-process checks on the CPU, over gloo.

    python tests/torch_parallel_worker.py SUITE RANK WORLD PORT WORKDIR

tests/test_torch_parallel_{dp,tp,pp,sp,sp_variants}.py start WORLD of these per world
size; each rank runs every check of SUITE once and writes
WORKDIR/SUITE_rank{RANK}.pt: {check: {"ok": values} or {"error": text}},
the values numpy arrays that the test files hold to their bars. Inputs
come from numpy seeds; JAX-side references, where a check has them, are
WORKDIR/*.npz written by the test file before the ranks start. A rank
imports torch and the port only (no JAX), so the worlds start fast.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from omnitokenizer_tpu_torch.parallel import mesh  # noqa: E402

# tests/torch_port_util.py's SMALL tokenizer (kept here: that module imports JAX)
SMALL = dict(embedding_dim=64, n_codes=64, resolution=32, sequence_length=5,
             patch_size=8, temporal_patch_size=2, enc_block="tw", dec_block="tt",
             spatial_depth=2, temporal_depth=2, twod_window_size=2, heads=2, dim_head=32)
GAN_LOSS = dict(perceptual_weight=1.0, image_gan_weight=1.0, video_gan_weight=1.0,
                gan_feat_weight=4.0, disc_layers=2, disc_channels=16)
GAN_TRAIN = dict(lr=1e-4, warmup_steps=10, max_steps=1000, warmup_lr_init=1e-5,
                 grad_clip_val=1.0, grad_clip_val_disc=1.0, ema_advances_per_step=2,
                 disloss_check_thres=None)
GLOBAL_B = 4


def np_tree(x):
    if isinstance(x, dict):
        return {k: np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [np_tree(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() else x.cpu().numpy()
    return x


# -- dp ---------------------------------------------------------------------------------------
def _clips(seed: int, batch: int = GLOBAL_B, frames: int = 5, res: int = 32) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-0.5, 0.5, (batch, frames, res, res, 3))
                            .astype(np.float32))


def _gan_run(group, video, steps, use_vae=False, norm_type="batch", apply_noise=True,
             apply_diffaug=True, restart=False, frames=5):
    from omnitokenizer_tpu_torch.config import LossConfig, TokenizerConfig, TrainConfig
    from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer

    cfg = TokenizerConfig(**SMALL, norm_type=norm_type, use_vae=use_vae,
                          no_random_restart=not restart)
    # GroupNorm's 32 groups need 32 channels (and take no 1-channel clip logits: images)
    loss = dict(GAN_LOSS, disc_channels=32) if norm_type == "group" else GAN_LOSS
    trainer = TokenizerTrainer(cfg, LossConfig(**loss, apply_noise=apply_noise,
                                               apply_diffaug=apply_diffaug),
                               TrainConfig(**GAN_TRAIN), device="cpu", group=group)
    state = trainer.init_state(seed=0)
    for m in state.MODULES:
        mesh.replicate(getattr(state, m), group)
    rows = mesh.rank_rows(video, group)
    metrics = []
    for _ in range(steps):
        state, m = trainer.train_step(state, rows)
        metrics.append({k: float(v) for k, v in m.items()})
    d_names = ([f"image.{n}" for n, _ in state.image_disc.named_parameters()]
               + [f"video.{n}" for n, _ in state.video_disc.named_parameters()])
    out = {"metrics": metrics,
           "g_mu": {n: mu for (n, _), mu in zip(state.net.named_parameters(), state.opt_g.mu)},
           "d_mu": dict(zip(d_names, state.opt_d.mu)),
           "net": dict(state.net.state_dict()),
           "disc": {**{"image." + k: v for k, v in state.image_disc.state_dict().items()},
                    **{"video." + k: v for k, v in state.video_disc.state_dict().items()}}}
    return np_tree(out)


def _gan_check(**kw):
    def check(workdir):
        group = dist.group.WORLD
        video = _clips(11, frames=kw.get("frames", 5))
        got = _gan_run(group, video, 1, **kw)
        want = _gan_run(None, video, 1, **kw) if mesh.rank() == 0 else None
        return {"dp": got, "one": want}
    return check


def check_codebook(workdir):
    """The grouped Codebook: init from the gathered rows, restarts, two
    EMA advances; against one call on the concatenated rows."""
    from omnitokenizer_tpu_torch.ops.codebook import Codebook

    group = dist.group.WORLD
    rng = np.random.RandomState(5)
    z = torch.from_numpy(rng.standard_normal((4, 3, 4, 4, 8)).astype(np.float32))

    def run(g, zz):
        cb = Codebook(64, 8, no_random_restart=False, restart_thres=1.0)
        torch.nn.init.normal_(cb.embeddings, generator=torch.Generator().manual_seed(1))
        outs = []
        for step in range(3):
            gen = torch.Generator().manual_seed(100 + step)
            out = cb(zz + 0.1 * step, training=True, generator=gen, group=g)
            outs.append({k: out[k] for k in ("encodings", "commitment_loss", "perplexity",
                                             "avg_usage", "batch_usage")})
        return np_tree({"outs": outs, "buffers": dict(cb.state_dict())})

    got = run(group, mesh.rank_rows(z, group))
    want = run(None, z) if mesh.rank() == 0 else None
    return {"dp": got, "one": want, "rows": mesh.rank_rows(torch.arange(4), group).numpy()}


def check_quantizers(workdir):
    """VectorQuantize (euclidean, cosine) and ResidualVQ with the group:
    counts and sums all-reduced, from initialized states."""
    from omnitokenizer_tpu_torch.ops.quantizers import ResidualVQ, VectorQuantize

    group = dist.group.WORLD
    rng = np.random.RandomState(6)
    z = torch.from_numpy(rng.standard_normal((8, 6, 16)).astype(np.float32))
    res = {}
    for name, cosine in (("euclid", False), ("cosine", True)):
        vq = VectorQuantize(16, 32, use_cosine_sim=cosine, kmeans_init=False)
        st = vq.init_state(torch.Generator().manual_seed(2))
        st = st._replace(initialized=torch.ones((), dtype=torch.int32))

        def run(g, zz, st=st, vq=vq):
            s, outs = st, []
            for _ in range(2):
                out, s = vq(zz, s, training=True, group=g)
                outs.append(out["encodings"])
            return np_tree({"enc": outs, "state": list(s)})
        res[name] = {"dp": run(group, mesh.rank_rows(z, group)),
                     "one": run(None, z) if mesh.rank() == 0 else None}
    rvq = ResidualVQ(16, 32, 3, kmeans_init=False)
    states = [s._replace(initialized=torch.ones((), dtype=torch.int32))
              for s in rvq.init_state(torch.Generator().manual_seed(3))]

    def run_r(g, zz):
        out, new = rvq(zz, states, training=True, group=g)
        return np_tree({"enc": out["encodings"], "state": [list(s) for s in new]})
    res["residual"] = {"dp": run_r(group, mesh.rank_rows(z, group)),
                       "one": run_r(None, z) if mesh.rank() == 0 else None}
    return res


def check_dit(workdir):
    """One DiT training step under data parallelism: the rank's rows, the
    gradients averaged, the EMA; against one process on the global batch.
    Then three steps on the loss-second-moment sampler (warmed up from a
    seed): its draws and loss history against one process's."""
    from omnitokenizer_tpu_torch.diffusion import create_diffusion
    from omnitokenizer_tpu_torch.diffusion.timestep_sampler import LossSecondMomentResampler
    from omnitokenizer_tpu_torch.models.dit import DiT, DiTConfig
    from omnitokenizer_tpu_torch.training.diffusion_loop import (init_diffusion_state,
                                                                 make_diffusion_train_step,
                                                                 sample_timesteps,
                                                                 update_sampler)
    from omnitokenizer_tpu_torch.training.trainer import OptaxAdam

    group = dist.group.WORLD
    cfg = DiTConfig(input_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=2,
                    num_heads=2, num_classes=10)
    rng = np.random.RandomState(7)
    x0 = torch.from_numpy(rng.standard_normal((4, 4, 8, 8)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (4,)))
    t = torch.from_numpy(rng.randint(0, 8, (4,)))

    def warm_sampler():
        sampler = LossSecondMomentResampler(8)
        sampler._loss_history[:] = np.random.RandomState(5).uniform(0.5, 2.0, (8, 10))
        sampler._loss_counts[:] = sampler.history_per_term
        return sampler

    def run(g, steps=1, sampler=None):
        torch.manual_seed(0)
        model = DiT(cfg)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(4)
            for p in model.parameters():
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
        diffusion = create_diffusion(None, diffusion_steps=8, noise_schedule="squaredcos_cap_v2")
        opt = OptaxAdam(lambda _: 1e-3, 1.0, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
        state = init_diffusion_state(model, opt)
        step = make_diffusion_train_step(
            lambda m, x_t, tt, gen_, y=None, group=None: m(x_t, tt, y, train=True,
                                                          generator=gen_, group=group),
            diffusion, opt, 0.9, group=g)
        rows = lambda a: mesh.rank_rows(a, g)  # noqa: E731
        draw_rng, drawn = np.random.RandomState(11), []
        for i in range(steps):
            if sampler is None:
                tt, w = rows(t), torch.ones(len(rows(x0)))
            else:
                tt, w, t_all = sample_timesteps(sampler, len(rows(x0)), draw_rng, g)
                tt, w = torch.as_tensor(tt), torch.as_tensor(w)
            state, loss, aux = step(state, rows(x0), tt, w,
                                    torch.Generator().manual_seed(9 + i), {"y": rows(y)})
            if sampler is not None:
                update_sampler(sampler, t_all, aux["per_t_loss"], g)
                drawn.append(t_all)
        out = {"loss": loss, "grad_norm": aux["grad_norm"],
               "model": dict(model.state_dict()), "ema": dict(state.ema.state_dict())}
        if sampler is not None:
            out.update(ts=np.stack(drawn), history=sampler._loss_history.copy())
        return np_tree(out)

    lead = mesh.rank() == 0
    return {"dp": run(group), "one": run(None) if lead else None,
            "lsm_dp": run(group, 3, warm_sampler()),
            "lsm_one": run(None, 3, warm_sampler()) if lead else None}


def check_placement(workdir):
    """shard_batch, replicate, draw_rows and the grid on this world."""
    group = dist.group.WORLD
    r, n = mesh.rank(), mesh.world()
    x = torch.arange(12).reshape(6, 2)
    t = torch.full((3,), float(r))
    mesh.replicate([t], group)
    draws = mesh.draw_rows(lambda s: torch.randn(s, generator=torch.Generator().manual_seed(3)),
                           (2, 3), group)
    full = torch.randn((2 * n, 3), generator=torch.Generator().manual_seed(3))
    g = mesh.grid(1)
    # 16-bit floats cross gloo as their bytes (copies) or summed in f32
    h = torch.full((2, 3), 1.5 + r, dtype=torch.bfloat16)
    gathered = torch.cat(mesh.all_gather(h, group))
    summed = mesh.all_reduce_(h.clone(), group)
    if r == 0:
        mesh.send(h, 1, group)
        hop = h
    else:
        hop = mesh.recv((2, 3), torch.bfloat16, "cpu", 0, group)
    return {"bf16": torch.stack([gathered[0, 0], gathered[2, 0], summed[0, 0], hop[0, 0]]).float()
            .numpy(),
            "rows": mesh.shard_batch({"a": x}, group)["a"].numpy(), "replicated": t.numpy(),
            "draws": draws.numpy(), "draws_full": full.numpy(),
            "grid": np.array([g.data_rank, g.data_size, g.inner_rank, g.inner_size])}


# -- tp ---------------------------------------------------------------------------------------
def _inputs(workdir, name):
    return torch.load(os.path.join(workdir, name), weights_only=False)


def _n2n(spec, sd, dtype=torch.float32):
    """The port's Net2Net over a GPT holding `sd`, with a stand-in tokenizer."""
    import types

    from omnitokenizer_tpu_torch.config import GPTConfig, Net2NetConfig
    from omnitokenizer_tpu_torch.models.gpt import GPT
    from omnitokenizer_tpu_torch.models.net2net import Net2NetTransformer

    gcfg = GPTConfig(**spec["gpt"], dtype=dtype)
    gpt = GPT(gcfg)
    gpt.load_state_dict(sd)
    return Net2NetTransformer(Net2NetConfig(gpt=gcfg, **spec["n2n"]),
                              types.SimpleNamespace(device=torch.device("cpu")), gpt=gpt)


def _tp_loss_grads(spec, model_parallel):
    """Loss and the full gradient of the TP (x DP) Net2Net loss: each data
    row takes its rows, the gradients averaged over the rows and gathered
    over the model group."""
    from omnitokenizer_tpu_torch.parallel import tp

    g = mesh.grid(model_parallel)
    n2n = _n2n(spec, spec["state_dict"])
    tp.shard_gpt(n2n.gpt, g.inner)
    # the carried-over JAX weights cut by shard_state_dict: this rank's shards exactly
    want = tp.shard_state_dict(spec["state_dict"], g.inner_rank, g.inner_size)
    shards_equal = all(torch.equal(v, want[k]) for k, v in n2n.gpt.state_dict().items())
    z, labels = torch.from_numpy(spec["z"]), torch.from_numpy(spec["labels"])
    data = g.data if g.data_size > 1 else None
    loss, metrics = n2n.loss_fn(mesh.rank_rows(z, data), mesh.rank_rows(labels, data))
    loss = mesh.mean_over(loss, data)
    params = dict(n2n.gpt.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    mesh.average_grads_(grads, data)
    dims = n2n.gpt.tp_dims or {}
    full = tp.gather_state_dict(dict(zip(params, grads)), dims, g.inner)
    return np_tree({"loss": loss, "acc1": mesh.mean_over(metrics["acc1"], data),
                    "grads": full, "shards_equal": shards_equal})


def check_tp_loss(workdir):
    out = {}
    for name, spec in _inputs(workdir, "tp_loss.pt").items():
        for mp in spec["layouts"]:
            if mesh.world() % mp == 0:
                out[f"{name}/mp{mp}"] = _tp_loss_grads(spec, mp)
    return out


def check_tp_step(workdir):
    """Two lm_train_step calls under TP (the clip's norm the whole model's,
    the moments sharded) against one process."""
    from omnitokenizer_tpu_torch.training import lm_loop

    if mesh.world() != 2:
        return None  # the 2-rank world holds it
    spec = _inputs(workdir, "tp_loss.pt")["even"]
    z, labels = torch.from_numpy(spec["z"]), torch.from_numpy(spec["labels"])

    def run(model_parallel):
        n2n = _n2n(spec, spec["state_dict"])
        opt = lm_loop.make_lm_optimizer(n2n.gpt, lr=1e-3, max_steps=10, warmup_steps=2,
                                        warmup_lr_init=1e-4, grad_clip_val=0.05,
                                        weight_decay=0.1)
        par = (lm_loop.setup_parallel(n2n, opt, model_parallel) if model_parallel
               else lm_loop.LMParallel())
        state = lm_loop.init_lm_state(n2n, opt)
        norms = []
        for _ in range(2):
            m = lm_loop.lm_train_step(n2n, opt, state, mesh.rank_rows(z, par.data),
                                      mesh.rank_rows(labels, par.data), par=par)
            norms.append(m["grad_norm"])
        full = lm_loop.full_state_dict(state, par)
        return np_tree({"gpt": full["gpt"], "mu": full["opt"]["mu"], "norms": norms,
                        "sharded": [n for n, d in (n2n.gpt.tp_dims or {}).items()
                                    if d is not None]})

    return {"tp": run(mesh.world()), "one": run(0) if mesh.rank() == 0 else None}


def check_tp_decode(workdir):
    """Greedy decode with the Megatron shards and head-sharded caches."""
    from omnitokenizer_tpu_torch.config import GPTConfig
    from omnitokenizer_tpu_torch.models.gpt import GPT, make_sampler
    from omnitokenizer_tpu_torch.parallel import tp

    spec = _inputs(workdir, "tp_decode.pt")
    out = {}
    for mp in (2, 4):
        if mesh.world() % mp:
            continue
        g = mesh.grid(mp)
        cfg = GPTConfig(**spec["gpt"])
        gpt = GPT(cfg)
        gpt.load_state_dict(spec["state_dict"])
        tp.shard_gpt(gpt, g.inner)
        caches_heads = gpt.n_local_heads
        toks = make_sampler(cfg, steps=10, greedy=True)(gpt, torch.from_numpy(spec["cond"]))
        out[f"mp{mp}"] = {"tokens": toks.numpy(), "heads": caches_heads}
    return out


def check_vq_sharded(workdir):
    """vq_argmin_sharded over the world, the table split into slabs."""
    from omnitokenizer_tpu_torch.ops.codebook import vq_argmin_sharded

    spec = np.load(os.path.join(workdir, "vq.npz"))
    n, r = mesh.world(), mesh.rank()
    emb = torch.from_numpy(spec["emb"])
    k = emb.shape[0] // n
    return {"idx": vq_argmin_sharded(torch.from_numpy(spec["flat"]), emb[r * k:(r + 1) * k],
                                     dist.group.WORLD).numpy()}


def _cli(module, argv):
    import importlib

    return importlib.import_module(f"omnitokenizer_tpu_torch.cli.{module}").main(argv)


def check_cli_train(workdir):
    """transformer_train under the layout of cli_train.pt's flags."""
    spec = _inputs(workdir, "cli_train.pt")
    _cli("transformer_train", spec["argv"])
    return {}


def check_cli_eval(workdir):
    """transformer_eval --model_parallel over the world, and the class split."""
    spec = _inputs(workdir, "cli_eval.pt")
    return {"done": [_cli("transformer_eval", argv) for argv in spec["argvs"]]}


# -- pp ---------------------------------------------------------------------------------------
def check_pp_loss(workdir):
    """The pipelined Net2Net loss and its full gradient (GPipe over the
    world's stages, 2 microbatches)."""
    from omnitokenizer_tpu_torch.parallel.pp import PipelineGPT

    out = {}
    for name, spec in _inputs(workdir, "pp_loss.pt").items():
        n2n = _n2n(spec, spec["state_dict"])
        pipe = PipelineGPT(n2n.gpt, dist.group.WORLD, spec["micro"])
        inputs, target, prefix = n2n.loss_inputs(
            torch.from_numpy(spec["z"]), torch.from_numpy(spec["labels"]),
            torch.from_numpy(spec["keep"]), torch.from_numpy(spec["rand"]).long())
        metrics = pipe.forward_backward(
            inputs, lambda logits: n2n.loss_from_logits(logits, target, prefix))
        grads = {k: p.grad for k, p in pipe.named_parameters()}
        merged = {}
        for part in _all_objects({k: v for k, v in grads.items() if k.startswith("blocks.")}):
            merged.update(part)
        merged.update({k: v for k, v in grads.items() if not k.startswith("blocks.")})
        out[name] = np_tree({"loss": metrics["loss"], "acc1": metrics["acc1"],
                             "acc5": metrics["acc5"], "grads": merged,
                             "rest": {k: v for k, v in grads.items()
                                      if not k.startswith("blocks.")},
                             "logits": pipe.logits(inputs)})
    return out


def _all_objects(obj):
    parts = [None] * mesh.world()
    dist.all_gather_object(parts, obj)
    return parts


def check_pp_step(workdir):
    """Two lm_train_step calls through the pipeline against one process."""
    from omnitokenizer_tpu_torch.training import lm_loop

    spec = _inputs(workdir, "pp_loss.pt")["pkeep"]
    z, labels = torch.from_numpy(spec["z"]), torch.from_numpy(spec["labels"])

    def run(stages):
        n2n = _n2n(spec, spec["state_dict"])
        opt = lm_loop.make_lm_optimizer(n2n.gpt, lr=1e-3, max_steps=10, warmup_steps=2,
                                        warmup_lr_init=1e-4, grad_clip_val=0.05,
                                        weight_decay=0.1)
        par = (lm_loop.setup_parallel(n2n, opt, pipeline_stages=stages,
                                      microbatches=spec["micro"]) if stages
               else lm_loop.LMParallel())
        state = lm_loop.init_lm_state(n2n, opt, seed=3)
        norms = []
        for _ in range(2):
            norms.append(lm_loop.lm_train_step(n2n, opt, state, z, labels, par=par)["grad_norm"])
        full = lm_loop.full_state_dict(state, par)
        return np_tree({"gpt": full["gpt"], "mu": full["opt"]["mu"], "norms": norms})

    return {"pp": run(mesh.world()), "one": run(0) if mesh.rank() == 0 else None}


# tests/test_torch_cli.py's TINY image tokenizer flags
VQGAN_TINY = ["--embedding_dim", "16", "--n_codes", "32", "--codebook_dim", "4",
              "--patch_size", "4", "--temporal_patch_size", "2", "--enc_block", "t",
              "--dec_block", "t", "--spatial_depth", "1", "--temporal_depth", "1",
              "--dim_head", "8", "--heads", "2", "--spatial_pos", "rope", "--resolution", "16",
              "--sequence_length", "1", "--perceptual_weight", "0", "--image_gan_weight", "0.1",
              "--video_gan_weight", "0", "--gan_feat_weight", "0.1"]


def check_vqgan_train(workdir):
    """vqgan_train over the world: 8 PNGs, batch 2 a rank, 2 steps and a
    resume to 3; every rank ends with rank 0's state."""
    from PIL import Image

    from omnitokenizer_tpu_torch.cli import vqgan_train

    data = os.path.join(workdir, "png")
    if mesh.rank() == 0:
        os.makedirs(data, exist_ok=True)
        rng = np.random.RandomState(0)
        for i in range(8):
            Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(
                os.path.join(data, f"im{i}.png"))
        with open(os.path.join(data, "list.txt"), "w") as f:
            f.write("".join(f"im{i}.png\t{i % 4}\n" for i in range(8)))
    mesh.barrier()
    run = os.path.join(workdir, "vqgan_run")
    flags = VQGAN_TINY + ["--data_path", data, "--train_datalist", os.path.join(data, "list.txt"),
                          "--val_datalist", os.path.join(data, "list.txt"),
                          "--default_root_dir", run, "--warmup_steps", "1", "--lr", "1e-4",
                          "--batch_size", "2", "--num_workers", "0", "--device", "cpu"]
    state = vqgan_train.main(flags + ["--max_steps", "2"])
    resumed = vqgan_train.main(flags + ["--max_steps", "3"])
    return np_tree({"steps": [state.step, resumed.step],
                    "net": dict(resumed.net.state_dict()),
                    "ckpts": sorted(os.listdir(os.path.join(run, "checkpoints")))})


# tests/test_torch_diffusion_cli.py's TINY DiT flags
DIT_TINY = ["--model", "DiT-S/2", "--image_size", "32", "--in_channels", "4",
            "--num_classes", "5", "--synthetic_data", "--global_batch_size", "4",
            "--diffusion_steps", "8", "--noise_schedule", "squaredcos_cap_v2", "--device", "cpu"]
DIT_SAMPLE = ["--model", "DiT-S/2", "--image_size", "32", "--in_channels", "4",
              "--num_classes", "5", "--num_samples", "2", "--per_proc_batch_size", "2",
              "--ddim", "--cfg_scale", "2.0", "--classes", "3", "--diffusion_steps", "8",
              "--noise_schedule", "squaredcos_cap_v2", "--device", "cpu",
              "--num_sampling_steps", "4"]


def check_dit_cli(workdir):
    """dit_train on the world (the global batch split) for 2 steps, then
    dit_sample from its state on every rank."""
    from omnitokenizer_tpu_torch.cli import dit_sample, dit_train

    run = os.path.join(workdir, "dit_run")
    state = dit_train.main(DIT_TINY + ["--results_dir", run, "--max_steps", "2",
                                       "--ckpt_every", "2", "--log_every", "1"])
    mesh.barrier()
    made = dit_sample.main(DIT_SAMPLE + ["--ckpt", os.path.join(run, "state_000000002.pt"),
                                         "--sample_dir", os.path.join(workdir, "dit_samples")])
    return np_tree({"made": made, "ema": dict(state.ema.state_dict()),
                    "states": sorted(f for f in os.listdir(run) if f.startswith("state_"))})


# -- sp ---------------------------------------------------------------------------------------
def _sp_run(net, x, sp):
    """The forward of the JAX test's loss (L1 reconstruction + commitment,
    training=False) and its gradient: under `sp` on this rank's pixel rows,
    the reconstruction and indices gathered and the ranks' gradients
    averaged."""
    from omnitokenizer_tpu_torch.parallel import tp

    group = None if sp is None else sp.group
    xin = x if sp is None else tp.sp_shard_pixels(x, group)
    recon, aux = net(xin, False, sp=sp)
    loss = mesh.mean_over((recon - xin).abs().mean(), group) + aux["commitment_loss"]
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    mesh.average_grads_(grads, group)
    out = {"loss": loss, "grads": dict(zip(names, grads)),
           "recon": recon if sp is None else tp.sp_gather(recon.detach(), group, 2)}
    if "encodings" in aux:
        enc = aux["encodings"]
        out["encodings"] = enc if sp is None else tp.sp_gather(enc, group, 2)
    return np_tree(out)


def _sp_net(spec, **overrides):
    from omnitokenizer_tpu_torch.config import TokenizerConfig
    from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet

    net = OmniTokenizerNet(TokenizerConfig(**{**spec["cfg"], **overrides}))
    if not overrides:
        net.load_state_dict(spec["state_dict"])
    return net


def check_sp_cases(workdir):
    """Each case's SP forward and gradient over the world, and rank 0's
    one-process run of the same net."""
    from omnitokenizer_tpu_torch.parallel import tp

    sp = tp.seq_parallel(dist.group.WORLD)
    out = {}
    for name, spec in _inputs(workdir, "sp.pt").items():
        net, x = _sp_net(spec), torch.from_numpy(spec["x"])
        out[name] = {"sp": _sp_run(net, x, sp),
                     "one": _sp_run(net, x, None) if mesh.rank() == 0 else None}
    return out


def check_sp_refusals(workdir):
    """What sequence parallelism refuses, each raising its reason: the
    message of each, or None where nothing raised."""
    from omnitokenizer_tpu_torch.config import LossConfig, TrainConfig
    from omnitokenizer_tpu_torch.parallel import tp
    from omnitokenizer_tpu_torch.training.trainer import TokenizerTrainer

    sp = tp.seq_parallel(dist.group.WORLD)
    spec = _inputs(workdir, "sp.pt")["t"]
    x = torch.from_numpy(spec["x"])
    rows = tp.sp_shard_pixels(x, sp.group)

    def message(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    return {
        "odd_rows": message(lambda: tp.sp_shard_pixels(x[:, :, :15], sp.group)),
        "bf16_training": message(lambda: _sp_net(spec, dtype=torch.bfloat16)(
            rows, False, training=True, sp=sp)),
        "trainer": message(lambda: TokenizerTrainer(
            _sp_net(spec).cfg, LossConfig(), TrainConfig(), device="cpu", sp=sp)),
    }


def check_sp_ragged(workdir):
    """What SP refused before its row partition, now run over the world and
    in rank 0's one process: 12 x 12 frames (a rank's 6 pixel rows are 1.5
    patches of 4), and 24 x 24 frames through a 2 x 2 average pool (3 token
    rows a rank at the pool)."""
    from omnitokenizer_tpu_torch.models.tokenizer import init_weights
    from omnitokenizer_tpu_torch.parallel import tp

    sp = tp.seq_parallel(dist.group.WORLD)
    spec = _inputs(workdir, "sp.pt")["t"]
    pool = _sp_net(spec, enc_block="ta", spatial_depth=2)
    init_weights(pool, torch.Generator().manual_seed(0))
    x24 = torch.from_numpy((np.random.RandomState(2).randn(2, 3, 24, 24, 3) * 0.2)
                           .astype(np.float32))
    out = {}
    for name, net, x in (("rows", _sp_net(spec), torch.from_numpy(spec["x"])[:, :, :12, :12]),
                         ("pool_rows", pool, x24)):
        out[name] = {"sp": _spv_run(net, x, sp, {}),
                     "one": _spv_run(net, x, None, {}) if mesh.rank() == 0 else None}
    return out


# -- sp variants ------------------------------------------------------------------------------
SPIED = ("ln_qkv", "geglu_ff", "small_n_attention", "cosine_mha")  # ops/attention.py's wrappers


def _spied_calls():
    """Count the calls of the kernel wrappers that ops/attention.py and
    ops/codebook.py make (on the CPU each runs its plain version): returns
    the counts, a dict the wrappers add to from now on."""
    from omnitokenizer_tpu_torch.ops import attention, codebook

    calls = {name: 0 for name in SPIED + ("vq_argmin",)}

    def spy(module, name):
        real = getattr(module, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return real(*a, **k)

        setattr(module, name, wrapper)

    for name in SPIED:
        spy(attention, name)
    spy(codebook, "vq_argmin")
    return calls


def _spv_run(net, x, sp, calls, grads=True, flat=False, noise=False):
    """One case's forward under `sp` (None: one process) on this rank's
    pixel rows: the JAX-side loss (L1 against the pixels, or the mean
    |recon| where a pool leaves a smaller grid, + commitment; the mean over
    every rank's elements, which ranks may hold unequal counts of), its
    gradient (the ranks' averaged), the reconstruction and indices
    gathered, the kernel wrappers' calls on this rank; with `flat`, the
    decodes of this rank's indices, grid and flat, gathered; with `noise`,
    a VAE's posterior sampled from a seeded generator."""
    from omnitokenizer_tpu_torch.parallel import tp

    group = None if sp is None else sp.group
    xin = x if sp is None else tp.sp_shard_pixels(x, group)
    for k in calls:
        calls[k] = 0
    gen = torch.Generator().manual_seed(5) if noise else None
    with torch.enable_grad() if grads else torch.no_grad():
        recon, aux = net(xin, False, sp=sp, generator=gen)
        counted = dict(calls)
        diff = recon - xin if recon.shape == xin.shape else recon
        total = sum(mesh.counts_of(diff.numel(), group))
        loss = mesh.sum_over(diff.float().abs().sum(), group) / total + aux["commitment_loss"]
        out = {"loss": loss, "calls": counted}
        if grads:
            names, params = zip(*net.named_parameters())
            g = torch.autograd.grad(loss, params, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(params, g)]
            mesh.average_grads_(g, group)
            out["grads"] = dict(zip(names, g))
    gather = (lambda t: t) if sp is None else (lambda t: tp.sp_gather(t, group, 2))
    out["recon"] = gather(recon.detach())
    if "encodings" in aux:
        out["encodings"] = gather(aux["encodings"])
    if flat:
        enc = aux["encodings"]
        with torch.no_grad():
            out["grid_recon"] = gather(net.decode(enc, False, sp=sp))
            out["flat_recon"] = gather(net.decode(enc.reshape(enc.shape[0], -1), False, sp=sp))
    return np_tree(out)


def _spv_cases(workdir, ranks):
    """Each case of `ranks` ranks: its SP run over the world and rank 0's
    one-process run of the same net."""
    from omnitokenizer_tpu_torch.config import TokenizerConfig
    from omnitokenizer_tpu_torch.models.tokenizer import OmniTokenizerNet, init_weights
    from omnitokenizer_tpu_torch.parallel import tp

    sp = tp.seq_parallel(dist.group.WORLD)
    calls = _spied_calls()
    out = {}
    for name, spec in _inputs(workdir, "spv.pt").items():
        if spec["ranks"] != ranks:
            continue
        bf16 = spec.get("bf16", False)
        net = OmniTokenizerNet(TokenizerConfig(**spec["cfg"], **(
            {"dtype": torch.bfloat16} if bf16 else {})))
        if bf16:
            init_weights(net, torch.Generator().manual_seed(0))
        else:
            net.load_state_dict(spec["state_dict"])
        x = torch.from_numpy(spec["x"])
        kw = dict(grads=not bf16, flat=spec.get("flat", False), noise=spec.get("noise", False))
        out[name] = {"sp": _spv_run(net, x, sp, calls, **kw),
                     "one": _spv_run(net, x, None, calls, **kw) if mesh.rank() == 0 else None}
    return out


def check_spv_cases(workdir):
    return _spv_cases(workdir, 2)


def check_spv_cases4(workdir):
    return _spv_cases(workdir, 4)


def check_spv_cases8(workdir):
    return _spv_cases(workdir, 8)

SUITES = {
    "dp": [("placement", check_placement),
           ("codebook", check_codebook),
           ("quantizers", check_quantizers),
           ("gan_vq_batch", _gan_check()),
           ("gan_vq_group", _gan_check(norm_type="group", frames=1)),
           ("gan_vq_restart", _gan_check(restart=True, apply_diffaug=False)),
           ("gan_vae_batch", _gan_check(use_vae=True)),
           ("dit", check_dit),
           ("vqgan_train", check_vqgan_train),
           ("dit_cli", check_dit_cli)],
    "tp": [("tp_loss", check_tp_loss),
           ("tp_step", check_tp_step),
           ("tp_decode", check_tp_decode),
           ("vq_sharded", check_vq_sharded),
           ("cli_train", check_cli_train),
           ("cli_eval", check_cli_eval)],
    "sp": [("sp_cases", check_sp_cases),
           ("sp_refusals", check_sp_refusals),
           ("sp_ragged", check_sp_ragged)],
    "sp_variants": [("spv_cases", check_spv_cases)],
    "sp_variants4": [("spv_cases", check_spv_cases4)],
    "sp_variants8": [("spv_cases", check_spv_cases8)],
    "pp": [("pp_loss", check_pp_loss),
           ("pp_step", check_pp_step),
           ("cli_train", check_cli_train)],
}


def main(argv):
    suite, rank, world, port, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    import datetime

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    results = {}
    have = set(os.listdir(workdir))
    for name, fn in SUITES[suite]:
        if name.startswith("cli_") and f"{name}.pt" not in have:
            continue  # the test file runs the CLIs in one world size alone
        try:
            results[name] = {"ok": fn(workdir)}
        except Exception:  # recorded for the test that reads this check
            results[name] = {"error": traceback.format_exc()}
            print(results[name]["error"], file=sys.stderr, flush=True)
    torch.save(results, os.path.join(workdir, f"{suite}_rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
