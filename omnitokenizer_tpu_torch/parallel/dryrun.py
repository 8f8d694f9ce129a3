"""A multi-process dry run of the GAN step (the counterpart of the JAX
package's `__graft_entry__.dryrun_multichip`).

    python -m omnitokenizer_tpu_torch.parallel.dryrun 2 [--device cuda|cpu]

`dryrun_multichip(n)` starts n processes (the OMNITOK_* variables, a local
coordinator), each of which takes one data-parallel GAN step of the JAX
dry run's small config on its 2 rows of an (n * 2)-clip batch, and checks
that every rank ends with the same finite metrics and parameters; then,
for an even n, the JAX dry run's sequence-parallel tokenizer forward
(`__graft_entry__._dryrun_tp_sp`'s second half): the batch over the data
axis of `mesh.grid(2)`, each clip's pixel rows over its model pairs,
held to the one-process forward of the data row's clips. The
ranks run on the card unless --device cpu is passed: over NCCL, one card a
rank, or over gloo where there are more ranks than cards
(`mesh.default_backend`); on the CPU over gloo.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict

import numpy as np
import torch

from . import mesh


def _config():
    from ..config import LossConfig, TokenizerConfig, TrainConfig

    cfg = TokenizerConfig(embedding_dim=32, n_codes=64, codebook_dim=8, resolution=32,
                          sequence_length=5, patch_size=4, temporal_patch_size=2,
                          enc_block="tw", dec_block="tt", spatial_depth=2, temporal_depth=2,
                          twod_window_size=4, dim_head=8, heads=4, spatial_pos="rope")
    loss = LossConfig(perceptual_weight=0.0, image_gan_weight=0.1, video_gan_weight=0.1,
                      gan_feat_weight=1.0, apply_noise=True, disc_layers=2)
    return cfg, loss, TrainConfig(grad_accumulates=1, warmup_steps=10, max_steps=100)


def rank_step(device: str = "cuda") -> Dict[str, float]:
    """This rank's share of the step; returns its metrics after checking
    that every rank holds the same parameters and metrics."""
    from ..training.trainer import TokenizerTrainer

    group = mesh.init_distributed(device)
    n = mesh.world()
    cfg, loss, train = _config()
    trainer = TokenizerTrainer(cfg, loss, train, device=device, group=mesh.world_group())
    state = trainer.init_state(seed=0)
    for m in state.MODULES:
        mesh.replicate(getattr(state, m), group)
    batch = torch.from_numpy(
        np.random.RandomState(0).randn(n * 2, 5, 32, 32, 3).astype(np.float32) * 0.2)
    state, metrics = trainer.train_step(state, mesh.shard_batch(batch, group).to(device))
    vals = torch.stack([metrics[k] for k in sorted(metrics)] +
                       [torch.cat([p.detach().reshape(-1) for p in state.g_params()]).sum(),
                        torch.cat([p.detach().reshape(-1) for p in state.d_params()]).sum()])
    every = torch.stack(mesh.all_gather(vals, group)) if group is not None else vals[None]
    if not bool(torch.isfinite(every).all()) or not bool((every == every[0]).all()):
        raise RuntimeError(f"ranks disagree after the data-parallel step: {every.tolist()}")
    out = {k: float(metrics[k]) for k in sorted(metrics)}
    if n % 2 == 0:
        out.update(sp_forward(state.net, batch.to(device)))
    return out


@torch.no_grad()
def sp_forward(net, batch: torch.Tensor) -> Dict[str, float]:
    """The tokenizer forward with the batch over the data axis of
    `mesh.grid(2)` and the pixel rows over its model axis, against the
    one-process forward of this data row's clips: the gathered
    reconstruction 1e-5 relative, the indices equal."""
    from . import tp

    grid = mesh.grid(2)
    sp = tp.seq_parallel(grid.inner)
    clips = mesh.rank_rows(batch, grid.data if grid.data_size > 1 else None)
    recon, aux = net(tp.sp_shard_pixels(clips, grid.inner), False, sp=sp)
    recon = tp.sp_gather(recon, grid.inner, 2)
    idx = tp.sp_gather(aux["encodings"], grid.inner, 2)
    want, want_aux = net(clips, False)
    err = float((recon - want).abs().max() / want.abs().max())
    if not (err <= 1e-5 and torch.equal(idx, want_aux["encodings"])):
        raise RuntimeError(f"the sequence-parallel forward is {err:.3e} from one process's, "
                           f"indices equal {torch.equal(idx, want_aux['encodings'])}")
    return {"sp_recon_rel_err": err, "sp_commitment_loss": float(aux["commitment_loss"])}


def dryrun_multichip(n: int, device: str = "cuda", timeout: float = 600.0) -> None:
    """Run the step over n processes; raises if any process fails."""
    env = dict(os.environ, OMNITOK_COORD=f"localhost:{mesh.free_port()}",
               OMNITOK_NPROCS=str(n))
    env.pop("OMNITOK_NO_DIST", None)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-m", "omnitokenizer_tpu_torch.parallel.dryrun",
                               "--rank", "--device", device],
                              env=dict(env, OMNITOK_PROC_ID=str(r)), cwd=root)
             for r in range(n)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(rcs):
        raise RuntimeError(f"dryrun_multichip({n}): exit codes {rcs}")


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser("dryrun")
    p.add_argument("n", type=int, nargs="?", default=2, help="processes")
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank", action="store_true", help="run as one rank (set by the launcher)")
    a = p.parse_args(argv)
    if a.rank:
        torch.set_num_threads(1)
        metrics = rank_step(a.device)
        if mesh.rank() == 0:
            print(f"dryrun_multichip({mesh.world()}): {metrics}", flush=True)
        mesh.shutdown()
    else:
        dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
