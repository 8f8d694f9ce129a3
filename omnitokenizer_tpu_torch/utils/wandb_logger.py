"""A wandb-compatible run logger (mirror of
`omnitokenizer_tpu.utils.wandb_logger`; the reference logs through
WandbLogger(project="omnitokenizer"), vqgan_train.py:149).

    run = WandbRun(project="omnitokenizer", config=vars(args), root=out_dir)
    run.log({"train/recon_loss": 0.1}, step=10)
    run.finish()

With the wandb package importable (mode 'auto' or 'online') it logs there.
Without it ('auto' or 'offline') it writes an offline run directory,
<root>/wandb/run-<YYYYmmdd_HHMMSS>-<name or project>/, holding config.json
(the config, each value a JSON scalar, a list or its str) and history.jsonl
(a record a log call: `_step`, `_runtime` in seconds since the run began,
and each 0-d metric as a float; other values are left out).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


def _scalarize(metrics: Dict[str, Any]) -> Dict[str, float]:
    """The 0-d values of `metrics` as floats (tensors and arrays included)."""
    out = {}
    for k, v in metrics.items():
        try:
            if np.ndim(v) == 0:
                out[k] = float(v)
        except TypeError:
            continue
    return out


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return str(v)


class WandbRun:
    def __init__(self, project: str = "omnitokenizer", name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None, root: str = ".",
                 mode: str = "auto"):  # auto | online | offline
        self.project = project
        self._wandb = None
        if mode in ("auto", "online"):
            try:
                import wandb  # optional

                self._wandb = wandb.init(project=project, name=name, config=config or {})
            except Exception:
                if mode == "online":
                    raise
        self._t0 = time.time()
        self._step = 0
        self.dir = None
        self._hist = None
        if self._wandb is None:
            ts = time.strftime("%Y%m%d_%H%M%S")
            self.dir = os.path.join(root, "wandb", f"run-{ts}-{name or project}")
            os.makedirs(self.dir, exist_ok=True)
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                json.dump({k: _json_safe(v) for k, v in (config or {}).items()}, f, indent=1)
            self._hist = open(os.path.join(self.dir, "history.jsonl"), "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        """One record at `step` (default: one past the last)."""
        step = self._step if step is None else step
        self._step = step + 1
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
            return
        rec = {"_step": step, "_runtime": round(time.time() - self._t0, 3)}
        rec.update(_scalarize(metrics))
        self._hist.write(json.dumps(rec) + "\n")
        self._hist.flush()

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        elif self._hist is not None:
            self._hist.close()
            self._hist = None
