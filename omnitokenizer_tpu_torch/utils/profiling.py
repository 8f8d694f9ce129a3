"""Profiling and step timing (mirror of `omnitokenizer_tpu.utils.profiling`):
a torch.profiler trace written as a chrome trace, named ranges, a step
timer with rolling throughput, and the cards' memory statistics.

    with profiling.trace("runs/trace"):
        with profiling.annotate("round_trip"):
            model.reconstruct(video)
    python -m omnitokenizer_tpu_torch.utils.trace_analysis runs/trace --calls 1
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import deque
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block (the CPU, and the cards where CUDA is available)
    and write `<host>_<pid>.<ns>.pt.trace.json` under log_dir, which
    utils/trace_analysis.py reads."""
    use_cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if use_cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if use_cuda:
            torch.cuda.synchronize()
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """A named range that shows up in profiler traces (a CPU range, and the
    kernels launched inside it are attributed to it)."""
    return record_function(name)


class StepTimer:
    """Rolling step-time / items-per-second meter."""

    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self, items: int = 1):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append((now - self._last, items))
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if not self.times:
            return 0.0
        total = sum(t for t, _ in self.times)
        return len(self.times) / total if total else 0.0

    @property
    def items_per_sec(self) -> float:
        if not self.times:
            return 0.0
        total_t = sum(t for t, _ in self.times)
        total_i = sum(i for _, i in self.times)
        return total_i / total_t if total_t else 0.0

    def eta_seconds(self, remaining_steps: int) -> float:
        sps = self.steps_per_sec
        return remaining_steps / sps if sps else float("inf")


def device_memory_stats() -> dict:
    """torch.cuda.memory_stats of every visible card, by device name
    ("cuda:0", ...); empty without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
