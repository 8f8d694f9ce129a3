"""The port's profiling utilities (utils/profiling.py, utils/trace_analysis.py):
a synthetic torch.profiler chrome trace gives known per-kernel and
per-source tables (kernels joined to their launches by correlation id, each
attributed to the innermost record_function range around its launch, else
to the innermost CPU op), gzipped or not, the newest file of a directory;
a real CPU `profiling.trace` writes a file that `load_trace_events` reads,
with the annotated range in it; the step timer and the memory statistics."""

import gzip
import json
import os

import pytest
import torch

from omnitokenizer_tpu_torch.utils import profiling
from omnitokenizer_tpu_torch.utils import trace_analysis as ta

HOST, DEV = (1, 1), (0, 7)  # (pid, tid) of the launching thread and of the card's stream


def _x(cat, name, ts, dur, where, **args):
    pid, tid = where
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def synthetic_events():
    """Two calls of a step: in each, aten::mm launches gemm (correlation
    10c+1) inside record_function 'ff'; 'attn' launches a ctypes kernel
    (no CPU op around its launch, 10c+2); one launch outside any range
    (10c+3); a memcpy, not a kernel."""
    ev = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 1, "args": {"name": "main"}}]
    for c in range(2):
        t0 = 1000.0 * c
        ev += [_x("user_annotation", "ff", t0, 100, HOST),
               _x("cpu_op", "aten::mm", t0 + 10, 50, HOST),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 20, 5, HOST, correlation=10 * c + 1),
               _x("user_annotation", "attn", t0 + 200, 100, HOST),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 210, 5, HOST, correlation=10 * c + 2),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 400, 5, HOST, correlation=10 * c + 3),
               _x("kernel", "gemm", t0 + 30, 400, DEV, correlation=10 * c + 1),
               _x("kernel", "cosine_flash", t0 + 500, 1000, DEV, correlation=10 * c + 2),
               _x("kernel", "gemm", t0 + 600, 100, DEV, correlation=10 * c + 3),
               _x("gpu_memcpy", "Memcpy HtoD", t0 + 700, 50, DEV, correlation=10 * c + 4)]
    return ev


def test_op_table_sums_kernels_per_call():
    rows = ta.op_table(synthetic_events(), calls=2)
    assert rows[0] == {"name": "TOTAL", "ms": 1.5, "count": 3, "source": ""}
    assert rows[1] == {"name": "cosine_flash", "ms": 1.0, "count": 1, "source": "attn"}
    assert rows[2] == {"name": "gemm", "ms": 0.5, "count": 2, "source": "ff"}
    assert len(rows) == 3  # the memcpy is no kernel
    one = ta.op_table(synthetic_events(), calls=4)
    assert one[2]["count"] == 1 and one[1]["count"] == 0.5  # sub-call counts stay visible


def test_source_table_attributes_launches():
    sources = ta.kernel_sources(synthetic_events())
    assert sources[1] == "ff" and sources[2] == "attn" and sources[3] == ta.UNATTRIBUTED
    rows = ta.source_table(synthetic_events(), calls=2)
    assert rows == [{"source": "attn", "ms": 1.0, "count": 1},
                    {"source": "ff", "ms": 0.4, "count": 1},
                    {"source": ta.UNATTRIBUTED, "ms": 0.1, "count": 1}]
    # without the record_function ranges, the CPU op around the launch
    bare = [e for e in synthetic_events() if e.get("cat") != "user_annotation"]
    assert ta.kernel_sources(bare)[1] == "aten::mm" and ta.kernel_sources(bare)[2] == \
        ta.UNATTRIBUTED


@pytest.mark.parametrize("gz", [False, True], ids=["json", "gzip"])
def test_load_reads_the_newest_trace(tmp_path, gz, capsys):
    old = tmp_path / "a.pt.trace.json"
    old.write_text(json.dumps({"traceEvents": []}))
    os.utime(old, (1, 1))
    sub = tmp_path / "plugins"
    sub.mkdir()
    data = json.dumps({"traceEvents": synthetic_events()})
    if gz:
        with gzip.open(sub / "b.pt.trace.json.gz", "wt") as f:
            f.write(data)
    else:
        (sub / "b.pt.trace.json").write_text(data)
    assert ta.load_trace_events(str(tmp_path)) == synthetic_events()
    ta.main([str(tmp_path), "--calls", "2"])
    out = capsys.readouterr().out
    assert "cosine_flash" in out and "per launching range" in out
    with pytest.raises(FileNotFoundError):
        ta.load_trace_events(str(tmp_path / "plugins" / "none"))


def test_cpu_trace_round_trip(tmp_path):
    """A real trace on the CPU: the file lands under the directory, holds
    the annotated range and the CPU ops, and has no kernels to sum."""
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("outer"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = ta.load_trace_events(str(tmp_path / "t"))
    names = {e.get("name") for e in events}
    assert "outer" in names and "aten::mm" in names
    assert ta.op_table(events) == [{"name": "TOTAL", "ms": 0.0, "count": 0, "source": ""}]


def test_step_timer_and_memory_stats(monkeypatch):
    clock = iter([0.0, 1.0, 3.0, 4.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(window=2)
    assert timer.steps_per_sec == 0.0 and timer.eta_seconds(3) == float("inf")
    for items in (8, 8, 4, 4):
        timer.tick(items)
    # the window keeps the last two steps: 2 s with 4 items and 1 s with 4
    assert timer.steps_per_sec == pytest.approx(2 / 3)
    assert timer.items_per_sec == pytest.approx(8 / 3)
    assert timer.eta_seconds(4) == pytest.approx(6.0)
    stats = profiling.device_memory_stats()
    assert set(stats) == {f"cuda:{i}" for i in range(torch.cuda.device_count())}
