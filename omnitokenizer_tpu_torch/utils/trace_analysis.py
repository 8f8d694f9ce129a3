"""Trace analysis: per-kernel and per-source device-time tables of a
torch.profiler chrome trace (mirror of `omnitokenizer_tpu.utils.trace_analysis`,
which reads XLA's 'XLA Ops' track).

`utils.profiling.trace` writes `*.pt.trace.json` files (torch.profiler's
`export_chrome_trace`, or a `tensorboard_trace_handler`'s, gzipped or not);
this module sums their device kernels without tensorboard.

Usage:
    with profiling.trace("runs/trace"):
        run_model()
    python -m omnitokenizer_tpu_torch.utils.trace_analysis runs/trace --calls 3
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import Dict, List

UNATTRIBUTED = "(unattributed)"
# the host events that launch a kernel, joined to it by their correlation id
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load_trace_events(trace_dir: str) -> List[dict]:
    """The events of the newest *.pt.trace.json[.gz] under trace_dir."""
    files = [f for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for f in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {trace_dir}")
    newest = max(files, key=os.path.getmtime)
    opener = gzip.open if newest.endswith(".gz") else open
    with opener(newest, "rt") as f:
        return json.load(f)["traceEvents"]


def _kernels(events) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e]


def _per_call(n: int, calls: int):
    """A per-call count; sub-call occurrences stay visible (a one-time op
    averaged over 15 calls is 0.07, not 0)."""
    return n // calls if n % calls == 0 else round(n / calls, 2)


def _innermost(ranges: List[tuple], points: List[tuple]) -> Dict[int, str]:
    """One thread's ranges (ts, end, name), which nest, and points (ts,
    key): each point's key -> the name of the innermost range holding it.
    One sweep in time order with a stack of the open ranges."""
    out, stack = {}, []
    # a range opens before a point at its start, an outer range before an inner one
    order = sorted([(r[0], 0, -r[1], r) for r in ranges] + [(p[0], 1, 0, p) for p in points],
                   key=lambda e: e[:3])
    for ts, kind, _, item in order:
        while stack and stack[-1][1] < ts:
            stack.pop()
        if kind == 0:
            stack.append(item)
        elif stack:
            out[item[1]] = stack[-1][2]
    return out


def kernel_sources(events) -> Dict[int, str]:
    """Each kernel's correlation id -> the range that launched it: the
    innermost record_function range (`user_annotation`) around its launch
    on the launching thread, else the innermost CPU op, else
    UNATTRIBUTED."""
    launches = collections.defaultdict(list)  # (pid, tid) -> [(ts, correlation)]
    ranges = collections.defaultdict(list)    # (pid, tid, cat) -> [(ts, end, name)]
    for e in events:
        if e.get("ph") != "X":
            continue
        where, cat = (e["pid"], e.get("tid")), e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in _LAUNCH_CATS and corr is not None:
            launches[where].append((e["ts"], corr))
        elif cat in ("user_annotation", "cpu_op") and "dur" in e:
            ranges[where + (cat,)].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    out = {}
    for where, points in launches.items():
        ops = _innermost(ranges[where + ("cpu_op",)], points)
        named = _innermost(ranges[where + ("user_annotation",)], points)
        for _, corr in points:
            out[corr] = named.get(corr) or ops.get(corr) or UNATTRIBUTED
    return out


def op_table(events, calls: int = 1) -> List[dict]:
    """Device kernel time by kernel name: rows {name, ms (per call), count
    (per call), source (the range that launched its first instance)}
    sorted by time, after a 'TOTAL' row whose count is the kernels a call."""
    sources = kernel_sources(events)
    agg, cnt = collections.Counter(), collections.Counter()
    src: Dict[str, str] = {}
    total, n = 0.0, 0
    for e in _kernels(events):
        name = e["name"]
        agg[name] += e["dur"]
        cnt[name] += 1
        total += e["dur"]
        n += 1
        src.setdefault(name, sources.get((e.get("args") or {}).get("correlation"), UNATTRIBUTED))
    rows = [{"name": k, "ms": us / 1000.0 / calls, "count": _per_call(cnt[k], calls),
             "source": src[k]} for k, us in agg.most_common()]
    rows.insert(0, {"name": "TOTAL", "ms": total / 1000.0 / calls,
                    "count": _per_call(n, calls), "source": ""})
    return rows


def source_table(events, calls: int = 1) -> List[dict]:
    """Device kernel time by the range that launched each kernel
    (`kernel_sources`): rows {source, ms (per call), count (per call)}."""
    sources = kernel_sources(events)
    agg, cnt = collections.Counter(), collections.Counter()
    for e in _kernels(events):
        s = sources.get((e.get("args") or {}).get("correlation"), UNATTRIBUTED)
        agg[s] += e["dur"]
        cnt[s] += 1
    return [{"source": s, "ms": us / 1000.0 / calls, "count": _per_call(cnt[s], calls)}
            for s, us in agg.most_common()]


def print_report(trace_dir: str, calls: int = 1, top: int = 25) -> None:
    events = load_trace_events(trace_dir)
    print(f"== per kernel (averaged over {calls} call(s)) ==")
    for r in op_table(events, calls)[: top + 1]:
        print(f"{r['ms']:8.3f} ms  x{r['count']:<6} {r['name'][:60]:60} {r['source'][-40:]}")
    print("\n== per launching range ==")
    for r in source_table(events, calls)[:top]:
        print(f"{r['ms']:8.3f} ms  x{r['count']:<6} {r['source'][-70:]}")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("trace_analysis")
    ap.add_argument("trace_dir")
    ap.add_argument("--calls", type=int, default=1, help="divide by this many traced calls")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    print_report(args.trace_dir, args.calls, args.top)


if __name__ == "__main__":
    main()
