"""Read the traces of one MANDO_TPU_PROFILE directory.

    python3 tools/trace_breakdown.py <dir>

`mando-tpu-torch` run with MANDO_TPU_PROFILE=<dir> writes one directory a
pipeline stage, <dir>/<stage>/*.pt.trace.json (torch.profiler's Chrome
trace). For each stage this prints one line: the traced window, the
card's busy time (the union of its kernel, memcpy and memset intervals,
so overlapping streams count once), the idle share, the device
operations that take the most time with their counts, the longest idle
gaps with the innermost host operation that covers each gap's middle, and
the trace's bytes on disk; then the idle share over all stages.

A trace without a device event (a host stage, or a run traced without
CUDA) has no measured busy time: busy and idle share are None, not 0.

Only the standard library: no torch, no jax.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function")
N_GAPS = 3


def load_events(trace) -> list:
    """The complete events ("ph": "X") of a trace: a path to a
    *.pt.trace.json file, or the parsed JSON object."""
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as fh:
            trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events
            if e.get("ph") == "X" and "ts" in e and "dur" in e]


def _union(intervals: Iterable[Tuple[float, float]]) -> list:
    merged: List[list] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _host_label(host: list, t: float) -> Optional[str]:
    """The name of the shortest host event that covers time t."""
    covering = [e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]]
    return min(covering, key=lambda e: e["dur"])["name"] if covering \
        else None


def stage_breakdown(trace, expect_device: bool = False) -> dict:
    """One stage's trace as start_us and window_ms (earliest event start
    to latest event end, the profiler's own span included), busy_ms,
    idle_share (1 - busy / window), device_ops ([(name, ms, count)], the
    largest first), gaps (the N_GAPS longest idle intervals of the
    window, [(start_ms from the window's start, length_ms, host label or
    None)]) and n_events. With no device event, busy_ms and idle_share
    are None, and expect_device=True raises ValueError."""
    events = load_events(trace)
    if not events:
        raise ValueError(f"{_what(trace)}: no complete event")
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    device = [e for e in events if str(e.get("cat", "")).lower()
              in DEVICE_CATS]
    out = dict(start_us=start, window_ms=(end - start) / 1e3, busy_ms=None,
               idle_share=None, device_ops=[], gaps=[], n_events=len(events))
    if not device:
        if expect_device:
            raise ValueError(f"{_what(trace)}: no device event (categories "
                             f"{', '.join(DEVICE_CATS)})")
        return out
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy_us = sum(hi - lo for lo, hi in busy)
    ops: Dict[str, list] = {}
    for e in device:
        op = ops.setdefault(e["name"], [0.0, 0])
        op[0] += e["dur"] / 1e3
        op[1] += 1
    edges = [start] + [t for span in busy for t in span] + [end]
    idle = [(lo, hi) for lo, hi in zip(edges[::2], edges[1::2]) if hi > lo]
    idle.sort(key=lambda g: g[1] - g[0], reverse=True)
    host = [e for e in events if str(e.get("cat", "")).lower() in HOST_CATS]
    out.update(
        busy_ms=busy_us / 1e3,
        idle_share=1.0 - busy_us / (end - start),
        device_ops=sorted(((name, ms, n) for name, (ms, n) in ops.items()),
                          key=lambda op: (-op[1], op[0])),
        gaps=[((lo - start) / 1e3, (hi - lo) / 1e3,
               _host_label(host, (lo + hi) / 2))
              for lo, hi in idle[:N_GAPS]])
    return out


def _what(trace) -> str:
    return str(trace) if isinstance(trace, (str, os.PathLike)) \
        else "the trace"


def stage_trace(stage_dir: str) -> str:
    """The newest *.pt.trace.json of a stage directory (a directory that
    was traced more than once holds one a run)."""
    found = glob.glob(os.path.join(stage_dir, "*.pt.trace.json"))
    if not found:
        raise FileNotFoundError(f"{stage_dir}: no *.pt.trace.json")
    return max(found, key=os.path.getmtime)


def run_breakdown(root: str, expect_device: Iterable[str] = ()) -> dict:
    """{stage: stage_breakdown + trace bytes} for every stage directory
    under a MANDO_TPU_PROFILE root, in the order the stages ran; the
    stages named in `expect_device` must show device events."""
    expect = set(expect_device)
    stages = sorted(d for d in os.listdir(root)
                    if os.path.isdir(os.path.join(root, d)))
    missing = expect - set(stages)
    if missing:
        raise FileNotFoundError(f"{root}: no trace of {sorted(missing)}")
    out = {}
    for stage in stages:
        path = stage_trace(os.path.join(root, stage))
        b = stage_breakdown(path, expect_device=stage in expect)
        b["bytes"] = os.path.getsize(path)
        out[stage] = b
    return dict(sorted(out.items(), key=lambda kv: kv[1]["start_us"]))


def run_idle_share(breakdowns: dict) -> Optional[float]:
    """1 - sum(busy) / sum(window) over a run's stages: a stage without a
    device event adds its window and no busy time. None when no stage
    has a device event."""
    busy = [b["busy_ms"] for b in breakdowns.values()
            if b["busy_ms"] is not None]
    if not busy:
        return None
    return 1.0 - sum(busy) / sum(b["window_ms"]
                                 for b in breakdowns.values())


def kernel_totals(breakdowns: dict, names: Iterable[str]) -> dict:
    """{name: (ms, count)} summed over the stages, over every device
    operation whose demangled name holds `name` as a whole word."""
    out = {}
    for name in names:
        word = re.compile(rf"(?<!\w){re.escape(name)}(?!\w)")
        ms, n = 0.0, 0
        for b in breakdowns.values():
            for op, op_ms, op_n in b["device_ops"]:
                if word.search(op):
                    ms, n = ms + op_ms, n + op_n
        out[name] = (ms, n)
    return out


def format_stage(stage: str, b: dict, n_ops: int = 5) -> str:
    if b["busy_ms"] is None:
        return (f"{stage}: window {b['window_ms']:.3f} ms, busy not measured "
                f"(no device event), {b['n_events']} events, "
                f"{b['bytes']} bytes")
    ops = "; ".join(f"{name[:80]} {ms:.3f} ms x{n}"
                    for name, ms, n in b["device_ops"][:n_ops])
    gaps = "; ".join(f"{length:.3f} ms at +{at:.3f} ms "
                     f"({label or 'no host op'})"
                     for at, length, label in b["gaps"])
    return (f"{stage}: window {b['window_ms']:.3f} ms, busy "
            f"{b['busy_ms']:.3f} ms, idle {100 * b['idle_share']:.2f}%, "
            f"{b['n_events']} events, {b['bytes']} bytes | top device ops: "
            f"{ops} | longest idle gaps: {gaps}")


def main(argv) -> int:
    if len(argv) != 1:
        print("usage: python3 tools/trace_breakdown.py <dir>",
              file=sys.stderr)
        return 2
    stages = run_breakdown(argv[0])
    for stage, b in stages.items():
        print(format_stage(stage, b))
    share = run_idle_share(stages)
    print("run: idle share " + ("not measured (no device event)"
                                if share is None else f"{100 * share:.2f}%"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
