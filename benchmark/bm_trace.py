"""The arithmetic of a stage's profiler trace: a frozen copy of
tools/trace_breakdown.py's, with one change: on a CUDA run a stage whose
trace holds no device event counts as wholly idle (busy 0), where the
tool reports no measurement.

A stage's trace is torch.profiler's Chrome trace, which the program's
StageTimer writes under MANDO_TPU_PROFILE=<dir> as
<dir>/<stage>/*.pt.trace.json. Only the standard library.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function", "user_annotation")
N_GAPS = 50   # the longest idle gaps of a stage that get a host label


def load_events(path: str) -> list:
    """The complete events ("ph": "X") of a trace file."""
    with open(path) as fh:
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


def stage_breakdown(path: str, on_cuda: bool) -> dict:
    """One stage's trace: window_s (earliest event start to latest event
    end), busy_s (the union of the device's kernel, memcpy and memset
    intervals), device_ops {name: seconds}, and gaps [(host label or
    None, seconds)] for the N_GAPS longest idle intervals. With no device
    event, busy_s is 0 on a CUDA run and None otherwise."""
    events = load_events(path)
    if not events:
        raise ValueError(f"{path}: no complete event")
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    device = [e for e in events
              if str(e.get("cat", "")).lower() in DEVICE_CATS]
    out = dict(window_s=(end - start) / 1e6, busy_s=None, device_ops={},
               gaps=[])
    if not device:
        if on_cuda:
            out.update(busy_s=0.0, gaps=[(None, (end - start) / 1e6)])
        return out
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in device)
    ops: Dict[str, float] = {}
    for e in device:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e6
    edges = [start] + [t for span in busy for t in span] + [end]
    idle = [(lo, hi) for lo, hi in zip(edges[::2], edges[1::2]) if hi > lo]
    idle.sort(key=lambda g: g[1] - g[0], reverse=True)
    host = [e for e in events
            if str(e.get("cat", "")).lower() in HOST_CATS]
    out.update(busy_s=sum(hi - lo for lo, hi in busy) / 1e6,
               device_ops=ops,
               gaps=[(_host_label(host, (lo + hi) / 2), (hi - lo) / 1e6)
                     for lo, hi in idle[:N_GAPS]])
    return out


def stage_trace(stage_dir: str) -> str:
    """The newest *.pt.trace.json of a stage directory."""
    found = glob.glob(os.path.join(stage_dir, "*.pt.trace.json"))
    if not found:
        raise FileNotFoundError(f"{stage_dir}: no *.pt.trace.json")
    return max(found, key=os.path.getmtime)


def run_traces(root: str, on_cuda: bool) -> Dict[str, dict]:
    """{stage: stage_breakdown} for every stage directory under a
    MANDO_TPU_PROFILE root."""
    return {stage: stage_breakdown(stage_trace(os.path.join(root, stage)),
                                   on_cuda)
            for stage in sorted(os.listdir(root))
            if os.path.isdir(os.path.join(root, stage))}


def kernel_seconds(stages: Dict[str, dict], word: str) -> float:
    """Device seconds of every operation whose name holds `word`."""
    return sum(s for b in stages.values()
               for name, s in b["device_ops"].items() if word in name)
