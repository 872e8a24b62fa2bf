"""Observability: per-stage wall times and optional profiler traces.

Every stage reports wall time and item counts into tmp/timing.tsv
(counterpart of mandalorion_tpu/pipeline/observe.py). With
MANDO_TPU_PROFILE=<dir> in the environment when the timer is built,
every stage runs under torch.profiler and writes <dir>/<stage>/
*.pt.trace.json (Chrome trace format: TensorBoard, Perfetto, or
tools/trace_breakdown.py), the layout the reference's jax.profiler traces
take. The device's kernels are traced only when the timer is given a
CUDA device, so a run on the host routes never starts CUPTI. Unlike the
reference, which carries on without a trace when one cannot be started,
a trace that was asked for and cannot be taken raises."""

from __future__ import annotations

import contextlib
import gc
import glob
import os
import time
from typing import Dict, Iterator, Optional

import torch


class StageTimer:
    """Collects per-stage wall times; writes tmp/timing.tsv. `device` is
    the run's device (None when the run resolved none): a CUDA device
    adds the card's activity to the traces."""

    def __init__(self, out_path: Optional[str] = None, device=None):
        self.out_path = out_path
        self.device = None if device is None else torch.device(device)
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.profile_dir = os.environ.get("MANDO_TPU_PROFILE") or None

    @contextlib.contextmanager
    def stage(self, name: str, count: Optional[int] = None) -> Iterator[None]:
        trace = self._start_trace(name) if self.profile_dir else None
        t0 = time.time()
        try:
            yield
        finally:
            # before the profiler's flush and export, as the reference
            dt = time.time() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if count is not None:
                self.counts[name] = self.counts.get(name, 0) + count
            if trace is not None:
                self._stop_trace(*trace)
                # the profiler holds its events in reference cycles: free
                # them now, outside the stage seconds, and not in a
                # collection that a later stage would pay for
                trace = None
                gc.collect()
            self.flush()

    def _on_cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _start_trace(self, name: str):
        from torch.profiler import (ProfilerActivity, profile,
                                    supported_activities,
                                    tensorboard_trace_handler)
        path = os.path.join(self.profile_dir, name)
        activities = [ProfilerActivity.CPU]
        if self._on_cuda():
            activities.append(ProfilerActivity.CUDA)
        missing = set(activities) - set(supported_activities())
        if missing:
            raise RuntimeError(f"MANDO_TPU_PROFILE: cannot trace stage "
                               f"{name} into {path}: this torch's profiler "
                               f"lacks {sorted(a.name for a in missing)}")
        if torch.autograd._profiler_enabled():
            raise RuntimeError(f"MANDO_TPU_PROFILE: cannot trace stage "
                               f"{name} into {path}: another profiler is "
                               f"already running")
        try:
            os.makedirs(path, exist_ok=True)
            before = set(glob.glob(os.path.join(path, "*.pt.trace.json")))
            prof = profile(activities=activities, record_shapes=False,
                           profile_memory=False, with_stack=False,
                           on_trace_ready=tensorboard_trace_handler(path))
            prof.start()
        except Exception as e:
            raise RuntimeError(f"MANDO_TPU_PROFILE: cannot start the trace "
                               f"of stage {name} in {path}: {e}") from e
        return prof, path, before

    def _stop_trace(self, prof, path: str, before: set) -> None:
        # the kernels this stage queued end inside its own trace
        if self._on_cuda() and torch.cuda.is_initialized():
            torch.cuda.synchronize(self.device)
        try:
            prof.stop()
        except Exception as e:
            raise RuntimeError(f"MANDO_TPU_PROFILE: cannot write the trace "
                               f"into {path}: {e}") from e
        if not set(glob.glob(os.path.join(path, "*.pt.trace.json"))) - before:
            raise RuntimeError(f"MANDO_TPU_PROFILE: the profiler wrote no "
                               f"trace into {path}")

    def flush(self) -> None:
        if not self.out_path:
            return
        os.makedirs(os.path.dirname(self.out_path), exist_ok=True)
        with open(self.out_path, "w") as fh:
            fh.write("stage\tseconds\titems\titems_per_sec\n")
            for name, dt in self.times.items():
                n = self.counts.get(name, 0)
                rate = n / dt if dt > 0 and n else ""
                fh.write(f"{name}\t{dt:.3f}\t{n or ''}\t"
                         f"{rate and f'{rate:.1f}'}\n")

    def summary(self) -> str:
        lines = [f"\t{name}: {dt:.2f}s"
                 + (f" ({self.counts[name] / dt:.0f}/s)"
                    if self.counts.get(name) and dt > 0 else "")
                 for name, dt in self.times.items()]
        return "\n".join(lines)
