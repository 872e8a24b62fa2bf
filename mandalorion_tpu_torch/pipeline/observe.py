"""Observability: per-stage wall times.

Every stage reports wall time and item counts into tmp/timing.tsv
(counterpart of mandalorion_tpu/pipeline/observe.py without its
profiler hook)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


class StageTimer:
    """Collects per-stage wall times; writes tmp/timing.tsv."""

    def __init__(self, out_path: Optional[str] = None):
        self.out_path = out_path
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, count: Optional[int] = None) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if count is not None:
                self.counts[name] = self.counts.get(name, 0) + count
            self.flush()

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
