"""Observability: per-stage wall times, spans inside the stages, and
optional profiler traces.

Every stage's wall time goes into tmp/timing.tsv, one row a stage under
the reference's names (counterpart of mandalorion_tpu/pipeline/observe.py;
columns `stage`, `seconds`). Inside the stages, `span(name, items)` times
a named part of the work; the spans go into tmp/spans.tsv beside it, one
row a (stage, span): `stage parent span calls seconds items`, `stage`
being `run` outside every stage and `parent` the span open around it.
`record(name, seconds, items)` adds a row's call for work timed
elsewhere (forked workers' seconds) or counted (no seconds).

With MANDO_TPU_PROFILE=<dir> in the environment when the timer is built,
every stage runs under torch.profiler and writes <dir>/<stage>/
*.pt.trace.json (Chrome trace format: TensorBoard, Perfetto, or
tools/trace_breakdown.py), the layout the reference's jax.profiler traces
take, and each span inside a stage is a `record_function` of its name in
that trace, on the clock of the card's kernels and copies. The device's
kernels are traced only when the timer is given a CUDA device, so a run
on the host routes never starts CUPTI. Unlike the reference, which
carries on without a trace when one cannot be started, a trace that was
asked for and cannot be taken raises. The profiler's own start, stop,
export and collection are left out of the stage seconds and recorded as
span `profiler` under `run`."""

from __future__ import annotations

import collections
import contextlib
import gc
import glob
import os
import time
from threading import get_ident
from time import perf_counter
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import torch

# the timer that spans record into: the one whose run (`with timer:`) or
# stage is open in this process; a forked child starts with none
_ACTIVE: Optional["StageTimer"] = None

# the timers of this process's last runs, oldest first, each added when
# its run ends: a caller that runs the pipeline in its own process reads a
# run's spans here once the run's files are gone
RUNS: Deque["StageTimer"] = collections.deque(maxlen=64)


def _forget_in_child() -> None:
    global _ACTIVE
    _ACTIVE = None


os.register_at_fork(after_in_child=_forget_in_child)


class span:
    """Times the block it wraps. The caller reads `seconds` afterwards and
    may set `items` inside the block. Recorded into the running
    StageTimer when there is one in this process and it was built in this
    thread, under its open stage and the span open around this one; while
    that stage is traced, also a torch.profiler.record_function of the
    same name. Elsewhere (a forked worker, another thread, a library call
    with no timer running) it times its block and records nothing."""

    __slots__ = ("name", "items", "seconds", "_timer", "_parent", "_mark",
                 "_t0")

    def __init__(self, name: str, items: Optional[int] = None):
        self.name = name
        self.items = items
        self.seconds = 0.0

    def __enter__(self) -> "span":
        timer = _ACTIVE
        if timer is not None and timer._thread == get_ident():
            self._timer = timer
            self._parent = timer._open[-1] if timer._open else ""
            timer._open.append(self.name)
            if timer._traced:
                self._mark = torch.profiler.record_function(self.name)
                self._mark.__enter__()
            else:
                self._mark = None
        else:
            self._timer = None
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = dt = perf_counter() - self._t0
        timer = self._timer
        if timer is None:
            return
        if self._mark is not None:
            self._mark.__exit__(*exc)
        timer._open.pop()
        timer._add(self._parent, self.name, dt, self.items)


def record(name: str, seconds: float = 0.0,
           items: Optional[int] = None) -> None:
    """Records one call of span `name` that was not timed here: seconds
    that forked workers measured and returned (summed over workers that
    may have run side by side, so not wall time), or, with none, a count
    whose items are what it counts. It goes where a span entered at this
    point would go, under the open stage and the span open around the
    call, and nowhere where a span would record nothing; it has no
    interval on this process's clock, so no record_function either."""
    timer = _ACTIVE
    if timer is not None and timer._thread == get_ident():
        timer._add(timer._open[-1] if timer._open else "", name, seconds,
                   items)


class StageTimer:
    """Collects per-stage wall times and the spans inside them; writes
    tmp/timing.tsv and tmp/spans.tsv. `device` is the run's device (None
    when the run resolved none): a CUDA device adds the card's activity
    to the traces. Spans record into the timer while one of its stages
    runs, and between its stages while the timer is entered (`with
    timer:`, the whole run), which also adds it to `RUNS` at the end."""

    def __init__(self, out_path: Optional[str] = None, device=None):
        self.out_path = out_path
        self.device = None if device is None else torch.device(device)
        self.times: Dict[str, float] = {}
        # (stage, parent, span) -> [calls, seconds, items or None]
        self.spans: Dict[Tuple[str, str, str], list] = {}
        self.profile_dir = os.environ.get("MANDO_TPU_PROFILE") or None
        self.started = time.time()
        self.ended: Optional[float] = None
        self._thread = get_ident()
        self._stage: Optional[str] = None
        self._traced = False
        self._open: List[str] = []
        self._outer: List[Optional[StageTimer]] = []

    def _add(self, parent: str, name: str, seconds: float,
             items: Optional[int]) -> None:
        key = (self._stage or "run", parent, name)
        row = self.spans.get(key)
        if row is None:
            self.spans[key] = [1, seconds, items]
        else:
            row[0] += 1
            row[1] += seconds
            if items is not None:
                row[2] = (row[2] or 0) + items

    def _activate(self) -> None:
        global _ACTIVE
        self._outer.append(_ACTIVE)
        _ACTIVE = self

    def _deactivate(self) -> None:
        global _ACTIVE
        _ACTIVE = self._outer.pop()

    def __enter__(self) -> "StageTimer":
        self._activate()
        return self

    def __exit__(self, *exc) -> None:
        self._deactivate()
        self.ended = time.time()
        self.flush()
        RUNS.append(self)

    def _record_profiler(self, seconds: float) -> None:
        row = self.spans.setdefault(("run", "", "profiler"), [0, 0.0, None])
        row[0] += 1
        row[1] += seconds

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self._activate()
        try:
            t = perf_counter()
            trace = self._start_trace(name) if self.profile_dir else None
            if trace is not None:
                self._record_profiler(perf_counter() - t)
            self._stage, self._traced = name, trace is not None
            t0 = time.time()
            try:
                yield
            finally:
                # before the profiler's flush and export, as the reference
                dt = time.time() - t0
                self.times[name] = self.times.get(name, 0.0) + dt
                self._stage, self._traced = None, False
                if trace is not None:
                    t = perf_counter()
                    self._stop_trace(*trace)
                    # the profiler holds its events in reference cycles:
                    # free them now, outside the stage seconds, and not in
                    # a collection that a later stage would pay for
                    trace = None
                    gc.collect()
                    self._record_profiler(perf_counter() - t)
                self.flush()
        finally:
            self._deactivate()

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
        tmp = os.path.dirname(self.out_path)
        os.makedirs(tmp, exist_ok=True)
        with open(self.out_path, "w") as fh:
            fh.write("stage\tseconds\n")
            for name, dt in self.times.items():
                fh.write(f"{name}\t{dt:.3f}\n")
        if not self.spans:
            return
        with open(os.path.join(tmp, "spans.tsv"), "w") as fh:
            fh.write("stage\tparent\tspan\tcalls\tseconds\titems\n")
            for (stage, parent, name), (calls, dt, items) in \
                    self.spans.items():
                fh.write(f"{stage}\t{parent}\t{name}\t{calls}\t{dt:.6f}\t"
                         f"{'' if items is None else items}\n")

    def summary(self) -> str:
        return "\n".join(f"\t{name}: {dt:.2f}s"
                         for name, dt in self.times.items())
