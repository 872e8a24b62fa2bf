"""The benchmark's run of one cell: set-up, the window of whole jobs, the
traced readings, and the comparison with the reference.

Everything a cell is made of is found by name: BENCHMARK.json's entry of
the cell names its configuration (configs/<name>.json) and its traffic
mix (traffic/<name>.json); the configuration names its data generator
(generators/<name>.py), and each metric is a reader in metrics/<name>.py
with one function, `read(run)`, that returns a number or None (nothing
to read in this run). A cell, a mix, a generator or a metric is added by
adding files and entries.

A generator module has `make_layout(config, seed)` (the genome and
annotation), `write_layout(layout, dir)`, `expression(mix, layout)` (a
mix's profile), `make_sample(layout, config, profile, seed, path)` (a
sample of the pool: its reads file and what the judge needs),
`judge(layout, config, sample, answer)` (one job's counts),
`numbers(per_job)` (the numbers compared, named in `NUMBERS`, each held
to the configuration's `limits`) and `control_answer(layout, config,
sample, seed)`.

A job is one call of the port's command line entry
(`mandalorion_tpu_torch.pipeline.cli.main`) in this process, over one
sample of the mix's pool, into a fresh output directory, with the
configuration's flags and the index cache that the warm-up job wrote.
After each job its answer is parsed and its directory deleted, outside
the window's time: the window's seconds are the jobs' own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import bm_data
import bm_reference
import bm_roofline
import bm_trace

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "mandalorion_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------ finding a cell

@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int
    generator: object


def _load_json(kind: str, name: str, base: str) -> dict:
    path = os.path.join(base, kind, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, base: str = HERE) -> Cell:
    """The cell `name` of a BENCHMARK.json object, with its files read
    from under `base`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the cells are "
                       f"{', '.join(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in e2e_names]
    config = _load_json("configs", w["config"], base)
    return Cell(name, config, _load_json("traffic", w["traffic"], base),
                e2e, layer, int(w["chips"]),
                _module("generators", config["generator"], base))


def list_cells(bench: dict, base: str = HERE) -> List[str]:
    """Every cell whose configuration and traffic files exist."""
    return [w["name"] for w in bench["workloads"]
            if os.path.exists(os.path.join(base, "configs",
                                           f"{w['config']}.json"))
            and os.path.exists(os.path.join(base, "traffic",
                                            f"{w['traffic']}.json"))]


def _module(kind: str, name: str, base: str = HERE):
    """<kind>/<name>.py as a module."""
    path = os.path.join(base, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"bm_{kind}_{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def reader(name: str, base: str = HERE):
    """metrics/<name>.py's `read`."""
    return _module("metrics", name, base).read


# ------------------------------------------------ what a run records

@dataclasses.dataclass
class Job:
    sample: int
    n_reads: int
    start: float
    end: float
    stages: Dict[str, float]
    peak_bytes: Optional[int] = None
    trace: Optional[Dict[str, dict]] = None   # stage -> breakdown
    rounds: int = 0
    fill_s: float = 0.0
    apply_s: float = 0.0
    fwd_bytes: int = 0
    answer: Optional[bm_reference.Answer] = None
    written: int = 0      # bytes of its output directory


@dataclasses.dataclass
class Run:
    """What the metric readers read. The window's seconds are the sum of
    its jobs' own: the harness's work between jobs is left out."""
    cell: str
    on_cuda: bool
    traced: bool
    setup_s: float
    data_s: float
    jobs: List[Job]
    power_limit: str = ""
    failed: int = 0
    memory_peak: Optional[int] = None
    written: int = 0      # bytes of the data, the cache and the jobs
    host: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def reads(self) -> int:
        return sum(j.n_reads for j in self.jobs)

    @property
    def window_s(self) -> float:
        return sum(j.end - j.start for j in self.jobs)

    def stage_s(self, *names: str) -> float:
        return sum(j.stages.get(n, 0.0) for j in self.jobs for n in names)

    def traced_jobs(self) -> List[Job]:
        return [j for j in self.jobs if j.trace is not None]


def process_start() -> float:
    """This process's start on the epoch clock, from /proc (10 ms
    ticks); the harness's import time where /proc is missing."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, StopIteration, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


@contextlib.contextmanager
def stdout_to_stderr():
    """File descriptor 1 on stderr while entered, for this process, the
    program's forked workers and native code alike, so that stdout
    carries the result line alone."""
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def stage_seconds(out_dir: str) -> Dict[str, float]:
    with open(os.path.join(out_dir, "tmp", "timing.tsv")) as fh:
        return {f[0]: float(f[1]) for f in
                (line.rstrip("\n").split("\t") for line in fh)
                if len(f) > 1 and f[0] != "stage"}


def _smi(query: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def power_limit() -> str:
    return _smi("name,power.limit")


def cpu_ticks() -> Optional[List[int]]:
    """The host's CPU time counters (/proc/stat's first line), or None."""
    try:
        with open("/proc/stat") as fh:
            return [int(x) for x in fh.readline().split()[1:]]
    except (OSError, ValueError):
        return None


def host_state(on_cuda: bool, since: Optional[List[int]] = None) -> str:
    """The host's mean CPU clock and, since `since`, the share of its CPU
    time that was busy and that was stolen by other guests; on a card its
    SM clock, power draw and temperature, at this moment."""
    parts = []
    try:
        with open("/proc/cpuinfo") as fh:
            mhz = [float(line.split(":")[1]) for line in fh
                   if line.startswith("cpu MHz")]
        if mhz:
            parts.append(f"cpu {sum(mhz) / len(mhz):.0f} MHz")
    except (OSError, ValueError):
        pass
    now = cpu_ticks()
    if since and now:
        d = [b - a for a, b in zip(since, now)]
        total = sum(d) or 1
        idle = d[3] + (d[4] if len(d) > 4 else 0)
        steal = d[7] if len(d) > 7 else 0
        parts.append(f"busy {100 * (total - idle) / total:.1f}%, "
                     f"steal {100 * steal / total:.2f}%")
    if on_cuda:
        parts.append("card " + _smi("clocks.sm,power.draw,temperature.gpu"))
    return ", ".join(parts)


def tree_bytes(path: str) -> int:
    """Bytes of the files under path."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files
               if os.path.isfile(os.path.join(d, f)))


def shm_names() -> set:
    try:
        return set(os.listdir("/dev/shm"))
    except OSError:
        return set()


# ------------------------------------------------ one run

class _Program:
    """The port's entry and hooks, imported at set-up."""

    def __init__(self, device: str):
        import torch
        from mandalorion_tpu_torch.pipeline import cli
        from mandalorion_tpu_torch.poa import kernels as poa_kernels
        self.torch = torch
        self.cli = cli
        self.poa_kernels = poa_kernels
        self.on_cuda = device == "cuda"
        if self.on_cuda:
            from mandalorion_tpu_torch import _build
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            _build.load_kernels()
        from mandalorion_tpu_torch.runtime import require_native
        require_native("the benchmark's configurations")

    def observer(self):
        base = self.poa_kernels.RunObserver

        class ByteObserver(base):
            """Counts the least bytes of every forward launch."""

            def __init__(self):
                super().__init__()
                self.fwd_bytes = 0

            def chunk(self, k, arrays, W, l_cap, params):
                super().chunk(k, arrays, W, l_cap, params)
                self.fwd_bytes += bm_roofline.poa_fwd_bytes(arrays, W)

        return ByteObserver()

    def reset_peak(self) -> None:
        if self.on_cuda:
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> Optional[int]:
        if not self.on_cuda:
            return None
        self.torch.cuda.synchronize()
        return int(self.torch.cuda.max_memory_allocated())

    def sync(self) -> None:
        if self.on_cuda:
            self.torch.cuda.synchronize()

    def run(self, out_dir: str, genome: str, ann: str, reads: str,
            flags, device: str, cache: str) -> None:
        rc = self.cli.main(["-p", out_dir, "-G", genome, "-g", ann,
                            "-f", reads, *flags, "--device", device,
                            "--index_cache", cache])
        if rc != 0:
            raise RuntimeError(f"the command line entry returned {rc}")


def adopt_orphans() -> None:
    """Make this process the parent of every orphan among its descendants
    (Linux's child subreaper), so that a process that a forked worker of
    the program leaves behind is this run's to wait for."""
    try:
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def reap_children() -> int:
    """Stop multiprocessing's resource tracker, where the program started
    one (it would outlive this process), and wait for every child of this
    process that has ended; how many."""
    from multiprocessing import resource_tracker
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    n = 0
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return n
        if pid == 0:
            return n
        n += 1


def live_children() -> List[str]:
    """The command lines of this process's children still running."""
    out = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/children") as fh:
                pids = fh.read().split()
        except OSError:
            continue
        for pid in pids:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as fh:
                    out.append(f"{pid}: " + fh.read().replace(
                        b"\0", b" ").decode(errors="replace")[:120])
            except OSError:
                pass
    return out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", work_root: Optional[str] = None,
             t_start: Optional[float] = None, reap: bool = False) -> dict:
    """One run of a cell; returns the result object that run.py prints
    (without `device`'s card name when device is 'cpu'). With `reap`,
    the children that have ended are waited for once the window closes."""
    t_start = process_start() if t_start is None else t_start
    work = tempfile.mkdtemp(prefix="mando_bench_", dir=work_root)
    try:
        with stdout_to_stderr():
            run, lay, pool, shm_left = _run(cell, seed, seconds, traced,
                                            device, work, t_start)
        if reap:
            log(f"processes reaped after the window: {reap_children()}, "
                f"still running: {live_children()}")
        return _result(cell, run, lay, pool, seed, shm_left)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, seed, seconds, traced, device, work, t_start):
    cfg, mix, gen = cell.config, cell.traffic, cell.generator
    shm_before = shm_names()
    prog = _Program(device)
    limit = power_limit() if prog.on_cuda else "cpu"

    t_data = time.time()
    lay = gen.make_layout(cfg, bm_data.sub_seed(seed, 1))
    genome, ann = gen.write_layout(lay, os.path.join(work, "ref"))
    profile = gen.expression(mix, lay)
    n_pool = int(mix["pool"])
    pool = [gen.make_sample(lay, cfg, profile,
                            bm_data.sub_seed(seed, 2, k),
                            os.path.join(work, f"sample{k}.fasta"))
            for k in range(n_pool)]
    # the warm-up: one more sample of the mix, at the window's own shapes
    warm = gen.make_sample(lay, cfg, profile, bm_data.sub_seed(seed, 3),
                           os.path.join(work, "warmup.fasta"))
    data_s = time.time() - t_data
    log(f"data: {data_s:.3f} s (not in setup_s): {len(lay.genes)} genes on "
        f"{len(lay.genome)} bp, pool of {len(pool)} samples of "
        f"{[s.n_reads for s in pool]} reads, warm-up {warm.n_reads} reads")

    flags = list(cfg["flags"])
    cache = os.path.join(work, "index_cache.npz")
    warm_out = os.path.join(work, "warmup_out")
    prog.reset_peak()
    prog.run(warm_out, genome, ann, warm.path, flags, device, cache)
    peaks = [prog.peak()]
    log(f"warm-up job: {stage_seconds(warm_out)}")
    written = tree_bytes(work)
    shutil.rmtree(warm_out)

    jobs: List[Job] = []
    failed = 0
    host = {"before": host_state(prog.on_cuda)}
    ticks = cpu_ticks()
    busy = 0.0
    setup_s = time.time() - t_start - data_s
    while busy < seconds:
        k = len(jobs) + failed
        sample = pool[k % len(pool)]
        out = os.path.join(work, f"job{k}")
        trace_root = os.path.join(work, f"trace{k}")
        obs = None
        if traced:
            os.environ["MANDO_TPU_PROFILE"] = trace_root
            obs = prog.observer()
            prog.poa_kernels.OBSERVER = obs
        prog.reset_peak()
        t0 = time.time()
        try:
            prog.run(out, genome, ann, sample.path, flags, device, cache)
            prog.sync()
        except Exception:
            failed += 1
            busy += time.time() - t0
            log(f"job {k} failed:\n{traceback.format_exc()}")
            shutil.rmtree(out, ignore_errors=True)
            continue
        finally:
            os.environ.pop("MANDO_TPU_PROFILE", None)
            prog.poa_kernels.OBSERVER = None
        t1 = time.time()
        busy += t1 - t0
        # between jobs, outside the window: the answer, then the files go
        try:
            job = Job(k % len(pool), sample.n_reads, t0, t1,
                      stage_seconds(out), prog.peak(),
                      answer=bm_reference.parse_answer(out),
                      written=tree_bytes(out))
        except (OSError, ValueError):
            failed += 1
            log(f"job {k} left no answer to read:\n{traceback.format_exc()}")
            continue
        finally:
            shutil.rmtree(out, ignore_errors=True)
        if traced:
            job.trace = bm_trace.run_traces(trace_root, prog.on_cuda)
            shutil.rmtree(trace_root, ignore_errors=True)
            job.rounds, job.fill_s, job.apply_s = (obs.rounds, obs.fill_s,
                                                   obs.apply_s)
            job.fwd_bytes = obs.fwd_bytes
        peaks.append(job.peak_bytes)
        jobs.append(job)
        written += job.written
        log(f"job {k}: sample {job.sample}, {job.n_reads} reads, "
            f"{t1 - t0:.3f} s, stages {job.stages}, device peak "
            f"{job.peak_bytes}, {job.written} bytes, "
            f"{host_state(False, ticks)}")
    host["after"] = host_state(prog.on_cuda, ticks)
    run = Run(cell.name, prog.on_cuda, traced, setup_s, data_s, jobs, limit,
              failed, max((p for p in peaks if p is not None), default=None),
              written, host)
    shm_left = sorted(shm_names() - shm_before)
    return run, lay, pool, shm_left


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _result(cell, run, lay, pool, seed, shm_left) -> dict:
    gen = cell.generator
    failed = run.failed
    metrics = {}
    for m in (cell.per_layer if run.traced else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t0 = time.time()
    per_job = [gen.judge(lay, cell.config, pool[job.sample], job.answer)
               for job in run.jobs]
    got = gen.numbers(per_job)
    limits = cell.config["limits"]
    checks = {k: {"value": got[k], "limit": limits[k]} for k in gen.NUMBERS}
    correct = (bool(run.jobs) and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    window_s = run.window_s
    log(f"window: {len(run.jobs)} jobs, {run.reads} reads in "
        f"{window_s:.3f} s ({run.reads / window_s if window_s else 0:.3f} "
        f"reads/s), setup {run.setup_s:.3f} s, data {run.data_s:.3f} s, "
        f"check {time.time() - t0:.3f} s, written {run.written} bytes, "
        f"card {run.power_limit}, host {run.host}")
    for j, counts in enumerate(per_job):
        log(f"job {j} counts: {counts}")
    if shm_left:
        log(f"/dev/shm entries left by the jobs: {shm_left}")
    result = {
        "correct": correct, "attempted": len(run.jobs) + failed,
        "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if run.on_cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": run.memory_peak},
        "window": {"seconds": window_s, "jobs": len(run.jobs),
                   "reads": run.reads, "setup_s": run.setup_s,
                   "data_s": run.data_s, "seed": seed,
                   "card": run.power_limit, "host": run.host,
                   "shm_left": len(shm_left), "written_bytes": run.written,
                   "job_bytes": [j.written for j in run.jobs],
                   "job_s": [j.end - j.start for j in run.jobs],
                   "stage_s": {s: run.stage_s(s) for s in
                               ("index_build", "A_alignment", "P_parsing",
                                "D_define", "F_filter", "Q_quant")}},
    }
    if run.traced:
        traced = run.traced_jobs()
        busy = sum(b["busy_s"] or 0.0 for j in traced
                   for b in j.trace.values())
        span = sum(b["window_s"] for j in traced for b in j.trace.values())
        result["device"].update(busy_s=busy, window_s=span)
        result["breakdown"] = breakdown(traced)
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    result["checks"] = checks
    return result


def breakdown(jobs: List[Job], top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by stage and the host operation that covers each."""
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for j in jobs:
        for stage, b in j.trace.items():
            for name, s in b["device_ops"].items():
                ops[name[:160]] = ops.get(name[:160], 0.0) + s
            for label, s in b["gaps"]:
                key = f"{stage}: {label or 'no traced host op'}"[:160]
                gaps[key] = gaps.get(key, 0.0) + s
    pick = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]
    return {"device_ops": pick(ops), "idle_gaps": pick(gaps)}
