"""The stage profiler hook (MANDO_TPU_PROFILE) of both packages, and its
reader tools/trace_breakdown.py.

The reference wraps every stage in a jax.profiler trace, the port in a
torch.profiler one; on the CPU the port traces the host only. The
artifacts must not change with the hook, and both packages must write
one trace directory a stage under the same names."""

import gc
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
import weakref

import numpy as np
import pytest
import torch

from mandalorion_tpu.config import PipelineConfig as ReferenceConfig
from mandalorion_tpu.native import load_native
from mandalorion_tpu.pipeline.observe import StageTimer as ReferenceTimer
from mandalorion_tpu.pipeline.stages import run_pipeline as reference_run
from mandalorion_tpu.utils.simulate import make_dataset
from mandalorion_tpu_torch.config import PipelineConfig
from mandalorion_tpu_torch.pipeline import observe
from mandalorion_tpu_torch.pipeline.observe import StageTimer, span
from mandalorion_tpu_torch.pipeline.stages import run_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READER = os.path.join(ROOT, "tools", "trace_breakdown.py")
_spec = importlib.util.spec_from_file_location("trace_breakdown", READER)
tb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tb)

ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"))
STAGES = {"index_build", "A_alignment", "P_parsing", "D_define",
          "F_filter", "Q_quant"}


def _artifacts(out_dir):
    blobs = {}
    for name in ARTIFACTS:
        with open(os.path.join(out_dir, name), "rb") as fh:
            blobs[name] = fh.read()
        assert blobs[name], name
    return blobs


def _timing_rows(out_dir):
    with open(os.path.join(out_dir, "tmp", "timing.tsv")) as fh:
        return [line.split("\t")[0] for line in fh][1:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The small dataset of tests/test_torch_pipeline.py (3 genes x 20
    reads, 90 kb) through the reference and the port with the hook, and
    through the port without it."""
    if load_native() is None:
        pytest.skip("native library unavailable")
    tmp = tmp_path_factory.mktemp("observe")
    make_dataset(str(tmp), n_genes=3, n_reads_per_gene=20,
                 genome_len=90_000, seed=0)
    data = [str(tmp / f) for f in ("genome.fasta", "ann.gtf", "reads.fasta")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MANDO_TPU_PROFILE", str(tmp / "ref_trace"))
        reference_run(str(tmp / "ref"), *data, ReferenceConfig(threads=2))
        mp.setenv("MANDO_TPU_PROFILE", str(tmp / "port_trace"))
        run_pipeline(str(tmp / "port"), *data, PipelineConfig(threads=2),
                     device="cpu")
        mp.delenv("MANDO_TPU_PROFILE")
        run_pipeline(str(tmp / "plain"), *data, PipelineConfig(threads=2),
                     device="cpu")
    return tmp


def test_traced_artifacts_match_reference_and_untraced(runs):
    port = _artifacts(runs / "port")
    assert port == _artifacts(runs / "plain")
    assert port == _artifacts(runs / "ref")


def test_one_trace_directory_a_stage_in_both_packages(runs):
    ref = set(os.listdir(runs / "ref_trace"))
    port = set(os.listdir(runs / "port_trace"))
    assert ref == port == STAGES
    assert not os.path.exists(runs / "plain_trace")


def test_port_traces_parse_and_hold_events(runs):
    """A CPU run traces the host only: every stage's trace parses, has
    events, and shows no device event, so its busy time is not
    measured."""
    for stage in STAGES:
        path = tb.stage_trace(str(runs / "port_trace" / stage))
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        assert events, stage
        b = tb.stage_breakdown(path)
        assert b["n_events"] > 0 and b["window_ms"] >= 0
        assert b["busy_ms"] is None and b["idle_share"] is None, stage
    breakdowns = tb.run_breakdown(str(runs / "port_trace"))
    assert set(breakdowns) == STAGES
    assert tb.run_idle_share(breakdowns) is None


def test_timing_rows_match_reference(runs):
    rows = _timing_rows(runs / "port")
    assert rows == _timing_rows(runs / "ref") == _timing_rows(runs / "plain")
    assert set(rows) == STAGES


def test_trace_reader_cli_prints_a_line_a_stage(runs):
    out = subprocess.run([sys.executable, READER,
                          str(runs / "port_trace")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == len(STAGES) + 1
    assert {line.split(":")[0] for line in lines[:-1]} == STAGES
    assert lines[-1] == "run: idle share not measured (no device event)"


class _FakeProfile:
    """Stands in for torch.profiler.profile: records what it was asked
    for, sleeps in start and stop, and writes an empty trace."""

    made: list = []

    def __init__(self, activities, on_trace_ready, **kw):
        self.activities, self.on_trace_ready, self.kw = activities, \
            on_trace_ready, kw
        _FakeProfile.made.append(self)

    def start(self):
        time.sleep(0.3)

    def stop(self):
        time.sleep(0.3)
        self.on_trace_ready(self)

    def export_chrome_trace(self, path, **_kw):
        with open(path, "w") as fh:
            json.dump({"traceEvents": []}, fh)


@pytest.fixture
def fake_profile(monkeypatch):
    _FakeProfile.made = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return _FakeProfile


def test_no_hook_runs_no_profiler(tmp_path, monkeypatch):
    """With MANDO_TPU_PROFILE unset nothing of the profiler runs, a span
    never enters record_function, and no directory is made."""
    monkeypatch.delenv("MANDO_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)

    def refuse(*_a, **_k):
        raise AssertionError("the profiler ran")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    timer = StageTimer(str(tmp_path / "tmp" / "timing.tsv"), device="cpu")
    with timer.stage("A_alignment"):
        with span("align.seed", 3):
            pass
    assert timer.profile_dir is None
    assert os.listdir(tmp_path) == ["tmp"]
    assert sorted(os.listdir(tmp_path / "tmp")) == ["spans.tsv",
                                                    "timing.tsv"]


@pytest.mark.parametrize("device,cuda", [(None, False), ("cpu", False),
                                         ("cuda", True)])
def test_activities_follow_the_device(tmp_path, monkeypatch, fake_profile,
                                      device, cuda):
    """CUDA activity only for a CUDA device; then the stage's queued
    kernels are waited for before the profiler stops, and only when CUDA
    was initialised. Stage seconds leave out the profiler's start and
    stop (0.3 s each here)."""
    from torch.profiler import ProfilerActivity
    monkeypatch.setenv("MANDO_TPU_PROFILE", str(tmp_path / "trace"))
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU, ProfilerActivity.CUDA})
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    timer = StageTimer(None, device=device)
    for initialised in (False, True):
        monkeypatch.setattr(torch.cuda, "is_initialized",
                            lambda: initialised)
        with timer.stage("D_define"):
            pass
    want = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda
                                     else set())
    assert [set(p.activities) for p in fake_profile.made] == [want, want]
    assert fake_profile.made[0].kw == dict(record_shapes=False,
                                           profile_memory=False,
                                           with_stack=False)
    assert synced == ([torch.device("cuda")] if cuda else [])
    assert len(os.listdir(tmp_path / "trace" / "D_define")) == 2
    assert timer.times["D_define"] < 0.3


def test_profiler_is_freed_at_the_stage_end(tmp_path, monkeypatch):
    """The profiler's events live in reference cycles; the stage frees
    them when it ends, so that no later stage's seconds pay for their
    collection."""
    made = []

    class Tracked(torch.profiler.profile):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(weakref.ref(self))

    monkeypatch.setattr(torch.profiler, "profile", Tracked)
    monkeypatch.setenv("MANDO_TPU_PROFILE", str(tmp_path))
    gc.disable()
    try:
        with StageTimer(None, device="cpu").stage("P_parsing"):
            torch.ones(8).sum()
        assert len(made) == 1 and made[0]() is None
    finally:
        gc.enable()


def test_cuda_activity_missing_raises(tmp_path, monkeypatch, fake_profile):
    from torch.profiler import ProfilerActivity
    monkeypatch.setenv("MANDO_TPU_PROFILE", str(tmp_path / "trace"))
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    timer = StageTimer(None, device="cuda")
    with pytest.raises(RuntimeError, match="lacks.*CUDA"):
        with timer.stage("A_alignment"):
            raise AssertionError("the stage ran without its trace")
    assert not fake_profile.made


def test_profile_naming_a_file_raises(tmp_path, monkeypatch):
    """A MANDO_TPU_PROFILE that names a regular file: the port raises
    before the stage runs, naming the directory. The reference does not
    swallow this case either, but it finds out only when it exports,
    after the stage has run (jax.profiler's stop raises "is not a
    directory" and leaves its profiler started, so that half runs in a
    process of its own)."""
    target = tmp_path / "afile"
    target.write_text("")
    monkeypatch.setenv("MANDO_TPU_PROFILE", str(target))
    with pytest.raises(RuntimeError,
                       match=re.escape(str(target / "A_alignment"))):
        with StageTimer(None, device="cpu").stage("A_alignment"):
            raise AssertionError("the stage ran without its trace")
    code = ("from mandalorion_tpu.pipeline.observe import StageTimer\n"
            "try:\n"
            "    with StageTimer(None).stage('A_alignment'):\n"
            "        print('stage ran', flush=True)\n"
            "except Exception as e:\n"
            "    print('raised', type(e).__name__, e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("stage ran\nraised"), out.stdout
    assert "not a directory" in out.stdout, out.stdout


def test_trace_that_cannot_start_raises(tmp_path, monkeypatch):
    """A stage traced while another profiler runs: the reference swallows
    the failure to start (mandalorion_tpu/pipeline/observe.py:29-35) and
    runs the stage with no trace; the port raises, naming the
    directory."""
    import jax
    monkeypatch.setenv("MANDO_TPU_PROFILE", str(tmp_path / "ref"))
    timer = ReferenceTimer(None)
    with jax.profiler.trace(str(tmp_path / "outer")):
        with timer.stage("D_define"):
            pass
    assert "D_define" in timer.times
    assert not os.path.exists(tmp_path / "ref")

    monkeypatch.setenv("MANDO_TPU_PROFILE", str(tmp_path / "port"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError,
                           match=re.escape(str(tmp_path / "port" /
                                               "D_define"))
                           + ".*already running"):
            with StageTimer(None, device="cpu").stage("D_define"):
                raise AssertionError("the stage ran without its trace")


# ------------------------------------------------ spans

# the spans of the CLI's default route (module A staged on the device
# route's plain versions, module D on the native engine), by stage
ROUTE_SPANS = {
    "index_build": {"index.genome", "index.load"},
    "A_alignment": {"align.read", "align.seed", "align.seed.threads",
                    "align.chain", "align.fill", "align.dp", "align.emit",
                    "align.records", "align.write"},
    "D_define": {"define.prepare", "define.resolve", "define.write"},
    "F_filter": {"filter.genome", "filter.realign", "filter.chroms",
                 "filter.write"},
    "run": {"checkpoint_wait"},
}
# the rows recorded inside a span of ROUTE_SPANS: (stage, parent) -> spans
NESTED_SPANS = {
    ("D_define", "define.prepare"): {"define.ends", "define.end_splits"},
    ("F_filter", "filter.chroms"): {
        "filter.ratio", "filter.contain", "filter.drop.absolute",
        "filter.drop.ratio", "filter.drop.polya", "filter.drop.internal",
        "filter.drop.identical"},
}


def _span_rows(out_dir):
    """spans.tsv as [(stage, parent, span, calls, seconds, items)]."""
    with open(os.path.join(out_dir, "tmp", "spans.tsv")) as fh:
        lines = [line.rstrip("\n").split("\t") for line in fh]
    assert lines[0] == ["stage", "parent", "span", "calls", "seconds",
                        "items"]
    return [(st, par, name, int(calls), float(sec),
             int(items) if items else None)
            for st, par, name, calls, sec, items in lines[1:]]


def _stage_seconds(out_dir):
    with open(os.path.join(out_dir, "tmp", "timing.tsv")) as fh:
        lines = [line.rstrip("\n").split("\t") for line in fh]
    assert lines[0] == ["stage", "seconds"]
    return {st: float(sec) for st, sec in lines[1:]}


@pytest.mark.parametrize("run", ["port", "plain"])
def test_spans_tsv_names_each_span_of_the_route(runs, run):
    """Each listed span of the route, under its stage, with its items;
    the traced run adds the profiler's own seconds under run."""
    rows = _span_rows(runs / run)
    got: dict = {}
    for stage, parent, name, calls, _s, items in rows:
        got.setdefault((stage, parent), set()).add(name)
        assert calls >= 1, (stage, name)
    want = {(k, ""): set(v) for k, v in ROUTE_SPANS.items()}
    want.update(NESTED_SPANS)
    if run == "port":
        want[("run", "")].add("profiler")
    assert got == want
    items = {(st, n): i for st, _p, n, _c, _s, i in rows}
    calls = {(st, n): c for st, _p, n, c, _s, _i in rows}
    assert items[("A_alignment", "align.seed")] == 60
    # -t 2 over 60 reads: the C seed stage ran on two threads a call
    seeds = calls[("A_alignment", "align.seed")]
    assert calls[("A_alignment", "align.seed.threads")] == seeds
    assert items[("A_alignment", "align.seed.threads")] == \
        seeds * min(2, os.cpu_count())
    assert items[("A_alignment", "align.read")] == 60
    assert items[("A_alignment", "align.records")] == \
        items[("A_alignment", "align.write")] == 60
    assert items[("D_define", "define.resolve")] == \
        items[("D_define", "define.write")] == 3


@pytest.mark.parametrize("run", ["port", "plain"])
def test_child_spans_sum_to_no_more_than_their_stage(runs, run):
    """A stage's spans are inside its seconds (timing.tsv rounds to the
    millisecond, spans.tsv to the microsecond)."""
    stages = _stage_seconds(runs / run)
    sums: dict = {}
    for stage, parent, _n, _c, seconds, _i in _span_rows(runs / run):
        if stage != "run" and not parent:
            sums[stage] = sums.get(stage, 0.0) + seconds
    assert set(sums) == set(ROUTE_SPANS) - {"run"}
    for stage, total in sums.items():
        assert 0 < total <= stages[stage] + 5e-4 + 1e-5, stage


@pytest.mark.parametrize("stage,name", [("A_alignment", "align.seed"),
                                        ("D_define", "define.resolve")])
def test_traced_stages_hold_their_spans(runs, stage, name):
    """The traced run's stage trace holds the span as a user_annotation
    inside the profiler's window."""
    path = tb.stage_trace(str(runs / "port_trace" / stage))
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    window = [e for e in events if e.get("cat") == "Trace"]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == name]
    assert window and marks, (stage, name)
    lo = min(e["ts"] for e in window)
    hi = max(e["ts"] + e["dur"] for e in window)
    for e in marks:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi
    # the untraced run wrote the same spans and no trace
    assert not os.path.exists(runs / "plain_trace")


def test_span_records_under_its_stage_and_parent(tmp_path):
    """Inside a stage a span records under the stage and the span around
    it, counting calls and summing items; between stages under run;
    spans.tsv is written with the stage rows."""
    timer = StageTimer(str(tmp_path / "tmp" / "timing.tsv"), device="cpu")
    with timer:
        with timer.stage("A_alignment"):
            for n in (3, 4):
                with span("align.seed", n) as outer:
                    with span("inner") as inner:
                        time.sleep(0.001)
        with span("checkpoint_wait"):
            pass
        with timer.stage("D_define"):
            with span("define.write") as s:
                s.items = 7
    assert inner.seconds >= 0.001 and outer.seconds >= inner.seconds
    rows = {(st, par, n): (c, i) for st, par, n, c, _s, i in
            _span_rows(tmp_path)}
    assert rows == {("A_alignment", "", "align.seed"): (2, 7),
                    ("A_alignment", "align.seed", "inner"): (2, None),
                    ("run", "", "checkpoint_wait"): (1, None),
                    ("D_define", "", "define.write"): (1, 7)}
    assert list(_stage_seconds(tmp_path)) == ["A_alignment", "D_define"]
    assert observe.RUNS[-1] is timer and timer.ended >= timer.started
    assert observe._ACTIVE is None


@pytest.mark.parametrize("threads,n_reads,used", [
    (1, 60, 1), (4, 60, 4), (4, 16, 1), (64, 60, 4)],
    ids=["serial", "t4", "one_block", "more_than_blocks"])
def test_seed_threads_span_counts_the_threads_a_seed_call_ran_on(
        tmp_path, threads, n_reads, used):
    """After staged map_batch calls under a running timer, span
    align.seed.threads has the seed calls' count and, over them, the
    threads each ran on (1 on the serial path: one thread, or one block
    of 16 reads); the records are the serial call's."""
    from mandalorion_tpu_torch.align.aligner import TorchSpliceAligner
    from mandalorion_tpu_torch.config import AlignConfig
    from mandalorion_tpu_torch.io.fastx import fastx_to_dict, read_fastx
    if load_native() is None:
        pytest.skip("native library unavailable")
    make_dataset(str(tmp_path), n_genes=3, n_reads_per_gene=20,
                 genome_len=90_000, seed=0)
    genome = fastx_to_dict(str(tmp_path / "genome.fasta"))
    reads = [(n, s) for n, s, _q in
             read_fastx(str(tmp_path / "reads.fasta"))][:n_reads]
    serial = TorchSpliceAligner(genome, AlignConfig(), device="cpu")
    aligner = TorchSpliceAligner.from_aligner(serial, device="cpu",
                                              threads=threads)
    used = min(used, os.cpu_count())
    timer = StageTimer(str(tmp_path / "tmp" / "timing.tsv"), device="cpu")
    with timer.stage("A_alignment"):
        got = [aligner.map_batch(reads) for _ in range(2)]
    rows = {(st, n): (c, i) for st, _p, n, c, _s, i in _span_rows(tmp_path)}
    assert rows[("A_alignment", "align.seed")] == (2, 2 * n_reads)
    assert rows[("A_alignment", "align.seed.threads")] == (2, 2 * used)
    want = [str(r) for r in serial.map_batch(reads)]
    assert want and all([str(r) for r in out] == want for out in got)


def test_span_without_a_running_timer_records_nothing(tmp_path):
    """With no timer running, and in a thread other than the timer's, a
    span times its block for its caller and records nothing."""
    import threading
    with span("align.seed", 5) as s:
        time.sleep(0.001)
    assert s.seconds >= 0.001
    timer = StageTimer(str(tmp_path / "tmp" / "timing.tsv"), device="cpu")
    seen = []

    def other():
        with span("elsewhere") as t:
            pass
        seen.append(t.seconds)

    with timer.stage("A_alignment"):
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive() and len(seen) == 1
    assert timer.spans == {}
    assert os.listdir(tmp_path / "tmp") == ["timing.tsv"]


def test_span_in_a_forked_child_records_nothing(tmp_path):
    """A span entered in a forked child records nothing in the child's
    copy of the timer, and nothing reaches the parent's file."""
    timer = StageTimer(str(tmp_path / "tmp" / "timing.tsv"), device="cpu")
    read_end, write_end = os.pipe()
    with timer.stage("D_define"):
        with span("define.prepare"):
            pid = os.fork()
            if pid == 0:    # the child: report, and leave at once
                ok = False
                try:
                    with span("child.only"):
                        pass
                    ok = observe._ACTIVE is None and not any(
                        k[2] == "child.only" for k in timer.spans)
                finally:
                    os.write(write_end, b"1" if ok else b"0")
                    os._exit(0)
            os.close(write_end)
            with os.fdopen(read_end, "rb") as fh:
                said = fh.read()
            _pid, status = os.waitpid(pid, 0)
    assert status == 0 and said == b"1"
    names = [n for _st, _p, n, *_r in _span_rows(tmp_path)]
    assert names == ["define.prepare"]


def _poa_sets(seed, n_sets=3, n_reads=4, length=48):
    """Read sets of a random template, each read with two
    substitutions."""
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(n_sets):
        template = rng.integers(0, 4, length).astype(np.uint8)
        reads = []
        for _r in range(n_reads):
            read = template.copy()
            at = rng.choice(length, 2, replace=False)
            read[at] = (read[at] + 1) % 4
            reads.append(read)
        sets.append(reads)
    return sets


@pytest.mark.parametrize("graphs", ["native", "python"])
def test_run_observer_reads_the_poa_spans(tmp_path, monkeypatch, graphs):
    """RunObserver's fill_s and apply_s are the poa.fill and poa.apply
    spans' seconds, native and Python graphs alike; the round's spans sit
    inside define.resolve."""
    from mandalorion_tpu_torch.poa import kernels as K
    from mandalorion_tpu_torch.poa.graph import PoaParams
    if graphs == "native" and K.load_native() is None:
        pytest.skip("native library unavailable")
    if graphs == "python":
        monkeypatch.setattr(K, "load_native", lambda: None)
    obs = K.RunObserver()
    monkeypatch.setattr(K, "OBSERVER", obs)
    timer = StageTimer(str(tmp_path / "tmp" / "timing.tsv"), device="cpu")
    with timer.stage("D_define"):
        with span("define.resolve", 3):
            K.poa_consensus_batch(_poa_sets(7), PoaParams(band=16),
                                  device="cpu")
    spans = timer.spans
    fill = spans[("D_define", "define.resolve", "poa.fill")]
    apply = spans[("D_define", "define.resolve", "poa.apply")]
    dispatch = spans[("D_define", "define.resolve", "poa.dispatch")]
    assert obs.rounds == 3 and fill[0] == dispatch[0] >= 3
    assert dispatch[2] == sum(c[0] for c in obs.chunks)
    assert obs.fill_s == fill[1] and obs.apply_s == apply[1]
    assert fill[1] > 0 and apply[1] > 0
    rows = {(st, par, n): sec for st, par, n, _c, sec, _i in
            _span_rows(tmp_path)}
    assert rows[("D_define", "define.resolve", "poa.fill")] == \
        pytest.approx(obs.fill_s, abs=1e-6)
    assert rows[("D_define", "define.resolve", "poa.apply")] == \
        pytest.approx(obs.apply_s, abs=1e-6)


@pytest.mark.parametrize("graphs", ["native", "python"])
def test_poa_round_counts_each_rounds_problems(tmp_path, monkeypatch,
                                               graphs):
    """Count poa.round has a call a round and, over them, the rounds'
    problems (the dispatched ones); poa.round.first the first round's,
    every set of two reads or more; neither has seconds."""
    from mandalorion_tpu_torch.poa import kernels as K
    from mandalorion_tpu_torch.poa.graph import PoaParams
    if graphs == "native" and K.load_native() is None:
        pytest.skip("native library unavailable")
    if graphs == "python":
        monkeypatch.setattr(K, "load_native", lambda: None)
    obs = K.RunObserver()
    monkeypatch.setattr(K, "OBSERVER", obs)
    sets = _poa_sets(7, n_sets=4, n_reads=4)
    sets[1], sets[2] = sets[1][:2], sets[2][:1]
    timer = StageTimer(str(tmp_path / "tmp" / "timing.tsv"), device="cpu")
    with timer.stage("D_define"):
        with span("define.resolve", 4):
            K.poa_consensus_batch(sets, PoaParams(band=16), device="cpu")
    rows = {(st, par, n): (c, s, i) for st, par, n, c, s, i in
            _span_rows(tmp_path)}
    assert rows[("D_define", "define.resolve", "poa.round")] == \
        (obs.rounds, 0.0, sum(c[0] for c in obs.chunks)) == (3, 0.0, 7)
    assert rows[("D_define", "define.resolve", "poa.round.first")] == \
        (1, 0.0, 3)


@pytest.mark.parametrize("threads", [1, 3])
def test_poa_stage_counts_threads_and_grows(tmp_path, monkeypatch, threads):
    """Count poa.stage.threads has a call a native staging or applying
    call, two a chunk, and over them the threads each ran on (1 on the
    serial path: one thread, or a chunk of one problem); poa.stage.grow
    one call a poa_consensus_batch call, its buffers' growths as items."""
    from mandalorion_tpu_torch.poa import kernels as K
    from mandalorion_tpu_torch.poa.graph import PoaParams
    if K.load_native() is None:
        pytest.skip("native library unavailable")
    obs = K.RunObserver()
    monkeypatch.setattr(K, "OBSERVER", obs)
    made = []

    class Seen(K.ChunkStaging):
        def __init__(self, device):
            super().__init__(device)
            made.append(self)

    monkeypatch.setattr(K, "ChunkStaging", Seen)
    sets = _poa_sets(7, n_sets=4, n_reads=4)
    sets[1] = sets[1][:2]
    timer = StageTimer(str(tmp_path / "tmp" / "timing.tsv"), device="cpu")
    with timer.stage("D_define"):
        with span("define.resolve", 4):
            K.poa_consensus_batch(sets, PoaParams(band=16), device="cpu",
                                  threads=threads)
    rows = {(st, par, n): (c, s, i) for st, par, n, c, s, i in
            _span_rows(tmp_path)}
    used = [1 if b == 1 else min(threads, b) for b, *_r in obs.chunks]
    assert rows[("D_define", "define.resolve", "poa.stage.threads")] == \
        (2 * len(obs.chunks), 0.0, 2 * sum(used))
    [staging] = made
    assert staging.grows >= 1
    assert rows[("D_define", "define.resolve", "poa.stage.grow")] == \
        (1, 0.0, staging.grows)


@pytest.fixture(scope="module")
def event_runs(tmp_path_factory):
    """The port's CLI (default route, -t 2) on a small sample of the
    benchmark's isoform_events generator (every event kind, a tandem pair
    among them), traced and untraced, and on the same genes with exon
    skipping alone (planted_isoforms)."""
    import event_samples
    from mandalorion_tpu_torch.pipeline.cli import main
    if load_native() is None:
        pytest.skip("native library unavailable")
    tmp = tmp_path_factory.mktemp("events")
    events = event_samples.make(str(tmp / "events"))
    skips = event_samples.make(str(tmp / "skips"), event_samples.SKIPS)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, s, trace in (("traced", events, True),
                              ("plain", events, False),
                              ("skips", skips, False)):
            if trace:
                mp.setenv("MANDO_TPU_PROFILE", str(tmp / "trace"))
            else:
                mp.delenv("MANDO_TPU_PROFILE", raising=False)
            runs[tag] = str(tmp / tag)
            assert main(["-p", runs[tag], *s.args, "-t", "2",
                         "--device", "cpu"]) == 0
    return runs


def _items(out_dir):
    """{(stage, span): (calls, items)} of a run's spans.tsv."""
    return {(st, n): (c, i) for st, _p, n, c, _s, i in _span_rows(out_dir)}


def test_filter_drops_and_kept_add_up_to_the_consensi(event_runs):
    """Module F's drop counters and the isoforms it kept account for every
    consensus module D wrote; filter.ratio keeps what filter.contain
    takes, and filter.contain keeps what Isoforms.filtered.fasta holds."""
    for tag in ("plain", "traced", "skips"):
        got = _items(event_runs[tag])
        kept = got[("F_filter", "filter.contain")][1]
        drops = {n.rsplit(".", 1)[1]: got[("F_filter", n)][1] for _st, n in
                 got if n.startswith("filter.drop.")}
        assert set(drops) == {"absolute", "ratio", "polya", "internal",
                              "identical"}
        assert kept + sum(drops.values()) == \
            got[("D_define", "define.write")][1]
        assert got[("F_filter", "filter.ratio")][1] == kept + \
            drops["polya"] + drops["internal"] + drops["identical"]
        with open(os.path.join(event_runs[tag],
                               "Isoforms.filtered.fasta")) as fh:
            assert fh.read().count(">") == kept > 0


def test_end_calling_spans_and_splits(event_runs):
    """define.ends has the groups that end calling formed (module D's
    consensi, every group here being of enough reads); define.end_splits
    counts the tandem-UTR sample's split splice groups, and none where
    exons are only skipped."""
    for tag in ("plain", "skips"):
        got = _items(event_runs[tag])
        assert got[("D_define", "define.ends")][1] == \
            got[("D_define", "define.write")][1]
    assert _items(event_runs["plain"])[("D_define",
                                        "define.end_splits")][1] >= 1
    assert _items(event_runs["skips"])[("D_define",
                                        "define.end_splits")] == (1, 0)


def test_event_outputs_do_not_change_with_tracing(event_runs):
    """Traced and untraced, the same seven files and the same span rows
    with the same counts (the traced run adds the profiler's own)."""
    assert artifacts_of(event_runs["traced"]) == \
        artifacts_of(event_runs["plain"])
    traced = {k: v[1] for k, v in _items(event_runs["traced"]).items()
              if k != ("run", "profiler")}
    assert traced == {k: v[1] for k, v in
                      _items(event_runs["plain"]).items()}


def artifacts_of(out_dir):
    blobs = _artifacts(out_dir)
    with open(os.path.join(out_dir, "Isoforms.filtered.clean.genes"),
              "rb") as fh:
        blobs["genes"] = fh.read()
    return blobs


def test_profiler_seconds_are_recorded_under_run(tmp_path, monkeypatch,
                                                 fake_profile):
    """The profiler's start, stop and export (0.3 s each way here) go to
    span profiler under run, and stay out of the stage seconds; a span
    inside the traced stage enters record_function."""
    monkeypatch.setenv("MANDO_TPU_PROFILE", str(tmp_path / "trace"))
    entered = []

    class Mark:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Mark)
    timer = StageTimer(str(tmp_path / "tmp" / "timing.tsv"), device="cpu")
    with timer:
        with timer.stage("A_alignment"):
            with span("align.seed"):
                pass
        with span("checkpoint_wait"):
            pass
    assert entered == ["align.seed"]
    assert timer.times["A_alignment"] < 0.3
    calls, seconds, items = timer.spans[("run", "", "profiler")]
    assert calls == 2 and seconds >= 0.6 and items is None


def test_span_costs_little_without_the_hook(monkeypatch):
    """10^5 empty spans under a running timer without MANDO_TPU_PROFILE:
    under 5 us each (the best of five repeats, against a loaded host)."""
    monkeypatch.delenv("MANDO_TPU_PROFILE", raising=False)
    timer = StageTimer(None)
    best = float("inf")
    with timer:
        with timer.stage("A_alignment"):
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(100_000):
                    with span("align.seed"):
                        pass
                best = min(best, (time.perf_counter() - t0) / 100_000)
    assert timer.spans[("A_alignment", "", "align.seed")][0] == 500_000
    assert best < 5e-6, best


def _event(cat, name, t0, t1, **kw):
    """A complete event from t0 to t1 in ms (the trace counts in us)."""
    return dict(ph="X", cat=cat, name=name, ts=1e3 * t0, dur=1e3 * (t1 - t0),
                pid=1, tid=1, **kw)


HAND_TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "x"}},
    _event("cpu_op", "aten::stage", 0, 40),
    _event("cpu_op", "aten::to", 16, 26),
    _event("cpu_op", "aten::copy_", 30, 35),
    _event("kernel", "void k1(int)", 0, 10),
    _event("kernel", "void k1(int)", 5, 15),
    _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 20, 25),
]}
HOST_TRACE = {"traceEvents": [_event("cpu_op", "aten::add", 3, 7),
                              _event("Trace", "PyTorch Profiler (0)", 0, 9)]}


@pytest.mark.parametrize("case", ["busy", "gaps", "ops", "no_device"])
def test_stage_breakdown_of_hand_made_traces(case):
    if case == "no_device":
        b = tb.stage_breakdown(HOST_TRACE)
        assert (b["window_ms"], b["busy_ms"], b["idle_share"]) == \
            (9.0, None, None)
        assert b["device_ops"] == [] and b["gaps"] == []
        with pytest.raises(ValueError, match="no device event"):
            tb.stage_breakdown(HOST_TRACE, expect_device=True)
        return
    b = tb.stage_breakdown(HAND_TRACE, expect_device=True)
    if case == "busy":
        # the kernels [0, 10] and [5, 15] overlap: they count once
        assert (b["window_ms"], b["busy_ms"], b["idle_share"]) == \
            (40.0, 20.0, 0.5)
        assert b["n_events"] == 6
    elif case == "gaps":
        # idle [25, 40] and [15, 20], the longest first, each labelled by
        # the innermost host op over its middle: aten::copy_ (30-35)
        # covers 32.5, aten::to (16-26) 17.5, both inside aten::stage
        assert b["gaps"] == [(25.0, 15.0, "aten::copy_"),
                             (15.0, 5.0, "aten::to")]
    else:
        assert b["device_ops"] == [
            ("void k1(int)", 20.0, 2),
            ("Memcpy HtoD (Pageable -> Device)", 5.0, 1)]
        totals = tb.kernel_totals({"s": b}, ["k1", "k"])
        assert totals == {"k1": (20.0, 2), "k": (0.0, 0)}


@pytest.mark.cuda
def test_cuda_trace_sees_the_dp_kernel(tmp_path, monkeypatch):
    """On the card: one solve_dp_fused batch under the hook; its trace
    names dp_fused_kernel as often as the launch counter moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from mandalorion_tpu_torch.align import kernels
    from mandalorion_tpu_torch.config import AlignConfig
    from test_torch_dp import MODES, _descriptors, _random_problems
    rng = np.random.default_rng(29)
    problems = []
    for mode in MODES:
        problems += _random_problems(rng, 60, mode, max_len=300)
    probs, oriented, read_off, genome = _descriptors(problems)
    genome_t = torch.from_numpy(genome).to("cuda")
    kernels.solve_dp_fused(probs, oriented, read_off, genome_t,
                           AlignConfig())   # build and warm up untraced
    monkeypatch.setenv("MANDO_TPU_PROFILE", str(tmp_path))
    timer = StageTimer(None, device="cuda")
    before = kernels.DP_LAUNCHES.count
    with timer.stage("A_alignment"):
        kernels.solve_dp_fused(probs, oriented, read_off, genome_t,
                               AlignConfig())
    launches = kernels.DP_LAUNCHES.count - before
    b = tb.run_breakdown(str(tmp_path), expect_device=["A_alignment"])
    ms, count = tb.kernel_totals(b, ["dp_fused_kernel"])["dp_fused_kernel"]
    assert launches > 0 and count == launches, (launches, b)
    assert ms > 0 and b["A_alignment"]["busy_ms"] >= ms * 0.999
