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
from mandalorion_tpu_torch.pipeline.observe import StageTimer
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
    """With MANDO_TPU_PROFILE unset nothing of the profiler runs and no
    directory is made."""
    monkeypatch.delenv("MANDO_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)

    def refuse(*_a, **_k):
        raise AssertionError("the profiler ran")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    timer = StageTimer(str(tmp_path / "tmp" / "timing.tsv"), device="cpu")
    with timer.stage("A_alignment", count=3):
        pass
    assert timer.profile_dir is None
    assert os.listdir(tmp_path) == ["tmp"]
    assert os.listdir(tmp_path / "tmp") == ["timing.tsv"]


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
