"""The span readers on canned span tables, and on a traced run of a tiny
cell on the CPU."""

import collections
import os

import pytest

import bm_harness
from mandalorion_tpu_torch.pipeline import observe

SPAN_METRICS = ("A_seed_ms_per_kread", "A_card_ms_per_kread",
                "A_fill_ms_per_kread", "A_emit_ms_per_kread",
                "A_glue_ms_per_kread", "D_prepare_ms_per_kread",
                "D_resolve_ms_per_kread", "unstaged_ms_per_kread")

# (stage, parent, span) -> seconds of one canned job
SPANS = {
    ("index_build", "", "index.genome"): 0.1,
    ("index_build", "", "index.load"): 0.3,
    ("A_alignment", "", "align.read"): 0.05,
    ("A_alignment", "", "align.seed"): 1.0,
    ("A_alignment", "", "align.chain"): 0.02,
    ("A_alignment", "", "align.fill"): 0.2,
    ("A_alignment", "", "align.dp"): 0.08,
    ("A_alignment", "", "align.emit"): 0.3,
    ("A_alignment", "", "align.records"): 0.25,
    ("A_alignment", "", "align.write"): 0.1,
    ("D_define", "", "define.prepare"): 0.4,
    ("D_define", "", "define.resolve"): 0.5,
    ("D_define", "define.resolve", "poa.fill"): 0.2,
    ("D_define", "", "define.write"): 0.05,
    ("run", "", "checkpoint_wait"): 0.02,
    ("run", "", "profiler"): 0.3,
}
STAGES = {"index_build": 0.5, "A_alignment": 2.0, "P_parsing": 0.25,
          "D_define": 1.0, "F_filter": 0.2, "Q_quant": 0.05}


def _timer(start, end):
    """A program run's timer as the program leaves it in observe.RUNS."""
    timer = observe.StageTimer(None)
    timer.started, timer.ended = start, end
    timer.spans = {k: [1, s, None] for k, s in SPANS.items()}
    return timer


@pytest.fixture
def run(monkeypatch):
    """Two traced jobs of 2,000 reads, 4 s each, whose program runs
    started and ended inside them, and a warm-up run before them."""
    runs = collections.deque([_timer(1.0, 3.0), _timer(10.5, 13.5),
                              _timer(15.5, 18.5)])
    monkeypatch.setattr(observe, "RUNS", runs)
    jobs = [bm_harness.Job(k, 2000, start, start + 4.0, dict(STAGES),
                           trace={})
            for k, start in enumerate((10.0, 15.0))]
    return bm_harness.Run("c", True, True, 21.5, 3.0, jobs)


def _read(name, run):
    return bm_harness.reader(name)(run)


def test_span_readers_on_canned_spans(run):
    # a job's seconds of the named spans over its 2,000 reads
    want = {"A_seed_ms_per_kread": 1.0, "A_card_ms_per_kread": 0.1,
            "A_fill_ms_per_kread": 0.2, "A_emit_ms_per_kread": 0.3,
            "A_glue_ms_per_kread": 0.4, "D_prepare_ms_per_kread": 0.4,
            "D_resolve_ms_per_kread": 0.5}
    for name, seconds in want.items():
        assert _read(name, run) == pytest.approx(1e6 * seconds / 2000), name


def test_unstaged_leaves_out_stages_and_profiler(run):
    run.jobs[0].end = run.jobs[0].start + 5.0
    run.jobs[1].end = run.jobs[1].start + 5.0
    # a job: 5.0 wall - 4.0 stages - 0.3 profiler = 0.7 s
    assert _read("unstaged_ms_per_kread", run) == pytest.approx(
        1e6 * 1.4 / 4000)


@pytest.mark.parametrize("case", ["no_runs", "no_match", "untraced"])
def test_span_readers_read_nothing_without_spans(run, monkeypatch, case):
    """A program without spans (the parent commit's: no observe.RUNS), a
    job with no program run inside its window, an untraced run: None."""
    if case == "no_runs":
        monkeypatch.delattr(observe, "RUNS")
    elif case == "no_match":
        monkeypatch.setattr(observe, "RUNS",
                            collections.deque([_timer(1.0, 3.0)]))
    else:
        for job in run.jobs:
            job.trace = None
    for name in SPAN_METRICS:
        assert _read(name, run) is None, name


def test_a_job_reads_its_own_run(run, monkeypatch):
    """Each job reads the run inside its window: a second job whose run
    has twice the seeding shows in the sum."""
    observe.RUNS[2].spans[("A_alignment", "", "align.seed")] = [1, 2.0,
                                                                None]
    assert _read("A_seed_ms_per_kread", run) == pytest.approx(
        1e6 * 3.0 / 4000)


def test_a_traced_run_reads_every_span_metric(tmp_path, tiny_cell):
    """A traced run of a tiny cell on the CPU: each span metric reads a
    number; module A's and D's spans cover most of their stage."""
    result = bm_harness.run_cell(tiny_cell, 2**31 + 7, 0.01, True,
                                 device="cpu", work_root=str(tmp_path))
    assert result["correct"] is True, result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(SPAN_METRICS) <= set(metrics)
    a_parts = sum(metrics[n] for n in SPAN_METRICS[:5])
    d_parts = metrics["D_prepare_ms_per_kread"] + \
        metrics["D_resolve_ms_per_kread"]
    assert 0 < a_parts <= metrics["A_ms_per_kread"] * 1.01
    assert 0 < d_parts <= metrics["D_ms_per_kread"] * 1.01
    assert metrics["unstaged_ms_per_kread"] > 0
    assert os.listdir(tmp_path) == []
