"""The metric readers on a canned trace and timing.tsv."""

import json

import pytest

import bm_harness
import bm_roofline
import bm_trace
from conftest import bench_json


def _trace(path, events):
    with open(path, "w") as fh:
        json.dump({"traceEvents": [dict(e, ph="X") for e in events]}, fh)
    return str(path)


def _stage(tmp_path, name, device):
    """A stage of 10 ms, a host op over its first half, and `device`
    kernels [(ts_us, dur_us, name)]."""
    events = [{"name": "aten::copy_", "cat": "cpu_op", "ts": 0,
               "dur": 5000},
              {"name": "span", "cat": "user_annotation", "ts": 0,
               "dur": 10_000}]
    events += [{"name": n, "cat": "kernel", "ts": ts, "dur": dur}
               for ts, dur, n in device]
    return bm_trace.stage_breakdown(_trace(tmp_path / f"{name}.json",
                                           events), on_cuda=True)


@pytest.fixture
def run(tmp_path):
    (tmp_path / "tmp").mkdir()
    timing = tmp_path / "tmp" / "timing.tsv"
    timing.write_text("stage\tseconds\titems\titems_per_sec\n"
                      "index_build\t0.500\t\t\nA_alignment\t2.000\t\t\n"
                      "P_parsing\t0.250\t\t\nD_define\t1.000\t\t\n"
                      "F_filter\t0.200\t\t\nQ_quant\t0.050\t\t\n")
    stages = bm_harness.stage_seconds(str(tmp_path))
    trace = {
        # two overlapping kernels: busy 2 ms of 10
        "A_alignment": _stage(tmp_path, "a", [(1000, 1500, "dp_fused_kernel"),
                                              (2000, 1000, "chain_rows")]),
        # 4 ms of the forward, 1 ms of the walk: busy 5 ms of 10
        "D_define": _stage(tmp_path, "d", [(0, 4000, "poa_fwd_kernel<1>"),
                                           (6000, 1000, "poa_walk_kernel")]),
        # no device event on a CUDA run: wholly idle
        "P_parsing": _stage(tmp_path, "p", []),
    }
    jobs = [bm_harness.Job(0, 2000, 10.0, 14.0, stages, 2_000_000_000,
                           trace, rounds=3, fill_s=0.2, apply_s=0.05,
                           fwd_bytes=int(0.134e9)),
            # a second apart: the harness read the first job's answer
            bm_harness.Job(1, 2000, 15.0, 19.0, stages, 3_500_000_000)]
    return bm_harness.Run("c", True, True, 21.5, 3.0, jobs)


def _read(name, run):
    return bm_harness.reader(name)(run)


def test_end_to_end(run):
    # the jobs' own 8 s: the second between them is the harness's
    assert _read("reads_per_s", run) == pytest.approx(4000 / 8.0)
    assert _read("setup_s", run) == 21.5


def test_stage_seconds_per_kread(run):
    # (0.5 + 0.25 + 0.2 + 0.05) s a job over 2,000 reads a job
    assert _read("host_ms_per_kread", run) == pytest.approx(500.0)
    assert _read("A_ms_per_kread", run) == pytest.approx(1000.0)
    assert _read("D_ms_per_kread", run) == pytest.approx(500.0)


def test_trace_readers(run):
    assert run.jobs[0].trace["A_alignment"]["busy_s"] == pytest.approx(2e-3)
    assert _read("A_idle_share", run) == pytest.approx(80.0)
    # busy 2 + 5 + 0 ms of 30 ms
    assert _read("idle_share", run) == pytest.approx(100 * (1 - 7 / 30))
    assert _read("D_staging_share", run) == pytest.approx(25.0)
    least = 0.134e9 / bm_roofline.PEAK_BYTES_S
    assert _read("poa_fwd_roofline", run) == pytest.approx(
        100 * least / 4e-3)
    assert _read("device_peak_gb", run) == pytest.approx(3.5)


def test_breakdown_names_ops_and_gaps(run):
    b = bm_harness.breakdown(run.traced_jobs())
    assert b["device_ops"][0] == ["poa_fwd_kernel<1>", pytest.approx(4e-3)]
    labels = dict((k, v) for k, v in b["idle_gaps"])
    assert labels["P_parsing: no traced host op"] == pytest.approx(0.01)
    assert labels["D_define: aten::copy_"] == pytest.approx(2e-3)


def test_readers_find_nothing_where_nothing_ran(run):
    run.jobs = [run.jobs[1]]            # untraced, no POA rounds
    for name in ("A_idle_share", "idle_share", "D_staging_share",
                 "poa_fwd_roofline"):
        assert _read(name, run) is None


def test_every_metric_has_its_reader():
    bench = bench_json()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(bm_harness.reader(m["name"]))
