"""bench_torch.py, the port's counterpart of bench.py, on the CPU at small
sizes, its section functions called with device "cpu" (the kernels'
plain versions; no figure here is a card's): its workloads are bench.py's
and tools/bench_poa_kernel.py's, byte for byte; its POA section's
consensi and its headline section's files equal the JAX package's on the
same inputs (tolerance: none); a byte flipped in one route's output makes
a section raise, naming the file; the host route's warm child (the
`serve` subcommand of tools/run_configs_torch.py) writes the files of a
fresh interpreter's run and of the JAX package's, never initialises
CUDA, forks its pools on every run, and leaves no process behind when a
run fails or outlives its limit; without a card it fails and prints no
result."""

import hashlib
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mandalorion_tpu.config import PoaConfig as ReferencePoaConfig
from mandalorion_tpu.config import config_from_args as reference_config
from mandalorion_tpu.native import load_native
from mandalorion_tpu.native import native_poa_consensus as reference_native
from mandalorion_tpu.pipeline.cli import build_parser as reference_parser
from mandalorion_tpu.pipeline.stages import run_pipeline as reference_run
from mandalorion_tpu.poa import consensus as reference_consensus
from mandalorion_tpu.poa.graph import PoaParams as ReferencePoaParams
from mandalorion_tpu_torch import _build

pytestmark = pytest.mark.skipif(load_native() is None,
                                reason="native library unavailable")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMALL = dict(n_genes=2, n_reads_per_gene=10, genome_len=40_000)
SMALL_POA = dict(n_iso=2, n_reads=4, length=300)
HEADLINE_KEYS = {
    "metric", "value", "unit", "value_spread", "warmup_reads_per_s",
    "host_warmup_reads_per_s", "host_same_workload", "module_a_reads_per_s", "wall_s", "stages",
    "launches", "peak_device_bytes", "reads", "artifacts_sha256",
    "attempts"}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module      # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


bench = _load("bench_torch", os.path.join(ROOT, "bench_torch.py"))
jax_bench = _load("bench", os.path.join(ROOT, "bench.py"))


def sha256_files(out_dir):
    digests = {}
    for name in bench.TOOL.ARTIFACTS:
        with open(os.path.join(out_dir, name), "rb") as fh:
            digests[name] = hashlib.sha256(fh.read()).hexdigest()
    return digests


def test_poa_workload_is_bench_py_s():
    """16 x 20 x 2,000: the same names, sequences and base count as
    bench.py's `_poa_workload()`."""
    got, got_bases = bench.poa_workload(**bench.POA)
    want, want_bases = jax_bench._poa_workload()
    assert bench.POA == dict(n_iso=16, n_reads=20, length=2000)
    assert got == want
    assert got_bases == want_bases == 16 * 20 * 2000


def test_poa_batch_workload_is_bench_poa_kernel_s(monkeypatch):
    """tools/bench_poa_kernel.py's generator, caught where its main hands
    the sets to the JAX package's poa_consensus_batch."""
    from mandalorion_tpu.poa import kernels as reference_kernels
    tool = _load("bench_poa_kernel",
                 os.path.join(ROOT, "tools", "bench_poa_kernel.py"))
    caught = []

    def catch(seq_sets, params):
        caught.append(seq_sets)
        raise KeyboardInterrupt

    monkeypatch.setattr(reference_kernels, "poa_consensus_batch", catch)
    monkeypatch.setattr(sys, "argv", ["bench_poa_kernel.py", "--isoforms",
                                      "5", "--reads", "3", "--length",
                                      "120"])
    with pytest.raises(KeyboardInterrupt):
        tool.main()
    got, truths = bench.poa_batch_workload(5, n_reads=3, length=120)
    assert len(got) == len(caught[0]) == len(truths) == 5
    for ours, theirs in zip(got, caught[0]):
        assert len(ours) == len(theirs) == 3
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    assert bench.POA_BATCH == dict(n_reads=12, length=800)
    assert bench.POA_BATCH_WIDTHS == (64, 264)


def reference_consensi(sets):
    jobs = reference_consensus.prepare_consensus_jobs(
        sets, ReferencePoaConfig(), np.random.default_rng(0))
    return [c for c, _names in reference_consensus.resolve_consensus_jobs(
        jobs, backend="native")]


def test_poa_section_consensi_match_reference():
    """2 isoforms x 4 reads x 300 bp: the section's consensi (both
    backends, checked equal inside it) and each backend's alone equal the
    JAX package's native engine on the same read sets, string for
    string."""
    out = bench.poa_section(CPU, 0, 1, SMALL_POA)
    sets, bases = jax_bench._poa_workload(**SMALL_POA)
    want = reference_consensi(sets)
    assert len(want) == 2 and all(want)
    assert out["consensus_sha256"] == hashlib.sha256(
        "\n".join(want).encode()).hexdigest()
    for backend in ("native", "device"):
        assert bench.poa_consensi(sets, backend, CPU) == want
    assert out["bases"] == bases
    assert out["bases_per_s_host"] > 0 and out["bases_per_s_device"] > 0
    assert len(out["host_spread"]) == len(out["device_spread"]) == 1
    assert [a["label"] for a in out["attempts"]] == ["native 0", "device 0"]


def test_poa_batch_section_matches_reference_engine():
    """poa_consensus_batch on the CPU against the JAX package's native
    engine on the same sets; every figure of a width present."""
    out = bench.poa_batch_section(CPU, 0, 1, (3,),
                                  dict(n_reads=3, length=200))["3"]
    seq_sets, _truths = bench.poa_batch_workload(3, n_reads=3, length=200)
    want = ["".join("ACGT"[c] for c in reference_native(
        s, ReferencePoaParams())) for s in seq_sets]
    assert out["consensus_sha256"] == hashlib.sha256(
        "\n".join(want).encode()).hexdigest()
    assert out["rounds"] >= 2 and out["chunks"] >= 2
    assert out["problems_per_chunk"] == [3, 3]
    assert out["fwd_ms"] is None and out["walk_ms"] is None
    assert out["bases"] == 3 * 3 * 200


def headline(tmp_path):
    work = bench.dataset(str(tmp_path / "data"), 2, **SMALL)
    return work, bench.value_section(str(tmp_path), work, CPU, 0, 1)


def test_headline_section_matches_reference(tmp_path):
    """2 genes x 10 reads, one attempt a route: every field, and the card
    route's files equal the host route's (checked inside) and those of
    mandalorion_tpu's run_pipeline on the same input, byte for byte."""
    work, out = headline(tmp_path)
    assert set(out) == HEADLINE_KEYS
    assert work.n_reads == out["reads"] == 20
    assert out["value"] == out["value_spread"][0] > 0
    assert out["host_same_workload"]["reads_per_s"] > 0
    assert [a["label"] for a in out["attempts"]] == ["card 0", "host 0"]
    assert set(out["stages"]["card"]) == set(out["stages"]["host"]) == {
        "index_build", "A_alignment", "P_parsing", "D_define", "F_filter",
        "Q_quant"}
    assert out["peak_device_bytes"] is None
    assert all(a["smi"] is None for a in out["attempts"])
    args = reference_parser().parse_args(["-p", str(tmp_path / "ref"),
                                          *work.inputs])
    reference_run(args.path, args.genome_sequence, args.genome_annotation,
                  args.Consensus_reads, reference_config(args))
    assert out["artifacts_sha256"] == sha256_files(tmp_path / "ref")


@pytest.mark.parametrize("route,name", [
    ("card", "Isoforms.filtered.clean.gtf"),
    ("host", os.path.join("tmp", "reads2isoforms.txt"))])
def test_a_flipped_byte_raises_naming_the_file(tmp_path, monkeypatch, route,
                                               name):
    plain = getattr(bench, f"{route}_run")

    def flipped(out_dir, *args):
        rec = plain(out_dir, *args)
        path = os.path.join(out_dir, name)
        with open(path, "rb") as fh:
            blob = bytearray(fh.read())
        blob[len(blob) // 2] ^= 1
        with open(path, "wb") as fh:
            fh.write(blob)
        return rec

    monkeypatch.setattr(bench, f"{route}_run", flipped)
    with pytest.raises(AssertionError) as err:
        headline(tmp_path)
    assert f"value: {name} of the card 0 run differs" in str(err.value)


def test_host_route_warms_up_like_the_card(tmp_path):
    """One warmup a route, in turns, then one attempt a route: the host
    route's warmup has its figures beside the card's, and every run's
    files equal the first host run's (checked inside)."""
    work = bench.dataset(str(tmp_path / "data"), 2, **SMALL)
    out = bench.value_section(str(tmp_path), work, CPU, 1, 1)
    assert set(out) == HEADLINE_KEYS
    assert [a["label"] for a in out["attempts"]] == [
        "warmup 0", "host warmup 0", "card 0", "host 0"]
    assert len(out["warmup_reads_per_s"]) == 1
    assert len(out["host_warmup_reads_per_s"]) == 1
    assert out["host_warmup_reads_per_s"][0] > 0
    assert {k: len(v) for k, v in out["wall_s"].items()} == {
        "warmup": 1, "host_warmup": 1, "card": 1, "host": 1}


def test_serve_child_runs_warm_like_a_fresh_interpreter(tmp_path):
    """Two runs in one `serve` child: each forks the pipeline's pools and
    leaves CUDA uninitialised, and their files equal `run_route`'s (a
    fresh interpreter) and mandalorion_tpu's run_pipeline's, byte for
    byte. The child ends with exit code 0 when its requests end."""
    work = bench.dataset(str(tmp_path / "data"), 2, **SMALL)
    flags = list(bench.TOOL.HOST_ROUTE)
    answers = []
    with bench.TOOL.RouteServer(str(tmp_path / "serve.log")) as server:
        for i in range(2):
            answers.append(server.run(f"warm {i}", str(tmp_path / f"warm{i}"),
                                      work.inputs, flags, work.n_reads, 300))
    assert server.proc.returncode == 0
    for res in answers:
        assert res["forks"] > 0 and res["threads"] == 1
        assert res["cuda_initialized"] is False
        assert res["peak_rss_bytes"] > 0 and res["peak_child_rss_bytes"] > 0
        assert set(res["stages"]) == {"index_build", "A_alignment",
                                      "P_parsing", "D_define", "F_filter",
                                      "Q_quant"}
    bench.TOOL.run_route("fresh", str(tmp_path / "fresh"), work.inputs,
                         flags, work.n_reads, 300)
    args = reference_parser().parse_args(["-p", str(tmp_path / "ref"),
                                          *work.inputs])
    reference_run(args.path, args.genome_sequence, args.genome_annotation,
                  args.Consensus_reads, reference_config(args))
    want = sha256_files(tmp_path / "ref")
    for name in ("warm0", "warm1", "fresh"):
        assert sha256_files(tmp_path / name) == want, name


def live_in_group(pgid):
    """The pids of the processes of group `pgid` that are not zombies."""
    live = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            live.append(int(pid))
    return live


@pytest.mark.parametrize("case", ["a failed run", "over its limit"])
def test_serve_child_failure_raises_naming_the_run(tmp_path, case):
    """After a warm run, a run that fails, or that outlives a quarter of
    the warm run's seconds (its RSS sampler alive), raises naming the
    run; the child's whole process group is gone after the block."""
    work = bench.dataset(str(tmp_path / "data"), 2, **SMALL)
    flags = list(bench.TOOL.HOST_ROUTE)
    inputs = list(work.inputs)
    with pytest.raises(RuntimeError) as err:
        with bench.TOOL.RouteServer(str(tmp_path / "serve.log")) as server:
            warm = server.run("warm", str(tmp_path / "warm"), inputs, flags,
                              work.n_reads, 300)
            timeout, says = 300, "failed"
            if case == "a failed run":
                inputs[1] = str(tmp_path / "missing.fasta")
            else:
                timeout = warm["seconds"] / 4
                says = f"did not end within {timeout} s"
            server.run("the run under test", str(tmp_path / "out"), inputs,
                       flags, work.n_reads, timeout)
    assert str(err.value).startswith(f"the run under test {says}")
    assert server.proc.returncode not in (None, 0)
    for _ in range(100):
        if not live_in_group(server.proc.pid):
            break
        time.sleep(0.1)
    assert live_in_group(server.proc.pid) == []


def test_main_without_a_card_fails_and_prints_no_result(monkeypatch,
                                                        capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
    assert capsys.readouterr().out == ""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "is_available" in proc.stderr


def test_cold_kind_follows_the_library(monkeypatch, tmp_path):
    lib = tmp_path / "libmando_kernels_x.so"
    monkeypatch.setattr(_build, "library_path", lambda: str(lib))
    assert bench.cold_kind() == "first-build"
    lib.write_bytes(b"")
    assert bench.cold_kind() == "built"


def test_time_limit_raises():
    import time
    with pytest.raises(TimeoutError, match="over its time limit of 1 s"):
        with bench.time_limit("section", 1):
            time.sleep(3)
