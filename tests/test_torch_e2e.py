"""The port's CLI against mandalorion_tpu's over the inputs users run:
the cases of tests/test_pipeline_e2e.py (multi-sample fofn, module
resume, gzipped FASTQ, the flag surface, PacBio BAM, two chromosomes
with junk reads, all junk, an external SAM, the forked pool, long-read
isoforms, thread counts), each through `mandalorion_tpu.pipeline.cli.main`
and `mandalorion_tpu_torch.pipeline.cli.main --device cpu` on the same
inputs. The six `_artifact_bytes` files and `.clean.genes` must be
byte-identical (tolerance 0); the only exception is `-P`, whose `.quant`
and `.tpm` headers name a converted FASTA under the output directory and
are compared with that directory substituted. The smallest cases also
run the port's `--consensus_backend device` (the plain POA forward costs
about a millisecond a graph row on the CPU)."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from mandalorion_tpu.config import AlignConfig as ReferenceAlignConfig
from mandalorion_tpu.config import PipelineConfig as ReferenceConfig
from mandalorion_tpu.native import load_native
from mandalorion_tpu.pipeline.cli import main as reference_cli
from mandalorion_tpu.pipeline.stages import run_pipeline as reference_run
from mandalorion_tpu_torch.config import AlignConfig, PipelineConfig
from mandalorion_tpu_torch.pipeline.cli import main as port_cli
from mandalorion_tpu_torch.pipeline.stages import run_pipeline

pytestmark = pytest.mark.skipif(load_native() is None,
                                reason="native library unavailable")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"),
             "Isoforms.filtered.clean.genes")
DEVICE_CONSENSUS = ("--consensus_backend", "device")
HOST_ROUTE = ("--chain_backend", "native", "--dp_backend", "numpy")

_spec = importlib.util.spec_from_file_location(
    "run_configs_torch", os.path.join(ROOT, "tools", "run_configs_torch.py"))
cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cases)


def artifacts(out_dir, required=True):
    """The compared files' bytes (None where a file is absent: an all-junk
    run writes no isoform)."""
    blobs = {}
    for name in ARTIFACTS:
        path = os.path.join(out_dir, name)
        blobs[name] = open(path, "rb").read() if os.path.exists(path) \
            else None
        if required:
            assert blobs[name], (out_dir, name)
    return blobs


def both(tmp, tag, args, port_flags=()):
    """One CLI run of each package on `args` (the port's with
    `port_flags`); returns (reference, port) output directories."""
    ref, port = str(tmp / f"{tag}_ref"), str(tmp / f"{tag}_port")
    assert reference_cli(["-p", ref, *args]) == 0
    assert port_cli(["-p", port, *args, "--device", "cpu",
                     *port_flags]) == 0
    return ref, port


# the datasets of tests/test_pipeline_e2e.py, same seeds and layouts
# (tools/run_configs_torch.py builds them for chip_smoke.py too)
CASES = {
    "two_sample_fofn": (cases.two_sample, ["-R", "3"]),
    "three_sample_mixed": (cases.three_sample_mixed, ["-R", "3"]),
    "gz_fastq_window_junctions": (cases.spliced_and_mono,
                                  ["-w", "2", "-j", "gtag"]),
    "gz_fastq_multi_exon_only": (cases.spliced_and_mono, ["-m"]),
    "gz_fastq": (cases.spliced_and_mono, []),
    "two_chromosomes_junk": (cases.two_chromosomes_junk, []),
    "long_read_isoforms": (cases.long_reads, []),
}
SMALL = ("gz_fastq", "two_chromosomes_junk")
RUNS = ([pytest.param(case, (), id=case) for case in sorted(CASES)]
        + [pytest.param(case, DEVICE_CONSENSUS, id=f"{case}-device_consensus")
           for case in SMALL])


@pytest.mark.parametrize("case,port_flags", RUNS)
def test_cli_matches_reference(tmp_path, case, port_flags):
    make, flags = CASES[case]
    ref, port = both(tmp_path, case, make(str(tmp_path)) + flags, port_flags)
    assert artifacts(port) == artifacts(ref)


@pytest.mark.parametrize("port_flags", [(), DEVICE_CONSENSUS],
                         ids=["default", "device_consensus"])
def test_all_junk_matches_reference(tmp_path, port_flags):
    """No read maps: both packages exit 0 and write no isoform file."""
    ref, port = both(tmp_path, "junk", cases.all_junk(str(tmp_path)),
                     port_flags)
    got, want = artifacts(port, False), artifacts(ref, False)
    assert got == want
    assert want["Isoforms.filtered.clean.quant"] is None
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))


def test_module_resume_matches_reference(tmp_path):
    """-M FQ re-runs filtering and quantification from each package's own
    tmp artifacts: the rewritten files equal the first run's, and the
    port's equal the reference's."""
    args = cases.two_sample(str(tmp_path)) + ["-R", "3"]
    ref, port = both(tmp_path, "fofn", args)
    first = artifacts(ref)
    assert artifacts(port) == first
    for out in (ref, port):
        for name in ("Isoforms.filtered.clean.quant",
                     "Isoforms.filtered.clean.tpm"):
            os.remove(os.path.join(out, name))
    assert reference_cli(["-p", ref, *args, "-M", "FQ"]) == 0
    assert port_cli(["-p", port, *args, "-M", "FQ", "--device", "cpu"]) == 0
    assert artifacts(ref) == first
    assert artifacts(port) == first


@pytest.mark.parametrize("port_flags", [(), DEVICE_CONSENSUS],
                         ids=["default", "device_consensus"])
def test_pacbio_bam_matches_reference(tmp_path, port_flags):
    """-P converts the BAM under <out>/tmp; the .quant and .tpm headers
    name that path, so they are compared with the output directory
    substituted, every other file as it is."""
    ref, port = both(tmp_path, "bam", cases.pacbio_bam(str(tmp_path)),
                     port_flags)
    got, want = artifacts(port), artifacts(ref)
    for name in ("Isoforms.filtered.clean.quant",
                 "Isoforms.filtered.clean.tpm"):
        assert str(port).encode() in got[name]
        got[name] = got[name].replace(str(port).encode(), b"<out>")
        want[name] = want[name].replace(str(ref).encode(), b"<out>")
    assert got == want
    quant = got["Isoforms.filtered.clean.quant"].decode().splitlines()
    assert len(quant) == 2 and quant[1].split("\t")[1] == "8"


@pytest.fixture
def emitted_sams(tmp_path):
    """Each package's run of the two-sample dataset with its SAM written
    (`AlignConfig(emit_sam=True)`): the reference's and the port's
    output directories."""
    args = cases.two_sample(str(tmp_path))
    genome, ann, fofn = args[1], args[3], args[5]
    ref, port = str(tmp_path / "sam_ref"), str(tmp_path / "sam_port")
    reference_run(ref, genome, ann, fofn,
                  ReferenceConfig(align=ReferenceAlignConfig(emit_sam=True)))
    run_pipeline(port, genome, ann, fofn,
                 PipelineConfig(align=AlignConfig(emit_sam=True)),
                 device="cpu")
    return args, ref, port


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_external_sam_crossed(tmp_path, emitted_sams, writer):
    """--external_sam both ways: a SAM written by either package, fed to
    each, gives the artifacts of the run that wrote it."""
    args, ref_first, port_first = emitted_sams
    sam_of = {"reference": ref_first, "port": port_first}
    sams = {k: open(os.path.join(v, "tmp", "mm2Alignments.sam"), "rb").read()
            for k, v in sam_of.items()}
    assert sams["port"] == sams["reference"]
    assert artifacts(port_first) == artifacts(ref_first)
    sam = os.path.join(sam_of[writer], "tmp", "mm2Alignments.sam")
    ref, port = both(tmp_path, f"ext_{writer}",
                     args + ["--external_sam", sam])
    assert artifacts(ref) == artifacts(port) == artifacts(ref_first)


def test_forked_pool_matches_reference(tmp_path):
    """-t 2 over two gzipped samples, each package's CLI in a fresh
    process so that its fork pool engages; the port on its host route
    (module A's device route is one process)."""
    args = cases.forked_pool(str(tmp_path))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    outs = {}
    for pkg, extra in (("mandalorion_tpu", ()),
                       ("mandalorion_tpu_torch",
                        HOST_ROUTE + ("--device", "cpu"))):
        outs[pkg] = str(tmp_path / pkg)
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.pipeline.cli", "-p", outs[pkg],
             *args, "-t", "2", *extra],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "mm2Alignments.part0.psl" not in os.listdir(
            os.path.join(outs[pkg], "tmp"))
    got = artifacts(outs["mandalorion_tpu_torch"])
    assert got == artifacts(outs["mandalorion_tpu"])
    quant = got["Isoforms.filtered.clean.quant"].decode().splitlines()
    assert [int(c) for c in quant[1].split("\t")[1:3]] == [600, 550]


def test_thread_count_byte_determinism_matches_reference(tmp_path):
    """-t 1 and -t 3 give the same bytes in the port, and the reference's
    at -t 1, read_stat included."""
    args = cases.two_sample(str(tmp_path)) + ["-R", "3"]
    files = ARTIFACTS + ("Mando_isoforms.read_stat.txt",)
    blobs = {}
    for t in ("1", "3"):
        ref, port = both(tmp_path, f"t{t}", args + ["-t", t])
        for tag, out in (("ref", ref), ("port", port)):
            blobs[tag, t] = {n: open(os.path.join(out, n), "rb").read()
                             for n in files}
    want = blobs["ref", "1"]
    assert all(want.values())
    for key, got in blobs.items():
        assert got == want, key


def test_staged_seed_threads_byte_identical(tmp_path):
    """The port's CLI on its default route (module A staged: the C seed
    stage, the chain and DP kernels' plain versions) with -t 1 and -t 4,
    each in a fresh process: the seven files byte-identical. With -t 4
    the seed stage ran on more than one thread a call, and the run went
    on to fork module D's prepare pool after it."""
    args = cases.two_sample(str(tmp_path)) + ["-R", "3"]
    # the stage open at each fork of the run, printed as its last line
    code = ("import json, os, sys\n"
            "from mandalorion_tpu_torch.pipeline import observe\n"
            "from mandalorion_tpu_torch.pipeline.cli import main\n"
            "forks = []\n"
            "os.register_at_fork(before=lambda: forks.append(\n"
            "    observe._ACTIVE and observe._ACTIVE._stage))\n"
            "rc = main(sys.argv[1:])\n"
            "print(json.dumps(forks))\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs, forks, seed_threads = {}, {}, {}
    for t in ("1", "4"):
        outs[t] = str(tmp_path / f"t{t}")
        r = subprocess.run(
            [sys.executable, "-c", code, "-p", outs[t], *args, "-t", t,
             "--device", "cpu"],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
        forks[t] = json.loads(r.stdout.strip().splitlines()[-1])
        with open(os.path.join(outs[t], "tmp", "spans.tsv")) as fh:
            rows = [line.rstrip("\n").split("\t") for line in fh]
        seed_threads[t] = [(int(calls), int(items)) for
                           stage, _p, name, calls, _s, items in rows[1:]
                           if name == "align.seed.threads"]
    assert artifacts(outs["4"]) == artifacts(outs["1"])
    assert seed_threads["1"] == [(1, 1)]
    [(calls, items)] = seed_threads["4"]
    assert calls == 1 and items == min(3, os.cpu_count())  # 38 reads
    assert "D_define" in forks["4"]
