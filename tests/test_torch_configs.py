"""The port at the acceptance and scale configurations, against
mandalorion_tpu: config-2's truth-set gates (tests/test_config2.py) and
config-4's layout (tests/test_scale.py) cut to 4 chromosomes x 1.5 Mbp,
run with the index cache in both forms, writing it and then loading it;
every run's artifacts byte-identical to the JAX package's (tolerance 0).
Also the dataset makers of tools/run_configs_torch.py, each held byte for
byte to the slow maker it stands for."""

import importlib.util
import os
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

import synthdata
from mandalorion_tpu.config import PipelineConfig as ReferenceConfig
from mandalorion_tpu.io.fastx import revcomp, write_fasta
from mandalorion_tpu.native import load_native
from mandalorion_tpu.pipeline import stages as reference_stages
from mandalorion_tpu.utils.simulate import make_adversarial_dataset
from mandalorion_tpu.utils.simulate import make_dataset
from mandalorion_tpu_torch.align.aligner import TorchSpliceAligner
from mandalorion_tpu_torch.align.index import load_index
from mandalorion_tpu_torch.config import AlignConfig
from mandalorion_tpu_torch.pipeline.cli import main as port_cli
from mandalorion_tpu_torch.utils.simulate import evaluate_adversarial

pytestmark = pytest.mark.skipif(load_native() is None,
                                reason="native library unavailable")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"),
             "Isoforms.filtered.clean.genes")
FILES = ("genome.fasta", "reads.fasta", "ann.gtf")
SCALE_CUT = dict(n_chroms=4, chrom_len=1_500_000, genes_per_chrom=2,
                 per_gene=40)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


makers = _tool("run_configs_torch")


def artifacts(out_dir):
    blobs = {}
    for name in ARTIFACTS:
        with open(os.path.join(out_dir, name), "rb") as fh:
            blobs[name] = fh.read()
        assert blobs[name], (out_dir, name)
    return blobs


def files(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in FILES}


def port_run(out, inputs, *flags):
    assert port_cli(["-p", str(out), *inputs, "--device", "cpu", "-t", "2",
                     *flags]) == 0
    return artifacts(out)


# ---------------------------------------------------------- the makers

@pytest.mark.parametrize("kw", [
    dict(n_genes=3, n_reads_per_gene=20, genome_len=90_000, seed=0),
    dict(n_genes=5, n_reads_per_gene=7, genome_len=200_000, seed=3,
         strand="-", exon_len=(100, 2000), sub_rate=0.05,
         exons_per_gene=(1, 4))])
def test_make_dataset_files_equal_make_dataset(tmp_path, kw):
    make_dataset(str(tmp_path / "slow"), **kw)
    n = makers.make_dataset_files(str(tmp_path / "fast"), **kw)
    assert n == kw["n_genes"] * kw["n_reads_per_gene"]
    assert files(tmp_path / "fast") == files(tmp_path / "slow")


class _Stop(Exception):
    pass


@pytest.mark.parametrize("tool,argv", [
    ("run_config3", ["3", "5", "1"]),
    ("run_config4", ["0.0016", "4", "1", "5"])])
def test_config_makers_equal_the_jax_tools(tmp_path, monkeypatch, tool,
                                           argv):
    """The JAX tool's own main() writes its dataset and stops at its
    run_pipeline call; the fast maker, given the same arguments, writes
    the same bytes."""
    slow = tmp_path / "slow"
    slow.mkdir()

    def stop(*_a, **_k):
        raise _Stop

    monkeypatch.setattr(reference_stages, "run_pipeline", stop)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda **_k: str(slow))
    monkeypatch.setattr("sys.argv", [tool, *argv])
    with pytest.raises(_Stop):
        _tool(tool).main()
    fast = str(tmp_path / "fast")
    if tool == "run_config3":
        assert makers.config3_files(fast, *map(int, argv)) == 15
    else:
        truth = makers.config4_files(fast, float(argv[0]),
                                     *map(int, argv[1:]))
        assert [c for c, _n in truth] == ["chr1", "chr2", "chr3", "chr4"]
    assert files(fast) == files(slow)


def test_scale_files_equal_the_scale_tests_layout(tmp_path):
    """tests/test_scale.py's generation, as it is written there, at 4 x
    300 kb with 5 reads a gene, against `scale_files`."""
    n_chroms, chrom_len, genes_per_chrom, per_gene = 4, 300_000, 2, 5
    rng = np.random.default_rng(0)
    reads, gtf = [], []
    slow = tmp_path / "slow"
    slow.mkdir()
    with open(slow / "genome.fasta", "w") as gfh:
        for ci in range(n_chroms):
            chrom = f"chr{ci + 1}"
            g = synthdata.make_genome(chrom_len, seed=700 + ci)
            span = chrom_len // genes_per_chrom
            for k in range(genes_per_chrom):
                base = k * span + 50_000
                exons = []
                pos = base
                for _ in range(int(rng.integers(2, 5))):
                    ln = int(rng.integers(250, 900))
                    exons.append((pos, pos + ln))
                    pos += ln + int(rng.integers(500, 30_000))
                strand = "+" if (ci + k) % 2 == 0 else "-"
                g = synthdata.plant_introns(g, exons, strand=strand)
                t = synthdata.transcript_seq(g, exons)
                if strand == "-":
                    t = revcomp(t)
                for ri in range(per_gene):
                    r, _ = synthdata.mutate_read(t, rng, 0.01)
                    reads.append((f"c{ci}g{k}r{ri}", r))
                gtf.append(synthdata.gtf_lines(
                    chrom, f"G{ci}_{k}", f"T{ci}_{k}", exons,
                    strand=strand))
            gfh.write(f">{chrom}\n{g}\n")
    write_fasta(str(slow / "reads.fasta"), reads)
    (slow / "ann.gtf").write_text("".join(gtf))
    truth = makers.scale_files(str(tmp_path / "fast"), n_chroms, chrom_len,
                               genes_per_chrom, per_gene)
    assert len(truth) == n_chroms * genes_per_chrom
    assert files(tmp_path / "fast") == files(slow)


def test_split_samples_keeps_every_read(tmp_path):
    makers.make_dataset_files(str(tmp_path), n_genes=2, n_reads_per_gene=3,
                              genome_len=40_000)
    fofn = makers.split_samples(str(tmp_path), 3)
    from mandalorion_tpu_torch.io.fastx import expand_fofn, read_fastx
    whole = [(n, s) for n, s, _q in read_fastx(str(tmp_path / "reads.fasta"))]
    paths = expand_fofn(fofn)
    assert paths[1].endswith(".fastq.gz")
    parts = [[(n, s, q) for n, s, q in read_fastx(p)] for p in paths]
    assert [(n, s) for n, s, _q in parts[0] + parts[1]] == whole
    assert [n for n, _s, _q in parts[0]] == ["g0r0", "g0r1", "g0r2"]
    assert all(q == "I" * len(s) for _n, s, q in parts[1])


# ---------------------------------------------------------- config-2

def test_config2_gates_and_reference_bytes(tmp_path):
    """make_adversarial_dataset(reads_per_isoform=12) through the port's
    CLI on its default routes: tests/test_config2.py's gates, and the
    artifacts of mandalorion_tpu's run on the same files."""
    truth = make_adversarial_dataset(str(tmp_path), reads_per_isoform=12)
    inputs = ["-G", str(tmp_path / "genome.fasta"),
              "-g", str(tmp_path / "ann.gtf"),
              "-f", str(tmp_path / "reads.fasta")]
    reference_stages.run_pipeline(
        str(tmp_path / "ref"), *inputs[1::2], ReferenceConfig(threads=2))
    got = port_run(tmp_path / "port", inputs)
    assert got == artifacts(tmp_path / "ref")
    m = evaluate_adversarial(str(tmp_path / "port"), truth)
    assert m["isoform_recall"] == 1.0, m
    assert m["junction_recall"] == 1.0, m
    assert m["pseudogene_false_calls"] == [], m
    assert m["read_purity"] >= 0.95, m
    assert m["n_out_isoforms"] == len(truth["isoforms"]), m


# ---------------------------------------------------------- config-4 cut

@pytest.fixture(scope="module")
def scale_cut(tmp_path_factory):
    """tests/test_scale.py's layout at 4 x 1.5 Mbp, 2 genes a chromosome,
    40 reads a gene, and mandalorion_tpu's artifacts on it (no cache)."""
    tmp = tmp_path_factory.mktemp("scale_cut")
    truth = makers.scale_files(str(tmp), **SCALE_CUT)
    inputs = ["-G", str(tmp / "genome.fasta"), "-g", str(tmp / "ann.gtf"),
              "-f", str(tmp / "reads.fasta")]
    reference_stages.run_pipeline(str(tmp / "ref"), *inputs[1::2],
                                  ReferenceConfig(threads=2))
    return tmp, inputs, truth, artifacts(tmp / "ref")


@pytest.mark.parametrize("form", ["genome.idx", "genome.npz"],
                         ids=["directory", "npz"])
def test_config4_cut_with_index_cache(tmp_path, scale_cut, form):
    """A run that writes the cache, then a run that loads it: both equal
    the reference's bytes, and every planted gene gives one isoform on its
    own chromosome."""
    tmp, inputs, truth, want = scale_cut
    cache = ["--index_cache", str(tmp_path / form)]
    assert port_run(tmp_path / "write", inputs, *cache) == want
    assert os.path.isdir(tmp_path / form) == (form == "genome.idx")
    assert port_run(tmp_path / "load", inputs, *cache) == want
    chroms = {}
    with open(tmp_path / "load" / "Isoforms.filtered.clean.psl") as fh:
        for line in fh:
            chrom = line.split("\t")[13]
            chroms[chrom] = chroms.get(chrom, 0) + 1
    planted = {}
    for chrom, _n_exons in truth:
        planted[chrom] = planted.get(chrom, 0) + 1
    assert chroms == planted == {f"chr{c + 1}": 2 for c in range(4)}


def test_directory_cache_load_never_aliases_the_mapped_genome(tmp_path,
                                                              scale_cut):
    """A directory cache loads memory-mapped and read-only; the port's
    genome tensor must be a copy, not a view of the mapping. The load runs
    in a fresh interpreter with UserWarning raised as an error (torch
    warns once a process on a tensor over a non-writable array), and its
    artifacts are unchanged; the aligner bound over the loaded index
    shares no memory with it."""
    tmp, inputs, _truth, want = scale_cut
    cache = str(tmp_path / "genome.idx")
    port_run(tmp_path / "write", inputs, "--index_cache", cache)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-W", "error::UserWarning", "-m",
         "mandalorion_tpu_torch.pipeline.cli", "-p", str(tmp_path / "load"),
         *inputs, "--device", "cpu", "-t", "2", "--index_cache", cache],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "UserWarning" not in proc.stderr
    assert artifacts(tmp_path / "load") == want
    index = load_index(cache)
    assert not index.seq_codes.flags.writeable
    aligner = object.__new__(TorchSpliceAligner)
    aligner.cfg, aligner.index, aligner.max_occ = AlignConfig(), index, 1
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        aligner._bind(torch.device("cpu"))
    codes = aligner.genome_codes.numpy()
    assert not np.shares_memory(codes, index.seq_codes)
    assert np.array_equal(codes, index.seq_codes)
