#!/usr/bin/env python3
"""Config-2, config-3 and config-4 runs of mandalorion_tpu_torch, the
port's counterpart of tools/run_config2.py, run_config3.py and
run_config4.py.

Usage (from the repository root):

    python3 tools/run_configs_torch.py config2 [reads_per_isoform] [threads]
    python3 tools/run_configs_torch.py config3 [n_genes] [reads_per_gene]
                                               [genome_mbp]
    python3 tools/run_configs_torch.py config4 [gbp] [n_chroms]
                                               [genes_per_chrom]
                                               [reads_per_gene]
    each with [--device cuda|cpu] (default cuda).

Each makes the tool's dataset (the same files, byte for byte, as the
JAX package's tool makes for the same arguments, only faster) and runs
the port's CLI twice, each run in a process of its own: the device route
(`--device <device> --consensus_backend device`, module A on its device
route) and the host route (`--device cpu --chain_backend native
--dp_backend numpy --consensus_backend native`, which never touches
CUDA). config4 runs in turns: the device route with `--index_cache
<dir>`, which writes the cache; the host route, which loads it
memory-mapped; the device route again, loading it.

Printed: a line a run with its stage seconds, module A and APDFQ reads/s
(index build included), peak RSS of the run's process and of its largest
child, and peak device memory (`torch.cuda.max_memory_allocated()`);
then one JSON line with the tool's own checks. Exits non-zero when the
routes' artifacts differ in a byte (the six `_artifact_bytes` files and
`.clean.genes`) or a check fails: config-2's gates (isoform and junction
recall 1.0, no pseudogene call, read purity >= 0.95), config-4's planted
genes (each gives one isoform on its own chromosome).

`python3 tools/run_configs_torch.py serve` runs the port's CLI warm, again
and again in one process, a run for each request line on stdin
(`serve_child`); `RouteServer` starts and drives it. bench_torch.py runs
its host route so, by bench.py's protocol.

The dataset makers are importable: `make_dataset_files` (the files of
`utils.simulate.make_dataset`), `config3_files`, `config4_files` and
`scale_files` (the 300 Mbp layout of tests/test_scale.py). They write
bytes from numpy arrays in one pass; every random draw is the slow
makers' own, in their order.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import select
import signal
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[ACGT] = np.frombuffer(b"TGCA", np.uint8)
ARTIFACTS = ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
             "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
             "Isoforms.filtered.clean.tpm",
             os.path.join("tmp", "reads2isoforms.txt"),
             "Isoforms.filtered.clean.genes")
HOST_ROUTE = ("--device", "cpu", "--chain_backend", "native",
              "--dp_backend", "numpy", "--consensus_backend", "native")


# ------------------------------------------------------------ the makers

def genome_bytes(length: int, seed: int) -> np.ndarray:
    """`make_genome(length, seed)` as a writable uint8 array."""
    rng = np.random.default_rng(seed)
    return ACGT[rng.integers(0, 4, size=length, dtype=np.uint8)]


def plant(genome: np.ndarray, exons, strand: str) -> None:
    """`plant_introns` in place."""
    donor, acceptor = (b"GT", b"AG") if strand == "+" else (b"CT", b"AC")
    for (_s1, e1), (s2, _e2) in zip(exons, exons[1:]):
        genome[e1], genome[e1 + 1] = donor
        genome[s2 - 2], genome[s2 - 1] = acceptor


def transcript(genome: np.ndarray, exons, strand: str) -> np.ndarray:
    """`transcript_seq`, reverse-complemented on '-' (the genomes hold
    only ACGT)."""
    t = np.concatenate([genome[s:e] for s, e in exons])
    return COMPLEMENT[t[::-1]] if strand == "-" else t


def mutate(t: np.ndarray, rng, sub_rate: float) -> bytes:
    """`mutate_read(t, rng, sub_rate)[0]` with the same draws: one uniform
    a base, then one of four bases a substitution."""
    if sub_rate <= 0:
        return t.tobytes()
    mask = rng.random(len(t)) < sub_rate
    subs = int(mask.sum())
    if not subs:
        return t.tobytes()
    out = t.copy()
    out[mask] = ACGT[rng.choice(4, size=subs)]
    return out.tobytes()


def gtf_lines(chrom: str, gene: str, tid: str, exons, strand: str) -> str:
    attrs = (f'gene_id "{gene}"; transcript_id "{tid}"; '
             f'gene_name "{gene}N";')
    return "".join(f"{chrom}\tsynth\texon\t{s + 1}\t{e}\t.\t{strand}\t.\t"
                   f"{attrs}\n" for s, e in exons)


def write_reads(path: str, reads) -> None:
    """FASTA of (name, bytes) reads, as `write_fasta` writes them."""
    with open(path, "wb") as fh:
        for name, seq in reads:
            fh.write(b">%s\n%s\n" % (name.encode(), seq))


def write_genome(fh, chrom: str, genome: np.ndarray) -> None:
    fh.write(b">%s\n" % chrom.encode())
    fh.write(memoryview(genome))
    fh.write(b"\n")


def make_dataset_files(out_dir: str, n_genes: int = 8,
                       n_reads_per_gene: int = 250,
                       genome_len: int = 200_000, sub_rate: float = 0.01,
                       seed: int = 0, exons_per_gene=(2, 5),
                       exon_len=(300, 800), strand=None) -> int:
    """The files of `utils.simulate.make_dataset` with the same arguments;
    returns the read count."""
    rng = np.random.default_rng(seed)
    genome = genome_bytes(genome_len, 9)
    genes = []
    span = genome_len // n_genes
    for g in range(n_genes):
        pos = g * span + 2000
        exons = []
        for _ in range(int(rng.integers(*exons_per_gene))):
            length = int(rng.integers(*exon_len))
            exons.append((pos, pos + length))
            pos += length + int(rng.integers(200, 2000))
        g_strand = strand or ("+" if g % 2 == 0 else "-")
        plant(genome, exons, g_strand)
        genes.append((exons, g_strand))
    reads, gtf = [], []
    for gi, (exons, g_strand) in enumerate(genes):
        t = transcript(genome, exons, g_strand)
        reads += [(f"g{gi}r{ri}", mutate(t, rng, sub_rate))
                  for ri in range(n_reads_per_gene)]
        gtf.append(gtf_lines("chr1", f"G{gi}", f"T{gi}", exons, g_strand))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "genome.fasta"), "wb") as fh:
        write_genome(fh, "chr1", genome)
    write_reads(os.path.join(out_dir, "reads.fasta"), reads)
    with open(os.path.join(out_dir, "ann.gtf"), "w") as fh:
        fh.write("".join(gtf))
    return len(reads)


def config3_files(out_dir: str, n_genes: int = 100, per_gene: int = 1000,
                  mbp: int = 50) -> int:
    """tools/run_config3.py's dataset for the same arguments; returns the
    read count."""
    rng = np.random.default_rng(0)
    genome = genome_bytes(mbp * 1_000_000, 4)
    span = len(genome) // n_genes
    genes, gtf = [], []
    for g in range(n_genes):
        pos = g * span + 5000
        exons = []
        for _ in range(int(rng.integers(2, 7))):
            ln = int(rng.integers(150, 1200))
            exons.append((pos, pos + ln))
            pos += ln + int(rng.integers(200, 30_000))
        strand = "+" if g % 2 == 0 else "-"
        plant(genome, exons, strand)
        genes.append((exons, strand))
        gtf.append(gtf_lines("chr1", f"G{g}", f"T{g}", exons, strand))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "genome.fasta"), "wb") as fh:
        write_genome(fh, "chr1", genome)
    with open(os.path.join(out_dir, "ann.gtf"), "w") as fh:
        fh.write("".join(gtf))
    reads = []
    for gi, (exons, strand) in enumerate(genes):
        t = transcript(genome, exons, strand)
        reads += [(f"g{gi}r{ri}", mutate(t, rng, 0.01))
                  for ri in range(per_gene)]
    write_reads(os.path.join(out_dir, "reads.fasta"), reads)
    return len(reads)


def _planted_chromosomes(out_dir, n_chroms, chrom_len, genes_per_chrom,
                         per_gene, genome_seed, n_exons, exon_len,
                         gap_len):
    """The layout shared by tools/run_config4.py and tests/test_scale.py:
    chromosome ci from make_genome(chrom_len, genome_seed + ci), gene k at
    k * span + 50,000, its exons drawn, planted, its transcript cut and
    its reads drawn before the next gene's exons. Returns the truth:
    (chrom, n_exons) a gene."""
    rng = np.random.default_rng(0)
    reads, gtf, truth = [], [], []
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "genome.fasta"), "wb") as gfh:
        for ci in range(n_chroms):
            chrom = f"chr{ci + 1}"
            genome = genome_bytes(chrom_len, genome_seed + ci)
            span = chrom_len // genes_per_chrom
            for k in range(genes_per_chrom):
                pos = k * span + 50_000
                exons = []
                for _ in range(int(rng.integers(*n_exons))):
                    ln = int(rng.integers(*exon_len))
                    exons.append((pos, pos + ln))
                    pos += ln + int(rng.integers(*gap_len))
                strand = "+" if (ci + k) % 2 == 0 else "-"
                plant(genome, exons, strand)
                t = transcript(genome, exons, strand)
                reads += [(f"c{ci}g{k}r{ri}", mutate(t, rng, 0.01))
                          for ri in range(per_gene)]
                gtf.append(gtf_lines(chrom, f"G{ci}_{k}", f"T{ci}_{k}",
                                     exons, strand))
                truth.append((chrom, len(exons)))
            write_genome(gfh, chrom, genome)
            del genome
    write_reads(os.path.join(out_dir, "reads.fasta"), reads)
    with open(os.path.join(out_dir, "ann.gtf"), "w") as fh:
        fh.write("".join(gtf))
    return truth


def config4_files(out_dir: str, gbp: float = 3.1, n_chroms: int = 24,
                  genes_per_chrom: int = 3, per_gene: int = 100) -> list:
    """tools/run_config4.py's dataset for the same arguments; returns the
    truth, (chrom, n_exons) a gene."""
    return _planted_chromosomes(out_dir, n_chroms, int(gbp * 1e9) // n_chroms,
                                genes_per_chrom, per_gene, 100, (2, 6),
                                (200, 1000), (500, 50_000))


def scale_files(out_dir: str, n_chroms: int = 4,
                chrom_len: int = 75_000_000, genes_per_chrom: int = 2,
                per_gene: int = 40) -> list:
    """tests/test_scale.py's 300 Mbp dataset (4 x 75 Mbp, 2 genes a
    chromosome, 40 reads a gene) or its layout at other sizes; returns
    the truth, (chrom, n_exons) a gene."""
    return _planted_chromosomes(out_dir, n_chroms, chrom_len,
                                genes_per_chrom, per_gene, 700, (2, 5),
                                (250, 900), (500, 30_000))


def split_samples(out_dir: str, n_first: int) -> str:
    """reads.fasta as two samples in a fofn: its first n_first reads as
    sample1.fasta, the rest as gzipped FASTQ sample2.fastq.gz (quality
    'I' a base). Returns the fofn's path."""
    with open(os.path.join(out_dir, "reads.fasta"), "rb") as fh:
        lines = fh.read().split(b"\n")
    first = os.path.join(out_dir, "sample1.fasta")
    second = os.path.join(out_dir, "sample2.fastq.gz")
    with open(first, "wb") as fh:
        fh.write(b"\n".join(lines[:2 * n_first]) + b"\n")
    with gzip.open(second, "wb", compresslevel=1) as fh:
        for k in range(2 * n_first, len(lines) - 1, 2):
            seq = lines[k + 1]
            fh.write(b"@%s\n%s\n+\n%s\n" % (lines[k][1:], seq,
                                             b"I" * len(seq)))
    fofn = os.path.join(out_dir, "reads.fofn")
    with open(fofn, "w") as fh:
        fh.write(f"{first}\n{second}\n")
    return fofn


# ------------------------------------------------------------ small cases

# The datasets of tests/test_pipeline_e2e.py (same seeds and layouts, the
# port's copies of the simulator's functions), each written into a
# directory; each returns the CLI's input arguments.

GENE1 = [(2000, 2400), (3000, 3400), (4000, 4600)]     # '+' strand
GENE2 = [(8000, 8500), (9200, 9900)]                   # '-' strand
ISO1B = [(2000, 2400), (4000, 4600)]                   # exon-skip isoform


def _sim():
    from mandalorion_tpu_torch.io import fastx
    from mandalorion_tpu_torch.utils import simulate
    return simulate, fastx


def gz_fastq(path: str, reads) -> None:
    """(name, seq) reads as a gzipped FASTQ, quality 'I' a base."""
    with gzip.open(path, "wt") as fh:
        for name, seq in reads:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def two_sample(d: str) -> list:
    """Two genes (one with an exon-skip isoform), two FASTA samples in a
    fofn; the suite's shared dataset."""
    sim, fastx = _sim()
    rng = np.random.default_rng(77)
    genome = sim.make_genome(12000, seed=55)
    genome = sim.plant_introns(genome, GENE1)
    genome = sim.plant_introns(genome, ISO1B)
    genome = sim.plant_introns(genome, GENE2, strand="-")
    t1 = sim.transcript_seq(genome, GENE1)
    t1b = sim.transcript_seq(genome, ISO1B)
    t2 = fastx.revcomp(sim.transcript_seq(genome, GENE2))
    reads1 = [(f"g1r{i}", sim.mutate_read(t1, rng, 0.01)[0])
              for i in range(20)]
    reads1 += [(f"g1br{i}", sim.mutate_read(t1b, rng, 0.01)[0])
               for i in range(6)]
    reads2 = [(f"g2r{i}", sim.mutate_read(t2, rng, 0.01)[0])
              for i in range(12)]
    paths = [os.path.join(d, f"sample{k}.fasta") for k in (1, 2)]
    fastx.write_fasta(paths[0], reads1)
    fastx.write_fasta(paths[1], reads2)
    return _inputs(d, {"chr1": genome}, "".join((
        sim.gtf_lines("chr1", "GENE1", "T1", GENE1),
        sim.gtf_lines("chr1", "GENE2", "T2", GENE2, strand="-"))), paths)


def three_sample_mixed(d: str) -> list:
    """Config-5's shape: one isoform over three samples in a fofn, the
    middle one a gzipped FASTQ, the others FASTA."""
    sim, fastx = _sim()
    rng = np.random.default_rng(5)
    genome = sim.make_genome(9000, seed=50)
    exons = [(2000, 2500), (3500, 4200)]
    genome = sim.plant_introns(genome, exons)
    t = sim.transcript_seq(genome, exons)
    paths = []
    for s, n in enumerate((6, 4, 9)):
        reads = [(f"s{s}read{i}", sim.mutate_read(t, rng, 0.01)[0])
                 for i in range(n)]
        if s == 1:
            paths.append(os.path.join(d, f"sample{s}.fastq.gz"))
            gz_fastq(paths[-1], reads)
        else:
            paths.append(os.path.join(d, f"sample{s}.fasta"))
            fastx.write_fasta(paths[-1], reads)
    return _inputs(d, {"chr1": genome}, None, paths)


def spliced_and_mono(d: str) -> list:
    """A spliced and a mono-exon gene, one gzipped FASTQ, no annotation:
    the flag surface's dataset."""
    sim, _fastx = _sim()
    rng = np.random.default_rng(9)
    genome = sim.make_genome(12000, seed=60)
    spliced = [(2000, 2500), (3500, 4100)]
    mono = [(7000, 7900)]
    genome = sim.plant_introns(genome, spliced)
    ts = sim.transcript_seq(genome, spliced)
    tm = sim.transcript_seq(genome, mono)
    reads = [(f"s{i}", sim.mutate_read(ts, rng, 0.01)[0]) for i in range(8)]
    reads += [(f"m{i}", sim.mutate_read(tm, rng, 0.01)[0]) for i in range(6)]
    path = os.path.join(d, "reads.fastq.gz")
    gz_fastq(path, reads)
    return _inputs(d, {"chr1": genome}, None, [path])


def two_chromosomes_junk(d: str) -> list:
    """A gene on each of two chromosomes, and three unmappable reads."""
    sim, fastx = _sim()
    rng = np.random.default_rng(41)
    g1 = sim.make_genome(9000, seed=81)
    g2 = sim.make_genome(9000, seed=82)
    e1 = [(2000, 2500), (3500, 4200)]
    e2 = [(2500, 3000), (4500, 5100)]
    g1 = sim.plant_introns(g1, e1)
    g2 = sim.plant_introns(g2, e2, strand="-")
    t1 = sim.transcript_seq(g1, e1)
    t2 = fastx.revcomp(sim.transcript_seq(g2, e2))
    reads = [(f"a{i}", sim.mutate_read(t1, rng, 0.01)[0]) for i in range(7)]
    reads += [(f"b{i}", sim.mutate_read(t2, rng, 0.01)[0]) for i in range(5)]
    reads += [(f"junk{i}", sim.make_genome(800, seed=900 + i))
              for i in range(3)]
    path = os.path.join(d, "reads.fasta")
    fastx.write_fasta(path, reads)
    return _inputs(d, {"chrA": g1, "chrB": g2}, "".join((
        sim.gtf_lines("chrA", "GA", "TA", e1),
        sim.gtf_lines("chrB", "GB", "TB", e2, strand="-"))), [path])


def all_junk(d: str) -> list:
    """No read maps."""
    sim, fastx = _sim()
    path = os.path.join(d, "reads.fasta")
    fastx.write_fasta(path, [(f"junk{i}", sim.make_genome(600, seed=500 + i))
                             for i in range(5)])
    return _inputs(d, {"chr1": sim.make_genome(9000, seed=1)}, None, [path])


def long_reads(d: str) -> list:
    """abPOA's -S regime: a 12 kb 4-exon transcript and a 25 kb mono-exon
    one, 15 reads each."""
    sim, fastx = _sim()
    rng = np.random.default_rng(4)
    genome = sim.make_genome(400_000, seed=8)
    exons1 = [(20_000 + i * 6000, 20_000 + i * 6000 + 3000)
              for i in range(4)]
    genome = sim.plant_introns(genome, exons1, strand="+")
    t1 = sim.transcript_seq(genome, exons1)
    t2 = genome[200_000:225_000]
    reads = []
    for ri in range(15):
        reads.append((f"a{ri}", sim.mutate_read(t1, rng, 0.01)[0]))
        reads.append((f"b{ri}", sim.mutate_read(t2, rng, 0.01)[0]))
    path = os.path.join(d, "reads.fasta")
    fastx.write_fasta(path, reads)
    return _inputs(d, {"chr1": genome}, "".join((
        sim.gtf_lines("chr1", "G0", "T0", exons1, strand="+"),
        sim.gtf_lines("chr1", "G1", "T1", [(200_000, 225_000)],
                      strand="+"))), [path])


def pacbio_bam(d: str) -> list:
    """One PacBio BAM of eight unmapped CCS records, with -P."""
    sim, _fastx = _sim()
    rng = np.random.default_rng(31)
    genome = sim.make_genome(9000, seed=70)
    exons = [(2000, 2600), (4000, 4700)]
    genome = sim.plant_introns(genome, exons)
    t = sim.transcript_seq(genome, exons)
    path = os.path.join(d, "movie.bam")
    write_bam(path, [(f"ccs{i}", 4, sim.mutate_read(t, rng, 0.01)[0])
                     for i in range(8)])
    return _inputs(d, {"chr1": genome}, None, [path]) + ["-P"]


def forked_pool(d: str) -> list:
    """Two gzipped FASTQ samples of 600 and 550 reads on one gene: over
    twice `batch_reads`, so module A's pool takes more than one job."""
    sim, _fastx = _sim()
    rng = np.random.default_rng(77)
    genome = sim.make_genome(150_000, seed=21)
    exons = [(9000, 9700), (12_000, 12_500), (15_000, 15_400)]
    genome = sim.plant_introns(genome, exons, strand="+")
    t = sim.transcript_seq(genome, exons)
    paths = []
    for si, n in (("a", 600), ("b", 550)):
        paths.append(os.path.join(d, f"s{si}.fastq.gz"))
        gz_fastq(paths[-1], [(f"s{si}r{i}", sim.mutate_read(t, rng, 0.01)[0])
                             for i in range(n)])
    return _inputs(d, {"chr1": genome},
                   sim.gtf_lines("chr1", "G0", "T0", exons, strand="+"),
                   paths)


def _inputs(d, chroms: dict, gtf, reads) -> list:
    """Writes genome.fasta (and ann.gtf, and reads.fofn for more than one
    read file) into d; returns the CLI's input arguments."""
    with open(os.path.join(d, "genome.fasta"), "w") as fh:
        fh.write("".join(f">{c}\n{s}\n" for c, s in chroms.items()))
    args = ["-G", os.path.join(d, "genome.fasta")]
    if gtf is not None:
        with open(os.path.join(d, "ann.gtf"), "w") as fh:
            fh.write(gtf)
        args += ["-g", os.path.join(d, "ann.gtf")]
    if len(reads) > 1:
        with open(os.path.join(d, "reads.fofn"), "w") as fh:
            fh.write("".join(f"{p}\n" for p in reads))
        return args + ["-f", os.path.join(d, "reads.fofn")]
    return args + ["-f", reads[0]]


_BAM_CODE = {b: i for i, b in enumerate("=ACMGRSVTWYHKDBN")}


def write_bam(path: str, records) -> None:
    """A minimal BAM (no header text, no references) of (name, flag, seq)
    records with no alignment, as a PacBio CCS BAM holds them."""
    payload = b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 0)
    for name, flag, seq in records:
        name_b = name.encode() + b"\x00"
        packed = bytearray()
        for i in range(0, len(seq), 2):
            lo = _BAM_CODE[seq[i + 1]] if i + 1 < len(seq) else 0
            packed.append(_BAM_CODE[seq[i]] << 4 | lo)
        body = struct.pack("<iiBBHHHiiii", -1, -1, len(name_b), 0, 0, 0,
                           flag, len(seq), -1, -1, 0)
        body += name_b + bytes(packed) + b"\xff" * len(seq)
        payload += struct.pack("<i", len(body)) + body
    with gzip.open(path, "wb") as fh:
        fh.write(payload)


# ------------------------------------------------------------ the runs

def artifact_bytes(out_dir: str) -> dict:
    blobs = {}
    for name in ARTIFACTS:
        with open(os.path.join(out_dir, name), "rb") as fh:
            blobs[name] = fh.read()
        if not blobs[name]:
            raise AssertionError(f"{out_dir}: {name} is empty")
    return blobs


def stage_seconds(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "tmp", "timing.tsv")) as fh:
        return {k: float(v) for k, v in
                (line.rstrip("\n").split("\t")[:2] for line in fh
                 if line.strip() and not line.startswith("stage"))}


# polls VmRSS of the process named by argv[1], and of each of its direct
# children but this one, every 50 ms; prints a line when it runs, and on
# SIGTERM the process's peak and its largest child's, in bytes
RSS_SAMPLER = r"""
import os, signal, sys, time
pid, me, peak, child_peak = sys.argv[1], str(os.getpid()), 0, 0
def rss(p):
    with open(f"/proc/{p}/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0
def children():
    for p in os.listdir("/proc"):
        if p.isdigit() and p != me:
            try:
                with open(f"/proc/{p}/stat") as fh:
                    ppid = fh.read().rsplit(")", 1)[1].split()[1]
                if ppid == pid:
                    yield rss(p)
            except (OSError, IndexError):
                pass
def sample():
    global peak, child_peak
    peak = max(peak, rss(pid))
    child_peak = max([child_peak, *children()])
def stop(*_):
    sample()
    print(peak, child_peak, flush=True)
    sys.exit(0)
signal.signal(signal.SIGTERM, stop)
sample()
print("sampling", flush=True)
while True:
    time.sleep(0.05)
    sample()
"""


@contextlib.contextmanager
def rss_peak():
    """Yields a dict whose `peak_rss_bytes`, after the block, is this
    process's peak RSS over the block, and `peak_child_rss_bytes` its
    largest direct child's (the pipeline's forked workers), VmRSS sampled
    every 50 ms by a child process: a thread would keep the pipeline from
    forking its workers, and getrusage's ru_maxrss can neither be reset
    nor trusted in a child (Linux keeps across execve the size of the
    address space that fork copied)."""
    out: dict = {}
    proc = subprocess.Popen([sys.executable, "-c", RSS_SAMPLER,
                             str(os.getpid())], stdout=subprocess.PIPE,
                            text=True)
    try:
        if not proc.stdout.readline():
            raise RuntimeError("the RSS sampler did not start")
        yield out
    finally:
        proc.terminate()
        text, _err = proc.communicate(timeout=10)
    out["peak_rss_bytes"], out["peak_child_rss_bytes"] = (
        int(field) for field in text.split()[-2:])


def launch_counters() -> dict:
    from mandalorion_tpu_torch.align import chain_kernel, kernels
    from mandalorion_tpu_torch.poa import kernels as poa
    return dict(dp_fused=kernels.DP_LAUNCHES,
                chain_rows=chain_kernel.CHAIN_LAUNCHES,
                poa_fwd=poa.POA_FWD_LAUNCHES, poa_walk=poa.POA_WALK_LAUNCHES,
                poa_sweep=poa.POA_SWEEP_LAUNCHES)


def route_child(cli_args) -> None:
    """The `route` subcommand: one run of the port's CLI in this process,
    then one JSON line of its resources."""
    import torch
    from mandalorion_tpu_torch.pipeline import cli
    counters = launch_counters()
    for counter in counters.values():
        counter.count = 0
    with rss_peak() as rss:
        t0 = time.time()
        rc = cli.main(cli_args)
        seconds = time.time() - t0
    peak_dev = None
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        peak_dev = torch.cuda.max_memory_allocated()
    print(json.dumps({
        "rc": rc, "seconds": seconds, "peak_device_bytes": peak_dev,
        "launches": {k: c.count for k, c in counters.items()}, **rss}),
        flush=True)
    if rc != 0:
        raise SystemExit(rc)


def run_route(label: str, out_dir: str, inputs, flags, n_reads: int,
              timeout: float | None = None) -> dict:
    """The port's CLI on `inputs` with `flags` in a process of its own
    (`route`), killed after `timeout` seconds when one is given; returns
    its stage seconds and resources, and prints them."""
    cmd = [sys.executable, os.path.abspath(__file__), "route", "-p",
           out_dir, *inputs, *flags]
    env = dict(os.environ, PYTHONPATH=ROOT)
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"{label} did not end within {timeout} s") \
            from exc
    if proc.returncode != 0:
        raise RuntimeError(f"{label} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return route_result(label, out_dir, n_reads,
                        json.loads(proc.stdout.strip().splitlines()[-1]))


def route_result(label: str, out_dir: str, n_reads: int, res: dict) -> dict:
    """A run's answer with its stage seconds and reads/s added; printed."""
    res["stages"] = stages = stage_seconds(out_dir)
    res["module_a_reads_s"] = n_reads / stages["A_alignment"]
    res["apdfq_reads_s"] = n_reads / sum(stages.values())
    print(f"{label}: wall {res['seconds']:.2f} s; stage seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; module A {res['module_a_reads_s']:.1f} reads/s, APDFQ "
          f"{res['apdfq_reads_s']:.1f} reads/s (index build included); "
          f"peak RSS {res['peak_rss_bytes']} bytes (largest child "
          f"{res['peak_child_rss_bytes']}); peak device memory "
          f"{res['peak_device_bytes']} bytes; launches {res['launches']}",
          flush=True)
    return res


def serve_child() -> None:
    """The `serve` subcommand: the port's CLI run again and again in this
    one process, warm. A request is one JSON line on stdin, the CLI's
    arguments; the answer is one JSON line of the run's resources on a
    duplicate of the stdout this process started with, while fd 1 points
    at stderr, so that neither the CLI's prints nor its forked workers'
    reach the answers. Before each run it raises unless the pipeline may
    fork its pools (one thread, CUDA never initialised); each answer
    counts the forks the run made. A failed run, or a line that is not
    JSON, raises, which ends the process non-zero."""
    import threading
    import torch
    from mandalorion_tpu_torch.pipeline import cli
    sys.stdout.flush()
    answers = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    forks = [0]
    os.register_at_fork(
        after_in_parent=lambda: forks.__setitem__(0, forks[0] + 1))
    counters = launch_counters()
    for line in sys.stdin:
        cli_args = json.loads(line)
        threads = threading.active_count()
        if threads != 1 or torch.cuda.is_initialized():
            raise RuntimeError(
                f"serve: the pipeline could not fork its pools ({threads} "
                f"threads, CUDA initialised "
                f"{torch.cuda.is_initialized()}): {cli_args}")
        for counter in counters.values():
            counter.count = 0
        forks_before = forks[0]
        with rss_peak() as rss:
            t0 = time.time()
            rc = cli.main(cli_args)
            seconds = time.time() - t0
        if rc != 0:
            raise SystemExit(f"serve: the run returned {rc}: {cli_args}")
        answers.write(json.dumps({
            "seconds": seconds, "forks": forks[0] - forks_before,
            "threads": threads,
            "cuda_initialized": torch.cuda.is_initialized(),
            "peak_device_bytes": None,
            "launches": {k: c.count for k, c in counters.items()},
            **rss}) + "\n")
        answers.flush()


class RouteServer:
    """A `serve` child in a process group of its own: the port's CLI run
    warm, a run a request (`run`). Its stderr, the CLI's output included,
    goes to `log_path`. Leaving the block ends the requests, waits for
    the child and checks its exit code; leaving it on an exception kills
    the child's whole group (its RSS sampler and forked workers too)."""

    def __init__(self, log_path: str):
        self.log_path = log_path
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "serve"], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.log, text=True,
            start_new_session=True)

    def __enter__(self) -> "RouteServer":
        return self

    def __exit__(self, exc_type, _exc, _tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.kill()

    def log_tail(self) -> str:
        with open(self.log_path) as fh:
            return fh.read()[-3000:]

    def run(self, label: str, out_dir: str, inputs, flags, n_reads: int,
            timeout: float) -> dict:
        """The CLI on `inputs` with `flags` in the child; raises, naming
        `label`, when the run fails or is not answered within `timeout`
        seconds. Returns what `run_route` returns, and the forks."""
        try:
            self.proc.stdin.write(json.dumps(
                ["-p", out_dir, *inputs, *flags]) + "\n")
            self.proc.stdin.flush()
        except BrokenPipeError as exc:
            raise RuntimeError(f"{label}: the serve child has ended "
                               f"({self.proc.wait()}):\n{self.log_tail()}"
                               ) from exc
        ready, _w, _x = select.select([self.proc.stdout], [], [], timeout)
        if not ready:
            raise RuntimeError(f"{label} did not end within {timeout} s")
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"{label} failed ({self.proc.wait()}):\n"
                               f"{self.log_tail()}")
        return route_result(label, out_dir, n_reads, json.loads(line))

    def close(self) -> None:
        self.proc.stdin.close()
        rc = self.proc.wait(timeout=60)
        self.proc.stdout.close()
        self.log.close()
        if rc != 0:
            raise RuntimeError(f"the serve child ended with {rc}:\n"
                               f"{self.log_tail()}")

    def kill(self) -> None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()
        for fh in (self.proc.stdin, self.proc.stdout, self.log):
            with contextlib.suppress(OSError):
                fh.close()


def same_artifacts(runs: dict) -> None:
    """Every run's artifacts byte-identical to the first's."""
    (first, out0), *rest = runs.items()
    want = artifact_bytes(out0)
    for label, out in rest:
        got = artifact_bytes(out)
        for name in ARTIFACTS:
            if got[name] != want[name]:
                raise AssertionError(f"{name} of {label} differs from "
                                     f"{first}'s")


def device_flags(device: str) -> tuple:
    return ("--device", device, "--consensus_backend", "device")


def isoform_chroms(out_dir: str) -> dict:
    chroms = {}
    with open(os.path.join(out_dir, "Isoforms.filtered.clean.psl")) as fh:
        for line in fh:
            f = line.split("\t")
            chroms[f[13]] = chroms.get(f[13], 0) + 1
    return chroms


def run_config2(tmp, device, reads_per: int = 50, threads: int = 0) -> dict:
    from mandalorion_tpu_torch.utils.simulate import (
        evaluate_adversarial, make_adversarial_dataset)
    t0 = time.time()
    truth = make_adversarial_dataset(tmp, reads_per_isoform=reads_per)
    print(f"dataset: {truth['n_reads']} reads ({time.time() - t0:.2f} s)")
    inputs = [os.path.join(tmp, "genome.fasta"), os.path.join(tmp, "ann.gtf"),
              os.path.join(tmp, "reads.fasta")]
    inputs = ["-G", inputs[0], "-g", inputs[1], "-f", inputs[2],
              "-t", str(threads or os.cpu_count() or 2)]
    outs = {"device route": os.path.join(tmp, "device"),
            "host route": os.path.join(tmp, "host")}
    res = {label: run_route(label, out, inputs, flags, truth["n_reads"])
           for (label, out), flags in zip(outs.items(),
                                          (device_flags(device), HOST_ROUTE))}
    same_artifacts(outs)
    gates = evaluate_adversarial(outs["device route"], truth)
    ok = (gates["isoform_recall"] == 1.0 and gates["junction_recall"] == 1.0
          and not gates["pseudogene_false_calls"]
          and gates["read_purity"] >= 0.95)
    return dict(runs=res, gates=gates, ok=ok, n_reads=truth["n_reads"])


def run_config3(tmp, device, n_genes: int = 100, per_gene: int = 1000,
                mbp: int = 50) -> dict:
    t0 = time.time()
    n_reads = config3_files(tmp, n_genes, per_gene, mbp)
    print(f"dataset: {n_reads} reads on {mbp} Mbp ({time.time() - t0:.2f} s)")
    inputs = ["-G", os.path.join(tmp, "genome.fasta"),
              "-g", os.path.join(tmp, "ann.gtf"),
              "-f", os.path.join(tmp, "reads.fasta")]
    outs = {"device route": os.path.join(tmp, "device"),
            "host route": os.path.join(tmp, "host")}
    res = {label: run_route(label, out, inputs, flags, n_reads)
           for (label, out), flags in zip(outs.items(),
                                          (device_flags(device), HOST_ROUTE))}
    same_artifacts(outs)
    with open(os.path.join(outs["device route"],
                           "Isoforms.filtered.fasta")) as fh:
        n_iso = sum(line.startswith(">") for line in fh)
    return dict(runs=res, ok=True, n_reads=n_reads, isoforms=n_iso,
                expected_isoforms=n_genes)


def cache_turns(tmp, device, inputs, n_reads, truth,
                timeout: float | None = None) -> dict:
    """The device route writing `--index_cache <tmp>/genome.idx` (a
    directory), the host route loading it memory-mapped, the device route
    loading it, each turn within `timeout` seconds: artifacts
    byte-identical, each planted gene one isoform on its own
    chromosome."""
    cache = ["--index_cache", os.path.join(tmp, "genome.idx")]
    turns = (("device route, cache written", "device0", device_flags(device)),
             ("host route, cache loaded", "host", HOST_ROUTE),
             ("device route, cache loaded", "device1", device_flags(device)))
    outs, res = {}, {}
    for label, sub, flags in turns:
        outs[label] = os.path.join(tmp, sub)
        res[label] = run_route(label, outs[label], inputs, [*flags, *cache],
                               n_reads, timeout)
    same_artifacts(outs)
    want = {}
    for chrom, _n_exons in truth:
        want[chrom] = want.get(chrom, 0) + 1
    got = isoform_chroms(outs["device route, cache written"])
    return dict(runs=res, isoform_chroms=got, planted=want, ok=got == want)


def run_config4(tmp, device, gbp: float = 3.1, n_chroms: int = 24,
                genes_per_chrom: int = 3, per_gene: int = 100) -> dict:
    t0 = time.time()
    truth = config4_files(tmp, gbp, n_chroms, genes_per_chrom, per_gene)
    n_reads = len(truth) * per_gene
    print(f"dataset: {n_reads} reads on {gbp} Gbp over {n_chroms} "
          f"chromosomes ({time.time() - t0:.2f} s)")
    inputs = ["-G", os.path.join(tmp, "genome.fasta"),
              "-g", os.path.join(tmp, "ann.gtf"),
              "-f", os.path.join(tmp, "reads.fasta")]
    out = cache_turns(tmp, device, inputs, n_reads, truth)
    cache = os.path.join(tmp, "genome.idx")
    out["index_cache_bytes"] = sum(
        os.path.getsize(os.path.join(cache, f)) for f in os.listdir(cache))
    out["n_reads"] = n_reads
    return out


COMMANDS = {"config2": (run_config2, (int, int)),
            "config3": (run_config3, (int, int, int)),
            "config4": (run_config4, (float, int, int, int))}


def main(argv) -> int:
    if argv[:1] == ["route"]:
        route_child(argv[1:])
        return 0
    if argv == ["serve"]:
        serve_child()
        return 0
    device, rest = "cuda", []
    it = iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, "")
        else:
            rest.append(arg)
    if not rest or rest[0] not in COMMANDS or device not in ("cuda", "cpu"):
        raise SystemExit(__doc__)
    fn, types = COMMANDS[rest[0]]
    args = [t(a) for t, a in zip(types, rest[1:])]
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("run_configs_torch: no CUDA device")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"card: {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        result = fn(tmp, device, *args)
    print(json.dumps({"config": rest[0], "args": args, "device": device,
                      **{k: v for k, v in result.items() if k != "runs"},
                      "runs": {label: {k: r[k] for k in (
                          "seconds", "stages", "module_a_reads_s",
                          "apdfq_reads_s", "peak_rss_bytes",
                          "peak_child_rss_bytes", "peak_device_bytes")}
                          for label, r in result["runs"].items()}}))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
