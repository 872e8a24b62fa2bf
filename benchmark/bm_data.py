"""Pieces shared by the benchmark's data generators (generators/<name>.py):
a genome's bases from a seed, planted splice sites, a transcript's bases,
annotation lines, and the seeds of each use of the run seed.

`genome_bytes`, `plant`, `transcript` and `gtf_lines` are frozen copies
of tools/run_configs_torch.py's makers, which write tools/run_config3.py's
dataset byte for byte; later changes to the program's tools do not move
them. Only numpy and the standard library.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[ACGT] = np.frombuffer(b"TGCA", np.uint8)
CODE = np.zeros(256, dtype=np.uint8)      # A C G T -> 0 1 2 3
CODE[ACGT] = np.arange(4, dtype=np.uint8)


def genome_bytes(length: int, seed) -> np.ndarray:
    """`make_genome(length, seed)` as a writable uint8 array (seed an int
    or a SeedSequence)."""
    rng = np.random.default_rng(seed)
    return ACGT[rng.integers(0, 4, size=length, dtype=np.uint8)]


def plant(genome: np.ndarray, exons, strand: str) -> None:
    """`plant_introns` in place: GT..AG on '+', CT..AC on '-'."""
    donor, acceptor = (b"GT", b"AG") if strand == "+" else (b"CT", b"AC")
    for (_s1, e1), (s2, _e2) in zip(exons, exons[1:]):
        genome[e1], genome[e1 + 1] = donor
        genome[s2 - 2], genome[s2 - 1] = acceptor


def transcript(genome: np.ndarray, exons, strand: str) -> np.ndarray:
    """`transcript_seq`, reverse-complemented on '-'."""
    t = np.concatenate([genome[s:e] for s, e in exons])
    return COMPLEMENT[t[::-1]] if strand == "-" else t


def gtf_lines(chrom: str, gene: str, tid: str, exons, strand: str) -> str:
    attrs = (f'gene_id "{gene}"; transcript_id "{tid}"; '
             f'gene_name "{gene}N";')
    return "".join(f"{chrom}\tsynth\texon\t{s + 1}\t{e}\t.\t{strand}\t.\t"
                   f"{attrs}\n" for s, e in exons)


def write_genome(fh, chrom: str, genome: np.ndarray) -> None:
    fh.write(b">%s\n" % chrom.encode())
    fh.write(memoryview(genome))
    fh.write(b"\n")


def sub_seed(seed: int, *path: int) -> np.random.SeedSequence:
    """The seed of one use of the run seed (any whole number >= 0)."""
    return np.random.SeedSequence([int(seed), *path])
