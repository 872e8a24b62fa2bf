"""The program's answer parsed from a job's files, and the plain pieces
that the generators' judges (generators/<name>.py) hold it to: intron
chains and the recount of an alignment's bases.

Only numpy and the standard library: nothing of the program.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from bm_data import COMPLEMENT

MIN_INTRON = 30   # a gap of the target this long or longer is an intron

Blocks = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class Alignment:
    strand: str
    blocks: Blocks            # (t_start, length) on the genome
    q_starts: Tuple[int, ...]  # in the aligned strand's orientation
    matches: int
    mismatches: int


@dataclasses.dataclass
class Isoform:
    strand: str
    exons: Blocks             # half-open (start, end) on the genome
    seq: bytes
    count: Optional[int]


@dataclasses.dataclass
class Answer:
    alignments: Dict[str, List[Alignment]]
    isoforms: Dict[str, Isoform]
    assigned: Dict[str, str]  # read -> isoform


# ------------------------------------------------ the program's files

def _ints(field: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in field.rstrip(",").split(",") if x)


def parse_alignments(psl: str) -> Dict[str, List[Alignment]]:
    """Module A's extended PSL (tmp/mm2Alignments.psl): its first 21
    columns a line."""
    out: Dict[str, List[Alignment]] = {}
    with open(psl) as fh:
        for line in fh:
            f = line.split("\t", 21)
            if len(f) < 21:
                continue
            sizes, q_starts, t_starts = (_ints(f[18]), _ints(f[19]),
                                         _ints(f[20]))
            out.setdefault(f[9], []).append(Alignment(
                f[8], tuple(zip(t_starts, sizes)), q_starts, int(f[0]),
                int(f[1])))
    return out


def parse_answer(out_dir: str) -> Answer:
    """A job's answer from its output directory."""
    tmp = os.path.join(out_dir, "tmp")
    isoforms: Dict[str, Isoform] = {}
    with open(os.path.join(out_dir, "Isoforms.filtered.clean.psl")) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 21:
                continue
            exons = tuple((t, t + b) for t, b in zip(_ints(f[20]),
                                                      _ints(f[18])))
            isoforms[f[9]] = Isoform(f[8], exons, b"", None)
    with open(os.path.join(out_dir, "Isoforms.filtered.fasta"), "rb") as fh:
        for entry in fh.read().split(b">")[1:]:
            head, _, body = entry.partition(b"\n")
            name = head.split()[0].decode()
            if name in isoforms:
                isoforms[name].seq = body.replace(b"\n", b"")
    with open(os.path.join(out_dir, "Isoforms.filtered.clean.quant")) as fh:
        next(fh, None)
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f and f[0] in isoforms and len(f) > 1 and f[1]:
                isoforms[f[0]].count = int(float(f[1]))
    assigned: Dict[str, str] = {}
    with open(os.path.join(tmp, "reads2isoforms.txt")) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) >= 2:
                assigned[f[0]] = f[1]
    return Answer(parse_alignments(os.path.join(tmp, "mm2Alignments.psl")),
                  isoforms, assigned)


# ------------------------------------------------ the reference

def introns(blocks: Blocks) -> Tuple[Tuple[int, int], ...]:
    """The (start, end) of each gap of the target of MIN_INTRON or more
    between (t_start, length) blocks."""
    return tuple((t + b, t2) for (t, b), (t2, _) in zip(blocks, blocks[1:])
                 if t2 - (t + b) >= MIN_INTRON)


def recount(genome: np.ndarray, read: np.ndarray, aln: Alignment
            ) -> Tuple[int, int]:
    """Matches and mismatches of the read (as written) against the genome
    over the alignment's blocks; (-1, -1) where a block leaves either."""
    r = COMPLEMENT[read[::-1]] if aln.strand == "-" else read
    same = 0
    total = 0
    for (t, b), q in zip(aln.blocks, aln.q_starts):
        a, g = r[q:q + b], genome[t:t + b]
        if len(a) != b or len(g) != b:
            return -1, -1
        same += int(np.count_nonzero(a == g))
        total += b
    return same, total - same
