"""GTF annotation parsing and writing.

Covers the reference's two independent GTF readers — splice-site bounds +
polyA whitelist (`SpliceDefineConsensus.parse_genome`, SDC.py:334-389) and
per-gene exon maps (`groupIsoforms.read_annotation`, groupIsoforms.py:28-81)
— plus the PSL→GTF writer (`filterIsoforms.psl_to_gtf`, :418-440).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple


def _open_gtf(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _attr(attrs: str, key: str) -> str:
    return attrs.split(key + ' "')[1].split('"')[0]


@dataclass
class Annotation:
    """Parsed annotation: per-chrom annotated splice-site bounds and the
    polyA whitelist.

    left_bounds[chrom]['5'|'3']  — exon *ends* that are not the transcript
    end (donor side on '+'); right_bounds — exon *starts* (minus 1) that are
    not the transcript start. Transcript terminal coordinates are excluded
    (`SDC.py:379-388`).
    """

    chroms: Set[str] = field(default_factory=set)
    left_bounds: Dict[str, Dict[str, List[int]]] = field(default_factory=dict)
    right_bounds: Dict[str, Dict[str, List[int]]] = field(default_factory=dict)
    # (chrom, direction, end_position, transcript_id)
    polya_whitelist: List[Tuple[str, str, str, str]] = field(default_factory=list)


def parse_annotation(path: str, white_list_polyA: Sequence[str]) -> Annotation:
    """Extract annotated internal splice-site positions per chromosome and
    the polyA whitelist from transcript ends of lines containing any of the
    `-W` substrings (substring match against the whole line, as in the
    reference)."""
    ann = Annotation()
    transcripts: Dict[str, List[Tuple[str, str, str, str, bool]]] = {}
    with _open_gtf(path) as fh:
        for line in fh:
            whitelisted = any(w in line for w in white_list_polyA)
            a = line.rstrip("\n").split("\t")
            if len(a) <= 7:
                continue
            if a[2] == "exon":
                tid = _attr(a[8], "transcript_id")
                transcripts.setdefault(tid, []).append(
                    (a[0], a[3], a[4], a[6], whitelisted))

    for tid, exons in transcripts.items():
        chrom = exons[0][0]
        direction = exons[0][3]
        ann.chroms.add(chrom)
        if chrom not in ann.right_bounds:
            ann.left_bounds[chrom] = {"5": [], "3": []}
            ann.right_bounds[chrom] = {"5": [], "3": []}
        start = min(exons, key=lambda e: int(e[1]))[1]
        end = max(exons, key=lambda e: int(e[2]))[2]
        if exons[0][4]:
            if direction == "+":
                ann.polya_whitelist.append((chrom, direction, end, tid))
            elif direction == "-":
                ann.polya_whitelist.append((chrom, direction, start, tid))
        for chrom_e, e_start, e_end, e_dir, _ in exons:
            if e_start != start:
                side = "3" if e_dir == "+" else "5"
                ann.right_bounds[chrom][side].append(int(e_start) - 1)
            if e_end != end:
                side = "5" if e_dir == "+" else "3"
                ann.left_bounds[chrom][side].append(int(e_end))
    return ann


def parse_gene_exons(path: str) -> Dict[str, Dict[str, Dict[int, Set[str]]]]:
    """coordDict[direction][chrom][position] -> set(gene) with exon bases
    sampled every 2 nt (`groupIsoforms.py:63-80`). Gene key is
    gene_id or gene_id_gene_name when gene_name is present."""
    coord: Dict[str, Dict[str, Dict[int, Set[str]]]] = {"+": {}, "-": {}}
    if path in (None, "None"):
        return coord
    with _open_gtf(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            a = line.rstrip("\n").split("\t")
            if len(a) <= 7 or a[2] != "exon":
                continue
            chrom, left, right, direction = a[0], int(a[3]) - 1, int(a[4]), a[6]
            gene = _attr(a[8], "gene_id")
            if "gene_name" in a[8]:
                gene += "_" + _attr(a[8], "gene_name")
            per_chrom = coord[direction].setdefault(chrom, {})
            for i in range(left, right, 2):
                per_chrom.setdefault(i, set()).add(gene)
    return coord


def write_gtf_from_psl(psl_path: str, gtf_path: str,
                       source: str = "Mandalorion") -> None:
    """PSL → GTF: one `transcript` line plus one `exon` line per block,
    start shifted +1 to GTF's 1-based closed coordinates
    (`filterIsoforms.psl_to_gtf`, :418-440)."""
    out_lines: List[str] = []
    with open(psl_path) as fh:
        for line in fh:
            a = line.rstrip("\n").split("\t")
            direction, name, chrom = a[8], a[9], a[13]
            start, end = int(a[15]), int(a[16])
            sizes = [int(x) for x in a[18].split(",")[:-1]]
            starts = [int(x) for x in a[20].split(",")[:-1]]
            attrs = (f'transcript_id "{name}"; gene_id "{name}.gene"; '
                     f'gene_name "{name}"')
            out_lines.append(
                f"{chrom}\t{source}\ttranscript\t{start + 1}\t{end}\t.\t"
                f"{direction}\t.\t{attrs}\n")
            for bs, bw in zip(starts, sizes):
                out_lines.append(
                    f"{chrom}\t{source}\texon\t{bs + 1}\t{bs + bw}\t.\t"
                    f"{direction}\t.\t{attrs}\n")
    with open(gtf_path, "w") as out:
        out.writelines(out_lines)
