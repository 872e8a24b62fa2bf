"""Isoform → locus grouping and gene assignment.

Equivalent of `groupIsoforms.py`: chain filtered isoforms into per-strand
loci (same overlap rule as the locus splitter), then majority-vote the gene
per locus by covered-base overlap with annotation exons sampled every 2 nt
(`groupIsoforms.py:84-188`). Vote ties break toward the lexicographically
larger gene key (the reference sorts (count, gene) tuples descending); the
gene-overlap list is emitted sorted (the reference iterates a Python set —
nondeterministic under hash randomization; we pin an order, SURVEY §5.9).
"""

from __future__ import annotations

from typing import Dict, List, Set, TextIO

def _match_isoforms(iso_lines: List[str], chrom: str, start: int, end: int,
                    direction: str, locus: int,
                    coord_dict: Dict[str, Dict[str, Dict[int, Set[str]]]],
                    out: TextIO) -> int:
    covered: Set[int] = set()
    for line in iso_lines:
        a = line.rstrip("\n").split("\t")
        sizes = [int(x) for x in a[18].split(",")[:-1]]
        starts = [int(x) for x in a[20].split(",")[:-1]]
        for s, z in zip(starts, sizes):
            covered.update(range(s, s + z))

    genes: Dict[str, int] = {}
    per_chrom = coord_dict[direction].get(chrom, {})
    for i in covered:
        if i in per_chrom:
            for gene in per_chrom[i]:
                genes[gene] = genes.get(gene, 0) + 1

    if genes:
        best = sorted(((c, g) for g, c in genes.items()), reverse=True)[0][1]
    else:
        best = ""
    locus += 1
    overlaps = ",".join(sorted(genes)) if genes else ""
    for line in iso_lines:
        name = line.rstrip("\n").split("\t")[9]
        out.write(f"{name}\tLocus{locus}\t{chrom}\t{start}\t{end}\t{best}\t"
                  f"{overlaps}\n")
    return locus


def group_isoforms(sorted_psl_path: str, out_path: str,
                   coord_dict: Dict[str, Dict[str, Dict[int, Set[str]]]]
                   ) -> None:
    """Write the `.genes` file: isoform, locus, span, best gene, overlaps."""
    with open(out_path, "w") as out:
        for direction in ("+", "-"):
            locus = 0  # reference resets numbering per strand (:103)
            iso_lines: List[str] = []
            prev_chrom = ""
            prev_start = 0
            prev_end = 0
            with open(sorted_psl_path) as fh:
                for line in fh:
                    a = line.rstrip("\n").split("\t")
                    if a[8] != direction:
                        continue
                    chrom, start, end = a[13], int(a[15]), int(a[16])
                    if chrom != prev_chrom or start > prev_end:
                        if iso_lines:
                            locus = _match_isoforms(
                                iso_lines, prev_chrom, prev_start, prev_end,
                                direction, locus, coord_dict, out)
                        iso_lines = [line]
                        prev_chrom = chrom
                        prev_start = start
                        prev_end = end
                    else:
                        prev_end = max(end, prev_end)
                        iso_lines.append(line)
            if iso_lines:
                locus = _match_isoforms(iso_lines, prev_chrom, prev_start,
                                        prev_end, direction, locus,
                                        coord_dict, out)
