"""Splice-site peak calling over locus read tables.

Re-design of the reference's per-base dict loops (`collect_reads`
SDC.py:278-331, `make_genome_bins` :392-438, `find_peaks`/`scan_for_best_bin`
/`determine_cov` :163-275) over columnar numpy arrays. The greedy peak-scan
order (candidates by descending support, first-appearance tie-break; bins
probed at offsets [0,+1,-1,...]) is preserved exactly — output parity
depends on it (SURVEY §5.9 #5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mandalorion_tpu_torch.core.coverage import CoverageIntervals, build_coverage
from mandalorion_tpu_torch.core.csparse import (
    CsIndex, build_cs_index, characterize_splicing_event)
from mandalorion_tpu_torch.io.psl import PslRecord


def myround(x, base: int = 10) -> int:
    """Round to the nearest `base` with banker's rounding (reference
    `myround`, SDC.py:227-229 — Python round())."""
    return int(base * round(float(x) / base))


@dataclass
class LocusReads:
    """Columnar view of one locus's extended-PSL reads, file order."""

    names: List[str]
    dirns: List[str]
    q_sizes: np.ndarray
    q_starts: np.ndarray     # col 11
    q_ends: np.ndarray       # col 12
    begins: np.ndarray       # tStart
    spans: np.ndarray        # tEnd
    accuracies: np.ndarray
    block_sizes: List[np.ndarray]
    block_starts: List[np.ndarray]
    cs_strings: List[str]
    sequences: List[str]
    _cs_cache: Dict[int, CsIndex] = field(default_factory=dict)

    @classmethod
    def from_records(cls, records: Sequence[PslRecord]) -> "LocusReads":
        return cls(
            names=[r.q_name for r in records],
            dirns=[r.strand for r in records],
            q_sizes=np.array([r.q_size for r in records], np.int64),
            q_starts=np.array([r.q_start for r in records], np.int64),
            q_ends=np.array([r.q_end for r in records], np.int64),
            begins=np.array([r.t_start for r in records], np.int64),
            spans=np.array([r.t_end for r in records], np.int64),
            accuracies=np.array(
                [r.accuracy if r.accuracy is not None else 1.0
                 for r in records], np.float64),
            block_sizes=[np.asarray(r.block_sizes, np.int64) for r in records],
            block_starts=[np.asarray(r.t_starts, np.int64) for r in records],
            cs_strings=[r.cs or "" for r in records],
            sequences=[r.sequence or "" for r in records],
        )

    def __len__(self) -> int:
        return len(self.names)

    def cs_index(self, i: int) -> CsIndex:
        if i not in self._cs_cache:
            self._cs_cache[i] = build_cs_index(
                self.cs_strings[i], int(self.begins[i]))
        return self._cs_cache[i]


@dataclass
class EdgeTable:
    """One side's splice-edge histogram: positions in first-appearance
    order with, per position, the supporting read indices."""

    order: List[int]                        # positions, first-appearance order
    items: Dict[int, List[int]]             # position -> read indices

    def count(self, pos: int) -> int:
        lst = self.items.get(pos)
        return len(lst) if lst else 0


@dataclass
class LocusHistograms:
    left: EdgeTable
    right: EdgeTable
    coverage: CoverageIntervals              # per-read bucket intervals
    reads: LocusReads

    @property
    def cov(self) -> Dict[int, int]:
        """Sparse position -> count view (reference histo_cov shape)."""
        return self.coverage.cov_dict()


def collect_reads(reads: LocusReads,
                  accuracy_gate: float = 0.9) -> LocusHistograms:
    """Coverage histogram (10 nt buckets) + splice-edge tables as one
    flattened segment sweep (core/coverage.py).

    Edge tables only include reads with accuracy >= accuracy_gate; the
    coverage histogram includes ALL reads (SDC.py:316-330). Left edges are
    block ends != alignment end; right edges are block starts != alignment
    start."""
    coverage = build_coverage(reads.block_starts, reads.block_sizes)
    left = EdgeTable([], {})
    right = EdgeTable([], {})
    for i in range(len(reads)):
        if reads.accuracies[i] < accuracy_gate:
            continue
        starts = reads.block_starts[i]
        sizes = reads.block_sizes[i]
        begin, span = int(reads.begins[i]), int(reads.spans[i])
        ends = starts + sizes
        for e in ends:
            e = int(e)
            if e != span:
                if e not in left.items:
                    left.items[e] = []
                    left.order.append(e)
                left.items[e].append(i)
        for s in starts:
            s = int(s)
            if s != begin:
                if s not in right.items:
                    right.items[s] = []
                    right.order.append(s)
                right.items[s].append(i)
    return LocusHistograms(left, right, coverage, reads)


def make_genome_bins(bounds: Dict[str, List[int]], side: str, chrom: str,
                     peak_areas: set, splice_site_width: int
                     ) -> List[List[str]]:
    """Convert annotated splice positions into peak bins: chain positions
    within splice_site_width; split multi-position clusters at midpoints
    when all gaps > 3 (SDC.py:392-438). Marks peak_areas in place; returns
    toWrite rows [chrom, start, end, type, side, 'A']."""
    w = splice_site_width
    to_write: List[List[str]] = []
    for type1 in ("5", "3"):
        position_list = sorted(bounds[type1], key=int)
        covered = set()
        for i1 in range(len(position_list)):
            if i1 in covered:
                continue
            sub = [position_list[i1]]
            for i2 in range(i1, len(position_list)):
                if position_list[i2] - max(sub) <= w:
                    sub.append(position_list[i2])
                    covered.add(i2)
                else:
                    break
            single = False
            if len(sub) > 1:
                gaps = [sub[j + 1] - sub[j] for j in range(len(sub) - 1)]
                if min(gaps) > 3:
                    for x in range(len(sub)):
                        if x != 0:
                            start = int(sub[x] - ((sub[x] - sub[x - 1]) / 2))
                        else:
                            start = int(sub[x]) - w
                        if x != len(sub) - 1:
                            end = int(sub[x] + ((sub[x + 1] - sub[x]) / 2))
                        else:
                            end = int(sub[x]) + w
                        to_write.append(
                            [chrom, str(start), str(end), type1, side, "A"])
                        peak_areas.update(range(start, end + 1))
                else:
                    single = True
            else:
                single = True
            if single:
                start = min(sub) - w
                end = max(sub) + w
                to_write.append([chrom, str(start), str(end), type1, side, "A"])
                peak_areas.update(range(start, end + 1))
    return to_write


def _scan_for_best_bin(entry: int, dist_range: List[int], table: EdgeTable,
                       peak_areas: set):
    """Best densest bin around `entry` (SDC.py:163-197): probe centers at
    offsets [0,+1,-1,...]; a center is skipped if any bin position is
    already inside a peak area; strict > keeps the first best."""
    best_count, peak_center = 0, 0
    best_reads: List[int] = []
    for x in dist_range:
        if any((entry + x + y) in peak_areas for y in dist_range):
            continue
        bin_reads: List[int] = []
        for y in dist_range:
            lst = table.items.get(entry + x + y)
            if lst:
                bin_reads.extend(lst)
        if len(bin_reads) > best_count:
            best_count = len(bin_reads)
            best_reads = bin_reads
            peak_center = entry + x
    return best_count, peak_center, best_reads


def _determine_cov(hist: LocusHistograms, bin_reads: List[int],
                   reverse: bool, peak_center: int) -> int:
    """Local coverage denominator (SDC.py:200-224): positions covered by
    >1 read in the bin, beyond the peak center (direction depends on side),
    first 4 such positions, max coverage-histogram value."""
    if not bin_reads:
        return 0
    multi = hist.coverage.multi_covered(bin_reads)
    ordered = multi[::-1] if reverse else multi
    cov = 0
    taken = 0
    for base in ordered:
        base = int(base)
        beyond = base < peak_center if reverse else base > peak_center
        if beyond:
            if taken <= 3:
                taken += 1
                cov = max(cov, hist.coverage.histo_at(myround(base)))
            else:
                break
    return cov


def find_peaks(hist: LocusHistograms, side: str, chrom: str,
               peak_areas: set, cutoff: float, splice_site_width: int,
               minimum_read_count: int, junctions: Tuple[str, ...],
               rng: Optional[np.random.Generator] = None,
               splice_check_subsample: int = 500,
               motif_fraction: float = 0.85,
               flank_accuracy: float = 0.85) -> List[List[str]]:
    """De-novo splice-site peak caller (SDC.py:232-275). side 'l' uses the
    left (block-end) table with reverse coverage walk; 'r' the right table.
    Marks peak_areas in place; returns toWrite rows."""
    reverse = side == "l"
    table = hist.left if reverse else hist.right
    w = splice_site_width
    dist_range = [0]
    for shift in range(1, w + 1):
        dist_range.extend((shift, -shift))

    entry_list = [(p, len(table.items[p])) for p in table.order
                  if len(table.items[p]) >= minimum_read_count]
    entry_list.sort(key=lambda e: e[1], reverse=True)  # stable: ties keep
    to_write: List[List[str]] = []                     # first-appearance order

    for entry, _count in entry_list:
        if entry in peak_areas:
            continue
        best_count, peak_center, bin_reads = _scan_for_best_bin(
            entry, dist_range, table, peak_areas)
        cov = _determine_cov(hist, bin_reads, reverse, peak_center)
        if cov <= 0:
            continue
        proportion = round(best_count / cov, 3)
        if proportion <= cutoff:
            continue
        plus = sum(1 for r in bin_reads if hist.reads.dirns[r] == "+")
        minus = len(bin_reads) - plus
        if plus < minus:
            type_ = "3" if reverse else "5"
        elif plus > minus:
            type_ = "5" if reverse else "3"
        else:
            continue
        # motif + flank gate on a subsample of supporting reads
        if len(bin_reads) > splice_check_subsample:
            gen = rng if rng is not None else np.random.default_rng()
            pick = gen.choice(len(bin_reads), splice_check_subsample,
                              replace=False)
            sampled = [bin_reads[int(j)] for j in pick]
        else:
            sampled = bin_reads
        cs_indices = [hist.reads.cs_index(r) for r in sampled]
        if not characterize_splicing_event(
                peak_center - w, peak_center + w, cs_indices, junctions,
                motif_fraction, flank_accuracy):
            continue
        start, end = peak_center - w, peak_center + w
        to_write.append([chrom, str(start), str(end), type_, side,
                         str(proportion)])
        peak_areas.update(range(start, end + 1))
    return to_write
