"""Vectorized coverage-bucket algebra for collect_reads.

The reference's per-base loop (SDC.py:300-310) contributes, per block, every
10th offset plus the tail run, each rounded to the nearest 10 (banker's).
Because the tail covers every integer offset to blocksize-1 and rounding is
monotone with round10(x+10) = round10(x)+10, the resulting set is exactly
the CONTIGUOUS multiples of 10 from round10(start) to round10(start+size-1)
— so per-read coverage reduces to merged bucket intervals, and the locus
histogram to one difference-array sweep (the segment-op form SURVEY §3.5
calls for). tests/test_core_parity.py proves equality with the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


def round10(x: np.ndarray) -> np.ndarray:
    """Vectorized banker's rounding to the nearest 10 (== myround)."""
    return (np.round(np.asarray(x, np.float64) / 10.0) * 10).astype(np.int64)


@dataclass
class CoverageIntervals:
    """Per-read merged coverage-bucket intervals plus the locus histogram.

    merged_lo/merged_hi — inclusive bucket bounds (multiples of 10),
    grouped by read in ascending order; read_slices[i] = (a, b) slice into
    them for read i. base/counts — dense histogram: counts[k] = number of
    reads covering bucket base + 10k.
    """

    merged_lo: np.ndarray
    merged_hi: np.ndarray
    read_slices: List[Tuple[int, int]]
    base: int
    counts: np.ndarray

    def cov_dict(self) -> Dict[int, int]:
        """Sparse position -> count dict (reference histo_cov shape)."""
        nz = np.nonzero(self.counts)[0]
        return {int(self.base + 10 * k): int(self.counts[k]) for k in nz}

    def read_positions(self, i: int) -> np.ndarray:
        """Materialized bucket positions for read i (parity/testing)."""
        a, b = self.read_slices[i]
        if a == b:
            return np.zeros(0, np.int64)
        parts = [np.arange(self.merged_lo[j], self.merged_hi[j] + 1, 10)
                 for j in range(a, b)]
        return np.concatenate(parts)

    def histo_at(self, position: int) -> int:
        k = (position - self.base) // 10
        if 0 <= k < len(self.counts):
            return int(self.counts[k])
        return 0

    def multi_covered(self, read_indices: List[int]) -> np.ndarray:
        """Bucket positions covered by >1 (occurrence-counted) reads of the
        given multiset — the determine_cov 'count > 1' set, sorted."""
        if not read_indices:
            return np.zeros(0, np.int64)
        los, his = [], []
        for r in read_indices:
            a, b = self.read_slices[r]
            los.append(self.merged_lo[a:b])
            his.append(self.merged_hi[a:b])
        lo = np.concatenate(los) // 10
        hi = np.concatenate(his) // 10
        if len(lo) == 0:
            return np.zeros(0, np.int64)
        b0 = int(lo.min())
        width = int(hi.max()) - b0 + 2
        diff = np.zeros(width, np.int64)
        np.add.at(diff, lo - b0, 1)
        np.add.at(diff, hi - b0 + 1, -1)
        counts = np.cumsum(diff)[:-1]
        return (np.nonzero(counts > 1)[0] + b0) * 10


def build_coverage(block_starts: List[np.ndarray],
                   block_sizes: List[np.ndarray]) -> CoverageIntervals:
    """Flatten all reads' blocks into merged bucket intervals + histogram."""
    n_reads = len(block_starts)
    counts_per_read = np.array([len(b) for b in block_starts], np.int64)
    if counts_per_read.sum() == 0:
        return CoverageIntervals(
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            [(0, 0)] * n_reads, 0, np.zeros(0, np.int64))
    read_ids = np.repeat(np.arange(n_reads), counts_per_read)
    starts = np.concatenate([b for b in block_starts if len(b)])
    sizes = np.concatenate([b for b in block_sizes if len(b)])
    # zero-size blocks contribute no coverage (reference's empty range
    # loop, SDC.py:300-310)
    nonzero = sizes > 0
    if not nonzero.all():
        read_ids = read_ids[nonzero]
        starts = starts[nonzero]
        sizes = sizes[nonzero]
    if len(starts) == 0:
        return CoverageIntervals(
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            [(0, 0)] * n_reads, 0, np.zeros(0, np.int64))
    lo = round10(starts)
    hi = round10(starts + sizes - 1)

    # merge intervals within a read (blocks ascend; adjacent or overlapping
    # bucket ranges collapse — identical membership either way)
    new = np.ones(len(lo), bool)
    new[1:] = (read_ids[1:] != read_ids[:-1]) | (lo[1:] > hi[:-1] + 10)
    merged_lo = lo[new]
    merged_hi = np.maximum.reduceat(hi, np.nonzero(new)[0])
    merged_read = read_ids[new]

    # per-read slices
    grp_start = np.searchsorted(merged_read, np.arange(n_reads), "left")
    grp_end = np.searchsorted(merged_read, np.arange(n_reads), "right")
    read_slices = list(zip(grp_start.tolist(), grp_end.tolist()))

    # dense histogram over the locus bucket span
    b0 = int(merged_lo.min()) // 10
    width = int(merged_hi.max()) // 10 - b0 + 2
    diff = np.zeros(width, np.int64)
    np.add.at(diff, merged_lo // 10 - b0, 1)
    np.add.at(diff, merged_hi // 10 - b0 + 1, -1)
    counts = np.cumsum(diff)[:-1]
    return CoverageIntervals(merged_lo, merged_hi, read_slices,
                             b0 * 10, counts)
