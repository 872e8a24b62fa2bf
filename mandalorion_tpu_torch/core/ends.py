"""TSS / polyA end calling and isoform splitting.

Equivalents of `find_ends` (SDC.py:554-711) and `define_start_end_sites`
(SDC.py:797-868), probed semantics: a 10 nt window with support >=
minimum_feature_count opens a peak bin [pos-upstream, pos+downstream) (ends:
[pos-downstream, pos+upstream)); the bin is then greedily extended in 10 nt
steps in both directions while the adjacent window count stays >=
minimum_feature_count and < the best 10 nt bin inside the original window.
Reads are binned by their (start-peak, end-peak) pair; the isoform key adds
direction + peaks + median unaligned end lengths.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from mandalorion_tpu_torch.core.splices import (
    ReadPlacement, group_mono_exon_transcripts)
from mandalorion_tpu_torch.core.peaks import LocusReads


def _open_bin(peaks: Dict[int, int], position: int, lo_shift: int,
              hi_shift: int) -> List[int]:
    """Assign peaks[position+shift] = position for shift in [lo, hi)."""
    original = []
    for shift in range(lo_shift, hi_shift):
        peaks[position + shift] = position
        original.append(position + shift)
    return original


def _window_sum(count: Counter, lo: int, hi: int) -> int:
    return sum(count[p] for p in range(lo, hi))


def _best_bin(count: Counter, original: List[int]) -> int:
    lo, hi = min(original), max(original)
    best = 0
    for i in range(lo, hi):
        best = max(best, _window_sum(count, i, i + 10))
    return best


def _extend(peaks: Dict[int, int], count: Counter, position: int,
            best_bin: int, minimum_feature_count: int, start_at: int,
            step: int) -> bool:
    """Greedy 10 nt-step extension from start_at in direction `step`
    (-1 = left, +1 = right). Stops when the adjacent window's count leaves
    [minimum_feature_count, best_bin) or hits an already-assigned base.
    Returns True when at least one full extension step succeeded."""
    extended = True
    ever = False
    adjacent = start_at
    while extended:
        adjacent_list = [adjacent + step * i for i in range(1, 11)]
        window_count = sum(count[p] for p in adjacent_list)
        if best_bin > window_count >= minimum_feature_count:
            for element in adjacent_list:
                if element not in peaks:
                    peaks[element] = position
                else:
                    extended = False
        else:
            extended = False
        adjacent = adjacent_list[-1]
        if extended:
            ever = True
    return ever


def find_ends(starts: List[int], ends: List[int], upstream_buffer: int,
              downstream_buffer: int, minimum_feature_count: int,
              stats: Optional[Dict[str, int]] = None
              ) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Call start/end peaks over raw read start/end positions.
    Returns (start_peaks, end_peaks): position -> peak representative."""
    u, d = upstream_buffer, downstream_buffer
    start_count = Counter(starts)
    end_count = Counter(ends)
    start_peaks: Dict[int, int] = {}
    end_peaks: Dict[int, int] = {}
    stats = stats if stats is not None else {}

    for position in sorted(starts):
        if position - u in start_peaks:
            continue
        window_count = _window_sum(start_count, position, position + 10)
        if window_count < minimum_feature_count:
            continue
        original = _open_bin(start_peaks, position, -u, d)
        best = _best_bin(start_count, original)
        if _extend(start_peaks, start_count, position, best,
                   minimum_feature_count, position - u, -1):
            stats["start_left"] = stats.get("start_left", 0) + 1
        if _extend(start_peaks, start_count, position, best,
                   minimum_feature_count, position + d - 1, +1):
            stats["start_right"] = stats.get("start_right", 0) + 1

    for position in sorted(ends, reverse=True):
        if position + u - 1 in end_peaks:
            continue
        window_count = _window_sum(end_count, position - 9, position + 1)
        if window_count < minimum_feature_count:
            continue
        original = _open_bin(end_peaks, position, -d, u)
        best = _best_bin(end_count, original)
        if _extend(end_peaks, end_count, position, best,
                   minimum_feature_count, position - d, -1):
            stats["end_left"] = stats.get("end_left", 0) + 1
        if _extend(end_peaks, end_count, position, best,
                   minimum_feature_count, position + u - 1, +1):
            stats["end_right"] = stats.get("end_right", 0) + 1

    return start_peaks, end_peaks


@dataclass
class IsoformGroup:
    """One isoform: its member read indices (into the LocusReads table)."""

    number: int
    read_indices: List[int] = field(default_factory=list)


def define_start_end_sites(
    spliced: Dict[str, List[ReadPlacement]],
    mono: Dict[str, List[ReadPlacement]],
    reads: LocusReads,
    upstream_buffer: int,
    downstream_buffer: int,
    minimum_feature_count: int,
    rng: Optional[np.random.Generator] = None,
    ends_subsample: int = 10_000,
    stats: Optional[Dict[str, int]] = None,
) -> Dict[str, IsoformGroup]:
    """Split each junction identity into isoforms by (start-peak, end-peak)
    pair (SDC.py:797-868). Peak calling runs on a subsample capped at
    ends_subsample (seeded rng — the reference's unseeded subsample only
    engages above the cap); binning uses ALL reads. Isoform names are
    stringified global counters in first-appearance order. `stats`, when
    given, gains under "end_splits" the identities split into two
    isoforms or more."""
    all_groups = group_mono_exon_transcripts(spliced, mono, reads)
    isoform_counter = 0
    iso_numbers: Dict[str, int] = {}
    iso_dict: Dict[str, IsoformGroup] = {}

    for identity in sorted(all_groups):
        placements = all_groups[identity]
        if len(placements) > ends_subsample:
            gen = rng if rng is not None else np.random.default_rng()
            pick = gen.choice(len(placements), ends_subsample, replace=False)
            sub = [placements[int(j)] for j in pick]
        else:
            sub = placements
        starts = [p.start for p in sub]
        ends = [p.end for p in sub]
        start_peaks, end_peaks = find_ends(
            starts, ends, upstream_buffer, downstream_buffer,
            minimum_feature_count)

        matched: List[Tuple[int, int, ReadPlacement]] = []
        left_extras: Dict[Tuple[int, int], List[int]] = {}
        right_extras: Dict[Tuple[int, int], List[int]] = {}
        for p in placements:
            if p.start in start_peaks and p.end in end_peaks:
                key = (start_peaks[p.start], end_peaks[p.end])
                left_extras.setdefault(key, []).append(p.left_extra)
                right_extras.setdefault(key, []).append(p.right_extra)
                matched.append((key[0], key[1], p))

        med_left = {k: float(np.median(v)) for k, v in left_extras.items()}
        med_right = {k: float(np.median(v)) for k, v in right_extras.items()}

        formed = 0
        for left, right, p in matched:
            new_identity = (f"{identity}_{p.direction}_{left}_{right}_"
                            f"{round(med_left[(left, right)], 2)}_"
                            f"{round(med_right[(left, right)], 2)}")
            if new_identity not in iso_numbers:
                isoform_counter += 1
                iso_numbers[new_identity] = isoform_counter
                formed += 1
            name = str(iso_numbers[new_identity])
            if name not in iso_dict:
                iso_dict[name] = IsoformGroup(iso_numbers[new_identity])
            iso_dict[name].read_indices.append(p.read_index)
        if stats is not None and formed > 1:
            stats["end_splits"] = stats.get("end_splits", 0) + 1
    return iso_dict
