"""Splice-peak labeling and read→junction-identity grouping.

Equivalents of the spliceDict build (`defineIsoforms.py:71-84`) and
`sort_reads_into_splice_junctions` (SDC.py:714-769). Reference quirks kept:
read direction is deliberately forced to '+' (SDC.py:721); a read whose
chromosome name contains '_' makes `identity.split('_')[1]` non-empty, so
mono-exon reads on such chromosomes are routed to the spliced dict
(SURVEY §5.9); junctions are target gaps > 50 nt.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from mandalorion_tpu_torch.core.peaks import LocusReads


def build_splice_dict(to_write_lists: Sequence[Sequence[Sequence[str]]]
                      ) -> Dict[int, str]:
    """Label peak bins: per-side counters over the toWrite lists in order
    [annotated-left, annotated-right, denovo-left, denovo-right]; every base
    in [start, end] maps to `type + side + counter`; later lists overwrite
    earlier ones at shared bases (defineIsoforms.py:71-84)."""
    counters = {"l": 0, "r": 0}
    splice: Dict[int, str] = {}
    for rows in to_write_lists:
        for _chrom, start, end, type1, side, _prop in rows:
            counters[side] += 1
            label = f"{type1}{side}{counters[side]}"
            for base in range(int(start), int(end) + 1):
                splice[base] = label
    return splice


@dataclass
class ReadPlacement:
    """One read's start/end + extras, grouped under a junction identity."""

    start: int
    end: int
    read_index: int
    left_extra: int
    right_extra: int
    direction: str  # always '+' (reference forces it)


def sort_reads_into_splice_junctions(
    splice: Dict[int, str], reads: LocusReads, chrom: str,
    junction_gap: int = 50,
) -> Tuple[Dict[str, List[ReadPlacement]], Dict[str, List[ReadPlacement]]]:
    """Map each read's junctions (target gaps > junction_gap) to peak labels;
    identity = chrom + '_' + 'L-R~' per junction. Reads with any unmatched
    junction are dropped. Returns (spliced, mono) placement dicts."""
    spliced: Dict[str, List[ReadPlacement]] = {}
    mono: Dict[str, List[ReadPlacement]] = {}
    for i in range(len(reads)):
        start, end = int(reads.begins[i]), int(reads.spans[i])
        direction = "+"  # reference ignores read direction here
        left_extra = int(reads.q_starts[i])
        right_extra = int(reads.q_sizes[i] - reads.q_ends[i])
        starts = reads.block_starts[i]
        sizes = reads.block_sizes[i]
        identity = chrom + "_"
        failed = False
        for x in range(len(sizes) - 1):
            left_splice = int(starts[x] + sizes[x])
            right_splice = int(starts[x + 1])
            if right_splice - left_splice > junction_gap:
                l_label = splice.get(left_splice)
                r_label = splice.get(right_splice)
                if not l_label or not r_label:
                    failed = True
                    break
                identity += f"{l_label}-{r_label}~"
        if failed:
            continue
        placement = ReadPlacement(start, end, i, left_extra, right_extra,
                                  direction)
        if identity.split("_")[1] != "":
            spliced.setdefault(identity, []).append(placement)
        else:
            mono.setdefault(identity, []).append(placement)
    return spliced, mono


def group_mono_exon_transcripts(
    spliced: Dict[str, List[ReadPlacement]],
    mono: Dict[str, List[ReadPlacement]],
    reads: LocusReads,
) -> Dict[str, List[ReadPlacement]]:
    """Chain mono-exon reads into overlap groups appended to the spliced
    dict as identity+'M<n>' (SDC.py:772-794, probed). The quirky
    previous_end update (max() only when opening a group) is kept.
    Sort order matches the reference's tuple sort: (start, end, read name)."""
    for identity, placements in mono.items():
        previous_end = 0
        iso_counter = 0
        new_identity = identity + "M" + str(iso_counter)
        for p in sorted(placements, key=lambda p: (p.start, p.end,
                                                   reads.names[p.read_index])):
            if p.start > previous_end:
                iso_counter += 1
                new_identity = identity + "M" + str(iso_counter)
                spliced.setdefault(new_identity, []).append(p)
                previous_end = max(p.end, previous_end)
            else:
                spliced.setdefault(new_identity, []).append(p)
                previous_end = p.end
    return spliced
