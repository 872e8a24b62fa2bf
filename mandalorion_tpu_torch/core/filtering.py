"""Isoform filtering (module F core).

Equivalents of `filterIsoforms.py`'s per-chromosome chain: absolute filters
(`parse_clean_psl` :308-384), locus-coverage ratio filter (`get_count`/
`filter_isoforms` :82-123), and the containment + polyA filter
(`look_for_contained_isoforms` :126-280) re-expressed as interval algebra
instead of per-base dict/set loops. The per-base semantics (±splice-window
padding, 20 nt end trim, >=10-base polyA-range vote) are preserved exactly.
Filter reasons go to a callback, reproducing the reference's de-facto
debugging API (SURVEY §5.5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from mandalorion_tpu_torch.config import PipelineConfig

Reason = Callable[[str], None]


def _noop(_msg: str) -> None:
    pass


@dataclass
class ChromIsoforms:
    """Columnar per-chromosome isoform table from the cleaned 21-col PSL."""

    names: List[str] = field(default_factory=list)
    lines: Dict[str, List[str]] = field(default_factory=dict)   # psl fields
    coords: Dict[str, List[int]] = field(default_factory=dict)  # [s,e,s,e..]
    direction: Dict[str, str] = field(default_factory=dict)
    parsed: int = 0         # the chromosome's isoforms, kept or not


def parse_clean_psl(psl_path: str, chromosome: str, cfg: PipelineConfig,
                    reason: Reason = _noop) -> ChromIsoforms:
    """Absolute filters: length >= minimum_isoform_length, abundance >=
    minimum_reads (parsed from the `_<n>` name suffix), 5'/3' overhangs
    within cfg.overhangs, optional multi-exon-only."""
    t = ChromIsoforms()
    done: Set[str] = set()
    o5min, o5max, o3min, o3max = cfg.overhangs
    with open(psl_path) as fh:
        for line in fh:
            a = line.rstrip("\n").split("\t")
            if a[13] != chromosome:
                continue
            name = a[9]
            if name in done:
                continue
            done.add(name)
            readlength = int(a[12]) - int(a[11])
            direction = a[8]
            exon_number = len(a[18].split(",")) - 1
            if direction == "+":
                overhang5 = int(a[11])
                overhang3 = int(a[10]) - int(a[12])
            else:
                overhang3 = int(a[11])
                overhang5 = int(a[10]) - int(a[12])
            abundance = int(name.split("_")[-1])
            if readlength < cfg.minimum_isoform_length:
                reason(f"{name} filtered because at {readlength}nt it did not "
                       f"match the minimum isoform length requirement of "
                       f"{cfg.minimum_isoform_length}")
                continue
            if abundance < cfg.minimum_reads:
                reason(f"{name} filtered because it at {abundance} reads it "
                       f"did not match the minimum absolute read requirement "
                       f"of {cfg.minimum_reads}")
                continue
            if not (o5min <= overhang5 <= o5max and o3min <= overhang3 <= o3max):
                reason(f"{name} filtered because at {overhang5} and "
                       f"{overhang3} its number of overhanging bases did not "
                       f"fall within the predefined bins of {o5min}-{o5max} "
                       f"and {o3min}-{o3max}")
                continue
            if cfg.multi_exon_only and exon_number <= 1:
                reason(f"{name} filtered because it only had a single exon "
                       f"and the multi_exon_only flag was set")
                continue
            sizes = [int(x) for x in a[18].split(",")[:-1]]
            starts = [int(x) for x in a[20].split(",")[:-1]]
            coords: List[int] = []
            for s, z in zip(starts, sizes):
                coords.append(s)
                coords.append(s + z)
            t.names.append(name)
            t.lines[name] = a
            t.coords[name] = coords
            t.direction[name] = direction
    t.parsed = len(done)
    return t


def ratio_filter(t: ChromIsoforms, isoform_names: Sequence[str],
                 cfg: PipelineConfig, reason: Reason = _noop) -> List[str]:
    """Locus-coverage ratio filter (filterIsoforms.py:82-123): per-strand
    10 nt coverage built by summing isoform abundances over each isoform's
    span; an isoform survives when abundance / max-span-coverage >=
    minimum_ratio. Iterates isoforms in sorted-name order (reference)."""
    cov: Dict[str, Dict[int, int]] = {}
    for name in isoform_names:
        coords = t.coords[name]
        number = int(name.split("_")[-1])
        d = t.direction[name]
        per = cov.setdefault(d, {})
        for base in range(round(coords[0], -1), round(coords[-1], -1), 10):
            per[base] = per.get(base, 0) + number
    kept: List[str] = []
    for name in sorted(isoform_names):
        a = t.lines[name]
        d = t.direction[name]
        start, end = int(a[15]), int(a[16])
        number = int(name.split("_")[-1])
        max_cov = max(cov[d][base]
                      for base in range(round(start, -1), round(end, -1), 10))
        if number / max_cov >= cfg.minimum_ratio:
            kept.append(name)
        else:
            reason(f"{name} filtered because it at {number} reads it only "
                   f"reached a {number / max_cov} ratio of expression in its "
                   f"locus which is below the minimum ratio of "
                   f"{cfg.minimum_ratio}")
    return kept


def _merge_intervals(pairs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    pairs = sorted(pairs)
    merged: List[Tuple[int, int]] = []
    for s, e in pairs:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _covers(merged: List[Tuple[int, int]], s: int, e: int) -> bool:
    """True when [s, e) is fully inside one merged interval (or empty)."""
    if s >= e:
        return True
    import bisect
    i = bisect.bisect_right([m[0] for m in merged], s) - 1
    return i >= 0 and merged[i][1] >= e


def _overlap_len(merged: List[Tuple[int, int]], s: int, e: int) -> int:
    total = 0
    for ms, me in merged:
        total += max(0, min(me, e) - max(ms, s))
    return total


def containment_filter(t: ChromIsoforms, isoform_names: Sequence[str],
                       chr_sequence: str, polyA_whitelist: Dict[str, Set[int]],
                       cfg: PipelineConfig, reason: Reason = _noop,
                       drops: Optional[Dict[str, int]] = None) -> List[str]:
    """Containment + polyA filter (filterIsoforms.py:126-280).

    An isoform is dropped when (a) other isoforms extend >= 10 bases into
    the 20 nt window past its putative polyA site AND the genomic A content
    in the 15 nt beyond the site exceeds Acutoff (unless whitelisted), or
    (b) all its (end-trimmed, ±sw-padded) bases and all its junctions are
    contained in a higher-abundance isoform with abundance ratio below
    minimum_internal_ratio (or nearly identical ends with lower abundance).
    `drops`, when given, counts the isoforms dropped by each rule: "polya"
    (a), "internal" and "identical" (b).
    """
    drops = {} if drops is None else drops
    sw = cfg.splice_site_window
    ib = cfg.internal_buffer
    lo_off, hi_off = cfg.polya_scan_offsets

    # padded exon interval sets per strand, from UNtrimmed coords (±sw)
    merged_of: Dict[str, List[Tuple[int, int]]] = {}
    for name in isoform_names:
        coords = t.coords[name]
        pairs = [(coords[i] - sw, coords[i + 1] + sw)
                 for i in range(0, len(coords), 2)]
        merged_of[name] = _merge_intervals(pairs)

    by_dir: Dict[str, List[str]] = {"+": [], "-": []}
    for name in isoform_names:
        by_dir[t.direction[name]].append(name)

    kept: List[str] = []
    for name in isoform_names:
        coords = list(t.coords[name])
        direction = t.direction[name]
        start, end = coords[0], coords[-1]
        trimmed = list(coords)
        trimmed[0] = min(coords[0] + ib, coords[1])
        trimmed[-1] = max(coords[-1] - ib, coords[-2])

        if direction == "+":
            window = chr_sequence[end:end + cfg.acontent_window].upper()
            a_content = window.count("A") / cfg.acontent_window
            polya_lo, polya_hi = end + lo_off, end + hi_off
            polya_pos = end
        else:
            window = chr_sequence[max(start - cfg.acontent_window, 0):start]
            a_content = window.upper().count("T") / cfg.acontent_window
            polya_lo, polya_hi = start - hi_off, start - lo_off
            polya_pos = start

        # status: isoforms (same strand) whose padded exons cover every
        # trimmed exon range of this isoform
        ranges = [(trimmed[i], trimmed[i + 1])
                  for i in range(0, len(trimmed), 2)]
        status = [other for other in by_dir[direction]
                  if all(_covers(merged_of[other], s, e) for s, e in ranges)]

        # extend: isoforms covering >= extend_vote bases of the polyA window
        extend = [other for other in by_dir[direction]
                  if _overlap_len(merged_of[other], polya_lo, polya_hi)
                  >= cfg.extend_vote]

        if len(status) + len(extend) == 1:
            kept.append(name)
            continue

        decision = True
        if extend and a_content > cfg.acutoff:
            if polya_pos in polyA_whitelist.get(direction, set()):
                reason(f"{name} would have been filtered because at least one "
                       f"isoform (including {extend[0]}) is extending beyond "
                       f"its polyA site and the genomic A content at its "
                       f"putative polyA site is {a_content} which is higher "
                       f"than the cutoff set to {cfg.acutoff} but it was kept "
                       f"because its polyA site was part of the polyA site "
                       f"whitelist")
            else:
                decision = False
                drops["polya"] = drops.get("polya", 0) + 1
                reason(f"{name} filtered because at least one isoform "
                       f"(including {extend[0]}) is extending beyond its "
                       f"polyA site and the genomic A content at its putative "
                       f"polyA site is {a_content} which is higher than the "
                       f"cutoff set to {cfg.acutoff}")

        if decision:
            abundance = int(name.split("_")[-1])
            junctions = [(coords[i], coords[i + 1])
                         for i in range(1, len(coords) - 1, 2)]
            for match in sorted(status):
                if match == name:
                    continue
                m_coords = t.coords[match]
                m_junctions = [(m_coords[i], m_coords[i + 1])
                               for i in range(1, len(m_coords) - 1, 2)]
                # junction matched when its ±sw windows intersect a match
                # junction's ±sw windows on both sides — with the reference's
                # overwrite rule: a base1 shared between two match junctions
                # keeps only the LATER junction's base2 set
                dup: Dict[int, Set[int]] = {}
                for j1, j2 in m_junctions:
                    b2 = set(range(j2 - sw, j2 + sw))
                    for b1 in range(j1 - sw, j1 + sw):
                        dup[b1] = b2
                all_matched = True
                for j1, j2 in junctions:
                    hit = False
                    for b1 in range(j1 - sw, j1 + sw):
                        if b1 in dup and any(
                                b2 in dup[b1]
                                for b2 in range(j2 - sw, j2 + sw)):
                            hit = True
                            break
                    if not hit:
                        all_matched = False
                        break
                if not all_matched:
                    continue
                match_abundance = int(match.split("_")[-1])
                if abundance / match_abundance < cfg.minimum_internal_ratio:
                    reason(f"{name} filtered because it is internal to (all "
                           f"bases and splice junctions contained in) {match} "
                           f"and expressed at {abundance} reads compared to "
                           f"{match_abundance} reads for the isoform "
                           f"containing it which is below that internal ratio "
                           f"of {cfg.minimum_internal_ratio}")
                    drops["internal"] = drops.get("internal", 0) + 1
                    decision = False
                    break
                if (abs(coords[0] - m_coords[0]) < cfg.downstream_buffer
                        and abs(coords[-1] - m_coords[-1])
                        < cfg.downstream_buffer
                        and abundance < match_abundance):
                    reason(f"{name} filtered because it is internal (all "
                           f"bases and splice junctions contained in) and "
                           f"almost identical to {match}")
                    drops["identical"] = drops.get("identical", 0) + 1
                    decision = False
                    break
        if decision:
            kept.append(name)
    return kept


def read_polya_whitelist(bed_path: str, chromosome: str
                         ) -> Dict[str, Set[int]]:
    """polyAWhiteList.bed → per-strand position sets for one chromosome
    (filterIsoforms.readWhiteList, :404-415)."""
    wl: Dict[str, Set[int]] = {"+": set(), "-": set()}
    import os
    if not os.path.exists(bed_path):
        return wl
    with open(bed_path) as fh:
        for line in fh:
            a = line.rstrip("\n").split("\t")
            if a and a[0] == chromosome:
                wl[a[5]].update(range(int(a[1]), int(a[2])))
    return wl


def process_chromosome(chromosome: str, clean_psl_path: str,
                       chr_sequence: str, polya_bed: str,
                       cfg: PipelineConfig, reason: Reason = _noop,
                       stats: Optional[dict] = None
                       ) -> Tuple[List[str], ChromIsoforms]:
    """Full per-chromosome filter chain (filterIsoforms.process_chr).
    `stats`, when given, gains the seconds of the ratio rule and of the
    containment and polyA rule ("ratio_s", "contain_s"), the isoforms each
    kept ("ratio_kept", "contain_kept") and the drops of each rule
    ("drops": "absolute", "ratio", "polya", "internal", "identical")."""
    wl = read_polya_whitelist(polya_bed, chromosome)
    t = parse_clean_psl(clean_psl_path, chromosome, cfg, reason)
    drops = {"absolute": t.parsed - len(t.names), "polya": 0,
             "internal": 0, "identical": 0}
    t0 = perf_counter()
    kept = ratio_filter(t, t.names, cfg, reason)
    t1 = perf_counter()
    drops["ratio"] = len(t.names) - len(kept)
    ratio_kept = len(kept)
    kept = containment_filter(t, kept, chr_sequence, wl, cfg, reason, drops)
    if stats is not None:
        stats.update(ratio_s=t1 - t0, contain_s=perf_counter() - t1,
                     ratio_kept=ratio_kept, contain_kept=len(kept),
                     drops=drops)
    return kept, t
