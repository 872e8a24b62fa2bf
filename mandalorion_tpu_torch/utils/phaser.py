"""SNP phasing of long reads (TurboPhaser).

Re-design of `utils/TurboPhaser.py` — which ships with SyntaxErrors at
:190, :217, :225 (missing line continuations, SURVEY §2.1 C20); the broken
conditions are implemented here by intent: an allele is assigned to a
haplotype when its normalized connection support exceeds 3x the other
allele's.

Flow: het SNPs from a VCF -> per-read allele observations from PSLX block
sequences -> SNP co-occurrence graph -> transitive closure (3 rounds) ->
per-group haplotype seeds + scoring -> read assignment to allele1/allele2/
undetermined files.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

Snp = Tuple[str, int]
SnpAllele = Tuple[str, int, str]


def read_vcf(vcf_path: str) -> Dict[str, Dict[int, tuple]]:
    """chromosome -> position -> ((ref_base, gt1), (alt_base, gt2)) for
    heterozygous single-base SNPs (TurboPhaser.read_vcf)."""
    snps: Dict[str, Dict[int, tuple]] = {}
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            a = line.rstrip("\n").split("\t")
            chromosome, position = a[0], a[1]
            ref, alt = a[3], a[4]
            status = a[9].split(":")[0]
            alt_split = alt.split(",")
            if len(alt_split) > 1:
                ref = alt = alt_split[0]
            gt = status.replace("|", "/").split("/")
            if len(gt) < 2 or gt[0] == gt[1]:
                continue
            if len(ref) == 1 and len(alt) == 1 and ref != alt:
                snps.setdefault(chromosome, {})[int(position)] = (
                    (ref, gt[0]), (alt, gt[1]))
    return snps


def _transitive_close(comb: Dict[Snp, Set[Snp]]) -> Dict[Snp, Set[Snp]]:
    for snp1 in comb:
        add_set: Set[Snp] = set()
        for snp2 in list(comb[snp1]):
            comb.setdefault(snp2, set()).add(snp1)
            comb[snp2].update(comb[snp1])
            add_set.update(comb[snp2])
        comb[snp1].update(add_set)
    return comb


def parse_reads(snps, pslx_path: str):
    """Extract per-read SNP allele observations from PSLX lines (cols 21/22
    carry per-block read/genome sequences). Returns (groups, connections,
    snp_dict, reads, snp_count, read_minimum)."""
    con: Dict[Snp, Dict[Snp, int]] = {}
    snp_dict: Dict[str, List[SnpAllele]] = {}
    reads: Dict[str, str] = {}
    snp_count: Dict[SnpAllele, int] = {}
    total = 0
    with open(pslx_path) as fh:
        for line in fh:
            if not line.strip():
                continue
            a = line.rstrip("\n").split("\t")
            chromosome = a[13]
            if chromosome not in snps:
                continue
            total += 1
            name = a[9]
            reads[name] = line
            sizes = [int(x) for x in a[18].split(",")[:-1]]
            starts = [int(x) for x in a[20].split(",")[:-1]]
            read_blocks = a[21].split(",")[:-1]
            genome_blocks = a[22].split(",")[:-1]
            observed: List[SnpAllele] = []
            chrom_snps = snps[chromosome]
            for g_start, r_seq, g_seq in zip(starts, read_blocks,
                                             genome_blocks):
                for pos in range(len(g_seq)):
                    vcf_pos = g_start + pos + 1  # VCF is 1-based
                    if vcf_pos in chrom_snps:
                        ref, alt = chrom_snps[vcf_pos]
                        base = r_seq[pos]
                        if base in (ref[0], alt[0]):
                            key = (chromosome, vcf_pos, base)
                            observed.append(key)
                            snp_count[key] = snp_count.get(key, 0) + 1
            snp_dict[name] = observed
            sites = [(c, p) for c, p, _b in observed]
            for s1 in sites:
                per = con.setdefault(s1, {})
                for s2 in sites:
                    if s1 != s2:
                        per[s2] = per.get(s2, 0) + 1

    read_minimum = total / 1_000_000
    comb: Dict[Snp, Set[Snp]] = {}
    for s1, partners in con.items():
        comb.setdefault(s1, set())
        counts = list(partners.values())
        minimum = (np.average(counts) / 5) if counts else 0
        for s2, c in partners.items():
            if c > minimum:
                comb[s1].add(s2)
    for _ in range(3):
        comb = _transitive_close(comb)

    groups = {tuple(sorted(g)) for g in comb.values()}

    # co-occurrence counts keyed by full allele triples (reference keys
    # `connections` by (chrom, pos, base) on both sides)
    connections: Dict[SnpAllele, Dict[SnpAllele, int]] = {}
    for name, observed in snp_dict.items():
        for s1 in observed:
            per = connections.setdefault(s1, {})
            for s2 in observed:
                if s1 != s2:
                    per[s2] = per.get(s2, 0) + 1
    return groups, connections, snp_dict, reads, snp_count, read_minimum


def _filter_group(group, snps, snp_count):
    maximum = 0
    scored = []
    for site in group:
        chromosome, position = site
        options = snps[chromosome][position]
        for option in options:
            snp_count.setdefault((chromosome, position, option[0]), 0)
        c0 = snp_count[(chromosome, position, options[0][0])]
        c1 = snp_count[(chromosome, position, options[1][0])]
        score = abs(c0 + c1) - abs(c0 - c1)
        maximum = max(maximum, score)
        scored.append((site, score))
    if maximum == 0:
        return []
    kept = [(s, sc) for s, sc in scored if sc / maximum > 0.2]
    return sorted(kept, key=lambda x: x[1], reverse=True)


def _ratio(first, c0, second, c1):
    """first/c0 > 3 * second/c1 without div-by-zero."""
    if c0 == 0:
        return False
    lhs = first / c0
    rhs = (second / c1) * 3 if c1 else 0.0
    return lhs > rhs


def _grow_haplo(group_filtered, snps, haplo, connections, starting_index,
                snp_count, read_minimum):
    for i, (site, _score) in enumerate(group_filtered):
        if i == starting_index:
            continue
        chromosome, position = site
        options = snps[chromosome][position]
        first = second = 0
        # support for each allele of this site = co-occurrence counts with
        # the alleles already in the haplotype
        k0 = (chromosome, position, options[0][0])
        k1 = (chromosome, position, options[1][0])
        for hs in haplo:
            hper = connections.get(hs, {})
            first += hper.get(k0, 0)
            second += hper.get(k1, 0)
        c0 = snp_count.get(k0, 0)
        c1 = snp_count.get(k1, 0)
        if _ratio(first, c0, second, c1):
            if first > read_minimum:
                haplo.add(k0)
        elif _ratio(second, c1, first, c0):
            if second > read_minimum:
                haplo.add(k1)
    return haplo


def _assign_group(group_filtered, snps, haplo, connections, haplo_group,
                  snp_count, hap, read_minimum):
    for i, (site, _score) in enumerate(group_filtered):
        chromosome, position = site
        options = snps[chromosome][position]
        k0 = (chromosome, position, options[0][0])
        k1 = (chromosome, position, options[1][0])
        first = second = 0
        for hs in haplo:
            hper = connections.get(hs, {})
            first += hper.get(k0, 0)
            second += hper.get(k1, 0)
        c0 = snp_count.get(k0, 0)
        c1 = snp_count.get(k1, 0)
        if _ratio(first, c0, second, c1):
            if c0 > read_minimum and first > (c0 * len(haplo)) / 5:
                haplo_group[k0] = ("f", hap, first, second, i)
        elif _ratio(second, c1, first, c0):
            if c1 > read_minimum and second > (c1 * len(haplo)) / 5:
                haplo_group[k1] = ("s", hap, first, second, i)
    return haplo_group


def create_haplotypes(groups, connections, snps, snp_count, read_minimum,
                      bed_path: Optional[str] = None):
    haplo_group: Dict[SnpAllele, tuple] = {}
    for group in groups:
        group_filtered = _filter_group(group, snps, snp_count)
        if not group_filtered:
            continue
        starting_index = 0
        s_chrom, s_pos = group_filtered[starting_index][0]
        options = snps[s_chrom][s_pos]
        maternal = {(s_chrom, s_pos, options[0][0])}
        paternal = {(s_chrom, s_pos, options[1][0])}
        maternal = _grow_haplo(group_filtered, snps, maternal, connections,
                               starting_index, snp_count, read_minimum)
        paternal = _grow_haplo(group_filtered, snps, paternal, connections,
                               starting_index, snp_count, read_minimum)
        haplo_group = _assign_group(group_filtered, snps, maternal,
                                    connections, haplo_group, snp_count, 0,
                                    read_minimum)
        haplo_group = _assign_group(group_filtered, snps, paternal,
                                    connections, haplo_group, snp_count, 1,
                                    read_minimum)
    if bed_path:
        with open(bed_path, "w") as bed:
            for (chrom, pos, _base), value in sorted(haplo_group.items()):
                bed.write(f"{chrom}\t{pos}\t{pos}\t+\t{value[1]}\n")
    return haplo_group


def sort_reads(haplo_group, snp_dict, reads, sort_file: str,
               write_undetermined: bool = False) -> Dict[str, int]:
    """Write reads to .allele1/.allele2 (and optionally .undetermined)
    based on their phased SNP observations. Returns counts per bucket."""
    counts = {"0": 0, "1": 0, "U": 0}
    handles = {
        "0": open(sort_file + ".allele1", "w"),
        "1": open(sort_file + ".allele2", "w"),
        "U": open(sort_file + ".undetermined", "w"),
    }
    try:
        for name, variants in snp_dict.items():
            var_list = [haplo_group[v][1] for v in variants
                        if v in haplo_group]
            haplotype = (str(var_list[0])
                         if len(set(var_list)) == 1 and var_list else "U")
            counts[haplotype] += 1
            if haplotype in ("0", "1") or write_undetermined:
                handles[haplotype].write(reads[name])
    finally:
        for h in handles.values():
            h.close()
    return counts


def phase(vcf_path: str, phasing_pslx: str, sort_pslx_files: Sequence[str],
          out_path: str) -> Dict[SnpAllele, tuple]:
    """Full TurboPhaser flow (TurboPhaser.main)."""
    import os

    snps = read_vcf(vcf_path)
    groups, connections, snp_dict, reads, snp_count, read_minimum = \
        parse_reads(snps, phasing_pslx)
    haplo_group = create_haplotypes(
        groups, connections, snps, snp_count, read_minimum,
        bed_path=os.path.join(out_path, "snp.bed"))
    for sort_file in sort_pslx_files:
        _g, _c, snp_dict, reads, _sc, _rm = parse_reads(snps, sort_file)
        sort_reads(haplo_group, snp_dict, reads, sort_file)
    return haplo_group
