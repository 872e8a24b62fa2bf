"""Generator `isoform_events`: the genes of `planted_isoforms` with the
isoform events of human genes (Wang et al. 2008, Nature 456:470): beside
a skipped exon, an alternative first exon, an alternative last exon, a
retained intron and a tandem 3' UTR; reads that are whole transcripts
with substitutions, and the judge of a job's answer against what was
planted, which tells isoforms apart by their ends as well as by their
intron chains.

A configuration file that names this generator holds:

- `layout`: `planted_isoforms`' layout keys (`chrom`, `genome_bp`,
  `n_genes`, `gene_offset`, `exons_per_gene`, `exon_len`, `intron_len`,
  `layout_seed`), drawn in config-3's order, so that each gene's main
  chain is config-3's gene; and `isoform_seed`, from which each gene's
  events are drawn;
- `events`: `further` (the isoforms a gene has beside its main one, each
  of one event, of distinct kinds, drawn from the kinds the gene
  allows), `tandem_ext` (the distal site's distance past the proximal
  one, [lo, hi)), `alt_last_margin` (an alternative last exon's least
  distance from either end of the intron it lies in), `retained_max`
  (the longest intron a gene retains), `edge_margin` (the least
  distance of a new exon from the edges of its gene's slot),
  `polya_window` and `polya_a_max` (the genomic bases after each polyA
  site, on the sense strand, hold at most this many A);
- `reads`: `sub_rate`, the rate a base of substitutions by another base;
- `judge`: `required_reads` (the reads of a transcript from which on it
  has to have an isoform, and its consensus is held to their column
  majority) and `downstream_buffer` (how far an isoform's first and last
  bases may lie from its transcript's);
- `limits`: each compared number's limit.

Each gene's main isoform is its full chain, ending at the proximal polyA
site; the further isoforms follow it in the order drawn, each differing
from the main by one event:

- `skip`: one internal exon skipped (genes of 3 exons or more);
- `alt_first`: a new exon of `exon_len`, 5' of the first exon in
  transcript orientation, inside the gene's slot, spliced to the second
  exon in place of the first;
- `alt_last`: a new exon inside the last intron (transcript
  orientation), `alt_last_margin` from both of its ends, in place of the
  last exon (where the intron has room);
- `retained`: the gene's shortest intron kept (where it is at most
  `retained_max`);
- `tandem`: the main chain with its last exon extended 3' by
  `tandem_ext` to a distal polyA site.

GT..AG is planted at every junction of every isoform, and no junction can
slide to another place that reads the same transcript (the judge holds a
junction to its planted place). A traffic mix is
`planted_isoforms`': a gene's reads are shared among its isoforms as 1,
1/2, 1/3, ..., the main first, so the proximal site's isoform is always
more abundant than the tandem one it is nested in.

What depends on what: the layout and the events on the configuration's
seeds; which genes and how many reads each on the mix's `profile_seed`;
the genome's bases (and so the bases changed to hold the polyA windows'
rule), the reads' substitutions and their order in the file on the run
seed. So every run seed has the same genes, reads and read lengths.

Only numpy, the standard library and the harness's own modules.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import bm_data
import bm_reference
from bm_data import ACGT, CODE
from bm_reference import Alignment, Answer, Isoform

NUMBERS = ("aln_bad", "introns_off_per_10k", "consensus_bad",
           "misassigned_per_10k", "counts_off_per_10k", "missed_per_10k")
KINDS = ("skip", "alt_first", "alt_last", "retained", "tandem")

Exons = List[Tuple[int, int]]


# ------------------------------------------------ the layout

@dataclasses.dataclass
class Gene:
    exons: Exons                   # the main chain, half-open, on the genome
    strand: str
    isoforms: List[Exons]          # each isoform's exons on the genome
    kinds: List[str]               # "main", then each further one's event
    slot: Tuple[int, int]          # the genome's share of this gene


@dataclasses.dataclass
class Layout:
    chrom: str
    genome: np.ndarray
    genes: List[Gene]
    gtf: str

    def exons(self, g: int, i: int) -> Exons:
        return self.genes[g].isoforms[i]

    def transcript(self, g: int, i: int) -> np.ndarray:
        return bm_data.transcript(self.genome, self.exons(g, i),
                                  self.genes[g].strand)


def _main_chains(lay: dict):
    """[(exons, strand, slot)] of config-3's genes at the layout's sizes,
    drawn in its order."""
    rng = np.random.default_rng(lay["layout_seed"])
    n_genes = int(lay["n_genes"])
    span = int(lay["genome_bp"]) // n_genes
    out = []
    for g in range(n_genes):
        pos = g * span + int(lay["gene_offset"])
        exons = []
        for _ in range(int(rng.integers(*lay["exons_per_gene"]))):
            ln = int(rng.integers(*lay["exon_len"]))
            exons.append((pos, pos + ln))
            pos += ln + int(rng.integers(*lay["intron_len"]))
        if exons[-1][1] > (g + 1) * span:
            raise ValueError(f"gene {g} runs into the next gene's span")
        out.append((exons, "+" if g % 2 == 0 else "-",
                    (g * span, (g + 1) * span)))
    return out


def _in_transcript_order(exons: Exons, strand: str) -> Exons:
    return list(exons) if strand == "+" else list(reversed(exons))


def _allowed(exons: Exons, strand: str, slot, lay: dict, ev: dict):
    """The kinds of event this gene allows, in KINDS' order."""
    tx = _in_transcript_order(exons, strand)
    kinds = []
    if len(exons) >= 3:
        kinds.append("skip")
    lo = lay["exon_len"][0]
    if _first_room(tx, strand, slot, ev) >= lo + lay["intron_len"][0]:
        kinds.append("alt_first")
    if len(exons) >= 2:
        s, e = _last_intron(tx)
        if e - s >= 2 * ev["alt_last_margin"] + lo:
            kinds.append("alt_last")
    if len(exons) >= 2 and min(b[0] - a[1] for a, b in zip(exons, exons[1:])) \
            <= ev["retained_max"]:
        kinds.append("retained")
    if _tail_room(tx, strand, slot, ev) >= ev["tandem_ext"][1]:
        kinds.append("tandem")
    return kinds


def _first_room(tx: Exons, strand: str, slot, ev: dict) -> int:
    """Bases between the slot's 5' edge (less the margin) and the first
    exon."""
    if strand == "+":
        return tx[0][0] - (slot[0] + ev["edge_margin"])
    return (slot[1] - ev["edge_margin"]) - tx[0][1]


def _tail_room(tx: Exons, strand: str, slot, ev: dict) -> int:
    """Bases between the last exon's 3' end and the slot's 3' edge (less
    the margin and the polyA window)."""
    margin = ev["edge_margin"] + ev["polya_window"]
    if strand == "+":
        return (slot[1] - margin) - tx[-1][1]
    return tx[-1][0] - (slot[0] + margin)


def _last_intron(tx: Exons) -> Tuple[int, int]:
    """The genomic (start, end) of the intron before the last exon in
    transcript order."""
    a, b = sorted((tx[-2], tx[-1]))
    return a[1], b[0]


def _event(kind: str, exons: Exons, strand: str, slot, lay: dict,
           ev: dict, rng) -> Exons:
    """The exons on the genome of the main chain changed by one event,
    its parameters drawn from rng."""
    tx = _in_transcript_order(exons, strand)
    lo, hi = lay["exon_len"]
    if kind == "skip":
        drop = int(rng.integers(1, len(tx) - 1))
        return sorted(tx[:drop] + tx[drop + 1:])
    if kind == "alt_first":
        room = _first_room(tx, strand, slot, ev)
        ln = int(rng.integers(lo, min(hi, room - lay["intron_len"][0] + 1)))
        gap = int(rng.integers(lay["intron_len"][0],
                               min(lay["intron_len"][1], room - ln + 1)))
        if strand == "+":
            new = (tx[0][0] - gap - ln, tx[0][0] - gap)
        else:
            new = (tx[0][1] + gap, tx[0][1] + gap + ln)
        return sorted([new] + tx[1:])
    if kind == "alt_last":
        s, e = _last_intron(tx)
        m = ev["alt_last_margin"]
        ln = int(rng.integers(lo, min(hi, e - s - 2 * m + 1)))
        at = int(rng.integers(s + m, e - m - ln + 1))
        return sorted(tx[:-1] + [(at, at + ln)])
    if kind == "retained":
        gaps = [b[0] - a[1] for a, b in zip(exons, exons[1:])]
        j = int(np.argmin(gaps))
        return exons[:j] + [(exons[j][0], exons[j + 1][1])] + exons[j + 2:]
    if kind == "tandem":
        ext = int(rng.integers(*ev["tandem_ext"]))
        last = tx[-1]
        last = (last[0], last[1] + ext) if strand == "+" \
            else (last[0] - ext, last[1])
        return sorted(tx[:-1] + [last])
    raise ValueError(f"no event kind {kind!r}")


def polya_site(exons: Exons, strand: str) -> int:
    """The genomic position of a transcript's 3' end: its last base + 1
    on '+', its first base on '-'."""
    return exons[-1][1] if strand == "+" else exons[0][0]


def polya_window(site: int, strand: str, width: int) -> Tuple[int, int]:
    """The genomic bases after a polyA site on the sense strand, as
    module F's internal-priming rule reads them."""
    return (site, site + width) if strand == "+" else (site - width, site)


def _hold_polya_rule(genome: np.ndarray, site: int, strand: str,
                     width: int, a_max: int) -> None:
    """Change the last A's (sense strand) of the window after `site`
    beyond `a_max` to other bases, chosen by position."""
    s, e = polya_window(site, strand, width)
    a = ord("A") if strand == "+" else ord("T")
    others = b"CGT" if strand == "+" else b"ACG"
    where = np.flatnonzero(genome[s:e] == a)
    order = where if strand == "-" else where[::-1]
    for k in order[:max(0, len(where) - a_max)]:
        genome[s + k] = others[(s + k) % 3]


def _pin_junctions(genome: np.ndarray, exons: Exons) -> None:
    """Make each junction's place the only one that reads its transcript:
    an intron k bases left (right) of it gives the same bases only where
    the k exon bases before it (after it) equal the intron's last (first)
    k, so the exon base next to each end of the intron is changed, by
    position, where it equals the intron's base at the other end."""
    for (_s1, e1), (s2, _e2) in zip(exons, exons[1:]):
        for exon_base, intron_base in ((e1 - 1, s2 - 1), (s2, e1)):
            if genome[exon_base] == genome[intron_base]:
                others = ACGT[ACGT != genome[intron_base]]
                genome[exon_base] = others[exon_base % 3]


def make_layout(config: dict, genome_seed) -> Layout:
    """config-3's genes at the configuration's sizes, each with its main
    isoform and its further isoforms of one event each, and the genome's
    bases from `genome_seed`, with splice sites planted, junctions pinned
    and the polyA windows' rule held."""
    lay, ev = config["layout"], config["events"]
    iso_rng = np.random.default_rng(lay["isoform_seed"])
    genome = bm_data.genome_bytes(int(lay["genome_bp"]), genome_seed)
    genes, gtf = [], []
    for g, (exons, strand, slot) in enumerate(_main_chains(lay)):
        bm_data.plant(genome, exons, strand)
        allowed = _allowed(exons, strand, slot, lay, ev)
        kinds = [allowed[int(k)] for k in iso_rng.choice(
            len(allowed), min(int(ev["further"]), len(allowed)),
            replace=False)]
        isoforms = [list(exons)] + [
            _event(kind, exons, strand, slot, lay, ev, iso_rng)
            for kind in kinds]
        for iso in isoforms[1:]:
            bm_data.plant(genome, iso, strand)
        genes.append(Gene(list(exons), strand, isoforms, ["main"] + kinds,
                          slot))
    # after every plant: exon bases next to the introns, and the windows,
    # lie off every splice site
    for gene in genes:
        for iso in gene.isoforms:
            _pin_junctions(genome, iso)
            _hold_polya_rule(genome, polya_site(iso, gene.strand),
                             gene.strand, int(ev["polya_window"]),
                             int(ev["polya_a_max"]))
    for g, gene in enumerate(genes):
        for i, iso in enumerate(gene.isoforms):
            tid = f"T{g}" if i == 0 else f"T{g}.{i}"
            gtf.append(bm_data.gtf_lines(lay["chrom"], f"G{g}", tid, iso,
                                         gene.strand))
    return Layout(lay["chrom"], genome, genes, "".join(gtf))


def write_layout(lay: Layout, out_dir: str) -> Tuple[str, str]:
    """genome.fasta and ann.gtf in out_dir; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    genome = os.path.join(out_dir, "genome.fasta")
    ann = os.path.join(out_dir, "ann.gtf")
    with open(genome, "wb") as fh:
        bm_data.write_genome(fh, lay.chrom, lay.genome)
    with open(ann, "w") as fh:
        fh.write(lay.gtf)
    return genome, ann


# ------------------------------------------------ the samples

def expression(mix: dict, lay: Layout) -> List[Tuple[int, int, int]]:
    """[(gene, isoform, reads)] of the mix: its genes (drawn by its
    profile_seed), their Zipf depths in the drawn order, each shared
    among the gene's isoforms as 1/(i+1)."""
    e = mix["expression"]
    rng = np.random.default_rng(e["profile_seed"])
    chosen = rng.choice(len(lay.genes), int(e["genes"]), replace=False)
    out = []
    for r, g in enumerate(chosen):
        depth = float(e["zipf_top"]) / (float(e["first_rank"]) + r)
        shares = 1.0 / np.arange(1, len(lay.genes[g].isoforms) + 1)
        for i, share in enumerate(shares / shares.sum()):
            n = int(round(depth * share))
            if n:
                out.append((int(g), i, n))
    return sorted(out)


@dataclasses.dataclass
class Sample:
    """A sample's FASTA and each transcript's reads: reads[(g, i)][k] is
    read k of isoform i of gene g (transcript orientation)."""
    path: str
    n_reads: int
    reads: Dict[Tuple[int, int], np.ndarray]


def read_name(g: int, i: int, k: int) -> str:
    return f"g{g}i{i}r{k}"


def make_sample(lay: Layout, config: dict, profile, seed,
                path: str) -> Sample:
    """Reads of every (gene, isoform, depth) of the profile, each base
    replaced by one of the other three at the configuration's sub_rate,
    written as FASTA to `path` in an order drawn from `seed`."""
    rate = float(config["reads"]["sub_rate"])
    rng = np.random.default_rng(seed)
    reads: Dict[Tuple[int, int], np.ndarray] = {}
    names, seqs = [], []
    for g, i, depth in profile:
        t = lay.transcript(g, i)
        block = np.broadcast_to(t, (depth, len(t))).copy()
        mask = rng.random(block.shape) < rate
        block[mask] = ACGT[(CODE[block[mask]]
                            + rng.integers(1, 4, int(mask.sum()))) % 4]
        reads[(g, i)] = block
        names += [read_name(g, i, r) for r in range(depth)]
        seqs += list(block)
    order = rng.permutation(len(names))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        for j in order:
            fh.write(b">%s\n%s\n" % (names[j].encode(), seqs[j].tobytes()))
    return Sample(path, len(names), reads)


# ------------------------------------------------ the judge

def _blocks(exons) -> tuple:
    return tuple((s, e - s) for s, e in exons)


def majority(block: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The column majority of a (depth, length) block of reads, and a
    (4, length) mask of the bases that tie for the most votes."""
    votes = np.stack([np.count_nonzero(block == b, axis=0) for b in ACGT])
    top = votes.max(axis=0)
    return ACGT[votes.argmax(axis=0)], votes == top


def _columns_off(seq: bytes, block: np.ndarray) -> Tuple[np.ndarray, int]:
    """The columns where seq's base is not a most-voted base, and seq's
    length less the reads'."""
    want, tied = majority(block)
    got = np.frombuffer(seq, np.uint8)
    n = min(len(got), len(want))
    col = CODE[got[:n]]
    ok = np.isin(got[:n], ACGT) & tied[col, np.arange(n)]
    return np.flatnonzero(~ok), len(got) - len(want)


def consensus_off(seq: bytes, block: np.ndarray) -> int:
    """Bases of seq that are not a most-voted base of their column, plus
    the difference in length."""
    off, extra = _columns_off(seq, block)
    return len(off) + abs(extra)


def _match(candidates, lay: Layout, exons, buffer: int
           ) -> Optional[Tuple[int, int]]:
    """The first (gene, isoform) of `candidates` whose first and last
    bases lie within `buffer` of the exons'."""
    first, last = exons[0][0], exons[-1][1]
    for g, i in candidates:
        t = lay.exons(g, i)
        if abs(t[0][0] - first) <= buffer and abs(t[-1][1] - last) <= buffer:
            return g, i
    return None


def judge(lay: Layout, config: dict, sample: Sample, ans: Answer
          ) -> Dict[str, object]:
    """The counts of one job, as `planted_isoforms`' judge counts them,
    with an isoform matched to the expressed transcript of its strand and
    intron chain whose first and last bases both lie within
    `downstream_buffer` of its own (a tandem pair's sites lie farther
    apart, so the match is unique):

    - aln_bad: reads with an alignment whose matches and mismatches are
      not the recount over its own blocks;
    - introns_off: reads with no alignment, more than one, another
      strand, or another intron chain than their transcript's;
    - consensus_bad: matched isoforms of a transcript with
      `required_reads` reads or more whose sequence is not the column
      majority of those reads (ties accepted);
    - isoforms_off: required transcripts with no isoform, and isoforms of
      no expressed transcript or a second of one (printed, not compared);
    - misassigned: reads assigned to an isoform of another transcript or
      of none, and reads of a transcript with an isoform that are not
      assigned to it;
    - counts_off: the distance of each matched isoform's quantity from
      its transcript's reads, and the reads of required transcripts with
      no isoform;
    - missed: the reads of required transcripts with no isoform;
    - reads, required;
    - notes: what is off in the first few bad consensi, for the log."""
    required_reads = int(config["judge"]["required_reads"])
    buffer = int(config["judge"]["downstream_buffer"])
    aln_bad = introns_off = 0
    by_chain: Dict[tuple, List[Tuple[int, int]]] = {}
    for (g, i), block in sample.reads.items():
        strand = lay.genes[g].strand
        want = bm_reference.introns(_blocks(lay.exons(g, i)))
        by_chain.setdefault((strand, want), []).append((g, i))
        for k, read in enumerate(block):
            alns = ans.alignments.get(read_name(g, i, k))
            if not alns:
                introns_off += 1
                continue
            if any(bm_reference.recount(lay.genome, read, a)
                   != (a.matches, a.mismatches) for a in alns):
                aln_bad += 1
            if len(alns) != 1 or alns[0].strand != strand \
                    or bm_reference.introns(alns[0].blocks) != want:
                introns_off += 1
    iso_of: Dict[Tuple[int, int], str] = {}
    tx_of: Dict[str, Tuple[int, int]] = {}
    consensus_bad = isoforms_off = counts_off = 0
    notes: List[str] = []
    for name, iso in ans.isoforms.items():
        candidates = by_chain.get(
            (iso.strand, bm_reference.introns(_blocks(iso.exons))), [])
        key = _match(candidates, lay, iso.exons, buffer)
        if key is None or key in iso_of:
            isoforms_off += 1
            continue
        iso_of[key] = name
        tx_of[name] = key
        block = sample.reads[key]
        if len(block) >= required_reads and consensus_off(iso.seq, block):
            consensus_bad += 1
            off, extra = _columns_off(iso.seq, block)
            notes.append(f"consensus {name} of gene {key[0]} isoform "
                         f"{key[1]} ({lay.genes[key[0]].kinds[key[1]]}, "
                         f"{len(block)} reads): {len(off)} columns off, "
                         f"the first at {off[:1].tolist()}, length "
                         f"{extra:+d}")
        counts_off += abs((iso.count or 0) - len(block))
    required = [key for key, block in sample.reads.items()
                if len(block) >= required_reads]
    missed = [key for key in required if key not in iso_of]
    isoforms_off += len(missed)
    missed_reads = sum(len(sample.reads[key]) for key in missed)
    counts_off += missed_reads
    misassigned = 0
    for key, block in sample.reads.items():
        for k in range(len(block)):
            got = ans.assigned.get(read_name(*key, k))
            if got is None:
                misassigned += int(key in iso_of)
            elif tx_of.get(got) != key:
                misassigned += 1
    notes += [f"missed gene {g} isoform {i} ({lay.genes[g].kinds[i]}, "
              f"{len(sample.reads[(g, i)])} reads)" for g, i in missed[:5]]
    return dict(aln_bad=aln_bad, introns_off=introns_off,
                consensus_bad=consensus_bad, isoforms_off=isoforms_off,
                misassigned=misassigned, counts_off=counts_off,
                missed=missed_reads, reads=sample.n_reads,
                required=len(required), notes=notes[:10])


def numbers(per_job: List[Dict[str, int]]) -> Dict[str, float]:
    """The compared numbers over a run's jobs."""
    if not per_job:
        return {k: float("inf") for k in NUMBERS}
    tot = {k: sum(j[k] for j in per_job) for k in per_job[0]
           if k != "notes"}
    per_10k = 1e4 / tot["reads"]
    return dict(
        aln_bad=tot["aln_bad"],
        introns_off_per_10k=per_10k * tot["introns_off"],
        consensus_bad=tot["consensus_bad"],
        misassigned_per_10k=per_10k * tot["misassigned"],
        counts_off_per_10k=per_10k * tot["counts_off"],
        missed_per_10k=per_10k * tot["missed"])


# ------------------------------------------------ the control

def control_answer(lay: Layout, config: dict, sample: Sample, seed: int,
                   k_mer: int = 15) -> Answer:
    """The reference in the program's place with its exactness broken:
    `planted_isoforms`' control (each read aligned along its transcript's
    chain with its junctions where a seed chain without the gap-fill DP
    leaves them, up to k_mer - 1 bases off, drawn from the seed; an
    isoform for each transcript of 3 reads or more whose sequence is its
    first read; a read assigned, and counted, where its intron chain is
    its isoform's), and each tandem-UTR isoform merged into its gene's
    main isoform, as a program that does not split by ends would give:
    its reads assigned to, and counted in, the main isoform."""
    rng = np.random.default_rng(seed)
    alignments: Dict[str, List[Alignment]] = {}
    isoforms: Dict[str, Isoform] = {}
    assigned: Dict[str, str] = {}
    for (g, i), block in sample.reads.items():
        gene = lay.genes[g]
        strand = gene.strand
        exons = lay.exons(g, i)
        want = bm_reference.introns(_blocks(exons))
        owner = 0 if gene.kinds[i] == "tandem" else i
        name = f"Isoform{g}.{owner}"
        if owner == i and len(block) >= 3:
            isoforms[name] = Isoform(strand, tuple(exons),
                                     block[0].tobytes(), 0)
        shifts = rng.integers(0, k_mer, size=(len(block), len(exons)))
        for k, read in enumerate(block):
            ex = [list(x) for x in exons]
            for j in range(len(ex) - 1):
                s = min(int(shifts[k, j]), ex[j][1] - ex[j][0] - 1)
                ex[j][1] -= s
                ex[j + 1][0] -= s
            blocks = _blocks(ex)
            q, q_starts = 0, []
            for _, b in blocks:
                q_starts.append(q)
                q += b
            a = Alignment(strand, blocks, tuple(q_starts), 0, 0)
            a.matches, a.mismatches = bm_reference.recount(
                lay.genome, read, a)
            alignments[read_name(g, i, k)] = [a]
            if bm_reference.introns(blocks) == want and name in isoforms:
                assigned[read_name(g, i, k)] = name
                isoforms[name].count += 1
    return Answer(alignments, isoforms, assigned)
