"""Generator `planted_isoforms`: one chromosome with planted genes of
several isoforms each, reads that are their whole transcripts with
substitutions, and the judge of a job's answer against what was
planted.

A configuration file that names this generator holds:

- `layout`: tools/run_config3.py's layout (`chrom`, `genome_bp`,
  `n_genes`, `gene_offset`, `exons_per_gene`, `exon_len`, `intron_len`,
  `layout_seed`, drawn in config-3's order, so that its first isoforms
  are config-3's genes), and `isoforms_per_gene` with `isoform_seed`:
  each gene's further isoforms skip one internal exon each;
- `reads`: `sub_rate`, the rate a base of substitutions by another base;
- `judge`: `required_reads`, the reads of a transcript from which on it
  has to have an isoform and its consensus is held to their column
  majority;
- `limits`: each compared number's limit.

A traffic mix holds `expression`: `genes` drawn from the layout's by
`profile_seed`, their depths `zipf_top / (first_rank + r)` for the r-th
gene (Zipf's law of gene expression), each gene's reads shared among its
isoforms as 1, 1/2, 1/3, ...; and `pool`, the samples a run cycles
through.

What depends on what: the layout on the configuration's seeds; which
genes and how many reads each on the mix's `profile_seed`; the genome's
bases, the reads' substitutions and their order in the file on the run
seed. So every run seed has the same genes, reads and read lengths.

Only numpy, the standard library and the harness's own modules.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

import bm_data
import bm_reference
from bm_data import ACGT, CODE
from bm_reference import Alignment, Answer, Isoform

NUMBERS = ("aln_bad", "introns_off_per_10k", "consensus_bad",
           "misassigned_per_10k", "counts_off_per_10k")


# ------------------------------------------------ the layout

@dataclasses.dataclass
class Gene:
    exons: List[Tuple[int, int]]          # half-open, on the genome
    strand: str
    isoforms: List[Tuple[int, ...]]       # exon indices of each isoform


@dataclasses.dataclass
class Layout:
    chrom: str
    genome: np.ndarray
    genes: List[Gene]
    gtf: str

    def exons(self, g: int, i: int) -> List[Tuple[int, int]]:
        gene = self.genes[g]
        return [gene.exons[x] for x in gene.isoforms[i]]

    def transcript(self, g: int, i: int) -> np.ndarray:
        return bm_data.transcript(self.genome, self.exons(g, i),
                                  self.genes[g].strand)


def make_layout(config: dict, genome_seed) -> Layout:
    """config-3's layout with the configuration's sizes, its genes'
    further isoforms, and the genome's bases from `genome_seed`."""
    lay = config["layout"]
    rng = np.random.default_rng(lay["layout_seed"])
    iso_rng = np.random.default_rng(lay["isoform_seed"])
    length = int(lay["genome_bp"])
    genome = bm_data.genome_bytes(length, genome_seed)
    n_genes = int(lay["n_genes"])
    span = length // n_genes
    genes, gtf = [], []
    for g in range(n_genes):
        pos = g * span + int(lay["gene_offset"])
        exons = []
        for _ in range(int(rng.integers(*lay["exons_per_gene"]))):
            ln = int(rng.integers(*lay["exon_len"]))
            exons.append((pos, pos + ln))
            pos += ln + int(rng.integers(*lay["intron_len"]))
        if exons[-1][1] > (g + 1) * span:
            raise ValueError(f"gene {g} runs into the next gene's span")
        strand = "+" if g % 2 == 0 else "-"
        bm_data.plant(genome, exons, strand)
        internal = np.arange(1, len(exons) - 1)
        n_iso = min(int(iso_rng.integers(*lay["isoforms_per_gene"])),
                    1 + len(internal))
        skipped = iso_rng.choice(internal, n_iso - 1, replace=False)
        isoforms = [tuple(range(len(exons)))] + [
            tuple(x for x in range(len(exons)) if x != int(s))
            for s in skipped]
        genes.append(Gene(exons, strand, isoforms))
        for i, chain in enumerate(isoforms):
            tid = f"T{g}" if i == 0 else f"T{g}.{i}"
            gtf.append(bm_data.gtf_lines(lay["chrom"], f"G{g}", tid,
                                         [exons[x] for x in chain], strand))
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


def judge(lay: Layout, config: dict, sample: Sample, ans: Answer
          ) -> Dict[str, object]:
    """The counts of one job:

    - aln_bad: reads with an alignment whose matches and mismatches are
      not the recount over its own blocks;
    - introns_off: reads with no alignment, more than one, another
      strand, or another intron chain than their transcript's;
    - consensus_bad: isoforms of the chain of a transcript with
      `required_reads` reads or more whose sequence is not the column
      majority of those reads (ties accepted);
    - isoforms_off: transcripts of `required_reads` reads or more with no
      isoform of their strand and intron chain, and isoforms of no
      expressed transcript's chain or a second of one (printed, not
      compared: the control reads 0 too; a missed isoform's reads count
      in counts_off, and reads of a false one in misassigned);
    - misassigned: reads assigned to an isoform of another transcript or
      of none, and reads of a transcript with an isoform that are not
      assigned to it;
    - counts_off: the distance of each matched isoform's quantity from
      its transcript's reads, and the reads of required transcripts with
      no isoform;
    - reads, required;
    - notes: what is off in the first few bad consensi, for the log."""
    required_reads = int(config["judge"]["required_reads"])
    aln_bad = introns_off = 0
    by_chain: Dict[tuple, Tuple[int, int]] = {}
    for (g, i), block in sample.reads.items():
        strand = lay.genes[g].strand
        want = bm_reference.introns(_blocks(lay.exons(g, i)))
        by_chain[(strand, want)] = (g, i)
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
        key = by_chain.get((iso.strand,
                            bm_reference.introns(_blocks(iso.exons))))
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
                         f"{key[1]} ({len(block)} reads): {len(off)} "
                         f"columns off, the first at {off[:1].tolist()}, "
                         f"length {extra:+d}")
        counts_off += abs((iso.count or 0) - len(block))
    required = [key for key, block in sample.reads.items()
                if len(block) >= required_reads]
    missed = [key for key in required if key not in iso_of]
    isoforms_off += len(missed)
    counts_off += sum(len(sample.reads[key]) for key in missed)
    misassigned = 0
    for key, block in sample.reads.items():
        for k in range(len(block)):
            got = ans.assigned.get(read_name(*key, k))
            if got is None:
                misassigned += int(key in iso_of)
            elif tx_of.get(got) != key:
                misassigned += 1
    return dict(aln_bad=aln_bad, introns_off=introns_off,
                consensus_bad=consensus_bad, isoforms_off=isoforms_off,
                misassigned=misassigned, counts_off=counts_off,
                reads=sample.n_reads, required=len(required),
                notes=notes[:5])


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
        counts_off_per_10k=per_10k * tot["counts_off"])


# ------------------------------------------------ the control

def control_answer(lay: Layout, config: dict, sample: Sample, seed: int,
                   k_mer: int = 15) -> Answer:
    """The reference in the program's place with its exactness broken:
    each read aligned along its transcript's planted chain, with its
    splice junctions where a seed chain without the gap-fill DP leaves
    them (the donor moved back by up to k_mer - 1 bases, the acceptor
    with it, drawn from the seed) and its counts recounted over those
    blocks; an isoform for each transcript of 3 reads or more, whose
    sequence is its first read (the consensus without POA).
    A read is assigned to its transcript's isoform, and counted in its
    quantity, where its intron chain is the isoform's."""
    rng = np.random.default_rng(seed)
    alignments: Dict[str, List[Alignment]] = {}
    isoforms: Dict[str, Isoform] = {}
    assigned: Dict[str, str] = {}
    for (g, i), block in sample.reads.items():
        strand = lay.genes[g].strand
        exons = lay.exons(g, i)
        want = bm_reference.introns(_blocks(exons))
        name = f"Isoform{g}.{i}"
        if len(block) >= 3:
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
