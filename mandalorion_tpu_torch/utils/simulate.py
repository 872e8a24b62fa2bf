"""Synthetic dataset simulator: genomes, spliced transcripts, noisy reads.

Builds config-1-style datasets (BASELINE.md): a random genome with planted
multi-exon genes (canonical gt..ag introns), transcripts, reads with
substitution errors, plus the GTF annotation — used by bench.py, the
multichip dryrun (__graft_entry__.py), and the test suite (tests/synthdata
re-exports these). The reference ships no simulator; its acceptance data
is external (SURVEY §4 configs).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

BASES = np.array(list("ACGT"))


def make_genome(length: int, seed: int = 7) -> str:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=length, dtype=np.uint8)
    return np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()


def plant_introns(genome: str, exons, strand: str = "+") -> str:
    """Force canonical intron motifs at the boundaries between exons:
    gt..ag on genome-forward for '+' transcripts, ct..ac for '-' ones.
    exons: list of (start, end) genomic half-open intervals, ascending."""
    donor, acceptor = ("GT", "AG") if strand == "+" else ("CT", "AC")
    g = list(genome)
    for (s1, e1), (s2, e2) in zip(exons, exons[1:]):
        g[e1] = donor[0]
        g[e1 + 1] = donor[1]
        g[s2 - 2] = acceptor[0]
        g[s2 - 1] = acceptor[1]
    return "".join(g)


def transcript_seq(genome: str, exons) -> str:
    return "".join(genome[s:e] for s, e in exons)


def gtf_lines(chrom: str, gene: str, tid: str, exons, strand: str = "+",
              tags: str = "") -> str:
    out = []
    attrs = (f'gene_id "{gene}"; transcript_id "{tid}"; '
             f'gene_name "{gene}N";{tags}')
    for s, e in exons:
        out.append(
            f"{chrom}\tsynth\texon\t{s + 1}\t{e}\t.\t{strand}\t.\t{attrs}")
    return "\n".join(out) + "\n"


def mutate_read(seq: str, rng: np.random.Generator, sub_rate: float = 0.0):
    """Introduce substitutions (keeps length). Returns (seq, n_subs)."""
    if sub_rate <= 0:
        return seq, 0
    arr = np.array(list(seq))
    mask = rng.random(len(arr)) < sub_rate
    subs = int(mask.sum())
    if subs:
        repl = rng.choice(BASES, size=subs)
        arr[mask] = repl
    return "".join(arr), subs


def make_adversarial_dataset(out_dir: str, reads_per_isoform: int = 30,
                             sub_rate: float = 0.02, seed: int = 0) -> dict:
    """Config-2-style truth-set dataset (BASELINE.json configs[1]): the
    adversarial structures real annotation throws at an isoform caller,
    with exact expected answers:

    - OVL_A / OVL_B   — two same-strand genes whose loci overlap (their
                        exons interleave); both junction chains must
                        survive the shared-locus peak calling;
    - AS_F ('+') and AS_R ('-') — antisense pair occupying the same span
                        on opposite strands;
    - SKIP.iso1/iso2  — one gene, two isoforms sharing exons (exon 2
                        skipped in iso2) — the shared-TSS/TES splice
                        grouping case;
    - PSEUDO parent   — a 3-exon gene whose processed (intronless,
                        ~5%-diverged) pseudogene copy sits 60 kb away:
                        reads must stay at the spliced parent and no
                        isoform may be called at the decoy;
    - CTRL            — a plain 2-exon gene as an anchor.

    Writes genome.fasta / reads.fasta / ann.gtf and returns the truth
    dict: {"isoforms": {tid: {"chain": [(s, e), ...], "strand": s}},
    "pseudogene_span": (s, e), "n_reads": N}. Read names are
    "<tid>_r<k>" so assignment purity is checkable. Evaluate with
    evaluate_adversarial()."""
    from mandalorion_tpu_torch.io.fastx import revcomp, write_fasta

    rng = np.random.default_rng(seed)
    genome = make_genome(300_000, seed=seed + 100)

    def gene(exons, strand):
        nonlocal genome
        genome = plant_introns(genome, exons, strand=strand)
        return exons

    iso = {}
    iso["OVL_A"] = (gene([(20_000, 20_600), (24_000, 24_500),
                          (28_000, 28_600)], "+"), "+")
    iso["OVL_B"] = (gene([(22_000, 22_700), (26_000, 26_500),
                          (30_000, 30_700)], "+"), "+")
    iso["AS_F"] = (gene([(60_000, 60_800), (64_000, 64_700)], "+"), "+")
    iso["AS_R"] = (gene([(62_000, 62_600), (66_000, 66_500)], "-"), "-")
    skip_exons = gene([(100_000, 100_700), (104_000, 104_400),
                       (108_000, 108_700)], "+")
    iso["SKIP.iso1"] = (skip_exons, "+")
    # skipped-exon isoform reuses E1's donor and E3's acceptor (already
    # canonical from the 3-exon planting)
    iso["SKIP.iso2"] = ([skip_exons[0], skip_exons[2]], "+")
    iso["PSEUDO"] = (gene([(140_000, 140_800), (144_000, 144_600),
                           (148_000, 148_500)], "+"), "+")
    iso["CTRL"] = (gene([(180_000, 180_600), (184_000, 184_500)], "+"), "+")

    # processed pseudogene: the PSEUDO transcript, ~5% diverged, pasted
    # intronless into a SEPARATE chromosome (retrotransposition lands at a
    # random locus; chr2 also keeps the decoy outside -G 400k chaining
    # range, so it competes as a whole-read multi-mapping alternative,
    # not as a chimeric splice target). No annotation, no reads of its own.
    parent_t = transcript_seq(genome, iso["PSEUDO"][0])
    decoy, _ = mutate_read(parent_t, rng, 0.05)
    chr2 = make_genome(20_000, seed=seed + 101)
    p0 = 9_000
    chr2 = chr2[:p0] + decoy + chr2[p0 + len(decoy):]
    pseudogene_span = ("chr2", p0, p0 + len(decoy))

    reads = []
    gtf = []
    gene_of = {"OVL_A": "G_OVL_A", "OVL_B": "G_OVL_B", "AS_F": "G_AS_F",
               "AS_R": "G_AS_R", "SKIP.iso1": "G_SKIP",
               "SKIP.iso2": "G_SKIP", "PSEUDO": "G_PSEUDO",
               "CTRL": "G_CTRL"}
    for tid, (exons, strand) in iso.items():
        t = transcript_seq(genome, exons)
        if strand == "-":
            t = revcomp(t)
        for k in range(reads_per_isoform):
            r, _ = mutate_read(t, rng, sub_rate)
            reads.append((f"{tid}_r{k}", r))
        gtf.append(gtf_lines("chr1", gene_of[tid], tid, exons,
                             strand=strand))

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "genome.fasta"), "w") as fh:
        fh.write(f">chr1\n{genome}\n>chr2\n{chr2}\n")
    write_fasta(os.path.join(out_dir, "reads.fasta"), reads)
    with open(os.path.join(out_dir, "ann.gtf"), "w") as fh:
        fh.write("".join(gtf))
    return {"isoforms": {tid: {"chain": list(exons), "strand": strand}
                         for tid, (exons, strand) in iso.items()},
            "pseudogene_span": pseudogene_span,
            "n_reads": len(reads)}


def evaluate_adversarial(out_dir: str, truth: dict) -> dict:
    """Score a pipeline run against make_adversarial_dataset's truth:
    isoform recall (exact intron-chain match), junction recall,
    pseudogene false calls (isoforms landing in the decoy span), and
    read-assignment purity (reads2isoforms vs the tid encoded in each
    read name)."""
    import re
    from collections import defaultdict

    # output isoform structures from the clean gtf
    chains: dict = defaultdict(list)   # out_tid -> [(s, e) exons]
    strands: dict = {}
    chroms: dict = {}
    gtf_path = os.path.join(out_dir, "Isoforms.filtered.clean.gtf")
    with open(gtf_path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 9 or f[2] != "exon":
                continue
            m = re.search(r'transcript_id "([^"]+)"', f[8])
            tid = m.group(1)
            chains[tid].append((int(f[3]) - 1, int(f[4])))
            strands[tid] = f[6]
            chroms[tid] = f[0]
    for tid in chains:
        chains[tid].sort()

    def introns(ch):
        return tuple((e1, s2) for (_s1, e1), (s2, _e2)
                     in zip(ch, ch[1:]))

    # match each truth isoform to an output isoform by exact intron chain
    matched: dict = {}
    for tid, info in truth["isoforms"].items():
        want = introns(info["chain"])
        for out_tid, ch in chains.items():
            if strands[out_tid] == info["strand"] and \
                    introns(ch) == want and len(ch) == len(info["chain"]):
                matched[tid] = out_tid
                break

    # junction recall over all truth junctions
    out_juncs = {(strands[t], j) for t, ch in chains.items()
                 for j in introns(ch)}
    want_juncs = {(info["strand"], j)
                  for info in truth["isoforms"].values()
                  for j in introns(info["chain"])}
    junc_hit = len(want_juncs & out_juncs)

    # pseudogene false calls: any output isoform inside the decoy span
    pc, p0, p1 = truth["pseudogene_span"]
    pseudo_fp = [t for t, ch in chains.items()
                 if ch and chroms[t] == pc
                 and ch[0][0] >= p0 - 1000 and ch[-1][1] <= p1 + 1000]

    # read purity via reads2isoforms
    assign: dict = {}
    r2i = os.path.join(out_dir, "tmp", "reads2isoforms.txt")
    with open(r2i) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                assign[parts[0]] = parts[1]
    out2truth = {v: k for k, v in matched.items()}
    good = bad = 0
    for rname, out_tid in assign.items():
        true_tid = rname.rsplit("_r", 1)[0]
        hit = out2truth.get(out_tid)
        if hit == true_tid:
            good += 1
        elif hit is not None:
            bad += 1
    purity = good / max(good + bad, 1)

    return {
        "isoform_recall": len(matched) / len(truth["isoforms"]),
        "matched": {k: v for k, v in matched.items()},
        "junction_recall": junc_hit / max(len(want_juncs), 1),
        "pseudogene_false_calls": pseudo_fp,
        "read_purity": round(purity, 4),
        "n_out_isoforms": len(chains),
    }


def make_dataset(out_dir: str, n_genes: int = 8, n_reads_per_gene: int = 250,
                 genome_len: int = 200_000, sub_rate: float = 0.01,
                 seed: int = 0,
                 exons_per_gene: Optional[Tuple[int, int]] = (2, 5),
                 exon_len: Tuple[int, int] = (300, 800),
                 strand: Optional[str] = None) -> int:
    """Write genome.fasta / reads.fasta / ann.gtf for a config-1-style
    multi-gene workload into out_dir; returns the read count. `strand`
    pins every gene to one strand (default: alternate); `exon_len` sizes
    exons (larger values build the >=8 kb isoforms that exercise abPOA's
    -S path in tools/validate_against_real_tools.py)."""
    from mandalorion_tpu_torch.io.fastx import revcomp, write_fasta

    rng = np.random.default_rng(seed)
    genome = make_genome(genome_len, seed=9)
    genes: List[Tuple[List[Tuple[int, int]], str]] = []
    span = genome_len // n_genes
    for g in range(n_genes):
        base = g * span + 2000
        exons = []
        pos = base
        for _ in range(int(rng.integers(*exons_per_gene))):
            length = int(rng.integers(*exon_len))
            exons.append((pos, pos + length))
            pos += length + int(rng.integers(200, 2000))
        g_strand = strand or ("+" if g % 2 == 0 else "-")
        genome = plant_introns(genome, exons, strand=g_strand)
        genes.append((exons, g_strand))

    reads = []
    gtf = []
    for gi, (exons, strand) in enumerate(genes):
        t = transcript_seq(genome, exons)
        if strand == "-":
            t = revcomp(t)
        for ri in range(n_reads_per_gene):
            r, _ = mutate_read(t, rng, sub_rate)
            reads.append((f"g{gi}r{ri}", r))
        gtf.append(gtf_lines("chr1", f"G{gi}", f"T{gi}", exons,
                             strand=strand))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "genome.fasta"), "w") as fh:
        fh.write(f">chr1\n{genome}\n")
    write_fasta(os.path.join(out_dir, "reads.fasta"), reads)
    with open(os.path.join(out_dir, "ann.gtf"), "w") as fh:
        fh.write("".join(gtf))
    return len(reads)
