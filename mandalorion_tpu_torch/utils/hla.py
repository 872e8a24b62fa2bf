"""HLA typing from isoform sequences.

Re-design of `utils/HLAtyping.py`: isoforms are assigned to HLA genes by
genomic position (hardcoded hg38 chr6 coordinates, HLAtyping.py:137-148),
then aligned against an HLA allele fasta; full-length allele hits are
ranked by (mismatches, indels). The external minimap2/emtrey/psl2pslx/
config-file machinery is replaced by the in-process SpliceAligner."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from mandalorion_tpu_torch.align.aligner import SpliceAligner
from mandalorion_tpu_torch.config import AlignConfig
from mandalorion_tpu_torch.io.fastx import fastx_to_dict, read_fastx

# (gene, chrom, start, end) — hg38, as in the reference
HLA_GENES: List[Tuple[str, str, int, int]] = [
    ("HLA-A", "chr6", 29942207, 29946087),
    ("HLA-B", "chr6", 31353043, 31358016),
    ("HLA-C", "chr6", 31268477, 31272311),
    ("HLA-DRA1", "chr6", 32439285, 32445414),
    ("HLA-DRB1", "chr6", 32578224, 32590373),
    ("HLA-DRB5", "chr6", 32516982, 32530918),
    ("HLA-DPA1", "chr6", 33064002, 33074116),
    ("HLA-DPB1", "chr6", 33075089, 33087875),
    ("HLA-DQA1", "chr6", 32637024, 32643690),
    ("HLA-DQB1", "chr6", 32658674, 32667200),
]

HLA_GENE_ORDER = ["A", "B", "C", "DRA", "DRB1", "DPA1", "DPB1", "DQA1",
                  "DQB1"]


def find_gene_matches(isoform_fasta: str, genome: Dict[str, str],
                      gene_list=None,
                      aligner: Optional[SpliceAligner] = None
                      ) -> Dict[str, str]:
    """isoform name -> HLA gene, by splice-aligning to the genome and
    testing gene_start < alignment_start < gene_end (reference rule)."""
    gene_list = gene_list or HLA_GENES
    if aligner is None:
        aligner = SpliceAligner(genome)
    reads = list(read_fastx(isoform_fasta))
    recs = aligner.map_batch([(n, s) for n, s, _ in reads])
    match: Dict[str, str] = {}
    for gene, chrom, start, end in gene_list:
        for rec in recs:
            if rec.t_name == chrom and start < rec.t_start < end:
                match[rec.q_name] = gene
    return match


def parse_allele_categories(hla_fasta: str) -> Dict[str, str]:
    """Allele fasta headers: `>name category ...` (collect_hla_names)."""
    cats: Dict[str, str] = {}
    with open(hla_fasta) as fh:
        for line in fh:
            if line.startswith(">"):
                parts = line[1:].split()
                cats[parts[0]] = parts[1] if len(parts) > 1 else parts[0]
    return cats


def type_alleles(isoform_fasta: str, gene_match: Dict[str, str],
                 hla_fasta: str) -> List[Tuple[str, str, int, int, int]]:
    """Align isoforms to the allele set; keep FULL-LENGTH allele hits
    (alignment covers the entire allele) ranked by (mismatches, indels).
    Returns [(isoform, best_allele_category, mismatches, indels,
    allele_length)] per HLA gene, reference print order."""
    cats = parse_allele_categories(hla_fasta)
    alleles = fastx_to_dict(hla_fasta)
    aligner = SpliceAligner(
        alleles, AlignConfig(kmer=13, window=5,
                             min_intron=1_000_000_000,
                             max_intron=1_000_000_000))
    hits: Dict[str, List[Tuple[int, int, str, str, int]]] = {}
    for name, seq, _q in read_fastx(isoform_fasta):
        for rec in aligner.map_all_targets(name, seq):
            full_length = rec.t_start == 0 and rec.t_end == rec.t_size
            if not full_length or rec.q_name not in gene_match:
                continue
            indels = rec.n_count + rec.q_base_insert + rec.t_base_insert
            hits.setdefault(rec.q_name, []).append(
                (rec.mismatches, indels, rec.t_name, cats[rec.t_name],
                 rec.t_size))
    results: List[Tuple[str, str, int, int, int]] = []
    for hla_gene in HLA_GENE_ORDER:
        for name, hit_list in hits.items():
            hit_list = sorted(hit_list, key=lambda x: (x[0], x[1]))
            best = hit_list[0]
            if best[3].split("*")[0] == hla_gene:
                results.append((name, best[3], best[0], best[1], best[4]))
    return results
