"""Single typed configuration for the whole pipeline (counterpart of
mandalorion_tpu/config.py; the backend fields default to the device
routes).

The reference scatters its constants across ~20 argparse flags re-parsed by
every module (`Mando.py:21-199`, `defineIsoforms.py:20-52`,
`filterIsoforms.py:19-68`) plus a dozen hardcoded magic numbers
(`SpliceDefineConsensus.py:16,321,542-548,740`, `filterIsoforms.py:127,157-173`).
Here every one of them is a named, documented field of one dataclass.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# Single source for the POA band half-width default: PoaConfig.band_width
# (the user-facing knob) and poa.graph.PoaParams.band (the engine's
# parameter object) both read it, so the two can't drift.
POA_BAND_DEFAULT = 128


@dataclass(frozen=True)
class AlignConfig:
    """Splice-aware aligner parameters (replaces minimap2 `-ax splice:hq
    --cs=long -uf -G 400k --secondary=no`, `Mando.py:316-319`)."""

    kmer: int = 15                 # minimizer k (splice:hq: k=15)
    window: int = 5                # minimizer w (splice:hq: w=5)
    max_occ: int = 200             # occurrence-cap floor for seed lookup
    occ_frac: float = 2e-4         # minimap2 -f analogue: the cap rises to
                                   # the (1 - occ_frac) quantile of the
                                   # index's occurrence distribution, so
                                   # high-copy repeat/tandem regions keep
                                   # their seeds (cap never drops below
                                   # max_occ; 0 disables)
    max_intron: int = 400_000      # -G 400k
    min_intron: int = 30           # target gaps >= this are introns
    match: int = 1                 # chain/extend match score
    mismatch: int = 2              # mismatch penalty (positive)
    gap_open: int = 2              # affine gap open (positive)
    gap_extend: int = 1            # affine gap extend (positive)
    noncanonical_penalty: int = 9  # splice junction without GT..AG (-C9)
    min_chain_score: int = 40      # discard chains below this score
    band_width: int = 128          # banded DP half-band for gap fill
    splice_slack: int = 10         # junction slide window for motif search
    end_bonus: int = 0             # extension bonus for consuming the
                                   # whole query (star consensus sets 12)
    zdrop: int = 0                 # stop extension once the score falls
                                   # >zdrop below the running best
                                   # (minimap2 -z analogue; 0 disables).
                                   # Identical semantics in all backends
                                   # (tests/test_kernels.py)
    max_end_extend: int = 2048     # max bases of end extension DP
    batch_reads: int = 512         # reads per device batch
    # note: -uf forward-splice and --secondary=no are structural (strand-
    # dependent motifs, primary-only emission), not knobs
    dp_backend: str = "device"     # 'device' (align/kernels.py: the CUDA
                                   # kernel, or its plain PyTorch version
                                   # on the CPU; the reference's
                                   # 'pallas') | 'rowscan' (that plain
                                   # version as PyTorch ops on the device:
                                   # the reference's pure-JAX row scan) |
                                   # 'numpy' (host native C++);
                                   # bit-identical
    chain_backend: str = "device"  # 'device' (align/chain_kernel.py) |
                                   # 'native' (host C++). Module A runs
                                   # any pair of the two: both 'device'
                                   # is the default, 'native' with
                                   # 'numpy' the host route (forked
                                   # workers, no device), the other four
                                   # run in one process on the device
                                   # (align/aligner.py). Each pair gives
                                   # the reference's output for the same
                                   # pair
    emit_sam: bool = False         # also write tmp/mm2Alignments.sam
    index_cache: str = ""          # persist/reuse the genome index (.npz),
                                   # minimap2 .mmi analogue; validated
                                   # against genome + k/w on load
    index_backend: str = "replicated"  # 'replicated' (per-host index);
                                   # 'sharded' (hash-range shards over the
                                   # installed device mesh on the device
                                   # route; byte-identical; without a
                                   # mesh the index stays replicated)


@dataclass(frozen=True)
class PoaConfig:
    """Partial-order consensus parameters (replaces `abpoa -M 5 -r 0 [-S]`,
    `SpliceDefineConsensus.py:915-919`)."""

    match: int = 5                 # -M 5
    mismatch: int = 4              # abPOA default mismatch penalty
    # convex dual-affine gap model (abPOA -O 6,26 -E 2,1):
    # gap(k) = min(gap_open + k*gap_extend, gap_open2 + k*gap_extend2)
    gap_open: int = 6
    gap_extend: int = 2
    gap_open2: int = 26
    gap_extend2: int = 1
    adaptive_band_threshold: int = 8000  # -S when median read length >= 8000
    band_width: int = 0            # adaptive band half-width; 0 = auto,
                                   # abPOA's default band formula
                                   # -b 10 -f 0.01 (10 + len/100, floor 16)
    max_reads: int = 100           # consensus subsample cap (`SDC.py:884-885`)
    seed: int = 0                  # our subsampling is seeded (reference: unseeded)
    engine: str = "graph"          # 'graph' (partial-order alignment,
                                   # the abPOA analogue and production
                                   # default, SDC.py:915-919) or 'star'
                                   # (backbone+vote fast path, different
                                   # output by design)
    max_graph_len: int = 32768     # longest read the banded graph DP
                                   # accepts; beyond it the
                                   # overlength_fallback policy applies
    overlength_fallback: str = "error"  # 'error' (abort loudly) or 'star'
                                   # (explicit opt-in to the vote engine
                                   # for >max_graph_len isoforms)
    backend: str = "auto"          # graph-DP execution backend: 'auto'
                                   # (= native C++ on one device),
                                   # 'native', 'device' (poa/kernels.py)



@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end APDFQ parameters. Field comments cite the reference flag
    or hardcoded constant each one replaces."""

    # ---- user-facing flags (Mando.py:21-199) ----
    upstream_buffer: int = 10          # -u
    downstream_buffer: int = 50        # -d
    minimum_ratio: float = 0.01        # -r (module F locus-coverage ratio)
    minimum_internal_ratio: float = 1.0  # -i
    minimum_reads: int = 3             # -R
    overhangs: Tuple[int, int, int, int] = (0, 40, 0, 40)  # -O
    minimum_isoform_length: int = 200  # -I
    minimum_feature_count: int = 2     # -n
    splice_site_window: int = 1        # -w
    acutoff: float = 0.5               # -A
    white_list_polyA: Tuple[str, ...] = ("0",)  # -W (comma list; "0" = off)
    multi_exon_only: bool = False      # -m
    junctions: Tuple[str, ...] = (     # -j
        "gtag", "gcag", "atac", "ctac", "ctgc", "gtat")
    modules: str = "APDFQ"             # -M
    threads: int = 8                   # -t (host-side parallelism)

    # ---- constants that are hardcoded in the reference ----
    locus_cutoff: float = 0.1          # D invoked with literal "0.1" (Mando.py:388)
    minimum_intron_size: int = 10      # clean_psl gap merge (SDC.py:16)
    junction_gap: int = 50             # junction = target gap > 50 (SDC.py:740)
    accuracy_gate: float = 0.9         # reads below excluded from edges (SDC.py:321)
    motif_fraction: float = 0.85       # allowed-motif gate (SDC.py:542)
    flank_accuracy: float = 0.85       # '=' fraction in 5 cs ops/side (SDC.py:547)
    splice_check_subsample: int = 500  # cs-motif subsample cap (SDC.py:506)
    ends_subsample: int = 10_000       # end-calling subsample cap (SDC.py:819)
    internal_buffer: int = 20          # containment end trim (filterIsoforms.py:127)
    acontent_window: int = 15          # polyA A-content window (filterIsoforms.py:157)
    polya_scan_offsets: Tuple[int, int] = (3, 23)  # scan range (filterIsoforms.py:158)
    extend_vote: int = 10              # >=10 covered bases => extending (filterIsoforms.py:173)
    whitelist_pad: int = 20            # polyA whitelist +/-20 (defineIsoforms.py:117-118)
    # note: the 10 nt coverage rounding (SDC.py:227-229) is structural —
    # it defines the histogram bucketing parity depends on

    # ---- sub-configs ----
    align: AlignConfig = field(default_factory=AlignConfig)
    poa: PoaConfig = field(default_factory=PoaConfig)

    # ---- runtime ----
    seed: int = 0                      # seeded subsampling (reference: unseeded)
    pacbio: bool = False               # hidden -P flag (BAM input)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def config_from_args(args) -> PipelineConfig:
    """Build a PipelineConfig from a Mando-compatible argparse namespace."""
    wl = tuple(str(args.white_list_polyA).split(","))
    return PipelineConfig(
        upstream_buffer=int(args.upstream_buffer),
        downstream_buffer=int(args.downstream_buffer),
        minimum_ratio=float(args.minimum_ratio),
        minimum_internal_ratio=float(args.minimum_internal_ratio),
        minimum_reads=int(args.minimum_reads),
        overhangs=tuple(int(x) for x in str(args.overhangs).split(",")),
        minimum_isoform_length=int(args.minimum_isoform_length),
        minimum_feature_count=int(args.minimum_feature_count),
        splice_site_window=int(args.splice_site_window),
        acutoff=float(args.Acutoff),
        white_list_polyA=wl,
        multi_exon_only=bool(int(args.multi_exon_only)),
        junctions=tuple(str(args.junctions).split(",")),
        modules=str(args.Modules),
        threads=int(args.minimap2_threads),
        pacbio=bool(getattr(args, "pacbio", False)),
        align=AlignConfig(
            index_cache=str(getattr(args, "index_cache", "") or ""),
            index_backend=str(getattr(args, "index_backend",
                                      "replicated")),
            dp_backend=str(getattr(args, "dp_backend", "device")),
            chain_backend=str(getattr(args, "chain_backend", "device"))),
        poa=PoaConfig(
            engine=str(getattr(args, "consensus_engine", "graph")),
            backend=str(getattr(args, "consensus_backend", "auto"))),
    )
