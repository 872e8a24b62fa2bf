"""APDFQ stage implementations (counterpart of
mandalorion_tpu/pipeline/stages.py).

Stage-artifact contract mirrors the reference (`Mando.py:269,323-325`):
  tmp/mm2Alignments.psl            — extended PSL from module A
  tmp/mm2Alignments.clean.psl      — after small-gap merging
  tmp/mm2Alignments.clean.sorted.psl
  tmp/tmp_SS/<chrom>~<start>~<end>.psl — per-locus reads
  tmp/Isoform_Consensi.fasta, tmp/reads2isoforms.txt — module D
  tmp/Isoforms.filtered.* — module F; quant/tpm — module Q
Any suffix of APDFQ re-runs from these files (the -M checkpoint system,
SURVEY §5.4). If tmp/mm2Alignments.sam exists (external aligner interop),
module P converts it instead of requiring module A.

Routes. Module A runs `cfg.align`'s route (`align_route`): the host route
(native C++ in forked workers) when chain_backend and dp_backend are
'native' and 'numpy'; for every other pair a `TorchSpliceAligner` in
this process, with the chain kernel on `device` for chain 'device' and
the DP kernel for dp 'device' (its plain version on `device` for
'rowscan'; align/aligner.py's module docstring has the table). Module D's
graph consensus runs the backend that `poa.consensus.graph_backend`
resolves `cfg.poa.backend` to: the native C++ engine, or the batched POA
kernels on `device` (poa/kernels.py), in this process after the forked
prepare workers have returned. 'auto' is the native engine, and the
kernels under MANDO_TPU_NO_NATIVE (no native library: every stage then
runs its numpy twins and Python staging, the kernels stay on `device`).

Mesh. Under parallel.mesh.use_mesh (the CLI's --devices N) module A's
chain and DP dispatches, module D's POA chunks and module Q's count
matrix shard over the mesh, in this process only: no forked worker
issues a collective. index_backend 'sharded' under a mesh needs a route
other than the host route.

Forking. One rule, `_may_fork(runs_device_code)`: workers that run host
code only (module A's host route, P, D's prepare phase, F) may fork even
after CUDA is initialised, because they never touch the inherited CUDA
context; workers that would run device code ask `runtime.fork_ok()`,
which refuses once CUDA is initialised (a context does not survive
fork). Either kind needs a single-threaded parent. The threads of a
native call (module A's C seed stage on the device routes) are joined
before the call returns, so no fork meets them.
"""

from __future__ import annotations

import itertools
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from mandalorion_tpu_torch.align.aligner import (
    SpliceAligner, TorchSpliceAligner, align_backends)
from mandalorion_tpu_torch.config import PipelineConfig
from mandalorion_tpu_torch.core.cleanpsl import clean_psl_file, discover_loci
from mandalorion_tpu_torch.core.ends import define_start_end_sites
from mandalorion_tpu_torch.core.filtering import process_chromosome
from mandalorion_tpu_torch.core.genes import group_isoforms
from mandalorion_tpu_torch.core.peaks import (
    LocusReads, collect_reads, find_peaks, make_genome_bins)
from mandalorion_tpu_torch.core.quant import write_quant
from mandalorion_tpu_torch.core.splices import (
    build_splice_dict, sort_reads_into_splice_junctions)
from mandalorion_tpu_torch.io.fastx import (
    combine_fastx, expand_fofn, fastx_to_dict, read_fastx)
from mandalorion_tpu_torch.io.gtf import (
    parse_annotation, parse_gene_exons, write_gtf_from_psl)
from mandalorion_tpu_torch.io.psl import (
    PslRecord, format_psl, parse_psl_line, read_psl, sort_psl_file)
from mandalorion_tpu_torch.io.sam import sam_to_psl
from mandalorion_tpu_torch.parallel.mesh import pipeline_mesh
from mandalorion_tpu_torch.pipeline.observe import StageTimer, record, span
from mandalorion_tpu_torch.poa.consensus import (
    determine_consensus_batch, graph_backend)
from mandalorion_tpu_torch.runtime import fork_ok, resolve_device

VERSION = "mandalorion-tpu-torch 0.1.0"


@dataclass
class Paths:
    out: str

    @property
    def tmp(self) -> str:
        return os.path.join(self.out, "tmp")

    @property
    def tmp_ss(self) -> str:
        return os.path.join(self.tmp, "tmp_SS")

    def t(self, name: str) -> str:
        return os.path.join(self.tmp, name)

    def o(self, name: str) -> str:
        return os.path.join(self.out, name)


def _log(paths: Paths, cfg: PipelineConfig) -> None:
    os.makedirs(paths.tmp, exist_ok=True)
    with open(paths.o("Mando.log"), "a") as fh:
        fh.write(f"\n{VERSION} was run on "
                 f"{time.strftime('%Y-%m-%d %H:%M:%S')}\n"
                 f"with the following parameters\n{cfg}\n")


def _banner(title: str) -> None:
    print(f"\n{'-' * 44}\n    {title}\n{'-' * 44}")


def _pool_size(requested: int, n_jobs: int) -> int:
    """Workers beyond physical cores only add fork/contention overhead."""
    return max(1, min(requested, os.cpu_count() or 1, n_jobs))


def _may_fork(runs_device_code: bool = False) -> bool:
    """Whether a fork pool may start now (see the module docstring);
    otherwise the caller runs serially. The workers inherit big read-only
    state (the genome index) by copy-on-write, which spawn cannot
    replicate cheaply."""
    if runs_device_code:
        return fork_ok()
    return threading.active_count() == 1


ALIGN_ROUTES = {
    ("device", "device"): "device",
    ("device", "rowscan"): "device-chain/rowscan-dp",
    ("device", "numpy"): "device-chain/host-dp",
    ("native", "device"): "host-chain/device-dp",
    ("native", "rowscan"): "host-chain/rowscan-dp",
    ("native", "numpy"): "host",
}


def align_route(cfg) -> str:
    """Module A's route for an AlignConfig's (chain_backend, dp_backend):
    'host' for ('native', 'numpy'), the route that touches no device;
    every other pair runs on the device. ValueError on a backend name the
    port does not know."""
    return ALIGN_ROUTES[align_backends(cfg)]


# ------------------------------------------------------------- module A

def _pacbio_fa_path(paths: "Paths", index: int, bam_path: str) -> str:
    """Converted-BAM fasta path; the index prefix keeps same-basename BAMs
    from different directories distinct (modules A and Q must agree)."""
    base = os.path.basename(bam_path)
    if base.endswith(".bam"):
        base = base[:-4]
    return paths.t(f"pacbio{index}_{base}.fa")


_A_ALIGNER: Optional[SpliceAligner] = None


def _align_chunk_worker(job) -> str:
    """Fork-pool worker: align one slice of the combined fasta with the
    inherited index and write its own part-file. The job carries only
    (path, record range[, byte offset]) — shipping sequences or PSL text
    through the pool pipes would pickle hundreds of MB at 100k-read
    scale. With a byte offset (plain input, scan_record_offsets) the
    worker seeks straight to its slice; otherwise (gzip) it skip-parses
    the records before it."""
    import itertools
    combined, rec_lo, rec_hi, part_path, byte_off = job
    if byte_off >= 0:
        from mandalorion_tpu_torch.io.fastx import read_fastx_slice
        records = read_fastx_slice(combined, byte_off, rec_hi - rec_lo)
    else:
        records = itertools.islice(read_fastx(combined), rec_lo, rec_hi)
    batch = [(name, seq) for name, seq, _q in records]
    with open(part_path, "w") as out:
        for rec in _A_ALIGNER.map_batch(batch):
            out.write(format_psl(rec) + "\n")
    return part_path


def module_a(paths: Paths, cfg: PipelineConfig, fasta_files: str,
             genome_path: str,
             aligner: Optional[SpliceAligner] = None) -> None:
    _banner("Module A - Alignment")
    fasta_list = expand_fofn(fasta_files)
    if cfg.pacbio:
        from mandalorion_tpu_torch.io.bam import bam_to_fasta
        print("\tConverting PacBio BAM input to FASTA")
        converted = []
        for k, bam in enumerate(fasta_list):
            out_fa = _pacbio_fa_path(paths, k, bam)
            bam_to_fasta(bam, out_fa)
            converted.append(out_fa)
        fasta_list = converted
    with span("align.read"):
        combined, ok = combine_fastx(fasta_list,
                                     paths.t("Combined.fasta"))
    if not ok:
        print("\t no reads were provided. Alignment will not be performed")
        return
    if aligner is None:
        print("\tbuilding genome index")
        aligner = SpliceAligner(fastx_to_dict(genome_path), cfg.align)
    t0 = time.time()
    # one binary scan gives the record count AND per-record byte offsets
    # (plain files) so pool workers can seek to their slice; gzipped
    # pass-through inputs fall back to counting + worker skip-parse
    from mandalorion_tpu_torch.io.fastx import scan_record_offsets
    with span("align.read"):
        offsets = scan_record_offsets(combined)
        n_reads = (len(offsets) if offsets is not None
                   else sum(1 for _ in read_fastx(combined)))
    # a few jobs per worker: balances load; plain files address slices by
    # byte offset (workers seek), .gz inputs fall back to record counts
    # plus a worker-side islice skip-parse
    workers = _pool_size(cfg.threads, n_reads)
    chunk = max(cfg.align.batch_reads,
                (n_reads + workers * 3 - 1) // (workers * 3))
    n_jobs = (n_reads + chunk - 1) // chunk
    with open(paths.t("mm2Alignments.psl"), "w") as out:
        if cfg.threads > 1 and n_jobs > 1 and _may_fork(
                isinstance(aligner, TorchSpliceAligner)):
            # fork workers inherit the index copy-on-write and read their
            # own record slice of the combined fasta; this is the
            # data-parallel 'reads' axis on a single host (SURVEY §2.3)
            import multiprocessing as mp
            global _A_ALIGNER
            _A_ALIGNER = aligner
            ctx = mp.get_context("fork")
            jobs = [(combined, k * chunk, min((k + 1) * chunk, n_reads),
                     paths.t(f"mm2Alignments.part{k}.psl"),
                     offsets[k * chunk] if offsets is not None else -1)
                    for k in range(n_jobs)]
            with ctx.Pool(_pool_size(cfg.threads, n_jobs)) as pool:
                for part in pool.imap(_align_chunk_worker, jobs):
                    with span("align.write"):
                        with open(part) as pf:
                            shutil.copyfileobj(pf, out)
                        os.remove(part)
        else:
            records = read_fastx(combined)
            while True:
                with span("align.read") as s:
                    batch = [(name, seq) for name, seq, _q in
                             itertools.islice(records, chunk)]
                    s.items = len(batch)
                if not batch:
                    break
                recs = aligner.map_batch(batch)
                with span("align.write", len(recs)):
                    for rec in recs:
                        out.write(format_psl(rec) + "\n")
    dt = time.time() - t0
    print(f"\taligned {n_reads} reads in {dt:.1f}s "
          f"({n_reads / max(dt, 1e-9):.1f} reads/s)")
    if cfg.align.emit_sam:
        from mandalorion_tpu_torch.io.psl import read_psl
        from mandalorion_tpu_torch.io.sam import write_sam
        sizes = {n: int(z) for n, z in zip(aligner.index.chrom_names,
                                           aligner.index.chrom_sizes)}
        with span("align.write"):
            write_sam(paths.t("mm2Alignments.sam"),
                      read_psl(paths.t("mm2Alignments.psl")), sizes)


# ------------------------------------------------------------- module P

def module_p(paths: Paths, cfg: PipelineConfig,
             defer_checkpoints: bool = False):
    """Clean + sort + locus-split. With defer_checkpoints=True (the
    in-process pipeline driver) the clean.psl / clean.sorted.psl resume
    checkpoints write in a background fork overlapped with module D, and
    the returned process handle must be joined before the run ends —
    only the locus files (what D consumes) are written synchronously.
    Returns the writer handle or None."""
    _banner("Module P - psl cleaning, sorting, locus split")
    psl = paths.t("mm2Alignments.psl")
    sam = paths.t("mm2Alignments.sam")
    if not os.path.exists(psl) or os.path.getsize(psl) == 0:
        if os.path.exists(sam) and os.path.getsize(sam) > 0:
            print("\tconverting external SAM to extended psl")
            sam_to_psl(sam, psl, mando=True,
                       threads=cfg.threads if _may_fork() else 1)
        else:
            print("\tno alignments found; skipping")
            return None
    print("\tcleaning, sorting and splitting psl (one pass)")
    if os.path.isdir(paths.tmp_ss):
        shutil.rmtree(paths.tmp_ss)
    if cfg.threads > 1 and _may_fork():
        # sharded parse (module A's byte-range pattern): byte-identical
        # to the serial path at any worker count
        from mandalorion_tpu_torch.core.cleanpsl import clean_sort_split_parallel
        res = clean_sort_split_parallel(
            psl, paths.t("mm2Alignments.clean.psl"),
            paths.t("mm2Alignments.clean.sorted.psl"),
            paths.tmp_ss, cfg.minimum_intron_size, threads=cfg.threads,
            defer_checkpoints=defer_checkpoints)
        if isinstance(res, tuple):
            return res[1]
    else:
        from mandalorion_tpu_torch.core.cleanpsl import clean_sort_split
        clean_sort_split(psl, paths.t("mm2Alignments.clean.psl"),
                         paths.t("mm2Alignments.clean.sorted.psl"),
                         paths.tmp_ss, cfg.minimum_intron_size)
    return None


# ------------------------------------------------------------- module D

def _locus_worker(locus_psl, chrom, lb, rb, cfg):
    """Picklable per-locus job for the worker pool; workers are seeded
    from the pipeline seed (the reference is unseeded here, SURVEY §5.9).
    Returns (results, the locus' end-calling stats)."""
    stats: dict = {}
    return process_locus(locus_psl, chrom, lb, rb, cfg,
                         np.random.default_rng(cfg.seed),
                         stats=stats), stats


def _locus_prepare_worker(locus_psl, chrom, lb, rb, cfg):
    """Like _locus_worker but stops after the host consensus phase,
    returning ConsensusJobs; the graph DPs then batch across ALL loci in
    the parent (one shared device dispatch set per round instead of one
    small set per locus)."""
    stats: dict = {}
    return process_locus(locus_psl, chrom, lb, rb, cfg,
                         np.random.default_rng(cfg.seed),
                         prepare_jobs=True, stats=stats), stats


def process_locus(locus_psl: str, chrom: str, left_bounds: Dict[str, List[int]],
                  right_bounds: Dict[str, List[int]], cfg: PipelineConfig,
                  rng: Optional[np.random.Generator] = None,
                  prepare_jobs: bool = False,
                  stats: Optional[dict] = None):
    """One locus: peaks → junction identities → isoforms → consensus.
    Returns [(consensus_sequence, [read names]), ...] in isoform order;
    with prepare_jobs=True, the pending ConsensusJobs instead (same rng
    consumption, device phase deferred to the caller). `stats`, when
    given, gains the end calling's seconds ("ends_s"), the isoform groups
    it formed ("groups") and the identities it split ("end_splits")."""
    records = [parse_psl_line(l) for l in open(locus_psl) if l.strip()]
    reads = LocusReads.from_records(records)
    hist = collect_reads(reads, cfg.accuracy_gate)
    areas_l: set = set()
    areas_r: set = set()
    rows_a_l = make_genome_bins(left_bounds, "l", chrom, areas_l,
                                cfg.splice_site_window)
    rows_a_r = make_genome_bins(right_bounds, "r", chrom, areas_r,
                                cfg.splice_site_window)
    rows_n_l = find_peaks(hist, "l", chrom, areas_l, cfg.locus_cutoff,
                          cfg.splice_site_window, cfg.minimum_feature_count,
                          cfg.junctions, rng, cfg.splice_check_subsample,
                          cfg.motif_fraction, cfg.flank_accuracy)
    rows_n_r = find_peaks(hist, "r", chrom, areas_r, cfg.locus_cutoff,
                          cfg.splice_site_window, cfg.minimum_feature_count,
                          cfg.junctions, rng, cfg.splice_check_subsample,
                          cfg.motif_fraction, cfg.flank_accuracy)
    splice = build_splice_dict([rows_a_l, rows_a_r, rows_n_l, rows_n_r])
    spliced, mono = sort_reads_into_splice_junctions(
        splice, reads, chrom, cfg.junction_gap)
    t0 = time.perf_counter()
    iso = define_start_end_sites(
        spliced, mono, reads, cfg.upstream_buffer, cfg.downstream_buffer,
        cfg.minimum_feature_count, rng, cfg.ends_subsample, stats)
    if stats is not None:
        stats["ends_s"] = time.perf_counter() - t0
        stats["groups"] = len(iso)
    read_sets = [[(reads.names[i], reads.sequences[i])
                  for i in iso[key].read_indices] for key in iso]
    if prepare_jobs:
        from mandalorion_tpu_torch.poa.consensus import prepare_consensus_jobs
        return prepare_consensus_jobs(read_sets, cfg.poa, rng)
    # graph engine: all of the locus' seq-to-graph DPs batch into shared
    # device dispatches; star engine: per-isoform fast path (unchanged)
    return determine_consensus_batch(read_sets, cfg.poa, rng)


def module_d(paths: Paths, cfg: PipelineConfig, annotation_path: str,
             sorted_psl_pending: bool = False, device="cuda") -> None:
    _banner("Module D - defining isoforms")
    sorted_psl = paths.t("mm2Alignments.clean.sorted.psl")
    # sorted_psl_pending: the in-process driver just ran module P with
    # the checkpoint writer still in flight — the gate's purpose (catch
    # an alignment-less resume) is already answered
    if not sorted_psl_pending and (
            not os.path.exists(sorted_psl)
            or os.path.getsize(sorted_psl) == 0):
        print("\tclean sorted psl file missing or empty")
        return
    with span("define.prepare") as s:
        jobs = _locus_jobs(paths, cfg, annotation_path)
        s.items = len(jobs)
        graph_engine = cfg.poa.engine == "graph"
        worker = _locus_prepare_worker if graph_engine else _locus_worker
        if cfg.threads > 1 and len(jobs) > 1 and _may_fork():
            import multiprocessing as mp
            ctx = mp.get_context("fork")
            with ctx.Pool(_pool_size(cfg.threads, len(jobs)),
                          maxtasksperchild=8) as pool:
                all_results = pool.starmap(worker, jobs)
        else:
            all_results = [worker(*j) for j in jobs]
        # the end calling, timed in the workers: worker seconds summed
        # over loci, and the isoform groups formed
        record("define.ends", sum(st["ends_s"] for _r, st in all_results),
               sum(st["groups"] for _r, st in all_results))
        # a count: the splice groups that end calling split
        record("define.end_splits",
               items=sum(st.get("end_splits", 0) for _r, st in all_results))
        all_results = [r for r, _st in all_results]
    if graph_engine:
        # compute phase, in this process: with the device backend the
        # pending graph DPs of ALL loci resolve in shared batched
        # dispatches (bit-identical to per-locus resolves; grouping only
        # changes padding); the device rounds' host staging on -t threads
        from mandalorion_tpu_torch.poa.consensus import resolve_consensus_jobs
        flat = [job for locus_jobs in all_results for job in locus_jobs]
        with span("define.resolve", len(flat)):
            resolved = iter(resolve_consensus_jobs(
                flat, backend=graph_backend(cfg.poa.backend), device=device,
                threads=max(1, min(cfg.threads, os.cpu_count() or 1))))
        all_results = [[next(resolved) for _ in locus_jobs]
                       for locus_jobs in all_results]

    with span("define.write") as s:
        counter = 0
        with open(paths.t("Isoform_Consensi.fasta"), "w") as out, \
                open(paths.t("reads2isoforms.txt"), "w") as r2i:
            for results in all_results:  # deterministic sorted-locus order
                for consensus, names in results:
                    counter += 1
                    iso_name = f"Isoform{counter}_{len(names)}"
                    out.write(f">{iso_name}\n{consensus}\n")
                    for name in names:
                        r2i.write(f"{name}\t{iso_name}\n")
        shutil.copy(paths.t("reads2isoforms.txt"),
                    paths.o("Mando_isoforms.read_stat.txt"))
        s.items = counter
    print(f"\t{counter} isoform consensi written")


def _locus_jobs(paths: Paths, cfg: PipelineConfig,
                annotation_path: str) -> list:
    """Module D's locus jobs (locus psl, chrom, left and right annotated
    bounds, cfg), after the annotation parse and the poly(A) whitelist
    bed."""
    whitelist_on = "0" not in cfg.white_list_polyA
    if annotation_path not in (None, "None") and (
            annotation_path.endswith(".gtf")
            or annotation_path.endswith(".gtf.gz")):
        print("\tparsing annotated splice sites")
        ann = parse_annotation(annotation_path, list(cfg.white_list_polyA))
    else:
        print("\tno annotation; splice sites will be read derived")
        ann = None
    with open(paths.t("polyAWhiteList.bed"), "w") as bed:
        if whitelist_on and ann is not None:
            print(f"\t{len(ann.polya_whitelist)} poly(A) sites whitelisted")
            for chrom, direction, end, tid in ann.polya_whitelist:
                p = int(end)
                bed.write(f"{chrom}\t{p - cfg.whitelist_pad}\t"
                          f"{p + cfg.whitelist_pad}\t{tid}\t0\t{direction}\n")
    roots = discover_loci(paths.tmp_ss)
    print(f"\tprocessing {len(roots)} loci on {cfg.threads} workers")
    jobs = []
    for root in roots:
        chrom, start, end = root.split("~")
        start, end = int(start), int(end)
        lb = {"5": [], "3": []}
        rb = {"5": [], "3": []}
        if ann is not None and chrom in ann.left_bounds:
            for side in ("5", "3"):
                lb[side] = [p for p in ann.left_bounds[chrom][side]
                            if start < p < end]
                rb[side] = [p for p in ann.right_bounds[chrom][side]
                            if start < p < end]
        jobs.append((os.path.join(paths.tmp_ss, root + ".psl"), chrom,
                     lb, rb, cfg))
    return jobs


# ------------------------------------------------------------- module F

def _filter_chrom_worker(chrom, clean_psl, chr_seq, polya_bed, cfg):
    """Picklable per-chromosome filter job: returns (kept names, psl lines,
    filter-reason log text, the rules' stats)."""
    parts: List[str] = []
    stats: dict = {}
    kept, table = process_chromosome(chrom, clean_psl, chr_seq, polya_bed,
                                     cfg, lambda m: parts.append(m + "\n"),
                                     stats)
    lines = {name: "\t".join(table.lines[name]) for name in kept}
    return kept, lines, "".join(parts), stats


def _record_filter_rules(chrom_results: list) -> None:
    """Module F's rules as spans, timed in the chromosome jobs (worker
    seconds, summed over chromosomes): `filter.ratio` and
    `filter.contain`, each with the isoforms it kept; and a count of each
    rule's drops, `filter.drop.<rule>`."""
    stats = [r[3] for r in chrom_results]
    for rule in ("ratio", "contain"):
        record(f"filter.{rule}", sum(st[f"{rule}_s"] for st in stats),
               sum(st[f"{rule}_kept"] for st in stats))
    for rule in ("absolute", "ratio", "polya", "internal", "identical"):
        record(f"filter.drop.{rule}",
               items=sum(st["drops"][rule] for st in stats))


def module_f(paths: Paths, cfg: PipelineConfig, genome_path: str,
             annotation_path: str,
             aligner: Optional[SpliceAligner] = None) -> None:
    _banner("Module F - filtering isoforms")
    consensi = paths.t("Isoform_Consensi.fasta")
    if not os.path.exists(consensi) or os.path.getsize(consensi) == 0:
        print("\tisoforms fasta missing or empty")
        return
    with span("filter.genome"):
        genome = fastx_to_dict(genome_path)
        isoforms = fastx_to_dict(consensi)
    # a run's isoform set is a handful of sequences — device dispatch
    # latency would dominate, so this stage always uses the host
    # backends. The DP backends are bit-identical; the two chain
    # backends agree up to transcendental-ulp log2 differences
    # (CLAUDE.md), so the host result here is the canonical
    # reference-parity output.
    with span("filter.realign", len(isoforms)):
        if aligner is None:
            aligner = SpliceAligner(genome, cfg.align)
        aligner = aligner.host_twin()
        print("\taligning isoform consensus sequences")
        with open(paths.t("Isoforms.aligned.out.psl"), "w") as out:
            items = list(isoforms.items())
            for i in range(0, len(items), cfg.align.batch_reads):
                for rec in aligner.map_batch(
                        items[i:i + cfg.align.batch_reads]):
                    rec = PslRecord(**{**rec.__dict__})
                    rec.accuracy = rec.cs = rec.sequence = None  # 21-col
                    out.write(format_psl(rec) + "\n")
    with span("filter.chroms"):
        clean_psl_file(paths.t("Isoforms.aligned.out.psl"),
                       paths.t("Isoforms.aligned.out.clean.psl"), False,
                       cfg.minimum_intron_size)
        chromosomes = sorted({line.split("\t")[13] for line in
                              open(paths.t("Isoforms.aligned.out.clean.psl"))
                              if line.strip()})
        jobs = [(chrom, paths.t("Isoforms.aligned.out.clean.psl"),
                 genome.get(chrom, ""), paths.t("polyAWhiteList.bed"), cfg)
                for chrom in chromosomes]
        if cfg.threads > 1 and len(jobs) > 1 and _may_fork():
            # per-chromosome fan-out, ordered merge
            # (filterIsoforms.py:497-509)
            import multiprocessing as mp
            ctx = mp.get_context("fork")
            with ctx.Pool(_pool_size(cfg.threads, len(jobs))) as pool:
                chrom_results = pool.starmap(_filter_chrom_worker, jobs)
        else:
            chrom_results = [_filter_chrom_worker(*j) for j in jobs]
        _record_filter_rules(chrom_results)

    with span("filter.write"):
        _filter_outputs(paths, annotation_path, isoforms, chrom_results)


def _filter_outputs(paths: Paths, annotation_path: str,
                    isoforms: Dict[str, str], chrom_results: list) -> None:
    """Module F's outputs from the per-chromosome results: the kept
    isoforms' fasta and psl, the reasons, the GTF, the sorted psl and the
    gene grouping, then their copies in the output directory."""
    with open(paths.t("filter_reasons.txt"), "w") as reasons, \
            open(paths.t("Isoforms.filtered.fasta"), "w") as ffa, \
            open(paths.t("Isoforms.filtered.clean.psl"), "w") as fpsl:
        for kept, lines, reason_log, _stats in chrom_results:
            reasons.write(reason_log)
            for name in kept:
                ffa.write(f">{name}\n{isoforms[name]}\n")
                fpsl.write(lines[name] + "\n")
    write_gtf_from_psl(paths.t("Isoforms.filtered.clean.psl"),
                       paths.t("Isoforms.filtered.clean.gtf"))
    sort_psl_file(paths.t("Isoforms.filtered.clean.psl"),
                  paths.t("Isoforms.sorted.psl"))
    print("\tgrouping isoforms and assigning genes")
    coord = parse_gene_exons(annotation_path)
    group_isoforms(paths.t("Isoforms.sorted.psl"),
                   paths.t("Isoforms.filtered.clean.genes"), coord)
    for name in ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
                 "Isoforms.filtered.clean.gtf",
                 "Isoforms.filtered.clean.genes"):
        shutil.copy(paths.t(name), paths.o(name))


# ------------------------------------------------------------- module Q

def module_q(paths: Paths, cfg: PipelineConfig, fasta_files: str) -> None:
    _banner("Module Q - quantifying isoforms")
    for needed in ("Isoforms.filtered.clean.psl", "reads2isoforms.txt"):
        p = paths.t(needed)
        if not os.path.exists(p):
            # module-gate in the style of A/D/F (the reference's Q crashes
            # here; skipping with a message is strictly kinder)
            print(f"\t{p} missing; quantification not performed")
            return
    fasta_list = expand_fofn(fasta_files)
    if cfg.pacbio:
        # quantify against the fastas module A converted from the BAMs
        # (assignReadsToIsoforms.py:97-98)
        fasta_list = [_pacbio_fa_path(paths, k, x)
                      for k, x in enumerate(fasta_list)]
    write_quant(paths.t("Isoforms.filtered.clean.psl"),
                paths.t("reads2isoforms.txt"), fasta_list,
                paths.t("Isoforms.filtered.clean.quant"),
                paths.t("Isoforms.filtered.clean.tpm"))
    shutil.copy(paths.t("Isoforms.filtered.clean.quant"),
                paths.o("Isoforms.filtered.clean.quant"))
    shutil.copy(paths.t("Isoforms.filtered.clean.tpm"),
                paths.o("Isoforms.filtered.clean.tpm"))


# --------------------------------------------------------------- driver

def run_pipeline(out_path: str, genome_path: str, annotation_path: str,
                 fasta_files: str, cfg: Optional[PipelineConfig] = None,
                 device="cuda") -> Paths:
    """Run APDFQ (or cfg.modules). `device` ('cuda' or 'cpu') serves the
    device routes (see the module docstring) and is resolved only when
    one is selected, so a run on the host routes never touches CUDA."""
    cfg = cfg or PipelineConfig()
    on_device = align_route(cfg.align) != "host"
    if not on_device and cfg.align.index_backend == "sharded" \
            and pipeline_mesh() is not None:
        raise ValueError("index_backend='sharded' under a mesh needs a "
                         "device route: chain_backend 'device' with any "
                         "dp_backend, or dp_backend 'device' or 'rowscan' "
                         "with any chain_backend. The host route "
                         "(chain_backend 'native', dp_backend 'numpy') "
                         "runs in forked workers, which hold no mesh")
    uses_device = on_device or graph_backend(cfg.poa.backend) == "device"
    if uses_device:
        device = resolve_device(device)
    paths = Paths(out_path)
    os.makedirs(paths.tmp, exist_ok=True)
    _log(paths, cfg)
    timer = StageTimer(paths.t("timing.tsv"),
                       device=device if uses_device else None)
    with timer:
        _run_stages(timer, paths, genome_path, annotation_path, fasta_files,
                    cfg, device, on_device)
    print("\n\tstage timing:")
    print(timer.summary())
    return paths


def _run_stages(timer: StageTimer, paths: Paths, genome_path: str,
                annotation_path: str, fasta_files: str, cfg: PipelineConfig,
                device, on_device: bool) -> None:
    """run_pipeline's stages, APDFQ or cfg.modules, each timed by
    `timer`."""
    aligner: Optional[SpliceAligner] = None
    if "A" in cfg.modules or "F" in cfg.modules:
        with timer.stage("index_build"):
            with span("index.genome"):
                genome = fastx_to_dict(genome_path)
            with span("index.load"):
                aligner = (TorchSpliceAligner(genome, cfg.align,
                                              device=device,
                                              threads=cfg.threads)
                           if on_device else SpliceAligner(genome, cfg.align))
    if "A" in cfg.modules:
        with timer.stage("A_alignment"):
            # a route on the device: one process (a CUDA context does not
            # survive fork), whose read batch then grows to
            # max(batch_reads, n_reads / 3) and whose C seed stage runs on
            # the aligner's cfg.threads threads; host route: cfg.threads
            # forked workers
            module_a(paths, cfg.replace(threads=1) if on_device
                     else cfg, fasta_files, genome_path, aligner)
    p_writer = None
    try:
        if "P" in cfg.modules:
            with timer.stage("P_parsing"):
                p_writer = module_p(paths, cfg, defer_checkpoints=True)
        if "D" in cfg.modules:
            with timer.stage("D_define"):
                module_d(paths, cfg, annotation_path,
                         sorted_psl_pending=p_writer is not None,
                         device=device)
    finally:
        if p_writer is not None:
            # the -M checkpoint writer overlapped module D; it must be
            # on disk before the run is considered complete
            with span("checkpoint_wait"):
                p_writer.join()
    if p_writer is not None and p_writer.exitcode != 0:
        raise RuntimeError(f"module P checkpoint writer failed (exit code "
                           f"{p_writer.exitcode}): clean.psl / "
                           f"clean.sorted.psl may be incomplete")
    if "F" in cfg.modules:
        with timer.stage("F_filter"):
            module_f(paths, cfg, genome_path, annotation_path, aligner)
    if "Q" in cfg.modules:
        with timer.stage("Q_quant"):
            module_q(paths, cfg, fasta_files)
