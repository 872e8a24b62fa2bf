"""Isoform consensus calling (replaces `determine_consensus`,
SDC.py:876-931).

Per isoform: subsample up to max_reads (SEEDED — the reference's unseeded
np.random.choice permutes even below its cap, making its consensus fasta
nondeterministic; we pin input order for reproducibility, SURVEY §5.9),
orient every read against the first by minimizer-chain strand, then:
<=2 oriented reads -> the first oriented sequence (reference behavior);
otherwise POA consensus over the oriented set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mandalorion_tpu_torch.align.encode import encode, revcomp_codes
from mandalorion_tpu_torch.align.pairwise import OrientationAligner
from mandalorion_tpu_torch.config import PoaConfig
from mandalorion_tpu_torch.native import load_native
from mandalorion_tpu_torch.poa.graph import PoaParams
from mandalorion_tpu_torch.runtime import require_native

from mandalorion_tpu_torch.align.encode import decode as _decode


def _subsample(reads: Sequence[Tuple[str, str]], cfg: PoaConfig,
               rng: Optional[np.random.Generator]
               ) -> List[Tuple[str, str]]:
    if len(reads) > cfg.max_reads:
        gen = rng if rng is not None else np.random.default_rng(cfg.seed)
        pick = sorted(gen.choice(len(reads), cfg.max_reads, replace=False))
        return [reads[int(i)] for i in pick]
    return list(reads)


def _orient(subsample: Sequence[Tuple[str, str]]
            ) -> Tuple[List[np.ndarray], List[int]]:
    """Orient each read against the first by minimizer-chain strand
    (mappy `map-ont` orientation analogue, SDC.py:895-907)."""
    orienter = OrientationAligner(subsample[0][1])
    oriented: List[np.ndarray] = []
    lengths: List[int] = []
    for _name, seq in subsample:
        lengths.append(len(seq))
        strand = orienter.strand(seq)
        if strand is None:
            continue
        codes = encode(seq)
        oriented.append(codes if strand > 0 else revcomp_codes(codes))
    return oriented, lengths


def determine_consensus(
    reads: Sequence[Tuple[str, str]],
    cfg: Optional[PoaConfig] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[str, List[str]]:
    """Returns (consensus_sequence, ALL read names) — names always cover
    the full read list (reads2isoforms uses them all, SDC.py:880-882)."""
    cfg = cfg or PoaConfig()
    names = [name for name, _ in reads]
    subsample = _subsample(reads, cfg, rng)

    first_seq = subsample[0][1]

    if cfg.engine == "star":
        # the backbone alignment inside the star engine determines each
        # read's orientation itself (both strands are chained); a separate
        # orientation pass would be redundant work
        if len(subsample) <= 2:
            return first_seq, names
        from mandalorion_tpu_torch.poa.star import star_consensus
        cons_str = star_consensus([seq for _n, seq in subsample])
        if not cons_str:
            return first_seq, names
        return cons_str, names

    # graph engine: module D's job path on the native C++ engine (the
    # Python PoaGraph.align stays the bit-identical oracle for tests)
    jobs = _prepare_one(reads, cfg, subsample)
    return resolve_consensus_jobs(jobs)[0]


def _prepare_one(reads, cfg: PoaConfig,
                 subsample: Sequence[Tuple[str, str]]) -> List["ConsensusJob"]:
    """prepare_consensus_jobs for one already-subsampled isoform."""
    names = [name for name, _ in reads]
    first_seq = subsample[0][1]
    oriented, lengths = _orient(subsample)
    if not oriented:
        return [ConsensusJob(names, result=first_seq)]
    if len(oriented) <= 2:
        return [ConsensusJob(names, result=_decode(oriented[0]))]
    longest = max(len(c) for c in oriented)
    if longest > cfg.max_graph_len:
        if cfg.overlength_fallback == "star":
            # explicit opt-in: vote-engine consensus for monster isoforms
            from mandalorion_tpu_torch.poa.star import star_consensus
            cons_str = star_consensus([_decode(c) for c in oriented])
            return [ConsensusJob(names,
                                 result=cons_str or _decode(oriented[0]))]
        raise ValueError(
            f"isoform read of {longest} nt exceeds "
            f"PoaConfig.max_graph_len={cfg.max_graph_len}; raise the cap "
            "or set PoaConfig.overlength_fallback='star'")
    return [ConsensusJob(names, oriented=oriented,
                         params=_poa_params(cfg, lengths),
                         fallback=_decode(oriented[0]))]


def _poa_params(cfg: PoaConfig, lengths: Sequence[int]) -> PoaParams:
    # The score-following adaptive band is the production banding model at
    # EVERY length (abPOA's banded SIMD rows for short inserts and its -S
    # adaptive band for >=8 kb, SDC.py:915-919, both map onto it): the
    # band half-width stays cfg.band_width regardless of how far the
    # graph outgrows the query. The static diagonal band (adaptive=False)
    # must widen to |nodes - qlen| + 16 for correctness, which degrades
    # to full-width rows as reads accumulate — it remains available on
    # PoaParams for parity studies and produces identical consensi when
    # its band covers the optimal path (tests/test_poa.py).
    # half-width: abPOA's default band formula -b 10 -f 0.01 on the
    # median read length (band = 10 + 0.01 * len, floor 16), or the
    # explicit cfg.band_width override
    band = cfg.band_width or max(16, 10 + int(np.median(lengths)) // 100)
    return PoaParams(match=cfg.match, mismatch=cfg.mismatch,
                     gap_open=cfg.gap_open, gap_extend=cfg.gap_extend,
                     gap_open2=cfg.gap_open2, gap_extend2=cfg.gap_extend2,
                     band=band, adaptive=True)


@dataclass
class ConsensusJob:
    """One isoform's consensus work item, split so the host phase (rng
    subsample + orientation, fork-parallel per locus) can run apart from
    the batched device phase (graph DP across ALL loci at once). Either
    `result` is already resolved on the host, or `oriented`+`params`
    describe a pending graph-POA problem with `fallback` the
    empty-consensus fallback sequence (abPOA empty-output behavior)."""

    names: List[str]
    result: Optional[str] = None
    oriented: Optional[List[np.ndarray]] = None
    params: Optional[PoaParams] = None
    fallback: Optional[str] = None


def prepare_consensus_jobs(
    read_sets: Sequence[Sequence[Tuple[str, str]]],
    cfg: Optional[PoaConfig] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[ConsensusJob]:
    """Host phase of determine_consensus_batch: subsample (SAME rng
    consumption order as the sequential calls), orient, and resolve every
    isoform that never needs the graph DP (star engine, <=2 reads,
    over-length star fallback)."""
    cfg = cfg or PoaConfig()
    jobs: List[ConsensusJob] = []
    for reads in read_sets:
        if cfg.engine == "star":
            cons, names = determine_consensus(reads, cfg, rng)
            jobs.append(ConsensusJob(names, result=cons))
            continue
        subsample = _subsample(reads, cfg, rng)
        jobs.extend(_prepare_one(reads, cfg, subsample))
    return jobs


def graph_backend(backend: Optional[str] = None) -> str:
    """The backend that pending graph-POA jobs run on. None and 'auto'
    resolve as the reference's `_graph_backend`: 'native' (the C++ banded
    engine of native/poa.cpp) when the native library is loaded, 'device'
    under MANDO_TPU_NO_NATIVE. 'native' under the switch raises, naming
    it."""
    if backend in (None, "auto"):
        return "native" if load_native() is not None else "device"
    if backend not in ("native", "device"):
        raise ValueError(f"unknown consensus backend {backend!r}")
    if backend == "native":
        require_native("the native consensus backend "
                       "(--consensus_backend native)")
    return backend


def resolve_consensus_jobs(jobs: Sequence[ConsensusJob],
                           backend: Optional[str] = None, device="cuda",
                           threads: int = 1
                           ) -> List[Tuple[str, List[str]]]:
    """Compute phase: run every pending graph-POA job through `backend`
    (`graph_backend` resolves None and 'auto'): 'native', the C++ banded
    engine of native/poa.cpp, or 'device', batched kernel dispatches on
    `device` (poa/kernels.py) across whatever set of loci the jobs came
    from. The band half-width is a per-problem input there, so jobs are
    grouped by their params without the band: jobs whose bands differ
    (the band follows the median read length) share every round's
    dispatch; each chunk's host staging runs on `threads` threads
    (`poa_consensus_batch`). Both produce the same consensi."""
    import dataclasses
    import os
    backend = graph_backend(backend)
    if backend == "native":
        from concurrent.futures import ThreadPoolExecutor
        from mandalorion_tpu_torch.native import native_poa_consensus
        pending = [j for j in jobs if j.result is None]

        def run(job):
            cons = native_poa_consensus(job.oriented, job.params)
            job.result = _decode(cons) if len(cons) else job.fallback

        if len(pending) > 1 and (os.cpu_count() or 1) > 1:
            # the C engine releases the GIL for the whole consensus call,
            # so isoforms parallelize on plain threads (no fork hazard)
            with ThreadPoolExecutor(min(len(pending),
                                        os.cpu_count() or 1)) as pool:
                list(pool.map(run, pending))
        else:
            for job in pending:
                run(job)
        return [(job.result, job.names) for job in jobs]
    from mandalorion_tpu_torch.poa.kernels import poa_consensus_batch
    # MANDO_POA_SWEEP=1 (the reference's gate, read here and nowhere else):
    # tracebacks leave the device as run-compressed records
    walk = "sweep" if os.environ.get("MANDO_POA_SWEEP") == "1" else "steps"
    by_params: dict = {}
    for i, job in enumerate(jobs):
        if job.result is None:
            key = dataclasses.astuple(dataclasses.replace(job.params, band=0))
            by_params.setdefault(key, []).append(i)
    for ids in by_params.values():
        consensi = poa_consensus_batch(
            [jobs[i].oriented for i in ids], jobs[ids[0]].params, device,
            walk, bands=[jobs[i].params.band for i in ids], threads=threads)
        for i, cons in zip(ids, consensi):
            jobs[i].result = (_decode(cons) if len(cons)
                              else jobs[i].fallback)
    return [(job.result, job.names) for job in jobs]


def determine_consensus_batch(
    read_sets: Sequence[Sequence[Tuple[str, str]]],
    cfg: Optional[PoaConfig] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[Tuple[str, List[str]]]:
    """determine_consensus over many isoforms on the native engine.
    Results are identical to the sequential calls (the rng is consumed in
    the same isoform order)."""
    cfg = cfg or PoaConfig()
    if cfg.engine == "star" or len(read_sets) <= 1:
        return [determine_consensus(rs, cfg, rng) for rs in read_sets]
    return resolve_consensus_jobs(prepare_consensus_jobs(read_sets, cfg,
                                                         rng))
