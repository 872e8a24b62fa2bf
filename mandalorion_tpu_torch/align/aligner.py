"""Splice-aware read-to-genome aligner (minimap2 `-ax splice:hq --cs=long
-uf -G 400k --secondary=no` replacement, `Mando.py:316-319`): the host
class `SpliceAligner` and `TorchSpliceAligner`, which runs the routes
that touch a device.

Counterpart of mandalorion_tpu/align/aligner.py. Per read the host class
runs seed -> chain -> gap fill -> DP -> extended-PSL emission in the
native C++ library. `TorchSpliceAligner.map_batch` runs the route that
the configuration's (chain_backend, dp_backend) pair names, as the
reference's `SpliceAligner.map_batch` does:

- chain 'device' (any DP): the staged route (the reference's
  `_map_batch_device_staged`), per batch

      C seed (native_stage_seed_batch) -> chain DP (chain_kernel.chain_rows)
        -> C fill (native_stage_fill_batch)
        -> affine-gap DP + traceback (kernels.solve_dp_fused)
        -> C emit (native_stage_emit_batch)

  where DP 'device' launches csrc/dp.cu, 'rowscan' runs its plain
  version on the device, and 'numpy' leaves every problem to the emit
  stage's host solver;
- chain 'native' with DP 'device' or 'rowscan': per read the native
  seed + chain (`_chain_both`) and the Python gap fill (`_fill`), then
  the batch's DP problem list through `kernels.solve_dp_device`, then
  `_emit` (the reference's Python-staged route);
- chain 'native' with DP 'numpy': the host class's fused C call a read
  (on the replicated index).

Under MANDO_TPU_NO_NATIVE (no native library loaded), and on an index
without a bucket table (`bucket_lo` None: a caller's own GenomeIndex, or
a directory index cache without bucket_lo.npy), every route runs the
reference's Python staging (`numpy_seeding`): seeding an orientation at
a time (`minimizers`, `GenomeIndex.lookup`'s numpy branch,
`collapse_anchors`), `_fill`, the DP problem list through the DP backend,
`_emit`; without the library the numpy twins stand in for the C stages
(`solve_dp_numpy` for 'numpy', `_runs_to_psl_numpy`). Chain 'device'
then runs every candidate of the batch through
`chain_kernel.chain_batch_segments` (the reference's
`_chain_batch_device`); chain 'native' runs `chain_segments` a
candidate on the host. The kernels stay on `device`.

The index's uint8 sequence codes are uploaded to the device once and stay
there. Every route gives byte-identical records.

Under a pipeline mesh (parallel.mesh.use_mesh) the chain and DP
dispatches shard over the mesh's devices (the genome codes are uploaded
once to each), and with index_backend 'sharded' the seed lookups run
against hash-range index shards on those devices (`sharded_seed_hits`)
before the C stage collapses and packs their anchors
(native_stage_seed_anchors): the same candidates, the same records.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mandalorion_tpu_torch.align.chain import (
    Segment, chain_segments, collapse_anchors)
from mandalorion_tpu_torch.align.chain_kernel import (
    chain_batch_rows, chain_batch_segments)
from mandalorion_tpu_torch.align.encode import (
    decode, encode, minimizers, revcomp_codes)
from mandalorion_tpu_torch.align.extend import (
    DpProblem, DpResult, solve_dp_native, splice_fill)
from mandalorion_tpu_torch.align.index import (
    ANCHOR_BUDGET, cached_index, frequency_occ_cap)
from mandalorion_tpu_torch.align.kernels import (
    solve_dp_device, solve_dp_fused)
from mandalorion_tpu_torch.config import AlignConfig
from mandalorion_tpu_torch.io.psl import PslRecord
from mandalorion_tpu_torch.native import (
    load_native, native_align_read, native_align_read_runs, native_emit_psl,
    native_seed_chain2, native_stage_emit_batch, native_stage_fill_batch,
    native_stage_seed_anchors, native_stage_seed_batch)
from mandalorion_tpu_torch.parallel.dist import (
    IndexShards, place_index_shards, shard_index_arrays)
from mandalorion_tpu_torch.parallel.mesh import pipeline_mesh
from mandalorion_tpu_torch.pipeline.observe import span
from mandalorion_tpu_torch.runtime import require_native, resolve_device


CHAIN_BACKENDS = ("device", "native")
DP_BACKENDS = ("device", "rowscan", "numpy")


def genome_tensor(codes: np.ndarray, device: torch.device) -> torch.Tensor:
    """The genome codes on `device`. A writable array is shared on the CPU
    and copied once to a card; a read-only one (a directory index cache,
    memory-mapped) is copied first, so that no tensor aliases the
    mapping."""
    if not codes.flags.writeable:
        codes = np.array(codes)
    return torch.from_numpy(codes).to(device)


def align_backends(cfg) -> Tuple[str, str]:
    """cfg's (chain_backend, dp_backend); ValueError on a name the port
    does not know."""
    chain, dp = cfg.chain_backend, cfg.dp_backend
    if chain not in CHAIN_BACKENDS or dp not in DP_BACKENDS:
        raise ValueError(
            f"chain_backend={chain!r}, dp_backend={dp!r}: the port knows "
            f"chain {CHAIN_BACKENDS} x dp {DP_BACKENDS} (the reference's "
            f"dp 'pallas' is 'device' here)")
    return chain, dp


@dataclass
class _Pending:
    """A read alignment awaiting batched DP results."""

    name: str
    seq: str
    strand: str
    q_codes: np.ndarray            # aligned-orientation query codes
    chrom_idx: int
    ops: List[Tuple[str, int, int, int]]  # (kind, q0, t0, length) + DP slots
    dp_slots: List[int]            # indices into the batch problem list


class SpliceAligner:
    """Genome-indexed splice aligner on the host (native C++ seeding,
    chaining and DP; the Python staging under `numpy_seeding`). Thread
    the same instance through batches."""

    def __init__(self, genome: Dict[str, str],
                 cfg: Optional[AlignConfig] = None):
        self.cfg = cfg or AlignConfig()
        self.index = cached_index(genome, self.cfg.kmer, self.cfg.window,
                                  self.cfg.index_cache)
        # minimap2 -f analogue: raise the seed occurrence cap to the
        # index's top-frequency quantile so repeat/tandem regions seed
        self.max_occ = frequency_occ_cap(self.index, self.cfg.occ_frac,
                                         self.cfg.max_occ)

    def host_twin(self) -> "SpliceAligner":
        """An aligner sharing this instance's index that computes on the
        host. For tiny batches (module F realigns a handful of isoform
        consensi) a device round trip per dispatch dominates the work
        itself; the routes are byte-identical, so this changes no
        output. No index rebuild."""
        return self

    # ------------------------------------------------------------ seeding

    def numpy_seeding(self) -> bool:
        """Whether module A seeds in numpy and stages in Python: this
        process has no native library (MANDO_TPU_NO_NATIVE), or this
        index has no bucket table, which every native seeding call
        reads."""
        return load_native() is None or self.index.bucket_lo is None

    def _chain_both(self, codes: np.ndarray):
        """Best chain over both read orientations (forward wins score
        ties): (chain, strand, chrom_idx, oriented query codes), or None
        when neither orientation chains. The native seed + chain in one
        call, or under `numpy_seeding` the numpy seeding
        (`_orientation_segments`) chained on the host (`_host_pick`)."""
        if self.numpy_seeding():
            return self._host_pick(codes, *self._orientation_segments([codes]))
        cfg = self.cfg
        idx = self.index
        q0, qe, t0, te, _score, ci, strand = native_seed_chain2(
            codes, cfg.kmer, cfg.window, self.max_occ, 100,
            idx.sorted_hashes, idx.bucket_lo, idx.bucket_bits,
            idx.sorted_positions, idx.chrom_offsets, cfg.min_intron,
            cfg.max_intron)
        if strand < 0 or len(q0) == 0:
            return None
        chain = [Segment(int(a), int(b), int(c), int(d))
                 for a, b, c, d in zip(q0, qe, t0, te)]
        if strand == 0:
            return chain, "+", ci, codes
        return chain, "-", ci, revcomp_codes(codes)

    def _anchors(self, code_list: List[np.ndarray]):
        """Every orientation's anchors, `GenomeIndex.lookup` an
        orientation (the reference's seeding without its native library):
        orientation 2r + s (s = 0 forward, 1 reverse) of read r holds
        anchors off[2r+s]:off[2r+s+1] of (anchor_q, anchor_g). Returns
        (off, anchor_q, anchor_g)."""
        cfg = self.cfg
        q_parts, g_parts = [], []
        for codes in code_list:
            for qc in (codes, revcomp_codes(codes)):
                pos, hashes = minimizers(qc, cfg.kmer, cfg.window)
                qidx, gpos = self.index.lookup(hashes, self.max_occ)
                q_parts.append(pos[qidx])
                g_parts.append(gpos)
        off = np.zeros(len(q_parts) + 1, np.int64)
        np.cumsum([len(q) for q in q_parts], out=off[1:])
        empty = np.zeros(0, np.int64)
        return (off, np.concatenate(q_parts) if q_parts else empty,
                np.concatenate(g_parts) if g_parts else empty)

    def _orientation_segments(self, code_list: List[np.ndarray]
                              ) -> List[List[Tuple[int, List[Segment]]]]:
        """Each orientation's candidates from its anchors (`_anchors`):
        entry 2r + s is read r's orientation s as [(chrom, segment list)],
        chromosomes ascending, anchors collapsed in Python."""
        off, anchor_q, anchor_g = self._anchors(code_list)
        out = []
        for o in range(len(off) - 1):
            q = anchor_q[off[o]:off[o + 1]]
            g = anchor_g[off[o]:off[o + 1]]
            ci, _local = self.index.position_to_chrom(g)
            out.append([(int(c), collapse_anchors(q[ci == c], g[ci == c],
                                                  self.cfg.kmer))
                        for c in np.unique(ci)])
        return out

    def _chain_anchors(self, cands: List[Tuple[int, List[Segment]]]
                       ) -> Tuple[Optional[List[Segment]], float, int]:
        """Best chain of one orientation's [(chrom, segment list)] by the
        host chain, a strictly higher score winning: (chain, score,
        chrom_idx)."""
        cfg = self.cfg
        best_chain, best_score, best_ci = None, 0.0, -1
        for c, segs in cands:
            chain, score = chain_segments(
                segs, min_intron=cfg.min_intron, max_intron=cfg.max_intron)
            if chain and score > best_score:
                best_chain, best_score, best_ci = chain, score, c
        return best_chain, best_score, best_ci

    def _host_pick(self, codes: np.ndarray, fwd, rev):
        """`_chain_both`'s pick from the two orientations' candidates
        (`_orientation_segments`), chained on the host, forward winning
        score ties."""
        chain_f, score_f, ci_f = self._chain_anchors(fwd)
        chain_r, score_r, ci_r = self._chain_anchors(rev)
        if chain_f is None and chain_r is None:
            return None
        if score_f >= score_r:
            return chain_f, "+", ci_f, codes
        return chain_r, "-", ci_r, revcomp_codes(codes)

    def _native_picks(self, reads: Sequence[Tuple[str, str]]) -> list:
        """Each read's chain pick in `_chain_both`'s form."""
        return [self._chain_both(encode(seq)) for _name, seq in reads]

    # ------------------------------------------------------------- filling

    def _fill(self, name: str, seq: str, strand: str, q_codes: np.ndarray,
              chain: List[Segment], chrom_idx: int,
              problems: List[DpProblem]) -> Optional[_Pending]:
        cfg = self.cfg
        g = self.index.seq_codes
        ops: List[Tuple[str, int, int, int]] = []
        dp_slots: List[int] = []

        def add_dp(q0: int, t0: int, q_arr: np.ndarray, t_arr: np.ndarray,
                   mode: str) -> None:
            dp_slots.append(len(problems))
            problems.append(DpProblem(q_arr, t_arr, mode))
            ops.append(("DP", q0, t0, len(dp_slots) - 1))

        chrom_off = int(self.index.chrom_offsets[chrom_idx])
        chrom_end = chrom_off + int(self.index.chrom_sizes[chrom_idx])
        first, last = chain[0], chain[-1]
        # left end extension (reversed extend problem); never cross the
        # chromosome boundary
        lq = min(first.q_start, cfg.max_end_extend)
        if lq > 0:
            lt = min(first.t_start - chrom_off, lq + cfg.band_width)
            add_dp(first.q_start, first.t_start,
                   q_codes[first.q_start - lq:first.q_start][::-1].copy(),
                   g[first.t_start - lt:first.t_start][::-1].copy(),
                   "extend_left")

        # Give every intron gap slack: repeated bases around a junction let
        # anchors run past the true splice site, which would pin the intron
        # at a motif-blind position. Pull both flanks back so the
        # splice-point search can slide the junction onto the motif.
        slack = cfg.splice_slack
        chain = [Segment(s.q_start, s.q_end, s.t_start, s.t_end)
                 for s in chain]
        for a, b in zip(chain, chain[1:]):
            dq = b.q_start - a.q_end
            dt = b.t_start - a.t_end
            if dt - dq >= cfg.min_intron and dq >= 0:
                s_back = min(slack, (a.length - 1) // 2)
                s_fwd = min(slack, (b.length - 1) // 2)
                a.q_end -= s_back
                a.t_end -= s_back
                b.q_start += s_fwd
                b.t_start += s_fwd

        prev: Optional[Segment] = None
        for seg in chain:
            if prev is not None:
                dq = seg.q_start - prev.q_end
                dt = seg.t_start - prev.t_end
                if dt - dq >= cfg.min_intron and dq >= 0:
                    q = q_codes[prev.q_end:seg.q_start]
                    splits = np.arange(dq + 1)
                    donor = np.stack([
                        g[prev.t_end + splits],
                        g[prev.t_end + splits + 1]], axis=1)
                    acc_base = seg.t_start - (dq - splits)
                    acceptor = np.stack([
                        g[acc_base - 2], g[acc_base - 1]], axis=1)
                    s, _m = splice_fill(
                        q, g[prev.t_end:prev.t_end + dq] if dq else
                        np.zeros(0, np.uint8),
                        g[seg.t_start - dq:seg.t_start] if dq else
                        np.zeros(0, np.uint8),
                        donor, acceptor, strand, cfg.noncanonical_penalty)
                    if s > 0:
                        ops.append(("M", prev.q_end, prev.t_end, s))
                    ops.append(("N", prev.q_end + s, prev.t_end + s,
                                dt - dq))
                    if dq - s > 0:
                        ops.append(("M", prev.q_end + s,
                                    seg.t_start - (dq - s), dq - s))
                elif dq == dt:
                    if dq > 0:
                        ops.append(("M", prev.q_end, prev.t_end, dq))
                elif dq == 0:
                    ops.append(("D", prev.q_end, prev.t_end, dt))
                elif dt == 0:
                    ops.append(("I", prev.q_end, prev.t_end, dq))
                else:
                    if dq * dt <= 4_000_000:
                        add_dp(prev.q_end, prev.t_end,
                               q_codes[prev.q_end:seg.q_start].copy(),
                               g[prev.t_end:seg.t_start].copy(), "global")
                    else:  # degenerate huge gap: crude I+D fill
                        ops.append(("I", prev.q_end, prev.t_end, dq))
                        ops.append(("D", seg.q_start, prev.t_end, dt))
            ops.append(("M", seg.q_start, seg.t_start, seg.length))
            prev = seg

        rq = min(len(q_codes) - last.q_end, cfg.max_end_extend)
        if rq > 0:
            rt = min(chrom_end - last.t_end, rq + cfg.band_width)
            add_dp(last.q_end, last.t_end,
                   q_codes[last.q_end:last.q_end + rq].copy(),
                   g[last.t_end:last.t_end + rt].copy(), "extend_right")
        return _Pending(name, seq, strand, q_codes, chrom_idx, ops, dp_slots)

    def _fill_picks(self, reads, picks, min_len: Optional[float]):
        """`_fill` of every picked read, its chain's length at least
        min_len when given: (pendings, the batch's DP problems)."""
        problems: List[DpProblem] = []
        pendings: List[_Pending] = []
        for (name, seq), picked in zip(reads, picks):
            if picked is None:
                continue
            chain, strand, ci, q_codes = picked
            if min_len is not None and \
                    float(sum(s.length for s in chain)) < min_len:
                continue
            pend = self._fill(name, seq, strand, q_codes, chain, ci,
                              problems)
            if pend is not None:
                pendings.append(pend)
        return pendings, problems

    def _map_picks(self, reads, picks) -> List[PslRecord]:
        """Records of the picked reads: `_fill_picks` (min chain length),
        the batch's DP problem list through `_solve_dp`, `_emit`."""
        pendings, problems = self._fill_picks(reads, picks,
                                              cfg_min_len(self.cfg))
        results = self._solve_dp(problems)
        modes = [p.mode for p in problems]
        return [rec for rec in (self._emit(pend, results, modes)
                                for pend in pendings) if rec is not None]

    def _runs_of_picks(self, reads, picks) -> list:
        """map_batch_runs' tuples of the picked reads (no min chain
        length), the DP problem list through `_solve_dp`."""
        pendings, problems = self._fill_picks(reads, picks, None)
        results = self._solve_dp(problems)
        modes = [p.mode for p in problems]
        return [(pend.name, pend.strand, pend.q_codes,
                 self._build_runs(pend, results, modes))
                for pend in pendings]

    # ------------------------------------------------------------ emission

    def _emit(self, pend: _Pending, results: List[DpResult],
              modes: List[str]) -> Optional[PslRecord]:
        """Stitch structural + DP ops into runs and build the PSL record."""
        runs = self._build_runs(pend, results, modes)
        return self._runs_to_psl(pend, runs)

    def _build_runs(self, pend: _Pending, results: List[DpResult],
                    modes: List[str]) -> List[Tuple[str, int, int, int]]:
        """Resolve DP slots into concrete (op, q0, t0, len) runs, sorted."""
        runs: List[Tuple[str, int, int, int]] = []  # (op, q0, t0, len)

        def push(op: str, q0: int, t0: int, ln: int) -> None:
            if ln > 0:
                runs.append((op, q0, t0, ln))

        for kind, q0, t0, ln in pend.ops:
            if kind == "DP":
                slot = pend.dp_slots[ln]  # already a global batch index
                res = results[slot]
                if not res.ops:
                    continue
                if modes[slot] == "extend_left":
                    # solved on reversed arrays: alignment covers
                    # q[q0-q_len:q0] / t[t0-t_len:t0], ops reversed
                    qq, tt = q0 - res.q_len, t0 - res.t_len
                    op_list = list(reversed(res.ops))
                else:
                    qq, tt = q0, t0
                    op_list = res.ops
                for op, dq, dt in op_list:
                    push(op, qq, tt, dq if op != "D" else dt)
                    qq += dq
                    tt += dt
            else:
                push(kind, q0, t0, ln)

        runs.sort(key=lambda r: (r[1], r[2]))
        return runs

    _OP_ID = {"M": 0, "I": 1, "D": 2, "N": 3}

    def _runs_to_psl(self, pend: _Pending,
                     runs: List[Tuple[str, int, int, int]]
                     ) -> Optional[PslRecord]:
        if not runs:
            return None
        op_id = self._OP_ID
        arr = np.array([(op_id[op], q0, t0, ln)
                        for op, q0, t0, ln in runs], np.int64)
        res = native_emit_psl(
            pend.q_codes, self.index.seq_codes,
            arr[:, 0].astype(np.int8), np.ascontiguousarray(arr[:, 1]),
            np.ascontiguousarray(arr[:, 2]),
            np.ascontiguousarray(arr[:, 3]))
        if res is None:
            return self._runs_to_psl_numpy(pend, runs)
        stats, bs, bq, bt, cs_str = res
        return self._psl_record(
            pend, stats, bs.tolist(), bq.tolist(), bt.tolist(), cs_str)

    def _psl_record(self, pend: _Pending, stats, block_sizes, q_starts,
                    t_starts, cs_str) -> Optional[PslRecord]:
        """Assemble the PslRecord from emitted stats + merged blocks
        (shared by the native and numpy emission paths)."""
        if not block_sizes:
            return None
        matches, mismatches, nI, I, nD, D, n_bases = (
            int(x) for x in stats[:7])
        q = pend.q_codes
        chrom_off = int(self.index.chrom_offsets[pend.chrom_idx])
        denom = matches + mismatches + I + D
        return PslRecord(
            matches=matches, mismatches=mismatches, rep_matches=0,
            n_count=n_bases, q_num_insert=nI, q_base_insert=I,
            t_num_insert=nD, t_base_insert=D, strand=pend.strand,
            q_name=pend.name, q_size=len(q), q_start=q_starts[0],
            q_end=q_starts[-1] + block_sizes[-1],
            t_name=self.index.chrom_names[pend.chrom_idx],
            t_size=int(self.index.chrom_sizes[pend.chrom_idx]),
            t_start=t_starts[0] - chrom_off,
            t_end=t_starts[-1] + block_sizes[-1] - chrom_off,
            block_count=len(block_sizes), block_sizes=block_sizes,
            q_starts=q_starts,
            t_starts=[t - chrom_off for t in t_starts],
            accuracy=matches / denom if denom else 0.0,
            cs=cs_str, sequence=pend.seq)

    def _runs_to_psl_numpy(self, pend: _Pending,
                           runs: List[Tuple[str, int, int, int]]
                           ) -> Optional[PslRecord]:
        """`_runs_to_psl` in numpy (the native emit's twin)."""
        g = self.index.seq_codes
        q = pend.q_codes
        matches = mismatches = 0
        n_bases = nI = I = nD = D = 0
        cs_parts: List[str] = []
        block_sizes: List[int] = []
        q_starts: List[int] = []
        t_starts: List[int] = []

        def open_block(q0: int, t0: int, ln: int) -> None:
            if block_sizes and (t_starts[-1] + block_sizes[-1] == t0
                                and q_starts[-1] + block_sizes[-1] == q0):
                block_sizes[-1] += ln
            else:
                block_sizes.append(ln)
                q_starts.append(q0)
                t_starts.append(t0)

        for op, q0, t0, ln in runs:
            if op == "M":
                open_block(q0, t0, ln)
                eq = q[q0:q0 + ln] == g[t0:t0 + ln]
                n_eq = int(eq.sum())
                matches += n_eq
                mismatches += ln - n_eq
                # emit cs: decode whole run once, slice strings per segment
                q_str = decode(q[q0:q0 + ln])
                if n_eq == ln:
                    cs_parts.append("=" + q_str)
                else:
                    g_low = decode(g[t0:t0 + ln]).lower()
                    q_low = q_str.lower()
                    edges = np.flatnonzero(np.diff(eq.astype(np.int8))) + 1
                    bounds = [0] + edges.tolist() + [ln]
                    for b0, b1 in zip(bounds, bounds[1:]):
                        if eq[b0]:
                            cs_parts.append("=" + q_str[b0:b1])
                        else:
                            for o in range(b0, b1):
                                cs_parts.append("*" + g_low[o] + q_low[o])
            elif op == "I":
                nI += 1
                I += ln
                cs_parts.append("+" + decode(q[q0:q0 + ln]).lower())
            elif op == "D":
                nD += 1
                D += ln
                cs_parts.append("-" + decode(g[t0:t0 + ln]).lower())
            elif op == "N":
                n_bases += ln
                cs_parts.append(
                    "~" + decode(g[t0:t0 + 2]).lower() + str(ln)
                    + decode(g[t0 + ln - 2:t0 + ln]).lower())

        return self._psl_record(
            pend, (matches, mismatches, nI, I, nD, D, n_bases),
            block_sizes, q_starts, t_starts, "".join(cs_parts))

    # -------------------------------------------------------------- public

    def map_batch(self, reads: Sequence[Tuple[str, str]]
                  ) -> List[PslRecord]:
        """Align a batch of (name, seq) reads; primary alignments only.
        One fused C call per read does seed+chain, gap fill (splice-point
        search + affine DP), run assembly and extended-PSL emission; under
        `numpy_seeding` the Python staging (`_native_picks`,
        `_map_picks`)."""
        if self.numpy_seeding():
            return self._map_picks(reads, self._native_picks(reads))
        out: List[PslRecord] = []
        for name, seq in reads:
            codes = encode(seq)
            strand, ci, stats, bs, bq, bt, cs = native_align_read(
                *self._fused_args(codes, cfg_min_len(self.cfg)))
            if strand is None:
                continue
            pend = _Pending(name, seq, "+" if strand == 0 else "-",
                            codes if strand == 0 else revcomp_codes(codes),
                            ci, [], [])
            rec = self._psl_record(pend, stats, bs, bq, bt, cs)
            if rec is not None:
                out.append(rec)
        return out

    def _fused_args(self, codes: np.ndarray, min_chain: float) -> tuple:
        """The shared argument tuple for the fused native entry points
        (index + chain constants + DP/fill parameters)."""
        cfg = self.cfg
        return (codes, cfg.kmer, cfg.window, self.max_occ, 100, self.index,
                cfg.min_intron, cfg.max_intron, 1, 12.0, 4.0, 0.3, 512,
                min_chain, cfg.match, cfg.mismatch, cfg.gap_open,
                cfg.gap_extend, cfg.end_bonus, cfg.zdrop,
                cfg.band_width, cfg.max_end_extend, cfg.splice_slack,
                cfg.noncanonical_penalty)


    def map_batch_runs(self, reads: Sequence[Tuple[str, str]]):
        """Like map_batch but returns raw (name, strand, q_codes, runs)
        tuples, the op-level interface used by the star consensus
        (poa/star.py); one fused C call per read, or under
        `numpy_seeding` the Python staging."""
        if self.numpy_seeding():
            return self._runs_of_picks(reads, self._native_picks(reads))
        out = []
        for name, seq in reads:
            codes = encode(seq)
            # min_chain 0: the runs path applies no min-chain gate
            strand, _ci, runs = native_align_read_runs(
                *self._fused_args(codes, 0.0))
            if strand is None:
                continue
            q_codes = codes if strand == 0 else revcomp_codes(codes)
            out.append((name, "+" if strand == 0 else "-", q_codes, runs))
        return out

    def map_all_targets(self, name: str, seq: str) -> List[PslRecord]:
        """Emit one alignment per target sequence with a viable chain (both
        strands considered, better one kept) — the `-N <many>` analogue
        used for allele typing (utils/hla.py)."""
        cfg = self.cfg
        per_chrom: Dict[int, Tuple[List[Segment], float, str, np.ndarray]] = {}
        codes = encode(seq)
        for strand, q_codes in (("+", codes), ("-", revcomp_codes(codes))):
            pos, hashes = minimizers(q_codes, cfg.kmer, cfg.window)
            if len(pos) == 0:
                continue
            qidx, gpos = self.index.lookup(hashes, self.max_occ)
            if len(qidx) == 0:
                continue
            qpos = pos[qidx]
            ci, _local = self.index.position_to_chrom(gpos)
            for c in np.unique(ci):
                mask = ci == c
                segs = collapse_anchors(qpos[mask], gpos[mask], cfg.kmer)
                chain, score = chain_segments(
                    segs, min_intron=cfg.min_intron,
                    max_intron=cfg.max_intron)
                if chain and (int(c) not in per_chrom
                              or score > per_chrom[int(c)][1]):
                    per_chrom[int(c)] = (chain, score, strand, q_codes)
        out: List[PslRecord] = []
        for c, (chain, score, strand, q_codes) in sorted(per_chrom.items()):
            if score < cfg_min_len(cfg):
                continue
            problems: List[DpProblem] = []
            pend = self._fill(name, seq, strand, q_codes, chain, c, problems)
            if pend is None:
                continue
            modes = [p.mode for p in problems]
            results = self._solve_dp(problems)
            rec = self._emit(pend, results, modes)
            if rec is not None:
                out.append(rec)
        return out

    def _solve_dp(self, problems: List[DpProblem]) -> List[DpResult]:
        """The DP problem list's results: the host solver."""
        return solve_dp_native(problems, self.cfg)


def cfg_min_len(cfg: AlignConfig) -> float:
    return float(cfg.min_chain_score)


SEED_QUERY_BLOCK = 1 << 20  # queries a sharded lookup call at most
# (whole orientations; one orientation alone may exceed it)


def sharded_seed_hits(shards: IndexShards, hashes: np.ndarray,
                      q_off: np.ndarray, max_occ: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """`GenomeIndex.lookup` through a hash-sharded index, for many
    orientations at once: orientation o's queries are
    hashes[q_off[o]:q_off[o+1]]. The lookups run over the mesh in blocks
    of whole orientations (`IndexShards.lookup`); the refinement is the
    reference's `_sharded_lookup` per orientation: counts summed over
    shards (one shard owns each hash), the max_occ cap, the ANCHOR_BUDGET
    cut. Returns (qidx, gpos) int64, query-major with each query's hits
    in its shard's sorted order: for one orientation what
    GenomeIndex.lookup returns."""
    q_off = np.asarray(q_off, np.int64)
    n_orient = len(q_off) - 1
    out_q, out_g = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    o = 0
    while o < n_orient:
        o1 = o + 1
        while o1 < n_orient and q_off[o1 + 1] - q_off[o] <= SEED_QUERY_BLOCK:
            o1 += 1
        qa, qb = int(q_off[o]), int(q_off[o1])
        if qb > qa:
            pos, valid, cnt = shards.lookup(hashes[qa:qb], max_occ)
            counts = cnt.sum(axis=0)
            keep = (counts > 0) & (counts <= max_occ)
            oid = np.repeat(np.arange(o1 - o), np.diff(q_off[o:o1 + 1]))
            kept = np.bincount(oid, weights=np.where(keep, counts, 0),
                               minlength=o1 - o)
            for j in np.flatnonzero(kept > ANCHOR_BUDGET):
                sl = slice(int(q_off[o + j]) - qa, int(q_off[o + j + 1]) - qa)
                c = np.sort(counts[sl][keep[sl]])
                k = int(np.searchsorted(np.cumsum(c), ANCHOR_BUDGET,
                                        "right"))
                cut = max(int(c[k - 1]) if k > 0 else 1, 1)
                keep[sl] &= counts[sl] <= cut
            qi, si, ki = np.nonzero(valid.transpose(1, 0, 2)
                                    & keep[:, None, None])
            out_q.append(qi + qa)
            out_g.append(pos[si, qi, ki])
        o = o1
    return np.concatenate(out_q).astype(np.int64), \
        np.concatenate(out_g).astype(np.int64)


class TorchSpliceAligner(SpliceAligner):
    """SpliceAligner whose `map_batch`, `map_batch_runs` and
    `map_all_targets` run cfg's (chain_backend, dp_backend) route (the
    module docstring) on `device` ('cuda' or 'cpu'; the CPU runs the
    kernels' plain PyTorch versions), or on the mesh's devices when one
    is installed. `host_twin()` returns a plain host SpliceAligner
    sharing the index (replicated)."""

    def __init__(self, genome, cfg: Optional[AlignConfig] = None,
                 device="cuda"):
        dev = resolve_device(device)
        super().__init__(genome, cfg)
        self._bind(dev)

    @classmethod
    def from_aligner(cls, aligner: SpliceAligner, device="cuda",
                     cfg: Optional[AlignConfig] = None
                     ) -> "TorchSpliceAligner":
        """A port aligner sharing `aligner`'s GenomeIndex (no rebuild),
        with `aligner`'s configuration or `cfg` (whose index parameters,
        kmer, window and occurrence cap, must be the aligner's)."""
        dev = resolve_device(device)
        self = object.__new__(cls)
        self.cfg = aligner.cfg if cfg is None else cfg
        self.index = aligner.index
        self.max_occ = aligner.max_occ
        self._bind(dev)
        return self

    def host_twin(self) -> SpliceAligner:
        twin = object.__new__(SpliceAligner)
        twin.cfg = self.cfg
        twin.index = self.index
        twin.max_occ = self.max_occ
        return twin

    def _bind(self, device: torch.device) -> None:
        """Upload the genome codes once to `device` and, under a pipeline
        mesh, to each distinct mesh device; with index_backend 'sharded'
        under a mesh, place this process's hash-range index shards on
        their mesh devices (without a mesh the index stays replicated, as
        in the reference)."""
        align_backends(self.cfg)
        self.device = device
        self.genome_codes = genome_tensor(self.index.seq_codes, device)
        self._genome_on = {device: self.genome_codes}
        self._genome()
        mesh = pipeline_mesh()
        self._sharded = None
        if self.cfg.index_backend == "sharded" and mesh is not None:
            self._sharded = place_index_shards(
                mesh, *shard_index_arrays(self.index, mesh.size))

    def _genome(self):
        """The genome codes for solve_dp_fused: the tensor on
        self.device, or under a mesh the codes by mesh device (uploaded at
        most once to each)."""
        mesh = pipeline_mesh()
        if mesh is None:
            return self.genome_codes
        for dev in mesh.distinct_devices():
            if dev not in self._genome_on:
                self._genome_on[dev] = genome_tensor(self.index.seq_codes,
                                                     dev)
        return self._genome_on

    def _native_picks(self, reads: Sequence[Tuple[str, str]]) -> list:
        """Each read's chain pick in `_chain_both`'s form with the native
        chain. With a hash-sharded index every orientation of the batch
        is looked up over the mesh at once (`_anchors`) and chained on
        the host (`_host_pick`)."""
        if self._sharded is None:
            return super()._native_picks(reads)
        code_list = [encode(seq) for _name, seq in reads]
        per_o = self._orientation_segments(code_list)
        return [self._host_pick(codes, per_o[2 * r], per_o[2 * r + 1])
                for r, codes in enumerate(code_list)]

    def _sharded_anchors(self, code_list: List[np.ndarray]):
        """Every orientation's anchors through the hash-sharded index, in
        one lookup over the mesh (`sharded_seed_hits`): orientation 2r + s
        (s = 0 forward, 1 reverse) of read r holds anchors
        off[2r+s]:off[2r+s+1] of (anchor_q, anchor_g). Returns (off,
        anchor_q, anchor_g)."""
        cfg = self.cfg
        mpos, hashes = [], []
        for codes in code_list:
            for qc in (codes, revcomp_codes(codes)):
                p, h = minimizers(qc, cfg.kmer, cfg.window)
                mpos.append(p)
                hashes.append(h)
        q_off = np.zeros(len(mpos) + 1, np.int64)
        np.cumsum([len(p) for p in mpos], out=q_off[1:])
        qidx, gpos = sharded_seed_hits(
            self._sharded, np.concatenate(hashes) if hashes
            else np.zeros(0, np.uint64), q_off, self.max_occ)
        anchor_q = (np.concatenate(mpos) if mpos
                    else np.zeros(0, np.int64))[qidx]
        return np.searchsorted(qidx, q_off), anchor_q, gpos

    def _anchors(self, code_list: List[np.ndarray]):
        """The host class's anchors, through `_sharded_anchors` with a
        hash-sharded index."""
        if self._sharded is not None:
            return self._sharded_anchors(code_list)
        return super()._anchors(code_list)

    def segment_candidates(self, code_list: List[np.ndarray]):
        """The candidates of the reads' codes without the C seed stage
        (`_orientation_segments`), in order read, strand, chromosome.
        Returns ([(orientation 2r + s, chrom)], [segment list])."""
        per_o = self._orientation_segments(code_list)
        cands = [(o, c) for o, lst in enumerate(per_o) for c, _segs in lst]
        return cands, [segs for lst in per_o for _c, segs in lst]

    def _segment_picks(self, reads: Sequence[Tuple[str, str]]) -> list:
        """Each read's chain pick in `_chain_both`'s form with the device
        chain from segment lists (the reference's `_chain_batch_device`):
        `segment_candidates`, all chained in one `chain_batch_segments`
        call; per read the first candidate of strictly highest score with
        a chain."""
        cfg = self.cfg
        code_list = [encode(seq) for _name, seq in reads]
        cands, seg_lists = self.segment_candidates(code_list)
        chains = chain_batch_segments(
            seg_lists, min_intron=cfg.min_intron, max_intron=cfg.max_intron,
            device=self.device)
        picks: list = [None] * len(reads)
        best = [0.0] * len(reads)
        for (o, c), (chain, score) in zip(cands, chains):
            r = o // 2
            if chain and score > best[r]:
                best[r] = score
                codes = code_list[r]
                picks[r] = (chain, "+", c, codes) if o % 2 == 0 else \
                    (chain, "-", c, revcomp_codes(codes))
        return picks

    def seed_batch(self, reads: Sequence[Tuple[str, str]]):
        """C seed stage: (codes_all, read_off, seeded), seeded being
        native_stage_seed_batch's (n_cand, read, strand, chrom, tbase,
        n_seg, (qs, qe, ts, te, cov)). With a sharded index the lookup runs
        over the mesh (`sharded_seed_hits`) and the C stage collapses,
        prepares and packs its anchors (native_stage_seed_anchors): the
        same tuple."""
        require_native("the C seed stage (TorchSpliceAligner.seed_batch)")
        if self.index.bucket_lo is None and self._sharded is None:
            raise ValueError("the C seed stage (TorchSpliceAligner."
                             "seed_batch) reads the index's bucket table "
                             "(bucket_lo), which this index lacks")
        cfg = self.cfg
        code_list = [encode(seq) for _name, seq in reads]
        read_off = np.zeros(len(reads) + 1, np.int64)
        np.cumsum([len(c) for c in code_list], out=read_off[1:])
        codes_all = (np.concatenate(code_list) if code_list
                     else np.zeros(0, np.uint8))
        if self._sharded is not None:
            return codes_all, read_off, self._seed_sharded(code_list)
        seeded = native_stage_seed_batch(
            codes_all, read_off, cfg.kmer, cfg.window, self.max_occ, 100,
            self.index, cfg.max_intron)
        return codes_all, read_off, seeded

    def _seed_sharded(self, code_list):
        cfg = self.cfg
        return native_stage_seed_anchors(
            *self._sharded_anchors(code_list), len(code_list), cfg.kmer,
            100, self.index, cfg.max_intron)

    def chain_batch(self, seeded) -> np.ndarray:
        """Chain DP on the device: the packed int16 chain rows."""
        n_cand, _read, _strand, _chrom, _tbase, n_seg, segs = seeded
        return chain_batch_rows(*segs, n_seg, n_cand,
                                min_intron=self.cfg.min_intron,
                                max_intron=self.cfg.max_intron,
                                device=self.device)

    def fill_batch(self, codes_all, read_off, seeded, rows):
        """C fill stage: (strand, chrom, oriented, run_off, runs, probs),
        probs being the DP descriptors (read, mode, q0, t0, nq, nt)."""
        require_native("the C fill stage (TorchSpliceAligner.fill_batch)")
        cfg = self.cfg
        n_cand, c_read, c_strand, c_chrom, c_tbase, c_nseg, segs = seeded
        return native_stage_fill_batch(
            codes_all, read_off, n_cand, c_read, c_strand, c_chrom, c_tbase,
            c_nseg, segs, rows, self.index, cfg_min_len(cfg), cfg.min_intron,
            cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_extend,
            cfg.end_bonus, cfg.zdrop, cfg.band_width, cfg.max_end_extend,
            cfg.splice_slack, cfg.noncanonical_penalty)

    def dp_batch(self, probs, oriented: np.ndarray, read_off: np.ndarray):
        """The DP of fill_batch's descriptors by cfg.dp_backend, as the
        emit stage reads it: (meta, ks, buf, on_host). 'numpy' marks every
        problem on_host, for the emit stage's host solver."""
        dp = self.cfg.dp_backend
        if dp == "numpy":
            n = len(probs[1])
            return (np.zeros((n, 4), np.int32), np.zeros(n, np.int32),
                    np.zeros((n, 1), np.int8), np.ones(n, np.uint8))
        return solve_dp_fused(probs, oriented, read_off, self._genome(),
                              self.cfg, rowscan=dp == "rowscan")

    def _solve_dp(self, problems: List[DpProblem]) -> List[DpResult]:
        dp = self.cfg.dp_backend
        if dp == "numpy":
            return solve_dp_native(problems, self.cfg)
        return solve_dp_device(problems, self.cfg, self.device,
                               rowscan=dp == "rowscan")

    def _device_picks(self, reads: Sequence[Tuple[str, str]]) -> list:
        """Each read's chain pick in `_chain_both`'s form with the device
        chain (the reference's `_chain_batch_device`): the C seed stage's
        candidates, in order read, strand, chromosome; the chain kernel's
        rows; per read the first candidate of strictly highest score whose
        chain keeps a segment after the overlap trim (the fill stage's
        pick)."""
        picks: list = [None] * len(reads)
        codes_all, read_off, seeded = self.seed_batch(reads)
        n_cand, c_read, c_strand, c_chrom, c_tbase, c_nseg, segs = seeded
        if n_cand == 0:
            return picks
        rows = self.chain_batch(seeded)
        msb = rows.shape[1] - 3
        scores = np.ascontiguousarray(rows[:, msb + 1:msb + 3]).view(
            np.float32)[:, 0]
        qs, qe, ts, te, _cov = segs
        best = [0.0] * len(reads)
        for ci in range(n_cand):
            ri, score = int(c_read[ci]), float(scores[ci])
            if c_nseg[ci] == 0 or not score > best[ri]:
                continue
            path = []
            at = int(rows[ci, msb])
            while at >= 0:
                path.append(at)
                at = int(rows[ci, at])
            chain: List[Segment] = []
            prev_q = prev_t = -1
            tbase = int(c_tbase[ci])
            for s in reversed(path):
                trim = max(prev_q - int(qs[ci, s]), prev_t - int(ts[ci, s]),
                           0)
                q0, t0 = int(qs[ci, s]) + trim, int(ts[ci, s]) + trim
                if q0 >= qe[ci, s] or t0 >= te[ci, s]:
                    continue
                chain.append(Segment(q0, int(qe[ci, s]), t0 + tbase,
                                     int(te[ci, s]) + tbase))
                prev_q, prev_t = int(qe[ci, s]), int(te[ci, s])
            if not chain:
                continue
            best[ri] = score
            codes = codes_all[read_off[ri]:read_off[ri + 1]]
            picks[ri] = (chain, "+", int(c_chrom[ci]), codes) \
                if c_strand[ci] == 0 else \
                (chain, "-", int(c_chrom[ci]), revcomp_codes(codes))
        return picks

    def map_batch(self, reads: Sequence[Tuple[str, str]]
                  ) -> List[PslRecord]:
        """Align a batch of (name, seq) reads on cfg's route; primary
        alignments only, byte-identical to the host route."""
        chain, dp = align_backends(self.cfg)
        if chain == "device":
            if self.numpy_seeding():
                return self._map_picks(reads, self._segment_picks(reads))
            return self._map_staged(reads)
        if dp == "numpy":
            return super().map_batch(reads)
        return self._map_picks(reads, self._native_picks(reads))

    def map_batch_runs(self, reads: Sequence[Tuple[str, str]]):
        """map_batch_runs by cfg's route: the chain pick of the chain
        backend, the DP problem list through the DP backend (the host
        class's fused C call for 'native' with 'numpy')."""
        chain, dp = align_backends(self.cfg)
        if chain == "device":
            picks = (self._segment_picks(reads) if self.numpy_seeding()
                     else self._device_picks(reads))
        elif dp == "numpy":
            return super().map_batch_runs(reads)
        else:
            picks = self._native_picks(reads)
        return self._runs_of_picks(reads, picks)

    def _map_staged(self, reads: Sequence[Tuple[str, str]]
                    ) -> List[PslRecord]:
        """The staged route: C seed, chain kernel, C fill, the DP of
        cfg.dp_backend (`dp_batch`), C emit."""
        with span("align.seed", len(reads)):
            codes_all, read_off, seeded = self.seed_batch(reads)
        if seeded[0] == 0:
            return []
        with span("align.chain", int(seeded[0])):
            rows = self.chain_batch(seeded)
        with span("align.fill", len(reads)):
            strand, chrom, oriented, run_off, runs, probs = self.fill_batch(
                codes_all, read_off, seeded, rows)
        cfg = self.cfg
        with span("align.dp", len(probs[0])):
            meta, ks, buf, on_host = self.dp_batch(probs, oriented, read_off)
        with span("align.emit", len(reads)):
            stats, blk_off, bs, bq, bt, cs_off, cs_raw = \
                native_stage_emit_batch(
                    oriented, read_off, self.index.seq_codes, strand,
                    run_off, runs, probs, on_host, meta, ks, buf, cfg.match,
                    cfg.mismatch, cfg.gap_open, cfg.gap_extend,
                    cfg.end_bonus, cfg.zdrop)

        with span("align.records") as s:
            out: List[PslRecord] = []
            for ri, (name, seq) in enumerate(reads):
                if strand[ri] < 0 or stats[ri, 7] == 0:
                    continue
                b0, b1 = int(blk_off[ri]), int(blk_off[ri + 1])
                pend = _Pending(
                    name, seq, "+" if strand[ri] == 0 else "-",
                    oriented[read_off[ri]:read_off[ri + 1]], int(chrom[ri]),
                    [], [])
                rec = self._psl_record(
                    pend, stats[ri], bs[b0:b1].tolist(), bq[b0:b1].tolist(),
                    bt[b0:b1].tolist(),
                    cs_raw[cs_off[ri]:cs_off[ri + 1]].decode())
                if rec is not None:
                    out.append(rec)
            s.items = len(out)
        return out
