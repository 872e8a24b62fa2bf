"""Native (C++) host-runtime components, built on demand with g++ and
loaded through ctypes (no pybind11 dependency). The port's own copy of
mandalorion_tpu/native: same sources and compiler flags, its own build
directory and its own loaded library.

MANDO_TPU_NO_NATIVE set to a non-empty value (read once a process, as
the reference reads it) leaves the library unbuilt and unloaded: every
`native_*` wrapper then returns None and its callers take their numpy
twins. Without the switch the library is required: a failed build or
load raises, it never falls back to the numpy twins."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def load_native() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native library; None, with nothing
    built, when MANDO_TPU_NO_NATIVE is set. Raises RuntimeError when g++
    is missing, the build fails or the library does not load."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    if os.environ.get("MANDO_TPU_NO_NATIVE"):
        _TRIED = True
        return None
    here = os.path.dirname(__file__)
    srcs = [os.path.join(here, "minimizers.cpp"),
            os.path.join(here, "poa.cpp")]
    so = os.path.join(_build_dir(), "libmando_native.so")
    try:
        if (not os.path.exists(so)
                or os.path.getmtime(so) < max(os.path.getmtime(s)
                                              for s in srcs)):
            # build to a pid-unique temp + atomic rename: forked pipeline
            # workers may race to compile the same library
            tmp = f"{so}.{os.getpid()}.tmp"
            # -ffp-contract=off: the chain DP's float32 cost arithmetic
            # must round exactly like numpy's (no FMA contraction).
            # -std=gnu++20: the POA packed prefix-max left-shifts signed
            # values; C++20 defines that as two's complement.
            subprocess.run(
                ["g++", "-O3", "-march=native", "-ffp-contract=off",
                 "-std=gnu++20", "-fopenmp-simd",
                 "-shared", "-fPIC", "-o", tmp] + srcs,
                check=True, capture_output=True, timeout=240)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.minimizers_c.restype = ctypes.c_int64
        lib.minimizers_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        lib.encode_seq.restype = None
        lib.encode_seq.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p]
        lib.lookup_ranges_c.restype = None
        lib.lookup_ranges_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.seed_segments_c.restype = ctypes.c_int64
        lib.seed_segments_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64] + [ctypes.c_void_p] * 7
        lib.solve_dp_batch_c.restype = ctypes.c_int64
        lib.solve_dp_batch_c.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64] + [ctypes.c_int32] * 6 + [
            ctypes.c_void_p] * 6 + [ctypes.c_int64]
        lib.emit_psl_c.restype = ctypes.c_int64
        lib.emit_psl_c.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64] + [ctypes.c_void_p] * 5 + [ctypes.c_int64]
        _chain_sig = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int64] + [ctypes.c_void_p] * 6
        lib.seed_chain_c.restype = ctypes.c_int64
        lib.seed_chain_c.argtypes = _chain_sig
        lib.seed_chain2_c.restype = ctypes.c_int64
        lib.seed_chain2_c.argtypes = _chain_sig + [ctypes.c_void_p]
        lib.parse_cs_c.restype = ctypes.c_int64
        lib.parse_cs_c.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64] + [
            ctypes.c_void_p] * 6
        lib.align_read_c.restype = ctypes.c_int64
        lib.align_read_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,                 # codes, n
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,  # k w max_occ
            ctypes.c_int32,                                  # merge_gap
            ctypes.c_void_p, ctypes.c_void_p,                # index
            ctypes.c_int32, ctypes.c_void_p,                 # bits, pos
            ctypes.c_int32,                                  # pos_is_u32
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # chroms
            ctypes.c_void_p,                                 # genome
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,  # introns,match
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # chain costs
            ctypes.c_int64, ctypes.c_float,                  # max_seg,min_sc
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # dp m/mm/go
            ctypes.c_int32, ctypes.c_int32,                  # ge, end_bonus
            ctypes.c_int32,                                  # zdrop
            ctypes.c_int32, ctypes.c_int64,                  # band, max_ext
            ctypes.c_int32, ctypes.c_int32,                  # slack, ncp
            ctypes.c_void_p, ctypes.c_void_p,                # strand, chrom
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # stats,blk
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,   # cs
            ctypes.c_int32] + [ctypes.c_void_p] * 4 + [          # runs mode
            ctypes.c_int64]                                      # runs cap
        lib.stage_seed_batch_c.restype = ctypes.c_int64
        lib.stage_seed_batch_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # codes,off,n
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,    # k w max_occ
            ctypes.c_int32,                                    # merge_gap
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,  # index
            ctypes.c_void_p, ctypes.c_int32,                   # pos, u32
            ctypes.c_void_p, ctypes.c_int64,                   # chroms
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,    # intr,seg,cap
            ] + [ctypes.c_void_p] * 10 + [ctypes.c_int32]      # threads
        lib.stage_seed_threads_c.restype = ctypes.c_int32
        lib.stage_seed_threads_c.argtypes = [ctypes.c_int64, ctypes.c_int32]
        lib.stage_seed_anchors_c.restype = ctypes.c_int64
        lib.stage_seed_anchors_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # off,q,g
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,     # n, k, gap
            ctypes.c_void_p, ctypes.c_int64,                    # chroms
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,     # intr,seg,cap
            ] + [ctypes.c_void_p] * 10
        lib.stage_fill_batch_c.restype = ctypes.c_int64
        lib.stage_fill_batch_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # codes,off,n
            ctypes.c_int64] + [ctypes.c_void_p] * 5 + [        # candidates
            ctypes.c_void_p] * 4 + [ctypes.c_int64,            # segs,maxseg
            ctypes.c_void_p, ctypes.c_int64,                   # chain rows,w
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # chroms
            ctypes.c_void_p,                                   # genome
            ctypes.c_float, ctypes.c_int64,                    # minsc,intron
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,    # dp m/mm/go
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,    # ge,eb,zdrop
            ctypes.c_int32, ctypes.c_int64,                    # band,max_ext
            ctypes.c_int32, ctypes.c_int32,                    # slack, ncp
            ] + [ctypes.c_void_p] * 8 + [ctypes.c_int64] + [   # outs,runscap
            ctypes.c_void_p] * 6 + [ctypes.c_int64,            # probs, cap
            ctypes.c_void_p]                                   # counts
        lib.stage_emit_batch_c.restype = ctypes.c_int64
        lib.stage_emit_batch_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # or,off,n
            ctypes.c_void_p, ctypes.c_void_p,                  # genome,strand
            ] + [ctypes.c_void_p] * 5 + [                      # runs
            ctypes.c_void_p] * 5 + [                           # probs
            ctypes.c_void_p,                                   # on_host
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, # dp results
            ctypes.c_int64,                                    # dp_stride
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,    # m/mm/go
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,    # ge,eb,zdrop
            ] + [ctypes.c_void_p] * 5 + [ctypes.c_int64,       # stats..blkcap
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,  # cs
            ctypes.c_void_p]                                   # needs
        lib.index_build_start.restype = ctypes.c_void_p
        lib.index_build_start.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p]
        lib.index_build_finish.restype = None
        lib.index_build_finish.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32]
        lib.index_build_abort.restype = None
        lib.index_build_abort.argtypes = [ctypes.c_void_p]
        lib.poa_consensus_c.restype = ctypes.c_int64
        lib.poa_consensus_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64] + [
            ctypes.c_int32] * 8 + [ctypes.c_void_p]
        lib.poa_align_c.restype = ctypes.c_int64
        lib.poa_align_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64] + [ctypes.c_int32] * 8 + [ctypes.c_void_p]
        lib.poa_graph_new_c.restype = ctypes.c_void_p
        lib.poa_graph_new_c.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.poa_graph_free_c.restype = None
        lib.poa_graph_free_c.argtypes = [ctypes.c_void_p]
        lib.poa_graph_nodes_c.restype = ctypes.c_int64
        lib.poa_graph_nodes_c.argtypes = [ctypes.c_void_p]
        lib.poa_graph_consensus_handle_c.restype = ctypes.c_int64
        lib.poa_graph_consensus_handle_c.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p]
        lib.poa_stage_pool_new_c.restype = ctypes.c_void_p
        lib.poa_stage_pool_new_c.argtypes = [ctypes.c_int32]
        lib.poa_stage_pool_free_c.restype = None
        lib.poa_stage_pool_free_c.argtypes = [ctypes.c_void_p]
        lib.poa_graphs_stage_c.restype = ctypes.c_int32
        lib.poa_graphs_stage_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4 + [
            ctypes.c_int64] * 3 + [ctypes.c_void_p] * 8
        lib.poa_graphs_apply_c.restype = ctypes.c_int32
        lib.poa_graphs_apply_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
        lib.poa_graphs_sizes_c.restype = None
        lib.poa_graphs_sizes_c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(
            f"native library build failed ({exc}):\n"
            f"{(exc.stderr or b'').decode(errors='replace')}") from exc
    except (subprocess.SubprocessError, OSError, AttributeError) as exc:
        raise RuntimeError(f"native library unavailable ({exc}); "
                           f"mandalorion_tpu_torch needs g++") from exc
    _LIB = lib
    return lib


def native_minimizers(codes: np.ndarray, k: int, w: int
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(positions, hashes) via the C++ path."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    m = max(len(codes) - k + 1, 0)
    if m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    pos = np.empty(m, np.int64)
    hsh = np.empty(m, np.uint64)
    n = lib.minimizers_c(codes.ctypes.data, len(codes), k, w,
                         pos.ctypes.data, hsh.ctypes.data)
    return pos[:n].copy(), hsh[:n].copy()


def native_build_index(codes: np.ndarray, chrom_starts: np.ndarray,
                       chrom_sizes: np.ndarray, chrom_goffsets: np.ndarray,
                       k: int, w: int, chunk: int, bucket_bits: int,
                       threads: int, pos_u32: bool):
    """Parallel minimizer-index build: (sorted_hashes, sorted_positions,
    bucket_lo), bit-identical to align/index.py's numpy path."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    starts = np.ascontiguousarray(chrom_starts, np.int64)
    sizes = np.ascontiguousarray(chrom_sizes, np.int64)
    goffs = np.ascontiguousarray(chrom_goffsets, np.int64)
    total = ctypes.c_int64(0)
    handle = lib.index_build_start(
        codes.ctypes.data, starts.ctypes.data, sizes.ctypes.data,
        goffs.ctypes.data, len(starts), k, w, chunk, bucket_bits,
        threads, ctypes.byref(total))
    n = total.value
    try:
        hashes = np.empty(n, np.uint64)
        positions = np.empty(n, np.uint32 if pos_u32 else np.int64)
        bucket_lo = np.empty((1 << bucket_bits) + 1, np.int64)
    except MemoryError:
        lib.index_build_abort(handle)
        raise
    lib.index_build_finish(handle, hashes.ctypes.data,
                           positions.ctypes.data, 1 if pos_u32 else 0,
                           bucket_lo.ctypes.data, threads)
    return hashes, positions, bucket_lo


def _make_seed_bufs(cap: int):
    return (np.empty(cap, np.int32),) + tuple(
        np.empty(cap, np.int64) for _ in range(6))


_SEED_BUFS = _make_seed_bufs(4096)


def native_seed_segments(codes: np.ndarray, k: int, w: int, max_occ: int,
                         merge_gap: int, sorted_hashes: np.ndarray,
                         bucket_lo: np.ndarray, bucket_bits: int,
                         sorted_positions: np.ndarray,
                         chrom_offsets: np.ndarray):
    """Fused minimizers -> lookup -> anchor collapse for one read
    orientation. Returns (chrom_ids, q_starts, q_ends, t_starts, t_ends,
    n_anchors, covs) arrays sorted by (chrom, diag, t). The returned arrays are views into reused
    buffers — consume (or copy) them before the next call."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    pos_is_u32 = 1 if sorted_positions.dtype == np.uint32 else 0
    global _SEED_BUFS
    while True:
        chrom, qs, qe, ts, te, na, cov = _SEED_BUFS
        cap = len(chrom)
        n = lib.seed_segments_c(
            codes.ctypes.data, len(codes), k, w, max_occ, merge_gap,
            sorted_hashes.ctypes.data, bucket_lo.ctypes.data, bucket_bits,
            sorted_positions.ctypes.data, pos_is_u32,
            chrom_offsets.ctypes.data, len(chrom_offsets), cap,
            chrom.ctypes.data, qs.ctypes.data, qe.ctypes.data,
            ts.ctypes.data, te.ctypes.data, na.ctypes.data,
            cov.ctypes.data)
        if n >= 0:
            # views into reused buffers: valid only until the next call
            return (chrom[:n], qs[:n], qe[:n], ts[:n], te[:n], na[:n],
                    cov[:n])
        _SEED_BUFS = _make_seed_bufs(-n)


def native_lookup_ranges(sorted_hashes: np.ndarray, bucket_lo: np.ndarray,
                         bucket_bits: int,
                         queries: np.ndarray):
    """Per-query [lo, hi) ranges in the sorted hash array."""
    lib = load_native()
    if lib is None:
        return None
    queries = np.ascontiguousarray(queries, np.uint64)
    lo = np.empty(len(queries), np.int64)
    hi = np.empty(len(queries), np.int64)
    lib.lookup_ranges_c(sorted_hashes.ctypes.data, bucket_lo.ctypes.data,
                        bucket_bits, queries.ctypes.data, len(queries),
                        lo.ctypes.data, hi.ctypes.data)
    return lo, hi


def native_solve_dp_batch(q_list, t_list, modes, match, mismatch,
                          gap_open, gap_extend, end_bonus, zdrop=0):
    """Batched affine-gap DP through the C++ scalar twin of
    extend._solve_one (bit-identical integer math). q_list/t_list are
    uint8 code arrays; modes[i] is 0 (global) or 1 (extension). Returns
    (q_lens, t_lens, n_ops, ops_op, ops_dq, ops_dt) — ops concatenated in
    problem order."""
    lib = load_native()
    if lib is None:
        return None
    n = len(q_list)
    q_off = np.zeros(n + 1, np.int64)
    t_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(q) for q in q_list], out=q_off[1:])
    np.cumsum([len(t) for t in t_list], out=t_off[1:])
    q_all = (np.concatenate(q_list) if q_off[-1]
             else np.zeros(0, np.uint8)).astype(np.uint8, copy=False)
    t_all = (np.concatenate(t_list) if t_off[-1]
             else np.zeros(0, np.uint8)).astype(np.uint8, copy=False)
    modes_arr = np.asarray(modes, np.uint8)
    q_lens = np.empty(n, np.int32)
    t_lens = np.empty(n, np.int32)
    n_ops = np.empty(n, np.int64)
    cap = int(q_off[-1] + t_off[-1]) + n + 1
    ops_op = np.empty(cap, np.int8)
    ops_dq = np.empty(cap, np.int32)
    ops_dt = np.empty(cap, np.int32)
    total = lib.solve_dp_batch_c(
        q_all.ctypes.data, q_off.ctypes.data,
        t_all.ctypes.data, t_off.ctypes.data,
        modes_arr.ctypes.data, n, match, mismatch, gap_open, gap_extend,
        end_bonus, zdrop, q_lens.ctypes.data, t_lens.ctypes.data,
        n_ops.ctypes.data, ops_op.ctypes.data, ops_dq.ctypes.data,
        ops_dt.ctypes.data, cap)
    assert total >= 0, "native DP ops capacity undersized"
    return q_lens, t_lens, n_ops, ops_op[:total], ops_dq[:total], ops_dt[:total]


def native_emit_psl(q: np.ndarray, g: np.ndarray, op_arr: np.ndarray,
                    q0_arr: np.ndarray, t0_arr: np.ndarray,
                    ln_arr: np.ndarray):
    """Stats + merged blocks + long cs string for concrete alignment runs
    (C++ twin of aligner._runs_to_psl's loop; ops 0=M 1=I 2=D 3=N).
    Returns (stats[8], blk_sizes, blk_q, blk_t, cs_str)."""
    lib = load_native()
    if lib is None:
        return None
    n = len(op_arr)
    stats = np.zeros(8, np.int64)
    blk_sizes = np.empty(n, np.int64)
    blk_q = np.empty(n, np.int64)
    blk_t = np.empty(n, np.int64)
    cap = int(3 * ln_arr.sum() + 30 * n) + 1
    cs = ctypes.create_string_buffer(cap)
    cl = lib.emit_psl_c(q.ctypes.data, g.ctypes.data, op_arr.ctypes.data,
                        q0_arr.ctypes.data, t0_arr.ctypes.data,
                        ln_arr.ctypes.data, n, stats.ctypes.data,
                        blk_sizes.ctypes.data, blk_q.ctypes.data,
                        blk_t.ctypes.data, cs, cap)
    assert cl >= 0, "native cs capacity undersized"
    nb = int(stats[7])
    return (stats, blk_sizes[:nb], blk_q[:nb], blk_t[:nb],
            cs.raw[:cl].decode())


_CHAIN_BUFS = tuple(np.empty(512, np.int64) for _ in range(4))


def native_seed_chain(codes: np.ndarray, k: int, w: int, max_occ: int,
                      merge_gap: int, sorted_hashes: np.ndarray,
                      bucket_lo: np.ndarray, bucket_bits: int,
                      sorted_positions: np.ndarray,
                      chrom_offsets: np.ndarray, min_intron: int,
                      max_intron: int, match: int = 1,
                      intron_penalty: float = 12.0, indel_open: float = 4.0,
                      indel_scale: float = 0.3, max_segments: int = 512):
    """Fused seed + per-chromosome chain for one read orientation (C++
    twin of aligner._chain_for's seeding + chain.chain_segments, identical
    float32 cost arithmetic). Returns (q0, qe, t0, te, score, chrom_idx) —
    the winning chain's segment arrays are views into reused buffers,
    valid until the next call."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    pos_is_u32 = 1 if sorted_positions.dtype == np.uint32 else 0
    q0, qe, t0, te = _CHAIN_BUFS
    score = ctypes.c_float()
    chrom = ctypes.c_int32()
    n = lib.seed_chain_c(
        codes.ctypes.data, len(codes), k, w, max_occ, merge_gap,
        sorted_hashes.ctypes.data, bucket_lo.ctypes.data, bucket_bits,
        sorted_positions.ctypes.data, pos_is_u32,
        chrom_offsets.ctypes.data, len(chrom_offsets),
        min_intron, max_intron, match, intron_penalty, indel_open,
        indel_scale, max_segments, q0.ctypes.data, qe.ctypes.data,
        t0.ctypes.data, te.ctypes.data, ctypes.byref(score),
        ctypes.byref(chrom))
    return q0[:n], qe[:n], t0[:n], te[:n], float(score.value), int(chrom.value)


def native_seed_chain2(codes: np.ndarray, k: int, w: int, max_occ: int,
                       merge_gap: int, sorted_hashes: np.ndarray,
                       bucket_lo: np.ndarray, bucket_bits: int,
                       sorted_positions: np.ndarray,
                       chrom_offsets: np.ndarray, min_intron: int,
                       max_intron: int, match: int = 1,
                       intron_penalty: float = 12.0,
                       indel_open: float = 4.0, indel_scale: float = 0.3,
                       max_segments: int = 512):
    """Both-orientation seed + chain in one call (forward wins score ties,
    matching map_batch). Returns (q0, qe, t0, te, score, chrom_idx,
    strand) with strand 0=forward / 1=reverse / -1=no chain; chain arrays
    are views into reused buffers."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    pos_is_u32 = 1 if sorted_positions.dtype == np.uint32 else 0
    q0, qe, t0, te = _CHAIN_BUFS
    score = ctypes.c_float()
    chrom = ctypes.c_int32()
    strand = ctypes.c_int32()
    n = lib.seed_chain2_c(
        codes.ctypes.data, len(codes), k, w, max_occ, merge_gap,
        sorted_hashes.ctypes.data, bucket_lo.ctypes.data, bucket_bits,
        sorted_positions.ctypes.data, pos_is_u32,
        chrom_offsets.ctypes.data, len(chrom_offsets),
        min_intron, max_intron, match, intron_penalty, indel_open,
        indel_scale, max_segments, q0.ctypes.data, qe.ctypes.data,
        t0.ctypes.data, te.ctypes.data, ctypes.byref(score),
        ctypes.byref(chrom), ctypes.byref(strand))
    return (q0[:n], qe[:n], t0[:n], te[:n], float(score.value),
            int(chrom.value), int(strand.value))


_ALIGN_BUFS = {"cap": 0}


def native_align_read(codes: np.ndarray, k: int, w: int, max_occ: int,
                      merge_gap: int, index, min_intron: int,
                      max_intron: int, chain_match: int,
                      intron_penalty: float, indel_open: float,
                      indel_scale: float, max_segments: int,
                      min_chain_score: float, dp_match: int,
                      dp_mismatch: int, gap_open: int, gap_extend: int,
                      end_bonus: int, zdrop: int, band_width: int,
                      max_end_extend: int,
                      splice_slack: int, noncanonical_penalty: int):
    """Fully-fused per-read alignment (seed+chain+fill+DP+emit in one C
    call). Returns (strand, chrom_idx, stats, block_sizes, q_starts,
    t_starts, cs) with strand None when unaligned."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes)
    cap = max(2 * n + 64, 4096)
    if _ALIGN_BUFS["cap"] < cap:
        _ALIGN_BUFS["cap"] = cap
        _ALIGN_BUFS["blk"] = tuple(np.empty(cap, np.int64)
                                   for _ in range(3))
        _ALIGN_BUFS["cs"] = ctypes.create_string_buffer(8 * cap)
    bs, bq, bt = _ALIGN_BUFS["blk"]
    stats = np.zeros(8, np.int64)
    strand = ctypes.c_int32()
    chrom = ctypes.c_int32()
    pos_is_u32 = 1 if index.sorted_positions.dtype == np.uint32 else 0
    cs_cap = 8 * cap
    cs_buf = _ALIGN_BUFS["cs"]
    while True:
        cl = lib.align_read_c(
            codes.ctypes.data, n, k, w, max_occ, merge_gap,
            index.sorted_hashes.ctypes.data, index.bucket_lo.ctypes.data,
            index.bucket_bits,
            index.sorted_positions.ctypes.data, pos_is_u32,
            index.chrom_offsets.ctypes.data, index.chrom_sizes.ctypes.data,
            len(index.chrom_offsets), index.seq_codes.ctypes.data,
            min_intron, max_intron, chain_match, intron_penalty,
            indel_open, indel_scale, max_segments, min_chain_score,
            dp_match, dp_mismatch, gap_open, gap_extend, end_bonus,
            zdrop, band_width, max_end_extend, splice_slack,
            noncanonical_penalty, ctypes.byref(strand),
            ctypes.byref(chrom), stats.ctypes.data, bs.ctypes.data,
            bq.ctypes.data, bt.ctypes.data, cs_buf, cs_cap,
            0, None, None, None, None, 0)
        if cl >= 0:
            break
        cs_cap = 2 * (-cl) + 64  # undersized cs buffer: retry bigger
        cs_buf = ctypes.create_string_buffer(cs_cap)
        _ALIGN_BUFS["cs"] = cs_buf
    nb = int(stats[7])
    if strand.value < 0 or nb == 0:
        return (None, -1, None, None, None, None, "")
    return (int(strand.value), int(chrom.value), stats,
            bs[:nb].tolist(), bq[:nb].tolist(), bt[:nb].tolist(),
            cs_buf.raw[:cl].decode())


def native_align_read_runs(codes: np.ndarray, k: int, w: int, max_occ: int,
                           merge_gap: int, index, min_intron: int,
                           max_intron: int, chain_match: int,
                           intron_penalty: float, indel_open: float,
                           indel_scale: float, max_segments: int,
                           min_chain_score: float, dp_match: int,
                           dp_mismatch: int, gap_open: int,
                           gap_extend: int, end_bonus: int, zdrop: int,
                           band_width: int, max_end_extend: int,
                           splice_slack: int, noncanonical_penalty: int):
    """align_read_c in runs mode: returns (strand, chrom_idx,
    [(op_char, q0, t0, len), ...]) with strand None when unaligned."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes)
    # runs <= q-advancing ops (~2n worst case) + per-gap structural ops
    # (N/D runs, <= ~3 per chain segment, 512 segments max)
    cap = max(2 * n + 4096, 8192)
    r_op = np.empty(cap, np.int8)
    r_q = np.empty(cap, np.int64)
    r_t = np.empty(cap, np.int64)
    r_l = np.empty(cap, np.int64)
    strand = ctypes.c_int32()
    chrom = ctypes.c_int32()
    pos_is_u32 = 1 if index.sorted_positions.dtype == np.uint32 else 0
    count = lib.align_read_c(
        codes.ctypes.data, n, k, w, max_occ, merge_gap,
        index.sorted_hashes.ctypes.data, index.bucket_lo.ctypes.data,
        index.bucket_bits,
        index.sorted_positions.ctypes.data, pos_is_u32,
        index.chrom_offsets.ctypes.data, index.chrom_sizes.ctypes.data,
        len(index.chrom_offsets), index.seq_codes.ctypes.data,
        min_intron, max_intron, chain_match, intron_penalty,
        indel_open, indel_scale, max_segments, min_chain_score,
        dp_match, dp_mismatch, gap_open, gap_extend, end_bonus, zdrop,
        band_width, max_end_extend, splice_slack, noncanonical_penalty,
        ctypes.byref(strand), ctypes.byref(chrom), None, None, None,
        None, None, 0, 1, r_op.ctypes.data, r_q.ctypes.data,
        r_t.ctypes.data, r_l.ctypes.data, cap)
    assert count >= 0, "runs capacity undersized"
    if strand.value < 0 or count == 0:
        return (None, -1, [])
    ops = "MIDN"
    runs = [(ops[r_op[i]], int(r_q[i]), int(r_t[i]), int(r_l[i]))
            for i in range(count)]
    return (int(strand.value), int(chrom.value), runs)


def native_parse_cs(cs: str, genome_start: int):
    """Tokenize a long-form cs string (C++ twin of csparse.build_cs_index).
    Returns (status, gp, advances, introns_dict), or None when the string
    is malformed (the caller then reports it through the Python parser)."""
    lib = load_native()
    if lib is None:
        return None
    raw = cs.encode()
    cap = max(len(raw), 1)
    status = np.empty(cap, np.int8)
    gp = np.empty(cap, np.int64)
    advances = np.empty(cap, np.uint8)
    icap = cap // 5 + 1
    intron_idx = np.empty(icap, np.int64)
    motifs = ctypes.create_string_buffer(icap * 4)
    n_introns = ctypes.c_int64()
    n = lib.parse_cs_c(raw, len(raw), genome_start, status.ctypes.data,
                       gp.ctypes.data, advances.ctypes.data,
                       intron_idx.ctypes.data, motifs,
                       ctypes.byref(n_introns))
    if n < 0:
        return None
    ni = int(n_introns.value)
    introns = {int(intron_idx[i]): motifs.raw[i * 4:i * 4 + 4].decode()
               for i in range(ni)}
    return status[:n], gp[:n], advances[:n].astype(bool), introns


def native_poa_consensus(seqs, params) -> Optional[np.ndarray]:
    """Graph-POA consensus of oriented code arrays via the C++ banded
    engine (bit-identical to poa.graph.poa_consensus — the host fast path
    of the graph consensus engine). Returns the consensus codes."""
    lib = load_native()
    if lib is None:
        return None
    lens = np.array([len(s) for s in seqs], np.int64)
    flat = (np.concatenate([np.ascontiguousarray(s, np.uint8)
                            for s in seqs])
            if len(seqs) else np.zeros(0, np.uint8))
    out = np.empty(int(lens.sum()) + 1, np.uint8)
    n = lib.poa_consensus_c(
        flat.ctypes.data, lens.ctypes.data, len(seqs),
        params.match, params.mismatch, params.gap_open, params.gap_extend,
        params.gap_open2, params.gap_extend2, params.band,
        1 if params.adaptive else 0, out.ctypes.data)
    if n == -2:
        raise ValueError("native POA engine: query longer than 2^24-2 "
                         "bases (packed prefix-max key limit)")
    if n < 0:
        raise RuntimeError("native POA traceback lost (bug)")
    return out[:n].copy()


def native_poa_align(graph, q, params):
    """One banded alignment of query codes vs a PoaGraph via C++;
    returns the (qi, node|None) path exactly like PoaGraph.align.
    Parity-test entry (the production path is native_poa_consensus,
    which keeps the graph in C++)."""
    lib = load_native()
    if lib is None:
        return None
    order = graph.topo_order()
    rank = {v: r for r, v in enumerate(order)}
    n = len(order)
    base_r = np.fromiter((graph.base[v] for v in order), np.int32, n)
    preds_off = np.zeros(n + 1, np.int64)
    flat: list = []
    for r, v in enumerate(order):
        ps = graph.preds[v]
        if ps:
            flat.extend(rank[u] + 1 for u in ps)
        else:
            flat.append(0)
        preds_off[r + 1] = len(flat)
    preds_flat = np.array(flat, np.int32)
    is_end = np.fromiter((not graph.succs[v] for v in order), np.uint8, n)
    qa = np.ascontiguousarray(q, np.uint8)
    steps = np.empty((n + len(qa) + 2, 2), np.int32)
    k = lib.poa_align_c(
        base_r.ctypes.data, n, preds_flat.ctypes.data,
        preds_off.ctypes.data, is_end.ctypes.data,
        qa.ctypes.data, len(qa),
        params.match, params.mismatch, params.gap_open, params.gap_extend,
        params.gap_open2, params.gap_extend2, params.band,
        1 if params.adaptive else 0, steps.ctypes.data)
    if k == -2:
        raise ValueError("native POA engine: query longer than 2^24-2 "
                         "bases (packed prefix-max key limit)")
    if k < 0:
        raise RuntimeError("native POA traceback lost (bug)")
    return [(int(qi), order[rk] if rk >= 0 else None)
            for qi, rk in steps[:k]]


# ----------------------------------------------------------------------
# Device-path batch staging (VERDICT r4 #1): python wrappers for the three
# stage_*_batch_c phases. See minimizers.cpp for the phase contracts; the
# staged device path in align/aligner.py (_map_batch_device_staged) is the
# only caller.


def _stage_candidates(call, n_reads: int, max_segments: int):
    """Run a phase-A entry (`call(cap, *outputs)`) with growing caps until
    its candidates fit; returns the phase-A tuple."""
    cap = max(64, 2 * n_reads)
    while True:
        cand_read = np.zeros(cap, np.int32)
        cand_strand = np.zeros(cap, np.int8)
        cand_chrom = np.zeros(cap, np.int32)
        cand_tbase = np.zeros(cap, np.int64)
        cand_nseg = np.zeros(cap, np.int32)
        segs = tuple(np.zeros((cap, max_segments), np.int32)
                     for _ in range(5))
        n = call(cap, cand_read.ctypes.data, cand_strand.ctypes.data,
                 cand_chrom.ctypes.data, cand_tbase.ctypes.data,
                 cand_nseg.ctypes.data, *(s.ctypes.data for s in segs))
        if n >= 0:
            return (int(n), cand_read, cand_strand, cand_chrom,
                    cand_tbase, cand_nseg, segs)
        cap = -n + 16


def native_stage_seed_batch(codes_all: np.ndarray, read_off: np.ndarray,
                            k: int, w: int, max_occ: int, merge_gap: int,
                            index, max_intron: int,
                            max_segments: int = 512, threads: int = 1):
    """Phase A: seed + prepare every (read, orientation, chromosome)
    candidate in one C call, packed straight into the chain kernel's
    zero-padded (cap, max_segments) int32 input rows. Returns
    (n_cand, cand_read, cand_strand, cand_chrom, cand_tbase, cand_nseg,
    (qs, qe, ts, te, cov)), the same for every `threads`: the call seeds
    on `native_stage_seed_threads(n_reads, threads)` threads of its own,
    all joined before it returns."""
    lib = load_native()
    if lib is None:
        return None
    n_reads = len(read_off) - 1
    pos_is_u32 = 1 if index.sorted_positions.dtype == np.uint32 else 0
    return _stage_candidates(
        lambda cap, *out: lib.stage_seed_batch_c(
            codes_all.ctypes.data, read_off.ctypes.data, n_reads,
            k, w, max_occ, merge_gap,
            index.sorted_hashes.ctypes.data, index.bucket_lo.ctypes.data,
            index.bucket_bits, index.sorted_positions.ctypes.data,
            pos_is_u32, index.chrom_offsets.ctypes.data,
            len(index.chrom_offsets), max_intron, max_segments, cap, *out,
            threads),
        n_reads, max_segments)


def native_stage_seed_threads(n_reads: int, threads: int) -> Optional[int]:
    """The threads `native_stage_seed_batch` runs `n_reads` reads on when
    given `threads`: at most one a block of 16 reads, and 1 (its serial
    loop) below two blocks."""
    lib = load_native()
    if lib is None:
        return None
    return int(lib.stage_seed_threads_c(n_reads, threads))


def native_stage_seed_anchors(anchor_off: np.ndarray, anchor_q: np.ndarray,
                              anchor_g: np.ndarray, n_reads: int, k: int,
                              merge_gap: int, index, max_intron: int,
                              max_segments: int = 512):
    """Phase A from anchors a hash-sharded lookup found: orientation
    2r + s (s = 0 forward, 1 reverse) of read r holds anchors
    anchor_off[2r+s]:anchor_off[2r+s+1] (query position anchor_q, global
    genome position anchor_g). The same diagonal collapse, preparation
    and packing as `native_stage_seed_batch`, whose tuple it returns."""
    lib = load_native()
    if lib is None:
        return None
    off = np.ascontiguousarray(anchor_off, np.int64)
    q = np.ascontiguousarray(anchor_q, np.int64)
    g = np.ascontiguousarray(anchor_g, np.int64)
    if len(off) != 2 * n_reads + 1 or off[0] != 0 or \
            off[-1] != len(q) or len(g) != len(q) or \
            (len(off) > 1 and np.any(np.diff(off) < 0)):
        raise ValueError("anchor_off: 2 * n_reads + 1 ascending offsets "
                         "into anchor_q / anchor_g expected")
    chrom_offsets = np.ascontiguousarray(index.chrom_offsets, np.int64)
    return _stage_candidates(
        lambda cap, *out: lib.stage_seed_anchors_c(
            off.ctypes.data, q.ctypes.data, g.ctypes.data, n_reads, k,
            merge_gap, chrom_offsets.ctypes.data, len(chrom_offsets),
            max_intron, max_segments, cap, *out),
        n_reads, max_segments)


def native_stage_fill_batch(codes_all: np.ndarray, read_off: np.ndarray,
                            n_cand: int, cand_read, cand_strand,
                            cand_chrom, cand_tbase, cand_nseg, segs,
                            chain_rows: np.ndarray, index,
                            min_chain_score: float, min_intron: int,
                            dp_match: int, dp_mismatch: int, gap_open: int,
                            gap_extend: int, end_bonus: int, zdrop: int,
                            band_width: int, max_end_extend: int,
                            splice_slack: int, noncanonical_penalty: int,
                            max_segments: int = 512):
    """Phase B: chain pick per read + gap fill in collect mode. Returns
    (strand, chrom, oriented, run_off, (runs_op, q0, t0, len),
    (prob_read, mode, q0, t0, nq, nt)) — runs with op=4 are DP
    placeholders whose len is the global problem index."""
    lib = load_native()
    if lib is None:
        return None
    n_reads = len(read_off) - 1
    qs, qe, ts, te, _cov = segs
    chain_rows = np.ascontiguousarray(chain_rows, np.int16)
    strand = np.empty(n_reads, np.int32)
    chrom = np.empty(n_reads, np.int32)
    oriented = np.empty(int(read_off[-1]), np.uint8)
    run_off = np.empty(n_reads + 1, np.int64)
    out_counts = np.zeros(2, np.int64)
    total_seg = int(cand_nseg[:n_cand].sum())
    runs_cap = 4 * total_seg + 8 * n_reads + 64
    prob_cap = total_seg + 4 * n_reads + 64
    while True:
        runs_op = np.empty(runs_cap, np.int8)
        runs_q0 = np.empty(runs_cap, np.int64)
        runs_t0 = np.empty(runs_cap, np.int64)
        runs_len = np.empty(runs_cap, np.int64)
        prob_read = np.empty(prob_cap, np.int32)
        prob_mode = np.empty(prob_cap, np.uint8)
        prob_q0 = np.empty(prob_cap, np.int64)
        prob_t0 = np.empty(prob_cap, np.int64)
        prob_nq = np.empty(prob_cap, np.int64)
        prob_nt = np.empty(prob_cap, np.int64)
        rc = lib.stage_fill_batch_c(
            codes_all.ctypes.data, read_off.ctypes.data, n_reads, n_cand,
            cand_read.ctypes.data, cand_strand.ctypes.data,
            cand_chrom.ctypes.data, cand_tbase.ctypes.data,
            cand_nseg.ctypes.data,
            qs.ctypes.data, qe.ctypes.data, ts.ctypes.data, te.ctypes.data,
            max_segments, chain_rows.ctypes.data, chain_rows.shape[1],
            index.chrom_offsets.ctypes.data, index.chrom_sizes.ctypes.data,
            len(index.chrom_offsets), index.seq_codes.ctypes.data,
            min_chain_score, min_intron, dp_match, dp_mismatch, gap_open,
            gap_extend, end_bonus, zdrop, band_width, max_end_extend,
            splice_slack, noncanonical_penalty,
            strand.ctypes.data, chrom.ctypes.data, oriented.ctypes.data,
            run_off.ctypes.data, runs_op.ctypes.data, runs_q0.ctypes.data,
            runs_t0.ctypes.data, runs_len.ctypes.data, runs_cap,
            prob_read.ctypes.data, prob_mode.ctypes.data,
            prob_q0.ctypes.data, prob_t0.ctypes.data, prob_nq.ctypes.data,
            prob_nt.ctypes.data, prob_cap, out_counts.ctypes.data)
        if rc == 0:
            nr, npb = int(out_counts[0]), int(out_counts[1])
            return (strand, chrom, oriented, run_off,
                    (runs_op[:nr], runs_q0[:nr], runs_t0[:nr],
                     runs_len[:nr]),
                    (prob_read[:npb], prob_mode[:npb], prob_q0[:npb],
                     prob_t0[:npb], prob_nq[:npb], prob_nt[:npb]))
        runs_cap = int(out_counts[0]) + 64
        prob_cap = int(out_counts[1]) + 64


def native_stage_emit_batch(oriented: np.ndarray, read_off: np.ndarray,
                            genome: np.ndarray, strand: np.ndarray,
                            run_off: np.ndarray, runs, probs,
                            on_host: np.ndarray, dp_meta: np.ndarray,
                            dp_ks: np.ndarray, dp_buf: np.ndarray,
                            match: int, mismatch: int, gap_open: int,
                            gap_extend: int, end_bonus: int, zdrop: int):
    """Phase C: resolve DP placeholders (device results or inline host
    solver) and emit extended PSL per read. Returns (stats (n,8), blk_off,
    blk_sizes, blk_q, blk_t, cs_off, cs_bytes)."""
    lib = load_native()
    if lib is None:
        return None
    n_reads = len(read_off) - 1
    runs_op, runs_q0, runs_t0, runs_len = runs
    prob_read, prob_mode, prob_q0, prob_t0, prob_nq, prob_nt = probs
    dp_meta = np.ascontiguousarray(dp_meta, np.int32)
    dp_ks = np.ascontiguousarray(dp_ks, np.int32)
    dp_buf = np.ascontiguousarray(dp_buf, np.int8)
    if dp_buf.size == 0:
        dp_buf = np.zeros((max(len(prob_mode), 1), 1), np.int8)
    stats = np.zeros((n_reads, 8), np.int64)
    blk_off = np.zeros(n_reads + 1, np.int64)
    cs_off = np.zeros(n_reads + 1, np.int64)
    needs = np.zeros(2, np.int64)
    blk_cap = len(runs_op) + 2 * n_reads + 64
    cs_cap = 4 * int(read_off[-1]) + 64 * n_reads + 64
    while True:
        blk_sizes = np.empty(blk_cap, np.int64)
        blk_q = np.empty(blk_cap, np.int64)
        blk_t = np.empty(blk_cap, np.int64)
        cs = ctypes.create_string_buffer(cs_cap)
        rc = lib.stage_emit_batch_c(
            oriented.ctypes.data, read_off.ctypes.data, n_reads,
            genome.ctypes.data, strand.ctypes.data,
            run_off.ctypes.data, runs_op.ctypes.data, runs_q0.ctypes.data,
            runs_t0.ctypes.data, runs_len.ctypes.data,
            prob_mode.ctypes.data, prob_q0.ctypes.data,
            prob_t0.ctypes.data, prob_nq.ctypes.data, prob_nt.ctypes.data,
            on_host.ctypes.data, dp_meta.ctypes.data, dp_ks.ctypes.data,
            dp_buf.ctypes.data, dp_buf.shape[1] if dp_buf.ndim == 2 else 0,
            match, mismatch, gap_open, gap_extend, end_bonus, zdrop,
            stats.ctypes.data, blk_off.ctypes.data, blk_sizes.ctypes.data,
            blk_q.ctypes.data, blk_t.ctypes.data, blk_cap,
            cs_off.ctypes.data, cs, cs_cap, needs.ctypes.data)
        if rc == 0:
            return (stats, blk_off, blk_sizes, blk_q, blk_t, cs_off,
                    cs.raw)
        blk_cap = 2 * int(needs[0]) + 64
        cs_cap = 2 * int(needs[1]) + 64
