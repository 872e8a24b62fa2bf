"""Gap fill, splice-point search, end extension, and alignment emission.

The chain (align/chain.py) leaves three kinds of work:
- intron gaps (dt - dq >= min_intron): the exact splice point is found with
  a cumulative-match scan over all possible splits plus a canonical-motif
  bonus (GT..AG forward / CT..AC reverse-strand transcripts, -uf semantics)
  — one vectorized O(dq) pass, no DP;
- small indel gaps: global affine-gap DP;
- read-end tails: extension (semi-global) affine DP with best-cell stop.

DP problems are collected per batch and solved by the native C++ solver,
or its numpy twin `solve_dp_numpy` under MANDO_TPU_NO_NATIVE (the CUDA
kernel in align/kernels.py solves the same problem layout on the device
route), then ops are stitched and emitted as extended PSL.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from mandalorion_tpu_torch.config import AlignConfig

# op codes: (kind, q0, t0, length) — kind M diagonal run / I insert /
# D delete / N intron
BASES = "ACGT"
NEG = -(10 ** 9)


@dataclass
class DpProblem:
    """One pairwise DP sub-problem over uint8 code arrays."""

    q: np.ndarray
    t: np.ndarray
    mode: str  # 'global' | 'extend'


@dataclass
class DpResult:
    ops: List[Tuple[str, int, int]]  # (op, q_advance, t_advance) runs
    q_len: int                       # query consumed (extend mode)
    t_len: int


def solve_dp_numpy(problems: Sequence[DpProblem],
                   cfg: AlignConfig) -> List[DpResult]:
    """Affine-gap DP, row-vectorized numpy: the native solver's twin."""
    return [_solve_one(p, cfg) for p in problems]


def solve_dp_native(problems: Sequence[DpProblem],
                    cfg: AlignConfig) -> List[DpResult]:
    """Batched affine-gap DP through the native C++ solver: global gap
    fills and best-cell-stop extensions, same row math and tie-breaks as
    the device kernel (align/kernels.py). Under MANDO_TPU_NO_NATIVE,
    `solve_dp_numpy` (the same results)."""
    if not problems:
        return []
    from mandalorion_tpu_torch.native import native_solve_dp_batch
    res = native_solve_dp_batch(
        [p.q for p in problems], [p.t for p in problems],
        [0 if p.mode == "global" else 1 for p in problems],
        cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_extend,
        cfg.end_bonus, getattr(cfg, "zdrop", 0))
    if res is None:
        return solve_dp_numpy(problems, cfg)
    q_lens, t_lens, n_ops, ops_op, ops_dq, ops_dt = res
    out: List[DpResult] = []
    at = 0
    op_chars = "MID"
    for k in range(len(problems)):
        n = int(n_ops[k])
        ops = [(op_chars[ops_op[at + m]], int(ops_dq[at + m]),
                int(ops_dt[at + m])) for m in range(n)]
        at += n
        out.append(DpResult(ops, int(q_lens[k]), int(t_lens[k])))
    return out


def _row_step_np(h_prev, e_prev, sub, jidx, go, ge):
    """One DP row (same values, same tie-breaks as the native solver):
    one DP row with the collapsed prefix-max deletion state.
    Returns (h_row, e_row, packed_ptr_bits)."""
    open_e = h_prev - go - ge
    ext_e = e_prev - ge
    e_row = np.maximum(open_e, ext_e)
    e_ext = ext_e > open_e
    diag = np.empty_like(h_prev)
    diag[0] = NEG
    diag[1:] = h_prev[:-1] + sub
    b = np.maximum(diag, e_row)
    b[0] = e_row[0]
    scan = np.maximum.accumulate(b + ge * jidx)
    f_row = np.empty_like(h_prev)
    f_row[0] = NEG
    f_row[1:] = scan[:-1] - go - ge * jidx[1:]
    f_shift = np.empty_like(f_row)
    f_shift[0] = NEG
    f_shift[1:] = f_row[:-1]
    b_shift = np.empty_like(b)
    b_shift[0] = NEG
    b_shift[1:] = b[:-1]
    f_ext = (f_shift - ge) > (b_shift - go - ge)
    h_row = diag.copy()
    code = np.zeros(len(jidx), np.uint8)
    take_e = e_row > h_row
    h_row[take_e] = e_row[take_e]
    code[take_e] = 1
    take_f = f_row > h_row
    h_row[take_f] = f_row[take_f]
    code[take_f] = 2
    h_row[0] = e_row[0]
    code[0] = 1
    packed = (code | (e_ext.astype(np.uint8) << 2)
              | (f_ext.astype(np.uint8) << 3))
    return h_row, e_row, packed


def _traceback_bits(ptr: np.ndarray, qi: int, tj: int):
    """Walk packed pointer bits (H source 2b | E-ext | F-ext) to merged op
    runs — the native solver's and the device walk's op runs."""
    ops: List[Tuple[str, int, int]] = []
    i, j = qi, tj
    state = "H"
    while i > 0 or j > 0:
        p = int(ptr[i, j])
        if state == "H":
            code = p & 3
            if code == 0 and i > 0 and j > 0:
                ops.append(("M", 1, 1))
                i -= 1
                j -= 1
            elif code == 1:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            ops.append(("I", 1, 0))
            state = "E" if (p >> 2) & 1 else "H"
            i -= 1
        else:
            ops.append(("D", 0, 1))
            state = "F" if (p >> 3) & 1 else "H"
            j -= 1
    ops.reverse()
    merged: List[Tuple[str, int, int]] = []
    for op, dq, dt in ops:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + dq, merged[-1][2] + dt)
        else:
            merged.append((op, dq, dt))
    return merged


def _solve_one(p: DpProblem, cfg: AlignConfig) -> DpResult:
    """Affine-gap DP, fully row-vectorized (the same collapsed prefix-max
    row math as the native solver and the device kernel, numpy edition)."""
    nq, nt = len(p.q), len(p.t)
    # fast path: an extension whose query is an exact prefix of the target
    # is optimally all-match (any other path scores lower) — the common
    # case for clean read ends
    if p.mode != "global" and 0 < nq <= nt and np.array_equal(
            p.q, p.t[:nq]):
        return DpResult([("M", nq, nq)], nq, nq)
    if nq == 0 and nt == 0:
        return DpResult([], 0, 0)
    if nq == 0:
        return (DpResult([("D", 0, nt)], 0, nt) if p.mode == "global"
                else DpResult([], 0, 0))
    if nt == 0:
        return (DpResult([("I", nq, 0)], nq, 0) if p.mode == "global"
                else DpResult([], 0, 0))

    match, mis = cfg.match, -cfg.mismatch
    go, ge = cfg.gap_open, cfg.gap_extend
    width = nt + 1
    jidx = np.arange(width, dtype=np.int64)
    h = np.where(jidx == 0, 0, -(go + ge * jidx)).astype(np.int64)
    e = np.full(width, NEG, np.int64)
    ptr = np.zeros((nq + 1, width), np.uint8)
    ptr[0, 1:] = 2
    ptr[0, 2:] |= 1 << 3
    best_val, best_i, best_j = 0, 0, 0
    zdrop = getattr(cfg, "zdrop", 0)
    raw_best = 0  # H[0,0]; running best WITHOUT end bonus (zdrop baseline)
    for i in range(1, nq + 1):
        sub = np.where(p.t == p.q[i - 1], match, mis).astype(np.int64)
        h, e, packed = _row_step_np(h, e, sub, jidx, go, ge)
        ptr[i] = packed
        if p.mode != "global":
            raw_row = int(h.max())
            if zdrop > 0:
                # minimap2 -z analogue: stop extending once the score
                # falls more than zdrop below the running best; the
                # triggering row is not considered
                if raw_row < raw_best - zdrop:
                    break
                if raw_row > raw_best:
                    raw_best = raw_row
            eff = h if (cfg.end_bonus == 0 or i != nq) else h + cfg.end_bonus
            row_best = int(eff.max())
            if row_best > best_val:
                best_val = row_best
                best_i = i
                best_j = int(eff.argmax())
    if p.mode == "global":
        qi, tj = nq, nt
    else:
        if best_val <= 0:
            return DpResult([], 0, 0)
        qi, tj = best_i, best_j
    return DpResult(_traceback_bits(ptr, qi, tj), qi, tj)


def splice_fill(q: np.ndarray, t_left: np.ndarray, t_right: np.ndarray,
                donor_codes: np.ndarray, acceptor_codes: np.ndarray,
                strand: str, noncanonical_penalty: int
                ) -> Tuple[int, int]:
    """Choose the splice split s in [0, dq]: q[:s] aligns before the intron,
    q[s:] after. donor_codes[s] = 2-mer code id at intron start for split s;
    acceptor_codes[s] = 2-mer at intron end. Returns (s, matches)."""
    dq = len(q)
    eq_l = (q == t_left[:dq]).astype(np.int32) if dq else np.zeros(0, np.int32)
    eq_r = (q == t_right[-dq:]).astype(np.int32) if dq else np.zeros(0, np.int32)
    cum_l = np.zeros(dq + 1, np.int32)
    np.cumsum(eq_l, out=cum_l[1:])
    cum_r = np.zeros(dq + 1, np.int32)
    np.cumsum(eq_r[::-1], out=cum_r[1:])
    sum_r = cum_r[::-1]  # matches in q[s:] aligned right
    if strand == "+":
        want_d, want_a = (2, 3), (0, 2)        # GT ... AG
    else:
        want_d, want_a = (1, 3), (0, 1)        # CT ... AC
    canon = ((donor_codes[:, 0] == want_d[0])
             & (donor_codes[:, 1] == want_d[1])
             & (acceptor_codes[:, 0] == want_a[0])
             & (acceptor_codes[:, 1] == want_a[1]))
    score = cum_l + sum_r + np.where(canon, noncanonical_penalty, 0)
    s = int(np.argmax(score))
    return s, int(cum_l[s] + sum_r[s])
