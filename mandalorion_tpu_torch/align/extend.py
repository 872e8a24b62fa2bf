"""Gap fill, splice-point search, end extension, and alignment emission.

The chain (align/chain.py) leaves three kinds of work:
- intron gaps (dt - dq >= min_intron): the exact splice point is found with
  a cumulative-match scan over all possible splits plus a canonical-motif
  bonus (GT..AG forward / CT..AC reverse-strand transcripts, -uf semantics)
  — one vectorized O(dq) pass, no DP;
- small indel gaps: global affine-gap DP;
- read-end tails: extension (semi-global) affine DP with best-cell stop.

DP problems are collected per batch and solved by the native C++ solver
(the CUDA kernel in align/kernels.py solves the same problem layout on
the device route), then ops are stitched and emitted as extended PSL.
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


def solve_dp_native(problems: Sequence[DpProblem],
                    cfg: AlignConfig) -> List[DpResult]:
    """Batched affine-gap DP through the native C++ solver: global gap
    fills and best-cell-stop extensions, same row math and tie-breaks as
    the device kernel (align/kernels.py)."""
    if not problems:
        return []
    from mandalorion_tpu_torch.native import native_solve_dp_batch
    q_lens, t_lens, n_ops, ops_op, ops_dq, ops_dt = native_solve_dp_batch(
        [p.q for p in problems], [p.t for p in problems],
        [0 if p.mode == "global" else 1 for p in problems],
        cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_extend,
        cfg.end_bonus, getattr(cfg, "zdrop", 0))
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
