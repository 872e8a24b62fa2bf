"""Anchor chaining: minimizer anchors → diagonal segments → best chain.

Anchors that share a diagonal (tpos - qpos) collapse into exact-diagonal
segments (no indel possible inside, substitutions resolved later at cs
emission), then a small O(n²) DP chains segments with splice-aware gap
costs — the classic collinear-block formulation of minimap2's chain DP
(minimap2 paper §2.1, PAPERS.md), sized so the per-read segment count is
tens, not thousands.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Segment:
    """Maximal same-diagonal run: query [q_start, q_end) matches target
    [t_start, t_end) with t - q constant (substitutions allowed).

    `cov` is the number of bases actually covered by the union of the
    segment's k-mer anchors (0 = unknown, treated as the full span). The
    chain DP scores cov, not span (minimap2 §2.1 sums anchor
    contributions): a merge-gap-bridged segment over diverged sequence —
    e.g. a processed-pseudogene decoy — must not score the bases its
    anchors never matched (simulate.make_adversarial_dataset catches
    exactly this)."""

    q_start: int
    q_end: int
    t_start: int
    t_end: int
    n_anchors: int = 1
    cov: int = 0

    @property
    def diag(self) -> int:
        return self.t_start - self.q_start

    @property
    def length(self) -> int:
        return self.q_end - self.q_start

    @property
    def score_len(self) -> int:
        """Anchor-covered length used by the chain score (span when the
        anchor union is unknown)."""
        return self.cov if self.cov > 0 else self.q_end - self.q_start


def collapse_anchors(q_pos: np.ndarray, t_pos: np.ndarray, k: int,
                     merge_gap: int = 100) -> List[Segment]:
    """Merge anchors on the same diagonal with spacing <= merge_gap into
    segments. Input: anchor start positions (k-mer starts)."""
    if len(q_pos) == 0:
        return []
    diag = t_pos - q_pos
    order = np.lexsort((t_pos, diag))
    d, q, t = diag[order], q_pos[order], t_pos[order]
    new_seg = np.ones(len(d), bool)
    new_seg[1:] = (d[1:] != d[:-1]) | (t[1:] - t[:-1] > merge_gap + k)
    segments: List[Segment] = []
    starts = np.nonzero(new_seg)[0]
    ends = np.append(starts[1:], len(d))
    # anchor-union coverage: k for the first anchor, min(k, dt) for each
    # following anchor on the same diagonal
    dt_cov = np.minimum(np.diff(t, prepend=t[:1]), k)
    for s, e in zip(starts, ends):
        cov = int(k + dt_cov[s + 1:e].sum())
        segments.append(Segment(
            q_start=int(q[s]), q_end=int(q[e - 1]) + k,
            t_start=int(t[s]), t_end=int(t[e - 1]) + k,
            n_anchors=int(e - s), cov=cov))
    return segments


def prepare_segments(segments: List[Segment], max_intron: int,
                     max_segments: int = 512) -> List[Segment]:
    """Shared pre-DP segment filter for BOTH chain backends (numpy and
    chain_kernel): drop spurious single-anchor segments on far-off
    diagonals once multi-anchor segments cover >=30% of the read, cap at
    max_segments by length, sort by (q_start, t_start)."""
    multi = [s for s in segments if s.n_anchors > 1]
    if multi and len(multi) < len(segments):
        covered = sum(s.length for s in multi)
        read_span = max(s.q_end for s in segments) - min(
            s.q_start for s in segments)
        if covered >= 0.3 * max(read_span, 1):
            multi_diags = np.array([s.diag for s in multi])
            kept = list(multi)
            for s in segments:
                if s.n_anchors > 1:
                    continue
                gap = int(np.abs(s.diag - multi_diags).min())
                # same-diagonal neighborhood or a plausible intron jump
                # from some multi segment (terminal small exons)
                if gap <= max_intron:
                    kept.append(s)
            segments = kept
    if len(segments) > max_segments:
        segments = sorted(segments, key=lambda s: -s.length)[:max_segments]
    return sorted(segments, key=lambda s: (s.q_start, s.t_start))


def chain_segments(segments: List[Segment], *, min_intron: int,
                   max_intron: int, match: int = 1,
                   intron_penalty: float = 12.0,
                   indel_open: float = 4.0, indel_scale: float = 0.3,
                   max_segments: int = 512
                   ) -> Tuple[List[Segment], float]:
    """Best-scoring collinear chain via O(n²) DP over segments sorted by
    query start. Returns (chain segments in order, score)."""
    if not segments:
        return [], 0.0
    segments = prepare_segments(segments, max_intron, max_segments)
    n = len(segments)
    qs = np.array([s.q_start for s in segments])
    qe = np.array([s.q_end for s in segments])
    ts = np.array([s.t_start for s in segments])
    te = np.array([s.t_end for s in segments])
    lens = (qe - qs).astype(np.float32)  # float32: matches chain_kernel
    # score term = anchor-covered length (see Segment.cov); geometry
    # (validity, overlaps) stays span-based
    covs = np.array([s.score_len for s in segments]).astype(np.float32)

    # precompute the full (i, j) transition matrix in one shot; the
    # sequential DP loop then reduces to one masked argmax per row.
    # All cost arithmetic is float32 with the same expression shape as
    # chain_kernel so the two backends agree (up to transcendental-ulp
    # differences in log2, see CLAUDE.md)
    dq = qs[:, None] - qe[None, :]
    dt = ts[:, None] - te[None, :]
    overlap = np.maximum(np.maximum(-dq, -dt), 0).astype(np.float32)
    tri = np.tril(np.ones((n, n), bool), -1)  # j < i
    valid = (tri & (dq > -lens[None, :]) & (dt > -lens[None, :])
             & (dt <= max_intron)
             & (qe[None, :] <= qe[:, None]) & (te[None, :] <= te[:, None]))
    gap_q = np.maximum(dq, 0)
    gap_t = np.maximum(dt, 0)
    diff32 = np.abs(gap_t - gap_q).astype(np.float32)
    is_intron = (gap_t - gap_q) >= min_intron
    # length term: the binary exponent of the gap (frexp), not log2 — an
    # integer every backend (numpy / CUDA / C++) computes EXACTLY, so the
    # three chain backends stay bit-identical (no transcendental ulps)
    _, intron_e = np.frexp(np.maximum(diff32, np.float32(1.0)))
    cost = np.where(
        is_intron,
        np.float32(intron_penalty)
        + np.float32(0.01) * intron_e.astype(np.float32),
        np.float32(indel_open) + np.float32(indel_scale) * diff32,
    ).astype(np.float32)

    score = (covs * match).astype(np.float32)
    parent = np.full(n, -1, np.int64)
    neg_inf = np.float32(-np.inf)
    for i in range(1, n):
        # same association as chain_kernel: ((score + cov*m) - cost) - o*m
        cand = (score[:i] + np.float32(covs[i] * match)) - cost[i, :i]             - overlap[i, :i] * np.float32(match)
        cand = np.where(valid[i, :i], cand, neg_inf)
        j = int(np.argmax(cand))
        if cand[j] > score[i]:
            score[i] = cand[j]
            parent[i] = j

    best = int(np.argmax(score))
    chain_idx = []
    at = best
    while at >= 0:
        chain_idx.append(at)
        at = int(parent[at])
    chain_idx.reverse()

    # trim overlaps so the chain is strictly increasing in q and t
    chain: List[Segment] = []
    prev_q = prev_t = -1
    for idx in chain_idx:
        s = segments[idx]
        trim = max(prev_q - s.q_start, prev_t - s.t_start, 0)
        q0, t0 = s.q_start + trim, s.t_start + trim
        if q0 >= s.q_end or t0 >= s.t_end:
            continue
        chain.append(Segment(q0, s.q_end, t0, s.t_end))
        prev_q, prev_t = s.q_end, s.t_end
    return chain, float(score[best])
