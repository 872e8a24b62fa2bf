"""Long-form cs-string parsing for splice-junction validation.

Behavioral equivalent of `SpliceDefineConsensus.getCSaroundSS` (SDC.py:107-161)
but tokenized ONCE per read into columnar arrays instead of re-walking the
whole string per (splice site, read) pair — the reference's hottest pure-
Python loop (SURVEY §3.2).

Record model (matching the reference's per-base `record` list):
  '=' match        : one record per base, genome position +1
  '+' insertion    : one record per base, genome position unchanged
  '-' deletion     : one record per base, genome position +1
  '*' substitution : one record per pair,  genome position +1
  '~' intron       : ONE record,           genome position += intron length
spliceIndex = 1 + index of the LAST genome-advancing record whose genome
position lies in [start, end]; the intron searched for is the last intron
record in record[spliceIndex-10 : spliceIndex+10]; bases = donor+acceptor,
left/right = the 5 records before/after the intron record.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

_CS_TOKEN = re.compile(r"([=+\-*~])([^=+\-*~]+)")

# status codes
EQ, INS, DEL, SUB, INTRON = 0, 1, 2, 3, 4
_STATUS_CHAR = {EQ: "=", INS: "+", DEL: "-", SUB: "*", INTRON: "~"}


@dataclass
class CsIndex:
    """Per-read tokenized cs string.

    status[i]   — record status code
    gp[i]       — genome position AFTER record i (cumulative)
    advances[i] — whether record i advanced the genome position
    introns     — record index -> 4-char motif (donor+acceptor, lowercase)
    """

    status: np.ndarray
    gp: np.ndarray
    advances: np.ndarray
    introns: Dict[int, str]


def build_cs_index(cs: str, genome_start: int) -> CsIndex:
    """Tokenize a long-form cs string starting at genome_start (tStart).
    Uses the native C++ tokenizer when available (bit-identical record
    model; tests/test_native.py), falling back to the numpy path."""
    from mandalorion_tpu_torch.native import native_parse_cs
    res = native_parse_cs(cs, genome_start)
    if res is not None:
        status, gp, advances, introns = res
        return CsIndex(status, gp, advances, introns)
    return _build_cs_index_numpy(cs, genome_start)


def _build_cs_index_numpy(cs: str, genome_start: int) -> CsIndex:
    statuses: List[np.ndarray] = []
    gsteps: List[np.ndarray] = []
    introns: Dict[int, str] = {}
    n_records = 0
    for op, body in _CS_TOKEN.findall(cs):
        if op == "=":
            k = len(body)
            statuses.append(np.full(k, EQ, np.int8))
            gsteps.append(np.ones(k, np.int64))
            n_records += k
        elif op == "+":
            k = len(body)
            statuses.append(np.full(k, INS, np.int8))
            gsteps.append(np.zeros(k, np.int64))
            n_records += k
        elif op == "-":
            k = len(body)
            statuses.append(np.full(k, DEL, np.int8))
            gsteps.append(np.ones(k, np.int64))
            n_records += k
        elif op == "*":
            # one record per substitution pair (ref base + read base)
            statuses.append(np.full(1, SUB, np.int8))
            gsteps.append(np.ones(1, np.int64))
            n_records += 1
        elif op == "~":
            # body like gt123ag
            length = int(body[2:-2])
            introns[n_records] = body[:2] + body[-2:]
            statuses.append(np.full(1, INTRON, np.int8))
            gsteps.append(np.array([length], np.int64))
            n_records += 1
    if n_records == 0:
        return CsIndex(np.zeros(0, np.int8), np.zeros(0, np.int64),
                       np.zeros(0, bool), {})
    status = np.concatenate(statuses)
    steps = np.concatenate(gsteps)
    gp = genome_start + np.cumsum(steps)
    return CsIndex(status, gp, steps > 0, introns)


def splice_context(idx: CsIndex, start: int, end: int
                   ) -> Tuple[str, Optional[np.ndarray], Optional[np.ndarray]]:
    """Return (motif_bases, left_statuses, right_statuses) around the splice
    site in genome interval [start, end]; ('nnnn', None, None) when no
    genome-advancing record falls in the interval — exactly the reference's
    (bases, left, right) with left/right reduced to status codes (the only
    fields it consumes, SDC.py:530-539)."""
    adv_idx = np.nonzero(idx.advances)[0]
    if adv_idx.size == 0:
        return "nnnn", None, None
    gp_adv = idx.gp[adv_idx]
    # last advancing record with start <= gp <= end
    hi = np.searchsorted(gp_adv, end, side="right") - 1
    if hi < 0 or gp_adv[hi] < start:
        return "nnnn", None, None
    splice_index = int(adv_idx[hi]) + 1  # 1-based, reference semantics

    lo = max(splice_index - 10, 0)
    hi_w = min(splice_index + 10, len(idx.status))
    bases, intron_at = "nnnn", None
    for rec in range(lo, hi_w):
        if rec in idx.introns:           # last intron in window wins
            bases = idx.introns[rec]
            intron_at = rec
    if intron_at is None:
        return bases, None, None
    if intron_at >= 5:
        left = idx.status[intron_at - 5:intron_at]
    else:
        # reference quirk: record[index-5:index] with a negative start wraps
        # and yields an empty list — keep that behavior
        left = idx.status[0:0]
    right = idx.status[intron_at + 1:intron_at + 6]
    return bases, left, right


def characterize_splicing_event(
    splice_left: int,
    splice_right: int,
    cs_indices: List[CsIndex],
    junctions: Tuple[str, ...],
    motif_fraction: float = 0.85,
    flank_accuracy: float = 0.85,
) -> bool:
    """Junction motif + flank accuracy gate (SDC.py:499-550): >85 % of the
    (subsampled upstream) reads must show an allowed motif, and >85 % of the
    5 cs records on each side of the intron must be '=' matches.

    `cs_indices` is the already-subsampled read set; subsampling policy
    (reference: unseeded np.random.choice capped at 500) lives in the caller.
    """
    allowed = 0
    total = 0
    left_eq = left_total = 0
    right_eq = right_total = 0
    for idx in cs_indices:
        bases, left, right = splice_context(idx, splice_left, splice_right)
        total += 1
        if bases in junctions:
            allowed += 1
        if left is not None and len(left):
            left_eq += int(np.sum(left == EQ))
            left_total += len(left)
        if right is not None and len(right):
            right_eq += int(np.sum(right == EQ))
            right_total += len(right)
    if total == 0 or allowed / total <= motif_fraction:
        return False
    if left_total == 0 or right_total == 0:
        # reference raises ZeroDivisionError here in theory; in practice a
        # passing motif implies flanks exist. Treat as fail-safe.
        return False
    return (left_eq / left_total > flank_accuracy
            and right_eq / right_total > flank_accuracy)
