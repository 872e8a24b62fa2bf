"""Star consensus: backbone alignment + column majority vote.

The production consensus path for high-accuracy (R2C2/ccs) reads: every
read aligns independently against the first read (the backbone) through the
same minimizer-chain + batched-DP machinery as genome alignment (so the
per-read cost is a handful of small DP fills), then per-column votes (match base / deletion) and per-gap
insertion votes produce the consensus. For ~1 % error reads this matches
partial-order alignment consensus (poa/graph.py, kept as the general
engine) while being orders of magnitude faster; see PoaConfig.engine.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mandalorion_tpu_torch.align.aligner import SpliceAligner
from mandalorion_tpu_torch.config import AlignConfig

from mandalorion_tpu_torch.align.encode import decode as _decode


def _star_align_cfg() -> AlignConfig:
    """Backbone-alignment parameters: no splicing (reads vs a read), small
    k for short reads, generous chaining."""
    return AlignConfig(kmer=13, window=5, max_occ=64,
                       min_intron=1_000_000_000,
                       max_intron=1_000_000_000,
                       min_chain_score=20, max_end_extend=256,
                       end_bonus=12)


def star_consensus(oriented_seqs: Sequence[str],
                   aligner_cfg: Optional[AlignConfig] = None) -> str:
    """Consensus of already-oriented sequences; the first is the backbone."""
    backbone = oriented_seqs[0]
    L = len(backbone)
    aligner = SpliceAligner({"bb": backbone},
                            aligner_cfg or _star_align_cfg())
    reads = [(str(i), s) for i, s in enumerate(oriented_seqs)]
    mapped = aligner.map_batch_runs(reads)

    # votes accumulate via difference arrays + one bincount (far cheaper
    # than per-run scatter-adds): coverage/gap_votes are run-interval sums,
    # base votes are a flat (pos*4 + base) histogram
    cov_diff = np.zeros(L + 1, np.int32)
    gap_diff = np.zeros(L + 1, np.int32)
    m_pos: List[np.ndarray] = []
    m_code: List[np.ndarray] = []
    insertions: Dict[int, Dict[str, int]] = {}

    for _name, strand, q_codes, runs in mapped:
        # a read mapping backwards against the backbone was mis-oriented
        # upstream; its votes still count in its aligned frame
        for op, q0, t0, ln in runs:
            if op == "M":
                sel = q_codes[q0:q0 + ln]
                valid = sel < 4
                m_pos.append(np.arange(t0, t0 + ln, dtype=np.int64)[valid])
                m_code.append(sel[valid].astype(np.int64))
                cov_diff[t0] += 1
                cov_diff[t0 + ln] -= 1
            elif op == "D":
                gap_diff[t0] += 1
                gap_diff[t0 + ln] -= 1
                cov_diff[t0] += 1
                cov_diff[t0 + ln] -= 1
            elif op == "I":
                seq = _decode(q_codes[q0:q0 + ln])
                per = insertions.setdefault(t0, {})
                per[seq] = per.get(seq, 0) + 1

    coverage = np.cumsum(cov_diff[:-1], dtype=np.int32)
    gap_votes = np.cumsum(gap_diff[:-1], dtype=np.int32)
    if m_pos:
        flat = np.bincount(np.concatenate(m_pos) * 4
                           + np.concatenate(m_code), minlength=4 * L)
        base_votes = flat.reshape(L, 4)
    else:
        base_votes = np.zeros((L, 4), np.int64)

    best_base = np.argmax(base_votes, axis=1)
    best_count = base_votes[np.arange(L), best_base]
    keep = best_count >= gap_votes          # deletion wins only on majority
    # uncovered positions fall back to the backbone base
    from mandalorion_tpu_torch.align.encode import encode as _enc
    bb = _enc(backbone)
    uncovered = coverage == 0
    out_parts: List[str] = []
    ins_positions = sorted(insertions)
    ins_iter = 0
    for pos in range(L + 1):
        if ins_iter < len(ins_positions) and ins_positions[ins_iter] == pos:
            per = insertions[pos]
            seq, count = max(per.items(), key=lambda kv: (kv[1], kv[0]))
            cov_here = coverage[min(pos, L - 1)]
            if count * 2 > max(int(cov_here), 1):
                out_parts.append(seq)
            ins_iter += 1
        if pos == L:
            break
        if uncovered[pos]:
            out_parts.append("ACGTN"[min(int(bb[pos]), 4)])
        elif keep[pos] and best_count[pos] > 0:
            out_parts.append("ACGT"[int(best_base[pos])])
        # else: deletion majority — emit nothing
    return "".join(out_parts)
