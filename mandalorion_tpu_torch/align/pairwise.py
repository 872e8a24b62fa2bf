"""Read-vs-read orientation check (replaces the reference's
`mappy.Aligner(seq=first, preset='map-ont')` strand probe,
SDC.py:895-907): minimizer anchors against a single target read, chained
per strand; the better-scoring orientation wins."""

from __future__ import annotations

from typing import Optional

import numpy as np

from mandalorion_tpu_torch.align.chain import chain_segments, collapse_anchors
from mandalorion_tpu_torch.align.encode import (
    encode, minimizers, revcomp_codes)
from mandalorion_tpu_torch.align.index import ragged_gather
from mandalorion_tpu_torch.native import load_native, native_seed_chain2


_MAX_OCC = 16          # per-minimizer hit cap, both paths
_BUCKET_BITS = 8       # tiny single-read index: 256 buckets is plenty


class OrientationAligner:
    def __init__(self, target_seq: str, kmer: int = 13, window: int = 5):
        self.kmer = kmer
        self.window = window
        codes = encode(target_seq)
        pos, hashes = minimizers(codes, kmer, window)
        order = np.argsort(hashes, kind="stable")
        self.sorted_hashes = np.ascontiguousarray(hashes[order])
        self.sorted_pos = pos[order]
        # a one-chromosome bucketed index over the target lets
        # `native_seed_chain2` run the aligner's seed+chain arithmetic
        # for both strands in one C++ call; under MANDO_TPU_NO_NATIVE the
        # numpy `_score` pair gives the same strand
        self._native = load_native() is not None
        if self._native:
            edges = (np.arange(1 << _BUCKET_BITS, dtype=np.uint64)
                     << np.uint64(64 - _BUCKET_BITS))
            lo = np.searchsorted(self.sorted_hashes, edges, side="left")
            self._bucket_lo = np.append(
                lo, len(self.sorted_hashes)).astype(np.int64)
            self._sorted_pos64 = np.ascontiguousarray(self.sorted_pos,
                                                      np.int64)
            self._chrom_offsets = np.zeros(1, np.int64)

    def _score(self, codes: np.ndarray) -> float:
        """Best chain score of one orientation of a read against the
        target, in numpy."""
        pos, hashes = minimizers(codes, self.kmer, self.window)
        if len(pos) == 0:
            return 0.0
        lo = np.searchsorted(self.sorted_hashes, hashes, "left")
        hi = np.searchsorted(self.sorted_hashes, hashes, "right")
        counts = hi - lo
        keep = (counts > 0) & (counts <= _MAX_OCC)
        if not keep.any():
            return 0.0
        q_all, t_all = ragged_gather(self.sorted_pos, lo[keep], hi[keep],
                                     pos[keep])
        segs = collapse_anchors(q_all, t_all, self.kmer)
        _chain, score = chain_segments(segs, min_intron=10 ** 9,
                                       max_intron=10 ** 9)
        return score

    def strand(self, seq: str) -> Optional[int]:
        """+1 forward, -1 reverse, None when no confident hit."""
        if not self._native:
            return self.strand_numpy(seq)
        res = native_seed_chain2(
            encode(seq), self.kmer, self.window, _MAX_OCC, 100,
            self.sorted_hashes, self._bucket_lo, _BUCKET_BITS,
            self._sorted_pos64, self._chrom_offsets, 10 ** 9, 10 ** 9)
        s = res[6]  # 0=forward, 1=reverse, -1=no chain either way
        if s < 0:
            return None
        return 1 if s == 0 else -1

    def strand_numpy(self, seq: str) -> Optional[int]:
        """`strand` by the numpy path (the native call's twin)."""
        codes = encode(seq)
        f = self._score(codes)
        r = self._score(revcomp_codes(codes))
        if f == 0.0 and r == 0.0:
            return None
        return 1 if f >= r else -1
