"""Read-vs-read orientation check (replaces the reference's
`mappy.Aligner(seq=first, preset='map-ont')` strand probe,
SDC.py:895-907): minimizer anchors against a single target read, chained
per strand; the better-scoring orientation wins."""

from __future__ import annotations

from typing import Optional

import numpy as np

from mandalorion_tpu_torch.align.encode import encode, minimizers


_MAX_OCC = 16          # per-minimizer hit cap
_BUCKET_BITS = 8       # tiny single-read index: 256 buckets is plenty


class OrientationAligner:
    def __init__(self, target_seq: str, kmer: int = 13, window: int = 5):
        self.kmer = kmer
        self.window = window
        codes = encode(target_seq)
        pos, hashes = minimizers(codes, kmer, window)
        order = np.argsort(hashes, kind="stable")
        self.sorted_hashes = np.ascontiguousarray(hashes[order])
        # a one-chromosome bucketed index over the target lets
        # `native_seed_chain2` run the aligner's seed+chain arithmetic
        # for both strands in one C++ call
        edges = (np.arange(1 << _BUCKET_BITS, dtype=np.uint64)
                 << np.uint64(64 - _BUCKET_BITS))
        lo = np.searchsorted(self.sorted_hashes, edges, side="left")
        self._bucket_lo = np.append(
            lo, len(self.sorted_hashes)).astype(np.int64)
        self._sorted_pos64 = np.ascontiguousarray(pos[order], np.int64)
        self._chrom_offsets = np.zeros(1, np.int64)

    def strand(self, seq: str) -> Optional[int]:
        """+1 forward, -1 reverse, None when no confident hit."""
        from mandalorion_tpu_torch.native import native_seed_chain2
        res = native_seed_chain2(
            encode(seq), self.kmer, self.window, _MAX_OCC, 100,
            self.sorted_hashes, self._bucket_lo, _BUCKET_BITS,
            self._sorted_pos64, self._chrom_offsets, 10 ** 9, 10 ** 9)
        s = res[6]  # 0=forward, 1=reverse, -1=no chain either way
        if s < 0:
            return None
        return 1 if s == 0 else -1
