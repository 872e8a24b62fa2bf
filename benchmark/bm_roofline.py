"""Peaks of the card and the bytes a kernel has to move.

PEAK_BYTES_S is the published HBM3 rate of one NVIDIA H100 SXM (80 GB,
3.35 TB/s, at its 700 W power limit). The POA forward's byte count is a
frozen copy of chip_smoke.py's (its inputs read once, its four score
matrices and its row offsets written once), taken over the real rows and
query bases of each problem. Only numpy.
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES_S = 3.35e12


def poa_fwd_bytes(arrays, W: int) -> int:
    """Least bytes of one forward launch over a chunk: arrays as the
    round loop hands them to its observer (base, preds, nn, ends, qq, ql,
    band), W the band's width."""
    _base, preds, nn, _ends, _qq, ql, band = arrays
    rows = np.asarray(nn, np.int64)
    cells = int(((rows + 1) * W).sum())
    return (int((rows * (1 + preds.shape[2]) * 4).sum())
            + int(np.asarray(ql, np.int64).sum()) * 4 + len(band) * 4
            + cells * 16 + int(((rows + 1) * 8).sum()))
