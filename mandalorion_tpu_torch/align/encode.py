"""Sequence encoding and (k, w) minimizers."""

from __future__ import annotations

from typing import Tuple

import numpy as np

# base codes: A=0 C=1 G=2 T=3, anything else = 4 (invalidates k-mers)
_LUT = np.full(256, 4, np.uint8)
for i, b in enumerate("ACGT"):
    _LUT[ord(b)] = i
    _LUT[ord(b.lower())] = i

_COMP_CODE = np.array([3, 2, 1, 0, 4], np.uint8)
_DECODE_TABLE = np.frombuffer(b"ACGTN" + b"N" * 251, np.uint8)


def decode(codes: np.ndarray) -> str:
    """codes -> bases via one bytes translation (C speed)."""
    return _DECODE_TABLE[codes.astype(np.uint8)].tobytes().decode()

def encode(seq: str) -> np.ndarray:
    """ASCII sequence -> uint8 codes."""
    return _LUT[np.frombuffer(seq.encode(), np.uint8)]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _COMP_CODE[codes[::-1]]


def minimizers(codes: np.ndarray, k: int, w: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(positions, hashes) of (k, w) minimizers: the smallest-hash k-mer in
    every window of w consecutive k-mers (leftmost tie-break), deduplicated.
    Computed by the native library (a rolling polynomial hash mod 2^64
    with an xorshift finalizer; k-mers holding a non-ACGT base are
    invalid)."""
    from mandalorion_tpu_torch.native import native_minimizers
    return native_minimizers(codes, k, w)
