"""Sequence encoding and (k, w) minimizers (rolling-hash k-mers)."""

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

# odd 64-bit mix constant for the polynomial rolling hash
_B = np.uint64(0x9E3779B97F4A7C15)
_BINV = np.uint64(pow(0x9E3779B97F4A7C15, -1, 1 << 64))

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
    invalid), or by its numpy twin under MANDO_TPU_NO_NATIVE."""
    from mandalorion_tpu_torch.native import native_minimizers
    res = native_minimizers(codes, k, w)
    if res is not None:
        return res
    return _minimizers_numpy(codes, k, w)


def _pow_series(base: np.uint64, n: int) -> np.ndarray:
    """[base^0, base^1, ..., base^(n-1)] mod 2^64."""
    out = np.empty(n, np.uint64)
    out[0] = 1
    if n > 1:
        out[1:] = base
        np.multiply.accumulate(out, out=out)
    return out


def kmer_hashes(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rolling polynomial hash of every k-mer (mod 2^64), fully vectorized.

    h[i] = sum_j codes[i+j] * B^(k-1-j). Returns (hashes, valid) where
    valid[i] is False when the k-mer contains a non-ACGT base. O(n) via
    prefix sums of codes[j] * B^(-j) re-scaled by B^(i+k-1); wraparound
    uint64 arithmetic throughout.
    """
    n = len(codes)
    m = n - k + 1
    if m <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    with np.errstate(over="ignore"):
        binv_pow = _pow_series(_BINV, n)           # B^-j
        terms = (codes.astype(np.uint64) + np.uint64(1)) * binv_pow
        prefix = np.zeros(n + 1, np.uint64)
        np.cumsum(terms, out=prefix[1:])           # wraps mod 2^64
        window = prefix[k:] - prefix[:-k]          # sum over [i, i+k)
        b_pow = _pow_series(_B, n + k)
        h = window * b_pow[k - 1:k - 1 + m]
    # scramble to decorrelate adjacent k-mers (xorshift finalizer)
    h ^= h >> np.uint64(33)
    with np.errstate(over="ignore"):
        h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    bad = codes >= 4
    if bad.any():
        bad_prefix = np.zeros(n + 1, np.int64)
        np.cumsum(bad, out=bad_prefix[1:])
        valid = (bad_prefix[k:] - bad_prefix[:-k]) == 0
    else:
        valid = np.ones(m, bool)
    return h, valid


def _minimizers_numpy(codes: np.ndarray, k: int, w: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy minimizers (the native library's twin)."""
    h, valid = kmer_hashes(codes, k)
    m = len(h)
    if m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    hv = np.where(valid, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    if m <= w:
        if not valid.any():
            return np.zeros(0, np.int64), np.zeros(0, np.uint64)
        p = int(np.argmin(hv))
        return np.array([p], np.int64), h[p:p + 1]
    win = np.lib.stride_tricks.sliding_window_view(hv, w)
    arg = np.argmin(win, axis=1)
    pos = np.arange(len(arg), dtype=np.int64) + arg
    pos = pos[valid[pos]]
    if len(pos) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    pos = np.unique(pos)
    return pos, h[pos]
