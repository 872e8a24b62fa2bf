"""Genome minimizer index.

Replaces minimap2's index (`-ax splice:hq` default k=15, w=5). The genome is
concatenated with 'N' spacers (k-mers spanning chromosome boundaries are
invalid); minimizer (position, hash) pairs are sorted by hash for
bucketed binary-search lookup. The index is a set of plain numpy arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from mandalorion_tpu_torch.align.encode import encode, minimizers

# per-read anchor budget (minimap2's mid-occ adaptation); MUST match the
# native constant in native/minimizers.cpp (ANCHOR_BUDGET): `lookup` and
# the native fused path drop the same seeds
ANCHOR_BUDGET = 16384


def ragged_gather(values: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                  source_ids: np.ndarray):
    """Gather values[lo[i]:hi[i]] for every range i, flattened, plus the
    repeated source_ids — the shared anchor-expansion primitive."""
    reps = (hi - lo).astype(np.int64)
    total = int(reps.sum())
    idx = np.repeat(lo, reps) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(reps) - reps, reps))
    return np.repeat(source_ids, reps), values[idx]


@dataclass
class GenomeIndex:
    kmer: int
    window: int
    seq_codes: np.ndarray          # concatenated genome, uint8 codes
    chrom_names: List[str]
    chrom_offsets: np.ndarray      # start offset of each chrom (int64)
    chrom_sizes: np.ndarray
    sorted_hashes: np.ndarray      # minimizer hashes, ascending (uint64)
    sorted_positions: np.ndarray   # global genome positions (uint32 when
                                   # the genome fits 4 Gbp, else int64)
    bucket_lo: np.ndarray = None   # 2^bits+1 offsets over hash top bits
    bucket_bits: int = 16          # adaptive: ~8 minimizers per bucket
    occ_hist: np.ndarray = None    # histogram of per-hash occurrence
                                   # counts (persisted by the cache so
                                   # frequency_occ_cap needn't scan the
                                   # full hash array on every startup)

    @property
    def total_length(self) -> int:
        return len(self.seq_codes)

    def position_to_chrom(self, gpos: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Global positions -> (chrom_index, local_position)."""
        ci = np.searchsorted(self.chrom_offsets, gpos, side="right") - 1
        return ci, gpos - self.chrom_offsets[ci]

    def lookup(self, hashes: np.ndarray, max_occ: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """For query minimizer hashes, return (query_idx, genome_position)
        anchor pairs; hashes occurring more than max_occ times in the genome
        are dropped (repeat masking, minimap2's -f analogue), and a per-read
        anchor budget keeps the lowest-occurrence seeds when a read seeds
        mostly in high-copy repeats (identical semantics to the native
        build_segments path, minimizers.cpp ANCHOR_BUDGET). Uses the
        native bucketed binary search, or numpy's searchsorted (the same
        ranges) on an index without a bucket table or under
        MANDO_TPU_NO_NATIVE."""
        from mandalorion_tpu_torch.native import native_lookup_ranges
        res = (native_lookup_ranges(self.sorted_hashes, self.bucket_lo,
                                    self.bucket_bits, hashes)
               if self.bucket_lo is not None else None)
        if res is not None:
            lo, hi = res
        else:
            lo = np.searchsorted(self.sorted_hashes, hashes, side="left")
            hi = np.searchsorted(self.sorted_hashes, hashes, side="right")
        counts = hi - lo
        keep = (counts > 0) & (counts <= max_occ)
        kept_counts = counts[keep]
        if int(kept_counts.sum()) > ANCHOR_BUDGET:
            # keep the largest per-seed count `cut` whose cumulative
            # ascending expansion fits the budget; seeds above it drop
            # (rarer = more informative seeds always survive)
            c = np.sort(kept_counts)
            k = int(np.searchsorted(np.cumsum(c), ANCHOR_BUDGET, "right"))
            cut = max(int(c[k - 1]) if k > 0 else 1, 1)
            keep &= counts <= cut
        lo, hi = lo[keep], hi[keep]
        qidx = np.nonzero(keep)[0]
        if len(lo) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        qout, gpos = ragged_gather(self.sorted_positions, lo, hi, qidx)
        return qout, gpos.astype(np.int64)

    def seed_segments(self, codes: np.ndarray, max_occ: int,
                      merge_gap: int = 100):
        """Fused native seeding for one read orientation: minimizers ->
        lookup -> per-chromosome diagonal collapse, in a single C call.
        Returns [(chrom_idx, [Segment, ...]), ...] in ascending chrom
        order (segments in (diag, t) order, matching collapse_anchors),
        or None on an index without a bucket table or under
        MANDO_TPU_NO_NATIVE."""
        from mandalorion_tpu_torch.align.chain import Segment
        from mandalorion_tpu_torch.native import native_seed_segments

        if self.bucket_lo is None:
            return None
        res = native_seed_segments(
            codes, self.kmer, self.window, max_occ, merge_gap,
            self.sorted_hashes, self.bucket_lo, self.bucket_bits,
            self.sorted_positions, self.chrom_offsets)
        if res is None:
            return None
        chrom, qs, qe, ts, te, na, cov = res
        out = []
        i = 0
        n = len(chrom)
        while i < n:
            c = chrom[i]
            segs = []
            while i < n and chrom[i] == c:
                segs.append(Segment(int(qs[i]), int(qe[i]), int(ts[i]),
                                    int(te[i]), int(na[i]), int(cov[i])))
                i += 1
            out.append((int(c), segs))
        return out


def build_index(genome: Dict[str, str], kmer: int = 15, window: int = 5,
                chunk: int = 1 << 24, threads: int = 0) -> GenomeIndex:
    """Build the minimizer index from a chrom -> sequence dict. Chromosomes
    are processed in chunks (with k-1 overlap) to bound peak memory.
    The native library does the minimizer scan and sort on `threads`
    threads; under MANDO_TPU_NO_NATIVE `_build_index_numpy` builds the
    same arrays in one thread."""
    from mandalorion_tpu_torch.native import native_build_index

    names = sorted(genome)
    offsets = []
    sizes = []
    code_parts = []
    offset = 0
    spacer = np.full(1, 4, np.uint8)  # 'N' spacer kills boundary k-mers
    for name in names:
        codes = encode(genome[name])
        offsets.append(offset)
        sizes.append(len(codes))
        code_parts.append(codes)
        code_parts.append(spacer)
        offset += len(codes) + 1
    seq_codes = (np.concatenate(code_parts) if code_parts
                 else np.zeros(0, np.uint8))
    chrom_offsets = np.asarray(offsets, np.int64)
    chrom_sizes = np.asarray(sizes, np.int64)
    pos_u32 = offset < (1 << 32)  # hg38-scale genomes fit uint32
    bits = _bucket_bits_for(offset)
    res = native_build_index(
        seq_codes, chrom_offsets, chrom_sizes, chrom_offsets,
        kmer, window, chunk, bits, threads or (os.cpu_count() or 1),
        pos_u32)
    if res is None:
        return _build_index_numpy(seq_codes, names, chrom_offsets,
                                  chrom_sizes, kmer, window, chunk, bits)
    sorted_hashes, sorted_positions, bucket_lo = res
    return GenomeIndex(
        kmer=kmer, window=window, seq_codes=seq_codes,
        chrom_names=names, chrom_offsets=chrom_offsets,
        chrom_sizes=chrom_sizes, sorted_hashes=sorted_hashes,
        sorted_positions=sorted_positions, bucket_lo=bucket_lo,
        bucket_bits=bits)


def _bucket_bits_for(total_bases: int) -> int:
    """Bucket-table width targeting ~8 minimizers per bucket (minimizer
    density ~ 1/3 per base at w=5): 16 bits up to ~1.6 Mbp, 28 at hg38
    scale. Finer buckets cut binary-search probes per seed lookup."""
    bits = 16
    while bits < 28 and (total_bases // 3) >> bits > 8:
        bits += 1
    return bits


def occurrence_histogram(sorted_hashes: np.ndarray) -> np.ndarray:
    """Histogram of per-distinct-hash occurrence counts (index = count)."""
    h = sorted_hashes
    if len(h) == 0:
        return np.zeros(1, np.int64)
    starts = np.empty(len(h), bool)
    starts[0] = True
    np.not_equal(h[1:], h[:-1], out=starts[1:])
    lens = np.diff(np.flatnonzero(np.append(starts, True)))
    return np.bincount(lens).astype(np.int64)


def _quantile_from_hist(hist: np.ndarray, q: float) -> float:
    """np.quantile (linear interpolation) over the values a histogram
    encodes, without materializing them."""
    n = int(hist.sum())
    if n == 0:
        return 0.0
    pos = (n - 1) * q
    lo = int(np.floor(pos))
    hi = int(np.ceil(pos))
    cum = np.cumsum(hist)
    v_lo = int(np.searchsorted(cum, lo, side="right"))
    v_hi = int(np.searchsorted(cum, hi, side="right"))
    return v_lo + (pos - lo) * (v_hi - v_lo)


def frequency_occ_cap(idx: GenomeIndex, frac: float, floor: int) -> int:
    """minimap2 -f analogue: the occurrence cap below which all but the
    top `frac` fraction of distinct minimizers fall. Never below floor —
    on ordinary genomes the quantile is tiny and the floor rules; on
    repeat/tandem-heavy genomes the cap rises so those regions still
    seed. Uses the cached occurrence histogram when present (a full hash
    scan costs ~a minute at hg38 scale)."""
    if frac <= 0 or len(idx.sorted_hashes) == 0:
        return floor
    hist = idx.occ_hist
    if hist is None:
        hist = occurrence_histogram(idx.sorted_hashes)
        idx.occ_hist = hist
    return max(floor, int(_quantile_from_hist(hist, 1.0 - frac)))


def content_checksum(seq_codes: np.ndarray) -> int:
    """Cheap order-sensitive content hash of the concatenated genome codes:
    dense up to 1 Mbp, then 64k sampled strides + length. Catches same-shape
    content changes (SNP fixes, masking) that the (k, w, names, sizes)
    cache key misses."""
    n = len(seq_codes)
    sample = (seq_codes if n <= (1 << 20)
              else seq_codes[:: max(1, n >> 16)])
    x = sample.astype(np.uint64)
    mult = np.uint64(0x9E3779B97F4A7C15)
    acc = np.uint64(n)
    # position-dependent weights mult^(i+1) (wrapping) make the hash
    # order-sensitive; uint64 overflow wraps silently, which is the point
    with np.errstate(over="ignore"):
        weights = np.cumprod(np.full(len(x), mult, np.uint64))
        acc += np.bitwise_xor.reduce(
            (x + np.uint64(0x2545F4914F6CDD1D)) * weights)
    return int(acc)


_DIR_ARRAYS = ("seq_codes", "chrom_offsets", "chrom_sizes",
               "sorted_hashes", "sorted_positions", "bucket_lo",
               "occ_hist")


def save_index(idx: GenomeIndex, path: str) -> None:
    """Persist the index — the minimap2 `.mmi` analogue: build the
    whole-genome index once, reuse across runs/hosts. A path ending in
    `.npz` writes the legacy single-file archive; any other path writes a
    DIRECTORY of raw `.npy` files that load memory-mapped (hg38-scale
    indexes — ~15 GB of arrays — page in lazily instead of being read
    up front; npz archives cannot mmap)."""
    if idx.occ_hist is None:
        idx.occ_hist = occurrence_histogram(idx.sorted_hashes)
    meta = dict(kmer=idx.kmer, window=idx.window,
                bucket_bits=idx.bucket_bits,
                content_sum=int(content_checksum(idx.seq_codes)))
    if path.endswith(".npz"):
        tmp = f"{path}.{os.getpid()}.tmp.npz"  # atomic (racing workers)
        np.savez(tmp, seq_codes=idx.seq_codes,
                 chrom_names=np.asarray(idx.chrom_names, dtype=object),
                 chrom_offsets=idx.chrom_offsets,
                 chrom_sizes=idx.chrom_sizes,
                 sorted_hashes=idx.sorted_hashes,
                 sorted_positions=idx.sorted_positions,
                 bucket_lo=idx.bucket_lo, occ_hist=idx.occ_hist,
                 **{k: np.asarray(v) for k, v in meta.items()})
        os.replace(tmp, path)
        return
    import json
    tmp = f"{path}.{os.getpid()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    for name in _DIR_ARRAYS:
        np.save(os.path.join(tmp, name + ".npy"), getattr(idx, name))
    meta["chrom_names"] = idx.chrom_names
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    if os.path.isdir(path):
        import shutil
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_index(path: str) -> GenomeIndex:
    return _load_index_with_sum(path)[0]


def _load_index_with_sum(path: str):
    if os.path.isdir(path):  # directory format: arrays memory-map
        import json
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        arrays = {name: np.load(os.path.join(path, name + ".npy"),
                                mmap_mode="r")
                  for name in _DIR_ARRAYS
                  if os.path.exists(os.path.join(path, name + ".npy"))}
        idx = GenomeIndex(
            kmer=int(meta["kmer"]), window=int(meta["window"]),
            chrom_names=[str(n) for n in meta["chrom_names"]],
            bucket_bits=int(meta["bucket_bits"]), **arrays)
        return idx, meta.get("content_sum")
    with np.load(path, allow_pickle=True) as z:
        idx = GenomeIndex(
            kmer=int(z["kmer"]), window=int(z["window"]),
            seq_codes=z["seq_codes"],
            chrom_names=[str(n) for n in z["chrom_names"]],
            chrom_offsets=z["chrom_offsets"], chrom_sizes=z["chrom_sizes"],
            sorted_hashes=z["sorted_hashes"],
            sorted_positions=z["sorted_positions"],
            bucket_lo=z["bucket_lo"],
            bucket_bits=int(z["bucket_bits"]) if "bucket_bits" in z
            else 16,
            occ_hist=z["occ_hist"] if "occ_hist" in z else None)
        stored_sum = int(z["content_sum"]) if "content_sum" in z else None
    return idx, stored_sum


def _genome_checksum(genome: Dict[str, str]) -> int:
    """content_checksum of the genome as build_index would concatenate it
    (sorted chroms, 'N' spacer after each)."""
    parts = []
    spacer = np.full(1, 4, np.uint8)
    for name in sorted(genome):
        parts.append(encode(genome[name]))
        parts.append(spacer)
    codes = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return content_checksum(codes)


def cached_index(genome: Dict[str, str], kmer: int, window: int,
                 cache_path: str = "", threads: int = 0) -> GenomeIndex:
    """build_index with an optional on-disk cache. A cached index is only
    reused when (k, w, chromosome names+sizes) match the genome AND the
    stored content checksum matches the cached seq_codes' checksum of the
    requested genome (same-length edits — SNP fixes, masking — must not
    silently reuse a stale index)."""
    if cache_path and os.path.exists(cache_path):
        try:
            idx, stored_sum = _load_index_with_sum(cache_path)
            if (idx.kmer == kmer and idx.window == window
                    and idx.chrom_names == sorted(genome)
                    and all(int(s) == len(genome[n]) for n, s in
                            zip(idx.chrom_names, idx.chrom_sizes))
                    and stored_sum is not None
                    and stored_sum == _genome_checksum(genome)):
                return idx
        except (OSError, KeyError, ValueError):
            pass  # unreadable/stale cache: rebuild below
    idx = build_index(genome, kmer, window, threads=threads)
    if cache_path:
        save_index(idx, cache_path)
    return idx


def _build_index_numpy(seq_codes: np.ndarray, names: List[str],
                       chrom_offsets: np.ndarray, chrom_sizes: np.ndarray,
                       kmer: int, window: int, chunk: int,
                       bucket_bits: int = 16) -> GenomeIndex:
    """Pure-numpy index build (the native builder's twin)."""
    pos_parts: List[np.ndarray] = []
    hash_parts: List[np.ndarray] = []
    total = int(chrom_offsets[-1] + chrom_sizes[-1] + 1) if len(names) else 0
    for ci in range(len(names)):
        offset = int(chrom_offsets[ci])
        codes = seq_codes[offset:offset + int(chrom_sizes[ci])]
        start = 0
        while start < len(codes):
            stop = min(len(codes), start + chunk)
            # context: windows touching a position reach w-1 k-mers left
            # and w-1 k-mers (+ k-1 bases) right of the chunk body
            lo = max(start - (window - 1), 0)
            hi = min(stop + kmer + window - 2, len(codes))
            pos, hsh = minimizers(codes[lo:hi], kmer, window)
            if len(pos):
                pos = pos + lo
                keep = (pos >= start) & (pos < stop)
                if keep.any():
                    pos_parts.append(pos[keep] + offset)
                    hash_parts.append(hsh[keep])
            start = stop
    all_pos = (np.concatenate(pos_parts) if pos_parts
               else np.zeros(0, np.int64))
    all_hash = (np.concatenate(hash_parts) if hash_parts
                else np.zeros(0, np.uint64))
    order = np.argsort(all_hash, kind="stable")
    sorted_hashes = all_hash[order]
    # bucket table over the hash's top bits for the bucketed lookup
    bucket_edges = (np.arange(1 << bucket_bits, dtype=np.uint64)
                    << np.uint64(64 - bucket_bits))
    bucket_lo = np.searchsorted(sorted_hashes, bucket_edges, side="left")
    bucket_lo = np.append(bucket_lo, len(sorted_hashes)).astype(np.int64)
    sorted_positions = all_pos[order]
    if total < (1 << 32):  # hg38-scale genomes fit uint32, halving memory
        sorted_positions = sorted_positions.astype(np.uint32)
    return GenomeIndex(
        kmer=kmer, window=window, seq_codes=seq_codes, chrom_names=names,
        chrom_offsets=chrom_offsets, chrom_sizes=chrom_sizes,
        sorted_hashes=sorted_hashes, sorted_positions=sorted_positions,
        bucket_lo=bucket_lo, bucket_bits=bucket_bits)
