"""Sharded collective steps of the mesh-integrated pipeline.

Counterpart of mandalorion_tpu/parallel/dist.py. The dispatch sites
(align/chain_kernel.py, align/kernels.py, poa/kernels.py) shard their
batches themselves through parallel.mesh; this module holds the
explicitly collective pieces: module Q's count-matrix sum
(`mesh_count_matrix`), the partial-matrix merge, sharded alignment
scoring, and the genome index split into hash-range shards with its
sharded seed lookup (`IndexShards`, the path to indexes larger than one
host's memory).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from mandalorion_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_max, all_reduce_sum, fetch_global, shard_batch)

NEG = -(10 ** 9)   # the reference row math's minus infinity
_FLIP = np.uint64(1 << 63)


def _shift_right(x: torch.Tensor, fill: int = NEG) -> torch.Tensor:
    """out[..., j] = x[..., j-1]; out[..., 0] = fill."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], -1)


def _cummax_neg(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix max along the last axis by doubling, NEG shifted
    in, as the reference's `_cummax`."""
    d, n = 1, x.shape[-1]
    while d < n:
        x = torch.maximum(x, torch.cat(
            [torch.full_like(x[..., :d], NEG), x[..., :-d]], -1))
        d *= 2
    return x


def _score_batch(q_codes: torch.Tensor, t_codes: torch.Tensor,
                 match: int = 1, mismatch: int = 2, go: int = 2,
                 ge: int = 1) -> torch.Tensor:
    """Alignment scores of a padded read batch: (B, L) query codes
    against (B, 128) target windows (lane j holds target base j - 1) ->
    (B,) int32, the maximum of the last DP row. The Gotoh row math of the
    reference's `row_step` (mandalorion_tpu/align/kernels.py), int32,
    one row a query base."""
    q = q_codes.to(torch.int32)
    t = t_codes.to(torch.int32)
    b = q.shape[0]
    j = torch.arange(t.shape[1], dtype=torch.int32, device=t.device
                     ).expand(b, -1)
    h = torch.where(j == 0, 0, -(go + ge * j)).to(torch.int32)
    e = torch.full_like(h, NEG)
    for i in range(q.shape[1]):
        open_e = h - go - ge
        ext_e = e - ge
        e = torch.maximum(open_e, ext_e)
        sub = torch.where(t == q[:, i:i + 1], match, -mismatch)
        diag = _shift_right(h) + sub
        bb = torch.where(j == 0, e, torch.maximum(diag, e))
        f = _shift_right(_cummax_neg(bb + ge * j)) - go - ge * j
        h = torch.maximum(torch.maximum(diag, e), f)
        h = torch.where(j == 0, e, h).to(torch.int32)
    return h.max(dim=1).values


def sharded_batch_score(mesh: Mesh, q_codes: np.ndarray,
                        t_codes: np.ndarray) -> np.ndarray:
    """Data-parallel `_score_batch`: the read batch shards over the mesh,
    each shard scores on its device, the scores gather back."""
    shards, b = shard_batch(mesh, [np.asarray(q_codes, np.int32),
                                   np.asarray(t_codes, np.int32)])
    (scores,) = fetch_global(mesh, [(_score_batch(q, t),)
                                    for q, t in shards])
    return scores[:b]


def sharded_quant_merge(mesh: Mesh, per_device_counts) -> np.ndarray:
    """Sum (n_shards, I, S) per-shard partial count matrices: each
    process adds its own shards' rows (those of other ranks are not
    read), then one all_reduce. Returns the merged (I, S) matrix."""
    parts = np.asarray(per_device_counts)
    if parts.shape[0] != mesh.size:
        raise ValueError(f"{parts.shape[0]} partials for {mesh.size} "
                         f"shards")
    _padded, slices = mesh.shard_slices(mesh.size)
    local = torch.from_numpy(parts[slices[0][1]:slices[-1][2]]).to(
        mesh.comm_device()).sum(dim=0, dtype=torch.int64)
    return all_reduce_sum(mesh, local).cpu().numpy().astype(parts.dtype)


def mesh_count_matrix(mesh: Mesh, flat_ids, num_segments: int
                      ) -> np.ndarray:
    """Module Q's count matrix over the mesh: the flattened
    (isoform * n_samples + sample) id stream is padded with the overflow
    bucket num_segments (0 is a real isoform id), sharded, bincounted a
    shard on its device, summed here and across processes (int64
    all_reduce), and the bucket dropped. Exact: equal to np.bincount.
    Returns int64 counts[num_segments]."""
    ids = np.asarray(flat_ids, np.int64)
    _padded, slices = mesh.shard_slices(len(ids))
    where = mesh.comm_device()
    total = torch.zeros(num_segments + 1, dtype=torch.int64, device=where)
    for dev, lo, hi in slices:
        shard = np.full(hi - lo, num_segments, np.int64)
        real = ids[lo:hi]
        shard[:len(real)] = real
        total += torch.bincount(torch.from_numpy(shard).to(dev),
                                minlength=num_segments + 1).to(where)
    return all_reduce_sum(mesh, total)[:num_segments].cpu().numpy()


# ------------------------------------------------------- sharded index

def shard_index_arrays(index, n_shards: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split a GenomeIndex's (sorted_hashes, sorted_positions) into
    n_shards hash-range shards. Split points snap to bucket boundaries so
    equal hashes never straddle shards (a hash's occurrence count, the
    max_occ repeat filter, stays exact on its owner shard). Returns
    (hashes (n, S) uint64, positions (n, S) int64, lens (n,) int32),
    padded with the max-hash sentinel. Raises on an index without a
    bucket table, as the reference's split cannot take one either."""
    if index.bucket_lo is None:
        raise ValueError("index_backend 'sharded' splits the index at its "
                         "bucket table (bucket_lo), which this index lacks: "
                         "rebuild the index cache with it, or run the "
                         "replicated index")
    total = len(index.sorted_hashes)
    cuts = [0]
    for i in range(1, n_shards):
        target = i * total // n_shards
        b = int(np.searchsorted(index.bucket_lo, target, side="left"))
        cuts.append(int(index.bucket_lo[min(b, len(index.bucket_lo) - 1)]))
    cuts.append(total)
    cuts = sorted(cuts)
    lens = np.array([cuts[i + 1] - cuts[i] for i in range(n_shards)],
                    np.int32)
    width = max(int(lens.max()), 1)
    hashes = np.full((n_shards, width), np.uint64(0xFFFFFFFFFFFFFFFF))
    positions = np.zeros((n_shards, width), np.int64)
    for i in range(n_shards):
        sl = slice(cuts[i], cuts[i + 1])
        hashes[i, :lens[i]] = index.sorted_hashes[sl]
        positions[i, :lens[i]] = index.sorted_positions[sl].astype(np.int64)
    return hashes, positions, lens


def ordered_int64(hashes) -> np.ndarray:
    """uint64 -> int64 keeping the order (x ^ 2^63): torch sorts and
    searches int64 only. The all-ones sentinel becomes int64's max."""
    return (np.asarray(hashes, np.uint64) ^ _FLIP).view(np.int64)


@dataclass
class IndexShards:
    """A hash-range-sharded index placed on a mesh: shard s (of n_shards)
    belongs to global mesh shard s // per, per = ceil(n_shards /
    mesh.size); this process holds only its own, one (hashes as
    `ordered_int64`, positions, lens) triple a local mesh shard, each
    holding `per` index shards (empty ones past n_shards)."""

    mesh: Mesh
    n_shards: int
    per: int
    local: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

    def lookup(self, queries, max_occ: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Seed lookup: each shard, on its device, searches its hash range
        (left and right), clamps the count by its length, expands up to
        the widest kept count w, masks and gathers; the results gather
        across the mesh. Returns pos (n_shards, nq, w) int64 (-1 where
        not valid), valid (n_shards, nq, w) bool and cnt (n_shards, nq)
        int64. w <= max_occ is the batch's largest count <= max_occ (at
        least 1): the reference expands to max_occ, and every entry past
        w is invalid there. A query's hits live on the one shard owning
        its hash."""
        q = ordered_int64(queries)
        found = []
        widest = 0
        for h, p, ln in self.local:
            qd = torch.from_numpy(q).to(h.device).expand(
                h.shape[0], -1).contiguous()
            lo = torch.searchsorted(h, qd)
            hi = torch.searchsorted(h, qd, right=True)
            # hits in a shard's sentinel padding do not count
            cnt = torch.minimum(hi - lo, (ln[:, None] - lo).clamp(min=0))
            kept = cnt[cnt <= max_occ]
            widest = max(widest, int(kept.max()) if kept.numel() else 0)
            found.append((lo, cnt))
        w = max(all_reduce_max(self.mesh, widest), 1)
        shards = []
        for (h, p, ln), (lo, cnt) in zip(self.local, found):
            k = torch.arange(w, device=h.device)
            idx = lo[..., None] + k
            valid = ((k < cnt[..., None]) & (cnt[..., None] <= max_occ)
                     & (idx < ln[:, None, None]))
            pos = torch.gather(p, 1, idx.clamp(max=h.shape[1] - 1).reshape(
                h.shape[0], -1)).reshape(idx.shape)
            shards.append((torch.where(valid, pos, -1), valid.to(torch.uint8),
                           cnt))
        pos, valid, cnt = fetch_global(self.mesh, shards)
        n = self.n_shards
        return pos[:n], valid[:n].astype(bool), cnt[:n]


def place_index_shards(mesh: Mesh, shard_hashes, shard_positions,
                       shard_lens) -> IndexShards:
    """Upload this process's own index shards (`shard_index_arrays`'
    arrays) to their mesh devices, once."""
    n_shards = len(shard_lens)
    per = -(-n_shards // mesh.size)
    _padded, slices = mesh.shard_slices(mesh.size)
    hashes = ordered_int64(shard_hashes)
    local = []
    for dev, g, _g1 in slices:  # one row a global shard: lo is its index
        rows = range(g * per, (g + 1) * per)
        h = np.full((per, hashes.shape[1]), np.iinfo(np.int64).max)
        p = np.zeros((per, hashes.shape[1]), np.int64)
        ln = np.zeros(per, np.int64)
        for r, s in enumerate(rows):
            if s < n_shards:
                h[r], p[r], ln[r] = hashes[s], shard_positions[s], \
                    shard_lens[s]
        local.append(tuple(torch.from_numpy(a).to(dev) for a in (h, p, ln)))
    return IndexShards(mesh, n_shards, per, local)


def sharded_index_lookup(mesh: Mesh, shard_hashes, shard_positions,
                         shard_lens, queries, max_occ: int):
    """`IndexShards.lookup` on index shards placed for this one call."""
    return place_index_shards(mesh, shard_hashes, shard_positions,
                              shard_lens).lookup(queries, max_occ)
