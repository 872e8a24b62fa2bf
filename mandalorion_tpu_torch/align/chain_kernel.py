"""Batched collinear chain DP on PyTorch.

Counterpart of mandalorion_tpu/align/chain_kernel.py. Two entries:
`chain_batch_rows` (the staged device route) takes the native seed
stage's pre-packed candidate rows and returns the packed int16 rows
(parent table, best index, float32 score bits) that the native fill
stage reads; `chain_batch_segments` (the route without the native
library, MANDO_TPU_NO_NATIVE) takes candidates as segment lists, packs
them, runs `chain_batch_rows` and returns each candidate's chain and
score. Two implementations of one function under both:

- `chain_rows_plain`: `_chain_fn`'s scan in plain PyTorch, batched over
  candidates with a loop over segment index i;
- csrc/chain.cu: the hand-written CUDA kernel (a warp per candidate,
  lanes on the receiving segments).

`chain_rows` dispatches on the tensors' device: CPU tensors take the
plain version, CUDA tensors the kernel. Both round float32 exactly as the
reference does: every product and sum is its own operation (no fused
multiply-add) and the intron cost uses the frexp exponent.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mandalorion_tpu_torch import _build
from mandalorion_tpu_torch.align.chain import Segment, prepare_segments
from mandalorion_tpu_torch.parallel.mesh import fetch_global, pipeline_mesh
from mandalorion_tpu_torch.runtime import LaunchCounter

NEG = -1e18        # score of padding lanes (float32 of the reference's NEG)
MAX_SEG = 512      # chain_segments' cap
# the scoring every caller of the reference's chain_batch_rows uses (its
# defaults); the native fill stage and module F assume these values
MATCH = 1
INTRON_PENALTY = 12.0
INDEL_OPEN = 4.0
INDEL_SCALE = 0.3

WARPS = 4          # csrc/chain.cu's kWarps: candidates a block at most

CHAIN_LAUNCHES = LaunchCounter("chain_rows")


def segment_lanes(max_segments: int) -> int:
    """pow2(max_segments), floor 64, cap MAX_SEG: the row width the
    reference's `chain_batch_rows` compiles for (the fill stage reads rows
    of this width + 3)."""
    msb = 64
    while msb < max_segments:
        msb *= 2
    return min(msb, MAX_SEG)


def chain_rows_plain(qs, qe, ts, te, cov, n_seg, *, min_intron: int,
                     max_intron: int) -> torch.Tensor:
    """Plain PyTorch chain DP; see `chain_rows` for the contract."""
    dev = qs.device
    n, msb = qs.shape

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    matchf, one, c001 = f32(MATCH), f32(1.0), f32(0.01)
    penalty, i_open, i_scale = (f32(INTRON_PENALTY), f32(INDEL_OPEN),
                                f32(INDEL_SCALE))
    lens = qe - qs
    covf = cov.to(torch.float32)
    lane = torch.arange(msb, device=dev)
    real = lane[None, :] < n_seg[:, None]
    score = torch.where(real, covf * matchf, f32(NEG))
    parent = torch.full((n, msb), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    for i in range(1, int(n_seg.max()) if n else 0):
        dq = qs[:, i:i + 1] - qe
        dt = ts[:, i:i + 1] - te
        overlap = torch.clamp(torch.maximum(-dq, -dt), min=0).to(
            torch.float32)
        valid = ((lane < i) & real & (dq > -lens) & (dt > -lens)
                 & (dt <= max_intron) & (qe <= qe[:, i:i + 1])
                 & (te <= te[:, i:i + 1]))
        gap = dt.clamp(min=0) - dq.clamp(min=0)
        diff = gap.abs().to(torch.float32)
        _, e = torch.frexp(torch.maximum(diff, one))
        cost = torch.where(gap >= min_intron,
                           penalty + c001 * e.to(torch.float32),
                           i_open + i_scale * diff)
        cand = score + covf[:, i:i + 1] * matchf - cost - overlap * matchf
        cand = torch.where(valid, cand, f32(-np.inf))
        j = torch.argmax(cand, dim=1)  # first max
        cj = cand[rows, j]
        better = (cj > score[:, i]) & (n_seg > i)
        score[:, i] = torch.where(better, cj, score[:, i])
        parent[:, i] = torch.where(better, j.to(torch.int32), -1)
    best = torch.argmax(score, dim=1)
    bits = score[rows, best].contiguous().view(torch.int16).reshape(n, 2)
    return torch.cat([parent.to(torch.int16), best.to(torch.int16)[:, None],
                      bits], dim=1)


def chain_order(n_seg: np.ndarray) -> np.ndarray:
    """The order in which csrc/chain.cu starts the candidates: longest
    first, ties in index order, as int32."""
    return np.argsort(-np.asarray(n_seg, np.int64), kind="stable").astype(
        np.int32)


def _chain_rows_cuda(qs, qe, ts, te, cov, n_seg, *, min_intron, max_intron,
                     order=None) -> torch.Tensor:
    lib = _build.load_kernels()
    n, msb = qs.shape
    rows = torch.empty((n, msb + 3), dtype=torch.int16, device=qs.device)
    if n == 0:
        return rows
    # fewer candidates a block when there are too few to give each SM one
    n_sm = torch.cuda.get_device_properties(qs.device).multi_processor_count
    per_block = min(WARPS, max(1, -(-n // n_sm)))
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        CHAIN_LAUNCHES.count += 1
        rc = lib.mando_chain_rows(
            qs.data_ptr(), qe.data_ptr(), ts.data_ptr(), te.data_ptr(),
            cov.data_ptr(), n_seg.data_ptr(),
            None if order is None else order.data_ptr(), rows.data_ptr(), n,
            msb, per_block, MATCH, min_intron, max_intron, INTRON_PENALTY,
            INDEL_OPEN, INDEL_SCALE, stream)
    _build.check(rc, "mando_chain_rows")
    return rows


def chain_rows(qs: torch.Tensor, qe: torch.Tensor, ts: torch.Tensor,
               te: torch.Tensor, cov: torch.Tensor, n_seg: torch.Tensor, *,
               min_intron: int, max_intron: int,
               order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chain DP over n candidates of msb segment lanes.

    qs/qe/ts/te/cov: (n, msb) int32, contiguous, segments sorted as the
    native seed stage packs them (target offsets normalized per
    candidate, zero padding); n_seg: (n,) int32 <= msb; msb <= 512.
    order: None, or an (n,) int32 permutation of the candidates, the
    order in which the kernel starts them (`chain_order`); the result
    does not depend on it. Returns (n, msb+3) int16 rows: parent per lane
    (-1 for none), the best lane, and the best score's float32 bits (low
    half first). CPU tensors run `chain_rows_plain`, after a check of
    n_seg's and order's values; CUDA tensors the csrc/chain.cu kernel,
    with no check of values (no device-to-host transfer before the
    launch: the caller holds n_seg's range, as `chain_batch_rows` does
    on the host)."""
    n, msb = qs.shape if qs.dim() == 2 else (-1, -1)
    for name, x in (("qs", qs), ("qe", qe), ("ts", ts), ("te", te),
                    ("cov", cov)):
        if x.dtype != torch.int32 or tuple(x.shape) != (n, msb) or \
                not x.is_contiguous() or x.device != qs.device:
            raise ValueError(f"{name}: need contiguous int32 ({n}, {msb}) "
                             f"on {qs.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for name, x in (("n_seg", n_seg), ("order", order)):
        if x is not None and (x.dtype != torch.int32 or tuple(x.shape) != (
                n,) or not x.is_contiguous() or x.device != qs.device):
            raise ValueError(f"{name}: need a contiguous int32 (n,) tensor "
                             f"on {qs.device}")
    if qs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qs.device}")
    if not 0 < msb <= MAX_SEG:
        raise ValueError(f"msb={msb} outside 1..{MAX_SEG}")
    kw = dict(min_intron=min_intron, max_intron=max_intron)
    if qs.device.type == "cuda":
        return _chain_rows_cuda(qs, qe, ts, te, cov, n_seg, **kw,
                                order=order)
    if n and (int(n_seg.min()) < 0 or int(n_seg.max()) > msb):
        raise ValueError(f"n_seg outside 0..{msb}")
    if order is not None and not torch.equal(
            torch.sort(order).values, torch.arange(n, dtype=torch.int32)):
        raise ValueError("order: not a permutation of the candidates")
    return chain_rows_plain(qs, qe, ts, te, cov, n_seg, **kw)


def chain_batch_rows(qs: np.ndarray, qe: np.ndarray, ts: np.ndarray,
                     te: np.ndarray, cov: np.ndarray, n_seg: np.ndarray,
                     n_cand: int, *, min_intron: int, max_intron: int,
                     device: torch.device) -> np.ndarray:
    """The reference `chain_batch_rows` on `device`: the native seed
    stage's (cap, 512) candidate rows in, (n_cand, msb+3) int16 rows out,
    msb = segment_lanes(batch max segments).

    n_seg's range is checked on the host array before any tensor is made.
    On a CUDA device the five (n_cand, msb) planes, n_seg and the
    candidates' order (`chain_order`) are staged in one pinned host
    buffer and uploaded in one transfer; the kernel's rows come back in
    one transfer into pinned memory.

    Under a pipeline mesh (parallel.mesh.use_mesh) the candidates shard
    in contiguous blocks over the mesh, each of this process's shards
    runs the same route on its own device (rows past n_cand padding with
    n_seg 0), msb from the whole batch, and the rows gather back in shard
    order; `device` is not used then."""
    n_seg = np.asarray(n_seg)[:n_cand]
    if n_cand and (n_seg.min() < 0 or n_seg.max() > MAX_SEG):
        raise ValueError(f"n_seg outside 0..{MAX_SEG}")
    msb = segment_lanes(int(n_seg.max()) if n_cand else 0)
    if n_cand == 0:
        return np.zeros((0, msb + 3), np.int16)
    kw = dict(min_intron=min_intron, max_intron=max_intron)
    planes = (qs, qe, ts, te, cov)
    mesh = pipeline_mesh()
    if mesh is not None:
        _padded, slices = mesh.shard_slices(n_cand)
        (rows,) = fetch_global(mesh, [
            (_route_rows(planes, n_seg, lo, hi, msb, kw, dev),)
            for dev, lo, hi in slices])
        return rows[:n_cand]
    device = torch.device(device)
    rows = _route_rows(planes, n_seg, 0, n_cand, msb, kw, device)
    if device.type != "cuda":
        return rows.numpy()
    with torch.cuda.device(device):
        out = torch.empty(rows.shape, dtype=torch.int16, pin_memory=True)
        out.copy_(rows, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
    return out.numpy()


def _route_rows(planes, n_seg: np.ndarray, lo: int, hi: int, msb: int,
                kw: dict, device: torch.device) -> torch.Tensor:
    """Chain rows of candidates lo..hi (zero rows, n_seg 0, past
    n_seg's end) on `device`, left there. On CUDA the inputs travel in
    one pinned buffer and the launch is not waited for."""
    n = hi - lo
    real = max(min(hi, len(n_seg)) - lo, 0)
    nseg = np.zeros(n, np.int32)
    nseg[:real] = n_seg[lo:lo + real]
    if device.type != "cuda":
        def put(a):
            out = torch.zeros((n, msb), dtype=torch.int32)
            out[:real] = torch.from_numpy(a[lo:lo + real, :msb])
            return out.to(device)

        return chain_rows(*(put(a) for a in planes),
                          torch.from_numpy(nseg).to(device), **kw)
    plane = n * msb
    staged = torch.empty(5 * plane + 2 * n, dtype=torch.int32,
                         pin_memory=True)
    for p, a in enumerate(planes):
        rows = staged[p * plane:(p + 1) * plane].view(n, msb)
        # torch's copy runs on the host's threads; numpy's on one
        rows[:real].copy_(torch.from_numpy(a[lo:lo + real, :msb]))
        rows[real:].zero_()
    host = staged.numpy()
    host[5 * plane:5 * plane + n] = nseg
    host[5 * plane + n:] = chain_order(nseg)
    with torch.cuda.device(device):
        dev = staged.to(device, non_blocking=True)
        return chain_rows(*dev[:5 * plane].view(5, n, msb).unbind(0),
                          dev[5 * plane:5 * plane + n], **kw,
                          order=dev[5 * plane + n:])


def pack_segment_lists(per_candidate: Sequence[List[Segment]], *,
                       max_intron: int):
    """Candidates' segment lists as `chain_batch_rows` takes them, the
    reference's `chain_batch_jax` packing: each list prepared as
    `chain_segments` prepares it (`prepare_segments`: over MAX_SEG
    segments keeps the longest MAX_SEG), its target offsets normalised by
    its smallest t_start, zero padding to segment_lanes(longest) lanes.
    Returns (prepared lists, (qs, qe, ts, te, cov) (n, msb) int32, n_seg
    (n,) int32)."""
    prepped = [prepare_segments(segs, max_intron, MAX_SEG) if segs else []
               for segs in per_candidate]
    n = len(prepped)
    n_seg = np.array([len(segs) for segs in prepped], np.int32)
    msb = segment_lanes(int(n_seg.max()) if n else 0)
    planes = np.zeros((5, n, msb), np.int32)
    for b, segs in enumerate(prepped):
        if segs:
            cols = np.array([(s.q_start, s.q_end, s.t_start, s.t_end,
                              s.score_len) for s in segs], np.int64).T
            cols[2:4] -= cols[2].min()
            planes[:, b, :len(segs)] = cols
    return prepped, tuple(planes), n_seg


def chains_from_rows(prepped: Sequence[List[Segment]], rows: np.ndarray
                     ) -> List[Tuple[List[Segment], float]]:
    """Each candidate's (chain, float32 score) from its packed row: the
    parent table traced back from the best lane, overlaps trimmed in the
    reference's order (`_unpack_chain` and the loop after it); ([], 0.0)
    for an empty list."""
    msb = rows.shape[1] - 3
    best = rows[:, msb].astype(np.int64)
    scores = np.ascontiguousarray(rows[:, msb + 1:msb + 3]).view(
        np.float32)[:, 0]
    out: List[Tuple[List[Segment], float]] = []
    for b, segs in enumerate(prepped):
        if not segs:
            out.append(([], 0.0))
            continue
        path = []
        at = int(best[b])
        while at >= 0:
            path.append(at)
            at = int(rows[b, at])
        chain: List[Segment] = []
        prev_q = prev_t = -1
        for idx in reversed(path):
            s = segs[idx]
            trim = max(prev_q - s.q_start, prev_t - s.t_start, 0)
            q0, t0 = s.q_start + trim, s.t_start + trim
            if q0 >= s.q_end or t0 >= s.t_end:
                continue
            chain.append(Segment(q0, s.q_end, t0, s.t_end))
            prev_q, prev_t = s.q_end, s.t_end
        out.append((chain, float(scores[b])))
    return out


def chain_batch_segments(per_candidate: Sequence[List[Segment]], *,
                         min_intron: int, max_intron: int,
                         device: torch.device
                         ) -> List[Tuple[List[Segment], float]]:
    """The reference's `chain_batch_jax` on `device`: every candidate's
    segments (one chromosome each) packed (`pack_segment_lists`), chained
    in one `chain_batch_rows` call (the chain kernel on a CUDA device, or
    over the mesh under one) and traced back (`chains_from_rows`).
    Returns (chain, float32 score) a candidate."""
    if not per_candidate:
        return []
    prepped, planes, n_seg = pack_segment_lists(per_candidate,
                                                max_intron=max_intron)
    rows = chain_batch_rows(*planes, n_seg, len(n_seg),
                            min_intron=min_intron, max_intron=max_intron,
                            device=device)
    return chains_from_rows(prepped, rows)
