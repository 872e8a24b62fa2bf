"""Batched collinear chain DP on PyTorch.

Counterpart of mandalorion_tpu/align/chain_kernel.py for the staged
device route: `chain_batch_rows` takes the native seed stage's
pre-packed candidate rows and returns the packed int16 rows (parent
table, best index, float32 score bits) that the native fill stage reads.
Two implementations of one function:

- `chain_rows_plain`: `_chain_fn`'s scan in plain PyTorch, batched over
  candidates with a loop over segment index i;
- csrc/chain.cu: the hand-written CUDA kernel (one block per candidate).

`chain_rows` dispatches on the tensors' device: CPU tensors take the
plain version, CUDA tensors the kernel. Both round float32 exactly as the
reference does: every product and sum is its own operation (no fused
multiply-add) and the intron cost uses the frexp exponent.
"""

from __future__ import annotations

import numpy as np
import torch

from mandalorion_tpu_torch import _build
from mandalorion_tpu_torch.runtime import LaunchCounter

NEG = -1e18        # score of padding lanes (float32 of the reference's NEG)
MAX_SEG = 512      # chain_segments' cap
# the scoring every caller of the reference's chain_batch_rows uses (its
# defaults); the native fill stage and module F assume these values
MATCH = 1
INTRON_PENALTY = 12.0
INDEL_OPEN = 4.0
INDEL_SCALE = 0.3

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


def _chain_rows_cuda(qs, qe, ts, te, cov, n_seg, *, min_intron,
                     max_intron) -> torch.Tensor:
    lib = _build.load_kernels()
    n, msb = qs.shape
    rows = torch.empty((n, msb + 3), dtype=torch.int16, device=qs.device)
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        CHAIN_LAUNCHES.count += 1
        rc = lib.mando_chain_rows(
            qs.data_ptr(), qe.data_ptr(), ts.data_ptr(), te.data_ptr(),
            cov.data_ptr(), n_seg.data_ptr(), rows.data_ptr(), n, msb,
            MATCH, min_intron, max_intron, INTRON_PENALTY, INDEL_OPEN,
            INDEL_SCALE, stream)
    _build.check(rc, "mando_chain_rows")
    return rows


def chain_rows(qs: torch.Tensor, qe: torch.Tensor, ts: torch.Tensor,
               te: torch.Tensor, cov: torch.Tensor, n_seg: torch.Tensor, *,
               min_intron: int, max_intron: int) -> torch.Tensor:
    """Chain DP over n candidates of msb segment lanes.

    qs/qe/ts/te/cov: (n, msb) int32, contiguous, segments sorted as the
    native seed stage packs them (target offsets normalized per
    candidate, zero padding); n_seg: (n,) int32 <= msb; msb <= 512.
    Returns (n, msb+3) int16 rows: parent per lane (-1 for none), the
    best lane, and the best score's float32 bits (low half first). CPU
    tensors run `chain_rows_plain`, CUDA tensors the csrc/chain.cu
    kernel."""
    n, msb = qs.shape if qs.dim() == 2 else (-1, -1)
    for name, x in (("qs", qs), ("qe", qe), ("ts", ts), ("te", te),
                    ("cov", cov)):
        if x.dtype != torch.int32 or tuple(x.shape) != (n, msb) or \
                not x.is_contiguous() or x.device != qs.device:
            raise ValueError(f"{name}: need contiguous int32 ({n}, {msb}) "
                             f"on {qs.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if n_seg.dtype != torch.int32 or tuple(n_seg.shape) != (n,) or \
            not n_seg.is_contiguous() or n_seg.device != qs.device:
        raise ValueError("n_seg: need a contiguous int32 (n,) tensor")
    if qs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qs.device}")
    if not 0 < msb <= MAX_SEG:
        raise ValueError(f"msb={msb} outside 1..{MAX_SEG}")
    if n and (int(n_seg.min()) < 0 or int(n_seg.max()) > msb):
        raise ValueError(f"n_seg outside 0..{msb}")
    kw = dict(min_intron=min_intron, max_intron=max_intron)
    if qs.device.type == "cpu":
        return chain_rows_plain(qs, qe, ts, te, cov, n_seg, **kw)
    return _chain_rows_cuda(qs, qe, ts, te, cov, n_seg, **kw)


def chain_batch_rows(qs: np.ndarray, qe: np.ndarray, ts: np.ndarray,
                     te: np.ndarray, cov: np.ndarray, n_seg: np.ndarray,
                     n_cand: int, *, min_intron: int, max_intron: int,
                     device: torch.device) -> np.ndarray:
    """The reference `chain_batch_rows` on `device`: the native seed
    stage's (cap, 512) candidate rows in, (n_cand, msb+3) int16 rows out,
    msb = segment_lanes(batch max segments)."""
    msb = segment_lanes(int(n_seg[:n_cand].max()) if n_cand else 0)

    def put(a):
        a = a[:n_cand, :msb] if a.ndim == 2 else a[:n_cand]
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    rows = chain_rows(put(qs), put(qe), put(ts), put(te), put(cov),
                      put(n_seg), min_intron=min_intron,
                      max_intron=max_intron)
    return rows.cpu().numpy()
