"""Batched affine-gap DP with its traceback walk, on PyTorch.

Counterpart of mandalorion_tpu/align/kernels.py for the staged device
route: `solve_dp_fused` takes the DP problem descriptors that the native
fill stage returns and gives back exactly what the native emit stage
reads (meta, ks, buf, on_host). Two implementations of one function:

- `dp_fused_plain`: the reference's row math (`row_step`, `_row0`,
  `_dp_kernel`'s best-cell and zdrop tracking, `_traceback_walk`) in
  plain PyTorch, batched over problems with a loop over query rows;
- csrc/dp.cu: the hand-written CUDA kernel (one block per problem).

`dp_fused` dispatches on the tensors' device: CPU tensors take the plain
version, CUDA tensors the kernel (never the other way round).

The queries are read from the batch's `oriented` codes and the targets
from the genome tensor that stays resident on the device, using the
descriptors' offsets (mode 2, extend_left, reads both slices reversed).
Problems with nq > 2048 or nt > 2303 are not device-eligible: they come
back with on_host=1 and the emit stage solves them with the bit-identical
host solver, exactly as in the reference.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from mandalorion_tpu_torch.config import AlignConfig
from mandalorion_tpu_torch import _build
from mandalorion_tpu_torch.runtime import LaunchCounter

NEG = -(10 ** 9)
PAD = 9                 # target code of the boundary column: matches nothing
MAX_Q_DEVICE = 2048
MAX_T_DEVICE = 2303
# pointer scratch per call, in bytes of (rows+1)*(cols+1) per problem
# padded to the chunk's largest problem (one byte per cell; the reference
# capped its int32 pointer matrices at 256 MB)
PTR_BUDGET = 1 << 30

DP_LAUNCHES = LaunchCounter("dp_fused")

Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def dp_fused_plain(genome: torch.Tensor, oriented: torch.Tensor,
                   q_lo: torch.Tensor, t_lo: torch.Tensor,
                   nq: torch.Tensor, nt: torch.Tensor, mode: torch.Tensor,
                   cfg: AlignConfig, steps: int) -> Tensors:
    """Plain PyTorch DP fill + walk; see `dp_fused` for the contract."""
    dev = genome.device
    i32 = torch.int32
    n = nq.shape[0]
    max_q = int(nq.max())
    width = int(nt.max()) + 1
    go, ge = cfg.gap_open, cfg.gap_extend
    nq64, nt64 = nq.long()[:, None], nt.long()[:, None]
    rev = (mode == 2)[:, None]

    k = torch.arange(max_q, device=dev)
    q_idx = torch.where(rev, q_lo[:, None] + nq64 - 1 - k, q_lo[:, None] + k)
    q = oriented[q_idx.clamp(0, oriented.numel() - 1)].to(i32)
    j = torch.arange(width, device=dev)
    t_idx = torch.where(rev, t_lo[:, None] + nt64 - j,
                        t_lo[:, None] + j - 1)
    t = torch.where((j >= 1) & (j <= nt64),
                    genome[t_idx.clamp(0, genome.numel() - 1)].to(i32), PAD)

    jidx = j.to(i32)[None, :]
    h = torch.where(jidx == 0, 0, -(go + ge * jidx)).expand(n, width)
    e = torch.full((n, width), NEG, dtype=i32, device=dev)
    ptr = torch.empty((n, max_q + 1, width), dtype=torch.uint8, device=dev)
    ptr[:, 0] = torch.where(jidx == 0, 0, 2 | ((jidx > 1).to(i32) << 3))
    neg_col = torch.full((n, 1), NEG, dtype=i32, device=dev)
    in_target = jidx <= nt[:, None]
    zeros = torch.zeros(n, dtype=i32, device=dev)
    best, best_i, best_j, raw_best, final = (zeros.clone() for _ in range(5))
    cut = torch.zeros(n, dtype=torch.bool, device=dev)

    def shift_right(x):
        return torch.cat([neg_col, x[:, :-1]], dim=1)

    for i in range(1, max_q + 1):
        # one DP row (`row_step`): E column-local, F by one prefix max
        open_e = h - go - ge
        ext_e = e - ge
        e = torch.maximum(open_e, ext_e)
        e_ext = ext_e > open_e
        sub = torch.where(t == q[:, i - 1:i], cfg.match, -cfg.mismatch)
        diag = shift_right(h) + sub
        b = torch.where(jidx == 0, e, torch.maximum(diag, e))
        scan = torch.cummax(b + ge * jidx, dim=1).values
        f = shift_right(scan) - go - ge * jidx
        f_ext = (shift_right(f) - ge) > (shift_right(b) - go - ge)
        take_e = e > diag
        h = torch.where(take_e, e, diag)
        code = take_e.to(i32)
        take_f = f > h
        h = torch.where(take_f, f, h)
        code = torch.where(take_f, 2, code)
        h = torch.where(jidx == 0, e, h)
        code = torch.where(jidx == 0, 1, code)
        ptr[:, i] = code | (e_ext.to(i32) << 2) | (f_ext.to(i32) << 3)

        # best cell (first max, strict > across rows), zdrop latch
        live = nq >= i
        raw, arg = torch.where(in_target, h, NEG).max(dim=1)
        if cfg.zdrop > 0:
            cut = cut | (raw < raw_best - cfg.zdrop)
            ok = live & ~cut
            raw_best = torch.where(ok & (raw > raw_best), raw, raw_best)
        else:
            ok = live
        row_best = raw + (nq == i).to(i32) * cfg.end_bonus
        better = ok & (row_best > best)
        best = torch.where(better, row_best, best)
        best_i = torch.where(better, i, best_i)
        best_j = torch.where(better, arg.to(i32), best_j)
        final = torch.where(nq == i, h.gather(1, nt64)[:, 0], final)

    # the walk (`_traceback_walk`): states 0 H, 1 E, 2 F
    is_global = mode == 0
    dead = ~is_global & (best <= 0)
    qi = torch.where(is_global, nq, torch.where(dead, 0, best_i)).long()
    tj = torch.where(is_global, nt, torch.where(dead, 0, best_j)).long()
    rows = torch.arange(n, device=dev)
    state = torch.zeros(n, dtype=i32, device=dev)
    ks = torch.zeros(n, dtype=torch.long, device=dev)
    buf = torch.zeros((n, steps), dtype=torch.int8, device=dev)
    active = (qi > 0) | (tj > 0)
    while bool(active.any()):
        bits = ptr[rows, qi, tj].to(i32)
        code = bits & 3
        is_h, is_e, is_f = state == 0, state == 1, state == 2
        h_diag = is_h & (code == 0) & (qi > 0) & (tj > 0)
        h_to_e = is_h & ~h_diag & (code == 1)
        h_to_f = is_h & ~h_diag & (code != 1)
        emit = active & (h_diag | is_e | is_f)
        op = torch.where(h_diag, 1, torch.where(is_e, 2, 3)).to(torch.int8)
        buf[rows[emit], ks[emit]] = op[emit]
        ks = ks + emit.long()
        qi = qi - (active & (h_diag | is_e)).long()
        tj = tj - (active & (h_diag | is_f)).long()
        nxt = torch.where(
            h_diag, 0, torch.where(
                h_to_e, 1, torch.where(
                    h_to_f, 2, torch.where(
                        is_e, (bits >> 2) & 1,
                        torch.where(is_f, 2 * ((bits >> 3) & 1), state)))))
        state = torch.where(active, nxt, state)
        active = ((qi > 0) | (tj > 0)) & (ks < steps)
    meta = torch.stack([best_i, best_j, best, final], dim=1)
    return meta, ks.to(i32), buf


def _dp_fused_cuda(genome, oriented, q_lo, t_lo, nq, nt, mode,
                   cfg: AlignConfig, steps: int) -> Tensors:
    lib = _build.load_kernels()
    dev = genome.device
    n = nq.shape[0]
    cells = (nq.long() + 1) * (nt.long() + 1)
    ptr_off = torch.cumsum(cells, 0) - cells
    scratch = torch.empty(int(cells.sum()), dtype=torch.uint8, device=dev)
    meta = torch.empty((n, 4), dtype=torch.int32, device=dev)
    ks = torch.empty(n, dtype=torch.int32, device=dev)
    buf = torch.zeros((n, steps), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        DP_LAUNCHES.count += 1
        rc = lib.mando_dp_fused(
            genome.data_ptr(), oriented.data_ptr(), q_lo.data_ptr(),
            t_lo.data_ptr(), nq.data_ptr(), nt.data_ptr(), mode.data_ptr(),
            ptr_off.data_ptr(), scratch.data_ptr(), meta.data_ptr(),
            ks.data_ptr(), buf.data_ptr(), n, steps, cfg.match,
            cfg.mismatch, cfg.gap_open, cfg.gap_extend, cfg.end_bonus,
            cfg.zdrop, stream)
    _build.check(rc, "mando_dp_fused")
    return meta, ks, buf


def _check_dp_args(genome, oriented, q_lo, t_lo, nq, nt, mode,
                   steps: int) -> None:
    named = {"genome": (genome, torch.uint8),
             "oriented": (oriented, torch.uint8),
             "q_lo": (q_lo, torch.int64), "t_lo": (t_lo, torch.int64),
             "nq": (nq, torch.int32), "nt": (nt, torch.int32),
             "mode": (mode, torch.uint8)}
    n = nq.shape[0] if nq.dim() == 1 else -1
    for name, (x, dtype) in named.items():
        if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous 1-D {dtype} "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
        if x.device != genome.device:
            raise ValueError(f"{name} on {x.device}, genome on "
                             f"{genome.device}")
        if name not in ("genome", "oriented") and x.shape[0] != n:
            raise ValueError(f"{name}: {x.shape[0]} problems, nq has {n}")
    if genome.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {genome.device}")
    if n == 0:
        raise ValueError("no problems")
    lo = torch.stack([nq.min().long(), nt.min().long(), q_lo.min(),
                      t_lo.min()]).tolist()
    hi = torch.stack([nq.max().long(), nt.max().long(),
                      (q_lo + nq).max(), (t_lo + nt).max(),
                      (nq.long() + nt).max()]).tolist()
    if min(lo[:2]) < 1 or hi[0] > MAX_Q_DEVICE or hi[1] > MAX_T_DEVICE:
        raise ValueError(f"problem sizes outside 1..{MAX_Q_DEVICE} x "
                         f"1..{MAX_T_DEVICE}")
    if min(lo[2:]) < 0 or hi[2] > oriented.numel() or \
            hi[3] > genome.numel():
        raise ValueError("problem slices outside oriented/genome")
    if steps < hi[4]:
        raise ValueError(f"steps={steps} < longest walk {hi[4]}")


def dp_fused(genome: torch.Tensor, oriented: torch.Tensor,
             q_lo: torch.Tensor, t_lo: torch.Tensor, nq: torch.Tensor,
             nt: torch.Tensor, mode: torch.Tensor, cfg: AlignConfig,
             steps: int) -> Tensors:
    """DP fill + start-cell pick + traceback walk for n problems.

    Problem p aligns query oriented[q_lo:q_lo+nq] against target
    genome[t_lo:t_lo+nt] (both reversed when mode == 2; mode 0 is global,
    1 and 2 are extensions). All tensors 1-D, contiguous, on one device:
    genome/oriented/mode uint8, q_lo/t_lo int64, nq/nt int32 with
    1 <= nq <= 2048 and 1 <= nt <= 2303. steps >= max(nq + nt).

    Returns meta (n,4) int32 [best_i, best_j, best score, final H],
    ks (n,) int32 and buf (n, steps) int8 (reverse-order step codes
    1 M / 2 I / 3 D, zero past ks). CPU tensors run `dp_fused_plain`,
    CUDA tensors the csrc/dp.cu kernel."""
    _check_dp_args(genome, oriented, q_lo, t_lo, nq, nt, mode, steps)
    if genome.device.type == "cpu":
        return dp_fused_plain(genome, oriented, q_lo, t_lo, nq, nt, mode,
                              cfg, steps)
    return _dp_fused_cuda(genome, oriented, q_lo, t_lo, nq, nt, mode, cfg,
                          steps)


def device_eligible(nq: np.ndarray, nt: np.ndarray) -> np.ndarray:
    """The reference's eligibility rule (`solve_dp_fused`)."""
    return (nq > 0) & (nq <= MAX_Q_DEVICE) & (nt > 0) & (nt <= MAX_T_DEVICE)


def _chunks(order: np.ndarray, nq: np.ndarray, nt: np.ndarray
            ) -> Iterator[np.ndarray]:
    """Split `order` (ascending problem size) into runs whose padded
    pointer matrices fit PTR_BUDGET."""
    start, max_q, max_t = 0, 0, 0
    for k, p in enumerate(order):
        q, t = max(max_q, int(nq[p])), max(max_t, int(nt[p]))
        if k > start and (k - start + 1) * (q + 1) * (t + 1) > PTR_BUDGET:
            yield order[start:k]
            start, q, t = k, int(nq[p]), int(nt[p])
        max_q, max_t = q, t
    if len(order) > start:
        yield order[start:]


def dp_chunks(probs, read_off: np.ndarray, device: torch.device
              ) -> Iterator[Tuple[np.ndarray, tuple, int]]:
    """The device-eligible problems of stage_fill_batch_c's descriptors
    (prob_read, mode, q0, t0, nq, nt) as `dp_fused` inputs on `device`:
    yields (problem indices, (q_lo, t_lo, nq, nt, mode), steps) per chunk,
    smallest problems first, each chunk's padded pointer matrices within
    PTR_BUDGET. q_lo indexes the batch's oriented codes (read_off gives
    each read's start), t_lo the genome."""
    prob_read, prob_mode, prob_q0, prob_t0, prob_nq, prob_nt = (
        np.asarray(a) for a in probs)
    nq = prob_nq.astype(np.int64)
    nt = prob_nt.astype(np.int64)
    rev = prob_mode == 2  # extend_left: the slices end at q0 / t0
    base = read_off[prob_read]
    q_lo = np.where(rev, base + prob_q0 - nq, base + prob_q0)
    t_lo = np.where(rev, prob_t0 - nt, prob_t0)
    idx = np.flatnonzero(device_eligible(nq, nt))
    order = idx[np.argsort((nq[idx] + 1) * (nt[idx] + 1), kind="stable")]

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    for chunk in _chunks(order, nq, nt):
        yield chunk, (put(q_lo[chunk], np.int64), put(t_lo[chunk], np.int64),
                      put(nq[chunk], np.int32), put(nt[chunk], np.int32),
                      put(prob_mode[chunk], np.uint8)), \
            int((nq[chunk] + nt[chunk]).max())


def solve_dp_fused(probs, oriented: np.ndarray, read_off: np.ndarray,
                   genome: torch.Tensor, cfg: AlignConfig):
    """Solve the staged route's DP descriptors (stage_fill_batch_c's
    (prob_read, mode, q0, t0, nq, nt)) on genome.device.

    `genome` is the index's uint8 codes, resident on the device;
    `oriented`/`read_off` are the batch's host arrays. Returns host
    arrays (meta (n,4) int32, ks (n,) int32, buf (n,S) int8,
    on_host (n,) uint8), the reference `solve_dp_fused`'s contract: rows
    with on_host=1 are left zero for the emit stage to solve."""
    nq, nt = np.asarray(probs[4]), np.asarray(probs[5])
    n = len(nq)
    ok = device_eligible(nq, nt)
    meta = np.zeros((n, 4), np.int32)
    ks = np.zeros(n, np.int32)
    buf = np.zeros((n, int((nq + nt)[ok].max()) if ok.any() else 1),
                   np.int8)
    if ok.any():
        oriented_t = torch.from_numpy(oriented).to(genome.device)
        for chunk, desc, steps in dp_chunks(probs, read_off, genome.device):
            m, k, b = dp_fused(genome, oriented_t, *desc, cfg, steps)
            meta[chunk] = m.cpu().numpy()
            ks[chunk] = k.cpu().numpy()
            buf[chunk, :steps] = b.cpu().numpy()
    return meta, ks, buf, (~ok).astype(np.uint8)
