"""Batched affine-gap DP with its traceback walk, on PyTorch.

Counterpart of mandalorion_tpu/align/kernels.py. Two entries:

- `solve_dp_fused` takes the DP problem descriptors that the native fill
  stage returns and gives back exactly what the native emit stage reads
  (meta, ks, buf, on_host): the staged routes' entry;
- `solve_dp_device` takes a list of `DpProblem`s and returns their
  `DpResult`s (the reference's `solve_dp_pallas` and `solve_dp_rowscan`):
  the entry of the routes that chain on the host.

Both end in `dp_fused`, one function with two implementations:

- `dp_fused_plain`: the reference's row math (`row_step`, `_row0`,
  `_dp_kernel`'s best-cell and zdrop tracking, `_traceback_walk`) in
  plain PyTorch, batched over problems with a loop over query rows;
- csrc/dp.cu: the hand-written CUDA kernel (a warp a problem, lanes on
  query rows; tall and wide problems a block each), laid out by
  `dp_layout`.

`dp_fused` dispatches on the tensors' device: CPU tensors take the plain
version, CUDA tensors the kernel (never the other way round). Only
`rowscan=True`, which `--dp_backend rowscan` alone asks for, runs the
plain version on a CUDA device: the reference's pure-JAX row scan
(`_rowscan_fn`) as PyTorch ops on the card.

The queries are read from the batch's `oriented` codes and the targets
from the genome tensor that stays resident on the device, using the
descriptors' offsets (mode 2, extend_left, reads both slices reversed).
Problems with nq > 2048 or nt > 2303 are not device-eligible: they come
back with on_host=1 and the emit stage solves them with the bit-identical
host solver, exactly as in the reference.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mandalorion_tpu_torch.align.extend import (
    DpProblem, DpResult, solve_dp_native)
from mandalorion_tpu_torch.config import AlignConfig
from mandalorion_tpu_torch import _build
from mandalorion_tpu_torch.parallel.mesh import fetch_global, pipeline_mesh
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

# csrc/dp.cu's launch geometry: WARPS warps a block, each with WARP_SHARE_CAP
# bytes of shared memory at most; a lane computes one column a step on a
# one-warp problem, TEAM_COLS on a team's; a problem whose pointers spill to
# scratch stages WIN_BYTES of them for its walk; a team problem's block keeps
# TEAM_FLAGS bytes of progress flags. A problem of two strips of 32 query
# rows or more, more than 64 groups of TEAM_COLS columns (a strip trails the
# one above by some 48 steps) and at least TEAM_STEPS team steps (strips x
# (groups + 31)) takes a whole block.
WARPS = 8
TEAM_COLS = 4
WARP_SHARE_CAP = 12 * 1024
WIN_BYTES = 64 * 32
TEAM_FLAGS = 64
TEAM_STEPS = 1024

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


def _align16(x):
    return (x + 15) // 16 * 16


class DpLayout(NamedTuple):
    """Where csrc/dp.cu puts each problem of a launch (`dp_layout`)."""
    order: np.ndarray      # (n,) int32: one-warp problems, then team ones
    n_small: int           # problems on one warp each
    ptr_off: np.ndarray    # (n,) int64 bytes into the pointer scratch, -1:
    #                        pointers in shared memory
    bnd_off: np.ndarray    # (n,) int64 (H, E) entries into the boundary
    #                        scratch, -1: none or in shared memory
    ptr_bytes: int         # pointer scratch, WIN_BYTES of slack included
    bnd_entries: int       # boundary scratch, in (H, E) int32 pairs
    warp_share: int        # shared-memory bytes a one-warp problem's warp
    per_block: int         # one-warp problems a block
    block_bytes: int       # shared-memory bytes a block
    all_shared: bool       # every problem on one warp, in its order, with
    #                        everything in shared memory


def dp_layout(nq: np.ndarray, nt: np.ndarray, n_sm: int = 132
              ) -> DpLayout:
    """csrc/dp.cu's layout of a launch, from the problems' sizes.

    A warp's share holds the target codes (nt + 1 bytes, rounded to 16),
    the boundary row between strips when nq > 32 (H and E, 8 bytes a
    column) and the pointer bytes (nq rows at a pitch of 5 mod 8 bytes),
    or the walk's window of WIN_BYTES when the pointers spill to scratch,
    laid out (strip, step, lane) in 32 x (nt + 32) bytes a strip. A team
    computes TEAM_COLS columns a lane and a step: its scratch takes
    32 x (groups + 31) words of TEAM_COLS bytes a strip, its WARPS boundary
    rows 8 x TEAM_COLS bytes a group each. Pointers stay in
    shared memory when all three fit WARP_SHARE_CAP; a spilling problem
    keeps its boundary row there if it fits beside the window. A team
    problem (a block) keeps its pointers and WARPS boundary rows in scratch
    and needs TEAM_FLAGS + 8 nq + codes + WIN_BYTES bytes of its block.
    warp_share is the largest one-warp need of the launch. One-warp
    problems go WARPS to a block, fewer when the launch has too few of
    them to give each of the card's n_sm SMs a block."""
    nq = np.asarray(nq, np.int64)
    nt = np.asarray(nt, np.int64)
    n = len(nq)
    width = nt + 1
    t_bytes = _align16(width)
    b_bytes = np.where(nq > 32, _align16(8 * width), 0)
    p_bytes = _shared_need(nq, nt) - t_bytes - b_bytes
    in_shared = t_bytes + b_bytes + p_bytes <= WARP_SHARE_CAP
    if n and in_shared.all() and not ((nq > 32) & (nt > 255)).any():
        # no team (one strip, or at most 64 groups) and nothing in scratch
        return _on_chip_layout(n, int((t_bytes + b_bytes + p_bytes).max()),
                               n_sm)
    strips = (nq + 31) // 32
    groups = (nt + TEAM_COLS) // TEAM_COLS
    team = (strips > 1) & (groups > 64) & (strips * (groups + 31)
                                           >= TEAM_STEPS)
    in_shared &= ~team
    bnd_shared = (nq > 32) & ~team & (
        in_shared | (t_bytes + b_bytes + WIN_BYTES <= WARP_SHARE_CAP))
    need = t_bytes + np.where(bnd_shared, b_bytes, 0) + np.where(
        in_shared, p_bytes, WIN_BYTES)
    team_need = TEAM_FLAGS + _align16(8 * nq) + \
        _align16(TEAM_COLS * groups) + WIN_BYTES
    n_small = int((~team).sum())
    warp_share = _align16(int(need[~team].max(initial=16)))
    per_block = int(min(WARPS, max(1, -(-n_small // n_sm))))
    g_bytes = np.where(in_shared, 0, strips * 32 * np.where(
        team, (groups + 31) * TEAM_COLS, width + 31))
    ptr_off = np.where(in_shared, -1, np.cumsum(g_bytes) - g_bytes)
    b_entries = np.where((nq > 32) & ~bnd_shared,
                         np.where(team, WARPS * TEAM_COLS * groups, width),
                         0)
    bnd_off = np.where(b_entries > 0, np.cumsum(b_entries) - b_entries, -1)
    order = np.concatenate([np.flatnonzero(~team), np.flatnonzero(team)])
    return DpLayout(order.astype(np.int32), n_small, ptr_off, bnd_off,
                    int(g_bytes.sum()) + WIN_BYTES, int(b_entries.sum()),
                    warp_share, per_block,
                    max(per_block * warp_share,
                        _align16(int(team_need[team].max(initial=0)))),
                    False)


def _on_chip_layout(n: int, need: int, n_sm: int) -> DpLayout:
    """The layout of n one-warp problems that keep everything in shared
    memory, the largest needing `need` bytes."""
    share = _align16(need)
    per_block = int(min(WARPS, max(1, -(-n // n_sm))))
    none = np.full(n, -1, np.int64)
    return DpLayout(np.arange(n, dtype=np.int32), n, none, none, WIN_BYTES,
                    0, share, per_block, per_block * share, True)


def dp_prepare(lay: DpLayout, steps: int, device: torch.device) -> tuple:
    """What one launch of csrc/dp.cu with layout `lay` needs beside its
    inputs: the layout's tensors on `device` (order, ptr_off, bnd_off;
    None when the layout keeps everything in shared memory), the scratch
    buffers, the outputs (meta, ks, buf; the kernel writes them whole) and
    the layout."""
    index = (None, None, None) if lay.all_shared else torch.from_numpy(
        np.stack([lay.order.astype(np.int64), lay.ptr_off, lay.bnd_off])
    ).to(device)
    n = len(lay.order)
    return (None if lay.all_shared else index[0].to(torch.int32),
            index[1], index[2],
            torch.empty(lay.ptr_bytes, dtype=torch.uint8, device=device),
            torch.empty((max(lay.bnd_entries, 1), 2), dtype=torch.int32,
                        device=device),
            torch.empty((n, 4), dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty((n, steps), dtype=torch.int8, device=device), lay)


_SM_COUNTS: dict = {}


def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return 132
    if device not in _SM_COUNTS:
        _SM_COUNTS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNTS[device]


def dp_launch(genome, oriented, q_lo, t_lo, nq, nt, mode, prep: tuple,
              cfg: AlignConfig, steps: int) -> Tensors:
    """Launch csrc/dp.cu on the current stream with `dp_prepare`'s
    buffers; returns its (meta, ks, buf)."""
    lib = _build.load_kernels()
    order, ptr_off, bnd_off, scratch, bnd, meta, ks, buf, lay = prep
    dev = genome.device

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        DP_LAUNCHES.count += 1
        rc = lib.mando_dp_fused(
            genome.data_ptr(), oriented.data_ptr(), q_lo.data_ptr(),
            t_lo.data_ptr(), nq.data_ptr(), nt.data_ptr(), mode.data_ptr(),
            ptr(order), ptr(ptr_off), ptr(bnd_off), scratch.data_ptr(),
            bnd.data_ptr(), meta.data_ptr(), ks.data_ptr(), buf.data_ptr(),
            nq.shape[0], lay.n_small, steps, lay.per_block, lay.warp_share,
            lay.block_bytes, cfg.match, cfg.mismatch, cfg.gap_open,
            cfg.gap_extend, cfg.end_bonus, cfg.zdrop, stream)
    _build.check(rc, "mando_dp_fused")
    return meta, ks, buf


def _check_dp_args(genome, oriented, q_lo, t_lo, nq, nt, mode,
                   steps: int) -> Tuple[int, int]:
    """Raise on what neither version takes; returns the largest nq and nt
    (one fetch of a few reductions)."""
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
    nq64, nt64 = nq.long(), nt.long()
    (nq_lo, nt_lo, q0_lo, t0_lo, nq_hi, nt_hi, q_end, t_end,
     walk) = torch.cat([
         torch.stack([nq64.min(), nt64.min(), q_lo.min(), t_lo.min()]),
         torch.stack([nq64.max(), nt64.max(), (q_lo + nq64).max(),
                      (t_lo + nt64).max(), (nq64 + nt64).max()])]).tolist()
    if min(nq_lo, nt_lo) < 1 or nq_hi > MAX_Q_DEVICE or nt_hi > MAX_T_DEVICE:
        raise ValueError(f"problem sizes outside 1..{MAX_Q_DEVICE} x "
                         f"1..{MAX_T_DEVICE}")
    if min(q0_lo, t0_lo) < 0 or q_end > oriented.numel() \
            or t_end > genome.numel():
        raise ValueError("problem slices outside oriented/genome")
    if steps < walk:
        raise ValueError(f"steps={steps} < longest walk {walk}")
    return nq_hi, nt_hi


def _shared_need(nq, nt):
    """Shared-memory bytes of a one-warp problem that keeps everything on
    chip (`dp_layout`): target codes, boundary row, pointer rows. It grows
    with nq and with nt. Scalars or numpy arrays."""
    width = nt + 1
    return _align16(width) + np.where(nq > 32, _align16(8 * width), 0) \
        + nq * (width + (5 - width) % 8)


def dp_fused(genome: torch.Tensor, oriented: torch.Tensor,
             q_lo: torch.Tensor, t_lo: torch.Tensor, nq: torch.Tensor,
             nt: torch.Tensor, mode: torch.Tensor, cfg: AlignConfig,
             steps: int, rowscan: bool = False) -> Tensors:
    """DP fill + start-cell pick + traceback walk for n problems.

    Problem p aligns query oriented[q_lo:q_lo+nq] against target
    genome[t_lo:t_lo+nt] (both reversed when mode == 2; mode 0 is global,
    1 and 2 are extensions). All tensors 1-D, contiguous, on one device:
    genome/oriented/mode uint8, q_lo/t_lo int64, nq/nt int32 with
    1 <= nq <= 2048 and 1 <= nt <= 2303. steps >= max(nq + nt).

    Returns meta (n,4) int32 [best_i, best_j, best score, final H],
    ks (n,) int32 and buf (n, steps) int8 (reverse-order step codes
    1 M / 2 I / 3 D, zero past ks). CPU tensors run `dp_fused_plain`,
    CUDA tensors the csrc/dp.cu kernel; with rowscan=True every device
    runs `dp_fused_plain`."""
    nq_hi, nt_hi = _check_dp_args(genome, oriented, q_lo, t_lo, nq, nt,
                                  mode, steps)
    if rowscan or genome.device.type == "cpu":
        return dp_fused_plain(genome, oriented, q_lo, t_lo, nq, nt, mode,
                              cfg, steps)
    return dp_launch(genome, oriented, q_lo, t_lo, nq, nt, mode,
                     dp_prepare(_launch_layout(nq, nt, nq_hi, nt_hi),
                                steps, genome.device), cfg, steps)


def _launch_layout(nq: torch.Tensor, nt: torch.Tensor, nq_hi: int,
                   nt_hi: int) -> DpLayout:
    """The launch's layout. When a problem of the largest nq and the
    largest nt would stay on chip on one warp, so does every problem (the
    need grows with both), and no size is fetched: the warp share is that
    problem's need. Otherwise `dp_layout` on the fetched sizes."""
    n_sm = _sm_count(nq.device)
    need = int(_shared_need(nq_hi, nt_hi))
    if need <= WARP_SHARE_CAP and (nq_hi <= 32 or nt_hi <= 255):
        return _on_chip_layout(nq.shape[0], need, n_sm)
    sizes = torch.stack([nq, nt]).cpu().numpy()
    return dp_layout(sizes[0], sizes[1], n_sm)


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


def dp_chunks(probs, read_off: np.ndarray, device: torch.device,
              idx: Optional[np.ndarray] = None
              ) -> Iterator[Tuple[np.ndarray, tuple, int]]:
    """The device-eligible problems of stage_fill_batch_c's descriptors
    (prob_read, mode, q0, t0, nq, nt), or of those the problem indices
    `idx` name, as `dp_fused` inputs on `device`: yields (problem
    indices, (q_lo, t_lo, nq, nt, mode), steps) per chunk, smallest
    problems first, each chunk's padded pointer matrices within
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
    if idx is None:
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
                   genome, cfg: AlignConfig, rowscan: bool = False):
    """Solve the staged route's DP descriptors (stage_fill_batch_c's
    (prob_read, mode, q0, t0, nq, nt)) on genome's device.

    `genome` is the index's uint8 codes, resident on the device (or a
    dict of them by device); `oriented`/`read_off` are the batch's host
    arrays. Returns host arrays (meta (n,4) int32, ks (n,) int32,
    buf (n,S) int8, on_host (n,) uint8), the reference `solve_dp_fused`'s
    contract: rows with on_host=1 are left zero for the emit stage to
    solve. rowscan=True runs `dp_fused_plain` on the device in place of
    the kernel (`--dp_backend rowscan`).

    Under a pipeline mesh the device-eligible problems shard in
    contiguous blocks over the mesh; each of this process's shards runs
    its own chunks against the genome codes on its device, and meta, ks
    and buf (as wide as the batch's longest walk) gather once a call."""
    nq, nt = np.asarray(probs[4]), np.asarray(probs[5])
    n = len(nq)
    ok = device_eligible(nq, nt)
    meta = np.zeros((n, 4), np.int32)
    ks = np.zeros(n, np.int32)
    buf = np.zeros((n, int((nq + nt)[ok].max()) if ok.any() else 1),
                   np.int8)
    if not ok.any():
        return meta, ks, buf, (~ok).astype(np.uint8)
    mesh = pipeline_mesh()
    if mesh is None:
        dev = genome.device
        oriented_t = torch.from_numpy(oriented).to(dev)
        for chunk, desc, steps in dp_chunks(probs, read_off, dev):
            m, k, b = dp_fused(genome, oriented_t, *desc, cfg, steps,
                               rowscan)
            meta[chunk] = m.cpu().numpy()
            ks[chunk] = k.cpu().numpy()
            buf[chunk, :steps] = b.cpu().numpy()
        return meta, ks, buf, (~ok).astype(np.uint8)
    idx = np.flatnonzero(ok)
    _padded, slices = mesh.shard_slices(len(idx))
    shards = []
    oriented_on = {}
    for dev, lo, hi in slices:
        sub = idx[lo:hi]
        m = torch.zeros((hi - lo, 4), dtype=torch.int32, device=dev)
        k = torch.zeros(hi - lo, dtype=torch.int32, device=dev)
        b = torch.zeros((hi - lo, buf.shape[1]), dtype=torch.int8,
                        device=dev)
        if len(sub):
            if dev not in oriented_on:
                oriented_on[dev] = torch.from_numpy(oriented).to(dev)
            codes = genome[dev] if isinstance(genome, dict) \
                else genome.to(dev)
            for chunk, desc, steps in dp_chunks(probs, read_off, dev, sub):
                at = torch.from_numpy(np.searchsorted(sub, chunk)).to(dev)
                mm, kk, bb = dp_fused(codes, oriented_on[dev], *desc, cfg,
                                      steps, rowscan)
                m[at] = mm.to(m.dtype)
                k[at] = kk.to(k.dtype)
                b[at, :steps] = bb.to(b.dtype)
        shards.append((m, k, b))
    g_meta, g_ks, g_buf = fetch_global(mesh, shards)
    meta[idx] = g_meta[:len(idx)]
    ks[idx] = g_ks[:len(idx)]
    buf[idx] = g_buf[:len(idx)]
    return meta, ks, buf, (~ok).astype(np.uint8)


def merge_steps(steps: np.ndarray) -> List[Tuple[str, int, int]]:
    """A walk's reverse-order step codes (1 M, 2 I, 3 D) as a DpResult's
    merged (op, dq, dt) runs, first op first: the reference's
    `_merge_steps`. `steps` holds exactly the walk's ks codes."""
    codes = np.asarray(steps, np.int64)[::-1]
    if len(codes) == 0:
        return []
    starts = np.concatenate([[0], np.flatnonzero(codes[1:] != codes[:-1])
                             + 1])
    lens = np.diff(np.append(starts, len(codes)))
    out = []
    for c, n in zip(codes[starts].tolist(), lens.tolist()):
        op = "MID"[c - 1]
        out.append((op, n if op != "D" else 0, n if op != "I" else 0))
    return out


def problem_batch(problems: Sequence[DpProblem]):
    """The device-eligible problems (`device_eligible`) of a DpProblem
    list as one batch of `solve_dp_fused` descriptors, a problem a
    "read": (their indices, descriptors (read, mode, q0, t0, nq, nt),
    oriented (the queries concatenated), read_off, genome (the targets
    concatenated)), the arrays numpy. Every extension goes as mode 1:
    `_fill` has already reversed an extend_left problem's arrays, and
    modes 1 and 2 differ only in the direction the slices are read."""
    n = len(problems)
    nq = np.fromiter((len(p.q) for p in problems), np.int64, n)
    nt = np.fromiter((len(p.t) for p in problems), np.int64, n)
    idx = np.flatnonzero(device_eligible(nq, nt))
    read_off = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(nq[idx], out=read_off[1:])
    t_off = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(nt[idx], out=t_off[1:])

    def joined(arrays):
        return np.ascontiguousarray(
            np.concatenate(arrays) if arrays else np.zeros(0), np.uint8)

    mode = np.array([problems[i].mode != "global" for i in idx], np.uint8)
    probs = (np.arange(len(idx), dtype=np.int32), mode,
             np.zeros(len(idx), np.int64), t_off[:-1], nq[idx], nt[idx])
    return (idx, probs, joined([problems[i].q for i in idx]), read_off,
            joined([problems[i].t for i in idx]))


def solve_dp_device(problems: Sequence[DpProblem], cfg: AlignConfig,
                    device, rowscan: bool = False) -> List[DpResult]:
    """The DP problem list entry: the reference's `solve_dp_pallas` (and,
    with rowscan=True, `solve_dp_rowscan`) on `device`.

    The device-eligible problems go to `solve_dp_fused` as one batch
    (`problem_batch`), their targets uploaded once a call as its genome
    (once to each mesh device under a pipeline mesh, where the batch
    shards as `solve_dp_fused` shards it and `device` is not used). The
    others (an empty side, nq > 2048, nt > 2303) are solved by
    `solve_dp_native`, as the reference solves them on the host. A global
    result starts at (len q, len t), a local one at its best cell, and a
    local problem whose best is <= 0 gives DpResult([], 0, 0)."""
    idx, probs, oriented, read_off, targets = problem_batch(problems)
    results: List[DpResult] = [None] * len(problems)  # type: ignore
    host = np.setdiff1d(np.arange(len(problems)), idx)
    for i, res in zip(host.tolist(), solve_dp_native(
            [problems[i] for i in host], cfg)):
        results[i] = res
    if len(idx) == 0:
        return results
    mesh = pipeline_mesh()
    if mesh is None:
        genome = torch.from_numpy(targets).to(device)
    else:
        genome = {dev: torch.from_numpy(targets).to(dev)
                  for dev in mesh.distinct_devices()}
    meta, ks, buf, _on_host = solve_dp_fused(probs, oriented, read_off,
                                             genome, cfg, rowscan)
    local, nq, nt = probs[1], probs[4], probs[5]
    for slot, i in enumerate(idx.tolist()):
        if not local[slot]:
            qi, tj = int(nq[slot]), int(nt[slot])
        elif meta[slot, 2] <= 0:
            results[i] = DpResult([], 0, 0)
            continue
        else:
            qi, tj = int(meta[slot, 0]), int(meta[slot, 1])
        results[i] = DpResult(merge_steps(buf[slot, :ks[slot]]), qi, tj)
    return results
