"""Batched sequence-to-graph POA DP and its traceback walk, on PyTorch.

Counterpart of mandalorion_tpu/poa/kernels.py and poa/pallas_kernel.py
for module D's device route. The graph lives on the host (in C++,
`NativePoaGraph`) as columnar padded arrays in topological-rank space;
the O(nodes x query) DP of a batch of (graph, query) problems runs on the
device and only the alignment paths come back:

    fill_arrays (C) -> forward (poa_forward) -> walk (poa_walk)
      -> apply_steps (C)

or, with walk="sweep" (counterpart of poa/pallas_kernel.py's reverse-sweep
walk), the path leaves the device run-compressed, one record per diagonal
step, deleted node or whole insertion run, and C expands it:

    ... -> forward (poa_forward) -> walk (poa_sweep) -> apply_runs (C)

Under MANDO_TPU_NO_NATIVE (no native library) the graphs are Python
`PoaGraph`s, as in the reference without its library, and every round
goes through `_align_graphs` (`align_graph_batch`'s body with a band a
problem; the step walk only):

    graph_arrays (Python) -> forward -> walk (poa_walk) -> apply_path

Two implementations of each device function, side by side:

- `poa_forward_plain` / `poa_walk_plain` / `poa_sweep_plain`: plain
  PyTorch, batched over problems with a Python loop over rank rows / walk
  steps / walk transitions;
- csrc/poa_fwd.cu / csrc/poa_walk.cu / csrc/poa_sweep.cu: the
  hand-written CUDA kernels.

`poa_forward`, `poa_walk` and `poa_sweep` dispatch on the tensors' device:
CPU tensors take the plain version, CUDA tensors the kernel (never the
other way round).

Gap model: abPOA's convex dual-affine (gap_open/gap_extend +
gap_open2/gap_extend2): two deletion states carried across graph edges,
two insertion states resolved per row with prefix-max scans (see
poa/graph.py for why the collapse is exact).

Bit-identical contract: scores, tie-breaks (first-max predecessor in
declared order, diag >= D1 >= D2, strict-> insertions I1 before I2, D
open wins ties over extend), band semantics (static diagonal band and
the score-following adaptive band) and traceback order all match
`PoaGraph.align` and the native C++ engine, so the engines are
interchangeable per read.

Matrix contract (what the forward hands the walk), per problem b, matrix
row t in 0..nn[b] (row 0 is the boundary row, row t is rank t-1), W
stored columns starting at absolute query column offs[b, t]:

    hpack  = op | op0 << 3 | (node0 + 2) << 6
    opack  = orig1 | orig2 << 16        (insertion origins, 16 bits each)
    d1p/d2p = (pred_row << 1) | took_extension
    endcol = H at absolute column ql[b] (NEG outside the window)

All (B, n_cap + 1, W) int32, offs/endcol (B, n_cap + 1) int32, a problem
contiguous. Every cell of rows 0..nn[b] is written; rows past nn[b] are
never read and hold nothing a caller may use (the plain version leaves
zeros and NEG there, the kernel whatever the allocation held:
`clear_rows_past` makes the two comparable). The score and
deletion-state rows stay in device scratch.

The band half-width is a per-problem input (`band`, (B,) int32), so one
dispatch carries problems of any mix of bands; every other field of
`PoaParams` is one value a dispatch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mandalorion_tpu_torch import _build
from mandalorion_tpu_torch.native import load_native
from mandalorion_tpu_torch.parallel.mesh import (
    fetch_global, pad_rows, pipeline_mesh)
from mandalorion_tpu_torch.pipeline.observe import span
from mandalorion_tpu_torch.poa.graph import NEG, PoaGraph, PoaParams
from mandalorion_tpu_torch.runtime import (
    LaunchCounter, require_native, resolve_device)

# One dispatch is chunked so that the forward's device tensors (three
# int32 state rows of scratch plus four packed matrices: 28 bytes a DP
# cell) stay under this many bytes: a tenth of an 80 GB H100. Chunking
# changes padding only, never results.
CHUNK_BYTES = 8 << 30
BYTES_PER_CELL = 28

POA_FWD_LAUNCHES = LaunchCounter("poa_fwd")
POA_WALK_LAUNCHES = LaunchCounter("poa_walk")
POA_SWEEP_LAUNCHES = LaunchCounter("poa_sweep")

# run-compressed walk records, in emission order (path end to path start):
#   rec0 = qi_hi | type << 16, rec1 = qi_lo | (rank + 2) << 16
#   type 0 DIAG: one (qi_hi, rank) step
#   type 1 DEL:  one (-1, rank) step
#   type 2 INS:  steps (qi, -1) for qi = qi_hi down to qi_lo
REC_DIAG, REC_DEL, REC_INS = 0, 1, 2
WALKS = ("steps", "sweep")
# rec1 holds rank + 2 in its upper half and the C consumer decodes it with a
# signed shift: the sweep serves row caps with n_cap + 2 below this
SWEEP_RANK_LIMIT = 1 << 15

Mats = Tuple[torch.Tensor, ...]  # hpack, opack, d1p, d2p, offs, endcol


class RunObserver:
    """What a caller asks `poa_consensus_batch` to record while this
    object is installed as `OBSERVER`: rounds, chunk shapes and host
    seconds in the C staging calls, the `poa.fill` and `poa.apply` spans'
    (`apply_s` covers apply_steps and apply_runs alike; under
    MANDO_TPU_NO_NATIVE `fill_s` is graph_arrays' and `apply_s`
    apply_path's), always; with `time_kernels` a CUDA event pair
    around every kernel launch (read after a synchronise by `kernel_ms`,
    the walk under the key of the kernel that ran); the numpy arrays of
    the chunks of `keep_rounds` as `kept` = [(round, W, l_cap, arrays)];
    with `keep_largest` the chunk
    of most DP cells as `largest` = (arrays, W, l_cap, params), so that a
    check can replay real chunks."""

    def __init__(self, time_kernels: bool = False, keep_rounds=(),
                 keep_largest: bool = False):
        self.time_kernels = time_kernels
        self.keep_rounds = keep_rounds
        self.keep_largest = keep_largest
        self.kept: list = []
        self.largest = None
        self.rounds = 0
        # B, n_cap, W, rows, round
        self.chunks: List[Tuple[int, int, int, int, int]] = []
        self.fill_s = 0.0
        self.apply_s = 0.0
        self.events = {"poa_fwd": [], "poa_walk": [], "poa_sweep": []}

    def chunk(self, k: int, arrays, W: int, l_cap: int,
              params: PoaParams) -> None:
        base, nn = arrays[0], arrays[2]  # arrays: as problems_from_numpy's
        self.chunks.append((base.shape[0], base.shape[1], W, int(nn.max()),
                            k))
        if k in self.keep_rounds:
            self.kept.append((k, W, l_cap, arrays))
        if self.keep_largest and (
                self.largest is None
                or base.size * W > self.largest[0][0].size * self.largest[1]):
            self.largest = (arrays, W, l_cap, params)

    def kernel_ms(self) -> dict:
        torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in pairs)
                for name, pairs in self.events.items()}


# the one hook into the consensus round loop: None (nothing is recorded)
# unless a caller installs a RunObserver around the calls it wants to see
OBSERVER: Optional[RunObserver] = None


def _pow2_at_least(n: int, floor: int = 64) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _rank_cap(n_max: int) -> int:
    """Row cap for graphs of up to n_max nodes: pow2 up to 1024, then
    multiples of 512 (the reference's buckets, kept so that shapes and
    matrices compare one to one)."""
    return (_pow2_at_least(n_max) if n_max <= 1024
            else -(-n_max // 512) * 512)


def graph_arrays(graph: PoaGraph, n_cap: int, p_cap: int,
                 order: Optional[List[int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[int]]:
    """Columnar rank-space arrays for one graph, padded to (n_cap, p_cap):
    (base_r, preds_r, is_end_r, order). preds_r holds predecessor ranks + 1
    (0 = virtual source row), -1 padding."""
    if order is None:
        order = graph.topo_order()
    rank = {v: r for r, v in enumerate(order)}
    base_r = np.zeros(n_cap, np.int32)
    preds_r = np.full((n_cap, p_cap), -1, np.int32)
    is_end_r = np.zeros(n_cap, bool)
    for r, v in enumerate(order):
        base_r[r] = graph.base[v]
        ps = graph.preds[v]
        if ps:
            for c, u in enumerate(ps):
                preds_r[r, c] = rank[u] + 1
        else:
            preds_r[r, 0] = 0
        is_end_r[r] = not graph.succs[v]
    return base_r, preds_r, is_end_r, order


def max_back_distance(preds_r: np.ndarray, n_nodes: int) -> int:
    """Largest (row - predecessor_row) over real predecessors (the
    virtual source row 0 excluded). The kernels here read any earlier row
    whatever its distance; tests use this to prove that a graph reaches
    further back than the reference's on-chip row ring."""
    rows = np.arange(1, n_nodes + 1)[:, None]
    pr = preds_r[:n_nodes].astype(np.int64)
    back = np.where(pr >= 1, rows - pr, 0)
    return int(back.max(initial=0))


def _item_width(n_nodes: int, qlen: int, band: int, l_cap: int,
                adaptive: bool = False) -> int:
    """Banded-storage window width for one item: wide enough that its
    per-row band [j0, j1] fits (adaptive: half-width exactly `band`;
    static: eff_band widens with |nodes - qlen| drift), rounded up to a
    power of two, floor 256 (over-width is safe: columns beyond the band
    are NEG-masked). The same widths as the reference's."""
    eff = band if adaptive else max(band, abs(n_nodes - qlen) + 16)
    need = min(qlen + 1, 2 * eff + 2)
    need = min(-(-(l_cap + 1) // 128) * 128, need)
    return _pow2_at_least(need, floor=256)


def check_problem_ranges(nn: np.ndarray, ql: np.ndarray, n_cap: int,
                         l_cap: int) -> None:
    """The kernels index rows by nn and columns by ql and pack insertion
    origins into 16 bits: refuse anything outside on the host."""
    if len(nn) and (nn.min() < 0 or nn.max() > n_cap or ql.min() < 0
                    or ql.max() > l_cap or ql.max() >= 1 << 16):
        raise ValueError(f"node counts outside 0..{n_cap} or query lengths "
                         f"outside 0..min({l_cap}, 65535)")


def problems_from_numpy(base: np.ndarray, preds: np.ndarray, nn: np.ndarray,
                        ends: np.ndarray, qq: np.ndarray, ql: np.ndarray,
                        band: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """The rank-space numpy arrays of a chunk (base (B, n_cap), preds
    (B, n_cap, p_cap), nn (B,), ends (B, n_cap), qq (B, l_cap), ql (B,),
    band (B,) band half-widths) as the device functions' tensors: int32,
    contiguous, on `device` (ends as uint8), after
    `check_problem_ranges`."""
    check_problem_ranges(np.asarray(nn), np.asarray(ql), base.shape[1],
                         qq.shape[1])
    if len(band) != len(nn) or (len(band) and np.min(band) < 0):
        raise ValueError("one band half-width >= 0 a problem expected")

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return (put(base, np.int32), put(preds, np.int32), put(nn, np.int32),
            put(ends, np.uint8), put(qq, np.int32), put(ql, np.int32),
            put(band, np.int32))


# ------------------------------------------------------------ forward

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=1).values


def _band_tensor(band: Optional[torch.Tensor], params: PoaParams, B: int,
                 device: torch.device) -> torch.Tensor:
    """The (B,) int32 band half-widths: `band`, or params.band for every
    problem when the caller gave none."""
    if band is None:
        return torch.full((B,), params.band, dtype=torch.int32,
                          device=device)
    return band


def poa_forward_plain(base: torch.Tensor, preds: torch.Tensor,
                      nn: torch.Tensor, qq: torch.Tensor, ql: torch.Tensor,
                      params: PoaParams, W: int,
                      band: Optional[torch.Tensor] = None) -> Mats:
    """Plain PyTorch forward; see `poa_forward` for the contract. The row
    math of the reference's `_align_rows`, batched over problems, each
    with its own band half-width."""
    dev = base.device
    i32 = torch.int32
    B, n_cap = base.shape
    p_cap = preds.shape[2]
    l_cap = qq.shape[1]
    match, mismatch = params.match, params.mismatch
    o1, e1, o2, e2 = (params.gap_open, params.gap_extend, params.gap_open2,
                      params.gap_extend2)
    nn64, ql64 = nn.long(), ql.long()
    rows_b = torch.arange(B, device=dev)
    cidx = torch.arange(W, device=dev)[None, :]          # (1, W) int64
    eff = _band_tensor(band, params, B, dev).long()
    if not params.adaptive:
        eff = torch.maximum(eff, (nn64 - ql64).abs() + 16)
    off_max = torch.clamp(ql64 + 1 - W, min=0)

    def full(shape, value):
        return torch.full(shape, value, dtype=i32, device=dev)

    g0 = -torch.minimum(o1 + e1 * cidx, o2 + e2 * cidx)
    g0 = torch.where(cidx == 0, 0, g0).expand(B, W)
    g0 = torch.where(cidx > torch.minimum(ql64, eff)[:, None], NEG, g0)
    score = full((B, n_cap + 1, W), NEG)
    score[:, 0] = g0.to(i32)
    d1m = full((B, n_cap + 1, W), NEG)
    d2m = full((B, n_cap + 1, W), NEG)
    hpack = full((B, n_cap + 1, W), 0)
    hpack[:, 0] = 1
    opack = full((B, n_cap + 1, W), 0)
    d1p = full((B, n_cap + 1, W), 0)
    d2p = full((B, n_cap + 1, W), 0)
    offs = torch.zeros((B, n_cap + 1), dtype=torch.int64, device=dev)
    bestc = torch.zeros((B, n_cap + 1), dtype=torch.int64, device=dev)
    endcol = full((B, n_cap + 1), NEG)
    endcol[:, 0] = torch.where(cidx == ql64[:, None], g0, NEG).amax(
        dim=1).to(i32)
    # query with a leading boundary slot and trailing zeros: the base
    # consumed by the diagonal at absolute column j is q_ext[j] = q[j-1]
    q_ext = torch.zeros((B, 1 + l_cap + W), dtype=torch.int64, device=dev)
    q_ext[:, 1:1 + l_cap] = qq

    def window(mat_rows, idx, ok):
        got = mat_rows.gather(1, idx.clamp(0, W - 1)).long()
        return torch.where(ok, got, NEG)

    n_hi = int(nn.max()) if B else 0
    # predecessor slots in use per rank over the batch; the -1 padding
    # behind them changes nothing (every window value would be NEG)
    slot = torch.arange(1, p_cap + 1, device=dev)
    p_used = ((preds >= 0) * slot).amax(dim=(0, 2)).tolist()
    for r in range(1, n_hi + 1):
        pr_all = preds[:, r - 1].long()                  # (B, p_cap)
        prc_all = pr_all.clamp(min=0)
        if params.adaptive:
            # band centre: one past the first-max column of the best
            # predecessor row
            bc = torch.where(pr_all >= 0, bestc.gather(1, prc_all), NEG)
            center = bc.amax(dim=1) + 1
        else:
            center = r * ql64 // torch.clamp(nn64, min=1)
        off = torch.minimum(torch.clamp(center - eff, min=0), off_max)
        offs[:, r] = off
        jabs = off[:, None] + cidx
        j0 = torch.clamp(center - eff, min=0)[:, None]
        j1 = torch.minimum(ql64, center + eff)[:, None]
        masked = (jabs < j0) | (jabs > j1)
        sub = torch.where(q_ext.gather(1, jabs) == base[:, r - 1, None],
                          match, -mismatch)

        best_diag = torch.full((B, W), NEG, dtype=torch.int64, device=dev)
        rank_diag = torch.full((B, W), -2, dtype=torch.int64, device=dev)
        d1_row, d2_row = best_diag.clone(), best_diag.clone()
        d1_ptr = torch.zeros((B, W), dtype=torch.int64, device=dev)
        d2_ptr = d1_ptr.clone()
        for p in range(p_used[r - 1]):
            pr, prc = pr_all[:, p, None], prc_all[:, p]
            rel0 = (off - 1 - offs[rows_b, prc])[:, None]
            i_d = rel0 + cidx                 # the diagonal's column j-1
            ok_d = (pr >= 0) & (i_d >= 0) & (i_d < W) & (jabs - 1 >= 0)
            i_n = i_d + 1                     # column j of the pred row
            ok_n = (pr >= 0) & (i_n >= 0) & (i_n < W)
            h_p = score[rows_b, prc]
            w_diag = window(h_p, i_d, ok_d)
            w_h = window(h_p, i_n, ok_n)
            w_d1 = window(d1m[rows_b, prc], i_n, ok_n)
            w_d2 = window(d2m[rows_b, prc], i_n, ok_n)
            better = w_diag > best_diag
            best_diag = torch.where(better, w_diag, best_diag)
            rank_diag = torch.where(better, pr, rank_diag)
            for o, e, w_d, which in ((o1, e1, w_d1, 1), (o2, e2, w_d2, 2)):
                c_open = w_h - (o + e)
                c_ext = w_d - e
                c = torch.maximum(c_open, c_ext)
                ptr = (prc[:, None] << 1) | (c_ext > c_open).long()
                if which == 1:
                    b = c > d1_row
                    d1_ptr = torch.where(b, ptr, d1_ptr)
                    d1_row = torch.where(b, c, d1_row)
                else:
                    b = c > d2_row
                    d2_ptr = torch.where(b, ptr, d2_ptr)
                    d2_row = torch.where(b, c, d2_row)
        d1_row = torch.where(masked, NEG, d1_row)
        d2_row = torch.where(masked, NEG, d2_row)

        # H pre-insertion: diag >= D1 >= D2 on ties
        row = torch.where(jabs == 0, NEG, best_diag + sub)
        rown = torch.where(jabs == 0, -2, rank_diag)
        m = d1_row > row
        row = torch.where(m, d1_row, row)
        rowo = torch.where(m, 2, 0)
        m = d2_row > row
        row = torch.where(m, d2_row, row)
        rowo = torch.where(m, 4, rowo)
        # insertions may only open from in-band cells (band-local)
        row = torch.where(masked, NEG, row)

        fin, fino, org_out = row, rowo, []
        for oo, ee, code in ((o1, e1, 1), (o2, e2, 3)):
            # prefix-max carry from the masked columns < off: their values
            # are NEG + ee*j (monotone), so the carry into the window is
            # NEG + ee*(off-1) with origin off-1 (ee > 0) / 0 (ee == 0)
            vals = row + ee * jabs
            acc_c = torch.where(off > 0, NEG + ee * (off - 1), NEG - 1)
            org_c = torch.where(off > 0, off - 1 if ee > 0
                                else torch.zeros_like(off), -1)
            acc = torch.maximum(_cummax(vals), acc_c[:, None])
            prev_acc = torch.cat([acc_c[:, None], acc[:, :-1]], dim=1)
            is_new = vals > prev_acc
            org = torch.maximum(_cummax(torch.where(is_new, jabs, -1)),
                                org_c[:, None])
            ins = acc - oo - ee * jabs
            m = ins > fin
            fin = torch.where(m, ins, fin)
            fino = torch.where(m, code, fino)
            org_out.append(torch.where(m, org, 0))
        fin = torch.where(masked, NEG, fin)

        score[:, r] = fin.to(i32)
        d1m[:, r] = d1_row.to(i32)
        d2m[:, r] = d2_row.to(i32)
        hpack[:, r] = (fino | (rowo << 3) | ((rown + 2) << 6)).to(i32)
        opack[:, r] = _wrap32(org_out[0] | (org_out[1] << 16))
        d1p[:, r] = d1_ptr.to(i32)
        d2p[:, r] = d2_ptr.to(i32)
        endcol[:, r] = torch.where(jabs == ql64[:, None], fin, NEG).amax(
            dim=1).to(i32)
        # first-max column of the stored row (all <= NEG rows pin to 0),
        # PoaGraph.align's best_col rule for the adaptive band
        row_best = fin.amax(dim=1)
        first = torch.where(fin == row_best[:, None], cidx, W).amin(dim=1)
        bestc[:, r] = torch.where(row_best <= NEG, 0, off + first)

    # rows past a problem's own node count: zero, endcol NEG
    past = torch.arange(n_cap + 1, device=dev)[None, :] > nn64[:, None]
    for mat in (hpack, opack, d1p, d2p):
        mat[past] = 0
    offs[past] = 0
    endcol[past] = NEG
    return hpack, opack, d1p, d2p, offs.to(i32), endcol


def _poa_forward_cuda(base, preds, nn, qq, ql, band, params: PoaParams,
                      W: int) -> Mats:
    lib = _build.load_kernels()
    dev = base.device
    B, n_cap = base.shape
    rows = n_cap + 1
    # no fills: the kernel writes every cell of rows 0..nn[b] of all six
    # outputs, and neither walk reads a row past nn[b]
    mats = [torch.empty((B, rows, W), dtype=torch.int32, device=dev)
            for _ in range(4)]
    offs = torch.empty((B, rows), dtype=torch.int32, device=dev)
    endcol = torch.empty((B, rows), dtype=torch.int32, device=dev)
    # H, D1, D2 state rows and the per-row first-max columns: written
    # before they are read, never returned
    state = torch.empty((3, B, rows, W), dtype=torch.int32, device=dev)
    bestc = torch.empty((B, rows), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        POA_FWD_LAUNCHES.count += 1
        rc = lib.mando_poa_fwd(
            base.data_ptr(), preds.data_ptr(), nn.data_ptr(), qq.data_ptr(),
            ql.data_ptr(), band.data_ptr(), *(m.data_ptr() for m in mats),
            offs.data_ptr(), endcol.data_ptr(), state.data_ptr(),
            bestc.data_ptr(), B, n_cap, preds.shape[2], qq.shape[1], W,
            params.match, params.mismatch, params.gap_open,
            params.gap_extend, params.gap_open2, params.gap_extend2,
            1 if params.adaptive else 0, stream)
    _build.check(rc, "mando_poa_fwd")
    return (*mats, offs, endcol)


def _check_i32(named: dict, device: torch.device) -> None:
    for name, (x, shape) in named.items():
        dtype = torch.uint8 if name == "ends" else torch.int32
        if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
                or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} tensor of "
                             f"shape {tuple(shape)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def poa_forward(base: torch.Tensor, preds: torch.Tensor, nn: torch.Tensor,
                qq: torch.Tensor, ql: torch.Tensor, params: PoaParams,
                W: int, band: Optional[torch.Tensor] = None) -> Mats:
    """Forward DP of B (graph, query) problems over rank rows.

    base (B, n_cap) node base codes by rank; preds (B, n_cap, p_cap)
    predecessor ranks + 1 (0 = virtual source row, -1 padding) in
    declared order; nn (B,) node counts; qq (B, l_cap) query codes; ql
    (B,) query lengths < 65536; band (B,) band half-widths >= 0, or None
    for params.band in every problem (params.band is read nowhere else).
    All int32, contiguous, on one device. W is the stored window width (a
    power of two >= 256, at least `_item_width` of every problem);
    params.adaptive selects the score-following band, else the static
    diagonal band.

    Returns (hpack, opack, d1p, d2p, offs, endcol), the module
    docstring's matrix contract. CPU tensors run `poa_forward_plain`,
    CUDA tensors the csrc/poa_fwd.cu kernel, on the current stream with
    no synchronisation: the ranges of nn and ql are checked here for CPU
    tensors only, and by `problems_from_numpy` on the host arrays that
    CUDA tensors are made from."""
    if base.dim() != 2 or preds.dim() != 3 or qq.dim() != 2:
        raise ValueError("base (B, n_cap), preds (B, n_cap, p_cap) and qq "
                         "(B, l_cap) expected")
    B, n_cap = base.shape
    _check_i32({"base": (base, (B, n_cap)),
                "preds": (preds, (B, n_cap, preds.shape[2])),
                "nn": (nn, (B,)), "qq": (qq, (B, qq.shape[1])),
                "ql": (ql, (B,))}, base.device)
    if W < 256 or W & (W - 1):
        raise ValueError(f"W={W}: need a power of two >= 256")
    if B == 0:
        raise ValueError("no problems")
    band = _band_tensor(band, params, B, base.device)
    _check_i32({"band": (band, (B,))}, base.device)
    if base.device.type == "cpu":
        check_problem_ranges(nn.numpy(), ql.numpy(), n_cap, qq.shape[1])
        return poa_forward_plain(base, preds, nn, qq, ql, params, W, band)
    return _poa_forward_cuda(base, preds, nn, qq, ql, band, params, W)


def clear_rows_past(mats: Mats, nn: torch.Tensor) -> Mats:
    """`mats` with the rows past nn[b], which the contract leaves open,
    set to what the plain version leaves there (0, endcol NEG): copies,
    for comparing a kernel's matrices with the plain version's whole."""
    rows = mats[0].shape[1]
    past = torch.arange(rows, device=nn.device)[None, :] > nn.long()[:, None]
    out = []
    for i, mat in enumerate(mats):
        mat = mat.clone()
        mat[past] = NEG if i == 5 else 0
        out.append(mat)
    return tuple(out)


# --------------------------------------------------------------- walk

def _cell_reader(offs: torch.Tensor):
    """cell(mat, t, j): mat (B, rows, W) at matrix row t (B,), ABSOLUTE
    column j (B,), as int64; 0 outside the row's stored window."""
    B, rows = offs.shape
    rows_b = torch.arange(B, device=offs.device)
    offs64 = offs.long()

    def cell(mat, t, j):
        W = mat.shape[2]
        tc = t.clamp(0, rows - 1)
        rel = j - offs64[rows_b, tc]
        ok = (rel >= 0) & (rel < W)
        return torch.where(ok, mat[rows_b, tc, rel.clamp(0, W - 1)].long(),
                           0)

    return cell


def _end_rank(nn: torch.Tensor, ends: torch.Tensor,
              endcol: torch.Tensor) -> torch.Tensor:
    """Matrix row a walk starts from: the first maximum of H[t, qlen] over
    real end ranks 1 <= t <= nn, 0 when there is none. (B,) int64."""
    B, rows = endcol.shape
    dev = nn.device
    t_idx = torch.arange(rows, device=dev)[None, :]
    end_mask = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                          ends.bool()], dim=1) & (t_idx <= nn.long()[:, None])
    cand = torch.where(end_mask, endcol.long(), NEG - 1)
    best = cand.amax(dim=1, keepdim=True)
    return torch.where(cand == best, t_idx, rows).amin(dim=1)


def poa_walk_plain(nn: torch.Tensor, ends: torch.Tensor, ql: torch.Tensor,
                   mats: Mats, l_cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch walk; see `poa_walk` for the contract. The reference's
    `_traceback_from_mats` state machine as batched selects, one loop
    iteration per walk step of the longest path."""
    hpack, opack, d1p, d2p, offs, endcol = mats
    dev = nn.device
    B, rows, _W = hpack.shape
    max_steps = rows - 1 + l_cap + 2
    cell = _cell_reader(offs)
    r = _end_rank(nn, ends, endcol)

    # states: 0 H (final op), 1 H0 (pre-insertion op), 2 D1, 3 D2,
    # 4 INS (emitting an insertion run down to column tgt)
    st = torch.zeros(B, dtype=torch.int64, device=dev)
    j = ql.long().clone()
    tgt = torch.zeros_like(st)
    k = torch.zeros_like(st)
    buf = torch.zeros((B, max_steps, 2), dtype=torch.int32, device=dev)
    while True:
        active = ((r > 0) | (j > 0)) & (r >= 0) & (k < max_steps)
        if not bool(active.any()):
            break
        hv = cell(hpack, r, j)
        ov = cell(opack, r, j)
        orig1v = ov & 0xFFFF
        orig2v = (ov >> 16) & 0xFFFF      # unsigned: origins reach 65535
        dptr = torch.where(st == 2, cell(d1p, r, j), cell(d2p, r, j))

        h_active = (st == 0) | (st == 1)
        d_active = (st == 2) | (st == 3)
        at_row0 = r == 0
        opv = torch.where(st == 1, (hv >> 3) & 7, hv & 7)
        node0v = (hv >> 6) - 2
        h_is_diag = ~at_row0 & (opv == 0)
        h_is_ins = ~at_row0 & ((opv == 1) | (opv == 3))
        ins_t = torch.where(opv == 1, orig1v, orig2v)
        d_pr = dptr >> 1
        d_ext = (dptr & 1) == 1

        # an H deletion transition emits nothing
        emit_diag = h_active & h_is_diag
        emit_ins = (st == 4) | (h_active & (at_row0 | h_is_ins))
        do_emit = active & (emit_diag | emit_ins | d_active)
        qi_e = torch.where(d_active, -1, j - 1)
        rk_e = torch.where(emit_diag | d_active, r - 1, -1)
        sel = do_emit.nonzero()[:, 0]
        buf[sel, k[sel]] = torch.stack([qi_e, rk_e], dim=1)[sel].to(
            torch.int32)
        k = k + do_emit.long()

        st_h = torch.where(
            at_row0 | h_is_diag, 0,
            torch.where(h_is_ins, torch.where(j - 1 > ins_t, 4, 1),
                        torch.where(opv == 2, 2, 3)))
        r_h = torch.where(h_is_diag, node0v, r)
        j_h = torch.where(at_row0 | h_is_diag | h_is_ins, j - 1, j)
        tgt_h = torch.where(h_is_ins, ins_t, tgt)
        st_i = torch.where(j - 1 > tgt, 4, 1)
        st_n = torch.where(h_active, st_h,
                           torch.where(d_active,
                                       torch.where(d_ext, st, 0), st_i))
        r_n = torch.where(h_active, r_h, torch.where(d_active, d_pr, r))
        j_n = torch.where(h_active, j_h, torch.where(d_active, j, j - 1))
        tgt_n = torch.where(h_active, tgt_h, tgt)
        st = torch.where(active, st_n, st)
        r = torch.where(active, r_n, r)
        j = torch.where(active, j_n, j)
        tgt = torch.where(active, tgt_n, tgt)
    return buf, k.to(torch.int32)


def _check_walk_args(nn, ends, ql, mats: Mats) -> None:
    hpack, opack, d1p, d2p, offs, endcol = mats
    if hpack.dim() != 3:
        raise ValueError("hpack (B, n_cap + 1, W) expected")
    B, rows, W = hpack.shape
    _check_i32({"nn": (nn, (B,)), "ends": (ends, (B, rows - 1)),
                "ql": (ql, (B,)), "hpack": (hpack, (B, rows, W)),
                "opack": (opack, (B, rows, W)), "d1p": (d1p, (B, rows, W)),
                "d2p": (d2p, (B, rows, W)), "offs": (offs, (B, rows)),
                "endcol": (endcol, (B, rows))}, nn.device)


def _poa_walk_cuda(nn, ends, ql, mats: Mats, l_cap: int):
    lib = _build.load_kernels()
    hpack, opack, d1p, d2p, offs, endcol = mats
    dev = nn.device
    B, rows, W = hpack.shape
    max_steps = rows - 1 + l_cap + 2
    # entries at and beyond ks[b] are never written
    buf = torch.empty((B, max_steps, 2), dtype=torch.int32, device=dev)
    ks = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        POA_WALK_LAUNCHES.count += 1
        rc = lib.mando_poa_walk(
            nn.data_ptr(), ends.data_ptr(), ql.data_ptr(), hpack.data_ptr(),
            opack.data_ptr(), d1p.data_ptr(), d2p.data_ptr(),
            offs.data_ptr(), endcol.data_ptr(), buf.data_ptr(),
            ks.data_ptr(), B, rows - 1, W, max_steps, stream)
    _build.check(rc, "mando_poa_walk")
    return buf, ks


def poa_walk(nn: torch.Tensor, ends: torch.Tensor, ql: torch.Tensor,
             mats: Mats, l_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Traceback walk over `poa_forward`'s matrices for B problems.

    nn (B,) int32 node counts, ends (B, n_cap) uint8 end-node flags by
    rank, ql (B,) int32 query lengths, mats as `poa_forward` returns
    them. Starts at the first maximum of endcol over end ranks <= nn and
    follows the packed pointers to row 0, column 0.

    Returns buf (B, n_cap + l_cap + 2, 2) int32 and ks (B,) int32:
    buf[b, :ks[b]] are the path's (qi, rank) steps in REVERSE order
    (qi == -1: node deleted; rank == -1: query base inserted); entries
    at and beyond ks[b] are unspecified. CPU tensors run
    `poa_walk_plain`, CUDA tensors the csrc/poa_walk.cu kernel, on the
    current stream with no synchronisation."""
    _check_walk_args(nn, ends, ql, mats)
    if l_cap < 0:
        raise ValueError(f"l_cap={l_cap}")
    if nn.device.type == "cpu":
        return poa_walk_plain(nn, ends, ql, mats, l_cap)
    return _poa_walk_cuda(nn, ends, ql, mats, l_cap)


# -------------------------------------------------------------- sweep

def sweep_record_cap(n_cap: int) -> int:
    """Records a problem's walk can emit at most (two a matrix row), with
    the reference's slack: the second dimension of `poa_sweep`'s recs."""
    return 2 * n_cap + 8


def chunk_walk(walk: str, n_cap: int) -> str:
    """The walk a chunk of row cap n_cap takes when the caller asked for
    `walk`: the sweep serves only n_cap + 2 < SWEEP_RANK_LIMIT; a chunk
    over that takes the step walk."""
    if walk not in WALKS:
        raise ValueError(f"unknown walk {walk!r}: one of {WALKS}")
    return ("sweep" if walk == "sweep" and n_cap + 2 < SWEEP_RANK_LIMIT
            else "steps")


def poa_sweep_plain(nn: torch.Tensor, ends: torch.Tensor, ql: torch.Tensor,
                    mats: Mats) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch record walk; see `poa_sweep` for the contract. The
    transition table of the reference's `_poa_walk_kernel` as batched
    selects, one loop iteration per transition of the longest path: every
    walker follows its own path, so no row is visited that no walker is
    in."""
    hpack, opack, d1p, d2p, offs, endcol = mats
    dev = nn.device
    B, rows, _W = hpack.shape
    maxrec = sweep_record_cap(rows - 1)
    cell = _cell_reader(offs)

    # states: 0 H (final op), 1 H0 (pre-insertion op), 2 D1, 3 D2; an
    # insertion run is one record, so there is no INS state
    r = _end_rank(nn, ends, endcol)
    j = ql.long().clone()
    st = torch.zeros(B, dtype=torch.int64, device=dev)
    k = torch.zeros_like(st)
    done = ((r <= 0) & (j <= 0)) | (r < 0)
    recs = torch.zeros((B, maxrec, 2), dtype=torch.int32, device=dev)
    # a walker leaves its row within three transitions (insertion run ->
    # H0 -> deletion entry -> deletion), which bounds the loop on any input
    for _ in range(3 * rows):
        active = ~done & (k < maxrec)
        if not bool(active.any()):
            break
        hv = cell(hpack, r, j)
        ov = cell(opack, r, j)
        orig1v = ov & 0xFFFF
        orig2v = (ov >> 16) & 0xFFFF      # unsigned: origins reach 65535
        dptr = torch.where(st == 2, cell(d1p, r, j), cell(d2p, r, j))

        h_active = st <= 1
        at_row0 = r == 0
        opv = torch.where(st == 1, (hv >> 3) & 7, hv & 7)
        node0v = (hv >> 6) - 2
        h_is_diag = ~at_row0 & (opv == 0)
        h_is_ins = ~at_row0 & ((opv == 1) | (opv == 3))
        d_pr = dptr >> 1
        d_ext = (dptr & 1) == 1

        # one record per transition; an H deletion entry emits nothing.
        # An insertion run goes from column j - 1 down to its origin (the
        # boundary row's run to column 0) and j jumps to the run's end
        run_lo = torch.where(at_row0, 0, torch.where(opv == 1, orig1v,
                                                     orig2v))
        emit_diag = h_active & h_is_diag
        emit_del = ~h_active
        emit_ins = h_active & (at_row0 | h_is_ins) & (j >= 1)
        do_emit = active & (emit_diag | emit_del | emit_ins)
        rtype = torch.where(emit_del, REC_DEL,
                            torch.where(emit_diag, REC_DIAG, REC_INS))
        rec0 = torch.where(emit_ins | emit_diag, j - 1, 0) | (rtype << 16)
        rec1 = torch.where(emit_ins, run_lo, 0) \
            | ((torch.where(emit_ins, -1, r - 1) + 2) << 16)
        sel = do_emit.nonzero()[:, 0]
        recs[sel, k[sel]] = _wrap32(torch.stack([rec0, rec1], dim=1)[sel])
        k = k + do_emit.long()

        st_h = torch.where(
            at_row0 | h_is_diag, 0,
            torch.where(h_is_ins, 1, torch.where(opv == 2, 2, 3)))
        r_h = torch.where(h_is_diag, node0v, r)
        j_h = torch.where(at_row0, 0,
                          torch.where(h_is_diag, j - 1,
                                      torch.where(h_is_ins, run_lo, j)))
        st_n = torch.where(h_active, st_h, torch.where(d_ext, st, 0))
        r_n = torch.where(h_active, r_h, d_pr)
        j_n = torch.where(h_active, j_h, j)
        st = torch.where(active, st_n, st)
        r = torch.where(active, r_n, r)
        j = torch.where(active, j_n, j)
        done = done | (active & (((r <= 0) & (j <= 0)) | (r < 0)))
    return recs, k.to(torch.int32)


def _poa_sweep_cuda(nn, ends, ql, mats: Mats):
    lib = _build.load_kernels()
    hpack, opack, d1p, d2p, offs, endcol = mats
    dev = nn.device
    B, rows, W = hpack.shape
    maxrec = sweep_record_cap(rows - 1)
    # entries at and beyond counts[b] are never written; every count is
    recs = torch.empty((B, maxrec, 2), dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        POA_SWEEP_LAUNCHES.count += 1
        rc = lib.mando_poa_sweep(
            nn.data_ptr(), ends.data_ptr(), ql.data_ptr(), hpack.data_ptr(),
            opack.data_ptr(), d1p.data_ptr(), d2p.data_ptr(),
            offs.data_ptr(), endcol.data_ptr(), recs.data_ptr(),
            counts.data_ptr(), B, rows - 1, W, maxrec, stream)
    _build.check(rc, "mando_poa_sweep")
    return recs, counts


def poa_sweep(nn: torch.Tensor, ends: torch.Tensor, ql: torch.Tensor,
              mats: Mats) -> Tuple[torch.Tensor, torch.Tensor]:
    """Traceback walk over `poa_forward`'s matrices for B problems, as
    run-compressed records: the same paths as `poa_walk`, one record per
    diagonal step, deleted node or whole insertion run.

    Arguments as `poa_walk`'s; n_cap + 2 must stay below
    SWEEP_RANK_LIMIT (`chunk_walk`). Returns recs (B, 2 * n_cap + 8, 2)
    int32 and counts (B,) int32: recs[b, :counts[b]] are problem b's
    (rec0, rec1) pairs
    from the path's end to its start, packed as REC_DIAG / REC_DEL /
    REC_INS above, the stream `NativePoaGraph.apply_runs` and
    `expand_walk_records` take. Entries at and beyond counts[b] are
    unspecified. CPU tensors run `poa_sweep_plain`, CUDA tensors the
    csrc/poa_sweep.cu kernel, on the current stream with no
    synchronisation."""
    _check_walk_args(nn, ends, ql, mats)
    n_cap = mats[0].shape[1] - 1
    if chunk_walk("sweep", n_cap) != "sweep":
        raise ValueError(f"n_cap={n_cap}: a record's rank field holds "
                         f"n_cap + 2 < {SWEEP_RANK_LIMIT} only")
    if nn.device.type == "cpu":
        return poa_sweep_plain(nn, ends, ql, mats)
    return _poa_sweep_cuda(nn, ends, ql, mats)


def expand_walk_records(recs: np.ndarray, k: int) -> np.ndarray:
    """One problem's records (recs[:k], emission order) as `poa_walk`'s
    buf contract: (steps, 2) int32 (qi, rank) steps in REVERSE order. What
    the C consumer does inside `apply_runs`, for checks."""
    rec0 = np.asarray(recs[:k, 0], np.int64)
    rec1 = np.asarray(recs[:k, 1], np.int64)
    rtype = (rec0 >> 16) & 3
    qi_hi, qi_lo = rec0 & 0xFFFF, rec1 & 0xFFFF
    rank = (rec1 >> 16) - 2
    is_run = rtype == REC_INS
    n = np.where(is_run, np.maximum(qi_hi - qi_lo + 1, 0), 1)
    src = np.repeat(np.arange(k), n)
    within = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    qi = np.where(is_run[src], qi_hi[src] - within,
                  np.where(rtype[src] == REC_DIAG, qi_hi[src], -1))
    rk = np.where(is_run[src], -1, rank[src])
    return np.stack([qi, rk], axis=1).astype(np.int32).reshape(-1, 2)


# ----------------------------------------------------------- dispatch

def dispatch_chunk(base: np.ndarray, preds: np.ndarray, nn: np.ndarray,
                   ends: np.ndarray, qq: np.ndarray, ql: np.ndarray,
                   band: np.ndarray, W: int, l_cap: int, params: PoaParams,
                   device: torch.device,
                   observer: Optional[RunObserver] = None,
                   walk: str = "steps") -> Tuple[np.ndarray, np.ndarray]:
    """The device part of one chunk: packed rank-space numpy arrays in,
    host arrays out: (buf, ks) reverse-order steps with walk="steps",
    (recs, counts) run-compressed records with walk="sweep" (the caller
    picks per chunk with `chunk_walk`). Forward and walk run back to back
    on one stream; fetching the walk's two outputs is the chunk's one
    synchronisation.

    Under a pipeline mesh the chunk's problems shard in contiguous blocks
    over the mesh (padding problems all zero: nn = 0, ql = 0, band 0),
    each of this process's shards runs forward and walk on its own
    device, and the walks' outputs gather back in shard order; `device`
    is not used then."""
    if walk not in WALKS:
        raise ValueError(f"unknown walk {walk!r}: one of {WALKS}")
    arrays = (base, preds, nn, ends, qq, ql, band)
    mesh = pipeline_mesh()
    if mesh is None:
        rows, counts = _forward_and_walk(arrays, W, l_cap, params, device,
                                         observer, walk)
        return rows.cpu().numpy(), counts.cpu().numpy()
    B = len(nn)
    _padded, slices = mesh.shard_slices(B)
    rows, counts = fetch_global(mesh, [
        _forward_and_walk([pad_rows(a, lo, hi) for a in arrays], W, l_cap,
                          params, dev, observer, walk)
        for dev, lo, hi in slices])
    return rows[:B], counts[:B]


def _forward_and_walk(arrays, W: int, l_cap: int, params: PoaParams,
                      device: torch.device, observer: Optional[RunObserver],
                      walk: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and walk of one chunk's problems on `device`, on the
    current stream; the walk's two outputs stay there."""
    t_base, t_preds, t_nn, t_ends, t_qq, t_ql, t_band = problems_from_numpy(
        *arrays, device)
    timed = observer is not None and observer.time_kernels \
        and device.type == "cuda"
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
        if timed else None
    if timed:
        marks[0].record()
    mats = poa_forward(t_base, t_preds, t_nn, t_qq, t_ql, params, W, t_band)
    if timed:
        marks[1].record()
    if walk == "sweep":
        rows, counts = poa_sweep(t_nn, t_ends, t_ql, mats)
    else:
        rows, counts = poa_walk(t_nn, t_ends, t_ql, mats, l_cap)
    if timed:
        marks[2].record()
        observer.events["poa_fwd"].append((marks[0], marks[1]))
        observer.events["poa_sweep" if walk == "sweep" else "poa_walk"
                        ].append((marks[1], marks[2]))
    return rows, counts


def _chunk_items(n_cap: int, W: int) -> int:
    return max(1, CHUNK_BYTES // (BYTES_PER_CELL * (n_cap + 1) * W))


def _check_query_lengths(queries) -> int:
    longest = max(len(q) for q in queries)
    if longest >= 1 << 16:
        # the packed traceback matrices hold insertion origins in 16-bit
        # halves; the host C++ engine has no such limit
        raise ValueError("device POA path: query >= 65536 bases "
                         "unsupported (use the host engine)")
    return longest


def align_graph_batch(graphs: Sequence[PoaGraph],
                      queries: Sequence[np.ndarray],
                      params: Optional[PoaParams] = None, device="cuda"
                      ) -> List[List[Tuple[int, Optional[int]]]]:
    """Align query[i] to the Python-held graph[i] for every i in one
    (chunked) device dispatch a width class, at band params.band; returns
    alignment paths for PoaGraph.apply_path."""
    params = params or PoaParams()
    device = resolve_device(device)
    if len(graphs) != len(queries):
        raise ValueError("one query per graph expected")
    return _align_graphs(graphs, queries, params, device,
                         [params.band] * len(graphs), None, 0)


def _align_graphs(graphs, queries, params, device, bands, obs, k):
    """align_graph_batch's body with a band half-width a problem
    (`bands`); `obs` (a RunObserver or None) records its chunks as round
    k's. `poa_consensus_batch` runs its rounds through it under
    MANDO_TPU_NO_NATIVE."""
    if not graphs:
        return []
    orders = [g.topo_order() for g in graphs]
    n_cap = _rank_cap(max(len(o) for o in orders))
    l_cap = _pow2_at_least(_check_query_lengths(queries))
    p_max = max(1, max((len(g.preds[v]) for g in graphs
                        for v in range(len(g.base))), default=1))
    p_cap = _pow2_at_least(p_max, floor=4)
    by_width: dict = {}
    for i, (order, q) in enumerate(zip(orders, queries)):
        w = _item_width(len(order), len(q), bands[i], l_cap,
                        params.adaptive)
        by_width.setdefault(w, []).append(i)
    paths: List[Optional[List[Tuple[int, Optional[int]]]]] = (
        [None] * len(graphs))
    for W in sorted(by_width):
        idxs = by_width[W]
        chunk = _chunk_items(n_cap, W)
        for c0 in range(0, len(idxs), chunk):
            _run_graph_chunk(idxs[c0:c0 + chunk], graphs, queries, orders,
                             n_cap, l_cap, p_cap, W, params, bands, paths,
                             device, obs, k)
    return paths  # type: ignore[return-value]


def _run_graph_chunk(batch, graphs, queries, orders, n_cap, l_cap, p_cap,
                     W, params, bands, paths, device, obs, k) -> None:
    """Dispatch one chunk of (graph, query) problems; write each problem's
    alignment path into paths[original_index]."""
    B = len(batch)
    with span("poa.fill") as fill:
        base = np.zeros((B, n_cap), np.int32)
        preds = np.full((B, n_cap, p_cap), -1, np.int32)
        ends = np.zeros((B, n_cap), bool)
        nn = np.zeros(B, np.int32)
        qq = np.zeros((B, l_cap), np.int32)
        ql = np.zeros(B, np.int32)
        for bi, gi in enumerate(batch):
            b, p, e, _ = graph_arrays(graphs[gi], n_cap, p_cap, orders[gi])
            base[bi], preds[bi], ends[bi] = b, p, e
            nn[bi] = len(orders[gi])
            q = queries[gi]
            qq[bi, :len(q)] = q
            ql[bi] = len(q)
        band = np.array([bands[gi] for gi in batch], np.int32)
    if obs is not None:
        obs.fill_s += fill.seconds
        obs.chunk(k, (base, preds, nn, ends, qq, ql, band), W, l_cap, params)
    with span("poa.dispatch", B):
        buf, ks = dispatch_chunk(base, preds, nn, ends, qq, ql, band, W,
                                 l_cap, params, device, obs)
        for bi, gi in enumerate(batch):
            order = orders[gi]
            steps = buf[bi, :ks[bi]][::-1]
            paths[gi] = [(int(qi), order[rank] if rank >= 0 else None)
                         for qi, rank in steps]


class NativePoaGraph:
    """A POA graph held in C++ between device rounds (native/poa.cpp
    GraphHandle): the consensus path's host staging (topo order,
    rank-space arrays, applying the traceback, the consensus walk) runs
    natively instead of through PoaGraph's Python adjacency loops. Same
    graph semantics as PoaGraph and the native consensus engine."""

    def __init__(self, seq_codes: np.ndarray):
        self._lib = require_native("NativePoaGraph")
        seq = np.ascontiguousarray(seq_codes, np.uint8)
        self._h = self._lib.poa_graph_new_c(seq.ctypes.data, len(seq))

    def close(self) -> None:
        if getattr(self, "_h", None):
            try:
                self._lib.poa_graph_free_c(self._h)
            except Exception:
                pass  # interpreter teardown may unload the lib first
            self._h = None

    __del__ = close

    def n_nodes(self) -> int:
        return int(self._lib.poa_graph_nodes_c(self._h))

    def max_preds(self) -> int:
        return int(self._lib.poa_graph_maxp_c(self._h))

    def fill_arrays(self, base_row: np.ndarray, preds_row: np.ndarray,
                    ends_row: np.ndarray) -> int:
        """Write this graph's rank-space arrays into the given batch-row
        slices (preds pre-filled -1); caches the topo order for
        apply_steps. Returns the node count."""
        n = self._lib.poa_graph_arrays_c(
            self._h, base_row.shape[0], preds_row.shape[1],
            base_row.ctypes.data, preds_row.ctypes.data,
            ends_row.ctypes.data)
        if n < 0:
            raise ValueError("poa_graph_arrays_c: caps too small")
        return int(n)

    def apply_steps(self, q: np.ndarray, buf_rows: np.ndarray,
                    k: int) -> None:
        """Thread query q along the device walk's reverse-order (qi,
        rank) steps (ranks resolve via the last fill_arrays order)."""
        qa = np.ascontiguousarray(q, np.uint8)
        b = np.ascontiguousarray(buf_rows[:k], np.int32)
        self._lib.poa_graph_apply_c(self._h, qa.ctypes.data,
                                    b.ctypes.data, int(k))

    def apply_runs(self, q: np.ndarray, recs: np.ndarray, k: int) -> None:
        """Thread query q along `poa_sweep`'s run-compressed records
        (recs[:k] of one problem, emission order), which C expands to the
        step walk's exact step sequence."""
        qa = np.ascontiguousarray(q, np.uint8)
        r = np.ascontiguousarray(recs[:k], np.int32)
        self._lib.poa_graph_apply_runs_c(self._h, qa.ctypes.data,
                                         r.ctypes.data, int(k))

    def consensus(self) -> np.ndarray:
        out = np.empty(self.n_nodes() + 1, np.uint8)
        n = self._lib.poa_graph_consensus_handle_c(self._h,
                                                   out.ctypes.data)
        return out[:n].copy()


def poa_consensus_batch(seq_sets: Sequence[List[np.ndarray]],
                        params: Optional[PoaParams] = None, device="cuda",
                        walk: str = "steps",
                        bands: Optional[Sequence[int]] = None
                        ) -> List[np.ndarray]:
    """Graph-POA consensus of many isoforms at once: reads are threaded in
    lockstep rounds: round k aligns the k-th read of every still-growing
    graph in batched device dispatches on `device` (the per-locus isoform
    axis, mirroring the reference's one-abpoa-process-per-isoform at
    SDC.py:915-919). Graphs live in C++ between rounds (NativePoaGraph),
    so the per-round staging never touches Python adjacency lists and the
    walk's steps go straight to C. With walk="sweep" every chunk that
    `chunk_walk` lets through leaves the device as run-compressed records
    (`poa_sweep`, `apply_runs`); the consensi are the same either way.

    `bands` gives each sequence set its own band half-width (default:
    params.band for all). The band is a per-problem input of the forward,
    so sets of different bands share a round's dispatch: a round is one
    chunk a width class (more only past CHUNK_BYTES), and each set's
    consensus is what a call with that band alone gives.

    A `RunObserver` installed as `OBSERVER` sees the call's rounds,
    chunks and timings; without one nothing is recorded.

    Under MANDO_TPU_NO_NATIVE the graphs are Python `PoaGraph`s and a
    round is one `_align_graphs` call (`align_graph_batch`'s body with
    each set's band) and `apply_path` a set (the
    reference's rounds without its library): the same consensi, by the
    step walk whatever `walk` asks."""
    params = params or PoaParams()
    device = resolve_device(device)
    if bands is None:
        bands = [params.band] * len(seq_sets)
    if len(bands) != len(seq_sets):
        raise ValueError("one band per sequence set expected")
    obs = OBSERVER
    if load_native() is None:
        return _poa_rounds_python(seq_sets, params, device, bands, obs)
    graphs = [NativePoaGraph(s[0]) for s in seq_sets]
    max_reads = max((len(s) for s in seq_sets), default=0)
    for k in range(1, max_reads):
        live = [i for i, s in enumerate(seq_sets) if k < len(s)]
        if not live:
            break
        if obs is not None:
            obs.rounds += 1
        queries = [seq_sets[i][k] for i in live]
        nodes = [graphs[i].n_nodes() for i in live]
        n_cap = _rank_cap(max(nodes))
        round_walk = chunk_walk(walk, n_cap)
        l_cap = _pow2_at_least(_check_query_lengths(queries))
        p_cap = _pow2_at_least(
            max(graphs[i].max_preds() for i in live), floor=4)
        by_width: dict = {}
        for pos in range(len(live)):
            w = _item_width(nodes[pos], len(queries[pos]), bands[live[pos]],
                            l_cap, params.adaptive)
            by_width.setdefault(w, []).append(pos)
        for W in sorted(by_width):
            idxs = by_width[W]
            chunk = _chunk_items(n_cap, W)
            for c0 in range(0, len(idxs), chunk):
                batch = idxs[c0:c0 + chunk]
                B = len(batch)
                with span("poa.fill") as fill:
                    base = np.zeros((B, n_cap), np.int32)
                    preds = np.full((B, n_cap, p_cap), -1, np.int32)
                    ends = np.zeros((B, n_cap), np.uint8)
                    nn = np.zeros(B, np.int32)
                    qq = np.zeros((B, l_cap), np.int32)
                    ql = np.zeros(B, np.int32)
                    band = np.array([bands[live[pos]] for pos in batch],
                                    np.int32)
                    for bi, pos in enumerate(batch):
                        g = graphs[live[pos]]
                        nn[bi] = g.fill_arrays(base[bi], preds[bi], ends[bi])
                        q = queries[pos]
                        qq[bi, :len(q)] = q
                        ql[bi] = len(q)
                if obs is not None:
                    obs.fill_s += fill.seconds
                    obs.chunk(k, (base, preds, nn, ends, qq, ql, band), W,
                              l_cap, params)
                with span("poa.dispatch", B):
                    rows, counts = dispatch_chunk(
                        base, preds, nn, ends, qq, ql, band, W, l_cap,
                        params, device, obs, round_walk)
                with span("poa.apply") as applied:
                    for bi, pos in enumerate(batch):
                        g = graphs[live[pos]]
                        apply = (g.apply_runs if round_walk == "sweep"
                                 else g.apply_steps)
                        apply(queries[pos], rows[bi], int(counts[bi]))
                if obs is not None:
                    obs.apply_s += applied.seconds
    out = [g.consensus() for g in graphs]
    for g in graphs:
        g.close()
    return out


def _poa_rounds_python(seq_sets, params, device, bands, obs
                       ) -> List[np.ndarray]:
    """poa_consensus_batch's rounds on Python-held PoaGraphs."""
    graphs = [PoaGraph(s[0]) for s in seq_sets]
    max_reads = max((len(s) for s in seq_sets), default=0)
    for k in range(1, max_reads):
        live = [i for i, s in enumerate(seq_sets) if k < len(s)]
        if not live:
            break
        if obs is not None:
            obs.rounds += 1
        paths = _align_graphs([graphs[i] for i in live],
                              [seq_sets[i][k] for i in live], params, device,
                              [bands[i] for i in live], obs, k)
        with span("poa.apply") as applied:
            for i, path in zip(live, paths):
                graphs[i].apply_path(seq_sets[i][k], path)
        if obs is not None:
            obs.apply_s += applied.seconds
    return [g.consensus() for g in graphs]
