"""Batched sequence-to-graph POA DP and its traceback walk, on PyTorch.

Counterpart of mandalorion_tpu/poa/kernels.py and poa/pallas_kernel.py
for module D's device route. The graph lives on the host (in C++,
`NativePoaGraph`) as columnar padded arrays in topological-rank space;
the O(nodes x query) DP of a batch of (graph, query) problems runs on the
device and only the alignment paths come back. One round loop
(`_rounds`) runs each chunk of problems as

    holder.stage -> forward (poa_forward) -> walk (poa_walk) -> holder.apply

on native graphs (`_NativeGraphs`: one C call a chunk each way,
`stage_graphs` and `apply_graphs`) or, under MANDO_TPU_NO_NATIVE, on
Python `PoaGraph`s as in the reference without its library
(`_PythonGraphs`: `graph_arrays`, `apply_path`). With walk="sweep"
(counterpart of poa/pallas_kernel.py's reverse-sweep walk) the walk is
`poa_sweep`: the path leaves the device run-compressed, one record per
diagonal step, deleted node or whole insertion run, and the holder's
apply expands it.

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
from mandalorion_tpu_torch.pipeline.observe import record, span
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
# csrc/poa_fwd.cu's kWarps: the warps of a forward launch's block, which
# holds one problem (counted as `poa.fwd.warps`)
FWD_WARPS = 4
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
    seconds in the graph holder's staging and applying calls, the
    `poa.fill` and `poa.apply` spans' (native and Python graphs, step and
    record walks alike), always; with `time_kernels` a CUDA event pair
    around every kernel launch (read after a synchronise by `kernel_ms`,
    the walk under the key of the kernel that ran); copies of the numpy
    arrays of the chunks of `keep_rounds` as `kept` = [(round, W, l_cap,
    arrays)]; with `keep_largest` the chunk
    of most DP cells as `largest` = (arrays, W, l_cap, params), so that a
    check can replay real chunks. The arrays `chunk` is handed may be
    views of buffers that the next chunk reuses: what it keeps, it
    copies."""

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
            self.kept.append((k, W, l_cap, tuple(map(np.array, arrays))))
        if self.keep_largest and (
                self.largest is None
                or base.size * W > self.largest[0][0].size * self.largest[1]):
            self.largest = (tuple(map(np.array, arrays)), W, l_cap, params)

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


def _check_problems(base, nn, qq, ql, band) -> None:
    check_problem_ranges(np.asarray(nn), np.asarray(ql), base.shape[1],
                         qq.shape[1])
    if len(band) != len(nn) or (len(band) and np.min(band) < 0):
        raise ValueError("one band half-width >= 0 a problem expected")


def problems_from_numpy(base: np.ndarray, preds: np.ndarray, nn: np.ndarray,
                        ends: np.ndarray, qq: np.ndarray, ql: np.ndarray,
                        band: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """The rank-space numpy arrays of a chunk (base (B, n_cap), preds
    (B, n_cap, p_cap), nn (B,), ends (B, n_cap), qq (B, l_cap), ql (B,),
    band (B,) band half-widths) as the device functions' tensors: int32,
    contiguous, on `device` (ends as uint8), after
    `check_problem_ranges`."""
    _check_problems(base, nn, qq, ql, band)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return (put(base, np.int32), put(preds, np.int32), put(nn, np.int32),
            put(ends, np.uint8), put(qq, np.int32), put(ql, np.int32),
            put(band, np.int32))


# a section of ChunkStaging's packed inputs starts every 64 int32 words
# (256 bytes)
_SECTION_WORDS = 64


def _words(n: int) -> int:
    return -(-n // _SECTION_WORDS) * _SECTION_WORDS


class ChunkStaging:
    """The host buffers that one `poa_consensus_batch` call stages its
    chunks in, reused from chunk to chunk and freed with the call.

    `chunk` hands out a chunk's input arrays (problems_from_numpy's
    base, preds, nn, ends, qq, ql, band) as numpy views of one int32
    buffer, a section each. On a CUDA device the buffer is pinned,
    `upload` copies its live part into a device buffer, likewise reused,
    by one asynchronous copy, and `fetch` brings the walk's two outputs
    back into a second pinned buffer with the chunk's one
    synchronisation. On the CPU the device functions read the host buffer
    itself and `fetch` hands their outputs on.

    A buffer grows only when a chunk needs more than it holds, to half as
    much again at least; `grows` counts the times. Nothing is cleared
    between chunks: the staging call writes each problem's rows 0..nn-1
    and query columns 0..ql-1, and neither the kernels nor the plain
    versions read past them, so what an earlier chunk left there is never
    read."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.grows = 0
        self.host_in: Optional[torch.Tensor] = None
        self.host_out: Optional[torch.Tensor] = None
        self.dev_in: Optional[torch.Tensor] = None
        self._layout: list = []

    def _reserve(self, buf: Optional[torch.Tensor], words: int,
                 device=None) -> torch.Tensor:
        if buf is not None and buf.numel() >= words:
            return buf
        self.grows += 1
        if buf is not None:
            words = max(words, buf.numel() * 3 // 2)
        return torch.empty(words, dtype=torch.int32, device=device,
                           pin_memory=self.pinned and device is None)

    @staticmethod
    def _sections(flat, layout, as_bytes):
        out = []
        for i, (at, words, shape) in enumerate(layout):
            sec = flat[at:at + words]
            if i == 3:  # ends, one byte a node
                sec = as_bytes(sec)[:int(np.prod(shape))]
            out.append(sec.reshape(shape))
        return tuple(out)

    def chunk(self, B: int, n_cap: int, p_cap: int, l_cap: int
              ) -> Tuple[np.ndarray, ...]:
        """Views of the host buffer as a chunk of B problems' arrays:
        base (B, n_cap), preds (B, n_cap, p_cap), nn (B,), ends (B, n_cap)
        uint8, qq (B, l_cap), ql (B,), band (B,), the rest int32; they
        hold whatever was there before."""
        shapes = ((B, n_cap), (B, n_cap, p_cap), (B,), (B, n_cap),
                  (B, l_cap), (B,), (B,))
        self._layout, at = [], 0
        for i, shape in enumerate(shapes):
            words = int(np.prod(shape))
            if i == 3:
                words = -(-words // 4)
            self._layout.append((at, words, shape))
            at += _words(words)
        self.host_in = self._reserve(self.host_in, at)
        return self._sections(self.host_in.numpy(), self._layout,
                              lambda a: a.view(np.uint8))

    def upload(self) -> Tuple[torch.Tensor, ...]:
        """The last `chunk`'s arrays as the device functions' tensors."""
        flat = self.host_in
        if self.pinned:
            at, words, _shape = self._layout[-1]
            live = at + words
            self.dev_in = self._reserve(self.dev_in, live, self.device)
            flat = self.dev_in[:live]
            flat.copy_(self.host_in[:live], non_blocking=True)
        return self._sections(flat, self._layout,
                              lambda t: t.view(torch.uint8))

    def fetch(self, rows: torch.Tensor, counts: torch.Tensor
              ) -> Tuple[np.ndarray, np.ndarray]:
        """The walk's two outputs as host numpy arrays."""
        if not self.pinned:
            return rows.numpy(), counts.numpy()
        n = rows.numel()
        self.host_out = self._reserve(self.host_out,
                                      _words(n) + counts.numel())
        host_rows = self.host_out[:n].view(rows.shape)
        host_counts = self.host_out[_words(n):_words(n) + counts.numel()]
        host_rows.copy_(rows, non_blocking=True)
        host_counts.copy_(counts, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return host_rows.numpy(), host_counts.numpy()


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
    # rows past a problem's node count hold whatever its caller's buffer
    # held there: they are read as padding
    preds = torch.where(
        (torch.arange(n_cap, device=dev)[None, :] < nn64[:, None])[..., None],
        preds, -1)
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
    record("poa.fwd.warps", items=FWD_WARPS)
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
    REC_INS above, the stream `apply_graphs` (walk="sweep") and
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
    buf contract: (steps, 2) int32 (qi, rank) steps in REVERSE order: what
    `apply_graphs` does in C with walk="sweep", and what the Python
    graphs apply."""
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
                   walk: str = "steps",
                   staging: Optional[ChunkStaging] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The device part of one chunk: packed rank-space numpy arrays in,
    host arrays out: (buf, ks) reverse-order steps with walk="steps",
    (recs, counts) run-compressed records with walk="sweep" (the caller
    picks per chunk with `chunk_walk`). Forward and walk run back to back
    on one stream; fetching the walk's two outputs is the chunk's one
    synchronisation. With `staging`, the ChunkStaging whose last `chunk`
    the arrays are, the upload and the outputs go through its buffers.

    Under a pipeline mesh the chunk's problems shard in contiguous blocks
    over the mesh (padding problems all zero: nn = 0, ql = 0, band 0),
    each of this process's shards runs forward and walk on its own
    device, and the walks' outputs gather back in shard order; `device`
    and `staging` are not used then."""
    if walk not in WALKS:
        raise ValueError(f"unknown walk {walk!r}: one of {WALKS}")
    arrays = (base, preds, nn, ends, qq, ql, band)
    mesh = pipeline_mesh()
    if mesh is None:
        if staging is None:
            tensors = problems_from_numpy(*arrays, device)
        else:
            _check_problems(base, nn, qq, ql, band)
            tensors = staging.upload()
        rows, counts = _forward_and_walk(tensors, W, l_cap, params, device,
                                         observer, walk)
        if staging is None:
            return rows.cpu().numpy(), counts.cpu().numpy()
        return staging.fetch(rows, counts)
    B = len(nn)
    _padded, slices = mesh.shard_slices(B)
    rows, counts = fetch_global(mesh, [
        _forward_and_walk(problems_from_numpy(
            *[pad_rows(a, lo, hi) for a in arrays], dev), W, l_cap, params,
            dev, observer, walk)
        for dev, lo, hi in slices])
    return rows[:B], counts[:B]


def _forward_and_walk(tensors, W: int, l_cap: int, params: PoaParams,
                      device: torch.device, observer: Optional[RunObserver],
                      walk: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and walk of one chunk's problems (problems_from_numpy's
    tensors) on `device`, on the current stream; the walk's two outputs
    stay there."""
    t_base, t_preds, t_nn, t_ends, t_qq, t_ql, t_band = tensors
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

    def consensus(self) -> np.ndarray:
        out = np.empty(self.n_nodes() + 1, np.uint8)
        n = self._lib.poa_graph_consensus_handle_c(self._h,
                                                   out.ctypes.data)
        return out[:n].copy()


def _c_array(a: np.ndarray, dtype) -> np.ndarray:
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"a C-contiguous {np.dtype(dtype)} array expected")
    return a


def graph_sizes(handles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Node counts and most predecessors of a node (at least 1) of the
    NativePoaGraphs whose handles (`_h`, uintp) are given: one native
    call."""
    lib = require_native("NativePoaGraph")
    h = np.ascontiguousarray(handles, np.uintp)
    nodes, maxp = np.empty(len(h), np.int64), np.empty(len(h), np.int64)
    lib.poa_graphs_sizes_c(h.ctypes.data, len(h), nodes.ctypes.data,
                           maxp.ctypes.data)
    return nodes, maxp


class StagePool:
    """Native worker threads that `stage_graphs` and `apply_graphs` calls
    share: up to `threads` a call with the caller's (min(threads,
    problems); 1, the serial loop, for a single problem or thread),
    started when a call first needs them, parked between calls and joined
    by `close` (a `with` block closes it). Starting a thread costs about a
    millisecond on some hosts, so a call does not start its own. A round
    loop holds one for its own length: none of its threads is alive when
    the process forks."""

    def __init__(self, threads: int = 1):
        self._lib = require_native("StagePool")
        self._h = self._lib.poa_stage_pool_new_c(
            max(1, min(int(threads), (1 << 31) - 1)))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.poa_stage_pool_free_c(self._h)
            self._h = None

    def __enter__(self) -> "StagePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stage_graphs(handles: np.ndarray, codes: np.ndarray,
                 q_start: np.ndarray, q_len: np.ndarray, bands: np.ndarray,
                 arrays, pool: Optional[StagePool] = None) -> int:
    """A chunk's staging in one native call: problem i is the
    NativePoaGraph of handle handles[i] (distinct) against the query
    codes[q_start[i]:q_start[i] + q_len[i]] at band half-width bands[i].
    Writes into `arrays` (base, preds, nn, ends, qq, ql, band, as
    ChunkStaging.chunk gives them) each graph's rank-space arrays as
    `graph_arrays` makes them of its PoaGraph twin (same topo order),
    rows 0..nn-1, with nn, qq[i, :ql], ql and band, and nothing else;
    caches each graph's topo order for `apply_graphs`. Runs on `pool`'s
    threads (None: the serial loop); returns how many it ran on."""
    lib = require_native("NativePoaGraph")
    base, preds, nn, ends, qq, ql, band = arrays
    for a, dtype in ((base, np.int32), (preds, np.int32), (nn, np.int32),
                     (ends, np.uint8), (qq, np.int32), (ql, np.int32),
                     (band, np.int32)):
        _c_array(a, dtype)
    h = np.ascontiguousarray(handles, np.uintp)
    if not len(h) == len(q_start) == len(q_len) == len(bands) == len(nn):
        raise ValueError("one graph, query and band a problem expected")
    used = lib.poa_graphs_stage_c(
        h.ctypes.data, len(h), _c_array(codes, np.uint8).ctypes.data,
        np.ascontiguousarray(q_start, np.int64).ctypes.data,
        np.ascontiguousarray(q_len, np.int64).ctypes.data,
        np.ascontiguousarray(bands, np.int32).ctypes.data,
        base.shape[1], preds.shape[2], qq.shape[1], base.ctypes.data,
        preds.ctypes.data, ends.ctypes.data, nn.ctypes.data,
        qq.ctypes.data, ql.ctypes.data, band.ctypes.data,
        pool._h if pool is not None else None)
    if used < 0:
        raise ValueError("poa_graphs_stage_c: caps too small")
    return int(used)


def apply_graphs(handles: np.ndarray, codes: np.ndarray,
                 q_start: np.ndarray, rows: np.ndarray, counts: np.ndarray,
                 walk: str = "steps", pool: Optional[StagePool] = None) -> int:
    """A chunk's paths applied in one native call: each problem's query
    (as `stage_graphs` took it) threaded along rows[i, :counts[i]], the
    step walk's reverse-order steps or with walk="sweep" the record
    walk's records (`expand_walk_records` in C), ranks resolved through
    the last staging's topo order. On `pool`'s threads (None: the serial
    loop); returns how many it ran on."""
    if walk not in WALKS:
        raise ValueError(f"unknown walk {walk!r}: one of {WALKS}")
    lib = require_native("NativePoaGraph")
    h = np.ascontiguousarray(handles, np.uintp)
    rows = np.ascontiguousarray(rows, np.int32)
    if len(rows) != len(h) or len(counts) != len(h):
        raise ValueError("one walk output a graph expected")
    return int(lib.poa_graphs_apply_c(
        h.ctypes.data, len(h), _c_array(codes, np.uint8).ctypes.data,
        np.ascontiguousarray(q_start, np.int64).ctypes.data,
        rows.ctypes.data, int(np.prod(rows.shape[1:])),
        np.ascontiguousarray(counts, np.int32).ctypes.data,
        1 if walk == "sweep" else 0, pool._h if pool is not None else None))




class _NativeGraphs:
    """The round loop's graphs held in C++ (NativePoaGraph): a chunk's
    staging and its paths applied are one native call each
    (`stage_graphs`, `apply_graphs`) on the threads of a StagePool that
    `close` joins with the handles it frees."""

    def __init__(self, seq_sets: Sequence[List[np.ndarray]], threads: int):
        self.graphs = [NativePoaGraph(s[0]) for s in seq_sets]
        self.handles = np.array([g._h for g in self.graphs], np.uintp)
        self.pool = StagePool(threads)

    def sizes(self, sets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return graph_sizes(self.handles[sets])

    def stage(self, sets, codes, q_start, q_len, bands, arrays) -> int:
        return stage_graphs(self.handles[sets], codes, q_start, q_len,
                            bands, arrays, self.pool)

    def apply(self, sets, codes, q_start, rows, counts, walk: str) -> int:
        return apply_graphs(self.handles[sets], codes, q_start, rows,
                            counts, walk, self.pool)

    def consensus(self) -> List[np.ndarray]:
        return [g.consensus() for g in self.graphs]

    def close(self) -> None:
        self.pool.close()
        for g in self.graphs:
            g.close()


class _PythonGraphs:
    """The round loop's graphs as Python PoaGraphs (no native library):
    a graph is staged by `graph_arrays`, which keeps its topo order with
    the query for its apply, and a path applied by `PoaGraph.apply_path`,
    one thread a call. With keep_paths, a chunk's paths go to `paths`
    (one a graph) and no graph changes."""

    def __init__(self, graphs: List[PoaGraph], keep_paths: bool = False):
        self.graphs = graphs
        self.orders: list = [None] * len(graphs)
        self.queries: list = [None] * len(graphs)
        self.paths = [None] * len(graphs) if keep_paths else None

    def sizes(self, sets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        graphs = [self.graphs[i] for i in sets]
        return (np.array([len(g.base) for g in graphs], np.int64),
                np.array([max([1, *map(len, g.preds)]) for g in graphs],
                         np.int64))

    def stage(self, sets, codes, q_start, q_len, bands, arrays) -> int:
        base, preds, nn, ends, qq, ql, band = arrays
        n_cap, p_cap = preds.shape[1:]
        for b, i in enumerate(sets):
            base[b], preds[b], ends[b], self.orders[i] = graph_arrays(
                self.graphs[i], n_cap, p_cap)
            nn[b] = len(self.orders[i])
            q = self.queries[i] = codes[q_start[b]:q_start[b] + q_len[b]]
            qq[b, :len(q)] = q
        ql[:], band[:] = q_len, bands
        return 1

    def apply(self, sets, codes, q_start, rows, counts, walk: str) -> int:
        for b, i in enumerate(sets):
            k = int(counts[b])
            steps = (expand_walk_records(rows[b], k) if walk == "sweep"
                     else rows[b, :k])
            order = self.orders[i]
            path = [(int(qi), order[rank] if rank >= 0 else None)
                    for qi, rank in steps[::-1]]
            if self.paths is None:
                self.graphs[i].apply_path(self.queries[i], path)
            else:
                self.paths[i] = path
        return 1

    def consensus(self) -> List[np.ndarray]:
        return [g.consensus() for g in self.graphs]

    def close(self) -> None:
        """Nothing outside Python to free."""


def _rounds(holder, seq_sets: Sequence[List[np.ndarray]],
            params: PoaParams, device: torch.device, walk: str,
            bands: Sequence[int], obs: Optional[RunObserver]) -> None:
    """The rounds over `holder`'s graphs (`_NativeGraphs` or
    `_PythonGraphs`; graph i holds seq_sets[i][0]): round k threads read
    k of every set that has one, a chunk at a time, each chunk staged by
    the holder into the call's ChunkStaging, dispatched, and its walk
    outputs applied by the holder."""
    # every read of every set in one array: set i's read k is read
    # first[i] + k, codes[start[r]:start[r] + length[r]]
    length = np.array([len(r) for s in seq_sets for r in s], np.int64)
    codes = np.concatenate([np.asarray(r, np.uint8) for s in seq_sets
                            for r in s] or [np.zeros(0, np.uint8)])
    start = np.cumsum(length) - length
    n_reads = np.array([len(s) for s in seq_sets], np.int64)
    first = np.cumsum(n_reads) - n_reads
    band_of = np.asarray(bands, np.int32)
    staging = ChunkStaging(device)
    for k in range(1, int(n_reads.max(initial=0))):
        live = np.flatnonzero(n_reads > k)
        if not len(live):
            break
        # counts poa.round every round and poa.round.first the first, the
        # widest (a graph stays live while it has reads left), which
        # tells whether a round outnumbers the card's SMs
        record("poa.round", items=len(live))
        if k == 1:
            record("poa.round.first", items=len(live))
        if obs is not None:
            obs.rounds += 1
        reads = first[live] + k
        nodes, maxp = holder.sizes(live)
        n_cap = _rank_cap(int(nodes.max()))
        round_walk = chunk_walk(walk, n_cap)
        if length[reads].max() >= 1 << 16:
            # the packed traceback matrices hold insertion origins in
            # 16-bit halves; the host C++ engine has no such limit
            raise ValueError("device POA path: query >= 65536 bases "
                             "unsupported (use the host engine)")
        l_cap = _pow2_at_least(int(length[reads].max()))
        p_cap = _pow2_at_least(int(maxp.max()), floor=4)
        by_width: dict = {}
        for pos in range(len(live)):
            w = _item_width(int(nodes[pos]), int(length[reads[pos]]),
                            int(band_of[live[pos]]), l_cap, params.adaptive)
            by_width.setdefault(w, []).append(pos)
        for W in sorted(by_width):
            idxs = by_width[W]
            chunk = _chunk_items(n_cap, W)
            for c0 in range(0, len(idxs), chunk):
                batch = idxs[c0:c0 + chunk]
                sets, at = live[batch], reads[batch]
                q_start = start[at]
                with span("poa.fill") as fill:
                    arrays = staging.chunk(len(batch), n_cap, p_cap, l_cap)
                    used = holder.stage(sets, codes, q_start, length[at],
                                        band_of[sets], arrays)
                record("poa.stage.threads", items=used)
                if obs is not None:
                    obs.fill_s += fill.seconds
                    obs.chunk(k, arrays, W, l_cap, params)
                with span("poa.dispatch", len(batch)):
                    rows, counts = dispatch_chunk(
                        *arrays, W, l_cap, params, device, obs, round_walk,
                        staging)
                with span("poa.apply") as applied:
                    used = holder.apply(sets, codes, q_start, rows, counts,
                                        round_walk)
                record("poa.stage.threads", items=used)
                if obs is not None:
                    obs.apply_s += applied.seconds
    if staging.grows:
        record("poa.stage.grow", items=staging.grows)


def align_graph_batch(graphs: Sequence[PoaGraph],
                      queries: Sequence[np.ndarray],
                      params: Optional[PoaParams] = None, device="cuda"
                      ) -> List[List[Tuple[int, Optional[int]]]]:
    """Align query[i] to the Python-held graph[i] for every i in one
    (chunked) device dispatch a width class, at band params.band: one
    round of the round loop, whose paths come back for
    PoaGraph.apply_path and change no graph."""
    params = params or PoaParams()
    device = resolve_device(device)
    if len(graphs) != len(queries):
        raise ValueError("one query per graph expected")
    holder = _PythonGraphs(list(graphs), keep_paths=True)
    # a set's read 0 is the one its graph was made of: an empty stand-in
    _rounds(holder, [(q[:0], q) for q in queries], params, device, "steps",
            [params.band] * len(graphs), None)
    return holder.paths


def poa_consensus_batch(seq_sets: Sequence[List[np.ndarray]],
                        params: Optional[PoaParams] = None, device="cuda",
                        walk: str = "steps",
                        bands: Optional[Sequence[int]] = None,
                        threads: int = 1) -> List[np.ndarray]:
    """Graph-POA consensus of many isoforms at once: reads are threaded in
    lockstep rounds: round k aligns the k-th read of every still-growing
    graph in batched device dispatches on `device` (the per-locus isoform
    axis, mirroring the reference's one-abpoa-process-per-isoform at
    SDC.py:915-919). Graphs live in C++ between rounds (NativePoaGraph),
    so the per-round staging never touches Python adjacency lists: a
    chunk's staging and its paths applied are one native call each
    (`stage_graphs`, `apply_graphs`) on min(`threads`, problems) threads
    of the call's StagePool, into host buffers the call reuses from chunk
    to chunk (ChunkStaging: pinned on a CUDA device). With walk="sweep"
    every chunk that `chunk_walk` lets through leaves the device as
    run-compressed records (`poa_sweep`); the consensi are the same
    either way, and for every `threads`.

    `bands` gives each sequence set its own band half-width (default:
    params.band for all). The band is a per-problem input of the forward,
    so sets of different bands share a round's dispatch: a round is one
    chunk a width class (more only past CHUNK_BYTES), and each set's
    consensus is what a call with that band alone gives.

    A `RunObserver` installed as `OBSERVER` sees the call's rounds,
    chunks and timings; without one nothing is recorded. Counts
    `poa.stage.threads` (a staging or applying call each, the threads it
    ran on) and `poa.stage.grow` (once a call, the times its buffers
    grew) go to the running StageTimer.

    Under MANDO_TPU_NO_NATIVE the graphs are Python `PoaGraph`s (the
    reference's rounds without its library) in the same round loop:
    `graph_arrays` stages a graph and `apply_path` applies its path, on
    one thread, by the walk `walk` asks; the same consensi."""
    params = params or PoaParams()
    device = resolve_device(device)
    if bands is None:
        bands = [params.band] * len(seq_sets)
    if len(bands) != len(seq_sets):
        raise ValueError("one band per sequence set expected")
    if load_native() is None:
        holder = _PythonGraphs([PoaGraph(s[0]) for s in seq_sets])
    else:
        holder = _NativeGraphs(seq_sets, threads)
    try:
        _rounds(holder, seq_sets, params, device, walk, bands, OBSERVER)
        return holder.consensus()
    finally:
        holder.close()
