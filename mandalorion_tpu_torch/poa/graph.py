"""Partial-order alignment graph: sequence-to-DAG DP + heaviest bundle.

The graph is columnar: node base codes, edge lists, edge weights. Each read
is globally aligned to the DAG with abPOA's convex (dual-affine) gap model
(`abpoa -M 5 -r 0`, SpliceDefineConsensus.py:915-919; defaults -O 6,26
-E 2,1): a gap of length k costs min(gap_open + k*gap_extend,
gap_open2 + k*gap_extend2) — the cheap-open component wins short gaps, the
cheap-extend component long ones. The DP carries two deletion states across
graph edges and resolves the two insertion states per row with prefix-max
scans (an insertion opening from another insertion's end pays both opens
and never beats a pure single-component run, so the scan collapse is
exact — tests/test_poa.py asserts optimality against a brute-force convex
Gotoh oracle). The traceback path adds nodes/edges with read support.
Consensus = heaviest-bundle path (max edge-weight DP over topological
order), abPOA's `-r 0` output mode.

Exact abPOA-binary output equivalence is unverifiable in this environment
(no abpoa binary, zero egress — see NOTES.md); the scoring model, tie-break
conventions, and graph-construction order are pinned here and mirrored
bit-identically by the batched device kernel (poa/kernels.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from mandalorion_tpu_torch.config import POA_BAND_DEFAULT

NEG = -(10 ** 9)


@dataclass
class PoaParams:
    match: int = 5          # abPOA -M 5
    mismatch: int = 4
    gap_open: int = 6       # abPOA -O 6,26 (convex: two affine components)
    gap_extend: int = 2     # abPOA -E 2,1
    gap_open2: int = 26
    gap_extend2: int = 1
    # query band half-width around the node-rank diagonal; single default
    # shared with PoaConfig.band_width (config.POA_BAND_DEFAULT)
    band: int = POA_BAND_DEFAULT
    # abPOA -S analogue (SDC.py:915-919 adds -S for >=8 kb inserts):
    # score-following adaptive band — each row's band centers one past the
    # first-max column of its best predecessor row instead of the static
    # rank diagonal, so the half-width stays `band` regardless of how far
    # the graph outgrows the query (the static mode must widen to
    # |nodes - qlen| + 16 to cover global drift)
    adaptive: bool = False


class PoaGraph:
    def __init__(self, seq_codes: np.ndarray):
        n = len(seq_codes)
        self.base: List[int] = [int(b) for b in seq_codes]
        self.preds: List[List[int]] = [[] for _ in range(n)]
        self.succs: List[List[int]] = [[] for _ in range(n)]
        self.edge_w: Dict[Tuple[int, int], int] = {}
        for i in range(1, n):
            self._add_edge(i - 1, i)
        self.starts: List[int] = [0] if n else []

    def _add_edge(self, u: int, v: int) -> None:
        if (u, v) not in self.edge_w:
            self.edge_w[(u, v)] = 0
            self.preds[v].append(u)
            self.succs[u].append(v)
        self.edge_w[(u, v)] += 1

    def _add_node(self, base: int) -> int:
        self.base.append(base)
        self.preds.append([])
        self.succs.append([])
        return len(self.base) - 1

    def topo_order(self) -> List[int]:
        n = len(self.base)
        indeg = np.zeros(n, np.int64)
        for v in range(n):
            indeg[v] = len(self.preds[v])
        from collections import deque
        dq = deque([v for v in range(n) if indeg[v] == 0])
        order = []
        while dq:
            u = dq.popleft()
            order.append(u)
            for v in self.succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    dq.append(v)
        return order

    # ------------------------------------------------------------- align

    @staticmethod
    def _gap0(params: PoaParams, jidx: np.ndarray) -> np.ndarray:
        """Row-0 boundary: cost of inserting the first j query bases =
        convex min over the two affine components (0 at j=0)."""
        g1 = params.gap_open + params.gap_extend * jidx
        g2 = params.gap_open2 + params.gap_extend2 * jidx
        out = -np.minimum(g1, g2)
        out[0] = 0
        return out

    def align(self, q: np.ndarray, params: PoaParams
              ) -> List[Tuple[int, Optional[int]]]:
        """Global banded convex-affine alignment of query codes vs the
        graph. Returns the path as (query_index | -1, node | None) steps:
        (qi, node)   — query base qi aligned to node (match or mismatch)
        (qi, None)   — query base qi inserted (new node needed)
        (-1, node)   — node deleted (skipped).

        Tie-break conventions (pinned; the device kernel mirrors them):
        H state order diag >= D1 >= D2, insertions replace on strict >
        (I1 before I2); D open-from-H wins ties over extend; first max
        over predecessors in declared order; end rank = first max. With
        params.adaptive, the band center is best_col[best pred] + 1
        (best_col = first-max column of a stored H row, 0 for an all-NEG
        row) with half-width exactly params.band.
        """
        order = self.topo_order()
        rank = {v: r for r, v in enumerate(order)}
        n, L = len(order), len(q)
        band = (params.band if params.adaptive
                else max(params.band, abs(n - L) + 16))
        jidx = np.arange(L + 1, dtype=np.int64)
        o1, e1 = params.gap_open, params.gap_extend
        o2, e2 = params.gap_open2, params.gap_extend2

        # state matrices over (rank+1, L+1)
        score = np.full((n + 1, L + 1), NEG, np.int64)   # H (band-masked)
        d1 = np.full((n + 1, L + 1), NEG, np.int64)
        d2 = np.full((n + 1, L + 1), NEG, np.int64)
        op = np.zeros((n + 1, L + 1), np.uint8)    # 0 diag 1 I1 2 D1 3 I2 4 D2
        op0 = np.zeros((n + 1, L + 1), np.uint8)   # pre-insertion op (0/2/4)
        node0 = np.full((n + 1, L + 1), -2, np.int32)  # diag pred rank
        orig1 = np.zeros((n + 1, L + 1), np.int32)  # I1 run origin column
        orig2 = np.zeros((n + 1, L + 1), np.int32)
        score[0] = self._gap0(params, jidx)
        score[0, min(L, band) + 1:] = NEG   # row 0 is band-local too
        op[0, :] = 1
        orig1[0, :] = 0
        # first-max column per stored H row (adaptive band centers); an
        # all-NEG row pins to 0 (the kernel mirrors this exactly)
        best_col = np.zeros(n + 1, np.int64)

        for r, v in enumerate(order, start=1):
            pred_ranks = [rank[u] + 1 for u in self.preds[v]]
            if not pred_ranks:
                pred_ranks = [0]
            base_v = self.base[v]
            sub = np.where(q == base_v, params.match, -params.mismatch)

            # band-local DP (true banded: ALL states exist only inside the
            # per-row band, like abPOA's banded SIMD rows — this is what
            # lets the device kernel store only the band window)
            if params.adaptive:
                center = int(max(best_col[pr] for pr in pred_ranks)) + 1
            else:
                center = r * L // max(n, 1)
            j0 = max(0, center - band)
            j1 = min(L, center + band)
            masked = (jidx < j0) | (jidx > j1)

            best_prev = np.full(L + 1, NEG, np.int64)
            best_prev_rank = np.full(L + 1, -2, np.int64)
            d1_row = np.full(L + 1, NEG, np.int64)
            d2_row = np.full(L + 1, NEG, np.int64)
            for pr in pred_ranks:
                better = score[pr] > best_prev
                best_prev = np.where(better, score[pr], best_prev)
                best_prev_rank = np.where(better, pr, best_prev_rank)
                c1 = np.maximum(score[pr] - (o1 + e1), d1[pr] - e1)
                c2 = np.maximum(score[pr] - (o2 + e2), d2[pr] - e2)
                d1_row = np.maximum(d1_row, c1)
                d2_row = np.maximum(d2_row, c2)
            d1_row = np.where(masked, NEG, d1_row)
            d2_row = np.where(masked, NEG, d2_row)
            d1[r] = d1_row
            d2[r] = d2_row

            # H pre-insertion: diag >= D1 >= D2 on ties
            diag = best_prev[:-1] + sub          # consume query base
            row = np.concatenate([[NEG], diag])
            rowo = np.zeros(L + 1, np.uint8)
            rown = np.concatenate([[-2], best_prev_rank[:-1]])
            m = d1_row > row
            row = np.where(m, d1_row, row)
            rowo = np.where(m, np.uint8(2), rowo)
            m = d2_row > row
            row = np.where(m, d2_row, row)
            rowo = np.where(m, np.uint8(4), rowo)
            op0[r] = rowo
            node0[r] = rown

            # insertions may only open from in-band cells (band-local)
            row = np.where(masked, NEG, row)

            # insertions: per component, a prefix-max scan over the
            # pre-insertion row (see module docstring for why this is
            # exact); origin column recovered for traceback
            fin = row.copy()
            fino = rowo.copy()
            for comp, (oo, ee, code, orig) in enumerate(
                    (((o1, e1, 1, orig1)), (o2, e2, 3, orig2))):
                vals = row + ee * jidx
                acc = np.maximum.accumulate(vals)
                prev_acc = np.concatenate([[NEG - 1], acc[:-1]])
                is_new = vals > prev_acc
                org = np.maximum.accumulate(np.where(is_new, jidx, -1))
                ins = acc - oo - ee * jidx
                m = ins > fin
                fin = np.where(m, ins, fin)
                fino = np.where(m, np.uint8(code), fino)
                orig[r] = np.where(m, org, orig[r])

            # band mask on the stored H row
            score[r] = np.where(masked, NEG, fin)
            op[r] = fino
            m = score[r].max()
            best_col[r] = 0 if m <= NEG else int(np.argmax(score[r]))

        # best end: first max over rows of nodes with no successors at L
        end_ranks = [rank[v] + 1 for v in order if not self.succs[v]]
        if not end_ranks:
            end_ranks = [n]
        br = max(end_ranks, key=lambda rr: score[rr, L])

        # ------------------------------------------------------ traceback
        path: List[Tuple[int, Optional[int]]] = []
        st = "H"   # H (final op) | H0 (pre-insertion op) | D1 | D2
        r, j = br, L
        while r > 0 or j > 0:
            if st in ("H", "H0"):
                if r == 0:
                    path.append((j - 1, None))
                    j -= 1
                    continue
                o = op[r, j] if st == "H" else op0[r, j]
                v = order[r - 1]
                if o == 0:
                    path.append((j - 1, v))
                    r, j, st = int(node0[r, j]), j - 1, "H"
                elif o in (1, 3):
                    target = int((orig1 if o == 1 else orig2)[r, j])
                    while j > target:
                        path.append((j - 1, None))
                        j -= 1
                    st = "H0"
                else:
                    st = "D1" if o == 2 else "D2"
            else:
                oo, ee = (o1, e1) if st == "D1" else (o2, e2)
                dmat = d1 if st == "D1" else d2
                v = order[r - 1]
                path.append((-1, v))
                pred_ranks = [rank[u] + 1 for u in self.preds[v]]
                if not pred_ranks:
                    pred_ranks = [0]
                target = dmat[r, j]
                nxt = None
                for pr in pred_ranks:  # first max, as in the forward pass
                    c_open = score[pr, j] - (oo + ee)
                    c_ext = dmat[pr, j] - ee
                    if max(c_open, c_ext) == target:
                        nxt = (pr, c_ext > c_open)  # open wins ties
                        break
                assert nxt is not None, "deletion traceback lost"
                r = nxt[0]
                st = st if nxt[1] else "H"
        path.reverse()
        return path

    # ---------------------------------------------------------- add read

    def add_read(self, q: np.ndarray, params: PoaParams) -> None:
        self.apply_path(q, self.align(q, params))

    def apply_path(self, q: np.ndarray,
                   path: List[Tuple[int, Optional[int]]]) -> None:
        """Thread query q into the graph along an alignment path (the
        mutation half of add_read; the batched kernel computes paths for
        many graphs at once and applies them here)."""
        prev_node = -1
        for qi, node in path:
            if qi == -1:
                continue  # deletion: no query base, no edge traversed
            if node is not None and self.base[node] == int(q[qi]):
                cur = node
            else:
                cur = self._add_node(int(q[qi]))
            if prev_node >= 0:
                self._add_edge(prev_node, cur)
            else:
                if cur not in self.starts:
                    self.starts.append(cur)
            prev_node = cur

    # --------------------------------------------------------- consensus

    def consensus(self) -> np.ndarray:
        """Heaviest-bundle path: maximize summed edge weight."""
        order = self.topo_order()
        n = len(order)
        if n == 0:
            return np.zeros(0, np.uint8)
        best = {v: 0 for v in order}
        back: Dict[int, int] = {}
        for v in order:
            for u in self.preds[v]:
                w = self.edge_w[(u, v)]
                cand = best[u] + w
                if cand > best.get(v, NEG):
                    best[v] = cand
                    back[v] = u
        end = max(order, key=lambda v: best[v])
        out = [end]
        while out[-1] in back:
            out.append(back[out[-1]])
        out.reverse()
        return np.array([self.base[v] for v in out], np.uint8)


def poa_consensus(seq_codes_list: List[np.ndarray],
                  params: Optional[PoaParams] = None) -> np.ndarray:
    """Consensus of oriented sequences (codes) — the pure-Python oracle.

    Length policy (cap + fallback) lives in ONE place: the production
    entry point (`poa/consensus.py`, `PoaConfig.max_graph_len` /
    `overlength_fallback`). This oracle imposes no cap of its own.
    """
    params = params or PoaParams()
    graph = PoaGraph(seq_codes_list[0])
    for q in seq_codes_list[1:]:
        graph.add_read(q, params)
    return graph.consensus()
