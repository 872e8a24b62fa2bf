// Native banded partial-order alignment (the host fast path of the graph
// consensus engine, replacing the abPOA C library the reference shells out
// to at SpliceDefineConsensus.py:915-919).
//
// Bit-identical contract: scores, band semantics (static diagonal band and
// the adaptive score-following -S band), tie-breaks (first-max predecessor,
// diag >= D1 >= D2, strict-> insertions I1 before I2, D open wins ties over
// extend), traceback order, graph construction order, and the
// heaviest-bundle consensus walk all match poa/graph.py's PoaGraph and the
// batched device kernel in poa/kernels.py (tests/test_poa.py asserts
// three-way equality). Storage is banded: each DP row holds only a W-wide
// window at a per-row offset, O(nodes x W) total, so 25 kb isoforms run in
// tens of milliseconds instead of the numpy oracle's O(nodes x query)
// full-width rows.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>

namespace {

constexpr int32_t NEG = -1000000000;

struct Params {
    int32_t match, mismatch, o1, e1, o2, e2, band;
    int32_t adaptive;
};

// ----------------------------------------------------------------- graph

struct Graph {
    std::vector<int32_t> base;
    // adjacency in declared (insertion) order — predecessor order is a
    // tie-break input, so it must match PoaGraph._add_edge exactly
    std::vector<std::vector<int32_t>> preds, succs;
    std::vector<std::vector<int64_t>> succ_w;  // parallel to succs
    std::vector<int32_t> starts;
    size_t maxp = 1;  // the most predecessors of any node, at least 1

    explicit Graph(const uint8_t* seq, int64_t n) {
        base.reserve(n * 2);
        for (int64_t i = 0; i < n; i++) base.push_back(seq[i]);
        preds.resize(n);
        succs.resize(n);
        succ_w.resize(n);
        for (int64_t i = 1; i < n; i++) add_edge(i - 1, i);
        if (n) starts.push_back(0);
    }

    void add_edge(int32_t u, int32_t v) {
        auto& su = succs[u];
        for (size_t c = 0; c < su.size(); c++) {
            if (su[c] == v) { succ_w[u][c] += 1; return; }
        }
        su.push_back(v);
        succ_w[u].push_back(1);
        preds[v].push_back(u);
        if (preds[v].size() > maxp) maxp = preds[v].size();
    }

    int32_t add_node(int32_t b) {
        base.push_back(b);
        preds.emplace_back();
        succs.emplace_back();
        succ_w.emplace_back();
        return (int32_t)base.size() - 1;
    }

    // Kahn's BFS with a FIFO queue seeded in node-index order — exactly
    // PoaGraph.topo_order (collections.deque popleft). The queue is
    // `order` itself: nodes leave it in the order they entered.
    void topo_order(std::vector<int32_t>& order) const {
        topo_visit(order, [](int32_t, int64_t) {});
    }

    // topo_order, calling visit(node, rank) as each node leaves the
    // queue: by then all its predecessors have left it.
    template <class Visit>
    void topo_visit(std::vector<int32_t>& order, Visit visit) const {
        int64_t n = base.size();
        std::vector<int32_t> indeg(n);
        order.clear();
        order.reserve(n);
        for (int64_t v = 0; v < n; v++) {
            indeg[v] = (int32_t)preds[v].size();
            if (!indeg[v]) order.push_back((int32_t)v);
        }
        for (size_t head = 0; head < order.size(); head++) {
            int32_t u = order[head];
            visit(u, (int64_t)head);
            for (int32_t v : succs[u])
                if (--indeg[v] == 0) order.push_back(v);
        }
    }
};

// ----------------------------------------------------------- banded align

// One alignment's DP state in banded storage (reused across reads)
struct DpState {
    std::vector<int32_t> score, d1, d2, node0, orig1, orig2, offs, bestc;
    std::vector<uint8_t> op, op0;

    void reset(int64_t rows, int32_t W) {
        // rows 1..n are fully written before any read, so only row 0
        // needs initialization — avoids O(rows x W) memsets per read
        score.resize(rows * W);
        d1.resize(rows * W);
        d2.resize(rows * W);
        node0.resize(rows * W);
        orig1.resize(rows * W);
        orig2.resize(rows * W);
        op.resize(rows * W);
        op0.resize(rows * W);
        offs.resize(rows);
        bestc.resize(rows);
        std::fill_n(score.data(), W, NEG);
        std::fill_n(d1.data(), W, NEG);
        std::fill_n(d2.data(), W, NEG);
        std::fill_n(node0.data(), W, -2);
        std::fill_n(orig1.data(), W, 0);
        std::fill_n(orig2.data(), W, 0);
        std::fill_n(op.data(), W, uint8_t(0));
        std::fill_n(op0.data(), W, uint8_t(0));
        offs[0] = 0;
        bestc[0] = 0;
    }
};

// Window read helpers: value at matrix row t, ABSOLUTE column j (NEG /
// zero outside the stored window — the band-local masked value).
static inline int32_t cell(const std::vector<int32_t>& mat,
                           const std::vector<int32_t>& offs,
                           int32_t W, int64_t t, int64_t j,
                           int32_t fill = NEG) {
    int64_t rel = j - offs[t];
    if (rel < 0 || rel >= W) return fill;
    return mat[t * W + rel];
}

static inline uint8_t cell_u8(const std::vector<uint8_t>& mat,
                              const std::vector<int32_t>& offs,
                              int32_t W, int64_t t, int64_t j) {
    int64_t rel = j - offs[t];
    if (rel < 0 || rel >= W) return 0;
    return mat[t * W + rel];
}

// Align query q (codes, length L) to the graph; emits the path as
// (qi, node) int32 pairs in forward order (qi == -1: node deleted,
// node == -1: query base inserted). Returns the number of steps.
// `order`/`rank` are the current topo order; scratch state in `st`.
static int64_t align_path(const Graph& g, const std::vector<int32_t>& order,
                          const std::vector<int32_t>& rank,
                          const uint8_t* q, int64_t L, const Params& pp,
                          DpState& st, int32_t* out_steps) {
    // the packed insertion prefix-max key stores 0xFFFFFF-(jabs+1) in its
    // low 24 bits; queries with L+1 >= 2^24 would wrap the index and
    // silently corrupt key ordering — refuse loudly (realistic reads are
    // ~1000x smaller)
    if (L + 1 >= ((int64_t)1 << 24)) return -2;
    int64_t n = order.size();
    int32_t eff = pp.adaptive
        ? pp.band
        : std::max<int64_t>(pp.band, std::llabs(n - L) + 16);
    int32_t W = (int32_t)std::min<int64_t>(L + 1, 2 * (int64_t)eff + 2);
    int64_t rows = n + 1;
    st.reset(rows, W);
    const int64_t off_hi = std::max<int64_t>(0, L + 1 - W);

    // row 0 (off = 0): convex insertion boundary, band-local
    {
        int32_t* s0 = st.score.data();
        uint8_t* o0 = st.op.data();
        int64_t jmax = std::min<int64_t>(L, eff);
        for (int64_t j = 0; j < W; j++) {
            if (j == 0) s0[j] = 0;
            else if (j <= jmax)
                s0[j] = -std::min(pp.o1 + pp.e1 * (int32_t)j,
                                  pp.o2 + pp.e2 * (int32_t)j);
            o0[j] = 1;
        }
    }

    std::vector<int32_t> best_prev(W + 1), best_rank(W + 1), row(W);
    std::vector<int64_t> keys(2 * W);
    std::vector<int32_t> pr_buf;

    for (int64_t r = 1; r <= n; r++) {
        int32_t v = order[r - 1];
        pr_buf.clear();
        for (int32_t u : g.preds[v]) pr_buf.push_back(rank[u] + 1);
        if (pr_buf.empty()) pr_buf.push_back(0);
        int32_t base_v = g.base[v];

        int64_t center;
        if (pp.adaptive) {
            int32_t c = NEG;
            for (int32_t pr : pr_buf) c = std::max(c, st.bestc[pr]);
            center = (int64_t)c + 1;
        } else {
            center = r * L / std::max<int64_t>(n, 1);
        }
        int64_t off = std::min<int64_t>(
            std::max<int64_t>(center - eff, 0), off_hi);
        st.offs[r] = (int32_t)off;
        int64_t j0 = std::max<int64_t>(0, center - eff);
        int64_t j1 = std::min<int64_t>(L, center + eff);

        // in-band stored-column range [cb0, cb1] (range fills replace
        // per-lane band masks; outside it every value is NEG by the
        // band-local semantics)
        int32_t cb0 = (int32_t)std::min<int64_t>(
            std::max<int64_t>(0, j0 - off), W);
        int32_t cb1 = (int32_t)std::min<int64_t>(W - 1, j1 - off);
        if (cb1 < cb0 - 1) cb1 = cb0 - 1;  // empty band: pure fills

        // predecessor combine over the extended range [off-1, off+W-1]
        // (index e: absolute column off-1+e; slot e feeds the diagonal of
        // stored column e and the vertical of stored column e-1 — the
        // +1-wide read exactly mirrors the kernel's eabs window). Split
        // into branchless vectorizable passes per predecessor.
        int32_t* __restrict d1_row = st.d1.data() + r * W;
        int32_t* __restrict d2_row = st.d2.data() + r * W;
        const int32_t oe1 = pp.o1 + pp.e1, oe2 = pp.o2 + pp.e2;
        const int32_t ge1 = pp.e1, ge2 = pp.e2;
        std::fill(best_prev.begin(), best_prev.end(), NEG);
        std::fill(best_rank.begin(), best_rank.end(), -2);
        std::fill(d1_row, d1_row + W, NEG);
        std::fill(d2_row, d2_row + W, NEG);
        for (int32_t pr : pr_buf) {
            int32_t off_p = st.offs[pr];
            const int32_t* __restrict srow =
                st.score.data() + (int64_t)pr * W;
            const int32_t* __restrict d1p = st.d1.data() + (int64_t)pr * W;
            const int32_t* __restrict d2p = st.d2.data() + (int64_t)pr * W;
            // clip e to the overlap of [off-1, off+W-1] with the pred's
            // stored window [off_p, off_p+W-1] and column range >= 0
            int32_t shift = (int32_t)(off - 1) - off_p;  // rel = e + shift
            int32_t e_lo = std::max(0, -shift);
            if ((int32_t)off - 1 + e_lo < 0) e_lo = (int32_t)(1 - off);
            int32_t e_hi = std::min((int32_t)W, W - 1 - shift);
            int32_t* __restrict bp = best_prev.data();
            int32_t* __restrict br = best_rank.data();
            int32_t* __restrict d1r = d1_row;
            int32_t* __restrict d2r = d2_row;
            // fused pass: slot e updates best_prev[e] and the D row at
            // e-1 (same srow element), so the pred row is read once.
            // The lone e without a D update (e_lo when e_lo == 0) runs
            // scalar first.
            int32_t d0 = std::max(e_lo, 1);
            for (int32_t e = e_lo; e < d0 && e <= e_hi; e++) {
                int32_t sv = srow[e + shift];
                bool m = sv > bp[e];
                bp[e] = m ? sv : bp[e];
                br[e] = m ? pr : br[e];
            }
#pragma omp simd
            for (int32_t e = d0; e <= e_hi; e++) {
                int32_t sv = srow[e + shift];
                bool m = sv > bp[e];
                bp[e] = m ? sv : bp[e];
                br[e] = m ? pr : br[e];
                int32_t c1 = std::max(sv - oe1, d1p[e + shift] - ge1);
                int32_t c2 = std::max(sv - oe2, d2p[e + shift] - ge2);
                d1r[e - 1] = c1 > d1r[e - 1] ? c1 : d1r[e - 1];
                d2r[e - 1] = c2 > d2r[e - 1] ? c2 : d2r[e - 1];
            }
        }
        // band mask on D rows: range fills
        std::fill(d1_row, d1_row + cb0, NEG);
        std::fill(d2_row, d2_row + cb0, NEG);
        if (cb1 + 1 < W) {
            std::fill(d1_row + cb1 + 1, d1_row + W, NEG);
            std::fill(d2_row + cb1 + 1, d2_row + W, NEG);
        }

        // H pre-insertion: diag >= D1 >= D2 on ties. The diagonal exists
        // for absolute columns in [1, L]: stored range [cd0, cd1];
        // outside it hv starts NEG / nv -2 (matches the full-row oracle).
        {
            int32_t cd0 = (off == 0) ? 1 : 0;
            int32_t cd1 = (int32_t)std::min<int64_t>(W - 1, L - off);
            int32_t* __restrict rw = row.data();
            int32_t* __restrict rn = st.node0.data() + r * W;
            uint8_t* __restrict ro = st.op0.data() + r * W;
            const int32_t* __restrict bp = best_prev.data();
            const int32_t* __restrict br = best_rank.data();
            const int32_t* __restrict d1r = d1_row;
            const int32_t* __restrict d2r = d2_row;
            const uint8_t* __restrict qd = q + off - 1;  // q[jabs-1]
            for (int32_t c = 0; c < cd0; c++) rn[c] = -2;
            for (int32_t c = cd1 + 1; c < W; c++) rn[c] = -2;
#pragma omp simd
            for (int32_t c = cd0; c <= cd1; c++) {
                int32_t sub = (qd[c] == base_v) ? pp.match : -pp.mismatch;
                rw[c] = bp[c] + sub;
                rn[c] = br[c];
            }
#pragma omp simd
            for (int32_t c = 0; c < W; c++) {
                int32_t hv = (c >= cd0 && c <= cd1) ? rw[c] : NEG;
                uint8_t ov = 0;
                bool m1 = d1r[c] > hv;
                hv = m1 ? d1r[c] : hv;
                ov = m1 ? (uint8_t)2 : ov;
                bool m2 = d2r[c] > hv;
                hv = m2 ? d2r[c] : hv;
                ov = m2 ? (uint8_t)4 : ov;
                rw[c] = hv;
                ro[c] = ov;
            }
            // insertions may only open from in-band cells (band-local)
            std::fill(row.begin(), row.begin() + cb0, NEG);
            if (cb1 + 1 < W)
                std::fill(row.begin() + cb1 + 1, row.end(), NEG);
        }

        // insertions: per component, a prefix-max scan with the masked
        // carry from columns < off (NEG + ee*j is monotone, so the carry
        // is NEG + ee*(off-1) with origin off-1 / 0 — kernel's acc_c rule)
        int32_t* __restrict fin = st.score.data() + r * W;
        uint8_t* __restrict fino = st.op.data() + r * W;
        std::copy(row.begin(), row.end(), fin);
        std::memcpy(fino, st.op0.data() + r * W, W);
        {
            const int32_t oo1 = pp.o1, ee1 = pp.e1;
            const int32_t oo2 = pp.o2, ee2 = pp.e2;
            int32_t* __restrict org1 = st.orig1.data() + r * W;
            int32_t* __restrict org2 = st.orig2.data() + r * W;
            // packed (value, first-index) prefix max per component: the
            // key carries the running max value in the high bits and
            // 0xFFFFFF-(jabs+1) in the low 24, so equal values resolve
            // to the SMALLER jabs — exactly the strict `val > acc`
            // first-max rule. Both components scan in one loop: two
            // independent dependency chains pipeline.
            int64_t a1, g1, a2, g2;
            if (off > 0) {
                a1 = (int64_t)NEG + (int64_t)ee1 * (off - 1);
                g1 = ee1 > 0 ? off - 1 : 0;
                a2 = (int64_t)NEG + (int64_t)ee2 * (off - 1);
                g2 = ee2 > 0 ? off - 1 : 0;
            } else {
                a1 = a2 = (int64_t)NEG - 1;
                g1 = g2 = -1;
            }
            int64_t* __restrict k1 = keys.data();
            int64_t* __restrict k2 = keys.data() + W;
            const int32_t* __restrict rwp = row.data();
#pragma omp simd
            for (int32_t c = 0; c < W; c++) {
                int64_t idx = (int64_t)(0xFFFFFF - (int32_t)(off + c + 1));
                k1[c] = (((int64_t)rwp[c]
                          + (int64_t)ee1 * (off + c)) << 24) | idx;
                k2[c] = (((int64_t)rwp[c]
                          + (int64_t)ee2 * (off + c)) << 24) | idx;
            }
            int64_t ka1 = (a1 << 24) | (int64_t)(0xFFFFFF - (int32_t)(g1 + 1));
            int64_t ka2 = (a2 << 24) | (int64_t)(0xFFFFFF - (int32_t)(g2 + 1));
            for (int32_t c = 0; c < W; c++) {
                if (k1[c] > ka1) ka1 = k1[c];
                k1[c] = ka1;
                if (k2[c] > ka2) ka2 = k2[c];
                k2[c] = ka2;
            }
#pragma omp simd
            for (int32_t c = 0; c < W; c++) {
                int64_t kk1 = k1[c], kk2 = k2[c];
                int32_t i1 = (int32_t)(kk1 >> 24) - oo1
                    - ee1 * (int32_t)(off + c);
                int32_t i2 = (int32_t)(kk2 >> 24) - oo2
                    - ee2 * (int32_t)(off + c);
                int32_t o1v = 0xFFFFFF - (int32_t)(kk1 & 0xFFFFFF) - 1;
                int32_t o2v = 0xFFFFFF - (int32_t)(kk2 & 0xFFFFFF) - 1;
                // component 1 first, then component 2 (original order)
                int32_t f = fin[c];
                uint8_t fo = fino[c];
                bool m1 = i1 > f;
                f = m1 ? i1 : f;
                fo = m1 ? (uint8_t)1 : fo;
                org1[c] = m1 ? o1v : 0;
                bool m2 = i2 > f;
                f = m2 ? i2 : f;
                fo = m2 ? (uint8_t)3 : fo;
                org2[c] = m2 ? o2v : 0;
                fin[c] = f;
                fino[c] = fo;
            }
        }
        // band mask + store; best_col = first-max column (all-NEG -> 0)
        int32_t* __restrict srow = fin;  // st.score row r, in place
        for (int32_t c = 0; c < cb0; c++) srow[c] = NEG;
        for (int32_t c = cb1 + 1; c < W; c++) srow[c] = NEG;
        // first-max column via packed (value, smaller-c-wins) max
        int64_t bkey = ((int64_t)NEG << 24) | 0xFFFFFF;
#pragma omp simd reduction(max : bkey)
        for (int32_t c = cb0; c <= cb1; c++) {
            int64_t k = ((int64_t)srow[c] << 24)
                | (int64_t)(0xFFFFFF - c - 1);
            bkey = k > bkey ? k : bkey;
        }
        int32_t best = (int32_t)(bkey >> 24);
        int32_t bc = 0xFFFFFF - (int32_t)(bkey & 0xFFFFFF) - 1;
        st.bestc[r] = best <= NEG ? 0 : (int32_t)(off + bc);
    }

    // best end: first max over end ranks (ascending) at column L
    int64_t br = -1;
    int32_t bscore = NEG - 1;
    for (int64_t r = 1; r <= n; r++) {
        if (!g.succs[order[r - 1]].empty()) continue;
        int32_t sv = cell(st.score, st.offs, W, r, L);
        if (sv > bscore) { bscore = sv; br = r; }
    }
    if (br < 0) {  // no end nodes (cannot happen in a DAG with nodes)
        br = n;
        if (n) bscore = cell(st.score, st.offs, W, n, L);
    }

    // ------------------------------------------------------- traceback
    // states: 0 H (final op), 1 H0 (pre-insertion op), 2 D1, 3 D2;
    // mirrors PoaGraph.align's while loop step for step
    int64_t k = 0;
    int64_t r = br, j = L;
    int stt = 0;
    while (r > 0 || j > 0) {
        if (stt == 0 || stt == 1) {
            if (r == 0) {
                out_steps[2 * k] = (int32_t)(j - 1);
                out_steps[2 * k + 1] = -1;
                k++; j--;
                continue;
            }
            uint8_t o = stt == 0 ? (uint8_t)cell_u8(st.op, st.offs, W, r, j)
                                 : (uint8_t)cell_u8(st.op0, st.offs, W, r, j);
            int32_t v = order[r - 1];
            if (o == 0) {
                out_steps[2 * k] = (int32_t)(j - 1);
                out_steps[2 * k + 1] = v;
                k++;
                r = cell(st.node0, st.offs, W, r, j, -2);
                j--;
                stt = 0;
            } else if (o == 1 || o == 3) {
                int32_t target = o == 1
                    ? cell(st.orig1, st.offs, W, r, j, 0)
                    : cell(st.orig2, st.offs, W, r, j, 0);
                while (j > target) {
                    out_steps[2 * k] = (int32_t)(j - 1);
                    out_steps[2 * k + 1] = -1;
                    k++; j--;
                }
                stt = 1;
            } else {
                stt = o == 2 ? 2 : 3;
            }
        } else {
            int32_t oo = stt == 2 ? pp.o1 : pp.o2;
            int32_t ee = stt == 2 ? pp.e1 : pp.e2;
            const std::vector<int32_t>& dmat = stt == 2 ? st.d1 : st.d2;
            int32_t v = order[r - 1];
            out_steps[2 * k] = -1;
            out_steps[2 * k + 1] = v;
            k++;
            int32_t target = cell(dmat, st.offs, W, r, j);
            int64_t nxt_r = -1;
            bool nxt_ext = false;
            const auto& ps = g.preds[v];
            int64_t np = ps.empty() ? 1 : (int64_t)ps.size();
            for (int64_t p = 0; p < np; p++) {  // first max, forward order
                int64_t pr = ps.empty() ? 0 : rank[ps[p]] + 1;
                int32_t c_open = cell(st.score, st.offs, W, pr, j)
                    - (oo + ee);
                int32_t c_ext = cell(dmat, st.offs, W, pr, j) - ee;
                if (std::max(c_open, c_ext) == target) {
                    nxt_r = pr;
                    nxt_ext = c_ext > c_open;  // open wins ties
                    break;
                }
            }
            if (nxt_r < 0) return -1;  // deletion traceback lost
            r = nxt_r;
            if (!nxt_ext) stt = 0;
        }
    }
    // emitted in traceback order; flip to forward (PoaGraph.align's
    // path.reverse())
    for (int64_t i = 0, jj = k - 1; i < jj; i++, jj--) {
        std::swap(out_steps[2 * i], out_steps[2 * jj]);
        std::swap(out_steps[2 * i + 1], out_steps[2 * jj + 1]);
    }
    return k;
}

// ------------------------------------------------------------ apply path

// Thread query q into the graph along the path — PoaGraph.apply_path
static void apply_path(Graph& g, const uint8_t* q,
                       const int32_t* steps, int64_t k) {
    int32_t prev = -1;
    for (int64_t i = 0; i < k; i++) {
        int32_t qi = steps[2 * i], node = steps[2 * i + 1];
        if (qi == -1) continue;  // deletion: no base, no edge
        int32_t cur;
        if (node >= 0 && g.base[node] == (int32_t)q[qi]) cur = node;
        else cur = g.add_node(q[qi]);
        if (prev >= 0) {
            g.add_edge(prev, cur);
        } else {
            if (std::find(g.starts.begin(), g.starts.end(), cur)
                    == g.starts.end())
                g.starts.push_back(cur);
        }
        prev = cur;
    }
}

// ------------------------------------------------------------- consensus

// Heaviest-bundle path — PoaGraph.consensus (strict > replacement, first
// max end node in topo order)
static int64_t consensus(const Graph& g, uint8_t* out) {
    std::vector<int32_t> order;
    g.topo_order(order);
    int64_t n = order.size();
    if (!n) return 0;
    std::vector<int64_t> best(g.base.size(), 0);
    std::vector<int32_t> back(g.base.size(), -1);
    for (int32_t v : order) {
        for (size_t c = 0; c < g.preds[v].size(); c++) {
            int32_t u = g.preds[v][c];
            // edge weight lives on u's succ list
            int64_t w = 0;
            for (size_t s = 0; s < g.succs[u].size(); s++)
                if (g.succs[u][s] == v) { w = g.succ_w[u][s]; break; }
            int64_t cand = best[u] + w;
            if (cand > best[v]) { best[v] = cand; back[v] = u; }
        }
    }
    int32_t end = order[0];
    int64_t bv = best[end];
    for (int64_t i = 1; i < n; i++)     // first max in topo order
        if (best[order[i]] > bv) { bv = best[order[i]]; end = order[i]; }
    std::vector<int32_t> outv;
    outv.push_back(end);
    while (back[outv.back()] >= 0) outv.push_back(back[outv.back()]);
    std::reverse(outv.begin(), outv.end());
    for (size_t i = 0; i < outv.size(); i++)
        out[i] = (uint8_t)g.base[outv[i]];
    return (int64_t)outv.size();
}

// ------------------------------------------------------------ threads

// The threads a call over n independent graphs runs on when given
// n_threads: one a graph at most, and 1 (the serial loop) for a single
// graph or thread.
static int32_t stage_threads(int64_t n, int32_t n_threads) {
    if (n_threads <= 1 || n < 2) return 1;
    return n < n_threads ? (int32_t)n : n_threads;
}

// Worker threads for a run of chunk calls, up to max_threads a call with
// the caller's: started when a call first needs them, parked between
// calls, joined when the pool is freed. Starting a thread costs up to a
// millisecond on some hosts, against a few hundred microseconds of work a
// graph, so a chunk call does not start its own. A pool serves one
// caller at a time and lives inside one round loop: none of its threads
// is alive when the pipeline forks.
struct StagePool {
    int32_t max_threads;
    std::vector<std::thread> workers;
    std::mutex m;
    std::condition_variable wake, done;
    uint64_t generation = 0;
    int32_t want = 0, pending = 0;
    bool stop = false;
    const std::function<void()>* task = nullptr;

    explicit StagePool(int32_t threads) : max_threads(threads) {}

    ~StagePool() {
        {
            std::lock_guard<std::mutex> lk(m);
            stop = true;
        }
        wake.notify_all();
        for (auto& th : workers) th.join();
    }

    // worker w takes part in the calls that want more than w workers
    void loop(int32_t w, uint64_t seen) {
        std::unique_lock<std::mutex> lk(m);
        for (;;) {
            wake.wait(lk, [&] { return stop || generation != seen; });
            if (stop) return;
            seen = generation;
            if (w >= want) continue;
            lk.unlock();
            (*task)();
            lk.lock();
            if (--pending == 0) done.notify_one();
        }
    }

    // fn(i) for every i < n, each i claimed by the next free thread, on
    // stage_threads(n, max_threads) threads; returns that count
    template <class Fn>
    int32_t run(int64_t n, Fn fn) {
        const int32_t nthr = stage_threads(n, max_threads);
        std::atomic<int64_t> next{0};
        const std::function<void()> claim = [&]() {
            for (int64_t i; (i = next.fetch_add(1)) < n;) fn(i);
        };
        if (nthr == 1) {
            claim();
            return 1;
        }
        {
            std::lock_guard<std::mutex> lk(m);
            while ((int32_t)workers.size() < nthr - 1) {
                const int32_t w = (int32_t)workers.size();
                const uint64_t seen = generation;
                workers.emplace_back([this, w, seen] { loop(w, seen); });
            }
            task = &claim;
            want = pending = nthr - 1;
            generation++;
        }
        wake.notify_all();
        claim();
        std::unique_lock<std::mutex> lk(m);
        done.wait(lk, [&] { return pending == 0; });
        return nthr;
    }
};

// fn(i) for every i < n: on `pool`'s threads, or the serial loop without
// one. Returns the thread count.
template <class Fn>
static int32_t for_each_problem(int64_t n, void* pool, Fn fn) {
    if (pool) return ((StagePool*)pool)->run(n, fn);
    for (int64_t i = 0; i < n; i++) fn(i);
    return 1;
}

}  // namespace

extern "C" {

// Consensus of n_seqs oriented reads (concatenated codes + lengths):
// graph from read 0, reads 1.. threaded sequentially (PoaGraph.add_read
// order). Writes consensus codes to `out` (caller sizes it to total
// input length + 1); returns its length, or -1 on internal error.
int64_t poa_consensus_c(const uint8_t* seqs, const int64_t* seq_lens,
                        int64_t n_seqs,
                        int32_t match, int32_t mismatch,
                        int32_t o1, int32_t e1, int32_t o2, int32_t e2,
                        int32_t band, int32_t adaptive,
                        uint8_t* out) {
    if (n_seqs <= 0) return 0;
    Params pp{match, mismatch, o1, e1, o2, e2, band, adaptive};
    Graph g(seqs, seq_lens[0]);
    const uint8_t* p = seqs + seq_lens[0];
    DpState st;
    std::vector<int32_t> order, rank, steps;
    for (int64_t s = 1; s < n_seqs; s++) {
        int64_t L = seq_lens[s];
        g.topo_order(order);
        rank.assign(g.base.size(), -1);
        for (size_t r = 0; r < order.size(); r++) rank[order[r]] = (int32_t)r;
        steps.resize(2 * (order.size() + L + 2));
        int64_t k = align_path(g, order, rank, p, L, pp, st, steps.data());
        if (k < 0) return -1;
        apply_path(g, p, steps.data(), k);
        p += L;
    }
    return consensus(g, out);
}

// ---------------------------------------------------------------------
// Handle-based graph API for the DEVICE consensus path (poa/kernels.py
// poa_consensus_batch): the device kernel does the DP, but the per-round
// host staging — topo order, rank-space arrays, applying the traceback
// path, the final heaviest-bundle consensus — was Python-loop-bound
// (~40% of the device path's wall). These wrappers keep the growing
// graph in C++ between rounds; graph semantics are the same Graph/
// apply_path/consensus used by poa_consensus_c (bit-identical to
// PoaGraph, tests/test_poa.py).

struct GraphHandle {
    Graph g;
    std::vector<int32_t> order;   // topo order of the LAST arrays call
    GraphHandle(const uint8_t* seq, int64_t n) : g(seq, n) {}
};

void* poa_graph_new_c(const uint8_t* seq, int64_t n) {
    return new GraphHandle(seq, n);
}

void poa_graph_free_c(void* h) { delete (GraphHandle*)h; }

int64_t poa_graph_nodes_c(void* h) {
    return (int64_t)((GraphHandle*)h)->g.base.size();
}

// Rank-space arrays for the device kernel (kernels.graph_arrays' C twin):
// out_base (n_cap) int32, out_preds (n_cap, p_cap) int32 holding pred
// rank + 1 (0 = virtual source) and -1 out to p_cap, out_ends (n_cap)
// uint8, each written on rows 0..n-1 only. Caches the topo order for
// apply_steps and apply_runs. Returns the node count n, or -1 when
// n_cap/p_cap are too small.
static int64_t graph_arrays(GraphHandle* gh, int64_t n_cap,
                            int64_t p_cap, int32_t* out_base,
                            int32_t* out_preds, uint8_t* out_ends) {
    const Graph& g = gh->g;
    const int64_t n = (int64_t)g.base.size();
    if (n > n_cap || (int64_t)g.maxp > p_cap) return -1;
    std::vector<int32_t> rank(n);
    // a node's row is written as it leaves the topo queue, its
    // predecessors' ranks already known
    g.topo_visit(gh->order, [&](int32_t v, int64_t r) {
        rank[v] = (int32_t)r;
        out_base[r] = g.base[v];
        const auto& ps = g.preds[v];
        int32_t* row = out_preds + r * p_cap;
        int64_t c = 0;
        if (ps.empty()) row[c++] = 0;
        for (int32_t u : ps) row[c++] = rank[u] + 1;
        for (; c < p_cap; c++) row[c] = -1;
        out_ends[r] = g.succs[v].empty() ? 1 : 0;
    });
    return n;
}

// A device walk's steps back into the graph: buf holds (qi, rank) int32
// pairs in REVERSE order (the kernel's emission order), first k entries;
// ranks resolve through the topo order cached by the LAST
// graph_arrays call (the same order the kernel consumed).
static void apply_steps(GraphHandle* gh, const uint8_t* q,
                        const int32_t* buf, int64_t k) {
    std::vector<int32_t> steps(2 * k);
    for (int64_t i = 0; i < k; i++) {
        steps[2 * i] = buf[2 * (k - 1 - i)];
        int32_t rk = buf[2 * (k - 1 - i) + 1];
        steps[2 * i + 1] = rk >= 0 ? gh->order[rk] : -1;
    }
    apply_path(gh->g, q, steps.data(), k);
}

// A run-compressed device traceback (poa/pallas_kernel.py reverse-sweep
// records, EMISSION order end->start) back into the graph:
//   rec0 = qi_hi | type << 16, rec1 = qi_lo | (rank + 2) << 16
//   type 0 diag (one (qi_hi, rank) step), 1 del ((-1, rank)),
//   2 insertion run ((qi, -1) for qi_lo..qi_hi ascending in forward
//   order). Expands to exactly the XLA walk's step sequence, then
//   threads the query like apply_steps.
static void apply_runs(GraphHandle* gh, const uint8_t* q,
                       const int32_t* recs, int64_t k) {
    std::vector<int32_t> steps;
    steps.reserve(4 * k);
    for (int64_t i = k - 1; i >= 0; i--) {
        int32_t rec0 = recs[2 * i], rec1 = recs[2 * i + 1];
        int32_t type = (rec0 >> 16) & 3;
        int32_t qi_hi = rec0 & 0xFFFF;
        int32_t qi_lo = rec1 & 0xFFFF;
        int32_t rank = (rec1 >> 16) - 2;
        if (type == 2) {
            for (int32_t qi = qi_lo; qi <= qi_hi; qi++) {
                steps.push_back(qi);
                steps.push_back(-1);
            }
        } else {
            steps.push_back(type == 0 ? qi_hi : -1);
            steps.push_back(rank >= 0 ? gh->order[rank] : -1);
        }
    }
    apply_path(gh->g, q, steps.data(), (int64_t)steps.size() / 2);
}

int64_t poa_graph_consensus_handle_c(void* h, uint8_t* out) {
    return consensus(((GraphHandle*)h)->g, out);
}

// ---------------------------------------------------------------------
// A chunk of the device round loop at once: its problems' staging and
// their paths applied, one native call each, the problems split over a
// StagePool's threads. Graphs are independent handles, so a thread
// claims the next problem and touches that graph alone: each result is
// the serial loop's, whatever the thread count. A chunk's handles are
// distinct.

// A StagePool of up to n_threads threads a call, the caller's among them
// (none started yet).
void* poa_stage_pool_new_c(int32_t n_threads) {
    return new StagePool(n_threads);
}

// Joins the pool's threads and frees it.
void poa_stage_pool_free_c(void* pool) { delete (StagePool*)pool; }

// Stages a chunk of n problems for the device forward. Problem i is graph
// handles[i] against the query codes reads[q_start[i] .. + q_len[i]) at
// band half-width band_in[i]; its rows of the chunk's arrays (caps n_cap,
// p_cap, l_cap) are written as graph_arrays writes them: base,
// preds and ends on rows 0..nn-1, nn[i] the node count, qq[i, 0..ql-1]
// the query as int32, ql[i], band[i]. Rows past nn and query columns past
// ql are not written. Caches each graph's topo order for
// poa_graphs_apply_c. On `pool`'s threads (NULL: the serial loop).
// Returns the thread count, or -1 when a graph outgrows n_cap or p_cap,
// or a query l_cap.
int32_t poa_graphs_stage_c(void* const* handles, int64_t n,
                           const uint8_t* reads, const int64_t* q_start,
                           const int64_t* q_len, const int32_t* band_in,
                           int64_t n_cap, int64_t p_cap, int64_t l_cap,
                           int32_t* base, int32_t* preds, uint8_t* ends,
                           int32_t* nn, int32_t* qq, int32_t* ql,
                           int32_t* band, void* pool) {
    std::atomic<bool> bad{false};
    int32_t nthr = for_each_problem(n, pool, [&](int64_t i) {
        int64_t nodes = graph_arrays(
            (GraphHandle*)handles[i], n_cap, p_cap, base + i * n_cap,
            preds + i * n_cap * p_cap, ends + i * n_cap);
        const int64_t len = q_len[i];
        if (nodes < 0 || len > l_cap) {
            bad.store(true);
            return;
        }
        nn[i] = (int32_t)nodes;
        const uint8_t* q = reads + q_start[i];
        int32_t* row = qq + i * l_cap;
        for (int64_t j = 0; j < len; j++) row[j] = q[j];
        ql[i] = (int32_t)len;
        band[i] = band_in[i];
    });
    return bad.load() ? -1 : nthr;
}

// Threads each problem's query (as poa_graphs_stage_c takes it) along its
// walk output: problem i's counts[i] entries start at walk + i * stride
// (int32 words), reverse-order (qi, rank) steps as apply_steps takes
// them, or with runs != 0 records as apply_runs does.
// Ranks resolve through the topo order of the last staging call. On
// `pool`'s threads (NULL: the serial loop); returns the thread count.
int32_t poa_graphs_apply_c(void* const* handles, int64_t n,
                           const uint8_t* reads, const int64_t* q_start,
                           const int32_t* walk, int64_t stride,
                           const int32_t* counts, int32_t runs,
                           void* pool) {
    return for_each_problem(n, pool, [&](int64_t i) {
        GraphHandle* gh = (GraphHandle*)handles[i];
        const int32_t* w = walk + i * stride;
        if (runs) apply_runs(gh, reads + q_start[i], w, counts[i]);
        else apply_steps(gh, reads + q_start[i], w, counts[i]);
    });
}

// Node counts and the most predecessors of any node (at least 1) of n
// graphs: a round's caps.
void poa_graphs_sizes_c(void* const* handles, int64_t n, int64_t* nodes,
                        int64_t* maxp) {
    for (int64_t i = 0; i < n; i++) {
        const Graph& g = ((GraphHandle*)handles[i])->g;
        nodes[i] = (int64_t)g.base.size();
        maxp[i] = (int64_t)g.maxp;
    }
}

// Single alignment against an externally-described graph (rank space:
// base codes per rank, CSR predecessor ranks+1 with 0 = virtual source,
// is_end flags) — the parity-test entry. Writes forward-order
// (qi, rank) pairs (rank -1 = insertion, qi -1 = deletion where the pair
// carries the RANK, converted to node ids by the caller); returns the
// step count, or -1 on internal error.
int64_t poa_align_c(const int32_t* base_r, int64_t n_nodes,
                    const int32_t* preds_flat, const int64_t* preds_off,
                    const uint8_t* is_end,
                    const uint8_t* q, int64_t qlen,
                    int32_t match, int32_t mismatch,
                    int32_t o1, int32_t e1, int32_t o2, int32_t e2,
                    int32_t band, int32_t adaptive,
                    int32_t* out_steps) {
    // rebuild a Graph in rank space so align_path's pred iteration and
    // end-node detection see the same structure
    Graph g(nullptr, 0);
    g.base.resize(n_nodes);
    g.preds.assign(n_nodes, {});
    g.succs.assign(n_nodes, {});
    g.succ_w.assign(n_nodes, {});
    for (int64_t r = 0; r < n_nodes; r++) {
        g.base[r] = base_r[r];
        for (int64_t c = preds_off[r]; c < preds_off[r + 1]; c++) {
            int32_t pr = preds_flat[c];  // rank + 1; 0 = virtual source
            if (pr > 0) {
                g.preds[r].push_back(pr - 1);
                g.succs[pr - 1].push_back((int32_t)r);
                g.succ_w[pr - 1].push_back(1);
            }
        }
        // mark real end nodes by giving non-ends a phantom successor? No:
        // succs is already populated above by construction order; is_end
        // flags override below.
    }
    // is_end: align_path checks g.succs[v].empty(); patch nodes flagged
    // not-end but with empty succs (cannot happen: succs derived from
    // preds covers every edge) — and nodes flagged end always have empty
    // succs in a rank-space DAG, so no patching is needed.
    (void)is_end;
    Params pp{match, mismatch, o1, e1, o2, e2, band, adaptive};
    std::vector<int32_t> order(n_nodes), rank(n_nodes);
    for (int64_t r = 0; r < n_nodes; r++) { order[r] = (int32_t)r; rank[r] = (int32_t)r; }
    DpState st;
    return align_path(g, order, rank, q, qlen, pp, st, out_steps);
}

}  // extern "C"
