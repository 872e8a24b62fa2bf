// Sequence-to-graph POA forward DP for module D's consensus: B (graph, query)
// problems, rows in topological-rank order, convex dual-affine gaps, static or
// score-following adaptive band.
//
// Replaces mandalorion_tpu/poa/pallas_kernel.py `_poa_fwd_kernel` (the Pallas
// TPU kernel, adaptive band, bounded predecessor distance) and
// mandalorion_tpu/poa/kernels.py `_align_rows` (the XLA row loop that served
// every other case): one kernel for every graph and both band modes. The
// output is the walk's contract, per problem b and matrix row t in 0..nn[b]
// (row 0 is the boundary row, row t is rank t-1), W stored columns starting at
// absolute query column offs[b][t]:
//   hpack = op | op0 << 3 | (node0 + 2) << 6,  opack = orig1 | orig2 << 16,
//   d1p / d2p = (pred_row << 1) | took_extension,
//   endcol = H at absolute column ql[b] (NEG when outside the window).
// The caller zero-fills the packed matrices and fills endcol with NEG; rows
// past nn[b] are left so.
//
// Layout: one block per problem; the rank rows are a loop inside the block
// (the Pallas grid's sequential axis). The three state rows of every rank (H,
// D1, D2) live in a scratch tensor in device memory, (3, B, n_cap+1, W) int32,
// so a predecessor row is read from there whatever its distance: the TPU
// kernel's K-deep on-chip ring, its row-0 special case and the host gate on
// the back-distance have no counterpart. A row is processed in tiles of
// kThreads columns, one column a thread, left to right, so W may be any
// multiple of kThreads (static band and long reads reach W = 65536).
//
// Per row and tile: for each predecessor in declared order a windowed read of
// its H, D1, D2 rows at the shift off - 1 - off_pred (NEG outside its window),
// strict-> first max for the diagonal and for both deletion states, the band
// mask, H = diag >= D1 >= D2 on ties; then both insertion tiers as inclusive
// prefix maxima of row + e*j carried from tile to tile, and a second prefix
// maximum for the origin column of the running maximum. Each pair of scans is
// one block scan of two values (warp shuffles, one shared slot per warp).
// The row's first-max column feeds the adaptive band of its successors.
//
// What bounds it on the H100: the row loop is serial, and a row is three
// block barriers plus a chain of dependent loads from L2 (predecessor list ->
// predecessor offset -> predecessor rows), so a row costs latency, not
// bandwidth or arithmetic: the bytes a row moves (7 int32 per cell written,
// about 4 per cell and predecessor read) are small. The design keeps one
// small block per problem so that many problems are in flight on the 132 SMs;
// staging predecessor rows in shared memory and several problems a block are
// left to later work.
//
// Exact int32 arithmetic: NEG = -10^9; values below NEG arise (NEG - (o+e),
// NEG + e*(off-1), NEG - 1) and are compared with >, never clamped.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNeg = -1000000000;  // the reference's NEG
constexpr unsigned kFull = 0xffffffffu;

struct Scoring {
  int match, mismatch, o1, e1, o2, e2, band, adaptive;
};

// (value, column) order of a row's first maximum: larger value, then lower
// column.
__device__ __forceinline__ bool beats(int v, int a, int bv, int ba) {
  return v > bv || (v == bv && a < ba);
}

// Inclusive prefix maximum of (a, b) over the block's kThreads columns, with
// the carries of the tiles to the left folded in. On return a, b hold the
// inclusive values, ea, eb the exclusive ones (the left neighbour's inclusive
// value; the carry for thread 0), and carry_a, carry_b the inclusive value of
// the last column. s_a, s_b: kWarps ints of shared memory each, not in use by
// any thread since the previous barrier. Contains one __syncthreads().
__device__ __forceinline__ void tile_scan2(int& a, int& b, int& ea, int& eb,
                                           int& carry_a, int& carry_b,
                                           int* s_a, int* s_b, int lane,
                                           int warp) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int oa = __shfl_up_sync(kFull, a, d);
    const int ob = __shfl_up_sync(kFull, b, d);
    if (lane >= d) {
      a = max(a, oa);
      b = max(b, ob);
    }
  }
  ea = __shfl_up_sync(kFull, a, 1);
  eb = __shfl_up_sync(kFull, b, 1);
  if (lane == 0) {
    ea = INT_MIN;
    eb = INT_MIN;
  }
  if (lane == 31) {
    s_a[warp] = a;
    s_b[warp] = b;
  }
  __syncthreads();
  int pa = carry_a, pb = carry_b;  // everything left of this warp
  int ta = carry_a, tb = carry_b;  // the whole tile
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int va = s_a[w], vb = s_b[w];
    if (w < warp) {
      pa = max(pa, va);
      pb = max(pb, vb);
    }
    ta = max(ta, va);
    tb = max(tb, vb);
  }
  a = max(a, pa);
  b = max(b, pb);
  ea = max(ea, pa);
  eb = max(eb, pb);
  carry_a = ta;
  carry_b = tb;
}

__global__ void __launch_bounds__(kThreads) poa_fwd_kernel(
    const int32_t* __restrict__ base, const int32_t* __restrict__ preds,
    const int32_t* __restrict__ nn, const int32_t* __restrict__ qq,
    const int32_t* __restrict__ ql, int32_t* __restrict__ hpack,
    int32_t* __restrict__ opack, int32_t* __restrict__ d1p,
    int32_t* __restrict__ d2p, int32_t* offs, int32_t* __restrict__ endcol,
    int32_t* state, int32_t* bestc, int64_t n_problems, int n_cap, int p_cap,
    int l_cap, int W, Scoring sc) {
  __shared__ int s_acc1[kWarps], s_acc2[kWarps];
  __shared__ int s_org1[kWarps], s_org2[kWarps];
  __shared__ int s_best_v[kWarps], s_best_a[kWarps];

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = nn[b], qlen = ql[b];
  const int64_t rows = static_cast<int64_t>(n_cap) + 1;
  const int64_t mat = rows * W;  // cells of one problem
  // H, D1, D2 state rows of this problem
  int32_t* H = state + b * mat;
  int32_t* D1 = H + n_problems * mat;
  int32_t* D2 = D1 + n_problems * mat;
  int32_t* hp = hpack + b * mat;
  int32_t* op = opack + b * mat;
  int32_t* p1 = d1p + b * mat;
  int32_t* p2 = d2p + b * mat;
  int32_t* off_row = offs + b * rows;
  int32_t* best_row = bestc + b * rows;
  int32_t* end_row = endcol + b * rows;
  const int32_t* q = qq + b * static_cast<int64_t>(l_cap);
  const int o1 = sc.o1, e1 = sc.e1, o2 = sc.o2, e2 = sc.e2;

  const int eff = sc.adaptive ? sc.band : max(sc.band, abs(n - qlen) + 16);
  const int off_max = max(0, qlen + 1 - W);

  // row 0 (window offset 0): the convex insertion boundary, band-local
  for (int e = tid; e < W; e += kThreads) {
    int g0 = e == 0 ? 0 : -min(o1 + e1 * e, o2 + e2 * e);
    if (e > min(qlen, eff)) g0 = kNeg;
    H[e] = g0;
    D1[e] = kNeg;
    D2[e] = kNeg;
    hp[e] = 1;  // op 1, op0 0, node0 -2
    if (e == qlen) end_row[0] = max(g0, kNeg);
  }
  if (tid == 0) {
    off_row[0] = 0;
    best_row[0] = 0;
  }
  __syncthreads();

  for (int r = 1; r <= n; ++r) {
    const int base_v = base[b * n_cap + (r - 1)];
    const int32_t* pr_row = preds + (b * n_cap + (r - 1)) * p_cap;

    int center;
    if (sc.adaptive) {
      // one past the first-max column of the best predecessor row
      int c = kNeg;
      for (int p = 0; p < p_cap; ++p) {
        const int pr = pr_row[p];
        if (pr >= 0) c = max(c, best_row[pr]);
      }
      center = c + 1;
    } else {
      center = static_cast<int>(static_cast<int64_t>(r) * qlen / max(n, 1));
    }
    const int off = min(max(center - eff, 0), off_max);
    const int j0 = max(0, center - eff);
    const int j1 = min(qlen, center + eff);
    if (tid == 0) off_row[r] = off;

    // prefix-max carries from the masked columns < off: their values are
    // NEG + e*j (monotone), so the carry into the window is NEG + e*(off-1)
    // with origin off-1 (e > 0) or 0 (e == 0)
    int acc_c1 = off > 0 ? kNeg + e1 * (off - 1) : kNeg - 1;
    int acc_c2 = off > 0 ? kNeg + e2 * (off - 1) : kNeg - 1;
    int org_c1 = off > 0 ? (e1 > 0 ? off - 1 : 0) : -1;
    int org_c2 = off > 0 ? (e2 > 0 ? off - 1 : 0) : -1;
    int best_v = INT_MIN, best_a = INT_MAX;  // the row's first maximum

    const int64_t row_at = static_cast<int64_t>(r) * W;
    for (int t0 = 0; t0 < W; t0 += kThreads) {
      const int e = t0 + tid;
      const int jabs = off + e;

      // predecessor reads, declared order, strict > (first max wins)
      int best_diag = kNeg, rank_diag = -2;
      int d1 = kNeg, d2 = kNeg, d1_ptr = 0, d2_ptr = 0;
      for (int p = 0; p < p_cap; ++p) {
        const int pr = pr_row[p];
        if (pr < 0) continue;  // padding: every window value would be NEG
        const int64_t at = static_cast<int64_t>(pr) * W;
        const int rel = off - 1 - off_row[pr] + e;  // column jabs-1 there
        const bool ok_d = rel >= 0 && rel < W && jabs >= 1;
        const bool ok_n = rel + 1 >= 0 && rel + 1 < W;
        const int w_diag = ok_d ? H[at + rel] : kNeg;
        const int w_h = ok_n ? H[at + rel + 1] : kNeg;
        const int w_d1 = ok_n ? D1[at + rel + 1] : kNeg;
        const int w_d2 = ok_n ? D2[at + rel + 1] : kNeg;
        if (w_diag > best_diag) {
          best_diag = w_diag;
          rank_diag = pr;
        }
        const int c1_open = w_h - (o1 + e1), c1_ext = w_d1 - e1;
        const int c1 = max(c1_open, c1_ext);
        if (c1 > d1) {
          d1 = c1;
          d1_ptr = (pr << 1) | (c1_ext > c1_open ? 1 : 0);
        }
        const int c2_open = w_h - (o2 + e2), c2_ext = w_d2 - e2;
        const int c2 = max(c2_open, c2_ext);
        if (c2 > d2) {
          d2 = c2;
          d2_ptr = (pr << 1) | (c2_ext > c2_open ? 1 : 0);
        }
      }
      const bool masked = jabs < j0 || jabs > j1;
      if (masked) {
        d1 = kNeg;
        d2 = kNeg;
      }

      // H before insertions: diag >= D1 >= D2 on ties. The query base that
      // the diagonal into column j consumes is q[j-1]; past the query it
      // reads as 0, as the reference's zero-padded copy does.
      const int qv = (jabs >= 1 && jabs - 1 < l_cap) ? q[jabs - 1] : 0;
      const int sub = qv == base_v ? sc.match : -sc.mismatch;
      int row = jabs == 0 ? kNeg : best_diag + sub;
      const int rown = jabs == 0 ? -2 : rank_diag;
      int rowo = 0;
      if (d1 > row) {
        row = d1;
        rowo = 2;
      }
      if (d2 > row) {
        row = d2;
        rowo = 4;
      }
      if (masked) row = kNeg;  // insertions open from in-band cells only

      // insertion tiers: acc = running max of row + e*j
      const int v1 = row + e1 * jabs, v2 = row + e2 * jabs;
      int acc1 = v1, acc2 = v2, prev1, prev2;
      tile_scan2(acc1, acc2, prev1, prev2, acc_c1, acc_c2, s_acc1, s_acc2,
                 lane, warp);
      int fin = row, fino = rowo;
      const int ins1 = acc1 - o1 - e1 * jabs;
      const bool m1 = ins1 > fin;
      if (m1) {
        fin = ins1;
        fino = 1;
      }
      const int ins2 = acc2 - o2 - e2 * jabs;
      const bool m2 = ins2 > fin;
      if (m2) {
        fin = ins2;
        fino = 3;
      }
      if (masked) fin = kNeg;

      H[row_at + e] = fin;
      D1[row_at + e] = d1;
      D2[row_at + e] = d2;
      if (jabs == qlen) end_row[r] = max(fin, kNeg);

      // the tile's first maximum, one slot per warp
      int tv = fin, ta = e;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const int ov = __shfl_down_sync(kFull, tv, d);
        const int oa = __shfl_down_sync(kFull, ta, d);
        if (beats(ov, oa, tv, ta)) {
          tv = ov;
          ta = oa;
        }
      }
      if (lane == 0) {
        s_best_v[warp] = tv;
        s_best_a[warp] = ta;
      }

      // origin column of each tier's running maximum
      int org1 = v1 > prev1 ? jabs : -1, org2 = v2 > prev2 ? jabs : -1;
      int unused1, unused2;
      tile_scan2(org1, org2, unused1, unused2, org_c1, org_c2, s_org1,
                 s_org2, lane, warp);
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (beats(s_best_v[w], s_best_a[w], best_v, best_a)) {
          best_v = s_best_v[w];
          best_a = s_best_a[w];
        }

      const unsigned orig1 = m1 ? static_cast<unsigned>(org1) : 0u;
      const unsigned orig2 = m2 ? static_cast<unsigned>(org2) : 0u;
      hp[row_at + e] = fino | (rowo << 3) | ((rown + 2) << 6);
      op[row_at + e] = static_cast<int32_t>(orig1 | (orig2 << 16));
      p1[row_at + e] = d1_ptr;
      p2[row_at + e] = d2_ptr;
    }
    // first-max column of the stored row; rows that are all <= NEG pin to 0
    if (tid == 0) best_row[r] = best_v <= kNeg ? 0 : off + best_a;
    __syncthreads();  // this row's state, offset and best column are visible
  }
}

}  // namespace

// Launch on `stream` for n problems. The caller allocates every buffer:
// hpack, opack, d1p, d2p (n, n_cap+1, W) zero-filled, offs (n, n_cap+1)
// zero-filled, endcol (n, n_cap+1) filled with NEG, state (3, n, n_cap+1, W)
// and bestc (n, n_cap+1) uninitialised scratch. W is a multiple of 256.
// Returns cudaGetLastError() after the launch.
extern "C" int mando_poa_fwd(const void* base, const void* preds,
                             const void* nn, const void* qq, const void* ql,
                             void* hpack, void* opack, void* d1p, void* d2p,
                             void* offs, void* endcol, void* state,
                             void* bestc, int64_t n, int n_cap, int p_cap,
                             int l_cap, int W, int match, int mismatch,
                             int gap_open, int gap_extend, int gap_open2,
                             int gap_extend2, int band, int adaptive,
                             void* stream) {
  if (n > 0) {
    const Scoring sc{match,     mismatch,    gap_open, gap_extend,
                     gap_open2, gap_extend2, band,     adaptive};
    poa_fwd_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(base), static_cast<const int32_t*>(preds),
        static_cast<const int32_t*>(nn), static_cast<const int32_t*>(qq),
        static_cast<const int32_t*>(ql), static_cast<int32_t*>(hpack),
        static_cast<int32_t*>(opack), static_cast<int32_t*>(d1p),
        static_cast<int32_t*>(d2p), static_cast<int32_t*>(offs),
        static_cast<int32_t*>(endcol), static_cast<int32_t*>(state),
        static_cast<int32_t*>(bestc), n, n_cap, p_cap, l_cap, W, sc);
  }
  return static_cast<int>(cudaGetLastError());
}
