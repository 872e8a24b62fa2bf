// Sequence-to-graph POA forward DP for module D's consensus: B (graph, query)
// problems, rows in topological-rank order, convex dual-affine gaps, static or
// score-following adaptive band, the band half-width a per-problem input.
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
// Every cell of rows 0..nn[b] of all six outputs is written here; rows past
// nn[b] are never touched, so the caller need not fill anything.
//
// What bounds it on the H100: the rank rows of a problem are a serial chain
// (a row reads the rows of its predecessors, and the adaptive band waits for
// the whole row before it: its first maximum), and a row of 256 columns is
// far too little work for bandwidth or arithmetic to matter. A row costs the
// latency of what lies between one row and the next; the card is filled by
// running many problems side by side. What the design does about it:
//
// - A warp a problem (kWarps of them a block); no block barrier anywhere. A
//   lane owns kCols = 8 neighbouring columns of a tile of 256, so the prefix
//   maxima of the two insertion tiers are 8 steps in registers, one warp scan
//   by shuffles over the lanes' totals (value and origin column as a pair,
//   both tiers side by side), and the prefix applied; the row's first maximum
//   is two warp reductions. Rows are ordered by __syncwarp(). W > 256
//   (static band, long queries) is the same warp walking the row in tiles of
//   256, left to right, the scans' carries in registers.
// - The state rows (H, D1, D2) of the last `ring_rows` ranks, with their
//   window offsets and first-max columns, sit in a ring in shared memory
//   (16 rows at W = 256, as many cells at W up to 2048, none above). A
//   predecessor less than ring_rows back is read from there; one farther
//   back is read from the state scratch in device memory, (3, B, n_cap+1, W)
//   int32, which every row still writes (stores do not stall the loop). The
//   ring is a cache in front of the scratch: any predecessor distance is
//   served by the same code, there is no gate. A ring row keeps kGuard cells
//   of NEG on either side, so a read shifted by less than kGuard columns
//   (nearly all: the band moves about a column a row) checks no bounds; and
//   one word of padding every 32 cells, so that 32 lanes reading at a stride
//   of 8 hit 32 banks.
// - `base` and `preds` of the coming rows are copied into shared memory with
//   cp.async a batch of rows ahead (two buffers). A row's predecessor list
//   is read an entry a lane, with each predecessor's offset and best column,
//   and handed round by shuffles: the chain predecessor list -> predecessor's
//   offset and best column -> predecessor's rows never leaves the SM for a
//   predecessor in the ring, and padding entries cost nothing.
// - A problem ends at its own nn[b]: a short graph in a tall batch costs
//   nothing past its last row.
//
// One warp runs the whole row, well over a thousand operations, and much of
// the time one waits on the one before it (shared-memory reads, shuffles,
// reductions): PERF.md has the row's time by phase
// (tools/poa_kernel_phases.py). kWarps is 1 because the problems of a round
// are fewer than the card's SMs, and a block of 4 warps measured slower a
// problem (4 problems share an SM's load/store path; the same script);
// either way 3 or 4 problems fit an SM by their shared memory.
//
// Per row and tile: for each predecessor in declared order a windowed read of
// its H, D1, D2 rows at the shift off - 1 - off_pred (NEG outside its window),
// strict-> first max for the diagonal and for both deletion states, the band
// mask, H = diag >= D1 >= D2 on ties; then both insertion tiers as inclusive
// prefix maxima of row + e*j carried from tile to tile, each with the column
// that set it (the insertion's origin). The row's first-max column feeds the
// adaptive band of its successors.
//
// Exact int32 arithmetic: NEG = -10^9; values below NEG arise (NEG - (o+e),
// NEG + e*(off-1), NEG - 1) and are compared with >, never clamped.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 1;  // problems a block, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 8;            // neighbouring columns a lane
constexpr int kTile = 32 * kCols;   // columns a warp takes at once
constexpr int kRingCells = 16 * kTile;  // ring_rows * W at most
constexpr int kRingMax = 16;            // ring_rows at most (W = 256)
constexpr int kGuard = 16;  // NEG cells kept on either side of a ring row
constexpr int kPredWords = 64;  // predecessor entries staged a batch, at least
constexpr int kBatchMax = 32;    // rows staged a batch, at most
constexpr int kSmemMax = 232448;    // bytes a block may take on sm_90
constexpr int kNeg = -1000000000;   // the reference's NEG
constexpr unsigned kFull = 0xffffffffu;

struct Scoring {
  int match, mismatch, o1, e1, o2, e2, adaptive;
};

// What the launcher derives from W and p_cap, in int32 words a warp.
struct Layout {
  int ring_rows;   // power of two, or 0: no ring
  int batch_rows;  // rows of base and preds staged at once
  int pred_words;  // words of one preds buffer (>= batch_rows * p_cap)
  int warp_words;  // all of a warp's shared memory
};

// (value, column) order of a row's first maximum: larger value, then lower
// column.
__device__ __forceinline__ bool beats(int v, int a, int bv, int ba) {
  return v > bv || (v == bv && a < ba);
}

// A ring row: kGuard cells of NEG, the W stored columns, kGuard cells of NEG,
// with one word of padding every 32 cells. Position of stored column c (from
// -kGuard to W + kGuard - 1), and the words of a row.
__host__ __device__ __forceinline__ int ring_at(int c) {
  return c + kGuard + ((c + kGuard) >> 5);
}
__host__ __device__ __forceinline__ int ring_stride(int W) {
  return ring_at(W + kGuard - 1) + 1;
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Columns c0 .. c0+8 of a predecessor's H row and c0+1 .. c0+8 of its D1 and
// D2 rows, NEG outside the stored window [0, W). kRing: the rows are ring
// rows in shared memory, else rows of the state scratch.
template <bool kRing>
__device__ __forceinline__ void load_pred(const int32_t* h, const int32_t* d1,
                                          const int32_t* d2, int c0, int W,
                                          int (&h9)[kCols + 1],
                                          int (&v1)[kCols], int (&v2)[kCols]) {
#pragma unroll
  for (int i = 0; i <= kCols; ++i) {
    const int c = c0 + i;
    const bool ok = c >= 0 && c < W;
    const int at = kRing ? ring_at(c) : c;
    h9[i] = ok ? h[at] : kNeg;
    if (i >= 1) {
      v1[i - 1] = ok ? d1[at] : kNeg;
      v2[i - 1] = ok ? d2[at] : kNeg;
    }
  }
}

// The same from ring rows when every lane's nine columns lie between
// -kGuard and W + kGuard - 1: the guard cells hold the NEG, no lane checks.
__device__ __forceinline__ void load_pred_guarded(
    const int32_t* h, int stride, int c0, int (&h9)[kCols + 1],
    int (&v1)[kCols], int (&v2)[kCols]) {
  const int at0 = ring_at(c0);
  const int room = 32 - ((c0 + kGuard) & 31);  // cells before a padding word
#pragma unroll
  for (int i = 0; i <= kCols; ++i) {
    const int at = at0 + i + (i >= room ? 1 : 0);
    h9[i] = h[at];
    if (i >= 1) {
      v1[i - 1] = h[stride + at];
      v2[i - 1] = h[2 * stride + at];
    }
  }
}

// Running maxima of both insertion tiers along a tile's 256 columns, each
// with the column that set it: on entry v[t][i] is tier t's own value at the
// lane's column i (absolute column j0 + i); on return v[t][i] is the maximum
// over the carry and every column up to and including i, and org[t][i] the
// origin: the last column whose own value exceeded everything to its left,
// which is the first column that reached the maximum (the carry's origin
// where none did). One scan of (value, column) pairs under "the right one if
// it is larger, else the left one": 8 steps in registers, one warp scan over
// the lanes' totals, and the prefix applied; the two tiers go side by side so
// that their shuffles overlap. carry_v, carry_o come from the tiles (and the
// masked columns) to the left and leave including this tile.
__device__ __forceinline__ void tile_scan_first(int (&v)[2][kCols],
                                                int (&org)[2][kCols], int j0,
                                                int (&carry_v)[2],
                                                int (&carry_o)[2], int lane) {
  int sv[2], so[2];  // scan of the lanes' totals
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    org[t][0] = j0;
#pragma unroll
    for (int i = 1; i < kCols; ++i) {
      const bool up = v[t][i] > v[t][i - 1];
      org[t][i] = up ? j0 + i : org[t][i - 1];
      v[t][i] = up ? v[t][i] : v[t][i - 1];
    }
    sv[t] = v[t][kCols - 1];
    so[t] = org[t][kCols - 1];
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int ov[2], oo[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      ov[t] = __shfl_up_sync(kFull, sv[t], d);
      oo[t] = __shfl_up_sync(kFull, so[t], d);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (lane >= d && !(sv[t] > ov[t])) {
        sv[t] = ov[t];
        so[t] = oo[t];
      }
  }
  int pv[2], po[2], lv[2], lo[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    pv[t] = __shfl_up_sync(kFull, sv[t], 1);
    po[t] = __shfl_up_sync(kFull, so[t], 1);
    lv[t] = __shfl_sync(kFull, sv[t], 31);
    lo[t] = __shfl_sync(kFull, so[t], 31);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    // everything left of this lane: the lanes before it over the carry
    if (lane == 0 || !(pv[t] > carry_v[t])) {
      pv[t] = carry_v[t];
      po[t] = carry_o[t];
    }
    if (lv[t] > carry_v[t]) {
      carry_v[t] = lv[t];
      carry_o[t] = lo[t];
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const bool own = v[t][i] > pv[t];
      org[t][i] = own ? org[t][i] : po[t];
      v[t][i] = own ? v[t][i] : pv[t];
    }
  }
}

__device__ __forceinline__ void store8(int32_t* dst, const int (&v)[kCols]) {
  int4* d = reinterpret_cast<int4*>(dst);  // 32-byte aligned: 8 | column
  d[0] = make_int4(v[0], v[1], v[2], v[3]);
  d[1] = make_int4(v[4], v[5], v[6], v[7]);
}

__global__ void __launch_bounds__(kThreads) poa_fwd_kernel(
    const int32_t* __restrict__ base, const int32_t* __restrict__ preds,
    const int32_t* __restrict__ nn, const int32_t* __restrict__ qq,
    const int32_t* __restrict__ ql, const int32_t* __restrict__ band,
    int32_t* __restrict__ hpack, int32_t* __restrict__ opack,
    int32_t* __restrict__ d1p, int32_t* __restrict__ d2p, int32_t* offs,
    int32_t* __restrict__ endcol, int32_t* state, int32_t* bestc,
    int64_t n_problems, int n_cap, int p_cap, int l_cap, int W, Layout lay,
    Scoring sc) {
  extern __shared__ int32_t smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= n_problems) return;  // a whole warp: nothing below joins warps

  // this warp's shared memory
  const int ring_rows = lay.ring_rows;
  const int stride = ring_stride(W);
  int32_t* ring = smem + static_cast<size_t>(warp) * lay.warp_words;
  int32_t* ring_off = ring + 3 * ring_rows * stride;  // [kRingMax]
  int32_t* ring_best = ring_off + kRingMax;           // [kRingMax]
  int32_t* s_base = ring_best + kRingMax;             // [2][kBatchMax]
  int32_t* s_pred = s_base + 2 * kBatchMax;           // [2][pred_words]

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
  const int32_t* base_b = base + b * static_cast<int64_t>(n_cap);
  const int32_t* preds_b = preds + b * static_cast<int64_t>(n_cap) * p_cap;
  const int o1 = sc.o1, e1 = sc.e1, o2 = sc.o2, e2 = sc.e2;

  const int band_b = band[b];
  const int eff = sc.adaptive ? band_b : max(band_b, abs(n - qlen) + 16);
  const int off_max = max(0, qlen + 1 - W);

  // base and preds of matrix rows r0 .. r0 + batch_rows - 1 into buffer `to`
  auto stage = [&](int r0, int to) {
    const int cnt = min(lay.batch_rows, n - r0 + 1);
    const int32_t* src = preds_b + static_cast<int64_t>(r0 - 1) * p_cap;
    int32_t* dst = s_pred + to * lay.pred_words;
    for (int i = lane; i < cnt * p_cap; i += 32) cp_async4(dst + i, src + i);
    if (lane < cnt) cp_async4(s_base + to * kBatchMax + lane,
                              base_b + (r0 - 1) + lane);
  };
  if (n >= 1) stage(1, 0);

  // the guard cells of every ring row: NEG, never written again
  for (int i = lane; i < ring_rows * 3 * 2 * kGuard; i += 32) {
    const int cell = i % (2 * kGuard);
    ring[i / (2 * kGuard) * stride +
         ring_at(cell < kGuard ? cell - kGuard : W + cell - kGuard)] = kNeg;
  }

  // row 0 (window offset 0): the convex insertion boundary, band-local
  for (int e = lane; e < W; e += 32) {
    int g0 = e == 0 ? 0 : -min(o1 + e1 * e, o2 + e2 * e);
    if (e > min(qlen, eff)) g0 = kNeg;
    H[e] = g0;
    D1[e] = kNeg;
    D2[e] = kNeg;
    if (ring_rows) {
      ring[ring_at(e)] = g0;
      ring[stride + ring_at(e)] = kNeg;
      ring[2 * stride + ring_at(e)] = kNeg;
    }
    hp[e] = 1;  // op 1, op0 0, node0 -2
    op[e] = 0;
    p1[e] = 0;
    p2[e] = 0;
    if (e == qlen) end_row[0] = max(g0, kNeg);
  }
  if (lane == 0) {
    if (qlen >= W) end_row[0] = kNeg;
    off_row[0] = 0;
    best_row[0] = 0;
    ring_off[0] = 0;
    ring_best[0] = 0;
  }

  int buf = 0;
  for (int r0 = 1; r0 <= n; r0 += lay.batch_rows, buf ^= 1) {
    // this batch's lists have landed; the other buffer's rows are done
    cp_async_wait_all();
    __syncwarp();
    if (r0 + lay.batch_rows <= n) stage(r0 + lay.batch_rows, buf ^ 1);
    const int r_end = min(n, r0 + lay.batch_rows - 1);

    for (int r = r0; r <= r_end; ++r) {
      const int base_v = s_base[buf * kBatchMax + (r - r0)];
      const int32_t* pr_row = s_pred + buf * lay.pred_words + (r - r0) * p_cap;
      const int slot = r & (ring_rows - 1);  // unused without a ring

      // The predecessor list, an entry a lane (32 at a time), each with its
      // row's window offset and first-max column: -1, 0, NEG for padding.
      int my_pr, my_off, my_best, listed = -1;
      auto list_at = [&](int p0) {
        if (p0 == listed) return;  // the usual list has one part
        listed = p0;
        my_pr = p0 + lane < p_cap ? pr_row[p0 + lane] : -1;
        my_off = 0;
        my_best = kNeg;
        if (my_pr >= 0) {
          const bool near = r - my_pr < ring_rows;
          const int ps = my_pr & (ring_rows - 1);
          my_off = near ? ring_off[ps] : off_row[my_pr];
          my_best = near ? ring_best[ps] : best_row[my_pr];
        }
      };

      int center;
      if (sc.adaptive) {
        // one past the first-max column of the best predecessor row
        int c = kNeg;
        for (int p0 = 0; p0 < p_cap; p0 += 32) {
          list_at(p0);
          c = max(c, my_best);
        }
        center = __reduce_max_sync(kFull, c) + 1;
      } else {
        center = static_cast<int>(static_cast<int64_t>(r) * qlen / max(n, 1));
      }
      const int off = min(max(center - eff, 0), off_max);
      const int j0 = max(0, center - eff);
      const int j1 = min(qlen, center + eff);
      if (lane == 0) {
        off_row[r] = off;
        if (ring_rows) ring_off[slot] = off;  // row r - ring_rows: not read
        if (qlen < off || qlen >= off + W) end_row[r] = kNeg;
      }

      // prefix-max carries from the masked columns < off: their values are
      // NEG + e*j (monotone), so the carry into the window is NEG + e*(off-1)
      // with origin off-1 (e > 0) or 0 (e == 0)
      int acc_c[2] = {off > 0 ? kNeg + e1 * (off - 1) : kNeg - 1,
                      off > 0 ? kNeg + e2 * (off - 1) : kNeg - 1};
      int org_c[2] = {off > 0 ? (e1 > 0 ? off - 1 : 0) : -1,
                      off > 0 ? (e2 > 0 ? off - 1 : 0) : -1};
      int best_v = INT_MIN, best_a = INT_MAX;  // the row's first maximum

      const int64_t row_at = static_cast<int64_t>(r) * W;
      for (int t0 = 0; t0 < W; t0 += kTile) {
        const int e0 = t0 + lane * kCols;  // the lane's first stored column
        const int jabs0 = off + e0;

        // the query bases the diagonals into columns jabs0.. consume:
        // q[j-1]; past the query it reads as 0, as the reference's
        // zero-padded copy does
        int sub[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int jq = jabs0 + i - 1;
          const int qv = (jq >= 0 && jq < l_cap) ? __ldg(q + jq) : 0;
          sub[i] = qv == base_v ? sc.match : -sc.mismatch;
        }

        // predecessor reads, declared order, strict > (first max wins)
        int best_diag[kCols], rank_diag[kCols];
        int d1[kCols], d2[kCols], d1_ptr[kCols], d2_ptr[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          best_diag[i] = kNeg;
          rank_diag[i] = -2;
          d1[i] = kNeg;
          d2[i] = kNeg;
          d1_ptr[i] = 0;
          d2_ptr[i] = 0;
        }
        for (int p0 = 0; p0 < p_cap; p0 += 32) {
          list_at(p0);
          // padding is skipped: every window value would be NEG
          unsigned live = __ballot_sync(kFull, my_pr >= 0);
          while (live) {
            const int src = __ffs(live) - 1;
            live &= live - 1;
            const int pr = __shfl_sync(kFull, my_pr, src);
            // the lane's columns start at column shift + e0 of the
            // predecessor's window: absolute column jabs0 - 1
            const int shift = off - 1 - __shfl_sync(kFull, my_off, src);
            const int c0 = shift + e0;
            int h9[kCols + 1], w_d1[kCols], w_d2[kCols];
            if (r - pr < ring_rows) {
              const int32_t* row_h =
                  ring + (pr & (ring_rows - 1)) * 3 * stride;
              if (shift >= -kGuard && shift < kGuard)
                load_pred_guarded(row_h, stride, c0, h9, w_d1, w_d2);
              else
                load_pred<true>(row_h, row_h + stride, row_h + 2 * stride, c0,
                                W, h9, w_d1, w_d2);
            } else {
              const int64_t at = static_cast<int64_t>(pr) * W;
              load_pred<false>(H + at, D1 + at, D2 + at, c0, W, h9, w_d1, w_d2);
            }
#pragma unroll
            for (int i = 0; i < kCols; ++i) {
              // the diagonal at absolute column 0 is never used: the cell is
              // the row's boundary cell below
              const int w_diag = h9[i], w_h = h9[i + 1];
              if (w_diag > best_diag[i]) {
                best_diag[i] = w_diag;
                rank_diag[i] = pr;
              }
              const int c1_open = w_h - (o1 + e1), c1_ext = w_d1[i] - e1;
              const int c1 = max(c1_open, c1_ext);
              if (c1 > d1[i]) {
                d1[i] = c1;
                d1_ptr[i] = (pr << 1) | (c1_ext > c1_open ? 1 : 0);
              }
              const int c2_open = w_h - (o2 + e2), c2_ext = w_d2[i] - e2;
              const int c2 = max(c2_open, c2_ext);
              if (c2 > d2[i]) {
                d2[i] = c2;
                d2_ptr[i] = (pr << 1) | (c2_ext > c2_open ? 1 : 0);
              }
            }
          }
        }

        // H before insertions: diag >= D1 >= D2 on ties
        int row[kCols], rowo[kCols], hp_out[kCols];
        int acc[2][kCols], org[2][kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int jabs = jabs0 + i;
          const bool masked = jabs < j0 || jabs > j1;
          if (masked) {
            d1[i] = kNeg;
            d2[i] = kNeg;
          }
          int v = jabs == 0 ? kNeg : best_diag[i] + sub[i];
          const int rown = jabs == 0 ? -2 : rank_diag[i];
          int vo = 0;
          if (d1[i] > v) {
            v = d1[i];
            vo = 2;
          }
          if (d2[i] > v) {
            v = d2[i];
            vo = 4;
          }
          if (masked) v = kNeg;  // insertions open from in-band cells only
          row[i] = v;
          rowo[i] = vo;
          hp_out[i] = (vo << 3) | ((rown + 2) << 6);
          // insertion tiers: acc = running max of row + e*j
          acc[0][i] = v + e1 * jabs;
          acc[1][i] = v + e2 * jabs;
        }
        tile_scan_first(acc, org, jabs0, acc_c, org_c, lane);

        int fin[kCols], op_out[kCols];
        int tv = INT_MIN, ta = 0;  // the lane's first maximum
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int jabs = jabs0 + i;
          const bool masked = jabs < j0 || jabs > j1;
          int f = row[i], fo = rowo[i];
          const int ins1 = acc[0][i] - o1 - e1 * jabs;
          const bool m1 = ins1 > f;
          if (m1) {
            f = ins1;
            fo = 1;
          }
          const int ins2 = acc[1][i] - o2 - e2 * jabs;
          const bool m2 = ins2 > f;
          if (m2) {
            f = ins2;
            fo = 3;
          }
          if (masked) f = kNeg;
          fin[i] = f;
          hp_out[i] |= fo;
          const unsigned orig1 = m1 ? static_cast<unsigned>(org[0][i]) : 0u;
          const unsigned orig2 = m2 ? static_cast<unsigned>(org[1][i]) : 0u;
          op_out[i] = static_cast<int32_t>(orig1 | (orig2 << 16));
          if (jabs == qlen) end_row[r] = max(f, kNeg);
          if (f > tv) {
            tv = f;
            ta = e0 + i;
          }
        }

        store8(H + row_at + e0, fin);
        store8(D1 + row_at + e0, d1);
        store8(D2 + row_at + e0, d2);
        if (ring_rows) {
          int32_t* own = ring + slot * 3 * stride + ring_at(e0);
#pragma unroll
          for (int i = 0; i < kCols; ++i) {  // 8 | e0: no padding inside
            own[i] = fin[i];
            own[stride + i] = d1[i];
            own[2 * stride + i] = d2[i];
          }
        }
        store8(hp + row_at + e0, hp_out);
        store8(op + row_at + e0, op_out);
        store8(p1 + row_at + e0, d1_ptr);
        store8(p2 + row_at + e0, d2_ptr);

        // the tile's first maximum, in every lane: the largest value, then
        // the lowest column that holds it
        const int tile_v = __reduce_max_sync(kFull, tv);
        const int tile_a =
            __reduce_min_sync(kFull, tv == tile_v ? ta : INT_MAX);
        if (beats(tile_v, tile_a, best_v, best_a)) {
          best_v = tile_v;
          best_a = tile_a;
        }
      }
      // first-max column of the stored row; rows that are all <= NEG pin to 0
      if (lane == 0) {
        const int best = best_v <= kNeg ? 0 : off + best_a;
        best_row[r] = best;
        if (ring_rows) ring_best[slot] = best;
      }
      __syncwarp();  // this row's state, offset and best column are visible
    }
  }
}

// ring_rows: kRingCells / W rows, halved until kWarps warps fit a block.
bool plan(int W, int p_cap, Layout* lay) {
  int ring_rows = W <= kRingCells / 2 ? kRingCells / W : 0;
  lay->batch_rows = kPredWords / p_cap < 1           ? 1
                    : kPredWords / p_cap > kBatchMax ? kBatchMax
                                                     : kPredWords / p_cap;
  lay->pred_words = p_cap > kPredWords ? p_cap : kPredWords;
  for (;; ring_rows = ring_rows > 2 ? ring_rows / 2 : 0) {
    const int64_t words = 3LL * ring_rows * ring_stride(W) + 2 * kRingMax +
                          2 * kBatchMax + 2LL * lay->pred_words;
    if (words * kWarps * 4 <= kSmemMax) {
      lay->ring_rows = ring_rows;
      lay->warp_words = static_cast<int>(words);
      return true;
    }
    if (ring_rows == 0) return false;
  }
}

}  // namespace

// Launch on `stream` for n problems. The caller allocates every buffer and
// need fill none: hpack, opack, d1p, d2p (n, n_cap+1, W), offs and endcol
// (n, n_cap+1), band (n) the band half-widths, state (3, n, n_cap+1, W) and
// bestc (n, n_cap+1) scratch. W is a multiple of 256, p_cap >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int mando_poa_fwd(const void* base, const void* preds,
                             const void* nn, const void* qq, const void* ql,
                             const void* band, void* hpack, void* opack,
                             void* d1p, void* d2p, void* offs, void* endcol,
                             void* state, void* bestc, int64_t n, int n_cap,
                             int p_cap, int l_cap, int W, int match,
                             int mismatch, int gap_open, int gap_extend,
                             int gap_open2, int gap_extend2, int adaptive,
                             void* stream) {
  if (n > 0) {
    Layout lay;
    if (p_cap < 1 || W < kTile || W % kTile || !plan(W, p_cap, &lay))
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem_bytes = lay.warp_words * kWarps * 4;
    const cudaError_t rc = cudaFuncSetAttribute(
        poa_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const Scoring sc{match,     mismatch,    gap_open, gap_extend,
                     gap_open2, gap_extend2, adaptive};
    const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
    poa_fwd_kernel<<<blocks, kThreads, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(base), static_cast<const int32_t*>(preds),
        static_cast<const int32_t*>(nn), static_cast<const int32_t*>(qq),
        static_cast<const int32_t*>(ql), static_cast<const int32_t*>(band),
        static_cast<int32_t*>(hpack), static_cast<int32_t*>(opack),
        static_cast<int32_t*>(d1p), static_cast<int32_t*>(d2p),
        static_cast<int32_t*>(offs), static_cast<int32_t*>(endcol),
        static_cast<int32_t*>(state), static_cast<int32_t*>(bestc), n, n_cap,
        p_cap, l_cap, W, lay, sc);
  }
  return static_cast<int>(cudaGetLastError());
}
