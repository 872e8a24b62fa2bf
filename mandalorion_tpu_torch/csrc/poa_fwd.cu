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
// far too little work for bandwidth or arithmetic to matter. A module D round
// has fewer problems than the card has SMs until its last rounds, so a row
// costs the time one SM takes for it, and that is the instruction stream of
// one warp: a row's work, the list, band centre, scans and first maximum
// above all, is a chain of dependent instructions that issue about one every
// five cycles. Taking pieces out of the row on the card (the stores, the
// predecessor reads, the scans' shuffles, the barriers) leaves most of it:
// what is left is the bookkeeping every warp repeats. What the design does
// about it:
//
// - A block a problem, of kWarps = 4 warps that split each tile of 256
//   columns: a lane owns kCols = 2 neighbouring columns, so the columns' work
//   is divided four ways while the bookkeeping is repeated four times, one
//   warp on each of the SM's four schedulers. The prefix maxima of the two
//   insertion tiers are kCols steps in registers and a warp scan by shuffles
//   of (value, origin column) pairs; each warp publishes its total to a slot
//   in shared memory first (two warp reductions, so the exchange overlaps the
//   scan), the warps meet at a named barrier of the problem's warps, and each
//   folds the totals of the warps to its left under the scan's own rule. The
//   row's first maximum is two warp reductions, then a second slot and
//   barrier, which also publishes the row's state, offset and first-max
//   column to the next row. Both slots are double-buffered, so no warp waits
//   for another to read the last ones. W > 256 (static band, long queries) is
//   the same block walking the row in tiles of 256, left to right, the scans'
//   carries in registers. Why 4: tools/poa_kernel_phases.py times 1, 2, 4 and
//   8 warps a problem on a chunk of 8 problems and on 296 (more than the
//   SMs), and 4 is the fastest on both, at W 256, 512 and 1024; 8 warps share
//   a scheduler two by two and repeat the bookkeeping twice as often, and
//   where problems outnumber the SMs several share an SM either way. So there
//   is one warp count for every launch.
// - The state rows (H, D1, D2) of the last `ring_rows` ranks, with their
//   window offsets and first-max columns, sit in a ring in shared memory
//   (16 rows at W = 256, as many cells at W up to 2048, none above). A
//   predecessor less than ring_rows back is read from there; one farther
//   back is read from the state scratch in device memory, (3, B, n_cap+1, W)
//   int32, which every row still writes (stores do not stall the loop). The
//   ring is a cache in front of the scratch: any predecessor distance is
//   served by the same code, there is no gate. A ring row keeps kGuard cells
//   of NEG on either side, so a read shifted by less than kGuard columns
//   (nearly all: the band moves about a column a row) checks no bounds. No
//   padding: a lane owns 2 neighbouring columns, and the two-way bank
//   conflicts that leaves cost less than the padding's address arithmetic.
// - A row's predecessor list is prepared during the row before: each entry's
//   offset and best column but the chain predecessor's (row r-1, which comes
//   from registers that every thread keeps), and, in registers of every lane,
//   the largest of those best columns and the first kHead live entries. The
//   band centre is then a max of registers, and the first kHead predecessor
//   rows are read together, the chain predecessor's ring row from a pointer
//   kept from the row before; any further entries follow one at a time.
// - `base` and `preds` of the coming rows are copied into shared memory with
//   cp.async a batch of rows ahead (two buffers).
// - A problem ends at its own nn[b]: a short graph in a tall batch costs
//   nothing past its last row.
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

constexpr int kWarps = 4;  // warps a problem, its block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 256;              // columns the warps take at once
constexpr int kCols = kTile / kThreads;  // neighbouring columns a lane
constexpr int kRingCells = 16 * kTile;  // ring_rows * W at most
constexpr int kRingMax = 16;            // ring_rows at most (W = 256)
constexpr int kGuard = 16;  // NEG cells kept on either side of a ring row
constexpr int kPredWords = 256;  // predecessor entries staged a batch, at least
constexpr int kBatchMax = 32;    // rows staged a batch, at most
constexpr int kSmemMax = 232448;    // bytes a block may take on sm_90
constexpr int kNeg = -1000000000;   // the reference's NEG
constexpr unsigned kFull = 0xffffffffu;

struct Scoring {
  int match, mismatch, o1, e1, o2, e2, adaptive;
};

// What the launcher derives from W and p_cap, in int32 words.
struct Layout {
  int ring_rows;    // power of two, or 0: no ring
  int batch_rows;   // rows of base and preds staged at once
  int pred_words;   // words of one preds buffer (>= batch_rows * p_cap)
  int block_words;  // all of the block's shared memory
};

// words of the warps' exchange slots: [2][kWarps] int4 scan totals, then
// [2][kWarps] int2 first maxima
constexpr int kSlotWords = 2 * kWarps * 4 + 2 * kWarps * 2;

constexpr int kHead = 3;  // predecessors a row reads together, in registers

// The first part of a row's predecessor list, the same in every lane (see
// `summarize`).
struct ListHead {
  int best;       // the largest first-max column but the chain predecessor's
  int chain;      // whether it lists the chain predecessor (the row before)
  int cnt;        // live entries in pr, off (at most kHead)
  int pr[kHead];  // the first live entries, in declared order
  int off[kHead];  // and their window offsets
  unsigned rest;  // lanes of the live entries after those
};

// (value, column) order of a row's first maximum: larger value, then lower
// column.
__device__ __forceinline__ bool beats(int v, int a, int bv, int ba) {
  return v > bv || (v == bv && a < ba);
}

// A ring row: kGuard cells of NEG, the W stored columns, kGuard cells of NEG.
// Position of stored column c (from -kGuard to W + kGuard - 1), and the words
// of a row.
__host__ __device__ __forceinline__ int ring_at(int c) { return c + kGuard; }
__host__ __device__ __forceinline__ int ring_stride(int W) {
  return W + 2 * kGuard;
}

// The problem's warps meet: a named barrier (1) of the block's threads, or
// the warp alone.
__device__ __forceinline__ void sync_problem() {
  if constexpr (kWarps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
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

// Columns c0 .. c0+kCols of a predecessor's H row and c0+1 .. c0+kCols of its
// D1 and D2 rows, NEG outside the stored window [0, W). kRing: the rows are
// ring rows in shared memory, else rows of the state scratch.
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

// The same from ring rows when every lane's columns lie between -kGuard and
// W + kGuard - 1: the guard cells hold the NEG, no lane checks.
__device__ __forceinline__ void load_pred_guarded(const int32_t* h, int stride,
                                                  int c0, int (&h9)[kCols + 1],
                                                  int (&v1)[kCols],
                                                  int (&v2)[kCols]) {
  const int at0 = ring_at(c0);
#pragma unroll
  for (int i = 0; i <= kCols; ++i) {
    const int at = at0 + i;
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
// it is larger, else the left one": kCols steps in registers, one warp scan
// over the lanes' totals, the warps' totals folded from the left (kWarps > 1:
// each warp's total goes to `slots` before its own scan, as the largest value
// at the lowest column holding it, which is the rule's total), and the prefix
// applied; the two tiers go side by side so that their shuffles overlap.
// carry_v, carry_o come from the tiles (and the masked columns) to the left
// and leave including this tile, in every warp.
__device__ __forceinline__ void tile_scan_first(int (&v)[2][kCols],
                                                int (&org)[2][kCols], int j0,
                                                int (&carry_v)[2],
                                                int (&carry_o)[2], int lane,
                                                int warp, int4* slots) {
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
  if constexpr (kWarps > 1) {
    int tv[2], to[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) tv[t] = __reduce_max_sync(kFull, sv[t]);
#pragma unroll
    for (int t = 0; t < 2; ++t)
      to[t] = __reduce_min_sync(kFull, sv[t] == tv[t] ? so[t] : INT_MAX);
    if (lane == 0) slots[warp] = make_int4(tv[0], to[0], tv[1], to[1]);
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
  int pv[2], po[2], wv[2], wo[2];  // wv, wo: everything left of this warp
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    pv[t] = __shfl_up_sync(kFull, sv[t], 1);
    po[t] = __shfl_up_sync(kFull, so[t], 1);
    wv[t] = carry_v[t];
    wo[t] = carry_o[t];
  }
  if constexpr (kWarps == 1) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int lv = __shfl_sync(kFull, sv[t], 31);
      const int lo = __shfl_sync(kFull, so[t], 31);
      if (lv > carry_v[t]) {
        carry_v[t] = lv;
        carry_o[t] = lo;
      }
    }
  } else {
    sync_problem();
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int4 s = slots[k];
      if (k == warp) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          wv[t] = carry_v[t];
          wo[t] = carry_o[t];
        }
      }
      if (s.x > carry_v[0]) {
        carry_v[0] = s.x;
        carry_o[0] = s.y;
      }
      if (s.z > carry_v[1]) {
        carry_v[1] = s.z;
        carry_o[1] = s.w;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    // everything left of this lane: the lanes before it over the warps
    // before it and the carry
    if (lane == 0 || !(pv[t] > wv[t])) {
      pv[t] = wv[t];
      po[t] = wo[t];
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const bool own = v[t][i] > pv[t];
      org[t][i] = own ? org[t][i] : po[t];
      v[t][i] = own ? v[t][i] : pv[t];
    }
  }
}

// A lane's kCols columns into device memory (kCols | column: aligned).
__device__ __forceinline__ void store_cols(int32_t* dst,
                                           const int (&v)[kCols]) {
  if constexpr (kCols == 8) {
    int4* d = reinterpret_cast<int4*>(dst);
    d[0] = make_int4(v[0], v[1], v[2], v[3]);
    d[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else if constexpr (kCols == 4) {
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kCols == 2) {
    *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
  } else {
    *dst = v[0];
  }
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
  extern __shared__ int4 smem4[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x;  // a block a problem

  // the block's shared memory
  int4* s_scan = smem4;                                       // [2][kWarps]
  int2* s_max = reinterpret_cast<int2*>(smem4 + 2 * kWarps);  // [2][kWarps]
  int32_t* ring_off =
      reinterpret_cast<int32_t*>(smem4) + kSlotWords;  // [kRingMax]
  int32_t* ring_best = ring_off + kRingMax;                  // [kRingMax]
  int32_t* s_base = ring_best + kRingMax;                    // [2][kBatchMax]
  int32_t* s_pred = s_base + 2 * kBatchMax;             // [2][pred_words]
  int32_t* ring = s_pred + 2 * lay.pred_words;          // ring rows
  const int ring_rows = lay.ring_rows;
  const int stride = ring_stride(W);

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
    for (int i = tid; i < cnt * p_cap; i += kThreads)
      cp_async4(dst + i, src + i);
    if (tid < cnt) cp_async4(s_base + to * kBatchMax + tid,
                             base_b + (r0 - 1) + tid);
  };
  if (n >= 1) stage(1, 0);

  // the guard cells of every ring row: NEG, never written again
  for (int i = tid; i < ring_rows * 3 * 2 * kGuard; i += kThreads) {
    const int cell = i % (2 * kGuard);
    ring[i / (2 * kGuard) * stride +
         ring_at(cell < kGuard ? cell - kGuard : W + cell - kGuard)] = kNeg;
  }

  // row 0 (window offset 0): the convex insertion boundary, band-local
  for (int e = tid; e < W; e += kThreads) {
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
  if (tid == 0) {
    if (qlen >= W) end_row[0] = kNeg;
    off_row[0] = 0;
    best_row[0] = 0;
    ring_off[0] = 0;
    ring_best[0] = 0;
  }

  // row r-1's window offset, first-max column and ring row, in every thread
  int prev_off = 0, prev_best = 0;
  const int32_t* prev_h = ring;

  // A row's predecessor list, an entry a lane (32 at a time: a part), each
  // with its row's window offset and first-max column: -1, 0, NEG for
  // padding; the chain predecessor's (the row before's) offset and best
  // column come from the registers above, once that row is done.
  auto load_list = [&](int rr, const int32_t* list, int p0, int& pr_,
                       int& off_, int& best_) {
    pr_ = p0 + lane < p_cap ? list[p0 + lane] : -1;
    off_ = 0;
    best_ = kNeg;
    if (pr_ >= 0 && pr_ < rr - 1) {
      const bool near = rr - pr_ < ring_rows;
      const int ps = pr_ & (ring_rows - 1);
      off_ = near ? ring_off[ps] : off_row[pr_];
      best_ = near ? ring_best[ps] : best_row[pr_];
    }
  };
  // ... and its first part in registers of every lane: the largest best
  // column but the chain predecessor's, whether it lists the chain
  // predecessor, and its first kHead live entries in declared order
  ListHead head, next;
  auto summarize = [&](int rr, int pr_, int off_, int best_, ListHead& h) {
    h.best = __reduce_max_sync(kFull, best_);
    h.chain = __any_sync(kFull, pr_ == rr - 1);
    unsigned live = __ballot_sync(kFull, pr_ >= 0);
    h.cnt = 0;
#pragma unroll
    for (int k = 0; k < kHead; ++k) {
      const int src = live ? __ffs(live) - 1 : 0;
      h.pr[k] = __shfl_sync(kFull, pr_, src);
      h.off[k] = __shfl_sync(kFull, off_, src);
      if (live) {
        ++h.cnt;
        live &= live - 1;
      }
    }
    h.rest = live;
  };
  // this row's list, part `listed` (the chain entry filled in)
  int my_pr = -1, my_off = 0, my_best = kNeg, listed = -1, listed_row = -1;
  // the next row's first part, loaded during this row
  int nx_pr = -1, nx_off = 0, nx_best = kNeg, ready_row = -1;

  // H, D1, D2 of one predecessor row at the lane's columns: the ring row
  // (the chain predecessor's kept, no address to work) or the scratch
  auto read_pred = [&](int r, int pr, int c0, int shift, int(&h9)[kCols + 1],
                       int(&w_d1)[kCols], int(&w_d2)[kCols]) {
    if (r - pr < ring_rows) {
      const int32_t* row_h =
          pr == r - 1 ? prev_h : ring + (pr & (ring_rows - 1)) * 3 * stride;
      if (shift >= -kGuard && shift < kGuard)
        load_pred_guarded(row_h, stride, c0, h9, w_d1, w_d2);
      else
        load_pred<true>(row_h, row_h + stride, row_h + 2 * stride, c0, W,
                            h9, w_d1, w_d2);
    } else {
      const int64_t at = static_cast<int64_t>(pr) * W;
      load_pred<false>(H + at, D1 + at, D2 + at, c0, W, h9, w_d1, w_d2);
    }
  };

  int par = 0;  // the scan slots' buffer, flipped every tile
  int buf = 0;
  for (int r0 = 1; r0 <= n; r0 += lay.batch_rows, buf ^= 1) {
    // this batch's lists have landed; the other buffer's rows are done
    cp_async_wait_all();
    sync_problem();
    if (r0 + lay.batch_rows <= n) stage(r0 + lay.batch_rows, buf ^ 1);
    const int r_end = min(n, r0 + lay.batch_rows - 1);

    for (int r = r0; r <= r_end; ++r) {
      const int base_v = s_base[buf * kBatchMax + (r - r0)];
      const int32_t* pr_row = s_pred + buf * lay.pred_words + (r - r0) * p_cap;
      const int slot = r & (ring_rows - 1);  // unused without a ring
      if (ready_row == r) {
        head = next;
        my_pr = nx_pr;
        my_off = nx_off;
        my_best = nx_best;
      } else {
        load_list(r, pr_row, 0, my_pr, my_off, my_best);
        summarize(r, my_pr, my_off, my_best, head);
      }
      listed = 0;
      listed_row = r;
      auto chain = [&]() {
        if (my_pr == r - 1) {
          my_off = prev_off;
          my_best = prev_best;
        }
      };
      chain();
#pragma unroll
      for (int k = 0; k < kHead; ++k)
        if (head.pr[k] == r - 1) head.off[k] = prev_off;
      auto list_at = [&](int p0) {
        if (p0 != listed || listed_row != r) {
          load_list(r, pr_row, p0, my_pr, my_off, my_best);
          listed = p0;
          chain();
        }
      };

      int center;
      if (sc.adaptive) {
        // one past the first-max column of the best predecessor row
        int c = max(head.best, head.chain ? prev_best : kNeg);
        if (p_cap > 32) {
          int c2 = kNeg;
          for (int p0 = 32; p0 < p_cap; p0 += 32) {
            list_at(p0);
            c2 = max(c2, my_best);
          }
          c = max(c, __reduce_max_sync(kFull, c2));
        }
        center = c + 1;
      } else {
        center = static_cast<int>(static_cast<int64_t>(r) * qlen / max(n, 1));
      }
      const int off = min(max(center - eff, 0), off_max);
      const int j0 = max(0, center - eff);
      const int j1 = min(qlen, center + eff);
      if (warp == 0) {
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
      int best_v = INT_MIN, best_a = INT_MAX;  // the warp's first maximum

      const int64_t row_at = static_cast<int64_t>(r) * W;
      for (int t0 = 0; t0 < W; t0 += kTile, par ^= 1) {
        // the lane's first stored column
        const int e0 = t0 + (warp * 32 + lane) * kCols;
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
        auto take = [&](int pr, const int(&h9)[kCols + 1],
                        const int(&w_d1)[kCols], const int(&w_d2)[kCols]) {
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
        };
        // the list's first live entries, their reads in flight together
        {
          int h9[kHead][kCols + 1], w_d1[kHead][kCols], w_d2[kHead][kCols];
#pragma unroll
          for (int k = 0; k < kHead; ++k)
            if (k < head.cnt) {
              // the lane's columns start at column shift + e0 of the
              // predecessor's window: absolute column jabs0 - 1
              const int shift = off - 1 - head.off[k];
              read_pred(r, head.pr[k], shift + e0, shift, h9[k], w_d1[k],
                        w_d2[k]);
            }
#pragma unroll
          for (int k = 0; k < kHead; ++k)
            if (k < head.cnt) take(head.pr[k], h9[k], w_d1[k], w_d2[k]);
        }
        // the rest, one at a time; padding is skipped: every window value
        // would be NEG
        if (head.rest || p_cap > 32) {
          for (int p0 = 0; p0 < p_cap; p0 += 32) {
            list_at(p0);
            unsigned live =
                p0 == 0 ? head.rest : __ballot_sync(kFull, my_pr >= 0);
            while (live) {
              const int src = __ffs(live) - 1;
              live &= live - 1;
              const int pr = __shfl_sync(kFull, my_pr, src);
              const int shift = off - 1 - __shfl_sync(kFull, my_off, src);
              int h9[kCols + 1], w_d1[kCols], w_d2[kCols];
              read_pred(r, pr, shift + e0, shift, h9, w_d1, w_d2);
              take(pr, h9, w_d1, w_d2);
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
        tile_scan_first(acc, org, jabs0, acc_c, org_c, lane, warp,
                            s_scan + par * kWarps);
        // the next row's list: its entries but this row are final (the
        // ring's offsets and best columns up to row r - 1 have crossed a
        // barrier of this row)
        const bool ahead = t0 == 0 && r < r_end;
        if (ahead) load_list(r + 1, pr_row + p_cap, 0, nx_pr, nx_off, nx_best);

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

        if (ring_rows) {
          int32_t* own = ring + slot * 3 * stride + ring_at(e0);
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            own[i] = fin[i];
            own[stride + i] = d1[i];
            own[2 * stride + i] = d2[i];
          }
        }
        // the tile's first maximum, in every lane: the largest value, then
        // the lowest column that holds it
        const int tile_v = __reduce_max_sync(kFull, tv);
        const int tile_a =
            __reduce_min_sync(kFull, tv == tile_v ? ta : INT_MAX);
        // the stores issue while the reductions run
        store_cols(H + row_at + e0, fin);
        store_cols(D1 + row_at + e0, d1);
        store_cols(D2 + row_at + e0, d2);
        store_cols(hp + row_at + e0, hp_out);
        store_cols(op + row_at + e0, op_out);
        store_cols(p1 + row_at + e0, d1_ptr);
        store_cols(p2 + row_at + e0, d2_ptr);
        if (beats(tile_v, tile_a, best_v, best_a)) {
          best_v = tile_v;
          best_a = tile_a;
        }
        if (ahead) {
          summarize(r + 1, nx_pr, nx_off, nx_best, next);
          ready_row = r + 1;
        }
      }
      // the row's first maximum over the warps; the barrier also publishes
      // this row's state and offset to the next row
      if constexpr (kWarps > 1) {
        int2* maxima = s_max + (r & 1) * kWarps;
        if (lane == 0) maxima[warp] = make_int2(best_v, best_a);
        sync_problem();
        best_v = INT_MIN;
        best_a = INT_MAX;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) {
          const int2 m = maxima[k];
          if (beats(m.x, m.y, best_v, best_a)) {
            best_v = m.x;
            best_a = m.y;
          }
        }
      }
      // first-max column of the stored row; rows that are all <= NEG pin to 0
      const int best = best_v <= kNeg ? 0 : off + best_a;
      if (warp == 0) {
        best_row[r] = best;
        if (ring_rows) ring_best[slot] = best;  // read from row r + 2 on
      }
      prev_off = off;
      prev_best = best;
      if (ring_rows) prev_h = ring + slot * 3 * stride;
      // row r is done (one warp: its state, offset and best are visible)
      if constexpr (kWarps == 1) __syncwarp();
    }
  }
}

// ring_rows: kRingCells / W rows, halved until the block's shared memory
// fits.
bool plan(int W, int p_cap, Layout* lay) {
  int ring_rows = W <= kRingCells / 2 ? kRingCells / W : 0;
  lay->batch_rows = kPredWords / p_cap < 1           ? 1
                    : kPredWords / p_cap > kBatchMax ? kBatchMax
                                                     : kPredWords / p_cap;
  lay->pred_words = p_cap > kPredWords ? p_cap : kPredWords;
  const int64_t fixed = kSlotWords + 2 * kRingMax + 2 * kBatchMax +
                        2LL * lay->pred_words;
  for (;; ring_rows = ring_rows > 2 ? ring_rows / 2 : 0) {
    const int64_t words = fixed + 3LL * ring_rows * ring_stride(W);
    if (words * 4 <= kSmemMax) {
      lay->ring_rows = ring_rows;
      lay->block_words = static_cast<int>(words);
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
    if (p_cap < 1 || W < kTile || W % kTile || n > INT_MAX ||
        !plan(W, p_cap, &lay))
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem_bytes = lay.block_words * 4;
    const cudaError_t rc = cudaFuncSetAttribute(
        poa_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const Scoring sc{match,     mismatch,    gap_open, gap_extend,
                     gap_open2, gap_extend2, adaptive};
    poa_fwd_kernel<<<static_cast<unsigned>(n), kThreads, smem_bytes,
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
