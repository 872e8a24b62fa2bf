// Affine-gap DP fill + traceback walk for module A's gap fills and end
// extensions, fused in one kernel so the pointer matrix never leaves the card.
//
// Replaces mandalorion_tpu/align/kernels.py: the Pallas kernel `_dp_kernel`
// (row math `row_step`, row 0 from `_row0`) and the XLA while_loop
// `_traceback_walk`, which `_pallas_fused_fn` runs as one dispatch. The
// output is `solve_dp_fused`'s contract: meta (n,4) int32 = best_i, best_j,
// best score (end bonus applied), final H[nq][nt]; ks (n,) int32 step
// counts; buf (n,steps) int8 reverse-order step codes 1 M / 2 I / 3 D.
//
// What bounds it on the H100: a cell is a few dozen integer operations and
// one pointer byte, and every cell waits on its left, upper and upper-left
// neighbours. A row of a few dozen to a few thousand columns is too little
// work for a block, and the main path's problems are small (gap fills of
// about 20 x 30 cells, at most 45 query rows): the time goes to latency and
// idle lanes, not to bytes or arithmetic. What the design does about it:
//
// - No prefix scan in the row. The reference's F prefix max (`_cummax` of
//   b + ge*j) is, cell by cell, F[j] = max(B[j-1] - go - ge, F[j-1] - ge)
//   with B = max(diag, E), exactly in integers; so a cell depends only on its
//   left, upper and upper-left neighbours.
// - A warp a problem, lanes on query rows: an inter-lane wavefront. Lane l
//   owns row 32s + l + 1 of strip s and computes column group c - l at step
//   c: one column on a one-warp problem, kTeamCols = 4 on a team's, one
//   after another. H and E of the row above come from lane l - 1 by
//   shuffles, the diagonal H left of the group is what lane l - 1 handed
//   over one step earlier, F and the left H, B stay in registers; on a team
//   four columns a step share the step's loop and one 32-bit pointer store
//   (the main path's narrow gap fills would waste a group's columns). A step
//   costs the latency of a shuffle and the cell's chain. Lane 0 takes the
//   row above the strip
//   from the boundary row: row 0 (`_row0`), which it computes, for strip 0,
//   else the (H, E) that lane 31 of the strip before wrote, read a batch of
//   32 groups at a time by the whole warp and handed to lane 0 by shuffles.
//   One-warp problems go up to kWarps a block (fewer when a launch has too
//   few to give each SM a block), and there is no barrier in the fill.
// - Pointers on chip. A problem's pointer bytes (rows 1..nq at a pitch
//   that is a multiple of 8, so that 32 lanes storing a word each on 32 rows
//   hit 32 banks) and its boundary row sit in the warp's share of shared
//   memory when they fit it, which every problem of the main path does; the
//   walk then reads shared memory. A larger problem writes its pointers to
//   device scratch laid out (strip, step, lane), one step's bytes
//   contiguous, and its walk stages 2 KB of a strip at a time.
// - Tall and wide problems (the wrapper's TEAM_STEPS rule) take a whole block:
//   its kWarps warps run successive strips, each following the strip above
//   through a boundary row in device scratch, kWarps rows deep, by a progress
//   flag in shared memory that the warp above publishes every 16 steps
//   (fence, then a volatile store). The one block barrier comes after the
//   fill, before the walk.
// - The best cell: each lane keeps its row's first maximum (a strict > along
//   the sweep gives the lowest column); a strip's 32 row maxima fold in row
//   order by warp scans: the zdrop latch, the end bonus on row nq only, and a
//   strict > across rows. H[nq][nt] comes from the lane that owns row nq.
// - The walk is `_traceback_walk`'s state machine on one warp, every lane in
//   step; the step codes go out 32 bytes at a time.
//
// Tie-breaks follow `row_step` exactly: H takes diag >= E >= F (a strict >
// switches), E and F extend only on strict >, column 0 is forced to code 1,
// row 0's codes are 2 | (j > 1) << 3. The best cell is the lowest column
// among a row's maxima and moves to a later row only on a strict >; it stays
// (0, 0, 0) when nothing beats 0. The zdrop latch excludes its triggering
// row and every row after it.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // problems a block, or the warps of one team
constexpr int kThreads = kWarps * 32;
constexpr int kNeg = -1000000000;  // the reference's NEG
constexpr int kPad = 9;            // target code of column 0: matches nothing
constexpr unsigned kFull = 0xffffffffu;
// neighbouring columns a lane computes a step: one on a one-warp problem,
// kTeamCols on a team's
constexpr int kTeamCols = 4;
constexpr int kWinBytes = 2048;  // bytes of a strip the walk stages at once
constexpr int kTeamFlags = 64;    // bytes of a team's progress flags
constexpr int kFlagStride = 4096;  // flag = strip * kFlagStride + columns

struct Scoring {
  int match, mismatch, go, ge, end_bonus, zdrop;
};

__host__ __device__ __forceinline__ int align16(int x) {
  return (x + 15) & ~15;
}
// groups of K columns of a problem of nt target bases (columns 0..nt)
template <int K>
__host__ __device__ __forceinline__ int groups_of(int nt) {
  return (nt + K) / K;
}
// bytes a pointer row takes in shared memory: 5 mod 8, so that the bytes 32
// lanes on 32 rows store at one step fall in 32 banks
__host__ __device__ __forceinline__ int row_pitch(int width) {
  return width + ((5 - width) % 8 + 8) % 8;
}

// (value, position) with the first-max order: larger value, then lower
// position.
__device__ __forceinline__ bool beats(int v, int a, int bv, int ba) {
  return v > bv || (v == bv && a < ba);
}

// Best cell so far (score, row, column) and the zdrop latch state; the same
// in every lane.
struct Best {
  int score = 0, i = 0, j = 0, raw_best = 0;
  bool cut = false;
};

// Fold the row maxima (v, a) of rows row0 + lane, lane < nrows, into the best
// cell, as `_dp_kernel` does one row after another: the zdrop latch (a row
// is cut when its maximum falls zdrop below the best of the rows before it),
// the end bonus on row nq, a strict > across rows.
__device__ __forceinline__ void fold_rows(Best& b, int v, int a, int row0,
                                          int nrows, int nq,
                                          const Scoring& sc, int lane) {
  const bool live = lane < nrows;
  bool valid = live && !b.cut;
  if (sc.zdrop > 0 && !b.cut) {
    int incl = live ? v : INT_MIN;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = INT_MIN;
    const int before = max(b.raw_best, excl);  // >= 0
    const unsigned cuts = __ballot_sync(kFull, live && v < before - sc.zdrop);
    const int first_cut = cuts ? __ffs(cuts) - 1 : 32;
    valid = live && lane < first_cut;
    int m = valid ? v : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(kFull, m, off));
    b.raw_best = max(b.raw_best, m);
    b.cut = cuts != 0;
  }
  int rb = valid ? v + (row0 + lane == nq ? sc.end_bonus : 0) : INT_MIN;
  int rr = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, rb, off);
    const int orr = __shfl_xor_sync(kFull, rr, off);
    if (beats(ov, orr, rb, rr)) {
      rb = ov;
      rr = orr;
    }
  }
  const int col = __shfl_sync(kFull, a, rr);
  if (rb > b.score) {
    b.score = rb;
    b.i = row0 + rr;
    b.j = col;
  }
}

// A problem as the fill and the walk see it. Columns go in groups of K:
// a lane computes a group of its row at each step of the wavefront.
struct Prob {
  int nq, nt, groups;     // groups = ceil((nt + 1) / K)
  const uint8_t* tcode;   // K * groups target codes, [0] = kPad
  uint8_t* sptr;          // shared pointer bytes, rows 1..nq at pitch, or null
  int pitch;
  uint8_t* gptr;  // scratch pointer bytes (strip, step, lane, K), or null
  int gsteps;     // steps a strip in gptr: groups + 31
  int32_t* bnd;   // boundary rows: nbuf buffers of H then E, K * groups
  int nbuf;       // each; 1 (a warp, in place) or kWarps (a team)
};

// K values a lane holds in registers (the loops over them are unrolled).
template <int K>
struct Vec {
  int v[K];
};

template <int K>
__device__ __forceinline__ Vec<K> fill(int x) {
  Vec<K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) r.v[k] = x;
  return r;
}
template <int K>
__device__ __forceinline__ Vec<K> shfl_up(const Vec<K>& x) {
  Vec<K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) r.v[k] = __shfl_up_sync(kFull, x.v[k], 1);
  return r;
}
template <int K>
__device__ __forceinline__ Vec<K> shfl(const Vec<K>& x, int src) {
  Vec<K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) r.v[k] = __shfl_sync(kFull, x.v[k], src);
  return r;
}

// H and E of one group of K columns.
template <int K>
struct Group {
  Vec<K> h, e;
};

// The boundary row above strip s > 0 at group g0 + lane, waiting for the warp
// above to have published it when `wait` is given (a team; then each batch
// is fetched when it is needed, so that a strip trails the one above by as
// little as 32 groups and a publishing interval).
template <int K>
__device__ __forceinline__ Group<K> boundary_batch(const Prob& P, int s,
                                                   int g0, int lane,
                                                   const volatile int* wait) {
  const int g = g0 + lane;
  if (wait != nullptr) {
    const int need = (s - 1) * kFlagStride + min(P.groups, g0 + 32);
    while (*wait < need) __nanosleep(32);
    __threadfence_block();
  }
  Group<K> r{fill<K>(kNeg), fill<K>(kNeg)};
  if (g < P.groups) {
    const int32_t* src =
        P.bnd + static_cast<int64_t>(s % P.nbuf) * 2 * K * P.groups + K * g;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r.h.v[k] = src[k];
      r.e.v[k] = src[K * P.groups + k];
    }
  }
  return r;
}

// One strip: lane l on row 32s + l + 1, column group c - l at step c. Leaves
// the lane's row maximum in (v, a) (INT_MIN past row nq), writes the pointer
// bytes (a word a group), lane 31's row to the boundary row below when there
// is a strip below, and H[nq][nt] to *final_h. kAbove: the row above is a
// boundary row (strip s > 0), else row 0, which lane 0 computes. kTeam: the
// strip above is another warp's, published through `wait`; this warp
// publishes its own boundary groups through `post`.
template <int K, bool kAbove, bool kTeam>
__device__ __forceinline__ void fill_strip(const Prob& P, int s, int qc,
                                           const Scoring& sc, int lane,
                                           const volatile int* wait,
                                           volatile int* post,
                                           int32_t* final_h, int& v, int& a) {
  const int i = 32 * s + lane + 1;
  const bool row_live = i <= P.nq;
  const int n_steps = P.groups + min(31, P.nq - 32 * s - 1);
  const bool feeds = P.nq > 32 * s + 32;
  const bool to_below = feeds && lane == 31;
  int32_t* below =
      P.bnd + static_cast<int64_t>((s + 1) % P.nbuf) * 2 * K * P.groups;
  const int go_ge = sc.go + sc.ge, ge = sc.ge, go = sc.go;
  const int match = sc.match, mismatch = -sc.mismatch;
  const int nt = P.nt;
  // the column of row nq this lane writes to *final_h, if it owns row nq
  const int final_j = i == P.nq ? nt : -1;
  // the pointer bytes of step c at dst + c * stride: shared rows (one
  // column a lane), or scratch laid out (strip, step, lane, K)
  uint8_t* dst =
      P.sptr != nullptr
          ? P.sptr + static_cast<int64_t>(i - 1) * P.pitch - lane
          : P.gptr + (static_cast<int64_t>(s) * P.gsteps * 32 + lane) * K;
  const int stride = P.sptr != nullptr ? 1 : 32 * K;
  Group<K> out{fill<K>(kNeg), fill<K>(kNeg)};  // this lane's group before
  int up_last = kNeg;  // H of the row above, left of this step's group
  int f_left = kNeg, b_left = kNeg;
  v = INT_MIN;
  a = INT_MAX;
  Group<K> cur = out, nxt = out;
  if (kAbove) {
    // one warp reads a batch ahead; a team reads each when it needs it
    cur = boundary_batch<K>(P, s, 0, lane, wait);
    if (!kTeam) nxt = boundary_batch<K>(P, s, 32, lane, wait);
  }
  for (int c = 0; c < n_steps; ++c) {
    const int u = c & 31;
    Vec<K> uh = shfl_up(out.h), ue = shfl_up(out.e);
    if (kAbove) {
      if (u == 0 && c > 0) {
        cur = kTeam ? boundary_batch<K>(P, s, c, lane, wait) : nxt;
        if (!kTeam) nxt = boundary_batch<K>(P, s, c + 32, lane, wait);
      }
      const Vec<K> bh = shfl(cur.h, u), be = shfl(cur.e, u);
      if (lane == 0) {
        uh = bh;
        ue = be;
      }
    } else if (lane == 0) {  // row 0 (`_row0`)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = K * c + k;
        uh.v[k] = j == 0 ? 0 : -(go + ge * j);
      }
      ue = fill<K>(kNeg);
    }
    const int g = c - lane;
    const int j0 = K * g;
    const int gc = min(max(g, 0), P.groups - 1);
    uint32_t tcodes;  // the group's target codes, a byte each
    if constexpr (K == 4)
      tcodes = reinterpret_cast<const uint32_t*>(P.tcode)[gc];
    else
      tcodes = P.tcode[gc];
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      const int tc = (tcodes >> (8 * k)) & 0xFF;
      const int diag = (k == 0 ? up_last : uh.v[k > 0 ? k - 1 : 0]) +
                       (tc == qc ? match : mismatch);
      const int open_e = uh.v[k] - go_ge, ext_e = ue.v[k] - ge;
      const int e = max(open_e, ext_e);
      const bool col0 = j == 0;
      const int fl = col0 ? kNeg : f_left, bl = col0 ? kNeg : b_left;
      const int open_f = bl - go_ge, ext_f = fl - ge;
      const int f = col0 ? kNeg - go : max(open_f, ext_f);
      const int b = col0 ? e : max(diag, e);
      int h = diag, code = 0;
      if (e > h) {
        h = e;
        code = 1;
      }
      if (f > h) {
        h = f;
        code = 2;
      }
      if (col0) {
        h = e;
        code = 1;
      }
      word |= static_cast<uint32_t>(code | (ext_e > open_e ? 4 : 0) |
                                    (ext_f > open_f ? 8 : 0))
              << (8 * k);
      if (row_live && static_cast<unsigned>(j) <= static_cast<unsigned>(nt)) {
        if (h > v) {
          v = h;
          a = j;
        }
        if (j == final_j) *final_h = h;
      }
      f_left = f;
      b_left = b;
      out.h.v[k] = h;
      out.e.v[k] = e;
    }
    up_last = uh.v[K - 1];
    if (row_live &&
        static_cast<unsigned>(g) < static_cast<unsigned>(P.groups)) {
      uint8_t* at = dst + static_cast<int64_t>(c) * stride;
      if constexpr (K == 4)
        *reinterpret_cast<uint32_t*>(at) = word;
      else
        *at = static_cast<uint8_t>(word);
      if (to_below) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          below[K * g + k] = out.h.v[k];
          below[K * (P.groups + g) + k] = out.e.v[k];
        }
      }
    }
    if (kTeam && to_below && (u & 15) == 15) {
      __threadfence_block();
      *post = s * kFlagStride + min(max(c - 30, 0), P.groups);
    }
  }
  if (kTeam && to_below) {
    __threadfence_block();
    *post = s * kFlagStride + P.groups;
  }
}

// `_traceback_walk`'s state machine (0 H, 1 E, 2 F) from the start cell the
// mode picks, every lane in step. Writes buf's row and ks.
template <int K>
__device__ __forceinline__ void walk(const Prob& P, int mode, const Best& best,
                                     int8_t* out, int64_t steps,
                                     int32_t* ks_p, uint8_t* win, int lane) {
  int qi = P.nq, tj = P.nt;
  if (mode != 0) {
    const bool dead = best.score <= 0;
    qi = dead ? 0 : best.i;
    tj = dead ? 0 : best.j;
  }
  int state = 0, ws = -1, wc0 = 0;
  int8_t mine = 0;  // lane x holds step code k with k % 32 == x
  int64_t k = 0;
  while ((qi > 0 || tj > 0) && k < steps) {
    int bits;
    if (qi == 0) {
      bits = tj == 0 ? 0 : 2 | (tj > 1 ? 8 : 0);  // row 0
    } else if (P.sptr != nullptr) {
      bits = P.sptr[static_cast<int64_t>(qi - 1) * P.pitch + tj];
    } else {
      // scratch: (strip, step, lane, K); within a strip the step only
      // falls, so the window is the steps up to the current one
      constexpr int kWinSteps = kWinBytes / (32 * K);
      const int s = (qi - 1) >> 5, l = (qi - 1) & 31, c = tj / K + l;
      if (s != ws || c < wc0) {
        __syncwarp();
        ws = s;
        wc0 = max(c - (kWinSteps - 1), 0);
        const int4* src = reinterpret_cast<const int4*>(
            P.gptr + (static_cast<int64_t>(s) * P.gsteps + wc0) * 32 * K);
        int4* dst = reinterpret_cast<int4*>(win);
        for (int x = lane; x < kWinBytes / 16; x += 32) dst[x] = src[x];
        __syncwarp();
      }
      bits = win[((c - wc0) * 32 + l) * K + tj % K];
    }
    int op = 0;
    if (state == 0) {
      const int code = bits & 3;
      if (code == 0 && qi > 0 && tj > 0) {
        op = 1;
        --qi;
        --tj;
      } else {
        state = code == 1 ? 1 : 2;
      }
    } else if (state == 1) {
      op = 2;
      state = (bits >> 2) & 1 ? 1 : 0;
      --qi;
    } else {
      op = 3;
      state = (bits >> 3) & 1 ? 2 : 0;
      --tj;
    }
    if (op != 0) {
      if (lane == static_cast<int>(k & 31)) mine = static_cast<int8_t>(op);
      ++k;
      if ((k & 31) == 0) out[k - 32 + lane] = mine;
    }
  }
  if (lane < static_cast<int>(k & 31)) out[(k & ~int64_t{31}) + lane] = mine;
  for (int64_t x = (k & ~int64_t{31}) + lane; x < steps; x += 32)
    if (x >= k) out[x] = 0;  // the contract's zeros past ks
  if (lane == 0) *ks_p = static_cast<int32_t>(k);
}

struct Args {
  const uint8_t* genome;
  const uint8_t* oriented;
  const int64_t* q_lo;
  const int64_t* t_lo;
  const int32_t* nq;
  const int32_t* nt;
  const uint8_t* mode;
  const int32_t* order;
  const int64_t* ptr_off;
  const int64_t* bnd_off;
  uint8_t* ptr_scratch;
  int32_t* bnd_scratch;
  int32_t* meta;
  int32_t* ks;
  int8_t* buf;
  int64_t steps;
  int n_small, per_block, warp_share;
  Scoring sc;
};

// Target codes of problem p into tcode[0..K * groups): column 0 and the
// columns past nt are kPad.
template <int K>
__device__ __forceinline__ void load_target(const Args& A, int p, int nt,
                                            bool rev, uint8_t* tcode, int tid,
                                            int nthreads) {
  const int64_t t0 = A.t_lo[p];
  for (int j = tid; j < K * groups_of<K>(nt); j += nthreads)
    tcode[j] = j == 0 || j > nt ? kPad
                                : A.genome[rev ? t0 + nt - j : t0 + j - 1];
}

__device__ __forceinline__ int query_code(const Args& A, int p, int nq,
                                          bool rev, int i) {
  if (i > nq) return 0xFF;
  const int64_t q0 = A.q_lo[p];
  return A.oriented[rev ? q0 + nq - i : q0 + i - 1];
}

// A problem on one warp, in `share` bytes of shared memory: target codes,
// then the boundary row when it lies there (nq > 32, bnd_off < 0), then the
// pointer bytes (ptr_off < 0) or the walk's window over scratch.
__device__ void solve_warp(const Args& A, int p, uint8_t* share, int lane) {
  const int nq = A.nq[p], nt = A.nt[p], mode = A.mode[p];
  const int groups = nt + 1;  // a column a lane
  const bool rev = mode == 2;  // extend_left: both slices read reversed
  uint8_t* rest = share + align16(groups);
  Prob P{nq, nt, groups, share, nullptr, row_pitch(nt + 1), nullptr,
         groups + 31, nullptr, 1};
  // null layout arrays: every problem keeps all of it in shared memory
  const int64_t ptr_off = A.ptr_off != nullptr ? A.ptr_off[p] : -1;
  if (nq > 32) {
    if (A.bnd_off == nullptr || A.bnd_off[p] < 0) {
      P.bnd = reinterpret_cast<int32_t*>(rest);
      rest += align16(8 * groups);
    } else {
      P.bnd = A.bnd_scratch + 2 * A.bnd_off[p];
    }
  }
  uint8_t* win = nullptr;
  if (ptr_off < 0) {
    P.sptr = rest;
  } else {
    P.gptr = A.ptr_scratch + ptr_off;
    win = rest;
  }
  load_target<1>(A, p, nt, rev, share, lane, 32);
  __syncwarp();

  Best best;
  int32_t* m = A.meta + 4 * static_cast<int64_t>(p);
  const int strips = (nq + 31) / 32;
  for (int s = 0; s < strips; ++s) {
    int v, a;
    const int qc = query_code(A, p, nq, rev, 32 * s + lane + 1);
    if (s == 0)
      fill_strip<1, false, false>(P, s, qc, A.sc, lane, nullptr, nullptr,
                                  m + 3, v, a);
    else
      fill_strip<1, true, false>(P, s, qc, A.sc, lane, nullptr, nullptr,
                                 m + 3, v, a);
    __syncwarp();  // the boundary row and the pointers are written
    fold_rows(best, v, a, 32 * s + 1, min(32, nq - 32 * s), nq, A.sc, lane);
  }
  if (lane == 0) {
    m[0] = best.i;
    m[1] = best.j;
    m[2] = best.score;
  }
  walk<1>(P, mode, best, A.buf + static_cast<int64_t>(p) * A.steps,
          A.steps, A.ks + p, win, lane);
}

// A tall and wide problem on a whole block: warp w runs strips w, w +
// kWarps, ...; shared memory holds the progress flags, the row maxima, the
// target codes and the walk's window; pointers and boundary rows are in
// scratch.
__device__ void solve_team(const Args& A, int p, uint8_t* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = A.nq[p], nt = A.nt[p], mode = A.mode[p];
  const int groups = groups_of<kTeamCols>(nt);
  const bool rev = mode == 2;
  volatile int* flags = reinterpret_cast<volatile int*>(smem);
  int* row_v = reinterpret_cast<int*>(smem + kTeamFlags);
  int* row_a = row_v + nq;
  uint8_t* tcode = smem + kTeamFlags + align16(8 * nq);
  uint8_t* win = tcode + align16(kTeamCols * groups);
  if (threadIdx.x < kWarps) flags[threadIdx.x] = -1;
  load_target<kTeamCols>(A, p, nt, rev, tcode, threadIdx.x, kThreads);
  __syncthreads();

  const Prob P{nq, nt, groups, tcode, nullptr, 0,
               A.ptr_scratch + A.ptr_off[p], groups + 31,
               A.bnd_scratch + 2 * A.bnd_off[p], kWarps};
  int32_t* m = A.meta + 4 * static_cast<int64_t>(p);
  const int strips = (nq + 31) / 32;
  for (int s = warp; s < strips; s += kWarps) {
    const int i = 32 * s + lane + 1;
    int v, a;
    const int qc = query_code(A, p, nq, rev, i);
    if (s == 0)
      fill_strip<kTeamCols, false, true>(P, s, qc, A.sc, lane, nullptr,
                                         &flags[warp], m + 3, v, a);
    else
      fill_strip<kTeamCols, true, true>(P, s, qc, A.sc, lane,
                                        &flags[(s - 1) % kWarps],
                                        &flags[warp], m + 3, v, a);
    if (i <= nq) {
      row_v[i - 1] = v;
      row_a[i - 1] = a;
    }
  }
  __syncthreads();  // every strip is done: its rows' maxima and pointers
  if (warp != 0) return;

  Best best;
  for (int s = 0; s < strips; ++s) {
    const int i = 32 * s + lane + 1;
    const bool live = i <= nq;
    fold_rows(best, live ? row_v[i - 1] : INT_MIN,
              live ? row_a[i - 1] : INT_MAX, 32 * s + 1,
              min(32, nq - 32 * s), nq, A.sc, lane);
  }
  if (lane == 0) {
    m[0] = best.i;
    m[1] = best.j;
    m[2] = best.score;
  }
  walk<kTeamCols>(P, mode, best, A.buf + static_cast<int64_t>(p) * A.steps,
                  A.steps, A.ks + p, win, lane);
}

__global__ void __launch_bounds__(kThreads, 2) dp_fused_kernel(Args A) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int small_blocks = (A.n_small + A.per_block - 1) / A.per_block;
  if (static_cast<int>(blockIdx.x) < small_blocks) {
    const int warp = threadIdx.x >> 5;
    const int k = blockIdx.x * A.per_block + warp;
    if (warp >= A.per_block || k >= A.n_small) return;  // whole warps
    solve_warp(A, A.order != nullptr ? A.order[k] : k,
               smem + warp * A.warp_share, threadIdx.x & 31);
  } else {
    solve_team(A, A.order[A.n_small + (blockIdx.x - small_blocks)], smem);
  }
}

}  // namespace

// Launch on `stream` for n problems: order[0..n_small) one warp each,
// per_block of them a block, order[n_small..n) a block each; warp_share
// bytes of shared memory a warp, block_bytes a block. ptr_off / bnd_off
// (bytes / int2 entries into the scratch buffers) are -1 where a problem
// keeps its pointers / boundary row in shared memory; order, ptr_off and
// bnd_off may all be null when every problem is on one warp, in its order,
// with everything in shared memory. buf is (n, steps) with steps >= nq+nt
// for every problem; every output is written whole. Returns
// cudaGetLastError() after the launch.
extern "C" int mando_dp_fused(
    const void* genome, const void* oriented, const void* q_lo,
    const void* t_lo, const void* nq, const void* nt, const void* mode,
    const void* order, const void* ptr_off, const void* bnd_off,
    void* ptr_scratch, void* bnd_scratch, void* meta, void* ks, void* buf,
    int64_t n, int64_t n_small, int64_t steps, int per_block, int warp_share,
    int block_bytes, int match,
    int mismatch, int gap_open, int gap_extend, int end_bonus, int zdrop,
    void* stream) {
  if (n > 0) {
    const Args A{static_cast<const uint8_t*>(genome),
                 static_cast<const uint8_t*>(oriented),
                 static_cast<const int64_t*>(q_lo),
                 static_cast<const int64_t*>(t_lo),
                 static_cast<const int32_t*>(nq),
                 static_cast<const int32_t*>(nt),
                 static_cast<const uint8_t*>(mode),
                 static_cast<const int32_t*>(order),
                 static_cast<const int64_t*>(ptr_off),
                 static_cast<const int64_t*>(bnd_off),
                 static_cast<uint8_t*>(ptr_scratch),
                 static_cast<int32_t*>(bnd_scratch),
                 static_cast<int32_t*>(meta),
                 static_cast<int32_t*>(ks),
                 static_cast<int8_t*>(buf),
                 steps,
                 static_cast<int>(n_small),
                 per_block,
                 warp_share,
                 {match, mismatch, gap_open, gap_extend, end_bonus, zdrop}};
    const int64_t blocks =
        (n_small + per_block - 1) / per_block + (n - n_small);
    cudaError_t err =
        cudaFuncSetAttribute(dp_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             block_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dp_fused_kernel<<<static_cast<unsigned>(blocks), kThreads, block_bytes,
                      static_cast<cudaStream_t>(stream)>>>(A);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mando_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
