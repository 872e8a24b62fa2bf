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
// Layout: one block per problem. Query rows are a loop inside the block (the
// Pallas grid's row axis); each thread owns a contiguous run of at most
// kColsPerThread target columns and keeps H and E of those columns in
// registers. Column 0 is the DP boundary, column j holds target base j-1.
// Only columns 0..nt are computed: a cell never feeds a cell to its left, so
// this gives the values the Pallas kernel's 128-lane buckets give.
//
// F collapses to one inclusive prefix max of b[j] + ge*j per row (the
// reference's `_cummax`): a sequential max over the thread's own columns,
// then a block-wide exclusive scan of the thread totals (warp shuffles, then
// one shared slot per warp).
//
// What bounds it on the H100: each row is three block barriers and a few
// dozen integer ops per column, so a row costs barrier latency rather than
// bandwidth or arithmetic; the pointer bits are one byte per cell, written
// once and read once by the walk. The design keeps many independent blocks
// in flight to hide the barriers (one block per problem, small shared
// memory; `-Xptxas -v` in the build log gives registers and shared bytes)
// and leaves faster row schemes (anti-diagonals, several problems a warp)
// to later work. The walk is sequential on thread 0: O(nq+nt) loads.
//
// Tie-breaks follow `row_step` exactly: H takes diag >= E >= F (a strict >
// switches), E and F extend only on strict >, column 0 is forced to code 1.
// The best cell is the lowest column among a row's maxima and moves to a
// later row only on a strict >. The zdrop latch excludes its triggering row
// and every row after it; the end bonus applies on row nq only.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 2304;  // 2303 target bases + the boundary column
constexpr int kColsPerThread = kMaxCols / kThreads;
constexpr int kMaxQuery = 2048;
constexpr int kNeg = -1000000000;  // the reference's NEG
constexpr int kPad = 9;            // target code of lane 0: matches nothing
constexpr unsigned kFull = 0xffffffffu;

struct Scoring {
  int match, mismatch, go, ge, end_bonus, zdrop;
};

// (value, column) pair with the first-max order: larger value, then lower
// column.
__device__ __forceinline__ bool beats(int v, int a, int bv, int ba) {
  return v > bv || (v == bv && a < ba);
}

// Best cell so far (score, row, column) and the zdrop latch state.
struct Best {
  int score = 0, i = 0, j = 0, raw_best = 0;
  bool cut = false;
};

// Fold row i's maximum (the per-warp first maxima in row_v / row_a) into
// the best cell: `_dp_kernel`'s zdrop latch, end bonus and strict-> rule.
__device__ __forceinline__ void take_row(Best& b, const int* row_v,
                                         const int* row_a, int i, int nq,
                                         const Scoring& sc) {
  int raw = INT_MIN, arg = INT_MAX;
  for (int w = 0; w < kWarps; ++w)
    if (beats(row_v[w], row_a[w], raw, arg)) {
      raw = row_v[w];
      arg = row_a[w];
    }
  bool valid = true;
  if (sc.zdrop > 0) {
    b.cut = b.cut || raw < b.raw_best - sc.zdrop;
    valid = !b.cut;
    if (valid && raw > b.raw_best) b.raw_best = raw;
  }
  if (valid) {
    const int row_best = raw + (i == nq ? sc.end_bonus : 0);
    if (row_best > b.score) {
      b.score = row_best;
      b.i = i;
      b.j = arg;
    }
  }
}

__global__ void __launch_bounds__(kThreads) dp_fused_kernel(
    const uint8_t* __restrict__ genome, const uint8_t* __restrict__ oriented,
    const int64_t* __restrict__ q_lo, const int64_t* __restrict__ t_lo,
    const int32_t* __restrict__ nq_arr, const int32_t* __restrict__ nt_arr,
    const uint8_t* __restrict__ mode_arr, const int64_t* __restrict__ ptr_off,
    uint8_t* __restrict__ ptr_all, int32_t* __restrict__ meta,
    int32_t* __restrict__ ks, int8_t* __restrict__ buf, int64_t steps,
    Scoring sc) {
  __shared__ uint8_t s_q[kMaxQuery];
  __shared__ int s_warp_max[kWarps];
  __shared__ int s_f_last[kThreads], s_b_last[kThreads], s_h_last[kThreads];
  __shared__ int s_row_v[kWarps], s_row_a[kWarps];
  __shared__ int s_final;

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = nq_arr[p], nt = nt_arr[p];
  const int width = nt + 1;
  const int mode = mode_arr[p];
  const bool rev = mode == 2;  // extend_left: both slices read reversed
  const int per = (width + kThreads - 1) / kThreads;
  const int base = tid * per;
  const int ncol = max(0, min(per, width - base));
  uint8_t* ptr = ptr_all + ptr_off[p];

  for (int k = tid; k < nq; k += kThreads)
    s_q[k] = oriented[rev ? q_lo[p] + nq - 1 - k : q_lo[p] + k];

  int H[kColsPerThread], E[kColsPerThread], B[kColsPerThread];
  int F[kColsPerThread], D[kColsPerThread], V[kColsPerThread];
  uint8_t T[kColsPerThread];
  unsigned e_ext = 0;  // bit c: E of column base+c extended in this row
  int h_last = 0;
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    if (c < ncol) {
      const int j = base + c;
      T[c] = j == 0 ? kPad : genome[rev ? t_lo[p] + nt - j : t_lo[p] + j - 1];
      H[c] = j == 0 ? 0 : -(sc.go + sc.ge * j);  // `_row0`
      E[c] = kNeg;
      ptr[j] = j == 0 ? 0 : (2 | (j > 1 ? 8 : 0));
      h_last = H[c];
    }
  }
  if (ncol > 0) s_h_last[tid] = h_last;

  Best best;  // thread 0's copy is the one that counts
  __syncthreads();

  for (int i = 1; i <= nq; ++i) {
    if (tid == 0 && i > 1) take_row(best, s_row_v, s_row_a, i - 1, nq, sc);

    // phase A: E (column-local), diag, b = max(diag, E), local prefix max
    const int qc = s_q[i - 1];
    int h_left = tid == 0 ? kNeg : s_h_last[tid - 1];
    int run = INT_MIN;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      if (c < ncol) {
        const int j = base + c;
        const int open_e = H[c] - sc.go - sc.ge;
        const int ext_e = E[c] - sc.ge;
        const int e = max(open_e, ext_e);
        e_ext = ext_e > open_e ? (e_ext | (1u << c)) : (e_ext & ~(1u << c));
        const int diag = h_left + (T[c] == qc ? sc.match : -sc.mismatch);
        h_left = H[c];
        const int b = j == 0 ? e : max(diag, e);
        E[c] = e;
        D[c] = diag;
        B[c] = b;
        run = max(run, b + sc.ge * j);
        V[c] = run;
      }
    }
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = INT_MIN;
    if (lane == 31) s_warp_max[warp] = incl;
    __syncthreads();

    // phase B: F[j] = scan[j-1] - go - ge*j
    for (int w = 0; w < warp; ++w) excl = max(excl, s_warp_max[w]);
    int f_last = 0, b_last = 0;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      if (c < ncol) {
        const int j = base + c;
        const int scan_prev = c == 0 ? excl : max(excl, V[c > 0 ? c - 1 : 0]);
        F[c] = j == 0 ? kNeg - sc.go : scan_prev - sc.go - sc.ge * j;
        f_last = F[c];
        b_last = B[c];
      }
    }
    if (ncol > 0) {
      s_f_last[tid] = f_last;
      s_b_last[tid] = b_last;
    }
    __syncthreads();

    // phase C: F-extend bit, H and its source, pointer byte, row max
    int f_prev = tid == 0 ? kNeg : s_f_last[tid - 1];
    int b_prev = tid == 0 ? kNeg : s_b_last[tid - 1];
    int row_v = INT_MIN, row_a = INT_MAX;
    uint8_t* prow = ptr + static_cast<int64_t>(i) * width;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      if (c < ncol) {
        const int j = base + c;
        const bool f_ext = (f_prev - sc.ge) > (b_prev - sc.go - sc.ge);
        f_prev = F[c];
        b_prev = B[c];
        int h = D[c], code = 0;
        if (E[c] > h) {
          h = E[c];
          code = 1;
        }
        if (F[c] > h) {
          h = F[c];
          code = 2;
        }
        if (j == 0) {
          h = E[c];
          code = 1;
        }
        prow[j] = static_cast<uint8_t>(code | (((e_ext >> c) & 1u) << 2) |
                                       (f_ext ? 8 : 0));
        H[c] = h;
        h_last = h;
        if (h > row_v) {
          row_v = h;
          row_a = j;
        }
      }
    }
    if (ncol > 0) {
      s_h_last[tid] = h_last;
      if (i == nq && base + ncol == width) s_final = h_last;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_down_sync(kFull, row_v, off);
      const int oa = __shfl_down_sync(kFull, row_a, off);
      if (beats(ov, oa, row_v, row_a)) {
        row_v = ov;
        row_a = oa;
      }
    }
    if (lane == 0) {
      s_row_v[warp] = row_v;
      s_row_a[warp] = row_a;
    }
    __syncthreads();
  }
  if (tid != 0) return;
  take_row(best, s_row_v, s_row_a, nq, nq, sc);

  int32_t* m = meta + 4 * static_cast<int64_t>(p);
  m[0] = best.i;
  m[1] = best.j;
  m[2] = best.score;
  m[3] = s_final;

  // the walk: `_traceback_walk`'s state machine (0 H, 1 E, 2 F)
  int qi = nq, tj = nt;
  if (mode != 0) {
    const bool dead = best.score <= 0;
    qi = dead ? 0 : best.i;
    tj = dead ? 0 : best.j;
  }
  int8_t* out = buf + static_cast<int64_t>(p) * steps;
  int state = 0;
  int64_t k = 0;
  while ((qi > 0 || tj > 0) && k < steps) {
    const int bits = ptr[static_cast<int64_t>(qi) * width + tj];
    if (state == 0) {
      const int code = bits & 3;
      if (code == 0 && qi > 0 && tj > 0) {
        out[k++] = 1;
        --qi;
        --tj;
      } else {
        state = code == 1 ? 1 : 2;
      }
    } else if (state == 1) {
      out[k++] = 2;
      state = (bits >> 2) & 1 ? 1 : 0;
      --qi;
    } else {
      out[k++] = 3;
      state = (bits >> 3) & 1 ? 2 : 0;
      --tj;
    }
  }
  ks[p] = static_cast<int32_t>(k);
}

}  // namespace

// Launch on `stream` for n problems. The caller allocates every buffer:
// ptr_scratch holds (nq+1)*(nt+1) bytes per problem at ptr_off, buf is
// zero-filled (n, steps) with steps >= nq+nt for every problem. Returns
// cudaGetLastError() after the launch.
extern "C" int mando_dp_fused(const void* genome, const void* oriented,
                              const void* q_lo, const void* t_lo,
                              const void* nq, const void* nt,
                              const void* mode, const void* ptr_off,
                              void* ptr_scratch, void* meta, void* ks,
                              void* buf, int64_t n, int64_t steps, int match,
                              int mismatch, int gap_open, int gap_extend,
                              int end_bonus, int zdrop, void* stream) {
  if (n > 0) {
    const Scoring sc{match, mismatch, gap_open, gap_extend, end_bonus, zdrop};
    dp_fused_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(genome),
        static_cast<const uint8_t*>(oriented),
        static_cast<const int64_t*>(q_lo), static_cast<const int64_t*>(t_lo),
        static_cast<const int32_t*>(nq), static_cast<const int32_t*>(nt),
        static_cast<const uint8_t*>(mode),
        static_cast<const int64_t*>(ptr_off),
        static_cast<uint8_t*>(ptr_scratch), static_cast<int32_t*>(meta),
        static_cast<int32_t*>(ks), static_cast<int8_t*>(buf), steps, sc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mando_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
