// Traceback walk over the POA forward's packed matrices, emitted as
// run-compressed records: one record per diagonal step, per deleted node and
// per whole insertion run.
//
// Replaces mandalorion_tpu/poa/pallas_kernel.py `_poa_walk_kernel` (built by
// `_poa_walk_fn`) together with its on-device prologue `_walk_prologue_fn`,
// which picks the end rank. Input is csrc/poa_fwd.cu's output contract;
// output is recs (B, max_rec, 2) int32 and counts (B,) int32. recs[b][0..
// counts[b]) are problem b's records from the path's end to its start:
//
//   rec0 = qi_hi | type << 16,  rec1 = qi_lo | (rank + 2) << 16
//   type 0 DIAG: one (qi_hi, rank) step
//   type 1 DEL:  one (-1, rank) step
//   type 2 INS:  steps (qi, -1) for qi = qi_hi down to qi_lo, rank field 1
//
// which the host's poa_graph_apply_runs_c expands to the step walk's exact
// sequence. Entries at and beyond counts[b] are not written.
//
// The TPU kernel sweeps every matrix row from the last to the first for every
// tile of problems, with three unrolled transitions a row and masked lane sums
// for each cell it reads, because its compiler cannot index a lane by a
// value. None of that binds here: a thread reads m[t][j - offs[t]] directly,
// so this kernel follows each path and touches no row its walker is not in.
// What is kept is the transition table, line by line, and the record stream.
//
// Layout: one thread per problem, as csrc/poa_walk.cu. The walk is a pointer
// chase; what bounds it on the H100 is the latency of two dependent loads a
// transition (the row's window offset, then the cell), not the few bytes they
// move. Against the step walk it saves the loop iterations and the 8-byte
// stores of every inserted base after the first of a run. It runs on the
// forward's stream right behind it, with no host fetch in between: the end
// rank is found here.
//
// States: 0 H (final op), 1 H0 (pre-insertion op), 2 D1, 3 D2. A cell outside
// its row's stored window reads as 0. The tier-2 insertion origin is the
// upper half of opack read as unsigned (origins reach 65535).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kNeg = -1000000000;  // the reference's NEG
constexpr int kDiag = 0, kDel = 1, kIns = 2;

__global__ void __launch_bounds__(kThreads) poa_sweep_kernel(
    const int32_t* __restrict__ nn, const uint8_t* __restrict__ ends,
    const int32_t* __restrict__ ql, const int32_t* __restrict__ hpack,
    const int32_t* __restrict__ opack, const int32_t* __restrict__ d1p,
    const int32_t* __restrict__ d2p, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ endcol, int32_t* __restrict__ recs,
    int32_t* __restrict__ counts, int64_t n_problems, int n_cap, int W,
    int max_rec) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= n_problems) return;
  const int64_t rows = static_cast<int64_t>(n_cap) + 1;
  const int n = nn[b];
  const int32_t* off_row = offs + b * rows;
  const int64_t mat = b * rows * W;

  // matrix value at row t, ABSOLUTE column j; 0 outside the stored window
  auto cell = [&](const int32_t* m, int t, int j) -> int {
    const int rel = j - off_row[t];
    return (rel >= 0 && rel < W) ? m[mat + static_cast<int64_t>(t) * W + rel]
                                 : 0;
  };

  // end rank: first max of H[t][qlen] over real end ranks t <= n, else 0
  int r = 0, best = kNeg - 1;
  for (int t = 1; t <= n; ++t) {
    const int v = ends[b * n_cap + (t - 1)] ? endcol[b * rows + t] : kNeg - 1;
    if (v > best) {
      best = v;
      r = t;
    }
  }

  int32_t* out = recs + b * static_cast<int64_t>(max_rec) * 2;
  int st = 0, j = ql[b], k = 0;
  // A walker leaves its row within three transitions (insertion run -> H0
  // -> deletion entry -> deletion), which bounds the loop on any input.
  for (int64_t left = 3 * rows;
       left > 0 && k < max_rec && !((r <= 0 && j <= 0) || r < 0); --left) {
    int type = -1, hi = 0, lo = 0, rk = r - 1;
    if (st <= 1) {
      if (r == 0) {  // boundary row: the rest of the query is one run
        if (j >= 1) {
          type = kIns;
          hi = j - 1;
          rk = -1;
        }
        st = 0;
        j = 0;
      } else {
        const int hv = cell(hpack, r, j);
        const int opv = st == 1 ? (hv >> 3) & 7 : hv & 7;
        if (opv == 0) {  // diagonal into node r-1
          type = kDiag;
          hi = j - 1;
          r = (hv >> 6) - 2;
          st = 0;
          --j;
        } else if (opv == 1 || opv == 3) {  // insertion run to its origin
          const unsigned ov = static_cast<unsigned>(cell(opack, r, j));
          const int origin = opv == 1 ? static_cast<int>(ov & 0xFFFFu)
                                      : static_cast<int>(ov >> 16);
          if (j >= 1) {
            type = kIns;
            hi = j - 1;
            lo = origin;
            rk = -1;
          }
          st = 1;
          j = origin;
        } else {  // enter a deletion state: nothing to emit yet
          st = opv == 2 ? 2 : 3;
        }
      }
    } else {  // node r-1 deleted, follow the pointer
      const int dptr = cell(st == 2 ? d1p : d2p, r, j);
      type = kDel;
      r = dptr >> 1;
      if ((dptr & 1) == 0) st = 0;
    }
    if (type >= 0) {
      // packed through unsigned arithmetic: hi is -1 for a diagonal read
      // outside every window, and the shifts must not overflow a signed int
      out[2 * k] = static_cast<int32_t>(static_cast<uint32_t>(hi) |
                                        static_cast<uint32_t>(type) << 16);
      out[2 * k + 1] = static_cast<int32_t>(
          static_cast<uint32_t>(lo) | static_cast<uint32_t>(rk + 2) << 16);
      ++k;
    }
  }
  counts[b] = k;
}

}  // namespace

// Launch on `stream` for n problems. The caller allocates recs (n, max_rec,
// 2) and counts (n); the matrices are mando_poa_fwd's. Returns
// cudaGetLastError() after the launch.
extern "C" int mando_poa_sweep(const void* nn, const void* ends,
                               const void* ql, const void* hpack,
                               const void* opack, const void* d1p,
                               const void* d2p, const void* offs,
                               const void* endcol, void* recs, void* counts,
                               int64_t n, int n_cap, int W, int max_rec,
                               void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    poa_sweep_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(nn), static_cast<const uint8_t*>(ends),
        static_cast<const int32_t*>(ql), static_cast<const int32_t*>(hpack),
        static_cast<const int32_t*>(opack), static_cast<const int32_t*>(d1p),
        static_cast<const int32_t*>(d2p), static_cast<const int32_t*>(offs),
        static_cast<const int32_t*>(endcol), static_cast<int32_t*>(recs),
        static_cast<int32_t*>(counts), n, n_cap, W, max_rec);
  }
  return static_cast<int>(cudaGetLastError());
}
