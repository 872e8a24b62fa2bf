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
// which the host's poa_graphs_apply_c expands to the step walk's exact
// sequence. Entries at and beyond counts[b] are not written.
//
// The TPU kernel sweeps every matrix row from the last to the first for every
// tile of problems, with three unrolled transitions a row and masked lane sums
// for each cell it reads, because its compiler cannot index a lane by a
// value. None of that binds here: the walk follows each path and touches no
// row its walker is not in. What is kept is the transition table, line by
// line, and the record stream.
//
// What bounds it on the H100: it follows exactly the paths of the step walk
// (csrc/poa_walk.cu), a pointer chase of one to two round trips to memory a
// step for a few bytes. So it runs on the step walk's scheme, from the shared
// csrc/poa_chase.cuh:
//
// - A warp a problem, kWarps problems a block; the end rank by 32 lanes and
//   a warp reduction, on the forward's stream right behind it, with no host
//   fetch in between.
// - Diagonal steps are chased inside a 64 x 32 tile of hpack staged by
//   cp.async; lane x writes the tile's diagonal record x. Each diagonal step
//   counts as one transition of the 3 x rows bound, and a tile is cut where
//   its records would pass max_rec.
// - An insertion run is one record (lane 0), never expanded: against the
//   step walk this saves the loop iterations and stores of every inserted
//   base after the first of a run.
// - Deletions and the op before an insertion take the reference's state
//   machine, one transition at a time from device memory, all lanes in step.
//
// States: 0 H (final op), 1 H0 (pre-insertion op), 2 D1, 3 D2. A cell outside
// its row's stored window reads as 0. The tier-2 insertion origin is the
// upper half of opack read as unsigned (origins reach 65535).

#include <cstdint>

#include <cuda_runtime.h>

#include "poa_chase.cuh"

namespace {

constexpr int kWarps = 4;  // problems a block, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kDiag = 0, kDel = 1, kIns = 2;

// (rec0, rec1) of one record, packed through unsigned arithmetic: hi is -1 for
// a diagonal read outside every window, and the shifts must not overflow a
// signed int
__device__ __forceinline__ int2 record(int type, int hi, int lo, int rk) {
  return make_int2(
      static_cast<int32_t>(static_cast<uint32_t>(hi) |
                           static_cast<uint32_t>(type) << 16),
      static_cast<int32_t>(static_cast<uint32_t>(lo) |
                           static_cast<uint32_t>(rk + 2) << 16));
}

__global__ void __launch_bounds__(kThreads) poa_sweep_kernel(
    const int32_t* __restrict__ nn, const uint8_t* __restrict__ ends,
    const int32_t* __restrict__ ql, const int32_t* __restrict__ hpack,
    const int32_t* __restrict__ opack, const int32_t* __restrict__ d1p,
    const int32_t* __restrict__ d2p, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ endcol, int32_t* __restrict__ recs,
    int32_t* __restrict__ counts, int64_t n_problems, int n_cap, int W,
    int max_rec) {
  __shared__ int32_t s_tile[kWarps][poa_chase::kTileRows *
                                    poa_chase::kTileCols];
  __shared__ int32_t s_off[kWarps][poa_chase::kOffRows];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= n_problems) return;  // a whole warp: nothing below joins warps
  poa_chase::Stage sg{s_tile[warp], s_off[warp]};

  const int64_t rows = static_cast<int64_t>(n_cap) + 1;
  const poa_chase::Problem pb{offs + b * rows, b * rows * W, W};
  const int32_t* hp = hpack + pb.mat;
  poa_chase::NoProbe probe;

  int r = poa_chase::end_rank(ends + b * n_cap, endcol + b * rows, nn[b],
                              lane);

  int2* out = reinterpret_cast<int2*>(recs) + b * static_cast<int64_t>(max_rec);
  // the walk's state is the same in every lane
  int st = 0, j = ql[b], k = 0;
  // A walker leaves its row within three transitions (insertion run -> H0
  // -> deletion entry -> deletion), which bounds the loop on any input.
  for (int64_t left = 3 * rows;
       left > 0 && k < max_rec && !((r <= 0 && j <= 0) || r < 0);) {
    int hv = 0;
    bool have_hv = false;
    if (st == 0 && r >= 1) {
      // the diagonal steps inside a tile at rows r .. r-63, columns j ..
      // j-31, each one transition, cut at max_rec
      const int room = static_cast<int>(
          min(left, static_cast<int64_t>(max_rec - k)));
      const poa_chase::Chase ch =
          poa_chase::chase_diagonals(sg, pb, hp, r, j, room, lane, probe);
      if (lane < ch.x)
        out[k + lane] = record(kDiag, j - 1 - lane, 0, ch.my_row - 1);
      r = ch.r;
      j -= ch.x;
      k += ch.x;
      left -= ch.x;
      if (!ch.have_hv) continue;
      hv = ch.hv;
      have_hv = true;
    }

    // one transition of the reference's table, every lane in step, lane 0
    // storing
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
        if (!have_hv) hv = pb.cell(hpack, r, j);
        const int opv = st == 1 ? (hv >> 3) & 7 : hv & 7;
        if (opv == 0) {  // diagonal into node r-1
          type = kDiag;
          hi = j - 1;
          r = (hv >> 6) - 2;
          st = 0;
          --j;
        } else if (opv == 1 || opv == 3) {  // insertion run to its origin
          const unsigned ov = static_cast<unsigned>(pb.cell(opack, r, j));
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
      const int dptr = pb.cell(st == 2 ? d1p : d2p, r, j);
      type = kDel;
      r = dptr >> 1;
      if ((dptr & 1) == 0) st = 0;
    }
    if (type >= 0) {
      if (lane == 0) out[k] = record(type, hi, lo, rk);
      ++k;
    }
    --left;
  }
  if (lane == 0) counts[b] = k;
}

}  // namespace

// Launch on `stream` for n problems. The caller allocates recs (n, max_rec,
// 2) and counts (n) and need fill neither; the matrices are mando_poa_fwd's.
// Returns cudaGetLastError() after the launch.
extern "C" int mando_poa_sweep(const void* nn, const void* ends,
                               const void* ql, const void* hpack,
                               const void* opack, const void* d1p,
                               const void* d2p, const void* offs,
                               const void* endcol, void* recs, void* counts,
                               int64_t n, int n_cap, int W, int max_rec,
                               void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
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
