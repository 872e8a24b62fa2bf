// Traceback walk over the POA forward's packed matrices: one alignment path per
// (graph, query) problem, as reverse-order (qi, rank) steps.
//
// Replaces mandalorion_tpu/poa/kernels.py `_traceback_from_mats`, the XLA
// while_loop that walks the matrices of `_poa_fwd_kernel` / `_align_rows` on
// the device (vmapped over the batch as `_traceback_from_mats_batch`). Input
// is csrc/poa_fwd.cu's output contract; output is buf (B, max_steps, 2) int32
// and ks (B,) int32: buf[b][0..ks[b]) are the steps from the path's end to
// its start, qi == -1 for a deleted node and rank == -1 for an inserted
// query base, which the host threads into its graph. Entries of buf at and
// beyond ks[b] are not written.
//
// What bounds it on the H100: the walk is a pointer chase, one to two round
// trips to memory a step for a few bytes (csrc/poa_chase.cuh). The design
// takes the round trips out of the chase:
//
// - A warp a problem, kWarps problems a block; the end rank by 32 lanes and
//   a warp reduction (`poa_chase::end_rank`).
// - Diagonal steps, nearly all of a consensus round's path, are chased inside
//   a 64 x 32 tile of hpack staged by cp.async (`poa_chase::chase_diagonals`,
//   shared with csrc/poa_sweep.cu), and the tile's steps are written by their
//   lanes at once.
// - A run of inserted bases (state 4, and the boundary row) needs no loads
//   and is written by all lanes at once.
// - Any other step (an insertion's origin, a deletion pointer, the op before
//   an insertion) takes the reference's state machine, one step at a time from
//   device memory, all lanes in step.
//
// The state machine is the reference's, step for step: states 0 H (final
// op), 1 H0 (pre-insertion op), 2 D1, 3 D2, 4 INS (emitting an insertion run
// down to column tgt). A cell outside its row's stored window reads as 0.
// The tier-2 insertion origin is the upper half of opack read as unsigned
// (origins reach 65535).

#include <cstdint>

#include <cuda_runtime.h>

#include "poa_chase.cuh"

namespace {

constexpr int kWarps = 4;  // problems a block, one a warp
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads) poa_walk_kernel(
    const int32_t* __restrict__ nn, const uint8_t* __restrict__ ends,
    const int32_t* __restrict__ ql, const int32_t* __restrict__ hpack,
    const int32_t* __restrict__ opack, const int32_t* __restrict__ d1p,
    const int32_t* __restrict__ d2p, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ endcol, int32_t* __restrict__ buf,
    int32_t* __restrict__ ks, int64_t n_problems, int n_cap, int W,
    int max_steps) {
  __shared__ int32_t s_tile[kWarps][poa_chase::kTileRows *
                                    poa_chase::kTileCols];
  __shared__ int32_t s_off[kWarps][poa_chase::kOffRows];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= n_problems) return;  // a whole warp: nothing below joins warps
  poa_chase::Stage sg{s_tile[warp], s_off[warp]};

  const int64_t rows = static_cast<int64_t>(n_cap) + 1;
  const int n = nn[b], qlen = ql[b];
  const poa_chase::Problem pb{offs + b * rows, b * rows * W, W};
  const int32_t* hp = hpack + pb.mat;
  poa_chase::NoProbe probe;

  int r = poa_chase::end_rank(ends + b * n_cap, endcol + b * rows, n, lane);

  int2* out =
      reinterpret_cast<int2*>(buf) + b * static_cast<int64_t>(max_steps);
  // the walk's state is the same in every lane
  int st = 0, j = qlen, tgt = 0, k = 0;
  while ((r > 0 || j > 0) && r >= 0 && k < max_steps) {
    if (st == 4 || (st <= 1 && r == 0)) {
      // inserted bases j-1, j-2, ...: down to column tgt inside a run (then
      // the cell's pre-insertion op), down to column 0 on the boundary row
      const int whole = st == 4 ? max(1, j - tgt) : j;
      const int c = min(whole, max_steps - k);
      for (int i = lane; i < c; i += 32) out[k + i] = make_int2(j - 1 - i, -1);
      st = st == 4 ? 1 : 0;  // a run cut by max_steps ends the walk anyway
      j -= c;
      k += c;
      continue;
    }

    int hv = 0;
    bool have_hv = false;
    if (st == 0) {
      // r >= 1: the diagonal steps inside a tile at rows r .. r-63, columns
      // j .. j-31
      probe.mark(0);
      const poa_chase::Chase ch = poa_chase::chase_diagonals(
          sg, pb, hp, r, j, max_steps - k, lane, probe);
      if (lane < ch.x) out[k + lane] = make_int2(j - lane - 1, ch.my_row - 1);
      r = ch.r;
      j -= ch.x;
      k += ch.x;
      probe.mark(4);
      if (!ch.have_hv) continue;
      hv = ch.hv;
      have_hv = true;
    }

    // one step of the reference's state machine, every lane in step, lane 0
    // storing; its boundary-row branch (states 0 and 1 at row 0) is the run
    // above
    int qi = j - 1, rk = -1;
    bool emit = true;
    if (st == 0 || st == 1) {
      if (!have_hv) hv = pb.cell(hpack, r, j);
      const int opv = st == 1 ? (hv >> 3) & 7 : hv & 7;
      if (opv == 0) {  // diagonal into node r-1
        rk = r - 1;
        r = (hv >> 6) - 2;
        st = 0;
        --j;
      } else if (opv == 1 || opv == 3) {  // insertion run back to an origin
        const unsigned ov = static_cast<unsigned>(pb.cell(opack, r, j));
        tgt = opv == 1 ? static_cast<int>(ov & 0xFFFFu)
                       : static_cast<int>(ov >> 16);
        st = j - 1 > tgt ? 4 : 1;
        --j;
      } else {  // enter a deletion state: nothing to emit yet
        emit = false;
        st = opv == 2 ? 2 : 3;
      }
    } else {  // st 2 or 3: node r-1 deleted, follow the pointer
      const int dptr = pb.cell(st == 2 ? d1p : d2p, r, j);
      qi = -1;
      rk = r - 1;
      r = dptr >> 1;
      if ((dptr & 1) == 0) st = 0;
    }
    if (emit) {
      if (lane == 0) out[k] = make_int2(qi, rk);
      ++k;
    }
  }
  if (lane == 0) ks[b] = k;
}

}  // namespace

// Launch on `stream` for n problems. The caller allocates buf (n, max_steps,
// 2) and ks (n) and need fill neither; the matrices are mando_poa_fwd's.
// Returns cudaGetLastError() after the launch.
extern "C" int mando_poa_walk(const void* nn, const void* ends, const void* ql,
                              const void* hpack, const void* opack,
                              const void* d1p, const void* d2p,
                              const void* offs, const void* endcol, void* buf,
                              void* ks, int64_t n, int n_cap, int W,
                              int max_steps, void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
    poa_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(nn), static_cast<const uint8_t*>(ends),
        static_cast<const int32_t*>(ql), static_cast<const int32_t*>(hpack),
        static_cast<const int32_t*>(opack), static_cast<const int32_t*>(d1p),
        static_cast<const int32_t*>(d2p), static_cast<const int32_t*>(offs),
        static_cast<const int32_t*>(endcol), static_cast<int32_t*>(buf),
        static_cast<int32_t*>(ks), n, n_cap, W, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}
