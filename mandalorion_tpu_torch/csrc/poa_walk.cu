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
// What bounds it on the H100: the walk is a pointer chase. Each step reads a
// packed cell at the position the step before decoded (a window offset, then
// the cell), and the matrices lie in device memory or L2: one to two round
// trips a step, for about nodes + query steps, while the bytes moved are a few
// a step. The design takes the round trips out of the chase:
//
// - A warp a problem, kWarps problems a block. The end rank is a strided
//   loop over the rows by 32 lanes and one warp reduction with the first-max
//   rule (larger value, then lower rank).
// - Diagonal steps, nearly all of a consensus round's path, are walked inside
//   a tile staged in shared memory: the hpack cells of the kTileRows rows at
//   and before the current one, at the kTileCols columns at and before the
//   current one. A row of 32 neighbouring columns is one asynchronous copy
//   (cp.async, zero-filled where a cell lies outside its row's window), and
//   all 64 are in flight together: the rows' window offsets come from a
//   block of 256 offsets staged the same way, two a lane, handed round by
//   shuffles, so nothing waits for memory between the copies. A diagonal step
//   moves one column back and at least one row back, to whichever
//   predecessor rank the cell names (a consensus graph's bubbles make that
//   some rows back about every other step, so guessing "the row before" would
//   not get far), and stays inside the tile for up to 32 steps: one round
//   trip to memory a tile, a shared-memory read a step, and that read is
//   started before the step it follows has been checked. Lane x keeps step
//   x's row, and the tile's steps are written by their lanes at once.
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

namespace {

constexpr int kWarps = 4;  // problems a block, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 64;   // rows of a staged tile
constexpr int kTileCols = 32;   // its columns: one a lane
constexpr int kOffRows = 256;   // window offsets staged at once
static_assert(kTileRows == 64 && kTileCols == 32,
              "a lane holds two of a tile's row offsets and one column");
constexpr int kNeg = -1000000000;  // the reference's NEG
constexpr unsigned kFull = 0xffffffffu;

// Copy 4 bytes from global to shared memory without passing a register, or
// store 0 there when `copy` is false (the source is then not read).
__device__ __forceinline__ void cp_async4_or_zero(int32_t* dst,
                                                  const int32_t* src,
                                                  bool copy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(copy ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__global__ void __launch_bounds__(kThreads) poa_walk_kernel(
    const int32_t* __restrict__ nn, const uint8_t* __restrict__ ends,
    const int32_t* __restrict__ ql, const int32_t* __restrict__ hpack,
    const int32_t* __restrict__ opack, const int32_t* __restrict__ d1p,
    const int32_t* __restrict__ d2p, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ endcol, int32_t* __restrict__ buf,
    int32_t* __restrict__ ks, int64_t n_problems, int n_cap, int W,
    int max_steps) {
  __shared__ int32_t s_tile[kWarps][kTileRows * kTileCols];
  __shared__ int32_t s_off[kWarps][kOffRows];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= n_problems) return;  // a whole warp: nothing below joins warps
  int32_t* tile = s_tile[warp];
  int32_t* soff = s_off[warp];

  const int64_t rows = static_cast<int64_t>(n_cap) + 1;
  const int n = nn[b], qlen = ql[b];
  const int32_t* off_row = offs + b * rows;
  const int64_t mat = b * rows * W;
  const int32_t* hp = hpack + mat;

  // matrix value at row t, ABSOLUTE column j; 0 outside the stored window
  auto cell = [&](const int32_t* m, int t, int j) -> int {
    const int rel = j - off_row[t];
    return (rel >= 0 && rel < W) ? m[mat + static_cast<int64_t>(t) * W + rel]
                                 : 0;
  };

  // end rank: first max of H[t][qlen] over real end ranks t <= n
  int r = 0, best = kNeg - 1;
  for (int t = 1 + lane; t <= n; t += 32) {
    const int v = ends[b * n_cap + (t - 1)] ? endcol[b * rows + t] : kNeg - 1;
    if (v > best) {
      best = v;
      r = t;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best, d);
    const int ot = __shfl_xor_sync(kFull, r, d);
    if (ov > best || (ov == best && ot < r)) {
      best = ov;
      r = ot;
    }
  }

  int2* out =
      reinterpret_cast<int2*>(buf) + b * static_cast<int64_t>(max_steps);
  // the walk's state is the same in every lane
  int st = 0, j = qlen, tgt = 0, k = 0;
  int off_lo = 0, off_hi = -1;  // rows whose offsets soff holds
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
      // r >= 1: stage rows r .. r-63 at columns j .. j-31 and walk the
      // diagonal steps that stay inside
      __syncwarp();  // the tile's readers are done
      if (r > off_hi || max(r - (kTileRows - 1), 0) < off_lo) {
        off_hi = r;
        off_lo = max(r - (kOffRows - 1), 0);
        for (int i = lane; i <= off_hi - off_lo; i += 32)
          soff[i] = off_row[off_lo + i];
        __syncwarp();
      }
      // The tile's rows' offsets, two a lane, handed round by shuffles; then
      // one asynchronous copy a row straight into the tile (a cell that is
      // not stored copies no bytes and is filled with 0). Nothing here waits
      // for memory before the last copy has started, and none sits behind a
      // branch, so all the rows are in flight together.
      const int off_a = soff[max(r - lane, off_lo) - off_lo];
      const int off_b = soff[max(r - 32 - lane, off_lo) - off_lo];
      int off_of[kTileRows];
#pragma unroll
      for (int y = 0; y < kTileRows; ++y)
        off_of[y] = __shfl_sync(kFull, y < 32 ? off_a : off_b, y & 31);
#pragma unroll
      for (int y = 0; y < kTileRows; ++y) {
        const int rel = j - lane - off_of[y];
        const bool ok = r - y >= 1 && rel >= 0 && rel < W;
        cp_async4_or_zero(tile + y * kTileCols + lane,
                          hp + (ok ? static_cast<int64_t>(r - y) * W + rel : 0),
                          ok);
      }
      cp_async_wait_all();
      __syncwarp();

      const int room = max_steps - k;
      int y = 0, x = 0;  // the walker is at row r - y, column j - x
      int my_row = 0;
      bool left = false;
      int next_r = r;
      hv = tile[0];
      while (x < room) {
        if ((hv & 7) != 0) {  // not a diagonal: the state machine below
          have_hv = true;
          break;
        }
        if (lane == x) my_row = r - y;  // lane x keeps step x's row
        ++x;
        next_r = (hv >> 6) - 2;  // diagonal into node r-y-1, on to next_r
        const int back = r - next_r;
        // the cell the step leads to is read before the step is checked
        // (clamped into the tile), so the checks cost the chase nothing
        const int ahead = tile[min(max(back, 0), kTileRows - 1) * kTileCols +
                               min(x, kTileCols - 1)];
        // the boundary row, a row outside the tile (a predecessor is an
        // earlier row: anything else is not the forward's output, and is
        // followed from a new tile), or the tile's last column
        if (next_r < 1 || back >= kTileRows || back <= y || x >= kTileCols) {
          left = true;
          break;
        }
        y = back;
        hv = ahead;
      }
      if (lane < x) out[k + lane] = make_int2(j - lane - 1, my_row - 1);
      r = left ? next_r : r - y;
      j -= x;
      k += x;
      if (!have_hv) continue;
    }

    // one step of the reference's state machine, every lane in step, lane 0
    // storing; its boundary-row branch (states 0 and 1 at row 0) is the run
    // above
    int qi = j - 1, rk = -1;
    bool emit = true;
    if (st == 0 || st == 1) {
      if (!have_hv) hv = cell(hpack, r, j);
      const int opv = st == 1 ? (hv >> 3) & 7 : hv & 7;
      if (opv == 0) {  // diagonal into node r-1
        rk = r - 1;
        r = (hv >> 6) - 2;
        st = 0;
        --j;
      } else if (opv == 1 || opv == 3) {  // insertion run back to an origin
        const unsigned ov = static_cast<unsigned>(cell(opack, r, j));
        tgt = opv == 1 ? static_cast<int>(ov & 0xFFFFu)
                       : static_cast<int>(ov >> 16);
        st = j - 1 > tgt ? 4 : 1;
        --j;
      } else {  // enter a deletion state: nothing to emit yet
        emit = false;
        st = opv == 2 ? 2 : 3;
      }
    } else {  // st 2 or 3: node r-1 deleted, follow the pointer
      const int dptr = cell(st == 2 ? d1p : d2p, r, j);
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
