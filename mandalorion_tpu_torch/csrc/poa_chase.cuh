// The diagonal chase that both POA traceback walks share: csrc/poa_walk.cu
// (reverse-order steps, replacing mandalorion_tpu/poa/kernels.py
// `_traceback_from_mats`) and csrc/poa_sweep.cu (run-compressed records,
// replacing mandalorion_tpu/poa/pallas_kernel.py `_poa_walk_kernel` and its
// prologue `_walk_prologue_fn`). The two kernels differ only in what a step
// writes; everything that reads the matrices on the common path is here.
//
// What bounds a walk on the H100: it is a pointer chase. Each step reads a
// packed cell at the position the step before decoded (a window offset, then
// the cell), and the matrices lie in device memory or L2: one to two round
// trips a step, while the bytes moved are a few a step. What this file does
// about it, for a warp a problem:
//
// - `end_rank`: the row a walk starts from, found by a strided loop over the
//   rows by 32 lanes and one warp reduction with the first-max rule (larger
//   value, then lower rank), in place of one thread's serial loop.
// - `chase_diagonals`: diagonal steps, nearly all of a consensus round's
//   path, walked inside a tile staged in shared memory: the hpack cells of
//   the kTileRows rows at and before the current one, at the kTileCols columns
//   at and before the current one. A row of 32 neighbouring columns is one
//   asynchronous copy (cp.async, zero-filled where a cell lies outside its
//   row's window), and all 64 are in flight together: the rows' window offsets
//   come from a block of kOffRows offsets staged the same way, two a lane,
//   handed round by shuffles, so nothing waits for memory between the copies.
//   A diagonal step moves one column back and at least one row back, to
//   whichever predecessor rank the cell names (a consensus graph's bubbles
//   make that some rows back about every other step, so guessing "the row
//   before" would not get far), and stays inside the tile for up to 32 steps:
//   one round trip to memory a tile, a shared-memory read a step, and that
//   read is started before the step it follows has been checked. Lane x keeps
//   step x's row, so the caller writes the tile's steps from all lanes at once.
//
// A cell outside its row's stored window reads as 0, in the tile as in
// `cell`: the tile is an exact copy of what `cell` would read.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace poa_chase {

constexpr int kTileRows = 64;  // rows of a staged tile
constexpr int kTileCols = 32;  // its columns: one a lane
constexpr int kOffRows = 256;  // window offsets staged at once
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

// One problem's matrices as a walk reads them.
struct Problem {
  const int32_t* off_row;  // (n_cap + 1) window offsets
  int64_t mat;             // element offset of the problem's first matrix row
  int W;

  // matrix value at row t, ABSOLUTE column j; 0 outside the stored window
  __device__ __forceinline__ int cell(const int32_t* m, int t, int j) const {
    const int rel = j - off_row[t];
    return (rel >= 0 && rel < W) ? m[mat + static_cast<int64_t>(t) * W + rel]
                                 : 0;
  }
};

// The matrix row a walk starts from: the first maximum of endcol over real
// end ranks 1 <= t <= n, 0 when there is none. The same in every lane.
__device__ __forceinline__ int end_rank(const uint8_t* ends_b,
                                        const int32_t* endcol_b, int n,
                                        int lane) {
  int r = 0, best = kNeg - 1;
  for (int t = 1 + lane; t <= n; t += 32) {
    const int v = ends_b[t - 1] ? endcol_b[t] : kNeg - 1;
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
  return r;
}

// A warp's staging buffers in shared memory and which rows' offsets the
// offset block holds.
struct Stage {
  int32_t* tile;  // kTileRows * kTileCols cells
  int32_t* soff;  // kOffRows offsets
  int off_lo = 0, off_hi = -1;
};

// Where a tile's work goes: nothing, unless tools/poa_kernel_phases.py
// builds a copy whose probe counts cycles between the marks.
struct NoProbe {
  __device__ __forceinline__ void mark(int) {}
};

// What a chase did: x diagonal steps (lane i < x holds step i's matrix row in
// my_row), the row the walker is at after them, and whether it stopped on a
// cell that is not a diagonal step (hv, still to be taken by the caller's
// state machine at row r and column j - x).
struct Chase {
  int x, my_row, r;
  bool have_hv;
  int hv;
};

// Walk the diagonal steps from (row r >= 1, column j) that stay inside one
// staged tile, at most `room` of them. Every lane calls it with the same
// arguments and gets the same result, my_row aside. The probe's marks 1, 2
// and 3 close the offsets, the tile copies and the chase.
template <class Probe>
__device__ __forceinline__ Chase chase_diagonals(Stage& sg, const Problem& pb,
                                                 const int32_t* hp, int r,
                                                 int j, int room, int lane,
                                                 Probe& probe) {
  __syncwarp();  // the tile's readers are done
  if (r > sg.off_hi || max(r - (kTileRows - 1), 0) < sg.off_lo) {
    sg.off_hi = r;
    sg.off_lo = max(r - (kOffRows - 1), 0);
    for (int i = lane; i <= sg.off_hi - sg.off_lo; i += 32)
      sg.soff[i] = pb.off_row[sg.off_lo + i];
    __syncwarp();
  }
  probe.mark(1);
  // The tile's rows' offsets, two a lane, handed round by shuffles; then one
  // asynchronous copy a row straight into the tile (a cell that is not stored
  // copies no bytes and is filled with 0). Nothing here waits for memory
  // before the last copy has started, and none sits behind a branch, so all
  // the rows are in flight together.
  const int off_a = sg.soff[max(r - lane, sg.off_lo) - sg.off_lo];
  const int off_b = sg.soff[max(r - 32 - lane, sg.off_lo) - sg.off_lo];
  int off_of[kTileRows];
#pragma unroll
  for (int y = 0; y < kTileRows; ++y)
    off_of[y] = __shfl_sync(kFull, y < 32 ? off_a : off_b, y & 31);
#pragma unroll
  for (int y = 0; y < kTileRows; ++y) {
    const int rel = j - lane - off_of[y];
    const bool ok = r - y >= 1 && rel >= 0 && rel < pb.W;
    cp_async4_or_zero(
        sg.tile + y * kTileCols + lane,
        hp + (ok ? static_cast<int64_t>(r - y) * pb.W + rel : 0), ok);
  }
  cp_async_wait_all();
  __syncwarp();
  probe.mark(2);

  const int32_t* tile = sg.tile;
  int x = 0, y = 0;  // the walker is at row r - y, column j - x
  int my_row = 0;
  bool left = false, have_hv = false;
  int next_r = r;
  int hv = tile[0];
  while (x < room) {
    if ((hv & 7) != 0) {  // not a diagonal: the caller's state machine
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
    // the boundary row, a row outside the tile (a predecessor is an earlier
    // row: anything else is not the forward's output, and is followed from a
    // new tile), or the tile's last column
    if (next_r < 1 || back >= kTileRows || back <= y || x >= kTileCols) {
      left = true;
      break;
    }
    y = back;
    hv = ahead;
  }
  probe.mark(3);
  return Chase{x, my_row, left ? next_r : r - y, have_hv, hv};
}

}  // namespace poa_chase
