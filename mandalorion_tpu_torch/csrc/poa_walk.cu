// Traceback walk over the POA forward's packed matrices: one alignment path per
// (graph, query) problem, as reverse-order (qi, rank) steps.
//
// Replaces mandalorion_tpu/poa/kernels.py `_traceback_from_mats`, the XLA
// while_loop that walks the matrices of `_poa_fwd_kernel` / `_align_rows` on
// the device (vmapped over the batch as `_traceback_from_mats_batch`). Input
// is csrc/poa_fwd.cu's output contract; output is buf (B, max_steps, 2) int32
// and ks (B,) int32: buf[b][0..ks[b]) are the steps from the path's end to
// its start, qi == -1 for a deleted node and rank == -1 for an inserted
// query base, which the host threads into its graph.
//
// Layout: one thread per problem. The walk is a pointer chase: each step
// reads one or two packed cells at the position the previous step decoded,
// so there is nothing to share between threads and nothing to vectorise.
// What bounds it on the H100 is the latency of those dependent loads (a
// window offset, then the cell), one to two round trips to L2 or device
// memory per step, for about nodes + query steps; the bytes moved are a few
// per step. It runs on the forward's stream right behind it, and threads of
// a warp walk different problems, so a chunk's walks overlap. A walk that
// splits one path across a warp is left to later work.
//
// The state machine is the reference's, step for step: states 0 H (final
// op), 1 H0 (pre-insertion op), 2 D1, 3 D2, 4 INS (emitting an insertion run
// down to column tgt). A cell outside its row's stored window reads as 0.
// The tier-2 insertion origin is the upper half of opack read as unsigned
// (origins reach 65535).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kNeg = -1000000000;  // the reference's NEG

__global__ void __launch_bounds__(kThreads) poa_walk_kernel(
    const int32_t* __restrict__ nn, const uint8_t* __restrict__ ends,
    const int32_t* __restrict__ ql, const int32_t* __restrict__ hpack,
    const int32_t* __restrict__ opack, const int32_t* __restrict__ d1p,
    const int32_t* __restrict__ d2p, const int32_t* __restrict__ offs,
    const int32_t* __restrict__ endcol, int32_t* __restrict__ buf,
    int32_t* __restrict__ ks, int64_t n_problems, int n_cap, int W,
    int max_steps) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= n_problems) return;
  const int64_t rows = static_cast<int64_t>(n_cap) + 1;
  const int n = nn[b], qlen = ql[b];
  const int32_t* off_row = offs + b * rows;
  const int64_t mat = b * rows * W;

  // matrix value at row t, ABSOLUTE column j; 0 outside the stored window
  auto cell = [&](const int32_t* m, int t, int j) -> int {
    const int rel = j - off_row[t];
    return (rel >= 0 && rel < W) ? m[mat + static_cast<int64_t>(t) * W + rel]
                                 : 0;
  };

  // end rank: first max of H[t][qlen] over real end ranks t <= n
  int r = 0, best = kNeg - 1;
  for (int t = 1; t <= n; ++t) {
    const int v = ends[b * n_cap + (t - 1)] ? endcol[b * rows + t] : kNeg - 1;
    if (v > best) {
      best = v;
      r = t;
    }
  }

  int32_t* out = buf + b * static_cast<int64_t>(max_steps) * 2;
  int st = 0, j = qlen, tgt = 0, k = 0;
  while ((r > 0 || j > 0) && r >= 0 && k < max_steps) {
    int qi = j - 1, rk = -1;
    bool emit = true;
    if (st == 0 || st == 1) {
      const int hv = cell(hpack, r, j);
      const int opv = st == 1 ? (hv >> 3) & 7 : hv & 7;
      if (r == 0) {  // boundary row: the rest of the query is inserted
        st = 0;
        --j;
      } else if (opv == 0) {  // diagonal into node r-1
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
    } else if (st == 2 || st == 3) {  // node r-1 deleted, follow the pointer
      const int dptr = cell(st == 2 ? d1p : d2p, r, j);
      qi = -1;
      rk = r - 1;
      r = dptr >> 1;
      if ((dptr & 1) == 0) st = 0;
    } else {  // st == 4: inside an insertion run
      st = j - 1 > tgt ? 4 : 1;
      --j;
    }
    if (emit) {
      out[2 * k] = qi;
      out[2 * k + 1] = rk;
      ++k;
    }
  }
  ks[b] = k;
}

}  // namespace

// Launch on `stream` for n problems. The caller allocates buf (n, max_steps,
// 2) and ks (n); the matrices are mando_poa_fwd's. Returns
// cudaGetLastError() after the launch.
extern "C" int mando_poa_walk(const void* nn, const void* ends, const void* ql,
                              const void* hpack, const void* opack,
                              const void* d1p, const void* d2p,
                              const void* offs, const void* endcol, void* buf,
                              void* ks, int64_t n, int n_cap, int W,
                              int max_steps, void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
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
