// Collinear chain DP over one read candidate's diagonal segments.
//
// Replaces mandalorion_tpu/align/chain_kernel.py `_chain_fn` (an XLA scan
// over segment index i, vmapped over candidates) and returns the packed
// int16 row of `chain_batch_rows`: msb parent entries, the best index, and
// the best score's float32 bits as two int16 halves (low half first). The
// native fill stage (stage_fill_batch_c) reads these rows at width msb+3.
//
// Layout: one block per candidate. The loop over i is sequential; the
// threads cover the predecessor lanes j < i, and the block takes the first
// maximum (lowest j among equal scores) as jnp.argmax does.
//
// Float32 rounding must match XLA and numpy exactly:
//   cand = ((score[j] + cov[i]*match) - cost) - overlap*match
//   cost = intron_penalty + 0.01*frexp_exponent(max(diff, 1))   (intron)
//        | indel_open + indel_scale*diff                         (indel)
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn), so no a*b+c contracts into an FMA; the build also passes
// -fmad=false.
//
// What bounds it on the H100: at most 511 steps of two block barriers each,
// with O(i) arithmetic per step spread over the block; the segment arrays
// (5 x 512 int32) and the running scores sit in shared memory, so a
// candidate reads device memory once. Candidates run as independent blocks.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSeg = 512;
constexpr float kNegScore = -1e18f;  // the reference's NEG
constexpr unsigned kFull = 0xffffffffu;

struct ChainParams {
  int match, min_intron, max_intron;
  float intron_penalty, indel_open, indel_scale;
};

__device__ __forceinline__ bool beats(float v, int a, float bv, int ba) {
  return v > bv || (v == bv && a < ba);
}

// First-max (value, index) over the block; every thread gets the result.
__device__ void block_argmax(float& v, int& a, float* s_v, int* s_a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, off);
    const int oa = __shfl_down_sync(kFull, a, off);
    if (beats(ov, oa, v, a)) {
      v = ov;
      a = oa;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_v[warp] = v;
    s_a[warp] = a;
  }
  __syncthreads();
  v = s_v[0];
  a = s_a[0];
  for (int w = 1; w < kWarps; ++w)
    if (beats(s_v[w], s_a[w], v, a)) {
      v = s_v[w];
      a = s_a[w];
    }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) chain_rows_kernel(
    const int32_t* __restrict__ qs, const int32_t* __restrict__ qe,
    const int32_t* __restrict__ ts, const int32_t* __restrict__ te,
    const int32_t* __restrict__ cov, const int32_t* __restrict__ n_seg,
    int16_t* __restrict__ rows, int msb, ChainParams cp) {
  __shared__ int s_qs[kMaxSeg], s_qe[kMaxSeg], s_ts[kMaxSeg], s_te[kMaxSeg];
  __shared__ float s_cov[kMaxSeg], s_score[kMaxSeg];
  __shared__ int s_parent[kMaxSeg];
  __shared__ float s_v[kWarps];
  __shared__ int s_a[kWarps];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = n_seg[b];
  const int64_t in_row = static_cast<int64_t>(b) * msb;
  const float match = static_cast<float>(cp.match);
  for (int j = tid; j < msb; j += kThreads) {
    s_qs[j] = qs[in_row + j];
    s_qe[j] = qe[in_row + j];
    s_ts[j] = ts[in_row + j];
    s_te[j] = te[in_row + j];
    s_cov[j] = static_cast<float>(cov[in_row + j]);
    s_score[j] = j < n ? __fmul_rn(s_cov[j], match) : kNegScore;
    s_parent[j] = -1;
  }
  __syncthreads();

  for (int i = 1; i < n; ++i) {
    const int qs_i = s_qs[i], qe_i = s_qe[i], ts_i = s_ts[i], te_i = s_te[i];
    const float gain = __fmul_rn(s_cov[i], match);
    float v = -INFINITY;
    int a = INT_MAX;
    for (int j = tid; j < i; j += kThreads) {
      const int dq = qs_i - s_qe[j], dt = ts_i - s_te[j];
      const int len_j = s_qe[j] - s_qs[j];
      if (!(dq > -len_j && dt > -len_j && dt <= cp.max_intron &&
            s_qe[j] <= qe_i && s_te[j] <= te_i))
        continue;
      const float overlap = static_cast<float>(max(max(-dq, -dt), 0));
      const int gap = max(dt, 0) - max(dq, 0);
      const float diff = static_cast<float>(abs(gap));
      float cost;
      if (gap >= cp.min_intron) {
        int e;
        frexpf(fmaxf(diff, 1.0f), &e);
        cost = __fadd_rn(cp.intron_penalty,
                         __fmul_rn(0.01f, static_cast<float>(e)));
      } else {
        cost = __fadd_rn(cp.indel_open, __fmul_rn(cp.indel_scale, diff));
      }
      const float cand = __fsub_rn(
          __fsub_rn(__fadd_rn(s_score[j], gain), cost),
          __fmul_rn(overlap, match));
      if (cand > v) {  // lanes ascend within a thread: keeps the first max
        v = cand;
        a = j;
      }
    }
    block_argmax(v, a, s_v, s_a);
    if (tid == 0 && v > s_score[i]) {
      s_score[i] = v;
      s_parent[i] = a;
    }
    __syncthreads();
  }

  float v = -INFINITY;
  int a = INT_MAX;
  for (int j = tid; j < msb; j += kThreads)
    if (beats(s_score[j], j, v, a)) {
      v = s_score[j];
      a = j;
    }
  block_argmax(v, a, s_v, s_a);
  int16_t* out = rows + static_cast<int64_t>(b) * (msb + 3);
  for (int j = tid; j < msb; j += kThreads)
    out[j] = static_cast<int16_t>(s_parent[j]);
  if (tid == 0) {
    const unsigned bits = __float_as_uint(s_score[a]);
    out[msb] = static_cast<int16_t>(a);
    out[msb + 1] = static_cast<int16_t>(bits & 0xffffu);
    out[msb + 2] = static_cast<int16_t>(bits >> 16);
  }
}

}  // namespace

// Launch on `stream` for n candidates of msb lanes each (msb <= 512); rows is
// (n, msb+3) int16. match, intron_penalty, indel_open and indel_scale are
// chain_kernel.py's MATCH, INTRON_PENALTY, INDEL_OPEN and INDEL_SCALE, the one
// scoring its plain version uses too. Returns cudaGetLastError() after the
// launch.
extern "C" int mando_chain_rows(const void* qs, const void* qe,
                                const void* ts, const void* te,
                                const void* cov, const void* n_seg,
                                void* rows, int64_t n, int msb, int match,
                                int min_intron, int max_intron,
                                float intron_penalty, float indel_open,
                                float indel_scale, void* stream) {
  if (n > 0) {
    const ChainParams cp{match,          min_intron, max_intron,
                         intron_penalty, indel_open, indel_scale};
    chain_rows_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(qs), static_cast<const int32_t*>(qe),
        static_cast<const int32_t*>(ts), static_cast<const int32_t*>(te),
        static_cast<const int32_t*>(cov), static_cast<const int32_t*>(n_seg),
        static_cast<int16_t*>(rows), msb, cp);
  }
  return static_cast<int>(cudaGetLastError());
}
