// Collinear chain DP over one read candidate's diagonal segments.
//
// Replaces mandalorion_tpu/align/chain_kernel.py `_chain_fn` (an XLA scan
// over segment index i, vmapped over candidates) and returns the packed
// int16 row of `chain_batch_rows`: msb parent entries (-1 for none and for
// padding), the best lane, and the best score's float32 bits as two int16
// halves (low half first). The native fill stage (stage_fill_batch_c) reads
// these rows at width msb+3.
//
// What bounds it on the H100: the DP is a chain of up to 511 dependent steps
// (score[i] needs every score[j], j < i), with a few dozen operations a
// (j, i) pair and 20 bytes a segment; the main path's candidates have tens of
// segments, at most 64 on slice-20k's first batch, a few carry up to 512.
// The time goes to the steps' latency, not to bytes or arithmetic. What the
// design does about it:
//
// - A warp a candidate, up to kWarps candidates a block (fewer when a launch
//   has too few to give each SM a block), no shared memory and no barrier.
//   Lane l owns the receiving segments i = 32k + l, k < K (K = msb / 32
//   rounded up to a power of two, at least 2, a template parameter; lanes
//   past msb take no part): their qs, qe, ts, te, gain = cov * match and a
//   running first maximum (best, arg) sit in registers. Only the
//   candidate's n_seg segments are read.
// - The loop is turned inside out, so that no step needs a reduction. The
//   reference takes, at step i, the first maximum over j < i; here, at step
//   j, the lane that owns j finalizes score[j] = best_j > gain_j ? best_j :
//   gain_j (the reference's strict `better` test against score0 = gain), a
//   shuffle broadcasts it with qe_j, te_j and -len_j, and every lane with
//   j < i < n computes cand(j, i) and keeps it only on a strict >. As j
//   ascends, the strict > keeps the lowest j among equal candidates, as
//   jnp.argmax does. A step's critical path is one shuffle, three rounded
//   float operations and a compare; validity, overlap and cost depend on no
//   score and issue off that path. A lane's receiving lanes k go kGroup at a
//   time with no branch inside a group, so their chains interleave. A long
//   candidate's step is bound by one warp issuing its pair bodies; a team of
//   warps would divide them, and is not built: candidates of hundreds of
//   segments are rare.
// - Candidates run longest first, in an order the host computes (the
//   wrapper's `order`), so a 512-segment candidate does not start last and
//   the warps of a block have similar lengths.
// - The end: each lane takes the first maximum of its lanes' scores (padding
//   lanes at NEG) in ascending k, a warp reduction breaks ties to the lower
//   lane; for n_seg = 0 that is lane 0 with NEG's bits, as in the reference.
//   The kernel writes the whole row.
//
// Float32 rounding must match XLA and numpy exactly:
//   cand = ((score[j] + cov[i]*match) - cost) - overlap*match
//   cost = intron_penalty + 0.01*frexp_exponent(max(diff, 1))   (intron)
//        | indel_open + indel_scale*diff                         (indel)
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn), so no a*b+c contracts into an FMA; the build also passes
// -fmad=false. The frexp exponent of a normal float d >= 1 is its biased
// exponent minus 126, read from the bits.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // candidates a block at most
constexpr int kGroup = 4;  // receiving lane sets a lane updates together
constexpr float kNegScore = -1e18f;  // the reference's NEG
constexpr unsigned kFull = 0xffffffffu;

struct ChainParams {
  int match, min_intron, max_intron;
  float intron_penalty, indel_open, indel_scale;
};

__device__ __forceinline__ bool beats(float v, int a, float bv, int ba) {
  return v > bv || (v == bv && a < ba);
}

// frexpf's exponent of d >= 1 (a normal float): d = 0.5..1 x 2^e.
__device__ __forceinline__ float frexp_exponent(float d) {
  return static_cast<float>(
      static_cast<int>((__float_as_uint(d) >> 23) & 0xffu) - 126);
}

// K: receiving segments a lane (32 K >= msb).
template <int K>
__global__ void __launch_bounds__(kWarps * 32) chain_rows_kernel(
    const int32_t* __restrict__ qs, const int32_t* __restrict__ qe,
    const int32_t* __restrict__ ts, const int32_t* __restrict__ te,
    const int32_t* __restrict__ cov, const int32_t* __restrict__ n_seg,
    const int32_t* __restrict__ order, int16_t* __restrict__ rows,
    int64_t n_cand, int msb, ChainParams cp) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                    (threadIdx.x >> 5);
  if (w >= n_cand) return;
  const int64_t b = order ? order[w] : w;
  if (b < 0 || b >= n_cand) return;  // not a permutation: the row stays
  // n_seg's range is the caller's to check; clamped here for memory safety
  const int n = min(max(n_seg[b], 0), msb);
  const int64_t in_row = b * msb;
  const float match = static_cast<float>(cp.match);

  int qs_i[K], qe_i[K], ts_i[K], te_i[K], arg[K];
  float gain[K], best[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * k + lane;
    const bool real = i < n;
    qs_i[k] = real ? qs[in_row + i] : 0;
    qe_i[k] = real ? qe[in_row + i] : 0;
    ts_i[k] = real ? ts[in_row + i] : 0;
    te_i[k] = real ? te[in_row + i] : 0;
    gain[k] = real ? __fmul_rn(static_cast<float>(cov[in_row + i]), match)
                   : kNegScore;
    // a padding lane's best never falls below a candidate: no update
    best[k] = real ? -INFINITY : INFINITY;
    arg[k] = -1;
  }

#pragma unroll
  for (int kj = 0; kj < K; ++kj) {
    if (32 * kj >= n - 1) break;
    const int s_end = min(32, n - 1 - 32 * kj);  // j = 32 kj + s < n - 1
    for (int s = 0; s < s_end; ++s) {
      const int j = 32 * kj + s;
      const float own = best[kj] > gain[kj] ? best[kj] : gain[kj];
      const float score_j = __shfl_sync(kFull, own, s);
      const int qe_j = __shfl_sync(kFull, qe_i[kj], s);
      const int te_j = __shfl_sync(kFull, te_i[kj], s);
      const int nlen_j = __shfl_sync(kFull, qs_i[kj] - qe_i[kj], s);
      // receivers in groups of kGroup lane sets with no branch inside a
      // group, so that their independent chains interleave
#pragma unroll
      for (int k0 = kj; k0 < K; k0 += kGroup) {
        if (32 * k0 >= n) break;
#pragma unroll
        for (int k = k0; k < k0 + kGroup && k < K; ++k) {
          const int dq = qs_i[k] - qe_j, dt = ts_i[k] - te_j;
          const bool valid = dq > nlen_j && dt > nlen_j &&
                             dt <= cp.max_intron && qe_j <= qe_i[k] &&
                             te_j <= te_i[k] && (k > kj || lane > s);
          const float overlap = static_cast<float>(max(max(-dq, -dt), 0));
          const int gap = max(dt, 0) - max(dq, 0);
          const float diff = static_cast<float>(abs(gap));
          const float cost =
              gap >= cp.min_intron
                  ? __fadd_rn(cp.intron_penalty,
                              __fmul_rn(0.01f,
                                        frexp_exponent(fmaxf(diff, 1.0f))))
                  : __fadd_rn(cp.indel_open,
                              __fmul_rn(cp.indel_scale, diff));
          const float cand =
              __fsub_rn(__fsub_rn(__fadd_rn(score_j, gain[k]), cost),
                        __fmul_rn(overlap, match));
          // a padding lane's best is +inf: it never takes a candidate
          if (valid && cand > best[k]) {
            best[k] = cand;
            arg[k] = j;
          }
        }
      }
    }
  }

  int16_t* out = rows + b * (msb + 3);
  float v = -INFINITY;
  int a = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = 32 * k + lane;
    const bool better = i < n && best[k] > gain[k];
    const float score = i < n ? (better ? best[k] : gain[k]) : kNegScore;
    if (i < msb) {
      out[i] = static_cast<int16_t>(better ? arg[k] : -1);
      if (score > v) {  // k ascends: the lane's first maximum
        v = score;
        a = i;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oa = __shfl_xor_sync(kFull, a, off);
    if (beats(ov, oa, v, a)) {
      v = ov;
      a = oa;
    }
  }
  if (lane == 0) {
    const unsigned bits = __float_as_uint(v);
    out[msb] = static_cast<int16_t>(a);
    out[msb + 1] = static_cast<int16_t>(bits & 0xffffu);
    out[msb + 2] = static_cast<int16_t>(bits >> 16);
  }
}

template <int K>
void launch(const void* qs, const void* qe, const void* ts, const void* te,
            const void* cov, const void* n_seg, const void* order,
            void* rows, int64_t n, int msb, int per_block,
            const ChainParams& cp, cudaStream_t stream) {
  const int64_t blocks = (n + per_block - 1) / per_block;
  chain_rows_kernel<K><<<static_cast<unsigned>(blocks), per_block * 32, 0,
                         stream>>>(
      static_cast<const int32_t*>(qs), static_cast<const int32_t*>(qe),
      static_cast<const int32_t*>(ts), static_cast<const int32_t*>(te),
      static_cast<const int32_t*>(cov), static_cast<const int32_t*>(n_seg),
      static_cast<const int32_t*>(order), static_cast<int16_t*>(rows), n,
      msb, cp);
}

}  // namespace

// Launch on `stream` for n candidates of msb lanes each (1 <= msb <= 512);
// rows is (n, msb+3) int16, written whole. order: n int32, a permutation of
// the candidates in the order they should start (longest first), or null for
// index order. per_block: candidates a block, 1..4. match, intron_penalty,
// indel_open and indel_scale are chain_kernel.py's MATCH, INTRON_PENALTY,
// INDEL_OPEN and INDEL_SCALE, the one scoring its plain version uses too.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// msb or per_block outside its range).
extern "C" int mando_chain_rows(const void* qs, const void* qe,
                                const void* ts, const void* te,
                                const void* cov, const void* n_seg,
                                const void* order, void* rows, int64_t n,
                                int msb, int per_block, int match,
                                int min_intron, int max_intron,
                                float intron_penalty, float indel_open,
                                float indel_scale, void* stream) {
  if (msb < 1 || msb > 512 || per_block < 1 || per_block > kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const ChainParams cp{match,          min_intron, max_intron,
                         intron_penalty, indel_open, indel_scale};
    const auto s = static_cast<cudaStream_t>(stream);
    if (msb <= 64)
      launch<2>(qs, qe, ts, te, cov, n_seg, order, rows, n, msb, per_block,
                cp, s);
    else if (msb <= 128)
      launch<4>(qs, qe, ts, te, cov, n_seg, order, rows, n, msb, per_block,
                cp, s);
    else if (msb <= 256)
      launch<8>(qs, qe, ts, te, cov, n_seg, order, rows, n, msb, per_block,
                cp, s);
    else
      launch<16>(qs, qe, ts, te, cov, n_seg, order, rows, n, msb, per_block,
                 cp, s);
  }
  return static_cast<int>(cudaGetLastError());
}
