// Native minimizer extraction — C++ twin of align/encode.py's vectorized
// rolling-hash minimizers (bit-identical output; tests assert it).
//
// The host-side data path feeding the TPU: encode -> rolling polynomial
// hash (mod 2^64) -> xorshift scramble -> windowed leftmost-min selection.
// Replaces the role mappy's C layer plays in the reference (SURVEY §2.2).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
#include <thread>
#include <vector>

extern "C" {

static const uint64_t B = 0x9E3779B97F4A7C15ULL;

// h ^= h >> 33; h *= C; h ^= h >> 33  (matches encode.kmer_hashes)
static inline uint64_t scramble(uint64_t h) {
    h ^= h >> 33;
    h *= 0xFF51AFD7ED558CCDULL;
    h ^= h >> 33;
    return h;
}

// Encode ASCII bases to 0-4 codes (A=0 C=1 G=2 T=3, other=4).
void encode_seq(const char* seq, int64_t n, uint8_t* out) {
    static uint8_t lut[256];
    static bool init = false;
    if (!init) {
        memset(lut, 4, 256);
        lut[(unsigned char)'A'] = lut[(unsigned char)'a'] = 0;
        lut[(unsigned char)'C'] = lut[(unsigned char)'c'] = 1;
        lut[(unsigned char)'G'] = lut[(unsigned char)'g'] = 2;
        lut[(unsigned char)'T'] = lut[(unsigned char)'t'] = 3;
        init = true;
    }
    for (int64_t i = 0; i < n; i++) out[i] = lut[(unsigned char)seq[i]];
}

// (k, w) minimizers of encoded sequence. out_pos/out_hash must hold up to
// n - k + 1 entries. Returns the number of minimizers written.
int64_t minimizers_c(const uint8_t* codes, int64_t n, int32_t k, int32_t w,
                     int64_t* out_pos, uint64_t* out_hash) {
    int64_t m = n - k + 1;
    if (m <= 0) return 0;

    // rolling hash h[i] = sum_j (codes[i+j]+1) * B^(k-1-j)  (mod 2^64)
    // raw arrays: every element is written by the first pass before any
    // read, so vector zero-init would memset 9 bytes/kmer for nothing
    // (it dominated the whole-genome index sweep)
    std::unique_ptr<uint64_t[]> h(new uint64_t[m]);
    std::unique_ptr<uint8_t[]> valid(new uint8_t[m]);
    uint64_t bk = 1;  // B^(k-1)
    for (int32_t j = 0; j < k - 1; j++) bk *= B;
    uint64_t cur = 0;
    int32_t bad_run = 0;
    for (int64_t i = 0; i < n; i++) {
        cur = cur * B + (uint64_t)(codes[i] + 1);
        if (codes[i] >= 4) bad_run = k;  // poisons k windows
        else if (bad_run > 0) bad_run--;
        if (i >= k - 1) {
            int64_t p = i - k + 1;
            h[p] = scramble(cur);
            valid[p] = bad_run == 0 ? 1 : 0;
            cur -= (uint64_t)(codes[p] + 1) * bk;  // pre-multiply next round
        }
    }

    const uint64_t INF = 0xFFFFFFFFFFFFFFFFULL;
    int64_t count = 0;
    if (m <= w) {
        uint64_t best = INF;
        int64_t arg = -1;
        for (int64_t i = 0; i < m; i++) {
            uint64_t hv = valid[i] ? h[i] : INF;
            if (hv < best) { best = hv; arg = i; }
        }
        bool any_valid = false;
        for (int64_t i = 0; i < m; i++) if (valid[i]) any_valid = true;
        if (!any_valid) return 0;
        out_pos[0] = arg;
        out_hash[0] = h[arg];
        return 1;
    }

    // leftmost window-min per window, dedup consecutive (monotone deque)
    std::unique_ptr<int64_t[]> deque_idx(new int64_t[m]);
    int64_t head = 0, tail = 0;  // [head, tail)
    int64_t last_emitted = -1;
    for (int64_t i = 0; i < m; i++) {
        uint64_t hv = valid[i] ? h[i] : INF;
        // strict <: keeps the LEFTMOST minimum at the deque front
        while (tail > head) {
            uint64_t back = valid[deque_idx[tail - 1]]
                                ? h[deque_idx[tail - 1]] : INF;
            if (back > hv) tail--; else break;
        }
        deque_idx[tail++] = i;
        int64_t win_start = i - w + 1;
        if (deque_idx[head] < win_start) head++;
        if (win_start >= 0) {
            int64_t p = deque_idx[head];
            if (p != last_emitted && valid[p]) {
                out_pos[count] = p;
                out_hash[count] = h[p];
                count++;
                last_emitted = p;
            }
        }
    }
    return count;
}

}  // extern "C"

extern "C" {

// Fused seeding: minimizers -> bucketed index lookup (max_occ repeat
// filter) -> anchor expansion -> per-chromosome diagonal-segment collapse.
// One call per read orientation replaces four numpy round-trips
// (align/aligner.py _chain_for). Output is bit-identical to the numpy
// path: anchors sorted by (chrom, diag, t) collapse into maximal
// same-diagonal runs with spacing <= merge_gap + k, exactly
// align/chain.py collapse_anchors.
//
// Returns the segment count written, or -needed if cap is too small
// (caller re-invokes with a larger cap).
struct Seg { int32_t chrom; int64_t qs, qe, ts, te, na, cov; };
struct Anchor { int32_t chrom; int64_t diag, t, q; };

// chrom = searchsorted(chrom_offsets, g, 'right') - 1
static inline int32_t chrom_of(int64_t g, const int64_t* chrom_offsets,
                               int64_t n_chroms) {
    int64_t cl = 0, cr = n_chroms;
    while (cl < cr) {
        int64_t mid = (cl + cr) >> 1;
        if (chrom_offsets[mid] <= g) cl = mid + 1; else cr = mid;
    }
    return (int32_t)(cl - 1);
}

// Sort anchors by (chrom, diag, t) and collapse maximal same-diagonal
// runs with spacing <= merge_gap + k into segments (appended to out):
// align/chain.py collapse_anchors. Shared by build_segments (anchors of
// the replicated index) and stage_seed_anchors_c (anchors of a
// hash-sharded index's lookup).
static void collapse_anchor_runs(std::vector<Anchor>& anchors, int32_t k,
                                 int32_t merge_gap, std::vector<Seg>& out) {
    if (anchors.empty()) return;
    std::sort(anchors.begin(), anchors.end(),
              [](const Anchor& a, const Anchor& b) {
                  if (a.chrom != b.chrom) return a.chrom < b.chrom;
                  if (a.diag != b.diag) return a.diag < b.diag;
                  return a.t < b.t;
              });

    int64_t seg_start = 0;
    auto flush = [&](int64_t s, int64_t e) {
        // anchor-union coverage: k for the first anchor, min(k, dt) for
        // each following same-diagonal anchor (Segment.cov in chain.py)
        int64_t cov = k;
        for (int64_t i = s + 1; i < e; i++) {
            int64_t dt = anchors[i].t - anchors[i - 1].t;
            cov += dt < k ? dt : k;
        }
        out.push_back({anchors[s].chrom, anchors[s].q,
                       anchors[e - 1].q + k, anchors[s].t,
                       anchors[e - 1].t + k, e - s, cov});
    };
    for (size_t i = 1; i < anchors.size(); i++) {
        const Anchor &p = anchors[i - 1], &c = anchors[i];
        if (c.chrom != p.chrom || c.diag != p.diag
            || c.t - p.t > merge_gap + k) {
            flush(seg_start, (int64_t)i);
            seg_start = (int64_t)i;
        }
    }
    flush(seg_start, (int64_t)anchors.size());
}

// minimizers -> bucketed lookup -> anchor expansion -> diagonal collapse.
// Shared by seed_segments_c and seed_chain_c; output sorted by
// (chrom, diag, t) — the canonical order matching align/chain.py.
static void build_segments(
    const uint8_t* codes, int64_t n, int32_t k, int32_t w,
    int64_t max_occ, int32_t merge_gap,
    const uint64_t* sorted_hashes, const int64_t* bucket_lo,
    int32_t bucket_bits,
    const void* sorted_positions, int32_t pos_is_u32,
    const int64_t* chrom_offsets, int64_t n_chroms,
    std::vector<Seg>& out) {
    const int32_t bucket_shift = 64 - bucket_bits;
    out.clear();
    int64_t m = n - k + 1;
    if (m <= 0) return;
    std::vector<int64_t> mpos(m);
    std::vector<uint64_t> mhash(m);
    int64_t nmin = minimizers_c(codes, n, k, w, mpos.data(), mhash.data());
    if (nmin == 0) return;

    std::vector<Anchor> anchors;
    const uint32_t* pos32 = (const uint32_t*)sorted_positions;
    const int64_t* pos64 = (const int64_t*)sorted_positions;
    // pass 1: per-minimizer hit ranges
    std::vector<int64_t> rlo(nmin), rcnt(nmin);
    int64_t total_hits = 0;
    for (int64_t i = 0; i < nmin; i++) {
        uint64_t hq = mhash[i];
        uint32_t b = (uint32_t)(hq >> bucket_shift);
        if (i + 1 < nmin) {  // hide the next bucket's DRAM latency
            uint32_t bn = (uint32_t)(mhash[i + 1] >> bucket_shift);
            __builtin_prefetch(&bucket_lo[bn]);
            __builtin_prefetch(&sorted_hashes[bucket_lo[bn]]);
        }
        int64_t lo = bucket_lo[b];
        const int64_t bhi = bucket_lo[b + 1];
        int64_t l;
        if (bhi - lo <= 32) {
            // adaptive buckets hold ~8 entries: a linear scan touches one
            // or two sequential cache lines instead of log2 random probes
            while (lo < bhi && sorted_hashes[lo] < hq) lo++;
            l = lo;
            while (l < bhi && sorted_hashes[l] == hq) l++;
        } else {
            int64_t r = bhi;
            l = lo;
            while (l < r) {  // lower bound
                int64_t mid = (l + r) >> 1;
                if (sorted_hashes[mid] < hq) l = mid + 1; else r = mid;
            }
            lo = l;
            r = bhi;
            while (l < r) {  // upper bound
                int64_t mid = (l + r) >> 1;
                if (sorted_hashes[mid] <= hq) l = mid + 1; else r = mid;
            }
        }
        rlo[i] = lo;
        int64_t cnt = l - lo;
        if (cnt == 0 || cnt > max_occ) cnt = 0;
        rcnt[i] = cnt;
        total_hits += cnt;
    }
    // per-read anchor budget (minimap2's per-read mid-occ adaptation):
    // when a read seeds mostly in high-copy repeats, keep its
    // lowest-occurrence seeds and drop the most repetitive ones until
    // the expansion fits the budget — bounded work per read, and the
    // informative (rarer) seeds always survive
    const int64_t ANCHOR_BUDGET = 16384;
    if (total_hits > ANCHOR_BUDGET) {
        std::vector<int64_t> cnts;
        cnts.reserve(nmin);
        for (int64_t i = 0; i < nmin; i++)
            if (rcnt[i] > 0) cnts.push_back(rcnt[i]);
        std::sort(cnts.begin(), cnts.end());
        int64_t acc = 0, cut = 0;
        for (int64_t c : cnts) {
            if (acc + c > ANCHOR_BUDGET) break;
            acc += c;
            cut = c;
        }
        if (cut < 1) cut = 1;  // always keep unique seeds
        for (int64_t i = 0; i < nmin; i++)
            if (rcnt[i] > cut) rcnt[i] = 0;
    }
    // pass 2: expand surviving seeds into anchors
    for (int64_t i = 0; i < nmin; i++) {
        if (rcnt[i] == 0) continue;
        int64_t lo = rlo[i], l = rlo[i] + rcnt[i];
        for (int64_t j = lo; j < l; j++) {
            int64_t g = pos_is_u32 ? (int64_t)pos32[j] : pos64[j];
            anchors.push_back({chrom_of(g, chrom_offsets, n_chroms),
                               g - mpos[i], g, mpos[i]});
        }
    }
    collapse_anchor_runs(anchors, k, merge_gap, out);
}

int64_t seed_segments_c(
    const uint8_t* codes, int64_t n, int32_t k, int32_t w,
    int64_t max_occ, int32_t merge_gap,
    const uint64_t* sorted_hashes, const int64_t* bucket_lo,
    int32_t bucket_bits,
    const void* sorted_positions, int32_t pos_is_u32,
    const int64_t* chrom_offsets, int64_t n_chroms,
    int64_t cap, int32_t* out_chrom, int64_t* out_qs, int64_t* out_qe,
    int64_t* out_ts, int64_t* out_te, int64_t* out_nanchor,
    int64_t* out_cov) {
    std::vector<Seg> segs;
    build_segments(codes, n, k, w, max_occ, merge_gap, sorted_hashes,
                   bucket_lo, bucket_bits, sorted_positions, pos_is_u32,
                   chrom_offsets, n_chroms, segs);
    int64_t count = (int64_t)segs.size();
    if (count > cap) return -count;
    for (int64_t i = 0; i < count; i++) {
        out_chrom[i] = segs[i].chrom;
        out_qs[i] = segs[i].qs;
        out_qe[i] = segs[i].qe;
        out_ts[i] = segs[i].ts;
        out_te[i] = segs[i].te;
        out_nanchor[i] = segs[i].na;
        out_cov[i] = segs[i].cov;
    }
    return count;
}

// prepare_segments + chain DP + traceback + overlap trim for one
// chromosome's segments [begin, end) — C++ twin of chain.py
// prepare_segments/chain_segments with the identical float32 cost
// arithmetic (same op order; built with -ffp-contract=off so no FMA
// contraction diverges from numpy). Returns the chain length written to
// chain_idx-trimmed outputs, and the chain score via *out_score.
// prepare_segments' C++ twin (chain.py:80-105): singleton prefilter, cap
// by length, sort by (q_start, t_start) — shared by the host chain DP
// (chain_one) and the device-path candidate staging (stage_seed_batch_c).
static void prepare_segs(std::vector<Seg>& segs, int64_t max_intron,
                         int64_t max_segments) {
    if (segs.empty()) return;
    int64_t n_multi = 0, covered = 0;
    int64_t span_lo = segs[0].qs, span_hi = segs[0].qe;
    for (const Seg& s : segs) {
        if (s.na > 1) { n_multi++; covered += s.qe - s.qs; }
        span_lo = s.qs < span_lo ? s.qs : span_lo;
        span_hi = s.qe > span_hi ? s.qe : span_hi;
    }
    if (n_multi > 0 && n_multi < (int64_t)segs.size()) {
        int64_t read_span = span_hi - span_lo;
        if ((double)covered >= 0.3 * (double)(read_span > 1 ? read_span : 1)) {
            std::vector<int64_t> multi_diags;
            for (const Seg& s : segs)
                if (s.na > 1) multi_diags.push_back(s.ts - s.qs);
            std::vector<Seg> kept;
            for (const Seg& s : segs) if (s.na > 1) kept.push_back(s);
            for (const Seg& s : segs) {
                if (s.na > 1) continue;
                int64_t d = s.ts - s.qs, gap = INT64_MAX;
                for (int64_t md : multi_diags) {
                    int64_t g = d > md ? d - md : md - d;
                    gap = g < gap ? g : gap;
                }
                if (gap <= max_intron) kept.push_back(s);
            }
            segs.swap(kept);
        }
    }
    if ((int64_t)segs.size() > max_segments) {
        std::stable_sort(segs.begin(), segs.end(),
                         [](const Seg& a, const Seg& b) {
                             return (a.qe - a.qs) > (b.qe - b.qs);
                         });
        segs.resize(max_segments);
    }
    std::stable_sort(segs.begin(), segs.end(),
                     [](const Seg& a, const Seg& b) {
                         if (a.qs != b.qs) return a.qs < b.qs;
                         return a.ts < b.ts;
                     });
}

static int64_t chain_one(
    std::vector<Seg>& segs, int64_t min_intron, int64_t max_intron,
    int32_t match, float intron_penalty, float indel_open,
    float indel_scale, int64_t max_segments,
    int64_t* cq0, int64_t* cqe, int64_t* ct0, int64_t* cte,
    float* out_score) {
    *out_score = 0.0f;
    if (segs.empty()) return 0;
    prepare_segs(segs, max_intron, max_segments);
    // --- chain DP (float32, numpy op order) ---
    int64_t n = (int64_t)segs.size();
    std::vector<float> score(n);
    std::vector<int64_t> parent(n, -1);
    std::vector<float> covs(n);
    for (int64_t i = 0; i < n; i++) {
        // score term = anchor-covered length (cov), span when unknown;
        // geometry below stays span-based — mirrors chain.chain_segments
        covs[i] = (float)(segs[i].cov > 0 ? segs[i].cov
                                          : segs[i].qe - segs[i].qs);
        score[i] = covs[i] * (float)match;
    }
    const float NEGINF = -std::numeric_limits<float>::infinity();
    for (int64_t i = 1; i < n; i++) {
        float lm = (float)(covs[i] * (float)match);
        float best_cand = NEGINF;
        int64_t best_j = -1;
        for (int64_t j = 0; j < i; j++) {
            int64_t dq = segs[i].qs - segs[j].qe;
            int64_t dt = segs[i].ts - segs[j].te;
            int64_t len_j = segs[j].qe - segs[j].qs;
            if (!(dq > -len_j) || !(dt > -len_j) || dt > max_intron
                || segs[j].qe > segs[i].qe || segs[j].te > segs[i].te)
                continue;
            int64_t gap_q = dq > 0 ? dq : 0;
            int64_t gap_t = dt > 0 ? dt : 0;
            int64_t idiff = gap_t - gap_q;
            float diff = (float)(idiff < 0 ? -idiff : idiff);
            float cost;
            if (gap_t - gap_q >= min_intron) {
                int e;
                std::frexp(diff > 1.0f ? diff : 1.0f, &e);
                cost = intron_penalty + 0.01f * (float)e;
            } else {
                cost = indel_open + indel_scale * diff;
            }
            int64_t iov_q = -dq, iov_t = -dt;
            int64_t iov = iov_q > iov_t ? iov_q : iov_t;
            float overlap = (float)(iov > 0 ? iov : 0);
            float cand = (score[j] + lm) - cost - overlap * (float)match;
            if (cand > best_cand) { best_cand = cand; best_j = j; }
        }
        if (best_j >= 0 && best_cand > score[i]) {
            score[i] = best_cand;
            parent[i] = best_j;
        }
    }
    int64_t best = 0;
    for (int64_t i = 1; i < n; i++)
        if (score[i] > score[best]) best = i;
    // --- traceback + overlap trim ---
    std::vector<int64_t> idx;
    for (int64_t at = best; at >= 0; at = parent[at]) idx.push_back(at);
    std::reverse(idx.begin(), idx.end());
    int64_t out_n = 0;
    int64_t prev_q = -1, prev_t = -1;
    for (int64_t id : idx) {
        const Seg& s = segs[id];
        int64_t trim = prev_q - s.qs;
        if (prev_t - s.ts > trim) trim = prev_t - s.ts;
        if (trim < 0) trim = 0;
        int64_t q0 = s.qs + trim, t0 = s.ts + trim;
        if (q0 >= s.qe || t0 >= s.te) continue;
        cq0[out_n] = q0; cqe[out_n] = s.qe;
        ct0[out_n] = t0; cte[out_n] = s.te;
        out_n++;
        prev_q = s.qe;
        prev_t = s.te;
    }
    *out_score = score[best];
    return out_n;
}

// Fused seed + chain for one read orientation: build segments, then run
// the chain DP per chromosome (ascending, strict > keeps the first best —
// matching aligner._chain_for), returning only the winning chain.
// Outputs fit 512 entries (chain length <= segments cap). Returns the
// chain length (0 = no chain), with score/chrom via out params.
int64_t seed_chain_c(
    const uint8_t* codes, int64_t n, int32_t k, int32_t w,
    int64_t max_occ, int32_t merge_gap,
    const uint64_t* sorted_hashes, const int64_t* bucket_lo,
    int32_t bucket_bits,
    const void* sorted_positions, int32_t pos_is_u32,
    const int64_t* chrom_offsets, int64_t n_chroms,
    int64_t min_intron, int64_t max_intron, int32_t match,
    float intron_penalty, float indel_open, float indel_scale,
    int64_t max_segments,
    int64_t* cq0, int64_t* cqe, int64_t* ct0, int64_t* cte,
    float* out_score, int32_t* out_chrom) {
    std::vector<Seg> segs;
    build_segments(codes, n, k, w, max_occ, merge_gap, sorted_hashes,
                   bucket_lo, bucket_bits, sorted_positions, pos_is_u32,
                   chrom_offsets, n_chroms, segs);
    *out_score = 0.0f;
    *out_chrom = -1;
    if (segs.empty()) return 0;
    std::vector<int64_t> bq0(max_segments), bqe(max_segments),
        bt0(max_segments), bte(max_segments);
    int64_t best_n = 0;
    float best_score = 0.0f;
    size_t at = 0;
    std::vector<Seg> group;
    while (at < segs.size()) {
        int32_t c = segs[at].chrom;
        group.clear();
        while (at < segs.size() && segs[at].chrom == c)
            group.push_back(segs[at++]);
        float sc;
        int64_t cn = chain_one(group, min_intron, max_intron, match,
                               intron_penalty, indel_open, indel_scale,
                               max_segments, bq0.data(), bqe.data(),
                               bt0.data(), bte.data(), &sc);
        if (cn > 0 && sc > best_score) {
            best_score = sc;
            best_n = cn;
            *out_chrom = c;
            for (int64_t i = 0; i < cn; i++) {
                cq0[i] = bq0[i]; cqe[i] = bqe[i];
                ct0[i] = bt0[i]; cte[i] = bte[i];
            }
        }
    }
    *out_score = best_score;
    return best_n;
}

// Extended-PSL emission: C++ twin of align/aligner.py _runs_to_psl's hot
// loop. Walks concrete (op, q0, t0, len) runs over the read/genome code
// arrays, merges adjacent blocks, counts match/mismatch/indel/intron
// stats, and renders the long-form cs string (= / * / + / - / ~ tokens,
// SAM cs=long semantics) in one pass.
// ops: 0=M 1=I 2=D 3=N. stats out: [matches, mismatches, nI, I, nD, D,
// n_intron_bases, n_blocks]. Returns the cs byte length, or -needed when
// cs_cap is too small.
int64_t emit_psl_c(
    const uint8_t* q, const uint8_t* g,
    const int8_t* op, const int64_t* q0s, const int64_t* t0s,
    const int64_t* lns, int64_t n_runs,
    int64_t* stats, int64_t* blk_sizes, int64_t* blk_q, int64_t* blk_t,
    char* cs, int64_t cs_cap) {
    static const char UP[] = "ACGTN";
    static const char LO[] = "acgtn";
    int64_t matches = 0, mismatches = 0, nI = 0, I = 0, nD = 0, D = 0;
    int64_t n_bases = 0, n_blocks = 0, cl = 0;
    auto put = [&](char c) { if (cl < cs_cap) cs[cl] = c; cl++; };
    for (int64_t r = 0; r < n_runs; r++) {
        int64_t a = q0s[r], b = t0s[r], ln = lns[r];
        switch (op[r]) {
        case 0: {  // M: merge contiguous blocks, split cs at mismatches
            if (n_blocks > 0
                && blk_t[n_blocks - 1] + blk_sizes[n_blocks - 1] == b
                && blk_q[n_blocks - 1] + blk_sizes[n_blocks - 1] == a) {
                blk_sizes[n_blocks - 1] += ln;
            } else {
                blk_sizes[n_blocks] = ln;
                blk_q[n_blocks] = a;
                blk_t[n_blocks] = b;
                n_blocks++;
            }
            int64_t i = 0;
            while (i < ln) {
                if (q[a + i] == g[b + i]) {
                    put('=');
                    while (i < ln && q[a + i] == g[b + i]) {
                        put(UP[q[a + i]]);
                        matches++;
                        i++;
                    }
                } else {
                    while (i < ln && q[a + i] != g[b + i]) {
                        put('*');
                        put(LO[g[b + i]]);
                        put(LO[q[a + i]]);
                        mismatches++;
                        i++;
                    }
                }
            }
            break;
        }
        case 1:  // I: read insertion
            nI++; I += ln;
            put('+');
            for (int64_t i = 0; i < ln; i++) put(LO[q[a + i]]);
            break;
        case 2:  // D: deletion from read
            nD++; D += ln;
            put('-');
            for (int64_t i = 0; i < ln; i++) put(LO[g[b + i]]);
            break;
        default: {  // N: intron with flanking 2-mers
            n_bases += ln;
            put('~');
            put(LO[g[b]]); put(LO[g[b + 1]]);
            char num[24];
            int nn = 0;
            int64_t v = ln;
            do { num[nn++] = (char)('0' + v % 10); v /= 10; } while (v);
            while (nn) put(num[--nn]);
            put(LO[g[b + ln - 2]]); put(LO[g[b + ln - 1]]);
            break;
        }
        }
    }
    stats[0] = matches; stats[1] = mismatches; stats[2] = nI; stats[3] = I;
    stats[4] = nD; stats[5] = D; stats[6] = n_bases; stats[7] = n_blocks;
    return cl <= cs_cap ? cl : -cl;
}

// Batched affine-gap DP: scalar C++ twin of align/extend.py _solve_one
// (same collapsed prefix-max row math, same pointer bits, same tie-breaks,
// all-integer arithmetic => bit-identical results; tests assert it).
// modes[i]: 0 = global, 1 = extension (best-cell stop, optional end bonus).
// Ops are written concatenated as (op 0=M/1=I/2=D, dq, dt) runs.
// Returns total ops written, or -needed when ops_cap is too small.
// One affine-gap DP problem -> merged (op, dq, dt) runs appended to
// mop/mdq/mdt (cleared first). Extracted from solve_dp_batch_c so the
// fused per-read aligner (align_read_c) can solve gap fills inline;
// byte-for-byte the same math and tie-breaks.
static void solve_one_dp(
    const uint8_t* q, int64_t nq, const uint8_t* t, int64_t nt,
    bool global, int32_t match, int32_t mismatch, int32_t go_, int32_t ge_,
    int32_t end_bonus, int32_t zdrop, int64_t* out_qlen, int64_t* out_tlen,
    std::vector<int8_t>& mop, std::vector<int32_t>& mdq,
    std::vector<int32_t>& mdt) {
    const int64_t NEG = -1000000000LL;
    mop.clear(); mdq.clear(); mdt.clear();
    *out_qlen = 0; *out_tlen = 0;
    // fast/edge paths mirror _solve_one exactly
    if (!global && nq > 0 && nq <= nt && !memcmp(q, t, nq)) {
        mop.push_back(0); mdq.push_back((int32_t)nq);
        mdt.push_back((int32_t)nq);
        *out_qlen = nq; *out_tlen = nq;
        return;
    }
    if (nq == 0 && nt == 0) return;
    if (nq == 0) {
        if (global) { mop.push_back(2); mdq.push_back(0);
                      mdt.push_back((int32_t)nt); *out_tlen = nt; }
        return;
    }
    if (nt == 0) {
        if (global) { mop.push_back(1); mdq.push_back((int32_t)nq);
                      mdt.push_back(0); *out_qlen = nq; }
        return;
    }
    {
        std::vector<int64_t> h, e;
        std::vector<uint8_t> ptr;
        std::vector<int8_t> rev_ops;
        int64_t width = nt + 1;
        h.assign(width, 0);
        e.assign(width, NEG);
        for (int64_t j = 1; j < width; j++) h[j] = -(go_ + ge_ * j);
        ptr.assign((nq + 1) * width, 0);
        for (int64_t j = 1; j < width; j++) ptr[j] = 2;
        for (int64_t j = 2; j < width; j++) ptr[j] |= 1 << 3;
        int64_t best_val = 0, best_i = 0, best_j = 0;
        int64_t raw_best = 0;  // running best WITHOUT end bonus (zdrop)
        for (int64_t i = 1; i <= nq; i++) {
            uint8_t* prow = ptr.data() + i * width;
            uint8_t qc = q[i - 1];
            // single left-to-right pass: h/e updated in place (h[j-1]
            // read BEFORE overwriting = previous row's value), with the
            // running prefix-max `scan` carrying the collapsed F state
            int64_t scan = NEG;          // max over j' <= j-1 of b + ge*j'
            int64_t h_prev_jm1 = NEG;    // h_prev[j-1] (diag source)
            int64_t b_prev = NEG;        // b[j-1]
            int64_t f_prev = NEG;        // f_row[j-1]
            int64_t row_best = NEG, row_arg = 0;
            for (int64_t j = 0; j < width; j++) {
                int64_t hp = h[j];       // h_prev[j]
                int64_t open_e = hp - go_ - ge_;
                int64_t ext_e = e[j] - ge_;
                int64_t e_val = ext_e > open_e ? ext_e : open_e;
                uint8_t e_ext = ext_e > open_e ? 1 : 0;
                int64_t diag = j == 0 ? NEG
                    : h_prev_jm1 + (t[j - 1] == qc ? match : -mismatch);
                int64_t b = j == 0 ? e_val : (diag > e_val ? diag : e_val);
                int64_t f_val = j == 0 ? NEG : scan - go_ - ge_ * j;
                uint8_t f_ext = 0;
                if (j > 0)
                    f_ext = (f_prev - ge_) > (b_prev - go_ - ge_) ? 1 : 0;
                int64_t h_val;
                uint8_t code;
                if (j == 0) { h_val = e_val; code = 1; }
                else {
                    h_val = diag; code = 0;
                    if (e_val > h_val) { h_val = e_val; code = 1; }
                    if (f_val > h_val) { h_val = f_val; code = 2; }
                }
                prow[j] = code | (e_ext << 2) | (f_ext << 3);
                scan = (b + ge_ * j) > scan ? (b + ge_ * j) : scan;
                h_prev_jm1 = hp;
                b_prev = b;
                f_prev = f_val;
                h[j] = h_val;
                e[j] = e_val;
                if (h_val > row_best) { row_best = h_val; row_arg = j; }
            }
            if (!global) {
                if (zdrop > 0) {
                    // minimap2 -z analogue: the triggering row is not
                    // considered (matches _solve_one's break placement)
                    if (row_best < raw_best - zdrop) break;
                    if (row_best > raw_best) raw_best = row_best;
                }
                int64_t eff = row_best
                    + ((end_bonus != 0 && i == nq) ? end_bonus : 0);
                if (eff > best_val) {
                    best_val = eff; best_i = i; best_j = row_arg;
                }
            }
        }
        int64_t qi, tj;
        if (global) { qi = nq; tj = nt; }
        else if (best_val <= 0) return;
        else { qi = best_i; tj = best_j; }

        // traceback (same state machine as _traceback_bits), then merge
        rev_ops.clear();
        int64_t i = qi, j = tj;
        int state = 0;  // 0 H, 1 E, 2 F
        while (i > 0 || j > 0) {
            uint8_t p = ptr[i * width + j];
            if (state == 0) {
                uint8_t code = p & 3;
                if (code == 0 && i > 0 && j > 0) {
                    rev_ops.push_back(0); i--; j--;
                } else if (code == 1) state = 1;
                else state = 2;
            } else if (state == 1) {
                rev_ops.push_back(1);
                state = ((p >> 2) & 1) ? 1 : 0;
                i--;
            } else {
                rev_ops.push_back(2);
                state = ((p >> 3) & 1) ? 2 : 0;
                j--;
            }
        }
        for (int64_t k = (int64_t)rev_ops.size() - 1; k >= 0; k--) {
            int8_t op = rev_ops[k];
            int32_t dq = op == 2 ? 0 : 1, dt = op == 1 ? 0 : 1;
            if (!mop.empty() && mop.back() == op) {
                mdq.back() += dq; mdt.back() += dt;
            } else { mop.push_back(op); mdq.push_back(dq); mdt.push_back(dt); }
        }
        *out_qlen = qi;
        *out_tlen = tj;
    }
}

int64_t solve_dp_batch_c(
    const uint8_t* q_all, const int64_t* q_off,
    const uint8_t* t_all, const int64_t* t_off,
    const uint8_t* modes, int64_t n_problems,
    int32_t match, int32_t mismatch, int32_t go_, int32_t ge_,
    int32_t end_bonus, int32_t zdrop,
    int32_t* out_qlen, int32_t* out_tlen, int64_t* out_nops,
    int8_t* ops_op, int32_t* ops_dq, int32_t* ops_dt, int64_t ops_cap) {
    int64_t total_ops = 0;
    std::vector<int8_t> mop;
    std::vector<int32_t> mdq, mdt;
    for (int64_t pi = 0; pi < n_problems; pi++) {
        int64_t qlen, tlen;
        solve_one_dp(q_all + q_off[pi], q_off[pi + 1] - q_off[pi],
                     t_all + t_off[pi], t_off[pi + 1] - t_off[pi],
                     modes[pi] == 0, match, mismatch, go_, ge_, end_bonus,
                     zdrop, &qlen, &tlen, mop, mdq, mdt);
        out_qlen[pi] = (int32_t)qlen;
        out_tlen[pi] = (int32_t)tlen;
        out_nops[pi] = (int64_t)mop.size();
        for (size_t k = 0; k < mop.size(); k++) {
            if (total_ops < ops_cap) {
                ops_op[total_ops] = mop[k];
                ops_dq[total_ops] = mdq[k];
                ops_dt[total_ops] = mdt[k];
            }
            total_ops++;
        }
    }
    return total_ops <= ops_cap ? total_ops : -total_ops;
}

int64_t seed_chain2_c(
    const uint8_t* codes, int64_t n, int32_t k, int32_t w,
    int64_t max_occ, int32_t merge_gap,
    const uint64_t* sorted_hashes, const int64_t* bucket_lo,
    int32_t bucket_bits,
    const void* sorted_positions, int32_t pos_is_u32,
    const int64_t* chrom_offsets, int64_t n_chroms,
    int64_t min_intron, int64_t max_intron, int32_t match,
    float intron_penalty, float indel_open, float indel_scale,
    int64_t max_segments,
    int64_t* cq0, int64_t* cqe, int64_t* ct0, int64_t* cte,
    float* out_score, int32_t* out_chrom, int32_t* out_strand);

// Fully-fused per-read alignment: seed+chain both orientations, gap fill
// (splice-point search, affine-gap DP fills, end extensions), run
// assembly, and extended-PSL emission in ONE call — the C++ twin of
// aligner.map_batch's per-read path (_chain_both -> _fill -> dp ->
// _build_runs -> emit), bit-identical to it (tests assert equality).
// Returns the block count (0 = unaligned), or -needed if cs_cap is too
// small. out_strand: 0 '+', 1 '-', -1 none.
struct Run { int8_t op; int64_t q0, t0, len; };

// A deferred DP gap fill (device-path staging): the problem geometry the
// Python layer needs to pack the device DP batch. mode: 0 global,
// 1 extend_right, 2 extend_left (reversed arrays, aligner._fill's
// convention: q covers [q0-nq, q0) reversed, t covers [t0-nt, t0)
// reversed).
struct DpDesc { uint8_t mode; int64_t q0, t0, nq, nt; };

// Append one resolved DP fill's merged (op, dq, dt) runs at (q0, t0) —
// the shared expansion used by the inline solver (align_read_c) and the
// device-result resolver (stage_emit_batch_c); twin of
// aligner._build_runs' DP branch.
static void expand_ops_into_runs(
    int mode, int64_t q0, int64_t t0, int64_t qlen, int64_t tlen,
    const std::vector<int8_t>& mop, const std::vector<int32_t>& mdq,
    const std::vector<int32_t>& mdt, std::vector<Run>& runs) {
    auto push = [&](int8_t op, int64_t q, int64_t t, int64_t ln) {
        if (ln > 0) runs.push_back({op, q, t, ln});
    };
    if (mop.empty()) return;
    if (mode == 2) {  // extend_left: reversed arrays, reversed ops
        int64_t qq = q0 - qlen, tt = t0 - tlen;
        for (int64_t i = (int64_t)mop.size() - 1; i >= 0; i--) {
            int8_t op = mop[i];
            push(op, qq, tt, op != 2 ? mdq[i] : mdt[i]);
            qq += mdq[i];
            tt += mdt[i];
        }
    } else {
        int64_t qq = q0, tt = t0;
        for (size_t i = 0; i < mop.size(); i++) {
            int8_t op = mop[i];
            push(op, qq, tt, op != 2 ? mdq[i] : mdt[i]);
            qq += mdq[i];
            tt += mdt[i];
        }
    }
}

// Gap fill for one picked chain: splice slack + splice-point search +
// structural runs + DP gap fills — the body of align_read_c between
// chaining and emission, factored so the device-path staging can COLLECT
// the DP problems (collect != nullptr: each DP site becomes a
// placeholder run {op=4, q0, t0, len=desc index} plus a DpDesc) instead
// of solving them inline. Identical control flow either way; the chain
// arrays are modified in place (slack pass). Runs are appended UNSORTED
// (align_read_c's final stable sort happens after resolution).
static void fill_runs(
    const uint8_t* q, int64_t n, const uint8_t* g,
    int64_t chrom_off, int64_t chrom_end, int32_t strand,
    int64_t* cq0, int64_t* cqe, int64_t* ct0, int64_t* cte, int64_t nseg,
    int64_t min_intron,
    int32_t dp_match, int32_t dp_mismatch, int32_t go_, int32_t ge_,
    int32_t end_bonus, int32_t zdrop, int32_t band_width,
    int64_t max_end_extend, int32_t splice_slack,
    int32_t noncanonical_penalty,
    std::vector<Run>& runs, std::vector<DpDesc>* collect) {
    auto push = [&](int8_t op, int64_t q0, int64_t t0, int64_t ln) {
        if (ln > 0) runs.push_back({op, q0, t0, ln});
    };
    std::vector<int8_t> mop;
    std::vector<int32_t> mdq, mdt;
    std::vector<uint8_t> ra, rb;
    // resolve one DP fill: solve inline (host path) or defer (device)
    auto add_dp = [&](int64_t q0, int64_t t0, const uint8_t* qs,
                      int64_t nq, const uint8_t* ts, int64_t nt,
                      int mode /*0 global 1 ext 2 ext_left*/) {
        if (collect) {
            runs.push_back({4, q0, t0, (int64_t)collect->size()});
            collect->push_back({(uint8_t)mode, q0, t0, nq, nt});
            return;
        }
        int64_t qlen, tlen;
        solve_one_dp(qs, nq, ts, nt, mode == 0, dp_match, dp_mismatch,
                     go_, ge_, end_bonus, zdrop, &qlen, &tlen, mop, mdq,
                     mdt);
        expand_ops_into_runs(mode, q0, t0, qlen, tlen, mop, mdq, mdt,
                             runs);
    };

    // left end extension (reversed problem); never cross the chrom start
    int64_t lq = cq0[0] < max_end_extend ? cq0[0] : max_end_extend;
    if (lq > 0) {
        int64_t lt = ct0[0] - chrom_off;
        if (lt > lq + band_width) lt = lq + band_width;
        if (collect) {
            add_dp(cq0[0], ct0[0], nullptr, lq, nullptr, lt, 2);
        } else {
            ra.assign(lq, 0);
            rb.assign(lt, 0);
            for (int64_t i = 0; i < lq; i++) ra[i] = q[cq0[0] - 1 - i];
            for (int64_t i = 0; i < lt; i++) rb[i] = g[ct0[0] - 1 - i];
            add_dp(cq0[0], ct0[0], ra.data(), lq, rb.data(), lt, 2);
        }
    }

    // splice slack: pull intron-gap flanks back so the splice-point
    // search can slide the junction onto the motif (_fill's slack pass)
    for (int64_t i = 0; i + 1 < nseg; i++) {
        int64_t dq = cq0[i + 1] - cqe[i];
        int64_t dt = ct0[i + 1] - cte[i];
        if (dt - dq >= min_intron && dq >= 0) {
            int64_t len_a = cqe[i] - cq0[i];
            int64_t len_b = cqe[i + 1] - cq0[i + 1];
            int64_t s_back = (len_a - 1) / 2;
            if (s_back > splice_slack) s_back = splice_slack;
            int64_t s_fwd = (len_b - 1) / 2;
            if (s_fwd > splice_slack) s_fwd = splice_slack;
            cqe[i] -= s_back;
            cte[i] -= s_back;
            cq0[i + 1] += s_fwd;
            ct0[i + 1] += s_fwd;
        }
    }

    for (int64_t i = 0; i < nseg; i++) {
        if (i > 0) {
            int64_t pqe = cqe[i - 1], pte = cte[i - 1];
            int64_t dq = cq0[i] - pqe;
            int64_t dt = ct0[i] - pte;
            if (dt - dq >= min_intron && dq >= 0) {
                // splice-point search: choose split s in [0, dq] maximizing
                // left+right matches + canonical-motif bonus (first max —
                // numpy argmax tie-break)
                int64_t n_intron = dt - dq;
                uint8_t wd0, wd1, wa0, wa1;
                if (strand == 0) { wd0 = 2; wd1 = 3; wa0 = 0; wa1 = 2; }
                else { wd0 = 1; wd1 = 3; wa0 = 0; wa1 = 1; }
                std::vector<int32_t> sum_r(dq + 1, 0);
                for (int64_t s = dq - 1; s >= 0; s--)
                    sum_r[s] = sum_r[s + 1]
                        + (q[pqe + s] == g[ct0[i] - dq + s] ? 1 : 0);
                int64_t best_s = 0;
                int32_t best_score = INT32_MIN;
                int32_t cum_l = 0;
                for (int64_t s = 0; s <= dq; s++) {
                    int64_t d = pte + s;
                    int64_t a = ct0[i] - (dq - s);
                    bool canon = g[d] == wd0 && g[d + 1] == wd1
                        && g[a - 2] == wa0 && g[a - 1] == wa1;
                    int32_t sc = cum_l + sum_r[s]
                        + (canon ? noncanonical_penalty : 0);
                    if (sc > best_score) { best_score = sc; best_s = s; }
                    if (s < dq)
                        cum_l += q[pqe + s] == g[pte + s] ? 1 : 0;
                }
                if (best_s > 0) push(0, pqe, pte, best_s);
                push(3, pqe + best_s, pte + best_s, n_intron);
                if (dq - best_s > 0)
                    push(0, pqe + best_s, ct0[i] - (dq - best_s),
                         dq - best_s);
            } else if (dq == dt) {
                if (dq > 0) push(0, pqe, pte, dq);
            } else if (dq == 0) {
                push(2, pqe, pte, dt);
            } else if (dt == 0) {
                push(1, pqe, pte, dq);
            } else if (dq * dt <= 4000000) {
                add_dp(pqe, pte, q + pqe, dq, g + pte, dt, 0);
            } else {  // degenerate huge gap: crude I+D fill
                push(1, pqe, pte, dq);
                push(2, cq0[i], pte, dt);
            }
        }
        push(0, cq0[i], ct0[i], cqe[i] - cq0[i]);
    }

    // right end extension
    int64_t rq = n - cqe[nseg - 1];
    if (rq > max_end_extend) rq = max_end_extend;
    if (rq > 0) {
        int64_t rt = chrom_end - cte[nseg - 1];
        if (rt > rq + band_width) rt = rq + band_width;
        add_dp(cqe[nseg - 1], cte[nseg - 1], q + cqe[nseg - 1], rq,
               g + cte[nseg - 1], rt, 1);
    }
}

int64_t align_read_c(
    const uint8_t* codes, int64_t n,
    int32_t k, int32_t w, int64_t max_occ, int32_t merge_gap,
    const uint64_t* sorted_hashes, const int64_t* bucket_lo,
    int32_t bucket_bits,
    const void* sorted_positions, int32_t pos_is_u32,
    const int64_t* chrom_offsets, const int64_t* chrom_sizes,
    int64_t n_chroms, const uint8_t* genome,
    int64_t min_intron, int64_t max_intron, int32_t chain_match,
    float intron_penalty, float indel_open, float indel_scale,
    int64_t max_segments, float min_chain_score,
    int32_t dp_match, int32_t dp_mismatch, int32_t go_, int32_t ge_,
    int32_t end_bonus, int32_t zdrop, int32_t band_width,
    int64_t max_end_extend,
    int32_t splice_slack, int32_t noncanonical_penalty,
    int32_t* out_strand, int32_t* out_chrom,
    int64_t* stats, int64_t* blk_sizes, int64_t* blk_q, int64_t* blk_t,
    char* cs, int64_t cs_cap,
    int32_t runs_mode, int8_t* runs_op, int64_t* runs_q0,
    int64_t* runs_t0, int64_t* runs_len, int64_t runs_cap) {
    std::vector<int64_t> cq0(max_segments), cqe(max_segments),
        ct0(max_segments), cte(max_segments);
    float score;
    int32_t chrom, strand;
    int64_t nseg = seed_chain2_c(
        codes, n, k, w, max_occ, merge_gap, sorted_hashes, bucket_lo,
        bucket_bits, sorted_positions, pos_is_u32, chrom_offsets,
        n_chroms, min_intron,
        max_intron, chain_match, intron_penalty, indel_open, indel_scale,
        max_segments, cq0.data(), cqe.data(), ct0.data(), cte.data(),
        &score, &chrom, &strand);
    *out_strand = -1;
    *out_chrom = -1;
    if (nseg == 0 || strand < 0) return 0;
    int64_t total_len = 0;
    for (int64_t i = 0; i < nseg; i++) total_len += cqe[i] - cq0[i];
    if ((float)total_len < min_chain_score) return 0;

    // oriented query (map_batch aligns the reverse complement for '-')
    static const uint8_t COMP[5] = {3, 2, 1, 0, 4};
    std::vector<uint8_t> qbuf;
    const uint8_t* q = codes;
    if (strand == 1) {
        qbuf.resize(n);
        for (int64_t i = 0; i < n; i++) qbuf[i] = COMP[codes[n - 1 - i]];
        q = qbuf.data();
    }
    const uint8_t* g = genome;
    int64_t chrom_off = chrom_offsets[chrom];
    int64_t chrom_end = chrom_off + chrom_sizes[chrom];

    std::vector<Run> runs;
    fill_runs(q, n, g, chrom_off, chrom_end, strand,
              cq0.data(), cqe.data(), ct0.data(), cte.data(), nseg,
              min_intron, dp_match, dp_mismatch, go_, ge_, end_bonus,
              zdrop, band_width, max_end_extend, splice_slack,
              noncanonical_penalty, runs, nullptr);

    std::stable_sort(runs.begin(), runs.end(),
                     [](const Run& a, const Run& b) {
                         if (a.q0 != b.q0) return a.q0 < b.q0;
                         return a.t0 < b.t0;
                     });
    if (runs.empty()) return 0;
    if (runs_mode) {  // raw (op, q0, t0, len) runs for the star engine
        *out_strand = strand;
        *out_chrom = chrom;
        int64_t count = (int64_t)runs.size();
        if (count > runs_cap) return -count;
        for (int64_t i = 0; i < count; i++) {
            runs_op[i] = runs[i].op;
            runs_q0[i] = runs[i].q0;
            runs_t0[i] = runs[i].t0;
            runs_len[i] = runs[i].len;
        }
        return count;
    }
    std::vector<int8_t> r_op(runs.size());
    std::vector<int64_t> r_q(runs.size()), r_t(runs.size()),
        r_l(runs.size());
    for (size_t i = 0; i < runs.size(); i++) {
        r_op[i] = runs[i].op;
        r_q[i] = runs[i].q0;
        r_t[i] = runs[i].t0;
        r_l[i] = runs[i].len;
    }
    int64_t cl = emit_psl_c(q, g, r_op.data(), r_q.data(), r_t.data(),
                            r_l.data(), (int64_t)runs.size(), stats,
                            blk_sizes, blk_q, blk_t, cs, cs_cap);
    *out_strand = strand;
    *out_chrom = chrom;
    // >= 0: cs byte length (block count is in stats[7]);
    // < 0: cs buffer too small, caller retries with -return bytes
    return cl;
}

// Long-form cs-string tokenizer: C++ twin of core/csparse.py
// build_cs_index's record model ('='/'+'/'-' one record per base,
// '*' one per token, '~' one with the intron length as the genome step).
// gp[i] = genome_start + cumulative steps; advances[i] = step > 0.
// Intron motifs (body[:2] + body[-2:]) are written 4 chars per intron.
// Returns the record count, or -1 on malformed '~' (caller falls back).
int64_t parse_cs_c(const char* cs, int64_t len, int64_t genome_start,
                   int8_t* status, int64_t* gp, uint8_t* advances,
                   int64_t* intron_idx, char* intron_motifs,
                   int64_t* n_introns) {
    int64_t n = 0, ni = 0;
    int64_t pos = genome_start;
    int64_t i = 0;
    while (i < len) {
        char op = cs[i++];
        int64_t body = i;
        while (i < len && cs[i] != '=' && cs[i] != '+' && cs[i] != '-'
               && cs[i] != '*' && cs[i] != '~')
            i++;
        int64_t blen = i - body;
        if (blen == 0) continue;  // regex requires a non-empty body
        switch (op) {
        case '=':
            for (int64_t j = 0; j < blen; j++) {
                status[n] = 0; pos += 1; gp[n] = pos; advances[n] = 1; n++;
            }
            break;
        case '+':
            for (int64_t j = 0; j < blen; j++) {
                status[n] = 1; gp[n] = pos; advances[n] = 0; n++;
            }
            break;
        case '-':
            for (int64_t j = 0; j < blen; j++) {
                status[n] = 2; pos += 1; gp[n] = pos; advances[n] = 1; n++;
            }
            break;
        case '*':
            status[n] = 3; pos += 1; gp[n] = pos; advances[n] = 1; n++;
            break;
        case '~': {
            if (blen < 5) return -1;
            int64_t v = 0;
            for (int64_t j = body + 2; j < body + blen - 2; j++) {
                if (cs[j] < '0' || cs[j] > '9') return -1;
                v = v * 10 + (cs[j] - '0');
            }
            intron_idx[ni] = n;
            intron_motifs[ni * 4 + 0] = cs[body];
            intron_motifs[ni * 4 + 1] = cs[body + 1];
            intron_motifs[ni * 4 + 2] = cs[body + blen - 2];
            intron_motifs[ni * 4 + 3] = cs[body + blen - 1];
            ni++;
            status[n] = 4; pos += v; gp[n] = pos;
            advances[n] = v > 0 ? 1 : 0; n++;
            break;
        }
        default:
            break;  // leading garbage before the first op: regex skips it
        }
    }
    *n_introns = ni;
    return n;
}

// Both-orientation seed + chain: runs seed_chain_c for the read and its
// reverse complement (computed here) and applies map_batch's tie-break
// (forward wins ties, aligner.py map_batch). Returns the winning chain
// length; *out_strand is 0 (forward), 1 (reverse), or -1 (no chain).
int64_t seed_chain2_c(
    const uint8_t* codes, int64_t n, int32_t k, int32_t w,
    int64_t max_occ, int32_t merge_gap,
    const uint64_t* sorted_hashes, const int64_t* bucket_lo,
    int32_t bucket_bits,
    const void* sorted_positions, int32_t pos_is_u32,
    const int64_t* chrom_offsets, int64_t n_chroms,
    int64_t min_intron, int64_t max_intron, int32_t match,
    float intron_penalty, float indel_open, float indel_scale,
    int64_t max_segments,
    int64_t* cq0, int64_t* cqe, int64_t* ct0, int64_t* cte,
    float* out_score, int32_t* out_chrom, int32_t* out_strand) {
    static const uint8_t COMP[5] = {3, 2, 1, 0, 4};
    int64_t nf = seed_chain_c(
        codes, n, k, w, max_occ, merge_gap, sorted_hashes, bucket_lo,
        bucket_bits, sorted_positions, pos_is_u32, chrom_offsets,
        n_chroms, min_intron,
        max_intron, match, intron_penalty, indel_open, indel_scale,
        max_segments, cq0, cqe, ct0, cte, out_score, out_chrom);
    float sf = nf > 0 ? *out_score : 0.0f;
    std::vector<uint8_t> rc(n);
    for (int64_t i = 0; i < n; i++) rc[i] = COMP[codes[n - 1 - i]];
    std::vector<int64_t> rq0(max_segments), rqe(max_segments),
        rt0(max_segments), rte(max_segments);
    float sr_raw;
    int32_t cr;
    int64_t nr = seed_chain_c(
        rc.data(), n, k, w, max_occ, merge_gap, sorted_hashes, bucket_lo,
        bucket_bits, sorted_positions, pos_is_u32, chrom_offsets,
        n_chroms, min_intron,
        max_intron, match, intron_penalty, indel_open, indel_scale,
        max_segments, rq0.data(), rqe.data(), rt0.data(), rte.data(),
        &sr_raw, &cr);
    float sr = nr > 0 ? sr_raw : 0.0f;
    if (nf == 0 && nr == 0) { *out_strand = -1; *out_score = 0.0f; return 0; }
    if (sf >= sr) {  // forward wins ties, matching map_batch
        *out_strand = 0;
        *out_score = sf;
        return nf;
    }
    *out_strand = 1;
    *out_score = sr;
    *out_chrom = cr;
    for (int64_t i = 0; i < nr; i++) {
        cq0[i] = rq0[i]; cqe[i] = rqe[i]; ct0[i] = rt0[i]; cte[i] = rte[i];
    }
    return nr;
}

// ---------------------------------------------------------------------
// Parallel genome-index build: C++ twin of align/index.py build_index's
// minimizer sweep + stable hash sort, bit-identical output (the per-chunk
// minimizer semantics — context window lo/hi, keep filter — are replicated
// exactly, and the final order is (hash, position) ascending, which equals
// numpy's stable argsort because positions are appended ascending).
//
// Two-call protocol (the caller cannot size the outputs up front):
//   h = index_build_start(...)  -> opaque handle, *out_total minimizers
//   index_build_finish(h, ...)  -> scatter + per-bucket sort, frees h
// index_build_abort(h) frees the handle without producing output.

struct IndexChunkTask {
    const uint8_t* codes;  // chromosome base pointer
    int64_t clen;          // chromosome length
    int64_t start, stop;   // body range within the chromosome
    int64_t goffset;       // global offset of the chromosome
};

struct IndexBuildState {
    int32_t k, w;
    int32_t bucket_bits;
    std::vector<IndexChunkTask> tasks;
    // retained per-task minimizer buffers (memory-rich host: one sweep)
    std::vector<std::vector<uint64_t>> hashes;
    std::vector<std::vector<int64_t>> positions;
    int64_t total = 0;
    std::vector<int64_t> bucket_counts;
};

static void index_sweep_one(IndexBuildState* st, size_t ti,
                            int64_t* pos_scratch, uint64_t* hsh_scratch) {
    int32_t k = st->k, w = st->w;
    const IndexChunkTask& t = st->tasks[ti];
    int64_t lo = t.start - (w - 1);
    if (lo < 0) lo = 0;
    int64_t hi = t.stop + k + w - 2;
    if (hi > t.clen) hi = t.clen;
    int64_t span = hi - lo;
    if (span < k) return;
    int64_t n = minimizers_c(t.codes + lo, span, k, w,
                             pos_scratch, hsh_scratch);
    auto& hout = st->hashes[ti];
    auto& pout = st->positions[ti];
    hout.reserve(n);
    pout.reserve(n);
    for (int64_t i = 0; i < n; i++) {
        int64_t p = pos_scratch[i] + lo;
        if (p < t.start || p >= t.stop) continue;
        hout.push_back(hsh_scratch[i]);
        pout.push_back(p + t.goffset);
    }
}

void* index_build_start(
    const uint8_t* codes, const int64_t* chrom_starts,
    const int64_t* chrom_sizes, const int64_t* chrom_goffsets,
    int64_t n_chroms, int32_t k, int32_t w, int64_t chunk,
    int32_t bucket_bits, int32_t n_threads, int64_t* out_total) {
    IndexBuildState* st = new IndexBuildState();
    st->k = k;
    st->w = w;
    st->bucket_bits = bucket_bits;
    for (int64_t c = 0; c < n_chroms; c++) {
        const uint8_t* base = codes + chrom_starts[c];
        int64_t clen = chrom_sizes[c];
        for (int64_t start = 0; start < clen; start += chunk) {
            int64_t stop = start + chunk < clen ? start + chunk : clen;
            st->tasks.push_back({base, clen, start, stop,
                                 chrom_goffsets[c]});
        }
    }
    size_t nt = st->tasks.size();
    st->hashes.resize(nt);
    st->positions.resize(nt);
    int nthr = n_threads > 1 ? n_threads : 1;
    if ((size_t)nthr > nt) nthr = (int)(nt > 0 ? nt : 1);
    st->bucket_counts.assign((int64_t)1 << bucket_bits, 0);
    const int32_t bucket_shift = 64 - bucket_bits;
    int64_t* counts = st->bucket_counts.data();
    int64_t scratch_cap = chunk + k + 2 * w;
    std::atomic<size_t> next(0);
    auto worker = [&]() {
        // per-thread scratch reused across tasks (vectors would zero-init
        // 256 MB per chunk); bucket counts fold into the sweep with
        // relaxed atomics (collisions are rare at ~8 entries/bucket)
        std::unique_ptr<int64_t[]> pos(new int64_t[scratch_cap]);
        std::unique_ptr<uint64_t[]> hsh(new uint64_t[scratch_cap]);
        for (;;) {
            size_t ti = next.fetch_add(1);
            if (ti >= nt) break;
            index_sweep_one(st, ti, pos.get(), hsh.get());
            for (uint64_t h : st->hashes[ti])
                __atomic_fetch_add(&counts[(uint32_t)(h >> bucket_shift)],
                                   1, __ATOMIC_RELAXED);
        }
    };
    std::vector<std::thread> pool;
    for (int i = 1; i < nthr; i++) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    for (size_t ti = 0; ti < nt; ti++)
        st->total += (int64_t)st->hashes[ti].size();
    *out_total = st->total;
    return st;
}

void index_build_finish(
    void* handle, uint64_t* out_hashes, void* out_pos, int32_t pos_is_u32,
    int64_t* bucket_lo /* 2^bits + 1 */, int32_t n_threads) {
    IndexBuildState* st = (IndexBuildState*)handle;
    const int64_t NB = (int64_t)1 << st->bucket_bits;
    const int32_t bucket_shift = 64 - st->bucket_bits;
    bucket_lo[0] = 0;
    for (int64_t b = 0; b < NB; b++)
        bucket_lo[b + 1] = bucket_lo[b] + st->bucket_counts[b];
    // scatter via atomic per-bucket cursors (per-bucket order fixed by
    // the sort below, so scatter order is irrelevant)
    std::vector<std::atomic<int64_t>> cursor(NB);
    for (int64_t b = 0; b < NB; b++)
        cursor[b].store(bucket_lo[b], std::memory_order_relaxed);
    uint32_t* pos32 = (uint32_t*)out_pos;
    int64_t* pos64 = (int64_t*)out_pos;
    size_t nt = st->tasks.size();
    std::atomic<size_t> next(0);
    auto scatter = [&]() {
        for (;;) {
            size_t ti = next.fetch_add(1);
            if (ti >= nt) break;
            const auto& hs = st->hashes[ti];
            const auto& ps = st->positions[ti];
            for (size_t i = 0; i < hs.size(); i++) {
                uint32_t b = (uint32_t)(hs[i] >> bucket_shift);
                int64_t at = cursor[b].fetch_add(1,
                                                 std::memory_order_relaxed);
                out_hashes[at] = hs[i];
                if (pos_is_u32) pos32[at] = (uint32_t)ps[i];
                else pos64[at] = ps[i];
            }
        }
    };
    int nthr = n_threads > 1 ? n_threads : 1;
    std::vector<std::thread> pool;
    for (int i = 1; i < nthr; i++) pool.emplace_back(scatter);
    scatter();
    for (auto& th : pool) th.join();
    // per-bucket sort by (hash, pos): equals numpy stable argsort by hash.
    // Buckets hold ~8 entries; in-place insertion sort on the parallel
    // arrays skips the pair-buffer round trip of the general path.
    std::atomic<int64_t> nextb(0);
    auto sorter = [&]() {
        std::vector<std::pair<uint64_t, uint64_t>> buf;
        auto pos_at = [&](int64_t i) -> uint64_t {
            return pos_is_u32 ? (uint64_t)pos32[i] : (uint64_t)pos64[i];
        };
        auto pos_set = [&](int64_t i, uint64_t v) {
            if (pos_is_u32) pos32[i] = (uint32_t)v;
            else pos64[i] = (int64_t)v;
        };
        for (;;) {
            int64_t b = nextb.fetch_add(1);
            if (b >= NB) break;
            int64_t lo = bucket_lo[b], hi = bucket_lo[b + 1];
            int64_t n = hi - lo;
            if (n <= 1) continue;
            if (n <= 16) {  // insertion sort, no copies
                for (int64_t i = lo + 1; i < hi; i++) {
                    uint64_t hk = out_hashes[i], pk = pos_at(i);
                    int64_t j = i - 1;
                    while (j >= lo && (out_hashes[j] > hk
                                       || (out_hashes[j] == hk
                                           && pos_at(j) > pk))) {
                        out_hashes[j + 1] = out_hashes[j];
                        pos_set(j + 1, pos_at(j));
                        j--;
                    }
                    out_hashes[j + 1] = hk;
                    pos_set(j + 1, pk);
                }
                continue;
            }
            buf.resize(n);
            for (int64_t i = lo; i < hi; i++)
                buf[i - lo] = {out_hashes[i], pos_at(i)};
            std::sort(buf.begin(), buf.end());
            for (int64_t i = lo; i < hi; i++) {
                out_hashes[i] = buf[i - lo].first;
                pos_set(i, buf[i - lo].second);
            }
        }
    };
    pool.clear();
    for (int i = 1; i < nthr; i++) pool.emplace_back(sorter);
    sorter();
    for (auto& th : pool) th.join();
    delete st;
}

void index_build_abort(void* handle) {
    delete (IndexBuildState*)handle;
}

// Bucketed binary search: for each query hash, find [lo, hi) in the sorted
// hash array, restricted to its top-`bucket_bits`-bit bucket (bucket_lo has
// 2^bucket_bits + 1 entries; bits adapt to genome size, 16..28). Cuts probe
// count and cache misses vs full-range binary search.
void lookup_ranges_c(const uint64_t* sorted_hashes, const int64_t* bucket_lo,
                     int32_t bucket_bits,
                     const uint64_t* queries, int64_t n_queries,
                     int64_t* out_lo, int64_t* out_hi) {
    const int32_t bucket_shift = 64 - bucket_bits;
    for (int64_t qi = 0; qi < n_queries; qi++) {
        uint64_t q = queries[qi];
        uint32_t b = (uint32_t)(q >> bucket_shift);
        int64_t lo = bucket_lo[b], hi = bucket_lo[b + 1];
        int64_t first, l;
        if (hi - lo <= 32) {  // small bucket: sequential scan beats probes
            while (lo < hi && sorted_hashes[lo] < q) lo++;
            first = lo;
            l = lo;
            while (l < hi && sorted_hashes[l] == q) l++;
        } else {
            l = lo;
            int64_t r = hi;
            while (l < r) {
                int64_t m = (l + r) >> 1;
                if (sorted_hashes[m] < q) l = m + 1; else r = m;
            }
            first = l;
            r = hi;
            while (l < r) {
                int64_t m = (l + r) >> 1;
                if (sorted_hashes[m] <= q) l = m + 1; else r = m;
            }
        }
        out_lo[qi] = first;
        out_hi[qi] = l;
    }
}

// ---------------------------------------------------------------------
// Device-path batch staging (VERDICT r4 #1): the three host phases of the
// chain=device + dp=pallas module-A path — candidate seeding, chain
// pick + gap fill, and DP-result emission — as single batched C calls, so
// the device path shares the native staging the fused host path
// (align_read_c) already has. Each call is bit-identical to the Python
// staging it replaces (aligner._chain_batch_device / _fill / _build_runs
// + emit; tests/test_stage_native.py asserts end-to-end byte equality).
// Replaces minimap2's role at Mando.py:316-319 on the device route.

// The chain kernel's candidate rows: per candidate its read, strand,
// chromosome, target base and segment count, and (cap, max_segments)
// int32 planes of prepared segments. The caller zeroes the planes
// (padding rows must stay zero).
struct CandidateRows {
    int64_t max_segments, cap;
    int32_t* read; int8_t* strand; int32_t* chrom; int64_t* tbase;
    int32_t* nseg;
    int32_t *qs, *qe, *ts, *te, *cov;
};

// Candidate row `at` from its prepared segments g[0, n): t normalized to
// their min t_start.
static void write_candidate(CandidateRows& o, int64_t at, int64_t read,
                            int32_t strand, int32_t chrom, const Seg* g,
                            size_t n) {
    int64_t tbase = g[0].ts;
    for (size_t i = 0; i < n; i++)
        tbase = g[i].ts < tbase ? g[i].ts : tbase;
    o.read[at] = (int32_t)read;
    o.strand[at] = (int8_t)strand;
    o.chrom[at] = chrom;
    o.tbase[at] = tbase;
    o.nseg[at] = (int32_t)n;
    int64_t row = at * o.max_segments;
    for (size_t i = 0; i < n; i++) {
        const Seg& s = g[i];
        o.qs[row + i] = (int32_t)s.qs;
        o.qe[row + i] = (int32_t)s.qe;
        o.ts[row + i] = (int32_t)(s.ts - tbase);
        o.te[row + i] = (int32_t)(s.te - tbase);
        // score_len: anchor-covered length, span when unknown
        // (Segment.score_len)
        o.cov[row + i] = (int32_t)(s.cov > 0 ? s.cov : s.qe - s.qs);
    }
}

// One (read, orientation)'s segments (sorted by chromosome, as
// collapse_anchor_runs leaves them) as candidates, one a chromosome in
// ascending order: prepare_segments applied to each chromosome's group,
// which put(chrom, group) then takes.
static void for_each_candidate(
    const std::vector<Seg>& segs, int64_t max_intron, int64_t max_segments,
    std::vector<Seg>& group,
    const std::function<void(int32_t, const std::vector<Seg>&)>& put) {
    size_t at = 0;
    while (at < segs.size()) {
        int32_t c = segs[at].chrom;
        group.clear();
        while (at < segs.size() && segs[at].chrom == c)
            group.push_back(segs[at++]);
        prepare_segs(group, max_intron, max_segments);
        if (group.empty()) continue;  // cannot happen (prepare never
        // empties a non-empty group); defensive only
        put(c, group);
    }
}

// for_each_candidate into the rows: counts every candidate in nc, writes
// those below the cap.
static void pack_candidates(const std::vector<Seg>& segs, int64_t read,
                            int32_t strand, int64_t max_intron,
                            std::vector<Seg>& group, CandidateRows& o,
                            int64_t& nc) {
    for_each_candidate(segs, max_intron, o.max_segments, group,
                       [&](int32_t c, const std::vector<Seg>& g) {
                           if (nc < o.cap)
                               write_candidate(o, nc, read, strand, c,
                                               g.data(), g.size());
                           nc++;
                       });
}

// Runs fn on n threads, the caller's among them, and joins them before it
// returns: no thread outlives the native call (the pipeline forks after
// it).
static void run_on_threads(int32_t n, const std::function<void()>& fn) {
    std::vector<std::thread> pool;
    for (int32_t i = 1; i < n; i++) pool.emplace_back(fn);
    fn();
    for (auto& th : pool) th.join();
}

// stage_seed_batch_c's unit of work on threads: a block of consecutive
// reads, claimed whole by one thread (reads of 0.3-7 kb balance over many
// small blocks).
static const int64_t SEED_BLOCK_READS = 16;

// The candidates of one block of reads, in the rows' order, before they
// are packed: candidate i's read, strand and chromosome, and its prepared
// segments segs[off[i], off[i + 1]).
struct CandidateBlock {
    std::vector<int32_t> read, chrom;
    std::vector<int8_t> strand;
    std::vector<int64_t> off{0};
    std::vector<Seg> segs;
};

// The threads stage_seed_batch_c runs n_reads reads on when given
// n_threads: at most one a block, and 1 (the serial loop) below two
// blocks.
int32_t stage_seed_threads_c(int64_t n_reads, int32_t n_threads) {
    int64_t blocks = (n_reads + SEED_BLOCK_READS - 1) / SEED_BLOCK_READS;
    if (n_threads <= 1 || blocks < 2) return 1;
    return blocks < n_threads ? (int32_t)blocks : n_threads;
}

// Phase A — seed every (read, orientation, chromosome) candidate and pack
// prepared segments straight into the chain kernel's (cap, max_segments)
// int32 input rows (prepare_segments applied, t normalized per candidate
// to its min t_start). Candidate order matches _chain_batch_device: read
// -> '+','-' -> chromosome ascending. Caller provides ZEROED seg arrays
// (padding rows must stay zero for the jit cache). Returns the candidate
// count, or -needed when cap is too small.
//
// On stage_seed_threads_c(n_reads, n_threads) threads, started and joined
// inside the call: each claims blocks of SEED_BLOCK_READS reads and seeds
// them into the block's own buffer; then the blocks are packed in block
// order, each from its first candidate's row on. The rows are the serial
// loop's, byte for byte, for every thread count.
int64_t stage_seed_batch_c(
    const uint8_t* codes_all, const int64_t* read_off, int64_t n_reads,
    int32_t k, int32_t w, int64_t max_occ, int32_t merge_gap,
    const uint64_t* sorted_hashes, const int64_t* bucket_lo,
    int32_t bucket_bits, const void* sorted_positions, int32_t pos_is_u32,
    const int64_t* chrom_offsets, int64_t n_chroms,
    int64_t max_intron, int64_t max_segments, int64_t cap,
    int32_t* cand_read, int8_t* cand_strand, int32_t* cand_chrom,
    int64_t* cand_tbase, int32_t* cand_nseg,
    int32_t* seg_qs, int32_t* seg_qe, int32_t* seg_ts, int32_t* seg_te,
    int32_t* seg_cov, int32_t n_threads) {
    static const uint8_t COMP[5] = {3, 2, 1, 0, 4};
    CandidateRows o{max_segments, cap, cand_read, cand_strand, cand_chrom,
                    cand_tbase, cand_nseg, seg_qs, seg_qe, seg_ts, seg_te,
                    seg_cov};
    // read r's segments in orientation `strand` (1: reverse complement,
    // built in rc)
    auto seed_one = [&](int64_t r, int32_t strand, std::vector<uint8_t>& rc,
                        std::vector<Seg>& segs) {
        const uint8_t* codes = codes_all + read_off[r];
        int64_t n = read_off[r + 1] - read_off[r];
        const uint8_t* qc = codes;
        if (strand == 1) {
            rc.resize(n);
            for (int64_t i = 0; i < n; i++)
                rc[i] = COMP[codes[n - 1 - i]];
            qc = rc.data();
        }
        build_segments(qc, n, k, w, max_occ, merge_gap, sorted_hashes,
                       bucket_lo, bucket_bits, sorted_positions,
                       pos_is_u32, chrom_offsets, n_chroms, segs);
    };
    const int32_t nthr = stage_seed_threads_c(n_reads, n_threads);
    if (nthr == 1) {
        std::vector<uint8_t> rc;
        std::vector<Seg> segs, group;
        int64_t nc = 0;
        for (int64_t r = 0; r < n_reads; r++)
            for (int32_t strand = 0; strand < 2; strand++) {
                seed_one(r, strand, rc, segs);
                pack_candidates(segs, r, strand, max_intron, group, o, nc);
            }
        return nc <= cap ? nc : -nc;
    }

    const int64_t n_blocks =
        (n_reads + SEED_BLOCK_READS - 1) / SEED_BLOCK_READS;
    std::vector<CandidateBlock> blocks(n_blocks);
    std::atomic<int64_t> next(0);
    auto seeder = [&]() {
        std::vector<uint8_t> rc;
        std::vector<Seg> segs, group;
        for (;;) {
            int64_t b = next.fetch_add(1);
            if (b >= n_blocks) break;
            CandidateBlock& blk = blocks[b];
            int64_t r1 = std::min((b + 1) * SEED_BLOCK_READS, n_reads);
            for (int64_t r = b * SEED_BLOCK_READS; r < r1; r++)
                for (int32_t strand = 0; strand < 2; strand++) {
                    seed_one(r, strand, rc, segs);
                    for_each_candidate(
                        segs, max_intron, max_segments, group,
                        [&](int32_t c, const std::vector<Seg>& g) {
                            blk.read.push_back((int32_t)r);
                            blk.strand.push_back((int8_t)strand);
                            blk.chrom.push_back(c);
                            blk.segs.insert(blk.segs.end(), g.begin(),
                                            g.end());
                            blk.off.push_back((int64_t)blk.segs.size());
                        });
                }
        }
    };
    run_on_threads(nthr, seeder);

    // block b's candidates take rows first[b] .. first[b + 1] - 1
    std::vector<int64_t> first(n_blocks + 1, 0);
    for (int64_t b = 0; b < n_blocks; b++)
        first[b + 1] = first[b] + (int64_t)blocks[b].read.size();
    const int64_t nc = first[n_blocks];
    next.store(0);
    auto packer = [&]() {
        for (;;) {
            int64_t b = next.fetch_add(1);
            if (b >= n_blocks) break;
            CandidateBlock& blk = blocks[b];
            for (size_t i = 0; i < blk.read.size(); i++) {
                int64_t at = first[b] + (int64_t)i;
                if (at >= cap) break;
                write_candidate(o, at, blk.read[i], blk.strand[i],
                                blk.chrom[i], blk.segs.data() + blk.off[i],
                                (size_t)(blk.off[i + 1] - blk.off[i]));
            }
            blk = CandidateBlock();
        }
    };
    run_on_threads(nthr, packer);
    return nc <= cap ? nc : -nc;
}

// Phase A from a hash-sharded index: the same candidates as
// stage_seed_batch_c, from each (read, orientation)'s anchors as the
// sharded lookup found them (after the max_occ filter and the per-read
// anchor budget). Orientation 2r + s (s = 0 forward, 1 reverse) holds
// anchors anchor_off[2r+s] .. anchor_off[2r+s+1] - 1: query position q,
// global genome position g, in any order. Returns as stage_seed_batch_c.
int64_t stage_seed_anchors_c(
    const int64_t* anchor_off, const int64_t* anchor_q,
    const int64_t* anchor_g, int64_t n_reads, int32_t k, int32_t merge_gap,
    const int64_t* chrom_offsets, int64_t n_chroms,
    int64_t max_intron, int64_t max_segments, int64_t cap,
    int32_t* cand_read, int8_t* cand_strand, int32_t* cand_chrom,
    int64_t* cand_tbase, int32_t* cand_nseg,
    int32_t* seg_qs, int32_t* seg_qe, int32_t* seg_ts, int32_t* seg_te,
    int32_t* seg_cov) {
    CandidateRows o{max_segments, cap, cand_read, cand_strand, cand_chrom,
                    cand_tbase, cand_nseg, seg_qs, seg_qe, seg_ts, seg_te,
                    seg_cov};
    std::vector<Anchor> anchors;
    std::vector<Seg> segs, group;
    int64_t nc = 0;
    for (int64_t r = 0; r < n_reads; r++) {
        for (int32_t strand = 0; strand < 2; strand++) {
            int64_t a0 = anchor_off[2 * r + strand];
            int64_t a1 = anchor_off[2 * r + strand + 1];
            anchors.clear();
            for (int64_t a = a0; a < a1; a++) {
                int64_t g = anchor_g[a], q = anchor_q[a];
                anchors.push_back({chrom_of(g, chrom_offsets, n_chroms),
                                   g - q, g, q});
            }
            segs.clear();
            collapse_anchor_runs(anchors, k, merge_gap, segs);
            pack_candidates(segs, r, strand, max_intron, group, o, nc);
        }
    }
    return nc <= cap ? nc : -nc;
}

// Phase B — per-candidate chain traceback from the packed device rows
// ((n_cand, max_segments+3) int16: parent table, best index, float32
// score bits), best-candidate pick per read (strict > in candidate
// order, chain_batch_jax + _chain_batch_device semantics), min-chain
// gate, oriented-query materialization, and the gap fill in COLLECT mode
// (structural runs + DP problem descriptors). Returns 0, or -1 when
// runs_cap/prob_cap are too small (needed counts in out_counts).
int64_t stage_fill_batch_c(
    const uint8_t* codes_all, const int64_t* read_off, int64_t n_reads,
    int64_t n_cand, const int32_t* cand_read, const int8_t* cand_strand,
    const int32_t* cand_chrom, const int64_t* cand_tbase,
    const int32_t* cand_nseg,
    const int32_t* seg_qs, const int32_t* seg_qe, const int32_t* seg_ts,
    const int32_t* seg_te, int64_t max_segments,
    const int16_t* chain_rows, int64_t chain_row_w,
    const int64_t* chrom_offsets, const int64_t* chrom_sizes,
    int64_t n_chroms, const uint8_t* genome,
    float min_chain_score, int64_t min_intron,
    int32_t dp_match, int32_t dp_mismatch, int32_t go_, int32_t ge_,
    int32_t end_bonus, int32_t zdrop, int32_t band_width,
    int64_t max_end_extend, int32_t splice_slack,
    int32_t noncanonical_penalty,
    int32_t* out_strand, int32_t* out_chrom, uint8_t* oriented,
    int64_t* run_off, int8_t* runs_op, int64_t* runs_q0, int64_t* runs_t0,
    int64_t* runs_len, int64_t runs_cap,
    int32_t* prob_read, uint8_t* prob_mode, int64_t* prob_q0,
    int64_t* prob_t0, int64_t* prob_nq, int64_t* prob_nt,
    int64_t prob_cap, int64_t* out_counts) {
    static const uint8_t COMP[5] = {3, 2, 1, 0, 4};
    // chain rows may be narrower than the seg arrays' stride: the kernel
    // buckets the segment axis to the batch's max (chain_batch_rows)
    const int64_t row_w = chain_row_w;
    const int64_t msb = chain_row_w - 3;   // parent-table width
    // pick the best candidate per read: strict > over candidates in
    // order, traceback+trim per winner (only the winner's chain is kept)
    std::vector<int64_t> best_cand(n_reads, -1);
    std::vector<float> best_score(n_reads, 0.0f);
    std::vector<int32_t> tb;
    for (int64_t ci = 0; ci < n_cand; ci++) {
        int64_t ri = cand_read[ci];
        if (cand_nseg[ci] == 0) continue;
        const int16_t* row = chain_rows + ci * row_w;
        uint32_t bits = (uint16_t)row[msb + 1]
            | ((uint32_t)(uint16_t)row[msb + 2] << 16);
        float score;
        memcpy(&score, &bits, 4);
        if (!(score > best_score[ri])) continue;
        // chain non-empty after trim? walk it (cheap: chain length <=
        // segments) — an all-trimmed chain must not win the pick
        // (chain_batch_jax returns [] and map_batch skips falsy chains)
        int64_t best = row[msb];
        tb.clear();
        for (int64_t at = best; at >= 0; at = row[at]) tb.push_back((int32_t)at);
        int64_t prev_q = -1, prev_t = -1, kept = 0;
        const int32_t* qs = seg_qs + ci * max_segments;
        const int32_t* qe = seg_qe + ci * max_segments;
        const int32_t* ts = seg_ts + ci * max_segments;
        const int32_t* te = seg_te + ci * max_segments;
        for (int64_t i = (int64_t)tb.size() - 1; i >= 0; i--) {
            int32_t s = tb[i];
            int64_t trim = prev_q - qs[s];
            if (prev_t - ts[s] > trim) trim = prev_t - ts[s];
            if (trim < 0) trim = 0;
            if (qs[s] + trim >= qe[s] || ts[s] + trim >= te[s]) continue;
            kept++;
            prev_q = qe[s];
            prev_t = te[s];
        }
        if (kept == 0) continue;
        best_score[ri] = score;
        best_cand[ri] = ci;
    }

    std::vector<Run> runs;
    std::vector<DpDesc> descs;
    std::vector<int64_t> cq0, cqe, ct0, cte;
    int64_t total_runs = 0, total_probs = 0;
    bool overflow = false;
    run_off[0] = 0;
    for (int64_t ri = 0; ri < n_reads; ri++) {
        out_strand[ri] = -1;
        out_chrom[ri] = -1;
        run_off[ri + 1] = total_runs;
        int64_t ci = best_cand[ri];
        if (ci < 0) continue;
        const int16_t* row = chain_rows + ci * row_w;
        const int32_t* qs = seg_qs + ci * max_segments;
        const int32_t* qe = seg_qe + ci * max_segments;
        const int32_t* ts = seg_ts + ci * max_segments;
        const int32_t* te = seg_te + ci * max_segments;
        int64_t tbase = cand_tbase[ci];
        tb.clear();
        for (int64_t at = row[msb]; at >= 0; at = row[at])
            tb.push_back((int32_t)at);
        cq0.clear(); cqe.clear(); ct0.clear(); cte.clear();
        int64_t prev_q = -1, prev_t = -1;
        for (int64_t i = (int64_t)tb.size() - 1; i >= 0; i--) {
            int32_t s = tb[i];
            int64_t trim = prev_q - qs[s];
            if (prev_t - ts[s] > trim) trim = prev_t - ts[s];
            if (trim < 0) trim = 0;
            int64_t q0 = qs[s] + trim, t0 = ts[s] + trim;
            if (q0 >= qe[s] || t0 >= te[s]) continue;
            cq0.push_back(q0);
            cqe.push_back(qe[s]);
            ct0.push_back(t0 + tbase);
            cte.push_back(te[s] + tbase);
            prev_q = qe[s];
            prev_t = te[s];
        }
        int64_t nseg = (int64_t)cq0.size();
        if (nseg == 0) continue;
        int64_t total_len = 0;
        for (int64_t i = 0; i < nseg; i++) total_len += cqe[i] - cq0[i];
        if ((float)total_len < min_chain_score) continue;

        // oriented query codes for this read (the DP packing and the
        // emit phase both read from here)
        const uint8_t* codes = codes_all + read_off[ri];
        int64_t n = read_off[ri + 1] - read_off[ri];
        uint8_t* oq = oriented + read_off[ri];
        int32_t strand = cand_strand[ci];
        if (strand == 1)
            for (int64_t i = 0; i < n; i++) oq[i] = COMP[codes[n - 1 - i]];
        else
            memcpy(oq, codes, n);

        int32_t chrom = cand_chrom[ci];
        int64_t chrom_off = chrom_offsets[chrom];
        int64_t chrom_end = chrom_off + chrom_sizes[chrom];
        runs.clear();
        size_t d0 = descs.size();
        fill_runs(oq, n, genome, chrom_off, chrom_end, strand,
                  cq0.data(), cqe.data(), ct0.data(), cte.data(), nseg,
                  min_intron, dp_match, dp_mismatch, go_, ge_, end_bonus,
                  zdrop, band_width, max_end_extend, splice_slack,
                  noncanonical_penalty, runs, &descs);
        out_strand[ri] = strand;
        out_chrom[ri] = chrom;
        for (const Run& rn : runs) {
            if (total_runs < runs_cap) {
                runs_op[total_runs] = rn.op;
                runs_q0[total_runs] = rn.q0;
                runs_t0[total_runs] = rn.t0;
                // placeholder runs already carry the GLOBAL problem
                // index (fill_runs appends to the shared descs vector)
                runs_len[total_runs] = rn.len;
            } else {
                overflow = true;
            }
            total_runs++;
        }
        run_off[ri + 1] = total_runs;
        for (size_t di = d0; di < descs.size(); di++) {
            if (total_probs < prob_cap) {
                prob_read[total_probs] = (int32_t)ri;
                prob_mode[total_probs] = descs[di].mode;
                prob_q0[total_probs] = descs[di].q0;
                prob_t0[total_probs] = descs[di].t0;
                prob_nq[total_probs] = descs[di].nq;
                prob_nt[total_probs] = descs[di].nt;
            } else {
                overflow = true;
            }
            total_probs++;
        }
    }
    out_counts[0] = total_runs;
    out_counts[1] = total_probs;
    return overflow ? -1 : 0;
}

// Phase C — resolve DP placeholders with the device results (fused
// packed format: meta (n,4) int32, ks int32, reverse-order step codes)
// or the inline host solver (on_host problems: device-ineligible
// shapes), stable-sort each read's runs, and emit extended PSL per read
// (emit_psl_c). Returns 0, or -1 when blk/cs caps are too small
// (needed totals in out_needs).
int64_t stage_emit_batch_c(
    const uint8_t* oriented, const int64_t* read_off, int64_t n_reads,
    const uint8_t* genome,
    const int32_t* in_strand,
    const int64_t* run_off, const int8_t* runs_op, const int64_t* runs_q0,
    const int64_t* runs_t0, const int64_t* runs_len,
    const uint8_t* prob_mode, const int64_t* prob_q0,
    const int64_t* prob_t0, const int64_t* prob_nq, const int64_t* prob_nt,
    const uint8_t* on_host,
    const int32_t* dp_meta, const int32_t* dp_ks, const int8_t* dp_buf,
    int64_t dp_stride,
    int32_t match, int32_t mismatch, int32_t go_, int32_t ge_,
    int32_t end_bonus, int32_t zdrop,
    int64_t* stats, int64_t* blk_off, int64_t* blk_sizes, int64_t* blk_q,
    int64_t* blk_t, int64_t blk_cap, int64_t* cs_off, char* cs,
    int64_t cs_cap, int64_t* out_needs) {
    std::vector<Run> runs;
    std::vector<int8_t> mop;
    std::vector<int32_t> mdq, mdt;
    std::vector<uint8_t> ra, rb;
    int64_t blk_at = 0, cs_at = 0;
    bool overflow = false;
    int64_t need_blk = 0, need_cs = 0;
    blk_off[0] = 0;
    cs_off[0] = 0;
    for (int64_t ri = 0; ri < n_reads; ri++) {
        int64_t* st = stats + ri * 8;
        for (int i = 0; i < 8; i++) st[i] = 0;
        blk_off[ri + 1] = blk_at;
        cs_off[ri + 1] = cs_at;
        if (in_strand[ri] < 0) continue;
        const uint8_t* q = oriented + read_off[ri];
        runs.clear();
        for (int64_t k = run_off[ri]; k < run_off[ri + 1]; k++) {
            if (runs_op[k] != 4) {
                runs.push_back({runs_op[k], runs_q0[k], runs_t0[k],
                                runs_len[k]});
                continue;
            }
            int64_t pi = runs_len[k];
            int mode = prob_mode[pi];
            int64_t q0 = prob_q0[pi], t0 = prob_t0[pi];
            int64_t nq = prob_nq[pi], nt = prob_nt[pi];
            if (on_host[pi]) {
                int64_t qlen, tlen;
                const uint8_t *qs, *ts;
                if (mode == 2) {
                    ra.assign(nq, 0);
                    rb.assign(nt, 0);
                    for (int64_t i = 0; i < nq; i++) ra[i] = q[q0 - 1 - i];
                    for (int64_t i = 0; i < nt; i++)
                        rb[i] = genome[t0 - 1 - i];
                    qs = ra.data();
                    ts = rb.data();
                } else {
                    qs = q + q0;
                    ts = genome + t0;
                }
                solve_one_dp(qs, nq, ts, nt, mode == 0, match, mismatch,
                             go_, ge_, end_bonus, zdrop, &qlen, &tlen,
                             mop, mdq, mdt);
                expand_ops_into_runs(mode, q0, t0, qlen, tlen, mop, mdq,
                                     mdt, runs);
                continue;
            }
            // device result: meta = (best_i, best_j, best_score, final);
            // extension problems with best_score <= 0 emit nothing
            // (_solve_chunk's dead handling); global starts at (nq, nt)
            const int32_t* meta = dp_meta + pi * 4;
            int64_t qlen, tlen;
            if (mode == 0) { qlen = nq; tlen = nt; }
            else if (meta[2] <= 0) continue;
            else { qlen = meta[0]; tlen = meta[1]; }
            // merge reverse-order step codes (1 M, 2 I, 3 D) into
            // (op, dq, dt) runs — _merge_steps' contract
            mop.clear(); mdq.clear(); mdt.clear();
            const int8_t* buf = dp_buf + pi * dp_stride;
            for (int64_t i = (int64_t)dp_ks[pi] - 1; i >= 0; i--) {
                int8_t op = (int8_t)(buf[i] - 1);  // 0 M, 1 I, 2 D
                int32_t dq = op == 2 ? 0 : 1, dt = op == 1 ? 0 : 1;
                if (!mop.empty() && mop.back() == op) {
                    mdq.back() += dq;
                    mdt.back() += dt;
                } else {
                    mop.push_back(op);
                    mdq.push_back(dq);
                    mdt.push_back(dt);
                }
            }
            expand_ops_into_runs(mode, q0, t0, qlen, tlen, mop, mdq, mdt,
                                 runs);
        }
        if (runs.empty()) continue;
        std::stable_sort(runs.begin(), runs.end(),
                         [](const Run& a, const Run& b) {
                             if (a.q0 != b.q0) return a.q0 < b.q0;
                             return a.t0 < b.t0;
                         });
        std::vector<int8_t> r_op(runs.size());
        std::vector<int64_t> r_q(runs.size()), r_t(runs.size()),
            r_l(runs.size());
        for (size_t i = 0; i < runs.size(); i++) {
            r_op[i] = runs[i].op;
            r_q[i] = runs[i].q0;
            r_t[i] = runs[i].t0;
            r_l[i] = runs[i].len;
        }
        // worst case one block per run — reserve before emitting
        if (blk_at + (int64_t)runs.size() > blk_cap
            || cs_at >= cs_cap) {
            overflow = true;
            need_blk += (int64_t)runs.size();
            need_cs += 16 * (int64_t)(read_off[ri + 1] - read_off[ri]);
            continue;
        }
        int64_t cl = emit_psl_c(q, genome, r_op.data(), r_q.data(),
                                r_t.data(), r_l.data(),
                                (int64_t)runs.size(), st,
                                blk_sizes + blk_at, blk_q + blk_at,
                                blk_t + blk_at, cs + cs_at,
                                cs_cap - cs_at);
        if (cl < 0) {
            overflow = true;
            need_cs += -cl;
            for (int i = 0; i < 8; i++) st[i] = 0;
            continue;
        }
        blk_at += st[7];
        cs_at += cl;
        blk_off[ri + 1] = blk_at;
        cs_off[ri + 1] = cs_at;
        need_blk += st[7];
        need_cs += cl;
    }
    out_needs[0] = need_blk;
    out_needs[1] = need_cs;
    return overflow ? -1 : 0;
}

}  // extern "C"
