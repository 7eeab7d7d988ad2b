// Fused chunk tote: the device step of batched detection, for Hopper.
//
// Replaces language_detector_tpu/ops/kernels.py::_fused_tote_kernel (the
// Pallas kernel) together with its XLA gather prologue _gather_wire: one
// launch turns the chunk-major flat wire into one packed u32 word per
// chunk row (two with full output), bit-identical to the reference
// program ops/score.py::score_chunks_impl.
//
// What bounds it on an H100: not bytes or arithmetic. The main path's
// wire is about 1 MB (2-byte slot indices, ~20 bytes of row metadata)
// and the langprob table (cat_ind2, 155 KB) stays resident in L2, so the
// launch latency and the dependent L2 gathers (idx -> cat_ind2 ->
// lg_prob3) set the time; PERF.md carries the measured time beside the
// bound.
//
// Design: one block of 256 threads per chunk row; thread t owns
// per-script language t. The row's tote lives in shared memory as 256
// ints and is filled with integer atomicAdd (exact in any order). Whack
// and hint-prior masks are gathered per thread straight from their
// small tables, so no [G, 256] plane ever reaches device memory (the
// Pallas path materialised both). The group-in-use top-2 is two
// block-wide max reductions over sortkey = score * 256 + (255 - lang):
// the key is unique per in-use language and carries its index in the
// low byte. Thread 0 then computes the reliability terms and writes the
// words. Every table gather clamps its index exactly as XLA clamps
// out-of-range gathers, so adversarial wires agree too.
//
// Exactness: build without --use_fast_math and with --fmad=false so the
// float32 reliability ratio rounds as XLA's does (IEEE division, no
// contraction), and the int cast truncates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLangs = 256;
constexpr int kHintBase = 40960;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// cldutil.cc:553-570, integer math
__device__ __forceinline__ int reliability_delta(int s1, int s2,
                                                 int grams) {
    int maxp = grams < 8 ? 12 * grams : 100;
    int thresh = clampi((grams * 5) >> 3, 3, 16);
    int delta = s1 - s2;
    if (delta >= thresh) return maxp;
    if (delta <= 0) return 0;
    int v = (100 * delta) / thresh;  // both positive: floor == trunc
    return v < maxp ? v : maxp;
}

// cldutil.cc:587-605, float32 ratio math as the reference program does it
__device__ __forceinline__ int reliability_expected(int actual,
                                                    int expected) {
    float hi = (float)(actual > expected ? actual : expected);
    float lo = (float)(actual < expected ? actual : expected);
    float ratio = __fdiv_rn(hi, fmaxf(lo, 1.0f));
    int pct = (int)__fdiv_rn(__fmul_rn(100.0f, __fsub_rn(4.0f, ratio)),
                             2.5f);
    if (ratio <= 1.5f) pct = 100;
    else if (ratio > 4.0f) pct = 0;
    if (expected == 0) pct = 100;
    if (actual == 0) return expected == 0 ? 100 : 0;
    return pct;
}

__device__ __forceinline__ int block_max(int v, int* scratch) {
    // scratch: 8 ints in shared memory; caller syncs before reuse
    for (int off = 16; off > 0; off >>= 1)
        v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) scratch[warp] = v;
    __syncthreads();
    int m = scratch[0];
#pragma unroll
    for (int w = 1; w < kLangs / 32; ++w) m = max(m, scratch[w]);
    return m;
}

__global__ void __launch_bounds__(kLangs)
fused_tote_kernel(const unsigned short* __restrict__ idx, long long n_idx,
                  const long long* __restrict__ cstart,
                  const unsigned char* __restrict__ cnsl,
                  const unsigned int* __restrict__ cmeta,
                  const unsigned char* __restrict__ cscript,
                  const unsigned short* __restrict__ cwhack,
                  const unsigned char* __restrict__ whack_tbl, int n_whack,
                  const unsigned short* __restrict__ cprior,
                  const unsigned char* __restrict__ prior_tbl, int n_prior,
                  const unsigned int* __restrict__ hint_lp, int n_hint,
                  const unsigned int* __restrict__ cat_ind2, int n_cat,
                  const unsigned char* __restrict__ lg_prob3, int n_lg,
                  const int* __restrict__ plang_to_lang,
                  const int* __restrict__ expected_score,
                  const int* __restrict__ close_set, int n_lang,
                  int K, int full_out, unsigned int* __restrict__ out) {
    __shared__ int tote[kLangs];
    __shared__ int scratch[kLangs / 32];
    const int g = blockIdx.x;
    const int t = threadIdx.x;

    tote[t] = 0;
    __syncthreads();

    // gather + decode: valid slots are k < cnsl (and k < K, the row
    // width the reference program's [G, K] grid has)
    const int n = min((int)cnsl[g], K);
    const long long cs = cstart[g];
    for (int k = t; k < n; k += kLangs) {
        const int raw = idx[clampll(cs + k, 0, n_idx - 1)];
        const unsigned int lp = raw >= kHintBase
            ? hint_lp[clampi(raw - kHintBase, 0, n_hint - 1)]
            : cat_ind2[min(raw, n_cat - 1)];
        const int row = min((int)(lp & 0xFFu), n_lg - 1);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int ps = (lp >> (8 * (j + 1))) & 0xFFu;
            if (ps > 0) atomicAdd(&tote[ps], (int)lg_prob3[row * 3 + j]);
        }
    }
    __syncthreads();

    const unsigned int meta = cmeta[g];
    const int side = (meta >> 28) & 1;
    const int group_score = tote[t];
    int score = group_score;
    if (n_whack > 0) {
        const int w = clampi(cwhack[g], 0, n_whack - 1);
        if (whack_tbl[(w * 2 + side) * kLangs + t] > 0) score = 0;
    }
    if (n_prior > 0 && score > 0) {
        const int pr = clampi(cprior[g], 0, n_prior - 1);
        score += prior_tbl[(pr * 2 + side) * kLangs + t];
    }
    // group-in-use: any pre-whack tote of this language's group of 4
    const int g0 = t & ~3;
    const bool in_use = tote[g0] > 0 || tote[g0 + 1] > 0 ||
                        tote[g0 + 2] > 0 || tote[g0 + 3] > 0;
    const int key = in_use ? score * 256 + (255 - t) : -1;

    // top-2: a key >= 0 carries its language in the low byte; an
    // all -1 row picks index 0, as argmax does
    const int top1 = block_max(key, scratch);
    const int k1 = top1 >= 0 ? 255 - (top1 & 0xFF) : 0;
    __syncthreads();
    const int top2 = block_max(t == k1 ? -1 : key, scratch);
    if (t != 0) return;
    const int k2 = top2 >= 0 ? 255 - (top2 & 0xFF) : 0;
    const int s1 = top1 >= 0 ? top1 >> 8 : 0;
    const int s2 = top2 >= 0 ? top2 >> 8 : 0;

    const int lang1 = plang_to_lang[side * kLangs + k1];
    const int lang2 = plang_to_lang[side * kLangs + k2];
    const int cbytes = meta & 0xFFFFu;
    const int grams = (meta >> 16) & 0xFFFu;
    const unsigned int real = (meta >> 29) & 1u;
    const int script = cscript[g];
    const int lscript = script == 1 ? 0 : script == 3 ? 1
                        : script == 6 ? 2 : 3;
    const int actual_kb = cbytes > 0 ? (s1 << 10) / cbytes : 0;
    const int l1 = clampi(lang1, 0, n_lang - 1);
    const int l2 = clampi(lang2, 0, n_lang - 1);
    const int expected_kb = expected_score[l1 * 4 + lscript];
    int rd = reliability_delta(s1, s2, grams);
    if (close_set[l1] != 0 && close_set[l1] == close_set[l2]) rd = 100;
    const int rs = reliability_expected(actual_kb, expected_kb);
    const int crel = min(rd, rs);

    const unsigned int word1 = (unsigned int)lang1 |
        ((unsigned int)clampi(s1, 0, 0x3FFF) << 10) |
        ((unsigned int)clampi(crel, 0, 127) << 24) | (real << 31);
    if (!full_out) {
        out[g] = word1;
        return;
    }
    out[2 * g] = word1;
    out[2 * g + 1] = (unsigned int)lang2 |
        ((unsigned int)clampi(rd, 0, 127) << 10) |
        ((unsigned int)clampi(rs, 0, 127) << 17);
}

}  // namespace

// Plain C entry point (bound with ctypes): launches on `stream`, returns
// cudaGetLastError() so a refused launch surfaces at the call site.
extern "C" int ldt_fused_tote(
        const void* idx, long long n_idx, const void* cstart,
        const void* cnsl, const void* cmeta, const void* cscript,
        const void* cwhack, const void* whack_tbl, int n_whack,
        const void* cprior, const void* prior_tbl, int n_prior,
        const void* hint_lp, int n_hint, const void* cat_ind2, int n_cat,
        const void* lg_prob3, int n_lg, const void* plang_to_lang,
        const void* expected_score, const void* close_set, int n_lang,
        int G, int K, int full_out, void* out, void* stream) {
    if (G > 0) {
        fused_tote_kernel<<<G, kLangs, 0, (cudaStream_t)stream>>>(
            (const unsigned short*)idx, n_idx, (const long long*)cstart,
            (const unsigned char*)cnsl, (const unsigned int*)cmeta,
            (const unsigned char*)cscript, (const unsigned short*)cwhack,
            (const unsigned char*)whack_tbl, n_whack,
            (const unsigned short*)cprior, (const unsigned char*)prior_tbl,
            n_prior, (const unsigned int*)hint_lp, n_hint,
            (const unsigned int*)cat_ind2, n_cat,
            (const unsigned char*)lg_prob3, n_lg,
            (const int*)plang_to_lang, (const int*)expected_score,
            (const int*)close_set, n_lang, K, full_out,
            (unsigned int*)out);
    }
    return (int)cudaGetLastError();
}
