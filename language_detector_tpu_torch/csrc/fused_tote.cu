// Fused chunk tote: the device step of batched detection, for Hopper.
//
// Replaces language_detector_tpu/ops/kernels.py::_fused_tote_kernel (the
// Pallas kernel) together with its XLA gather prologue _gather_wire,
// chunk starts included: one launch turns the chunk-major flat wire into
// one packed u32 word per chunk row (two with full output), bit-identical
// to the reference program ops/score.py::score_chunks_impl.
//
// What bounds it on an H100: not bytes or arithmetic. The main path's
// wire is about 0.5 MB (2-byte slot indices, ~10 bytes of row metadata)
// and the tables it gathers from (cat_ind2 155 KB, lg_prob3, the tail's
// language tables) stay resident in L2, so the time is the launch plus
// the latency of each row's chain of dependent L2 gathers (chunk start
// -> idx -> cat_ind2 -> lg_prob3 -> shared-memory tote -> plang_to_lang
// -> expected_score / close_set) and the instructions issued around it.
// PERF.md carries the measured time beside the bound and the launch
// floor.
//
// Design: keep as many rows' chains in flight as the card holds, in one
// wave, with no block-wide barrier inside a row and one launch per
// dispatch.
// - One warp per chunk row, 8 rows per 256-thread block. Each warp owns a
//   256-int tote in shared memory (1 KB), zeroed with 16-byte stores.
//   Lanes stride the row's slots and add their three (pslang, qprob)
//   terms with shared-memory integer atomicAdd (exact in any order). The
//   row's body synchronises with __syncwarp only.
// - Lane l owns languages 8l .. 8l+7: two whole groups of four, so the
//   group-in-use test is lane-local. It reads its 8 tote values as two
//   int4 loads and the row's whack and prior bytes as one 8-byte load
//   each (whack first, then the prior only where the score is above 0).
// - Top-2 in registers: each lane takes the top-2 of its 8 sortkeys
//   (score * 256 + 255 - lang, -1 when the group is not in use), then a
//   5-step xor butterfly merges the pairs. Keys are unique per in-use
//   language, so this equals the reference's argmax followed by a masked
//   argmax; an all -1 row picks index 0 for both.
// - The rows' tails (plang_to_lang, expected_score / close_set, the
//   reliability terms, the words) run after the block's rows, one row a
//   thread: a block's 8 tails cost one warp's issue slots, not eight (a
//   tail on lane 0 of each row's warp was measurably slower).
// - Chunk starts are scanned inside the kernel. The grid is persistent:
//   min(ceil(G / 8), SMs x resident blocks per SM) blocks, each owning
//   one contiguous range of rows. A block walks its range in tiles of 256
//   rows: a segmented exclusive scan of the tile's counts (it restarts at
//   every shard row, as the reference's per-shard cumsum does) goes to
//   shared memory, the block's 8 warps score the tile's rows, and its
//   threads run their tails. The first tile's scan also sums the range's
//   exclusive base, the cnsl bytes from its shard row's start to its
//   first row (16-byte loads, L2-resident), under the same barrier.
// - __launch_bounds__(256, 8): 8 resident blocks (64 rows) per SM at 32
//   registers a thread (ptxas spills a few bytes; 6 blocks at 40
//   registers spill none but ran slower). At G = 8,192 the grid is one
//   wave (132 SMs x 8 blocks x 8 rows = 8,448 rows).
// Every table gather clamps its index exactly as XLA clamps out-of-range
// gathers, so adversarial wires agree too.
//
// Exactness: build without --use_fast_math and with --fmad=false so the
// float32 reliability ratio rounds as XLA's does (IEEE division, no
// contraction), and the int cast truncates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLangs = 256;
constexpr int kHintBase = 40960;
constexpr int kWarps = 8;                  // chunk rows in flight per block
constexpr int kThreads = kWarps * 32;      // also the scan tile, in rows
constexpr int kMinBlocksPerSM = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr long long kMaxShardRows = 1 << 23;  // 255 * 2^23 < 2^31

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

// sum of the four bytes of a word
__device__ __forceinline__ int byte_sum(unsigned int x) {
    unsigned int s = (x & 0x00FF00FFu) + ((x >> 8) & 0x00FF00FFu);
    return (int)((s & 0xFFFFu) + (s >> 16));
}

// this thread's share of the sum of p[a, b): 16-byte loads over the
// aligned middle, single bytes at the two ragged ends
__device__ __forceinline__ int byte_sum_part(const unsigned char* p,
                                             long long a, long long b) {
    const int tid = threadIdx.x;
    int part = 0;
    if (a >= b) return 0;
    const uintptr_t pa = (uintptr_t)(p + a), pb = (uintptr_t)(p + b);
    const uintptr_t qa = (pa + 15) & ~(uintptr_t)15;
    const uintptr_t qb = pb & ~(uintptr_t)15;
    if (qa >= qb) {
        for (long long i = a + tid; i < b; i += kThreads) part += p[i];
        return part;
    }
    if (tid < (long long)(qa - pa)) part += p[a + tid];
    if (tid < (long long)(pb - qb)) part += ((const unsigned char*)qb)[tid];
    const uint4* q = (const uint4*)qa;
    const long long nq = (long long)(qb - qa) / 16;
    for (long long i = tid; i < nq; i += kThreads) {
        const uint4 x = q[i];
        part += byte_sum(x.x) + byte_sum(x.y) + byte_sum(x.z) + byte_sum(x.w);
    }
    return part;
}

struct Planes {
    const unsigned short* idx;
    long long n_idx;
    const unsigned int* cmeta;
    const unsigned char* cscript;
    const unsigned short* cwhack;
    const unsigned char* whack_tbl;
    int n_whack;
    const unsigned short* cprior;
    const unsigned char* prior_tbl;
    int n_prior;
    const unsigned int* hint_lp;
    int n_hint;
    const unsigned int* cat_ind2;
    int n_cat;
    const unsigned char* lg_prob3;
    int n_lg;
    const int* plang_to_lang;
    const int* expected_score;
    const int* close_set;
    int n_lang;
    int K;
    int full_out;
    unsigned int* out;
};

// One chunk row on one warp (tote: the warp's 256 ints in shared memory):
// the tote, whack and prior, and the top-2 sortkeys, which lane 0 stores
// to top[0..1] for the row's tail.
__device__ __forceinline__ void score_row(const Planes& P, long long g,
                                          int cs, int cnt,
                                          int* __restrict__ tote,
                                          int* __restrict__ top, int lane) {
    // the whack / prior bytes do not depend on the gather: issue first
    unsigned long long wbits = 0, pbits = 0;
    if (P.n_whack > 0 || P.n_prior > 0) {
        const int side = (P.cmeta[g] >> 28) & 1;
        if (P.n_whack > 0) {
            const int w = clampi(P.cwhack[g], 0, P.n_whack - 1);
            wbits = *(const unsigned long long*)(
                P.whack_tbl + (w * 2 + side) * kLangs + 8 * lane);
        }
        if (P.n_prior > 0) {
            const int pr = clampi(P.cprior[g], 0, P.n_prior - 1);
            pbits = *(const unsigned long long*)(
                P.prior_tbl + (pr * 2 + side) * kLangs + 8 * lane);
        }
    }

    int4* t4 = reinterpret_cast<int4*>(tote);
    __syncwarp();  // the previous row's tote reads are done
    t4[lane] = make_int4(0, 0, 0, 0);
    t4[lane + 32] = make_int4(0, 0, 0, 0);
    __syncwarp();

    // gather + decode: valid slots are k < cnsl (and k < K, the row
    // width the reference program's [G, K] grid has)
    const int n = min(cnt, P.K);
    for (int k = lane; k < n; k += 32) {
        const int raw = P.idx[clampll((long long)cs + k, 0, P.n_idx - 1)];
        const unsigned int lp = raw >= kHintBase
            ? P.hint_lp[clampi(raw - kHintBase, 0, P.n_hint - 1)]
            : P.cat_ind2[min(raw, P.n_cat - 1)];
        const int row = min((int)(lp & 0xFFu), P.n_lg - 1);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int ps = (lp >> (8 * (j + 1))) & 0xFFu;
            if (ps > 0) atomicAdd(&tote[ps], (int)P.lg_prob3[row * 3 + j]);
        }
    }
    __syncwarp();

    // languages 8*lane .. 8*lane+7: two whole groups of four
    const int4 a = t4[2 * lane];
    const int4 b = t4[2 * lane + 1];
    const int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const bool use0 = a.x > 0 || a.y > 0 || a.z > 0 || a.w > 0;
    const bool use1 = b.x > 0 || b.y > 0 || b.z > 0 || b.w > 0;
    int t1 = -1, t2 = -1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int s = v[i];
        if ((wbits >> (8 * i)) & 0xFFu) s = 0;          // whack first
        if (s > 0) s += (int)((pbits >> (8 * i)) & 0xFFu);  // then prior
        const int key = (i < 4 ? use0 : use1)
            ? s * 256 + (255 - (8 * lane + i)) : -1;
        if (key > t1) {
            t2 = t1;
            t1 = key;
        } else if (key > t2) {
            t2 = key;
        }
    }
    // merge the lanes' (top1, top2) pairs; each step joins disjoint sets
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int o1 = __shfl_xor_sync(kFull, t1, off);
        const int o2 = __shfl_xor_sync(kFull, t2, off);
        t2 = max(min(t1, o1), max(t2, o2));
        t1 = max(t1, o1);
    }
    if (lane == 0) {
        top[0] = t1;
        top[1] = t2;
    }
}

// A row's tail on one thread: languages from the top-2 sortkeys, the
// reliability terms, the packed words.
__device__ __forceinline__ void row_tail(const Planes& P, long long g,
                                         int t1, int t2) {
    const unsigned int meta = P.cmeta[g];
    const int side = (meta >> 28) & 1;
    // a key >= 0 carries its language in the low byte; an all -1 row
    // picks index 0, as argmax does
    const int k1 = t1 >= 0 ? 255 - (t1 & 0xFF) : 0;
    const int k2 = t2 >= 0 ? 255 - (t2 & 0xFF) : 0;
    const int s1 = t1 >= 0 ? t1 >> 8 : 0;
    const int s2 = t2 >= 0 ? t2 >> 8 : 0;

    const int lang1 = P.plang_to_lang[side * kLangs + k1];
    const int lang2 = P.plang_to_lang[side * kLangs + k2];
    const int cbytes = meta & 0xFFFFu;
    const int grams = (meta >> 16) & 0xFFFu;
    const unsigned int real = (meta >> 29) & 1u;
    const int script = P.cscript[g];
    const int lscript = script == 1 ? 0 : script == 3 ? 1
                        : script == 6 ? 2 : 3;
    const int actual_kb = cbytes > 0 ? (s1 << 10) / cbytes : 0;
    const int l1 = clampi(lang1, 0, P.n_lang - 1);
    const int l2 = clampi(lang2, 0, P.n_lang - 1);
    const int expected_kb = P.expected_score[l1 * 4 + lscript];
    int rd = reliability_delta(s1, s2, grams);
    if (P.close_set[l1] != 0 && P.close_set[l1] == P.close_set[l2])
        rd = 100;
    const int rs = reliability_expected(actual_kb, expected_kb);
    const int crel = min(rd, rs);

    const unsigned int word1 = (unsigned int)lang1 |
        ((unsigned int)clampi(s1, 0, 0x3FFF) << 10) |
        ((unsigned int)clampi(crel, 0, 127) << 24) | (real << 31);
    if (!P.full_out) {
        P.out[g] = word1;
        return;
    }
    P.out[2 * g] = word1;
    P.out[2 * g + 1] = (unsigned int)lang2 |
        ((unsigned int)clampi(rd, 0, 127) << 10) |
        ((unsigned int)clampi(rs, 0, 127) << 17);
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
fused_tote_kernel(const unsigned char* __restrict__ cnsl, long long G,
                  long long Gs, Planes P) {
    __shared__ __align__(16) int tote[kWarps][kLangs];
    __shared__ int s_start[kThreads];
    __shared__ int s_cnt[kThreads];
    __shared__ int s_top[kThreads][2];
    __shared__ int s_wv[kWarps];
    __shared__ int s_wf[kWarps];
    __shared__ int s_base[kWarps];
    __shared__ int s_carry;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long r0 = (long long)blockIdx.x * G / gridDim.x;
    const long long r1 = (long long)(blockIdx.x + 1) * G / gridDim.x;

    // Sums fit in int: the wrapper holds Gs to at most 2^23 rows, so a
    // shard row's counts (at most 255 each) sum below 2^31.
    int carry = 0;
    for (long long t0 = r0; t0 < r1; t0 += kThreads) {
        const int nt = (int)min((long long)kThreads, r1 - t0);
        // the first tile also sums the range's exclusive base: its shard
        // row's counts before r0; both go through one barrier
        int base = t0 == r0 ? byte_sum_part(cnsl, r0 - r0 % Gs, r0) : 0;
        // segmented inclusive scan of the tile's counts; a flag marks a
        // shard row's first row, where the sum restarts
        const long long g = t0 + tid;
        const int c = tid < nt ? cnsl[g] : 0;
        int f = tid < nt && g % Gs == 0;
        int v = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int fp = __shfl_up_sync(kFull, f, off);
            const int vp = __shfl_up_sync(kFull, v, off);
            base += __shfl_xor_sync(kFull, base, off);
            if (lane >= off) {
                if (!f) v += vp;
                f |= fp;
            }
        }
        if (lane == 31) {
            s_wf[warp] = f;
            s_wv[warp] = v;
            s_base[warp] = base;
        }
        __syncthreads();
        int pv = carry;  // the tile's carry and base head its first segment
#pragma unroll
        for (int w = 0; w < kWarps; ++w) pv += s_base[w];
        for (int w = 0; w < warp; ++w)
            pv = s_wf[w] ? s_wv[w] : pv + s_wv[w];
        if (!f) v += pv;
        if (tid < nt) {
            s_start[tid] = v - c;
            s_cnt[tid] = c;
        }
        if (tid == nt - 1) s_carry = v;
        __syncthreads();
        carry = s_carry;

        for (int i = warp; i < nt; i += kWarps)
            score_row(P, t0 + i, s_start[i], s_cnt[i], tote[warp],
                      s_top[i], lane);
        __syncthreads();
        // the tile's tails, one row a thread
        if (tid < nt) row_tail(P, t0 + tid, s_top[tid][0], s_top[tid][1]);
        if (t0 + kThreads < r1) __syncthreads();  // s_* rewritten next tile
    }
}

// resident blocks on the whole card, per device; 0 = not asked yet
int g_resident[kMaxDevices];

}  // namespace

// Blocks of the kernel that one SM holds at once, and the device's SM
// count (cached per device after the first call). Returns a CUDA error.
extern "C" int ldt_fused_tote_occupancy(int device, int* per_sm,
                                        int* sms) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, fused_tote_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    if (*per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    if (device >= 0 && device < kMaxDevices)
        g_resident[device] = *per_sm * *sms;
    return 0;
}

// Plain C entry point (bound with ctypes): one launch on `stream` over a
// [G / Gs, Gs] chunk grid; returns cudaGetLastError() so a refused launch
// surfaces at the call site.
extern "C" int ldt_fused_tote(
        const void* idx, long long n_idx, const void* cnsl, long long Gs,
        const void* cmeta, const void* cscript,
        const void* cwhack, const void* whack_tbl, int n_whack,
        const void* cprior, const void* prior_tbl, int n_prior,
        const void* hint_lp, int n_hint, const void* cat_ind2, int n_cat,
        const void* lg_prob3, int n_lg, const void* plang_to_lang,
        const void* expected_score, const void* close_set, int n_lang,
        long long G, int K, int full_out, void* out, int device,
        void* stream) {
    if (G <= 0) return 0;
    if (Gs <= 0 || Gs > kMaxShardRows || G % Gs != 0)
        return (int)cudaErrorInvalidValue;
    int resident = device >= 0 && device < kMaxDevices
        ? g_resident[device] : 0;
    if (resident == 0) {
        int per_sm = 0, sms = 0;
        const int e = ldt_fused_tote_occupancy(device, &per_sm, &sms);
        if (e != 0) return e;
        resident = per_sm * sms;
    }
    const long long want = (G + kWarps - 1) / kWarps;
    const int blocks = (int)(want < resident ? want : resident);
    Planes P;
    P.idx = (const unsigned short*)idx;
    P.n_idx = n_idx;
    P.cmeta = (const unsigned int*)cmeta;
    P.cscript = (const unsigned char*)cscript;
    P.cwhack = (const unsigned short*)cwhack;
    P.whack_tbl = (const unsigned char*)whack_tbl;
    P.n_whack = n_whack;
    P.cprior = (const unsigned short*)cprior;
    P.prior_tbl = (const unsigned char*)prior_tbl;
    P.n_prior = n_prior;
    P.hint_lp = (const unsigned int*)hint_lp;
    P.n_hint = n_hint;
    P.cat_ind2 = (const unsigned int*)cat_ind2;
    P.n_cat = n_cat;
    P.lg_prob3 = (const unsigned char*)lg_prob3;
    P.n_lg = n_lg;
    P.plang_to_lang = (const int*)plang_to_lang;
    P.expected_score = (const int*)expected_score;
    P.close_set = (const int*)close_set;
    P.n_lang = n_lang;
    P.K = K;
    P.full_out = full_out;
    P.out = (unsigned int*)out;
    fused_tote_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)cnsl, G, Gs, P);
    return (int)cudaGetLastError();
}
