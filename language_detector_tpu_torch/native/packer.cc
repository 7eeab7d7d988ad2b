// Native host-side batch packer: UTF-8 texts -> fixed-shape candidate
// tensors for the TPU scorer.
//
// C++ twin of preprocess/{segment,grams,hashing,squeeze,pack}.py — the
// byte-level, inherently sequential front half of detection (reference:
// getonescriptspan.cc:799 scanner, cldutil_shared.cc:107-386 hashes,
// cldutil.cc:315-533 gram scans, compact_lang_det_impl.cc:541-971 squeeze
// predictor). The Python packer is the behavioral spec (itself
// oracle-parity-tested); tests/test_native_pack.py asserts array-for-array
// equality between the two.
//
// Build: native/build.sh  ->  libldtpack.so (loaded via ctypes).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "ldt_internal.h"

// Stage cycle counters, compiled in only for profiling builds.
// build.sh never defines LDT_PROF and no LDT_PROF_SCOPE marker exists
// in this file: tools/profile_pack.py generates packer_prof.cc with
// scopes inserted at the stage boundaries and builds the instrumented
// .so side by side. Slots: 0 segment, 1 quad scan, 2 word scan,
// 4 emission pass, 5 build_span, 7 whole pack_resolve_one_doc.
#ifdef LDT_PROF
#include <x86intrin.h>

#include <atomic>
// Plain u64 storage for the ctypes reader, updated with atomic RMWs:
// the flat pack runs docs on multiple worker threads, and non-atomic
// += would silently drop increments on multi-core hosts.
extern "C" uint64_t ldt_prof_cycles[8];
uint64_t ldt_prof_cycles[8] = {};
namespace {
struct ProfScope {
  int i;
  uint64_t t0;
  explicit ProfScope(int i) : i(i), t0(__rdtsc()) {}
  ~ProfScope() {
    reinterpret_cast<std::atomic<uint64_t>*>(&ldt_prof_cycles[i])
        ->fetch_add(__rdtsc() - t0, std::memory_order_relaxed);
  }
};
}  // namespace
#define LDT_PROF_CAT2(a, b) a##b
#define LDT_PROF_CAT(a, b) LDT_PROF_CAT2(a, b)
#define LDT_PROF_SCOPE(i) ProfScope LDT_PROF_CAT(_prof_scope_, __LINE__)(i)
#else
#define LDT_PROF_SCOPE(i)
#endif

namespace {

// ---- candidate kinds (preprocess/pack.py) ----
enum Kind : int8_t {
  PAD = 0, SEED = 1, QUAD = 2, UNI = 3,
  DELTA_OCTA = 4, DISTINCT_OCTA = 5, BI_DELTA = 6, BI_DISTINCT = 7
};

constexpr int kMaxScoringHits = 1000;       // scoreonescriptspan.h:93
constexpr int kMaxSpanPutBytes = 40960 - 32;  // getonescriptspan.h:29-32
constexpr int kSoftSpanPutBytes = kMaxSpanPutBytes - 32;
constexpr int kTailPad = 32;
constexpr int kSqueezeTestThresh = 4096;    // kCheapSqueezeTestThresh
constexpr int kSqueezeTestLen = 256;
constexpr int kPredictionTableSize = 4096;
constexpr int kUlScriptInherited = 40;
constexpr int kUlScriptLatin = 1;

// ---- global tables (ldt_init; backing arrays owned by Python) ----
struct Ctx {
  const uint8_t* script_of_cp;   // [0x110000]
  const uint32_t* lower_map;     // [0x110000]
  const uint8_t* cjk_prop;       // [0x110000]
  const int32_t* rtype;          // [n_scripts]
  const int32_t* deflang;        // [n_scripts]
  const uint32_t* seed_lp;       // [n_scripts]
  int n_scripts;
  int distinctbi_empty;
};
Ctx g;

// ---- byte-class advance tables (cldutil_shared.h:462, cldutil.cc:49-99) --
struct AdvTables {
  int8_t but_space[256];   // 0 for <=0x20; 1/2/3/4 by UTF-8 lead
  int8_t one[256];
  int8_t space_vowel[256]; // 1 on space/ASCII-vowel/continuation/ctrl
  AdvTables() {
    for (int i = 0; i < 256; i++) {
      but_space[i] = i <= 0x20 ? 0 : i < 0xC0 ? 1 : i < 0xE0 ? 2
                     : i < 0xF0 ? 3 : 4;
      one[i] = i < 0xC0 ? 1 : i < 0xE0 ? 2 : i < 0xF0 ? 3 : 4;
      space_vowel[i] = (i <= 0x20) || (i >= 0x80 && i < 0xC0);
    }
    for (const char* v = "AEIOUaeiou"; *v; v++)
      space_vowel[(uint8_t)*v] = 1;
  }
};
const AdvTables adv;

inline uint32_t load32(const uint8_t* p) {
  uint32_t w;
  std::memcpy(&w, p, 4);  // little-endian hosts only (x86/arm64)
  return w;
}

constexpr uint32_t kPreSpace = 0x00004444;   // cldutil_shared.cc:41
constexpr uint32_t kPostSpace = 0x44440000;
const uint32_t kWordMask[4] = {0xFFFFFFFFu, 0x000000FFu, 0x0000FFFFu,
                               0x00FFFFFFu};

// QuadHashV2 (cldutil_shared.cc:196; preprocess/hashing.py quad_hash_v2)
uint32_t quad_hash(const uint8_t* buf, int64_t pos, int64_t len) {
  if (len == 0) return 0;
  uint32_t prepost = (buf[pos - 1] == 0x20 ? kPreSpace : 0) |
                     (buf[pos + len] == 0x20 ? kPostSpace : 0);
  uint32_t mask = kWordMask[len & 3];
  if (len <= 4) {
    uint32_t w0 = load32(buf + pos) & mask;
    w0 ^= w0 >> 3;
    return w0 ^ prepost;
  }
  uint32_t w0 = load32(buf + pos);
  w0 ^= w0 >> 3;
  if (len <= 8) {
    uint32_t w1 = load32(buf + pos + 4) & mask;
    w1 ^= w1 << 4;
    return (w0 ^ prepost) + w1;
  }
  uint32_t w1 = load32(buf + pos + 4);
  w1 ^= w1 << 4;
  uint32_t w2 = load32(buf + pos + 8) & mask;
  w2 ^= w2 << 2;
  return (w0 ^ prepost) + w1 + w2;
}

// OctaHash40 (cldutil_shared.cc:348; hashing.py octa_hash40)
const int kOctaShift[6] = {3, -4, -2, 8, 4, 6};

uint64_t octa_hash40(const uint8_t* buf, int64_t pos, int64_t len,
                     int64_t buflen) {
  if (len == 0) return 0;
  uint64_t prepost = (buf[pos - 1] == 0x20 ? kPreSpace : 0) |
                     (buf[pos + len] == 0x20 ? kPostSpace : 0);
  uint64_t mask = kWordMask[len & 3];
  int ngroups = (int)((len - 1) >> 2);
  if (ngroups > 5) ngroups = 5;
  uint64_t word0 = 0, csum = 0;
  for (int gidx = 0; gidx <= ngroups; gidx++) {
    int64_t gpos = pos + 4 * gidx;
    if (gpos > buflen - 4) gpos = buflen - 4;  // clip like the Python spec
    uint64_t w = load32(buf + gpos);
    if (gidx == ngroups) w &= mask;
    csum += w;
    int s = kOctaShift[gidx];
    uint64_t mixed = s > 0 ? (w ^ (w >> s)) : (w ^ (w << -s));
    word0 += mixed;
  }
  csum += csum >> 17;
  csum += csum >> 9;
  csum = (csum & 0xFF) << 32;
  return (word0 ^ prepost) + csum;
}

// BiHashV2 (cldutil_shared.cc:107; hashing.py bi_hash_v2)
uint32_t bi_hash(const uint8_t* buf, int64_t pos, int64_t len) {
  if (len == 0) return 0;
  uint32_t mask = kWordMask[len & 3];
  if (len <= 4) {
    uint32_t w0 = load32(buf + pos) & mask;
    w0 ^= w0 >> 3;
    return w0;
  }
  uint32_t w0 = load32(buf + pos);
  w0 ^= w0 >> 3;
  uint32_t w1 = load32(buf + pos + 4) & mask;
  w1 ^= w1 << 18;
  return w0 + w1;
}

// PairHash (cldutil_shared.cc:384)
inline uint64_t pair_hash(uint64_t a, uint64_t b) {
  return ((a >> 13) | (a << 51)) + b;
}

// ---- squeeze trigger (compact_lang_det_impl.cc:541-605, :952-971) ----
int count_spaces4(const uint8_t* buf, int len) {
  int n = len & ~3, c = 0;
  for (int i = 0; i < n; i++) c += buf[i] == 0x20;
  return c;
}

// CountPredictedBytes (compact_lang_det_impl.cc:541; squeeze.py): bytes
// whose UTF-8 char the rolling 12-bit-hash table predicted.
int count_predicted(const uint8_t* buf, int start, int len, int* hash,
                    int64_t* tbl) {
  int predicted = 0, h = *hash, i = start;
  const int limit = start + len;
  while (i < limit) {
    uint8_t c0 = buf[i];
    int64_t c;
    int incr;
    if (c0 < 0xC0) { c = c0; incr = 1; }
    else if ((c0 & 0xE0) == 0xC0) { c = (c0 << 8) | buf[i + 1]; incr = 2; }
    else if ((c0 & 0xF0) == 0xE0) {
      c = ((int64_t)c0 << 16) | (buf[i + 1] << 8) | buf[i + 2]; incr = 3;
    } else {
      c = ((int64_t)c0 << 24) | ((int64_t)buf[i + 1] << 16) |
          (buf[i + 2] << 8) | buf[i + 3];
      incr = 4;
    }
    i += incr;
    if (tbl[h] == c) predicted += incr;
    tbl[h] = c;
    h = ((h << 4) ^ (int)c) & 0xFFF;
  }
  *hash = h;
  return predicted;
}

bool cheap_squeeze_trigger(const uint8_t* buf, int src_len) {
  const int testsize = kSqueezeTestLen;
  if (src_len < testsize) return false;
  if (count_spaces4(buf, testsize) >= testsize * 25 / 100) return true;
  std::vector<int64_t> tbl(kPredictionTableSize, 0);
  int h = 0;
  return count_predicted(buf, 0, testsize, &h, tbl.data()) >=
         testsize * 67 / 100;
}

// BackscanToSpace / ForwardscanToSpace (compact_lang_det_impl.cc:491-521)
int backscan_to_space(const uint8_t* b, int dst) {
  int limit = dst < 32 ? dst : 32;
  for (int n = 0; n < limit; n++)
    if (b[dst - n - 1] == 0x20) return n;
  for (int n = 0; n < limit; n++)
    if ((b[dst - n] & 0xC0) != 0x80) return n;
  return 0;
}

int forwardscan_to_space(const uint8_t* b, int src, int limit) {
  if (limit > 32) limit = 32;
  for (int n = 0; n < limit; n++)
    if (b[src + n] == 0x20) return n + 1;
  for (int n = 0; n < limit; n++)
    if ((b[src + n] & 0xC0) != 0x80) return n;
  return 0;
}

// CheapSqueezeInplace (compact_lang_det_impl.cc:785-865; squeeze.py
// cheap_squeeze): drop space-heavy / well-predicted 48-byte chunks,
// compacting in place. b must extend >= 4 bytes past src_len; returns the
// new length.
int cheap_squeeze_inplace(uint8_t* b, int src_len) {
  const int chunksize = 48;
  const int space_thresh = chunksize * 25 / 100;
  const int predict_thresh = chunksize * 40 / 100;
  std::vector<int64_t> tbl(kPredictionTableSize, 0);
  int h = 0;
  bool skipping = false;
  int src = 0, dst = 0;
  while (src < src_len) {
    int len = src_len - src < chunksize ? src_len - src : chunksize;
    while ((b[src + len] & 0xC0) == 0x80) len++;  // UTF-8 boundary
    int space_n = count_spaces4(b + src, len);
    int predb_n = count_predicted(b, src, len, &h, tbl.data());
    if (space_n >= space_thresh || predb_n >= predict_thresh) {
      if (!skipping) {
        dst -= backscan_to_space(b, dst);
        if (dst == 0) {
          b[0] = 0x20;
          dst = 1;
        }
        skipping = true;
      }
    } else {
      int take_from = src, take_len = len;
      if (skipping) {
        int n = forwardscan_to_space(b, src, len);
        take_from += n;
        take_len -= n;
        skipping = false;
      }
      if (take_len > 0) {
        std::memmove(b + dst, b + take_from, take_len);
        dst += take_len;
      }
    }
    src += len;
  }
  return dst;
}


// ---- segmentation (preprocess/segment.py segment_text) ----
struct Span {
  std::vector<uint8_t> buf;      // ' ' + lowered letters + "   \0" + pad
  std::vector<uint32_t> cps;     // decoded buf codepoints + trailing space
  std::vector<int32_t> b2o;      // span byte -> ORIGINAL byte (result-
                                 // vector packs only; else empty; the
                                 // segment.py src_idx composed with the
                                 // char->byte cumsum)
  int text_bytes;
  int ulscript;
};

inline int u8len_of(uint32_t cp) {
  return cp < 0x80 ? 1 : cp < 0x800 ? 2 : cp < 0x10000 ? 3 : 4;
}

inline void u8encode(uint32_t cp, std::vector<uint8_t>* out) {
  if (cp < 0x80) out->push_back((uint8_t)cp);
  else if (cp < 0x800) {
    out->push_back(0xC0 | (cp >> 6));
    out->push_back(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out->push_back(0xE0 | (cp >> 12));
    out->push_back(0x80 | ((cp >> 6) & 0x3F));
    out->push_back(0x80 | (cp & 0x3F));
  } else {
    out->push_back(0xF0 | (cp >> 18));
    out->push_back(0x80 | ((cp >> 12) & 0x3F));
    out->push_back(0x80 | ((cp >> 6) & 0x3F));
    out->push_back(0x80 | (cp & 0x3F));
  }
}

// Decode valid UTF-8 (internal span buffers; truncated tails consume the
// lead byte alone rather than reading past `len`).
void u8decode(const uint8_t* s, int len, std::vector<uint32_t>* out) {
  int i = 0;
  while (i < len) {
    uint8_t c = s[i];
    if (c >= 0x80 && i + (c < 0xF0 ? (c < 0xE0 ? 2 : 3) : 4) > len) {
      out->push_back(c);
      i += 1;
    }
    else if (c < 0x80) { out->push_back(c); i += 1; }
    else if (c < 0xE0) {
      out->push_back(((c & 0x1F) << 6) | (s[i + 1] & 0x3F));
      i += 2;
    } else if (c < 0xF0) {
      out->push_back(((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) |
                     (s[i + 2] & 0x3F));
      i += 3;
    } else {
      out->push_back(((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                     ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F));
      i += 4;
    }
  }
}

void build_span(const std::vector<uint32_t>& cur, int ulscript,
                Span* sp, const std::vector<int32_t>* src = nullptr) {
  sp->ulscript = ulscript;
  const size_t n = cur.size();
  sp->cps.resize(n + 2);
  uint32_t* cps = sp->cps.data();
  cps[0] = 0x20;
  if (n) std::memcpy(cps + 1, cur.data(), n * sizeof(uint32_t));
  cps[n + 1] = 0x20;
  size_t nb = 1;  // leading space
  for (size_t i = 0; i < n; i++) nb += u8len_of(cur[i]);
  sp->text_bytes = (int)nb;
  // sized writes through a raw pointer: the per-byte push_back capacity
  // checks were ~14% of single-core pack time
  sp->buf.resize(nb + kTailPad);
  uint8_t* p = sp->buf.data();
  *p++ = 0x20;
  for (size_t i = 0; i < n; i++) {
    uint32_t cp = cur[i];
    if (cp < 0x80) {
      *p++ = (uint8_t)cp;
    } else if (cp < 0x800) {
      *p++ = (uint8_t)(0xC0 | (cp >> 6));
      *p++ = (uint8_t)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      *p++ = (uint8_t)(0xE0 | (cp >> 12));
      *p++ = (uint8_t)(0x80 | ((cp >> 6) & 0x3F));
      *p++ = (uint8_t)(0x80 | (cp & 0x3F));
    } else {
      *p++ = (uint8_t)(0xF0 | (cp >> 18));
      *p++ = (uint8_t)(0x80 | ((cp >> 12) & 0x3F));
      *p++ = (uint8_t)(0x80 | ((cp >> 6) & 0x3F));
      *p++ = (uint8_t)(0x80 | (cp & 0x3F));
    }
  }
  p[0] = p[1] = p[2] = 0x20;
  std::memset(p + 3, 0, kTailPad - 3);
  // span byte -> original byte (segment.py _build_span src_idx: each
  // cp's source repeated over its encoded length, leading space
  // inheriting the first letter's source, one trailing duplicate)
  sp->b2o.clear();
  if (src != nullptr) {
    sp->b2o.reserve(nb + 1);
    int32_t lead = n ? (*src)[0] : 0;
    sp->b2o.push_back(lead);  // leading space (1 byte)
    for (size_t i = 0; i < n; i++) {
      int l = u8len_of(cur[i]);
      for (int k = 0; k < l; k++) sp->b2o.push_back((*src)[i]);
    }
    sp->b2o.push_back(sp->b2o.back());
  }
}

// Reusable per-thread segmentation scratch: all vectors keep their
// capacity across documents, making steady-state packing allocation-free
// (the malloc + first-touch cost was ~25% of single-thread pack time).
struct SegScratch {
  std::vector<uint32_t> lower, cur;
  std::vector<int32_t> cur_src;  // orig byte per cur entry (ranges mode)
  std::vector<uint8_t> script;
  std::vector<int8_t> u8l;
  std::vector<int64_t> byte_before;
  std::vector<Span> spans;  // pool; only [0, n_spans) are live
  int n_spans = 0;

  Span* alloc_span() {
    if (n_spans == (int)spans.size()) spans.emplace_back();
    return &spans[n_spans++];
  }

  // Bound long-lived retention: one pathological multi-MB document must
  // not pin worst-case capacity on a persistent thread forever.
  void maybe_shrink() {
    if (lower.capacity() > (1 << 20) || spans.size() > 512)
      *this = SegScratch();
  }
};

// CheapRepWordsInplace (compact_lang_det_impl.cc:610-692; squeeze.py
// cheap_rep_words): drop words with more than half their bytes predicted.
// hash/tbl persist across the spans of one document.
int cheap_rep_words_inplace(uint8_t* b, int src_len, int* hash,
                            int64_t* tbl) {
  int h = *hash;
  int dst = 0, word_dst = 0, good_predict = 0, word_len = 0, src = 0;
  while (src < src_len) {
    uint8_t c0 = b[src];
    b[dst++] = c0;
    if (c0 == 0x20) {
      if (good_predict * 2 > word_len) dst = word_dst;
      word_dst = dst;
      good_predict = 0;
      word_len = 0;
    }
    int64_t c;
    int incr;
    if (c0 < 0xC0) { c = c0; incr = 1; }
    else if ((c0 & 0xE0) == 0xC0) {
      b[dst++] = b[src + 1];
      c = (c0 << 8) | b[src + 1];
      incr = 2;
    } else if ((c0 & 0xF0) == 0xE0) {
      b[dst++] = b[src + 1];
      b[dst++] = b[src + 2];
      c = ((int64_t)c0 << 16) | (b[src + 1] << 8) | b[src + 2];
      incr = 3;
    } else {
      b[dst++] = b[src + 1];
      b[dst++] = b[src + 2];
      b[dst++] = b[src + 3];
      c = ((int64_t)c0 << 24) | ((int64_t)b[src + 1] << 16) |
          (b[src + 2] << 8) | b[src + 3];
      incr = 4;
    }
    src += incr;
    word_len += incr;
    if (tbl[h] == c) good_predict += incr;
    tbl[h] = c;
    h = ((h << 4) ^ (int)c) & 0xFFF;
  }
  *hash = h;
  return dst;
}

// Rebuild a span around rewritten (shorter) text
void respan(Span* sp, int n) {
  sp->b2o.clear();  // offsets no longer map to the original input
  sp->text_bytes = n;
  sp->buf.resize(n + kTailPad);
  sp->buf[n] = sp->buf[n + 1] = sp->buf[n + 2] = 0x20;
  std::memset(sp->buf.data() + n + 3, 0, kTailPad - 3);
  sp->cps.clear();
  u8decode(sp->buf.data(), n, &sp->cps);
  sp->cps.push_back(0x20);
}

// Rebuild a span around its squeezed text (engine_scalar _respan)
void squeeze_span(Span* sp) {
  respan(sp, cheap_squeeze_inplace(sp->buf.data(), sp->text_bytes));
}

// Returns the number of codepoints decoded (ss->byte_before[0..n] holds
// each one's byte offset, byte_before[n] the end).
int segment_text(const uint8_t* text, int text_len, SegScratch* ss,
                 bool collect_src = false) {
  ss->n_spans = 0;
  if (text_len == 0) return 0;
  // Single fused pass: decode + script/lower classification + byte
  // accounting (the decode increment IS the codepoint's u8 length for
  // the valid UTF-8 a Python str encodes to, so no second u8len pass)
  std::vector<uint8_t>& script = ss->script;
  std::vector<uint32_t>& lower = ss->lower;
  std::vector<int8_t>& u8l = ss->u8l;
  std::vector<int64_t>& byte_before = ss->byte_before;
  script.resize(text_len);
  lower.resize(text_len);
  u8l.resize(text_len);
  byte_before.resize(text_len + 1);
  int n = 0;
  {
    int i = 0;
    while (i < text_len) {
      uint8_t c = text[i];
      uint32_t cp;
      int incr;
      if (c < 0x80) {
        // ASCII run fast path: one-byte classification straight from
        // the low end of the global tables, no decode branches (most
        // service traffic is Latin; this loop was the largest single
        // pack cost after the scanners)
        do {
          script[n] = g.script_of_cp[c];
          lower[n] = g.lower_map[c];
          u8l[n] = 1;
          byte_before[n] = i;
          n++;
          i++;
          if (i >= text_len) break;
          c = text[i];
        } while (c < 0x80);
        continue;
      }
      if (i + (c < 0xF0 ? (c < 0xE0 ? 2 : 3) : 4) > text_len) {
        // truncated multibyte tail OR stray continuation byte at the end
        // (reachable via the C ABI, which takes arbitrary bytes):
        // consume one byte instead of reading past the buffer
        cp = c;
        incr = 1;
      } else if (c < 0xE0) {
        cp = ((c & 0x1F) << 6) | (text[i + 1] & 0x3F);
        incr = 2;
      } else if (c < 0xF0) {
        cp = ((c & 0x0F) << 12) | ((text[i + 1] & 0x3F) << 6) |
             (text[i + 2] & 0x3F);
        incr = 3;
      } else {
        cp = ((c & 0x07) << 18) | ((text[i + 1] & 0x3F) << 12) |
             ((text[i + 2] & 0x3F) << 6) | (text[i + 3] & 0x3F);
        incr = 4;
      }
      uint32_t cpc = cp > 0x10FFFF ? 0x10FFFF : cp;
      script[n] = g.script_of_cp[cpc];
      lower[n] = g.lower_map[cpc];
      u8l[n] = (int8_t)incr;
      byte_before[n] = i;
      n++;
      i += incr;
    }
    byte_before[n] = i;
  }
  if (n == 0) return 0;
  const int64_t total_bytes = byte_before[n];

  int i = 0;
  while (i < n) {
    int64_t remaining = total_bytes - byte_before[i];
    int soft_limit = kSoftSpanPutBytes;
    if (remaining >= kMaxSpanPutBytes && remaining < 2 * kMaxSpanPutBytes)
      soft_limit = (int)(remaining / 2);
    while (i < n && script[i] == 0) i++;
    if (i >= n) break;
    const int spanscript = script[i];
    std::vector<uint32_t>& cur = ss->cur;
    std::vector<int32_t>& cur_src = ss->cur_src;
    cur.clear();
    cur_src.clear();
    int put = 1;

    while (i < n) {
      // letter run
      while (i < n) {
        int sc = script[i];
        if (sc == 0) break;
        if (sc != spanscript && sc != kUlScriptInherited) {
          // one embedded foreign letter allowed when the next char is
          // Common or back in-script (getonescriptspan.cc:900-930)
          int sc2 = i + 1 < n ? script[i + 1] : 0;
          if (sc2 != 0 && sc2 != spanscript) break;
        }
        cur.push_back(lower[i]);
        if (collect_src) cur_src.push_back((int32_t)byte_before[i]);
        put += u8l[i];
        i++;
        if (put >= kMaxSpanPutBytes) break;
      }
      // non-letter run -> single space
      cur.push_back(0x20);
      if (collect_src)
        cur_src.push_back((int32_t)byte_before[i < n ? i : n - 1]);
      put += 1;
      while (i < n && script[i] == 0) i++;
      if (i >= n) break;
      if (script[i] != spanscript && script[i] != kUlScriptInherited) break;
      if (put >= soft_limit) break;
    }
    if (cur.size() > 1)
      build_span(cur, spanscript, ss->alloc_span(),
                 collect_src ? &cur_src : nullptr);
  }
  return n;
}

// ---- per-span candidate records (preprocess/pack.py) ----
struct Rec {
  int32_t offset;
  int8_t kind;
  int8_t prio;     // merge priority at equal offsets
  uint8_t fp_hi;   // octa hash bits 32-39
  int8_t pad_;
  uint32_t fp;     // fingerprint low 32 / seed langprob / uni class
};

inline int8_t prio_of(int8_t kind) {
  switch (kind) {
    case SEED: return -1;
    case DELTA_OCTA: case BI_DELTA: return 0;
    case DISTINCT_OCTA: case BI_DISTINCT: return 1;
    default: return 2;  // QUAD, UNI
  }
}

// Quad + word candidates in linear merge order; false => scalar fallback
bool pack_quad_span(const Span& sp, std::vector<Rec>* recs) {
  const uint8_t* b = sp.buf.data();
  const int64_t buflen = (int64_t)sp.buf.size();
  const int limit = sp.text_bytes;

  // quad positions (grams.py quad_positions: 2-char steps, word-end jump,
  // space/vowel skip; cldutil.cc:338-395)
  std::vector<int32_t> qpos, qlen;
  {
    int64_t src = 1;
    if (b[src] == 0x20) src++;
    while (src < limit) {
      int64_t e = src;
      e += adv.but_space[b[e]];
      e += adv.but_space[b[e]];
      int64_t mid = e;
      e += adv.but_space[b[e]];
      e += adv.but_space[b[e]];
      qpos.push_back((int32_t)src);
      qlen.push_back((int32_t)(e - src));
      src = b[e] == 0x20 ? e : mid;
      if (src < limit) src += adv.space_vowel[b[src]];
      else src = limit;
    }
  }
  if ((int)qpos.size() > kMaxScoringHits) return false;  // multi-round span

  // word records with hash-only repeat filter + pairs (cldutil.cc:459-502)
  {
    int64_t src = 1;
    if (b[src] == 0x20) src++;
    uint64_t cache[2] = {0, 0};
    int nxt = 0;
    int n_delta = 0, n_distinct = 0;
    int64_t srclimit = limit + 1;
    int charcount = 0;
    int64_t prior_word_start = src, word_start = src, word_end = word_start;
    while (src < srclimit) {
      if (b[src] == 0x20) {
        if (word_end > word_start) {
          int64_t wlen = word_end - word_start;
          uint64_t fpw = octa_hash40(b, word_start, wlen, buflen);
          if (fpw != cache[0] && fpw != cache[1]) {
            cache[nxt] = fpw;
            nxt = 1 - nxt;
            uint64_t prior = cache[nxt];
            if (prior != 0 && prior != fpw) {
              uint64_t pfp = pair_hash(prior, fpw);
              recs->push_back({(int32_t)prior_word_start, DISTINCT_OCTA, 0,
                               (uint8_t)(pfp >> 32), 0, (uint32_t)pfp});
              n_distinct++;
            }
            recs->push_back({(int32_t)word_start, DISTINCT_OCTA, 0,
                             (uint8_t)(fpw >> 32), 0, (uint32_t)fpw});
            recs->push_back({(int32_t)word_start, DELTA_OCTA, 0,
                             (uint8_t)(fpw >> 32), 0, (uint32_t)fpw});
            n_delta++;
            n_distinct++;
            if (n_delta >= kMaxScoringHits ||
                n_distinct >= kMaxScoringHits - 1)
              break;
          }
        }
        charcount = 0;
        prior_word_start = word_start;
        word_start = src + 1;
        word_end = word_start;
      } else {
        charcount++;
      }
      src += adv.one[b[src]];
      if (charcount <= 8) word_end = src;
    }
  }

  for (size_t i = 0; i < qpos.size(); i++) {
    uint32_t fp = quad_hash(b, qpos[i], qlen[i]);
    recs->push_back({qpos[i], QUAD, 0, 0, 0, fp});
  }
  return true;
}

bool pack_cjk_span(const Span& sp, std::vector<Rec>* recs) {
  const int n = (int)sp.cps.size();
  std::vector<int64_t> starts(n), ends(n);
  int64_t acc = 0;
  for (int i = 0; i < n; i++) {
    starts[i] = acc;
    acc += u8len_of(sp.cps[i]);
    ends[i] = acc;
  }
  int n_uni = 0;
  for (int i = 0; i < n; i++) {
    uint32_t cp = sp.cps[i] > 0x10FFFF ? 0x10FFFF : sp.cps[i];
    uint8_t prop = g.cjk_prop[cp];
    if (prop > 0 && starts[i] >= 1 && starts[i] < sp.text_bytes) n_uni++;
  }
  if (n_uni > kMaxScoringHits) return false;  // multi-round span
  for (int i = 0; i < n; i++) {
    uint32_t cp = sp.cps[i] > 0x10FFFF ? 0x10FFFF : sp.cps[i];
    uint8_t prop = g.cjk_prop[cp];
    if (prop > 0 && starts[i] >= 1 && starts[i] < sp.text_bytes)
      recs->push_back({(int32_t)ends[i], UNI, 0, 0, 0, prop});
  }
  for (int i = 0; i + 1 < n; i++) {
    int64_t len2 = ends[i + 1] - starts[i];
    if (len2 >= 6 && starts[i] >= 1 && starts[i] < sp.text_bytes) {
      uint32_t fp = bi_hash(sp.buf.data(), starts[i], len2);
      recs->push_back({(int32_t)starts[i], BI_DELTA, 0, 0, 0, fp});
      if (!g.distinctbi_empty)
        recs->push_back({(int32_t)starts[i], BI_DISTINCT, 0, 0, 0, fp});
    }
  }
  return true;
}

// ---- per-document packing (pack.py pack_batch body) ----
struct Out {
  int8_t* kind; int32_t* offset; uint32_t* fp; uint8_t* fp_hi;
  int32_t* chunk_base; int32_t* span_start;
  int32_t* span_end_off; int8_t* side; int8_t* cjk; int16_t* script;
  int16_t* chunk_script; int8_t* chunk_cjk; int8_t* chunk_side;
  int32_t* chunk_span_end;
  int32_t* direct_adds; int32_t* text_bytes; uint8_t* fallback;
  int32_t* n_slots; int32_t* n_chunks;
  int L, C, D, flags;
};

void pack_one_doc(const uint8_t* text, int text_len, int b, const Out& o) {
  static thread_local SegScratch seg;
  seg.maybe_shrink();
  segment_text(text, text_len, &seg);

  const int L = o.L, C = o.C;
  int8_t* kind = o.kind + (int64_t)b * L;
  int32_t* offset = o.offset + (int64_t)b * L;
  uint32_t* fp = o.fp + (int64_t)b * L;
  uint8_t* fp_hi = o.fp_hi + (int64_t)b * L;
  int32_t* chunk_base_a = o.chunk_base + (int64_t)b * L;
  int32_t* span_start_a = o.span_start + (int64_t)b * L;
  int32_t* span_end_a = o.span_end_off + (int64_t)b * L;
  int8_t* side_a = o.side + (int64_t)b * L;
  int8_t* cjk_a = o.cjk + (int64_t)b * L;
  int16_t* script_a = o.script + (int64_t)b * L;
  int16_t* cscript = o.chunk_script + (int64_t)b * C;
  int8_t* ccjk = o.chunk_cjk + (int64_t)b * C;
  int8_t* cside = o.chunk_side + (int64_t)b * C;
  int32_t* cspanend = o.chunk_span_end + (int64_t)b * C;
  int32_t* dadds = o.direct_adds + (int64_t)b * o.D * 3;

  int slot = 0, chunk_base = 0, n_direct = 0;
  int64_t total = 0;
  bool ok = true;
  static thread_local std::vector<Rec> recs;
  for (int _si = 0; _si < seg.n_spans; _si++) {
    const Span& sp = seg.spans[_si];
    total += sp.text_bytes;
    int rt = sp.ulscript < g.n_scripts ? g.rtype[sp.ulscript] : 0;
    if (!(o.flags & 1) && sp.text_bytes > (kSqueezeTestThresh >> 1) &&
        cheap_squeeze_trigger(sp.buf.data(), sp.text_bytes)) {
      ok = false;  // squeeze-trigger doc -> scalar path (FLAG_FINISH skips)
      break;
    }
    if (rt == 0 || rt == 1) {  // RTypeNone/One: direct doc-tote add
      if (n_direct >= o.D || chunk_base >= C) { ok = false; break; }
      dadds[n_direct * 3 + 0] = chunk_base;
      dadds[n_direct * 3 + 1] = g.deflang[sp.ulscript];
      dadds[n_direct * 3 + 2] = sp.text_bytes;
      n_direct++;
      chunk_base++;
      continue;
    }
    if (sp.text_bytes <= 1) continue;
    const bool cjk = rt == 3;
    recs.clear();
    bool fits = cjk ? pack_cjk_span(sp, &recs) : pack_quad_span(sp, &recs);
    if (!fits) { ok = false; break; }
    recs.push_back({1, SEED, 0, 0, 0,
                    sp.ulscript < g.n_scripts ? g.seed_lp[sp.ulscript] : 0});
    for (size_t i = 0; i < recs.size(); i++)
      recs[i].prio = prio_of(recs[i].kind);
    std::stable_sort(recs.begin(), recs.end(),
                     [](const Rec& a, const Rec& c) {
                       if (a.offset != c.offset) return a.offset < c.offset;
                       return a.prio < c.prio;
                     });
    int n_base_max = 0;
    for (const Rec& r : recs)
      n_base_max += (r.kind == SEED || r.kind == QUAD || r.kind == UNI);
    int chunksize = cjk ? 50 : 20;
    int span_chunks = 1 + (n_base_max + chunksize - 1) / chunksize;
    if (span_chunks < 1) span_chunks = 1;
    if (slot + (int)recs.size() > L || chunk_base + span_chunks > C) {
      ok = false;
      break;
    }
    int8_t side = sp.ulscript == kUlScriptLatin ? 0 : 1;
    int start = slot;
    for (const Rec& r : recs) {
      kind[slot] = r.kind;
      offset[slot] = r.offset;
      fp[slot] = r.fp;
      fp_hi[slot] = r.fp_hi;
      chunk_base_a[slot] = chunk_base;
      span_start_a[slot] = start;
      span_end_a[slot] = sp.text_bytes;
      side_a[slot] = side;
      cjk_a[slot] = cjk;
      script_a[slot] = (int16_t)sp.ulscript;
      slot++;
    }
    for (int c = chunk_base; c < chunk_base + span_chunks; c++) {
      cscript[c] = (int16_t)sp.ulscript;
      ccjk[c] = cjk;
      cside[c] = side;
      cspanend[c] = sp.text_bytes;
    }
    chunk_base += span_chunks;
  }
  o.text_bytes[b] = (int32_t)total;
  o.fallback[b] = !ok;
  o.n_slots[b] = slot;
  o.n_chunks[b] = chunk_base;
}

// ---- host-side table resolution (the device program's stages 1-4,
// ops/score.py) ------------------------------------------------------------
//
// The scoring tables are a few MB and host-cache-resident, so the 4-way
// associative probes (QuadHashV3Lookup4 / OctaHashV3Lookup4,
// cldutil_shared.h:403-454), the quad repeat cache (cldutil.cc:334-367),
// chunk assignment (ChunkAll, scoreonescriptspan.cc:978-1031), and the
// rotating distinct-boost lists (AddDistinctBoost2, :112-121) all run here
// during packing. The wire then carries only RESOLVED hits: a u16 index
// into the device's concatenated indirect array + a u8 doc-local chunk id
// (3 bytes/slot vs 8, and misses never cross the host->device link).

struct ResTables {
  const uint32_t* cat_buckets;  // [rows][4] all tables' buckets
  const uint32_t* cat_ind;      // concatenated indirect arrays
  int64_t n_ind;
  // per-kind geometry (DeviceTables.kind_tbl)
  int64_t bucket_off[8];
  uint32_t size[8], keymask[8];
  int32_t ind_off[8], size_one[8];
  uint8_t probes[8];
  // dual quadgram table
  int64_t q2_bucket_off;
  uint32_t q2_size, q2_keymask;
  int32_t q2_ind_off, q2_size_one;
  int q2_enabled;
  int32_t seed_ind_base;  // cat_ind2 index of script 0's seed langprob
};
ResTables rt;
bool rt_ready = false;

inline uint32_t probe4(const uint32_t* row, uint32_t key, uint32_t keymask) {
  for (int s = 0; s < 4; s++)
    if (((row[s] ^ key) & keymask) == 0) return row[s];
  return 0;
}

// Resolve one candidate exactly as the device program did (ops/score.py
// stages 2-3): word A at the indirect address, word B only for QUAD/UNI
// double entries. A zero word A makes the whole candidate inactive for
// every kind except UNI (whose word B scores independently). Returns
// (a_nonzero, b_nonzero, ia); emitted indices are ia / ia + 1.
struct Resolved { bool a, b; int32_t ia; };

inline Resolved resolve_rec(const Rec& r) {
  int kind = r.kind;
  if (kind == UNI) {
    // direct double entry (cjkcompat: size_one == 0)
    int32_t ia = rt.ind_off[UNI] + 2 * (int32_t)r.fp - rt.size_one[UNI];
    return {rt.cat_ind[ia] != 0, rt.cat_ind[ia + 1] != 0, ia};
  }
  uint32_t fp = r.fp, size = rt.size[kind], keymask = rt.keymask[kind];
  uint32_t sub, key;
  if (kind == DELTA_OCTA || kind == DISTINCT_OCTA) {
    uint32_t hi = r.fp_hi;
    sub = (fp + ((fp >> 12) | (hi << 20))) & (size - 1);
    key = ((fp >> 4) | (hi << 28)) & keymask;
  } else {
    sub = (fp + (fp >> 12)) & (size - 1);
    key = fp & keymask;
  }
  uint32_t kv = probe4(rt.cat_buckets + 4 * (rt.bucket_off[kind] + sub),
                       key, keymask);
  int32_t io = rt.ind_off[kind], so = rt.size_one[kind];
  if (kv == 0 && kind == QUAD && rt.q2_enabled) {
    uint32_t sub2 = (fp + (fp >> 12)) & (rt.q2_size - 1);
    kv = probe4(rt.cat_buckets + 4 * (rt.q2_bucket_off + sub2),
                fp & rt.q2_keymask, rt.q2_keymask);
    io = rt.q2_ind_off;
    so = rt.q2_size_one;
    keymask = rt.q2_keymask;
  }
  if (kv == 0) return {false, false, 0};
  int32_t ind_raw = (int32_t)(kv & ~keymask);
  if (ind_raw < so) {
    int32_t ia = io + ind_raw;
    return {rt.cat_ind[ia] != 0, false, ia};
  }
  int32_t ia = io + 2 * ind_raw - so;
  // word B scores only for QUAD/UNI doubles (device lp_b gating)
  bool b = kind == QUAD && rt.cat_ind[ia + 1] != 0;
  return {rt.cat_ind[ia] != 0, b, ia};
}

// ---- per-round scanners (hitbuffer fills of <= 1000 base hits,
// scoreonescriptspan.cc:1163-1277; Python spec preprocess/grams.py) ------

// One quadgram round from `start`: pushes RESOLVED quad hits (Rec.pad_=1,
// fp=indirect address, fp_hi=word-B flag) and returns next_offset (the
// next candidate position when the fill hits kMaxScoringHits, else the
// scan end). Repeat cache is round-local (GetQuadHits, cldutil.cc:334).
// *n_quota / *n_emit accumulate resolved hits and emitted slots (a + b).
//
// Two-phase per 512-quad block: phase A is pure byte work (positions +
// hashes) and issues a software prefetch for each hash's probe row;
// phase B runs the repeat cache + 4-way probes over lines that are
// already inbound. The probes' random access into the multi-MB bucket
// array was the single largest pack cost (~200 cycles/miss).
int64_t scan_quad_round(const Span& sp, int64_t start,
                        std::vector<Rec>* recs, int* n_quota,
                        int* n_emit) {
  const uint8_t* b = sp.buf.data();
  const int limit = sp.text_bytes;
  int64_t src = start;
  if (b[src] == 0x20) src++;
  uint32_t cache[2] = {0, 0};
  int nxt = 0, hits = 0, emitted = 0;
  static thread_local std::vector<int32_t> qpos, qnext;
  static thread_local std::vector<uint32_t> qfp;
  constexpr int kBlock = 512;  // prefetched lines stay L1/L2-resident
  const uint32_t qmask = rt.size[QUAD] - 1;
  const uint32_t* qbase = rt.cat_buckets + 4 * rt.bucket_off[QUAD];
  while (src < limit) {
    qpos.clear();
    qfp.clear();
    qnext.clear();
    while (src < limit && (int)qpos.size() < kBlock) {
      int64_t e = src;
      e += adv.but_space[b[e]];
      e += adv.but_space[b[e]];
      int64_t mid = e;
      e += adv.but_space[b[e]];
      e += adv.but_space[b[e]];
      uint32_t fp = quad_hash(b, src, e - src);
      qpos.push_back((int32_t)src);
      qfp.push_back(fp);
      __builtin_prefetch(qbase + 4 * ((fp + (fp >> 12)) & qmask));
      src = b[e] == 0x20 ? e : mid;
      if (src < limit) src += adv.space_vowel[b[src]];
      else src = limit;
      qnext.push_back((int32_t)src);
    }
    const size_t nq = qpos.size();
    for (size_t i = 0; i < nq; i++) {
      uint32_t fp = qfp[i];
      if (fp != cache[0] && fp != cache[1]) {
        Rec raw{qpos[i], QUAD, 0, 0, 0, fp};
        Resolved rs = resolve_rec(raw);
        if (rs.a) {
          cache[nxt] = fp;
          nxt = 1 - nxt;
          recs->push_back({qpos[i], QUAD, 0, (uint8_t)(rs.b ? 1 : 0), 1,
                           (uint32_t)rs.ia});
          emitted += 1 + (rs.b ? 1 : 0);
          if (++hits >= kMaxScoringHits) {
            *n_quota += hits;
            *n_emit += emitted;
            return qnext[i];
          }
        }
      }
    }
  }
  *n_quota += hits;
  *n_emit += emitted;
  return src;
}

// Word (octa) hits over [start, end): RESOLVED delta + distinct + pair
// records (Rec.pad_=1), caches and HIT caps round-local (GetOctaHits,
// cldutil.cc:416-533; Python spec grams.py get_octa_hits). *n_emit
// accumulates pushed records (1 emitted slot each).
//
// Two-phase per 512-word block like scan_quad_round: the repeat cache
// here advances independently of table resolution, so phase A applies
// it while hashing + prefetching the three probe rows each word needs
// (pair / delta / distinct), and phase B probes warm lines. DELTA is
// pushed before DISTINCT at each offset: emission order IS the final
// merge order (offset, then kind priority) — there is no sort.
void scan_word_range(const Span& sp, int64_t start, int64_t end,
                     std::vector<Rec>* recs, int* n_emit) {
  const uint8_t* b = sp.buf.data();
  const int64_t buflen = (int64_t)sp.buf.size();
  int64_t src = start;
  if (b[src] == 0x20) src++;
  uint64_t cache[2] = {0, 0};
  int nxt = 0;
  int n_delta = 0, n_distinct = 0;
  int64_t srclimit = end + 1;  // include trailing space off the end
  int charcount = 0;
  int64_t prior_word_start = src, word_start = src, word_end = word_start;
  struct WordEnt {
    int32_t prior_start, start;
    uint64_t fpw, pfp;  // pfp == 0: no pair record
  };
  static thread_local std::vector<WordEnt> ents;
  constexpr int kBlock = 512;
  const uint32_t dmask = rt.size[DELTA_OCTA] - 1;
  const uint32_t xmask = rt.size[DISTINCT_OCTA] - 1;
  const uint32_t* dbase = rt.cat_buckets + 4 * rt.bucket_off[DELTA_OCTA];
  const uint32_t* xbase =
      rt.cat_buckets + 4 * rt.bucket_off[DISTINCT_OCTA];
  auto octa_sub = [](uint64_t fp64, uint32_t mask) {
    uint32_t lo = (uint32_t)fp64, hi = (uint32_t)(fp64 >> 32) & 0xFF;
    return (lo + ((lo >> 12) | (hi << 20))) & mask;
  };
  bool capped = false;
  while (src < srclimit && !capped) {
    ents.clear();
    while (src < srclimit && (int)ents.size() < kBlock) {
      if (b[src] == 0x20) {
        if (word_end > word_start) {
          uint64_t fpw = octa_hash40(b, word_start, word_end - word_start,
                                     buflen);
          if (fpw != cache[0] && fpw != cache[1]) {
            cache[nxt] = fpw;
            nxt = 1 - nxt;
            uint64_t prior = cache[nxt];
            uint64_t pfp =
                prior != 0 && prior != fpw ? pair_hash(prior, fpw) : 0;
            if (pfp) __builtin_prefetch(xbase + 4 * octa_sub(pfp, xmask));
            __builtin_prefetch(dbase + 4 * octa_sub(fpw, dmask));
            __builtin_prefetch(xbase + 4 * octa_sub(fpw, xmask));
            ents.push_back({(int32_t)prior_word_start, (int32_t)word_start,
                            fpw, pfp});
          }
        }
        charcount = 0;
        prior_word_start = word_start;
        word_start = src + 1;
        word_end = word_start;
      } else {
        charcount++;
      }
      src += adv.one[b[src]];
      if (charcount <= 8) word_end = src;
    }
    for (const WordEnt& w : ents) {
      if (w.pfp) {
        Rec raw{w.prior_start, DISTINCT_OCTA, 0, (uint8_t)(w.pfp >> 32),
                0, (uint32_t)w.pfp};
        Resolved rs = resolve_rec(raw);
        if (rs.a) {
          recs->push_back({w.prior_start, DISTINCT_OCTA, 0, 0, 1,
                           (uint32_t)rs.ia});
          n_distinct++;
          (*n_emit)++;
        }
      }
      Rec rawd{w.start, DELTA_OCTA, 0, (uint8_t)(w.fpw >> 32), 0,
               (uint32_t)w.fpw};
      Resolved rd = resolve_rec(rawd);
      if (rd.a) {
        recs->push_back({w.start, DELTA_OCTA, 0, 0, 1, (uint32_t)rd.ia});
        n_delta++;
        (*n_emit)++;
      }
      Rec rawx{w.start, DISTINCT_OCTA, 0, (uint8_t)(w.fpw >> 32), 0,
               (uint32_t)w.fpw};
      Resolved rx = resolve_rec(rawx);
      if (rx.a) {
        recs->push_back({w.start, DISTINCT_OCTA, 0, 0, 1,
                         (uint32_t)rx.ia});
        n_distinct++;
        (*n_emit)++;
      }
      if (n_delta >= kMaxScoringHits || n_distinct >= kMaxScoringHits - 1) {
        capped = true;
        break;
      }
    }
  }
}

// Per-span CJK codepoint geometry, computed once and reused across
// rounds (with a resume index so multi-round spans stay O(n) total).
struct CjkGeom {
  std::vector<int64_t> starts, ends;
  int resume = 0;  // first codepoint index not yet consumed by a round

  void init(const Span& sp) {
    const int n = (int)sp.cps.size();
    starts.resize(n);
    ends.resize(n);
    int64_t acc = 0;
    for (int i = 0; i < n; i++) {
      starts[i] = acc;
      acc += u8len_of(sp.cps[i]);
      ends[i] = acc;
    }
    resume = 0;
  }
};

// One CJK round from `start`: unigram candidates (cap 1000 ->
// next_offset just past the capping char, cldutil.cc:233) into *recs,
// bigram candidates over the round range into *birecs (kept separate so
// the caller's offset merge can order them without sorting). Unigrams
// are pushed RESOLVED (fp=indirect address; fp_hi bit1=word A valid,
// bit0=word B valid — a B-only unigram still consumes an entry rank);
// *n_quota / *n_emit accumulate resolved hits and emitted slots.
int64_t scan_cjk_round(const Span& sp, int64_t start, CjkGeom* gm,
                       std::vector<Rec>* recs, std::vector<Rec>* birecs,
                       int* n_quota, int* n_emit) {
  const int n = (int)sp.cps.size();
  const std::vector<int64_t>& starts = gm->starts;
  const std::vector<int64_t>& ends = gm->ends;
  int64_t next_offset = sp.text_bytes;
  int hits = 0;
  int round_first = gm->resume;
  for (int i = round_first; i < n; i++) {
    uint32_t cp = sp.cps[i] > 0x10FFFF ? 0x10FFFF : sp.cps[i];
    uint8_t prop = g.cjk_prop[cp];
    if (prop > 0 && starts[i] >= start && starts[i] < sp.text_bytes) {
      Resolved rs = resolve_rec({(int32_t)ends[i], UNI, 0, 0, 0, prop});
      if (rs.a || rs.b) {
        recs->push_back({(int32_t)ends[i], UNI, 0,
                         (uint8_t)((rs.a ? 2 : 0) | (rs.b ? 1 : 0)), 1,
                         (uint32_t)rs.ia});
        if (rs.a) {
          (*n_quota)++;
          *n_emit += 1 + (rs.b ? 1 : 0);
        }
      }
      if (++hits >= kMaxScoringHits) {
        next_offset = ends[i];
        gm->resume = i + 1;
        break;
      }
    }
  }
  if (hits < kMaxScoringHits) gm->resume = n;
  int nd = 0, nx = 0;
  for (int i = round_first; i + 1 < n; i++) {
    int64_t len2 = ends[i + 1] - starts[i];
    if (starts[i] >= next_offset) break;
    if (len2 >= 6 && starts[i] >= start) {
      uint32_t fp = bi_hash(sp.buf.data(), starts[i], len2);
      if (nd < kMaxScoringHits) {
        Resolved rs = resolve_rec(
            {(int32_t)starts[i], BI_DELTA, 0, 0, 0, fp});
        if (rs.a) {
          birecs->push_back({(int32_t)starts[i], BI_DELTA, 0, 0, 1,
                             (uint32_t)rs.ia});
          nd++;
          (*n_emit)++;
        }
      }
      if (!g.distinctbi_empty && nx < kMaxScoringHits - 1) {
        Resolved rs = resolve_rec(
            {(int32_t)starts[i], BI_DISTINCT, 0, 0, 0, fp});
        if (rs.a) {
          birecs->push_back({(int32_t)starts[i], BI_DISTINCT, 0, 0, 1,
                             (uint32_t)rs.ia});
          nx++;
          (*n_emit)++;
        }
      }
    }
  }
  return next_offset;
}

// Closed-form ChunkAll boundary rule (ops/score.py _chunk_of_rank;
// scoreonescriptspan.cc:994-1003)
inline int chunk_of_rank(int r, int n_quota, int c) {
  int k_full = n_quota < 2 * c ? 0 : (n_quota - 2 * c) / c + 1;
  int tail = n_quota - k_full * c;
  if (r < k_full * c) return r / c;
  int tr = r - k_full * c;
  bool tail_single = tail < c + (c >> 1);
  int half = (tail + 1) >> 1;
  return k_full + (tail_single ? 0 : (tr >= half ? 1 : 0));
}

// Hint-boost slots (hints engine priors riding the wire): idx values at
// or above kHintBase address the per-batch hint_lp window instead of the
// scoring tables (cat_ind2 ends ~38.8K; seeds sit just above it).
constexpr int kHintBase = 40960;

// Resolved-wire per-doc output views
struct ROut {
  uint16_t* idx;      // [B, L] cat_ind2 indices
  uint16_t* chk;      // [B, L] doc-local chunk ids
  uint32_t* cmeta;    // [B, C] cbytes(16) | grams(12) | side<<28 | real<<29
  uint8_t* cscript;   // [B, C]
  int32_t* direct_adds;
  int32_t* text_bytes;
  uint8_t* fallback;
  uint8_t* squeezed;  // [B] doc took the squeeze re-scan
  int32_t* n_slots;
  int32_t* n_chunks;
  int L, C, D, flags;
  // per-doc hint boosts: window indices into the batch hint_lp table,
  // [2 sides][4 slots], -1 = empty; nullptr = no hints (the common case)
  const int32_t* hint_boost = nullptr;
  // result-vector sidecars (all null unless the caller asked for chunk
  // ranges; never read by the device — they feed the host-side
  // ResultChunkVector builder):
  int32_t* slot_soff = nullptr;  // [L] span-coord offset per slot
                                 //     (-1: boost/hint slot, no offset)
  int32_t* slot_orig = nullptr;  // [L] original-byte offset (-1 boosts)
  int32_t* c_orig_lo = nullptr;  // [C] chunk range in original bytes
  int32_t* c_orig_hi = nullptr;  // [C]
  int32_t* c_rid = nullptr;      // [C] hit round id (-1 direct-add)
  uint8_t* c_isdir = nullptr;    // [C] direct-add (JustOneItem) chunk
};

void pack_resolve_one_doc(const uint8_t* text, int text_len, int b,
                          const ROut& o) {
  // NOTE: worker threads are spawned per batch, so thread_local scratch
  // amortizes over one batch's ~n_docs/n_threads documents (hundreds at
  // service batch sizes), and persists fully on the single-threaded
  // calling-thread path.
  static thread_local SegScratch seg;
  seg.maybe_shrink();
  segment_text(text, text_len, &seg, o.slot_soff != nullptr);

  const int L = o.L, C = o.C;
  uint16_t* idx = o.idx + (int64_t)b * L;
  uint16_t* chk = o.chk + (int64_t)b * L;
  uint32_t* cmeta = o.cmeta + (int64_t)b * C;
  uint8_t* cscript = o.cscript + (int64_t)b * C;
  int32_t* dadds = o.direct_adds + (int64_t)b * o.D * 3;

  // per-chunk accumulators (sized to the per-doc chunk budget; resize
  // to an already-seen size is O(1), and entries zero lazily at
  // allocation — see zero_chunks)
  static thread_local std::vector<int32_t> c_grams, c_lo, c_span_end;
  static thread_local std::vector<int32_t> c_span;  // i32: tier-2 round
                                                    // counts pass 32767
  static thread_local std::vector<int8_t> c_side, c_real, c_dir;
  static thread_local std::vector<int32_t> c_spanix;
  c_grams.resize(C); c_lo.resize(C); c_span_end.resize(C);
  c_span.resize(C); c_side.resize(C); c_real.resize(C);
  const bool want_ranges = o.slot_soff != nullptr;
  if (want_ranges) { c_dir.resize(C); c_spanix.resize(C); }
  int32_t boosts[2][4];
  int bptr[2];
  int slot, chunk_base, n_direct, round_no, open_chunk;
  int64_t total;
  bool ok;
  // scanner outputs, each offset-ordered by construction: brecs = base
  // kinds (QUAD / CJK UNI), wrecs = word kinds (OCTA deltas/distincts/
  // pairs, CJK BI) which outrank base kinds at equal offsets
  static thread_local std::vector<Rec> brecs, wrecs;
  // Repetitive documents restart the whole doc with span squeezing, like
  // the reference's recursive kCLDFlagSqueeze call (impl.cc:1867-1901) —
  // previously such docs fell back to the (much slower) scalar engine.
  // FLAG_SQUEEZE (2) forces it batch-wide; FLAG_REPEATS (4) strips
  // well-predicted words (the gate-failure recursion pass).
  bool squeeze = (o.flags & 2) != 0;
  static thread_local std::vector<int64_t> rep_tbl;
  int rep_hash;

  // Chunk accumulators zero lazily at allocation (zero_chunks below):
  // upfront O(C) init would dominate packing when the per-doc budget is
  // generous (the flat path's C_doc is 16K+ while real docs use ~4).
  auto zero_chunks = [&](int lo, int hi) {
    for (int c = lo; c < hi; c++) {
      c_grams[c] = 0;
      c_lo[c] = 1 << 30; c_span_end[c] = 0;
      c_side[c] = 0; c_real[c] = 0; c_span[c] = -1;
      if (want_ranges) { c_dir[c] = 0; c_spanix[c] = 0; }
    }
  };

restart:
  rep_hash = 0;
  if (o.flags & 4) rep_tbl.assign(kPredictionTableSize, 0);
  // per-doc rotating distinct-boost lists (idx into cat_ind; 0 = empty)
  std::memset(boosts, 0, sizeof(boosts));
  bptr[0] = bptr[1] = 0;
  // round_no uniquely ids each (span, hitbuffer-round): chunk byte
  // ranges chain only within one round (scalar _score_round's end_off)
  slot = 0; chunk_base = 0; n_direct = 0; round_no = 0;
  open_chunk = -1;  // chunk awaiting its boost flush
  total = 0;
  ok = true;

  // emit the pending chunk's boost adds (list state at its last slot):
  // hint priors first, then the rotating distinct boosts (ScoreBoosts
  // order, scoreonescriptspan.cc:125-152 — tote adds commute, whacks
  // apply as a separate device mask)
  auto flush_boosts = [&](int c) {
    if (c < 0 || !c_real[c]) return;
    int side = c_side[c];
    if (o.hint_boost != nullptr) {
      for (int s = 0; s < 4; s++) {
        int w = o.hint_boost[side * 4 + s];
        if (w >= 0 && slot < L) {
          idx[slot] = (uint16_t)(kHintBase + w);
          chk[slot] = (uint16_t)c;
          if (want_ranges) {
            o.slot_soff[slot] = -1;
            o.slot_orig[slot] = -1;
          }
          slot++;
        }
      }
    }
    for (int s = 0; s < 4; s++) {
      if (boosts[side][s] && slot < L) {
        idx[slot] = (uint16_t)boosts[side][s];
        chk[slot] = (uint16_t)c;
        if (want_ranges) {
          o.slot_soff[slot] = -1;
          o.slot_orig[slot] = -1;
        }
        slot++;
      }
    }
  };

  for (int _si = 0; _si < seg.n_spans; _si++) {
    Span& sp = seg.spans[_si];
    if (squeeze) {
      // Remove repetitive or mostly-space chunks (impl.cc:1852-1864)
      squeeze_span(&sp);
    } else if (!(o.flags & 1) &&
               sp.text_bytes > (kSqueezeTestThresh >> 1) &&
               cheap_squeeze_trigger(sp.buf.data(), sp.text_bytes)) {
      // re-scan the whole document with squeezing on
      squeeze = true;
      segment_text(text, text_len, &seg, want_ranges);
      goto restart;
    }
    if (o.flags & 4) {
      // Remove repeated words (impl.cc:1905-1918)
      respan(&sp, cheap_rep_words_inplace(sp.buf.data(), sp.text_bytes,
                                          &rep_hash, rep_tbl.data()));
    }
    total += sp.text_bytes;
    int rtv = sp.ulscript < g.n_scripts ? g.rtype[sp.ulscript] : 0;
    if (rtv == 0 || rtv == 1) {  // RTypeNone/One: direct doc-tote add
      if (n_direct >= o.D || chunk_base >= C) { ok = false; break; }
      dadds[n_direct * 3 + 0] = chunk_base;
      dadds[n_direct * 3 + 1] = g.deflang[sp.ulscript];
      dadds[n_direct * 3 + 2] = sp.text_bytes;
      n_direct++;
      zero_chunks(chunk_base, chunk_base + 1);
      if (want_ranges) {
        // JustOneItem record range: [1, text_bytes) in span coords
        // (scoreonescriptspan.cc:513-548)
        c_dir[chunk_base] = 1;
        c_spanix[chunk_base] = _si;
        c_lo[chunk_base] = 1;
        c_span_end[chunk_base] = sp.text_bytes;
      }
      chunk_base++;
      continue;
    }
    if (sp.text_bytes <= 1) continue;
    const bool cjk = rtv == 3;
    const int chunksize = cjk ? 50 : 20;
    const int side = sp.ulscript == kUlScriptLatin ? 0 : 1;
    const uint32_t seed_lp =
        sp.ulscript < g.n_scripts ? g.seed_lp[sp.ulscript] : 0;

    // hitbuffer rounds of <= 1000 base hits, each with its own seed,
    // repeat caches, and chunk grid (score_span_hits / the reference's
    // fill loops, scoreonescriptspan.cc:1163-1277)
    static thread_local CjkGeom geom;
    if (cjk) geom.init(sp);
    int64_t lo_pos = 1;
    while (lo_pos < sp.text_bytes && ok) {
      brecs.clear();
      wrecs.clear();
      int quota = 0, emit = 0;
      int64_t round_end =
          cjk ? scan_cjk_round(sp, lo_pos, &geom, &brecs, &wrecs,
                               &quota, &emit)
              : scan_quad_round(sp, lo_pos, &brecs, &quota, &emit);
      if (!cjk) scan_word_range(sp, lo_pos, round_end, &wrecs, &emit);
      const bool seed_valid = seed_lp != 0;
      emit += seed_valid;

      // round chunk count from quota (chunk_boundaries grid)
      int round_chunks = quota <= 0 ? 1
          : chunk_of_rank(quota - 1, quota, chunksize) + 1;
      // budget: emitted hits + per-chunk boost flush (4 rotating + up
      // to 4 hint priors when the doc carries hints)
      int per_chunk = o.hint_boost != nullptr ? 8 : 4;
      if (slot + emit + per_chunk * round_chunks > L ||
          chunk_base + round_chunks > C) {
        ok = false;
        break;
      }
      zero_chunks(chunk_base, chunk_base + round_chunks);

      // ---- single merged emission pass: seed first, then the offset
      // merge of the two scanner lists (each offset-ordered by
      // construction; word kinds precede base kinds at equal offsets —
      // the canonical order the per-round stable_sort used to produce).
      // Chunk assignment with device-exact accounting (ops/score.py
      // stages 4-8): entry RANKS consume a+b for base kinds regardless
      // of word-A validity; scores, grams, lo_off, and chunk realness
      // require word A (slot_valid).
      int cum_entries = 0;  // consumed base entries, exclusive
      size_t mb = 0, mw = 0;
      bool on_seed = true;
      while (on_seed || mb < brecs.size() || mw < wrecs.size()) {
        int32_t r_offset, r_ia;
        int8_t r_a, r_b, r_kind;
        if (on_seed) {
          on_seed = false;
          r_offset = (int32_t)lo_pos;
          r_kind = SEED;
          r_a = seed_valid;
          r_b = 0;
          r_ia = rt.seed_ind_base + sp.ulscript;
        } else {
          bool take_w =
              mw < wrecs.size() &&
              (mb >= brecs.size() ||
               wrecs[mw].offset <= brecs[mb].offset);
          const Rec& r = take_w ? wrecs[mw++] : brecs[mb++];
          r_offset = r.offset;
          r_ia = (int32_t)r.fp;
          r_kind = r.kind;
          if (r.kind == UNI) {  // a/b validity in fp_hi (scan_cjk_round)
            r_a = (r.fp_hi >> 1) & 1;
            r_b = r.fp_hi & 1;
          } else {
            r_a = 1;
            r_b = r.kind == QUAD ? (int8_t)(r.fp_hi & 1) : 0;
          }
        }
        bool base_kind = r_kind == SEED || r_kind == QUAD ||
                         r_kind == UNI;
        int contrib = base_kind ? r_a + r_b : 0;
        if (!r_a) {
          cum_entries += contrib;  // UNI word-B rank quirk
          continue;
        }
        int r_excl = cum_entries;
        int rank = quota > 0 ? std::min(r_excl, quota - 1) : 0;
        int local = quota > 0 ? chunk_of_rank(rank, quota, chunksize) : 0;
        int c = chunk_base + local;
        if (c != open_chunk) {
          flush_boosts(open_chunk);
          open_chunk = c;
        }
        idx[slot] = (uint16_t)r_ia;
        chk[slot] = (uint16_t)c;
        if (want_ranges) {
          int32_t orig = -1;
          if (!sp.b2o.empty()) {
            size_t k = r_offset < 0 ? 0 : (size_t)r_offset;
            if (k >= sp.b2o.size()) k = sp.b2o.size() - 1;
            orig = sp.b2o[k];
          }
          o.slot_soff[slot] = r_offset;
          o.slot_orig[slot] = orig;
          if (r_b) {
            o.slot_soff[slot + 1] = r_offset;
            o.slot_orig[slot + 1] = orig;
          }
        }
        slot++;
        if (r_b) {
          idx[slot] = (uint16_t)(r_ia + 1);
          chk[slot] = (uint16_t)c;
          slot++;
        }
        cum_entries += contrib;
        if (base_kind) c_grams[c] += r_a + r_b;
        if (r_offset < c_lo[c]) c_lo[c] = r_offset;
        c_real[c] = 1;
        c_side[c] = (int8_t)side;
        c_span[c] = round_no;
        c_span_end[c] = (int32_t)round_end;
        cscript[c] = (uint8_t)sp.ulscript;
        if (want_ranges) c_spanix[c] = _si;
        // rotating distinct boost (device scan: update AFTER scoring the
        // slot, state read by the chunk containing the slot)
        if (r_kind == DISTINCT_OCTA || r_kind == BI_DISTINCT) {
          boosts[side][bptr[side]] = r_ia;
          bptr[side] = (bptr[side] + 1) & 3;
        }
      }
      // mark allocated-but-empty chunks of this round (runt grids)
      for (int c = chunk_base; c < chunk_base + round_chunks; c++) {
        if (c_span[c] < 0) {
          c_span[c] = round_no;
          c_span_end[c] = (int32_t)round_end;
          c_side[c] = (int8_t)side;
          cscript[c] = (uint8_t)sp.ulscript;
          if (want_ranges) c_spanix[c] = _si;
        }
      }
      chunk_base += round_chunks;
      round_no++;
      if (round_end <= lo_pos) break;  // no forward progress possible
      lo_pos = round_end;
    }
    if (!ok) break;  // fallback doc: skip remaining spans
  }
  flush_boosts(open_chunk);

  // ---- chunk byte ranges: hi = next real chunk's lo (same span) else
  // span_end (device stages 8) ----
  for (int c = 0; c < chunk_base && c < C; c++) {
    if (!c_real[c]) {
      cmeta[c] = 0;
      continue;
    }
    int hi = c_span_end[c];
    if (c + 1 < chunk_base && c_real[c + 1] && c_span[c + 1] == c_span[c])
      hi = c_lo[c + 1];
    int cbytes = hi > c_lo[c] ? hi - c_lo[c] : 0;
    if (cbytes > 0xFFFF) cbytes = 0xFFFF;
    int grams = c_grams[c] > 0xFFF ? 0xFFF : c_grams[c];
    cmeta[c] = (uint32_t)cbytes | ((uint32_t)grams << 16) |
               ((uint32_t)(c_side[c] & 1) << 28) | (1u << 29);
  }
  // result-vector sidecar: per-chunk ranges mapped to ORIGINAL bytes
  // (spans hold their byte->orig maps until the next segment_text)
  if (want_ranges && o.c_orig_lo != nullptr) {
    for (int c = 0; c < chunk_base && c < C; c++) {
      const Span& sps = seg.spans[c_spanix[c]];
      auto mp = [&](int off) -> int32_t {
        if (sps.b2o.empty()) return -1;  // squeezed/respun: unmappable
        size_t k = off < 0 ? 0 : (size_t)off;
        if (k >= sps.b2o.size()) k = sps.b2o.size() - 1;
        return sps.b2o[k];
      };
      int lo, hi;
      if (c_dir[c]) {
        lo = c_lo[c];
        hi = c_span_end[c];
      } else if (c_real[c]) {
        lo = c_lo[c];
        hi = c_span_end[c];
        if (c + 1 < chunk_base && c_real[c + 1] &&
            c_span[c + 1] == c_span[c])
          hi = c_lo[c + 1];
      } else {
        lo = hi = c_span_end[c];  // runt: zero-length at the round end
      }
      o.c_orig_lo[c] = mp(lo);
      o.c_orig_hi[c] = mp(hi);
      o.c_rid[c] = c_dir[c] ? -1 : c_span[c];
      o.c_isdir[c] = c_dir[c];
    }
  }

  // Tails are NOT cleared: every consumer respects the n_slots/n_chunks
  // bounds (the flat compaction copies exactly [0, n_chunks) rows).
  // direct_adds pads with -1 sentinels (the epilogue's stop condition).
  for (int d = n_direct; d < o.D; d++) dadds[d * 3 + 0] = -1;
  o.text_bytes[b] = (int32_t)total;
  o.fallback[b] = !ok;
  o.squeezed[b] = squeeze ? 1 : 0;
  o.n_slots[b] = slot;
  o.n_chunks[b] = chunk_base;
}

// ---- chunk-major ragged pack (the flat wire) ------------------------------
//
// The doc-major dense wire ([B, L] slots + [B, C] chunks) couples device
// program shape to the LONGEST document in a batch: one 60KB doc forces
// L=32768/C=2048 buckets whose [B, C, L] one-hot chunk matmul is quadratic
// in doc length, capping batches at 16 docs. Chunks, however, are
// independent once the packer assigns them (the reference's chunk totes
// are order-free sums, scoreonescriptspan.cc:978-1031; doc aggregation
// :305-315) and the packer emits slots with monotone chunk ids — so the
// flat wire drops the doc axis entirely: all docs' slots concatenate into
// one [N] lane, chunks become rows of a [G, K] grid (K = fattest chunk in
// the batch, <= kMaxChunkSlots), and a long document simply contributes
// more chunk rows. Device cost is linear in total text; batches freely
// mix 100-byte tweets with 100KB documents in ONE dispatch.
//
// Two-phase because the wire is sized by content (total slots/chunks and
// the K bucket are known only after packing): begin() packs every doc via
// pack_resolve_one_doc into thread-local dense scratch and compacts into
// per-thread growing buffers; the caller then sizes/allocates the wire
// and finish() lays it out shard-major and frees the state.

// A chunk holds <= ~20 quads / ~50 CJK unigrams (a+b pairs), trailing
// runt merges (x1.5), interleaved word hits, and a 4-slot boost flush;
// 255 covers every real text with margin (and lets per-chunk slot
// counts ride the wire as u8). Fatter chunks (adversarial
// constructions) route the doc to the scalar fallback.
constexpr int kMaxChunkSlots = 255;

struct FlatThreadBuf {
  std::vector<uint16_t> idx;     // resolved slots, concat over this
                                 // thread's docs
  std::vector<uint16_t> cnsl;    // per-chunk slot count
  std::vector<uint32_t> cmeta;   // per-chunk meta (ROut layout)
  std::vector<uint8_t> cscript;  // per-chunk ULScript
  // result-vector sidecars (filled only in want_ranges packs)
  std::vector<int32_t> soff, sorig;          // per slot
  std::vector<int32_t> clo, chi, crid;       // per chunk
  std::vector<uint8_t> cdir;                 // per chunk
};

struct FlatPackState {
  int B = 0;
  std::vector<FlatThreadBuf> bufs;
  std::vector<int32_t> doc_buf;        // thread-buffer index per doc
  std::vector<int64_t> doc_slot_off;   // doc's slot offset in its buffer
  std::vector<int64_t> doc_chunk_off;  // doc's chunk offset in its buffer
};

// ---- C ABI detection (wrapper.h:8 seam) -----------------------------------
//
// A cgo/Go host links this library and calls detect_language() /
// ldt_detect_batch_codes() with no Python in the loop: the chunk scorer
// below is a bit-exact C twin of the device program (ops/score.py
// score_chunks_impl — same integer decode/tote/top-2/reliability math),
// and the document epilogue is the existing ldt_epilogue_flat. Tables
// arrive via ldt_init_tables + ldt_init_detect (today driven by the
// Python runtime; the mmap artifact loader can drive them C-only).

struct DetectCtx {
  const uint8_t* lg_prob3 = nullptr;        // [256, 3] (padded from 240)
  const int32_t* plang_to_lang = nullptr;   // [2, 256]
  const int32_t* expected_score = nullptr;  // [n_lang, 4]
  const int32_t* close_set = nullptr;       // [n_lang]
  const int32_t* closest_alt = nullptr;     // [n_lang]
  const uint8_t* is_figs = nullptr;         // [n_lang]
  const char* codes = nullptr;              // [n_lang, code_stride]
  int32_t n_lang = 0;
  int32_t code_stride = 0;
  bool ready = false;
};
DetectCtx dctx;

inline int lscript4_of(int script) {
  return script == 1 ? 0 : script == 3 ? 1 : script == 6 ? 2 : 3;
}

// cldutil.cc:553-570 (ops/score.py _reliability_delta)
inline int c_rel_delta(int s1, int s2, int grams) {
  int maxp = grams < 8 ? 12 * grams : 100;
  int thresh = (grams * 5) >> 3;
  thresh = thresh < 3 ? 3 : thresh > 16 ? 16 : thresh;
  int delta = s1 - s2;
  if (delta >= thresh) return maxp;
  if (delta <= 0) return 0;
  int pct = (100 * delta) / thresh;
  return pct < maxp ? pct : maxp;
}

// cldutil.cc:587-605 (ops/score.py _reliability_expected; f32 math)
inline int c_rel_expected(int actual, int expected) {
  if (actual == 0) return expected == 0 ? 100 : 0;
  float hi = (float)(actual > expected ? actual : expected);
  float lo = (float)(actual < expected ? actual : expected);
  float ratio = hi / (lo > 1.0f ? lo : 1.0f);
  int pct = (int)(100.0f * (4.0f - ratio) / 2.5f);
  if (ratio <= 1.5f) pct = 100;
  else if (ratio > 4.0f) pct = 0;
  if (expected == 0) pct = 100;
  return pct;
}

// Score the chunk rows of one packed doc into [nc, 5] epilogue rows
// (lang1, cbytes, score1, rel, real) — the C twin of the device scorer.
void score_chunks_host(const uint16_t* idx, const uint16_t* chk, int ns,
                       int nc, const uint32_t* cmeta,
                       const uint8_t* cscript, int32_t* rows) {
  static thread_local std::vector<int32_t> scores;
  // one tier-2 adversarial doc would otherwise pin ~64MB per thread
  if (scores.capacity() > (size_t)(8 << 20))
    std::vector<int32_t>().swap(scores);
  scores.assign((size_t)nc * 256, 0);
  for (int i = 0; i < ns; i++) {
    uint32_t lp = rt.cat_ind[idx[i]];
    int row = lp & 0xFF;
    int c = chk[i];
    int32_t* sc = scores.data() + (size_t)c * 256;
    for (int j = 0; j < 3; j++) {
      int ps = (lp >> (8 * (j + 1))) & 0xFF;
      if (ps > 0) sc[ps] += dctx.lg_prob3[row * 3 + j];
    }
  }
  for (int c = 0; c < nc; c++) {
    const int32_t* sc = scores.data() + (size_t)c * 256;
    uint32_t cm = cmeta[c];
    int cbytes = cm & 0xFFFF;
    int grams = (cm >> 16) & 0xFFF;
    int side = (cm >> 28) & 1;
    int real = (cm >> 29) & 1;
    // group-in-use top-2 (tote.cc:30-100 semantics)
    int k1 = -1, k2 = -1;
    int64_t top1 = -1, top2 = -1;
    for (int gi = 0; gi < 64; gi++) {
      bool in_use = sc[gi * 4] > 0 || sc[gi * 4 + 1] > 0 ||
                    sc[gi * 4 + 2] > 0 || sc[gi * 4 + 3] > 0;
      if (!in_use) continue;
      for (int k = gi * 4; k < gi * 4 + 4; k++) {
        int64_t key = (int64_t)sc[k] * 256 + (255 - k);
        if (key > top1) {
          top2 = top1; k2 = k1;
          top1 = key; k1 = k;
        } else if (key > top2) {
          top2 = key; k2 = k;
        }
      }
    }
    int s1 = top1 >= 0 ? (int)(top1 >> 8) : 0;
    int s2 = top2 >= 0 ? (int)(top2 >> 8) : 0;
    if (k1 < 0) k1 = 0;
    if (k2 < 0) k2 = 0;
    int lang1 = dctx.plang_to_lang[side * 256 + k1];
    int lang2 = dctx.plang_to_lang[side * 256 + k2];
    int actual_kb = cbytes > 0 ? (s1 << 10) / cbytes : 0;
    int expected_kb =
        dctx.expected_score[lang1 * 4 + lscript4_of(cscript[c])];
    int rd = c_rel_delta(s1, s2, grams);
    int cs1 = dctx.close_set[lang1];
    if (cs1 != 0 && cs1 == dctx.close_set[lang2]) rd = 100;
    int rs = c_rel_expected(actual_kb, expected_kb);
    int rel = rd < rs ? rd : rs;
    // device wire clips (OUTW packing): keep bit-for-bit agreement
    if (s1 > 0x3FFF) s1 = 0x3FFF;
    if (rel < 0) rel = 0;
    if (rel > 127) rel = 127;
    rows[c * 5 + 0] = lang1;
    rows[c * 5 + 1] = cbytes;
    rows[c * 5 + 2] = s1;
    rows[c * 5 + 3] = rel;
    rows[c * 5 + 4] = real;
  }
}

constexpr int kCabiFlagFinish = 1;
constexpr int kCabiFlagSqueeze = 2;
constexpr int kCabiFlagRepeats = 4;
constexpr int kCabiFlagTop40 = 8;
constexpr int kCabiUnknown = 26;  // UNKNOWN_LANGUAGE

}  // namespace

extern "C" {

// Bumped on ANY change to the exported function signatures or wire
// layouts; the Python loader refuses (and rebuilds) on mismatch so a
// stale .so can never silently corrupt results across an ABI change.
int32_t ldt_abi_version() { return 11; }

// Phase 1: pack + compact. Per-doc outputs (direct_adds [B, D_cap, 3],
// text_bytes/fallback/squeezed/n_slots/n_chunks [B]) land in caller
// arrays; slots and chunk meta stay in C++-owned buffers until finish().
// Fallback docs report 0 slots/chunks (they resolve via the scalar
// engine, so nothing of theirs belongs on the wire). Returns an opaque
// handle; *max_chunk_nsl gets the fattest chunk's slot count (the
// caller's K bucket). L_doc/C_doc are per-doc scratch budgets —
// generosity costs thread-local scratch only, not wire.
int64_t ldt_pack_flat_begin(
    const uint8_t* texts, const int64_t* bounds, int32_t n_docs,
    int32_t L_doc, int32_t C_doc, int32_t D_cap, int32_t flags,
    int32_t n_threads, int32_t want_ranges,
    const int32_t* hint_boost,  // [B, 2, 4] hint-window indices, or null
    int32_t* direct_adds, int32_t* text_bytes, uint8_t* fallback,
    uint8_t* squeezed, int32_t* n_slots, int32_t* n_chunks,
    int32_t* max_chunk_nsl) {
  FlatPackState* st = new FlatPackState;
  st->B = n_docs;
  st->doc_buf.assign(n_docs, 0);
  st->doc_slot_off.assign(n_docs, 0);
  st->doc_chunk_off.assign(n_docs, 0);
  if (!rt_ready) {
    for (int b = 0; b < n_docs; b++) {
      fallback[b] = 1;
      squeezed[b] = 0;
      n_slots[b] = 0;
      n_chunks[b] = 0;
      text_bytes[b] = 0;
      for (int d = 0; d < D_cap; d++)
        direct_adds[((int64_t)b * D_cap + d) * 3] = -1;
    }
    st->bufs.resize(1);
    *max_chunk_nsl = 0;
    return (int64_t)(intptr_t)st;
  }
  int nt = n_threads;
  if (nt <= 1 || n_docs < 2 * nt) nt = 1;
  st->bufs.resize(nt);
  std::vector<int32_t> tmax(nt, 0);

  auto work = [&](int t, int lo, int hi) {
    FlatThreadBuf& tb = st->bufs[t];
    static thread_local std::vector<uint16_t> sidx, schk;
    static thread_local std::vector<uint32_t> scmeta;
    static thread_local std::vector<uint8_t> scscript;
    static thread_local std::vector<int32_t> counts;
    static thread_local std::vector<int32_t> ssoff, ssorig, sclo, schi,
        scrid;
    static thread_local std::vector<uint8_t> scdir;
    sidx.resize(L_doc);
    schk.resize(L_doc);
    scmeta.resize(C_doc);
    scscript.resize(C_doc);
    if (want_ranges) {
      ssoff.resize(L_doc);
      ssorig.resize(L_doc);
      sclo.resize(C_doc);
      schi.resize(C_doc);
      scrid.resize(C_doc);
      scdir.resize(C_doc);
    }
    for (int b = lo; b < hi; b++) {
      // per-doc views: scratch for slot/chunk lanes (b=0 addressing),
      // caller rows for everything per-doc
      ROut o{sidx.data(), schk.data(), scmeta.data(), scscript.data(),
             direct_adds + (int64_t)b * D_cap * 3, text_bytes + b,
             fallback + b, squeezed + b, n_slots + b, n_chunks + b,
             L_doc, C_doc, D_cap, flags,
             hint_boost ? hint_boost + (int64_t)b * 8 : nullptr};
      if (want_ranges) {
        o.slot_soff = ssoff.data();
        o.slot_orig = ssorig.data();
        o.c_orig_lo = sclo.data();
        o.c_orig_hi = schi.data();
        o.c_rid = scrid.data();
        o.c_isdir = scdir.data();
      }
      pack_resolve_one_doc(texts + bounds[b],
                           (int)(bounds[b + 1] - bounds[b]), 0, o);
      st->doc_buf[b] = t;
      st->doc_slot_off[b] = (int64_t)tb.idx.size();
      st->doc_chunk_off[b] = (int64_t)tb.cnsl.size();
      int ns = n_slots[b], nc = n_chunks[b];
      if (!fallback[b] && nc > 0) {
        counts.assign(nc, 0);
        for (int i = 0; i < ns; i++) counts[schk[i]]++;
        int mx = 0;
        for (int c = 0; c < nc; c++) mx = std::max(mx, counts[c]);
        if (mx > kMaxChunkSlots) fallback[b] = 1;  // adversarial chunk
        else {
          if (mx > tmax[t]) tmax[t] = mx;
          tb.idx.insert(tb.idx.end(), sidx.begin(), sidx.begin() + ns);
          for (int c = 0; c < nc; c++)
            tb.cnsl.push_back((uint16_t)counts[c]);
          tb.cmeta.insert(tb.cmeta.end(), scmeta.begin(),
                          scmeta.begin() + nc);
          tb.cscript.insert(tb.cscript.end(), scscript.begin(),
                            scscript.begin() + nc);
          if (want_ranges) {
            tb.soff.insert(tb.soff.end(), ssoff.begin(),
                           ssoff.begin() + ns);
            tb.sorig.insert(tb.sorig.end(), ssorig.begin(),
                            ssorig.begin() + ns);
            tb.clo.insert(tb.clo.end(), sclo.begin(), sclo.begin() + nc);
            tb.chi.insert(tb.chi.end(), schi.begin(), schi.begin() + nc);
            tb.crid.insert(tb.crid.end(), scrid.begin(),
                           scrid.begin() + nc);
            tb.cdir.insert(tb.cdir.end(), scdir.begin(),
                           scdir.begin() + nc);
          }
        }
      }
      if (fallback[b]) {
        n_slots[b] = 0;
        n_chunks[b] = 0;
      }
    }
  };
  if (nt == 1) {
    work(0, 0, n_docs);
  } else {
    std::vector<std::thread> ts;
    int per = (n_docs + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int lo = t * per, hi = std::min(n_docs, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, t, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  int mx = 0;
  for (int t = 0; t < nt; t++) mx = std::max(mx, tmax[t]);
  *max_chunk_nsl = mx;
  return (int64_t)(intptr_t)st;
}

// Free a begin() handle without laying out the wire (error-path cleanup:
// the caller could not allocate the wire arrays, or was interrupted).
void ldt_pack_flat_free(int64_t handle) {
  delete (FlatPackState*)(intptr_t)handle;
}

// Scoring/epilogue tables for the C-only detection path. Pointers must
// outlive detection calls (the Python runtime pins them; a C host keeps
// the artifact mapped).
void ldt_init_detect(const uint8_t* lg_prob3, const int32_t* plang_to_lang,
                     const int32_t* expected_score,
                     const int32_t* close_set, const int32_t* closest_alt,
                     const uint8_t* is_figs, int32_t n_lang,
                     const char* codes, int32_t code_stride) {
  dctx = DetectCtx{lg_prob3, plang_to_lang, expected_score, close_set,
                   closest_alt, is_figs, codes, n_lang, code_stride, true};
}

// Scoring subset cap, mirroring the reference's 160KB-per-document
// subsetting (compact_lang_det_impl.h:159-161, impl.cc:192): detection
// quality saturates long before this, and the cap is what lets the
// budget ladder below GUARANTEE an answer for any input.
constexpr int32_t kCabiMaxScoreBytes = 160 << 10;

// One full C-side detection: pack -> score -> epilogue, plus the
// reference's gate-failure recursion (impl.cc:2061-2105) as a second
// pass with the recursion flags. Fills the 14-lane epilogue row
// (ldt_epilogue_flat contract). Documents that overflow the default
// per-doc budgets retry once with a large tier instead of giving up —
// the reference's wrapper never answers "un" for mere size
// (wrapper.cc:7-16): 512K slots / 64K chunks / 64K direct adds cover
// every real 160KB-capped document (~3 resolved hits per 6-byte word
// plus per-chunk boost flushes < 512K slots; a chunk or direct add
// needs a fresh hit round or a script flip).
static bool detect_one_row(const uint8_t* text, int32_t len,
                           int64_t* out) {
  if (!rt_ready || !dctx.ready) return false;
  if (len > kCabiMaxScoreBytes) len = kCabiMaxScoreBytes;
  static thread_local std::vector<uint16_t> sidx, schk;
  static thread_local std::vector<uint32_t> scmeta;
  static thread_local std::vector<uint8_t> scscript;
  static thread_local std::vector<int32_t> rows, dadds;
  struct Tier { int L, C, D; };
  // The chunk-id lane is u16 (ROut.chk), so no tier may budget more
  // than 1<<16 chunks; 64K chunks need >32K script alternations inside
  // the 160KB cap, so only adversarial constructions exceed tier 2 —
  // those return false here (the Python caller falls back to the
  // scalar engine; the raw C ABI answers "un").
  const Tier tiers[2] = {{1 << 17, 1 << 14, 64},
                         {1 << 19, 1 << 16, 1 << 16}};
  for (const Tier& bud : tiers) {
    sidx.resize(bud.L);
    schk.resize(bud.L);
    scmeta.resize(bud.C);
    scscript.resize(bud.C);
    dadds.resize((size_t)bud.D * 3);
    int32_t text_bytes = 0, n_slots = 0, n_chunks = 0;
    uint8_t fallback = 0, squeezed = 0;
    int flags = 0;
    for (int pass = 0; pass < 2; pass++) {
      ROut o{sidx.data(), schk.data(), scmeta.data(), scscript.data(),
             dadds.data(), &text_bytes, &fallback, &squeezed, &n_slots,
             &n_chunks, bud.L, bud.C, bud.D, flags};
      pack_resolve_one_doc(text, len, 0, o);
      if (fallback) break;  // budget overflow: try the large tier
      rows.assign((size_t)n_chunks * 5, 0);
      score_chunks_host(sidx.data(), schk.data(), n_slots, n_chunks,
                        scmeta.data(), scscript.data(), rows.data());
      int64_t dcs = 0;
      uint8_t skip = 0;
      ldt_epilogue_flat(rows.data(), &dcs, &n_chunks, dadds.data(),
                        &text_bytes, &skip, 1, bud.D, flags,
                        dctx.close_set, dctx.closest_alt, dctx.is_figs,
                        dctx.n_lang, out);
      if (!out[12]) return true;
      // good-answer gate failed: one recursion pass (FINISH forces it)
      flags = kCabiFlagTop40 | kCabiFlagRepeats | kCabiFlagFinish |
              (squeezed ? kCabiFlagSqueeze : 0);
    }
  }
  return false;  // adversarial: >64K chunks inside the 160KB cap
}

static int32_t detect_one_c(const uint8_t* text, int32_t len) {
  int64_t out[14];
  if (!detect_one_row(text, len, out)) return kCabiUnknown;
  return (int32_t)out[0];
}

// The reference seam (wrapper.h:8 / wrapper.cc:7-16): NUL-terminated
// UTF-8 in, static ISO-639 code string out, no allocation. The returned
// pointer is thread-local and valid until this thread's next call.
const char* detect_language(const char* src) {
  if (src == nullptr || !dctx.ready) return "un";
  int32_t lang = detect_one_c((const uint8_t*)src,
                              (int32_t)strlen(src));
  if (lang < 0 || lang >= dctx.n_lang) lang = kCabiUnknown;
  return dctx.codes + (size_t)lang * dctx.code_stride;
}

// Length-taking twin of detect_language (embedded NULs are legal in
// the length-delimited contract; the NUL-terminated seam cannot carry
// them). Same static-string return semantics.
const char* detect_language_n(const char* src, int32_t len) {
  if (src == nullptr || len < 0 || !dctx.ready) return "un";
  int32_t lang = detect_one_c((const uint8_t*)src, len);
  if (lang < 0 || lang >= dctx.n_lang) lang = kCabiUnknown;
  return dctx.codes + (size_t)lang * dctx.code_stride;
}

// Full 14-lane epilogue row for one document (the richer
// ExtDetectLanguageSummary surface, compact_lang_det.h:168-426, over
// the C pipeline): summary lang, top-3 languages / percents /
// normalized scores, text bytes, reliability. Returns 1 on success.
int32_t ldt_detect_one_full(const uint8_t* text, int32_t len,
                            int64_t* out14) {
  if (text == nullptr || out14 == nullptr || len < 0) return 0;
  if (!detect_one_row(text, len, out14)) {
    for (int i = 0; i < 14; i++) out14[i] = 0;
    out14[0] = kCabiUnknown;
    return 0;
  }
  return 1;
}

// Batched variant: concatenated UTF-8 docs + bounds, language ids out.
// Thread-parallel like the packer (each doc is independent).
void ldt_detect_batch_codes(const uint8_t* texts, const int64_t* bounds,
                            int32_t n_docs, int32_t n_threads,
                            int32_t* lang_out) {
  auto work = [&](int lo, int hi) {
    for (int b = lo; b < hi; b++)
      lang_out[b] = detect_one_c(texts + bounds[b],
                                 (int32_t)(bounds[b + 1] - bounds[b]));
  };
  if (n_threads <= 1 || n_docs < 2 * n_threads) {
    work(0, n_docs);
    return;
  }
  std::vector<std::thread> ts;
  int per = (n_docs + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int lo = t * per, hi = std::min(n_docs, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// Phase 2: lay the packed content out shard-major and free the state.
// Shard d takes docs [d*B/D, (d+1)*B/D); within a shard, slots and
// chunks concatenate in doc order (chunk_start is shard-local so the
// device program is identical on every shard). doc_chunk_start[b] is
// the doc's first chunk row in the flattened [D*Gs] grid (the epilogue's
// map back from chunk rows to documents). Tails beyond each shard's
// content are zeroed: cnsl=0 rows are dead on device (masked) and in
// the epilogue (real bit 0).
void ldt_pack_flat_finish(
    int64_t handle, int32_t B, int32_t D, int32_t N, int32_t Gs,
    const int32_t* n_slots, const int32_t* n_chunks,
    const int32_t* doc_whack_row,  // [B] whack-table rows, or null
    uint16_t* idx_flat, uint8_t* cnsl_flat,
    uint32_t* cmeta_flat, uint8_t* cscript_flat, uint16_t* cwhack_flat,
    int64_t* doc_chunk_start,
    // result-vector sidecars, [D,N] / [D,Gs] like the wire lanes; all
    // null unless the pack ran with want_ranges (host-only — never
    // shipped to the device)
    int32_t* soff_flat, int32_t* sorig_flat, int32_t* clo_flat,
    int32_t* chi_flat, int32_t* crid_flat, uint8_t* cdir_flat) {
  // No chunk-start lane on the wire: slots concatenate in chunk order,
  // so the device derives starts as an exclusive cumsum of cnsl.
  // cwhack_flat may be null (hint-free batches carry a 1-wide dummy).
  FlatPackState* st = (FlatPackState*)(intptr_t)handle;
  int Bd = B / D;
  const bool ranges = soff_flat != nullptr;
  for (int d = 0; d < D; d++) {
    int64_t spos = 0, gpos = 0;
    for (int i = 0; i < Bd; i++) {
      int b = d * Bd + i;
      const FlatThreadBuf& tb = st->bufs[st->doc_buf[b]];
      int ns = n_slots[b], nc = n_chunks[b];
      std::memcpy(idx_flat + (int64_t)d * N + spos,
                  tb.idx.data() + st->doc_slot_off[b],
                  (size_t)ns * sizeof(uint16_t));
      if (ranges && !tb.soff.empty()) {
        std::memcpy(soff_flat + (int64_t)d * N + spos,
                    tb.soff.data() + st->doc_slot_off[b],
                    (size_t)ns * sizeof(int32_t));
        std::memcpy(sorig_flat + (int64_t)d * N + spos,
                    tb.sorig.data() + st->doc_slot_off[b],
                    (size_t)ns * sizeof(int32_t));
      }
      doc_chunk_start[b] = (int64_t)d * Gs + gpos;
      int64_t src = st->doc_chunk_off[b];
      int64_t dst = (int64_t)d * Gs + gpos;
      uint16_t wrow = doc_whack_row ? (uint16_t)doc_whack_row[b] : 0;
      for (int c = 0; c < nc; c++) {
        cnsl_flat[dst + c] = (uint8_t)tb.cnsl[src + c];
        cmeta_flat[dst + c] = tb.cmeta[src + c];
        cscript_flat[dst + c] = tb.cscript[src + c];
        if (cwhack_flat) cwhack_flat[dst + c] = wrow;
        if (ranges && !tb.clo.empty()) {
          clo_flat[dst + c] = tb.clo[src + c];
          chi_flat[dst + c] = tb.chi[src + c];
          crid_flat[dst + c] = tb.crid[src + c];
          cdir_flat[dst + c] = tb.cdir[src + c];
        }
      }
      spos += ns;
      gpos += nc;
    }
    for (int64_t g = gpos; g < Gs; g++) {
      int64_t dst = (int64_t)d * Gs + g;
      cnsl_flat[dst] = 0;
      cmeta_flat[dst] = 0;
      cscript_flat[dst] = 0;
      if (cwhack_flat) cwhack_flat[dst] = 0;
      if (ranges) {
        clo_flat[dst] = chi_flat[dst] = -1;
        crid_flat[dst] = -1;
        cdir_flat[dst] = 0;
      }
    }
  }
  delete st;
}

// Table geometry + data for host-side resolution. Pointers are owned by
// Python (DeviceTables host copies) and must outlive packing calls.
void ldt_init_tables(const uint32_t* cat_buckets, const uint32_t* cat_ind,
                     int64_t n_ind, const int64_t* bucket_off,
                     const uint32_t* size, const uint32_t* keymask,
                     const int32_t* ind_off, const int32_t* size_one,
                     const uint8_t* probes, int64_t q2_bucket_off,
                     uint32_t q2_size, uint32_t q2_keymask,
                     int32_t q2_ind_off, int32_t q2_size_one,
                     int32_t q2_enabled, int32_t seed_ind_base) {
  rt.cat_buckets = cat_buckets;
  rt.cat_ind = cat_ind;
  rt.n_ind = n_ind;
  for (int k = 0; k < 8; k++) {
    rt.bucket_off[k] = bucket_off[k];
    rt.size[k] = size[k];
    rt.keymask[k] = keymask[k];
    rt.ind_off[k] = ind_off[k];
    rt.size_one[k] = size_one[k];
    rt.probes[k] = probes[k];
  }
  rt.q2_bucket_off = q2_bucket_off;
  rt.q2_size = q2_size;
  rt.q2_keymask = q2_keymask;
  rt.q2_ind_off = q2_ind_off;
  rt.q2_size_one = q2_size_one;
  rt.q2_enabled = q2_enabled;
  rt.seed_ind_base = seed_ind_base;
  rt_ready = true;
}

void ldt_init(const uint8_t* script_of_cp, const uint32_t* lower_map,
              const uint8_t* cjk_prop, const int32_t* rtype,
              const int32_t* deflang, const uint32_t* seed_lp,
              int32_t n_scripts, int32_t distinctbi_empty) {
  g = Ctx{script_of_cp, lower_map, cjk_prop, rtype, deflang, seed_lp,
          n_scripts, distinctbi_empty};
}

// Script spans of a batch of documents, for the long-doc lane's split
// (preprocess/pack.py span_extents, over segment_text above). texts and
// bounds as ldt_pack_batch. Document b writes its spans at
// ext[4 * ext_off[b]...] (room for ext_off[b + 1] - ext_off[b] spans):
// per span the source char index of its first letter, one past the
// source char of its closing separator, its ULScript and its buffer
// length text_bytes; the span buffers [0, text_bytes) go, concatenated,
// to bytes[byte_off[b]...] (room up to byte_off[b + 1]). n_spans[b] is
// the span count, or -1 when the tables are not installed or the room
// is too small. Documents are taken by n_threads threads in turn.
void ldt_span_extents(const uint8_t* texts, const int64_t* bounds,
                      int32_t n_docs, int32_t n_threads,
                      const int64_t* ext_off, int32_t* ext,
                      const int64_t* byte_off, uint8_t* bytes,
                      int32_t* n_spans) {
  auto one = [&](int b) {
    n_spans[b] = -1;
    if (g.script_of_cp == nullptr) return;
    static thread_local SegScratch seg;
    seg.maybe_shrink();
    const int n = segment_text(texts + bounds[b],
                               (int)(bounds[b + 1] - bounds[b]), &seg,
                               true);
    if (seg.n_spans > ext_off[b + 1] - ext_off[b]) return;
    const int64_t* bb = seg.byte_before.data();
    // b2o holds source BYTE offsets, each the start of a codepoint
    auto char_of = [&](int32_t off) {
      return (int32_t)(std::lower_bound(bb, bb + n + 1, (int64_t)off) -
                       bb);
    };
    int32_t* e = ext + 4 * ext_off[b];
    int64_t used = byte_off[b];
    for (int k = 0; k < seg.n_spans; k++) {
      const Span& sp = seg.spans[k];
      if (sp.b2o.size() < 2 || used + sp.text_bytes > byte_off[b + 1])
        return;
      e[4 * k] = char_of(sp.b2o[1]);
      e[4 * k + 1] = char_of(sp.b2o.back()) + 1;
      e[4 * k + 2] = sp.ulscript;
      e[4 * k + 3] = sp.text_bytes;
      std::memcpy(bytes + used, sp.buf.data(), sp.text_bytes);
      used += sp.text_bytes;
    }
    n_spans[b] = seg.n_spans;
  };
  std::atomic<int> next{0};
  auto work = [&]() {
    for (int b; (b = next.fetch_add(1)) < n_docs;) one(b);
  };
  std::vector<std::thread> ts;
  for (int t = 1; t < std::min(n_threads, n_docs); t++)
    ts.emplace_back(work);
  work();
  for (auto& t : ts) t.join();
}

// texts: concatenated UTF-8 docs; bounds[i]..bounds[i+1] delimit doc i.
void ldt_pack_batch(const uint8_t* texts, const int64_t* bounds,
                    int32_t n_docs, int32_t L, int32_t C, int32_t D,
                    int32_t flags, int32_t n_threads,
                    int8_t* kind, int32_t* offset, uint32_t* fp,
                    uint8_t* fp_hi,
                    int32_t* chunk_base, int32_t* span_start,
                    int32_t* span_end_off, int8_t* side, int8_t* cjk,
                    int16_t* script, int16_t* chunk_script,
                    int8_t* chunk_cjk, int8_t* chunk_side,
                    int32_t* chunk_span_end,
                    int32_t* direct_adds, int32_t* text_bytes,
                    uint8_t* fallback, int32_t* n_slots,
                    int32_t* n_chunks) {
  Out o{kind, offset, fp, fp_hi, chunk_base, span_start,
        span_end_off, side, cjk, script, chunk_script, chunk_cjk,
        chunk_side, chunk_span_end, direct_adds, text_bytes, fallback,
        n_slots, n_chunks, L, C, D, flags};
  auto work = [&](int lo, int hi) {
    for (int b = lo; b < hi; b++)
      pack_one_doc(texts + bounds[b], (int)(bounds[b + 1] - bounds[b]), b,
                   o);
  };
  if (n_threads <= 1 || n_docs < 2 * n_threads) {
    work(0, n_docs);
    return;
  }
  std::vector<std::thread> ts;
  int per = (n_docs + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int lo = t * per, hi = std::min(n_docs, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
