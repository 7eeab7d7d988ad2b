// Batched document epilogue: DocTote replay + close pairs + unreliable
// removal + summary language, per document over the device scorer's
// [B, C, 5] chunk summaries.
//
// C++ twin of the oracle-validated Python epilogue in models/ngram.py
// _doc_epilogue + engine_scalar.py (refine_close_pairs :469,
// remove_unreliable :495, extract_lang_etc :543, calc_summary_lang :594),
// which in turn mirrors the reference document pipeline
// (compact_lang_det_impl.cc:1956-2106; DocTote tote.cc:127-252).
// tests/test_native_epilogue.py asserts array equality against the Python
// path on the golden suite and on randomized chunk summaries.
//
// O(1) per document, no allocation; the per-doc loop is trivially
// parallel but single-threaded here (it runs at ~1us/doc).

#include <cstdint>
#include <cstring>

#include "ldt_internal.h"

namespace {

constexpr int kMax = 24;
constexpr int kUnused = 0xFFFF;
constexpr int kUnknown = 26;       // UNKNOWN_LANGUAGE
constexpr int kTgUnknown = 25;     // TG_UNKNOWN_LANGUAGE
constexpr int kEnglish = 0;

constexpr int kMinReliableKeepPercent = 41;
constexpr int kNonEnBoilerplateMinPercent = 17;
constexpr int kNonFigsBoilerplateMinPercent = 20;
constexpr int kGoodFirstMinPercent = 26;
constexpr int kGoodFirstReliableMinPercent = 51;
constexpr int kIgnoreMaxPercent = 20;
constexpr int kKeepMinPercent = 2;
constexpr int kGoodSecondT1T2MinBytes = 15;
constexpr int kGoodLang1Percent = 70;
constexpr int kGoodLang1and2Percent = 93;
constexpr int kShortTextThresh = 256;

constexpr int kFlagFinish = 1;
constexpr int kFlagBestEffort = 0x4000;

struct Reg {
  const int32_t* close_set;    // [n_lang]
  const int32_t* closest_alt;  // [n_lang] (kUnknown when none)
  const uint8_t* is_figs;      // [n_lang]
  int n_lang;

  int close(int lang) const {
    return (lang >= 0 && lang < n_lang) ? close_set[lang] : 0;
  }
  int alt(int lang) const {
    return (lang >= 0 && lang < n_lang) ? closest_alt[lang] : kUnknown;
  }
  bool figs(int lang) const {
    return lang >= 0 && lang < n_lang && is_figs[lang];
  }
  bool efigs(int lang) const { return lang == kEnglish || figs(lang); }
};

struct DocTote {
  int64_t key[kMax];
  int64_t value[kMax];
  int64_t score[kMax];
  int64_t rel[kMax];

  void init() {
    for (int i = 0; i < kMax; i++) {
      key[i] = kUnused;
      value[i] = score[i] = rel[i] = 0;
    }
  }

  // tote.cc:127-177 3-way set-associative insert with smallest-victim
  // eviction (engine_scalar.py DocTote.add)
  void add(int lang, int64_t nbytes, int64_t s, int64_t reliability) {
    int subs[3] = {lang & 15, (lang & 15) ^ 8, (lang & 7) + 16};
    for (int s3 : subs) {
      if (key[s3] == lang) {
        value[s3] += nbytes;
        score[s3] += s;
        rel[s3] += reliability * nbytes;
        return;
      }
    }
    int alloc = -1;
    for (int s3 : subs) {
      if (key[s3] == kUnused) { alloc = s3; break; }
    }
    if (alloc < 0) {
      alloc = subs[0];
      for (int s3 : subs) {
        if (value[s3] < value[alloc]) alloc = s3;
      }
    }
    key[alloc] = lang;
    value[alloc] = nbytes;
    score[alloc] = s;
    rel[alloc] = reliability * nbytes;
  }

  int find(int lang) const {
    for (int i = 0; i < kMax; i++) {
      if (key[i] == lang) return i;
    }
    return -1;
  }

  // stable sort by decreasing byte count, UNUSED last (tote.cc:221-250)
  void sort() {
    for (int i = 0; i < kMax; i++) {
      if (key[i] == kUnused) value[i] = -1;
    }
    // insertion sort, stable, 24 elements
    for (int i = 1; i < kMax; i++) {
      int64_t k = key[i], v = value[i], s = score[i], r = rel[i];
      int j = i - 1;
      while (j >= 0 && value[j] < v) {
        key[j + 1] = key[j];
        value[j + 1] = value[j];
        score[j + 1] = score[j];
        rel[j + 1] = rel[j];
        j--;
      }
      key[j + 1] = k;
      value[j + 1] = v;
      score[j + 1] = s;
      rel[j + 1] = r;
    }
  }
};

// RefineScoredClosePairs (impl.cc:1154-1203)
void refine_close_pairs(const Reg& reg, DocTote* t) {
  for (int sub = 0; sub < kMax; sub++) {
    int lang = (int)t->key[sub];
    if (lang == kUnused) continue;
    int cs = reg.close(lang);
    if (cs == 0) continue;
    for (int sub2 = sub + 1; sub2 < kMax; sub2++) {
      int lang2 = (int)t->key[sub2];
      if (lang2 == kUnused || reg.close(lang2) != cs) continue;
      int frm = sub, to = sub2;
      if (t->value[sub] >= t->value[sub2]) { frm = sub2; to = sub; }
      t->value[to] += t->value[frm];
      t->score[to] += t->score[frm];
      t->rel[to] += t->rel[frm];
      t->key[frm] = kUnused;
      t->value[frm] = t->score[frm] = t->rel[frm] = 0;
      break;
    }
  }
}

// RemoveUnreliableLanguages (impl.cc:997-1101)
void remove_unreliable(const Reg& reg, DocTote* t) {
  for (int sub = 0; sub < kMax; sub++) {
    int lang = (int)t->key[sub];
    if (lang == kUnused) continue;
    int64_t nbytes = t->value[sub];
    if (nbytes == 0) continue;
    int64_t pct = t->rel[sub] / nbytes;
    if (pct >= kMinReliableKeepPercent) continue;
    int alt = reg.alt(lang);
    if (alt == kUnknown) continue;
    int altsub = t->find(alt);
    if (altsub < 0) continue;
    int64_t bytes2 = t->value[altsub];
    if (bytes2 == 0) continue;
    int64_t pct2 = t->rel[altsub] / bytes2;
    int tosub = altsub, fromsub = sub;
    if (pct2 < pct || (pct2 == pct && lang < alt)) {
      tosub = sub;
      fromsub = altsub;
    }
    int64_t newpct = pct > pct2 ? pct : pct2;
    if (newpct < kMinReliableKeepPercent) newpct = kMinReliableKeepPercent;
    int64_t newbytes = nbytes + bytes2;
    t->key[fromsub] = kUnused;
    t->score[fromsub] = 0;
    t->rel[fromsub] = 0;
    t->score[tosub] = newbytes;  // reference stores bytes via SetScore
    t->rel[tosub] = newpct * newbytes;
  }
  for (int sub = 0; sub < kMax; sub++) {
    if (t->key[sub] == kUnused) continue;
    int64_t nbytes = t->value[sub];
    if (nbytes == 0) continue;
    if (t->rel[sub] / nbytes < kMinReliableKeepPercent) {
      t->key[sub] = kUnused;
      t->score[sub] = 0;
      t->rel[sub] = 0;
    }
  }
}

struct Extract {
  int lang3[3];
  int percent3[3];
  int rel3[3];
  int64_t ns3[3];   // integer-valued normalized score (score<<10)/bytes
  int64_t total;
  bool is_reliable;
};

// ExtractLangEtc (impl.cc:1276-1384)
void extract_lang_etc(const DocTote& t, int64_t total_text_bytes,
                      Extract* e) {
  int64_t bc[3] = {0, 0, 0};
  for (int i = 0; i < 3; i++) {
    e->lang3[i] = kUnknown;
    e->percent3[i] = 0;
    e->rel3[i] = 0;
    e->ns3[i] = 0;
    int lang = (int)t.key[i];
    if (lang != kUnused && lang != kUnknown) {
      e->lang3[i] = lang;
      bc[i] = t.value[i];
      int64_t d = bc[i] > 0 ? bc[i] : 1;
      e->rel3[i] = (int)(t.rel[i] / d);
      e->ns3[i] = bc[i] ? ((t.score[i] << 10) / bc[i]) : 0;
    }
  }
  int64_t total12 = bc[0] + bc[1];
  int64_t total123 = total12 + bc[2];
  int64_t total = total_text_bytes > total123 ? total_text_bytes : total123;
  int64_t div = total > 1 ? total : 1;
  e->percent3[0] = (int)(bc[0] * 100 / div);
  e->percent3[1] = (int)(total12 * 100 / div);
  e->percent3[2] = (int)(total123 * 100 / div);
  e->percent3[2] -= e->percent3[1];
  e->percent3[1] -= e->percent3[0];
  if (e->percent3[1] < e->percent3[2]) {
    e->percent3[1]++;
    e->percent3[2]--;
  }
  if (e->percent3[0] < e->percent3[1]) {
    e->percent3[0]++;
    e->percent3[1]--;
  }
  e->total = total;
  e->is_reliable = false;
  if (e->lang3[0] != kUnknown) {
    e->is_reliable = e->rel3[0] >= kMinReliableKeepPercent;
  }
  int ignore = 100 - (e->percent3[0] + e->percent3[1] + e->percent3[2]);
  if (ignore > kIgnoreMaxPercent) e->is_reliable = false;
}

// CalcSummaryLang (impl.cc:1414-1522)
void calc_summary_lang(const Reg& reg, const Extract& e,
                       int64_t total_text_bytes, int flags, int* summary_out,
                       bool* reliable_out) {
  const int* lang3 = e.lang3;
  const int* percent3 = e.percent3;
  int slot[3] = {0, 1, 2};
  int slot_count = 3;
  int ignore_percent = 0;
  int return_percent = percent3[0];
  int summary = lang3[0];
  bool reliable = true;
  if (percent3[0] < kKeepMinPercent) reliable = false;

  for (int i = 0; i < 3; i++) {
    if (lang3[i] == kTgUnknown) {
      ignore_percent += percent3[i];
      for (int j = i + 1; j < 3; j++) slot[j - 1] = slot[j];
      slot_count--;
      return_percent = (percent3[0] * 100) / (101 - ignore_percent);
      summary = lang3[slot[0]];
      if (percent3[slot[0]] < kKeepMinPercent) reliable = false;
    }
  }

  int64_t second_bytes = total_text_bytes * percent3[slot[1]] / 100;
  if (lang3[slot[0]] == kEnglish && lang3[slot[1]] != kEnglish &&
      lang3[slot[1]] != kUnknown &&
      percent3[slot[1]] >= kNonEnBoilerplateMinPercent &&
      second_bytes >= kGoodSecondT1T2MinBytes) {
    ignore_percent += percent3[slot[0]];
    return_percent = (percent3[slot[1]] * 100) / (101 - ignore_percent);
    summary = lang3[slot[1]];
    if (percent3[slot[1]] < kKeepMinPercent) reliable = false;
  } else if (reg.figs(lang3[slot[0]]) && !reg.efigs(lang3[slot[1]]) &&
             lang3[slot[1]] != kUnknown &&
             percent3[slot[1]] >= kNonFigsBoilerplateMinPercent &&
             second_bytes >= kGoodSecondT1T2MinBytes) {
    ignore_percent += percent3[slot[0]];
    return_percent = (percent3[slot[1]] * 100) / (101 - ignore_percent);
    summary = lang3[slot[1]];
    if (percent3[slot[1]] < kKeepMinPercent) reliable = false;
  } else if (lang3[slot[1]] == kEnglish && lang3[slot[0]] != kEnglish) {
    ignore_percent += percent3[slot[1]];
    return_percent = (percent3[slot[0]] * 100) / (101 - ignore_percent);
  } else if (reg.figs(lang3[slot[1]]) && !reg.efigs(lang3[slot[0]])) {
    ignore_percent += percent3[slot[1]];
    return_percent = (percent3[slot[0]] * 100) / (101 - ignore_percent);
  }

  if (return_percent < kGoodFirstMinPercent && !(flags & kFlagBestEffort)) {
    summary = kUnknown;
    reliable = false;
  }
  if (return_percent < kGoodFirstReliableMinPercent) reliable = false;
  ignore_percent = 100 - (percent3[0] + percent3[1] + percent3[2]);
  if (ignore_percent > kIgnoreMaxPercent) reliable = false;
  if (slot_count == 0) {
    summary = kUnknown;
    reliable = false;
  }
  *summary_out = summary;
  *reliable_out = reliable;
}

}  // namespace

extern "C" {

// Batched document epilogue. Output layout per doc (int64, 14 lanes):
//   0 summary | 1-3 lang3 | 4-6 percent3 | 7-9 ns3 | 10 text_bytes
//   11 is_reliable | 12 need_scalar (good-answer gate failed ->
//   caller runs the batched recursion) | 13 unused
// Chunk summaries arrive as one
// flat [G, 5] array (all docs' chunks concatenated, the device layout of
// the flat wire) and each doc owns rows [doc_chunk_start[b],
// doc_chunk_start[b] + n_chunks[b]). direct_adds chunk ids stay
// doc-local. Same output contract.
void ldt_epilogue_flat(
    const int32_t* rows,             // [G, 5] lang1, bytes, score1, rel, real
    const int64_t* doc_chunk_start,  // [B] doc's first chunk row
    const int32_t* n_chunks,         // [B]
    const int32_t* direct,           // [B, D, 3] chunk_id, lang, bytes
    const int32_t* text_bytes,       // [B]
    const uint8_t* skip,             // [B] nonzero = packer fallback
    int32_t B, int32_t D, int32_t flags,
    const int32_t* close_set, const int32_t* closest_alt,
    const uint8_t* is_figs, int32_t n_lang,
    int64_t* out) {                  // [B, 14]
  Reg reg{close_set, closest_alt, is_figs, n_lang};
  for (int b = 0; b < B; b++) {
    int64_t* o = out + (int64_t)b * 14;
    std::memset(o, 0, 14 * sizeof(int64_t));
    if (skip && skip[b]) {
      o[12] = 1;  // scalar path decides everything
      continue;
    }
    DocTote t;
    t.init();
    const int32_t* dd = direct + (int64_t)b * D * 3;
    const int32_t* rr = rows + doc_chunk_start[b] * 5;
    int nd = 0;
    while (nd < D && dd[nd * 3] >= 0) nd++;
    for (int c = 0; c < n_chunks[b]; c++) {
      bool is_direct = false;
      for (int d = 0; d < nd; d++) {
        if (dd[d * 3] == c) {
          t.add(dd[d * 3 + 1], dd[d * 3 + 2], dd[d * 3 + 2], 100);
          is_direct = true;
          break;
        }
      }
      if (!is_direct && rr[c * 5 + 4]) {
        t.add(rr[c * 5], rr[c * 5 + 1], rr[c * 5 + 2], rr[c * 5 + 3]);
      }
    }

    refine_close_pairs(reg, &t);
    t.sort();
    Extract e;
    extract_lang_etc(t, text_bytes[b], &e);

    bool good = (flags & kFlagFinish) || e.total <= kShortTextThresh ||
                (e.is_reliable && e.percent3[0] >= kGoodLang1Percent) ||
                (e.is_reliable &&
                 e.percent3[0] + e.percent3[1] >= kGoodLang1and2Percent);
    if (!good) {
      o[12] = 1;
      continue;
    }

    if (!(flags & kFlagBestEffort)) remove_unreliable(reg, &t);
    t.sort();
    extract_lang_etc(t, text_bytes[b], &e);
    int summary;
    bool reliable;
    calc_summary_lang(reg, e, e.total, flags, &summary, &reliable);

    o[0] = summary;
    for (int i = 0; i < 3; i++) {
      o[1 + i] = e.lang3[i];
      o[4 + i] = e.percent3[i];
      o[7 + i] = e.ns3[i];
    }
    o[10] = e.total;
    o[11] = (e.is_reliable && reliable) ? 1 : 0;
  }
}

}  // extern "C"
