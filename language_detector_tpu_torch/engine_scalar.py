"""Scalar reference engine: the complete detection pipeline on the host.

This is the behavioral specification for the batched TPU path (ops/ and
models/ngram.py): a faithful, readable re-implementation of the reference
scoring pipeline over the same table artifact, validated hit-for-hit against
the compiled oracle (tools/oracle). The TPU engine must agree with this
engine, and this engine must agree with the oracle.

Pipeline (reference call stack, compact_lang_det_impl.cc:1707-2106):
  segment -> per-span hits -> linearize -> chunk -> chunk totes ->
  doc tote -> close-pair refinement -> extract top-3 -> decision gate ->
  [recurse with stricter flags] -> remove unreliable -> summary language.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .preprocess.grams import (DUAL_TABLE_FLAG, HitList, get_bi_hits,
                               get_octa_hits, get_quad_hits, get_uni_hits)
from .preprocess.segment import ScriptSpan, segment_text
from .preprocess.squeeze import (PREDICTION_TABLE_SIZE, TEST_THRESH,
                                 cheap_rep_words, cheap_rep_words_overwrite,
                                 cheap_squeeze, cheap_squeeze_overwrite,
                                 cheap_squeeze_trigger_test)
from .registry import (ENGLISH, RTYPE_CJK, RTYPE_MANY, RTYPE_NONE, RTYPE_ONE,
                       TG_UNKNOWN_LANGUAGE, ULSCRIPT_LATIN, UNKNOWN_LANGUAGE,
                       Registry, registry as default_registry)
from .tables import NgramTable, ScoringTables, load_tables

# Hit types (scoreonescriptspan.h:172-175)
UNIHIT, QUADHIT, DELTAHIT, DISTINCTHIT = 0, 1, 2, 3

# Chunk sizes (scoreonescriptspan.h:91-92)
CHUNKSIZE_QUADS = 20
CHUNKSIZE_UNIS = 50

# Flags (public compact_lang_det.h:343-350 + internal impl.h:31-38)
FLAG_SCORE_AS_QUADS = 0x0100
FLAG_BEST_EFFORT = 0x4000
FLAG_FINISH = 1
FLAG_SQUEEZE = 2
FLAG_REPEATS = 4
FLAG_TOP40 = 8
FLAG_SHORT = 16
FLAG_USE_WORDS = 64

# Decision thresholds (compact_lang_det_impl.cc:188-240, :981, :1405-1406)
GOOD_LANG1_PERCENT = 70
GOOD_LANG1AND2_PERCENT = 93
SHORT_TEXT_THRESH = 256
MIN_RELIABLE_KEEP_PERCENT = 41
NON_EN_BOILERPLATE_MIN_PERCENT = 17
NON_FIGS_BOILERPLATE_MIN_PERCENT = 20
GOOD_FIRST_MIN_PERCENT = 26
GOOD_FIRST_RELIABLE_MIN_PERCENT = 51
IGNORE_MAX_PERCENT = 20
KEEP_MIN_PERCENT = 2
GOOD_SECOND_T1T2_MIN_BYTES = 15

# Reliability model (cldutil.cc:41-44, :553-605)
MIN_GRAM_COUNT = 3
MAX_GRAM_COUNT = 16

MAX_BOOSTS = 4  # rotating distinct-word boost slots (scoreonescriptspan.h:89)


# ---------------------------------------------------------------------------
# langprob decode and totes
# ---------------------------------------------------------------------------

def decode_langprob(lp: int, lg_prob: np.ndarray) -> list[tuple[int, int]]:
    """uint32 langprob -> up to 3 (pslang, qprob) pairs (cldutil.cc:128)."""
    entry = lg_prob[lp & 0xFF]
    out = []
    for j, shift in enumerate((8, 16, 24)):
        pslang = (lp >> shift) & 0xFF
        if pslang > 0:
            out.append((pslang, int(entry[5 + j])))
    return out


class Tote:
    """Per-chunk accumulator over 256 per-script language slots (tote.h:36).

    Tracks the in-use mask of 4-slot groups: top-key scans only consider
    touched groups, which matters for zero-score runner-up slots
    (tote.cc:52-99)."""

    def __init__(self):
        self.score = np.zeros(256, dtype=np.int64)
        self.group_used = np.zeros(64, dtype=bool)
        self.score_count = 0

    def reinit(self):
        self.score[:] = 0
        self.group_used[:] = False
        self.score_count = 0

    def add(self, pslang: int, qprob: int):
        self.group_used[pslang >> 2] = True
        self.score[pslang] += qprob

    def top_three_keys(self) -> list[int]:
        """Top-3 in-use slots, lower index wins ties (tote.cc:65-99)."""
        idx = np.flatnonzero(np.repeat(self.group_used, 4))
        if len(idx) == 0:
            return [-1, -1, -1]
        s = self.score[idx]
        order = np.lexsort((idx, -s))
        picks = [int(idx[order[i]]) for i in range(min(3, len(idx)))]
        while len(picks) < 3:
            picks.append(-1)
        return picks


class DocTote:
    """24-slot 3-way set-associative document accumulator (tote.cc:127)."""

    UNUSED = 0xFFFF
    MAX = 24

    def __init__(self):
        self.key = np.full(self.MAX, self.UNUSED, dtype=np.int64)
        self.value = np.zeros(self.MAX, dtype=np.int64)   # byte count
        self.score = np.zeros(self.MAX, dtype=np.int64)
        self.rel = np.zeros(self.MAX, dtype=np.int64)     # reliability*bytes

    def add(self, lang: int, nbytes: int, score: int, reliability: int):
        subs = [lang & 15, (lang & 15) ^ 8, (lang & 7) + 16]
        for s in subs:
            if self.key[s] == lang:
                self.value[s] += nbytes
                self.score[s] += score
                self.rel[s] += reliability * nbytes
                return
        for s in subs:
            if self.key[s] == self.UNUSED:
                alloc = s
                break
        else:
            alloc = min(subs, key=lambda s: self.value[s])
        self.key[alloc] = lang
        self.value[alloc] = nbytes
        self.score[alloc] = score
        self.rel[alloc] = reliability * nbytes

    def find(self, lang: int) -> int:
        hits = np.flatnonzero(self.key == lang)
        return int(hits[0]) if len(hits) else -1

    def sort(self):
        """Stable sort by decreasing byte count (tote.cc:221-250).

        The reference bubble sort swaps only when value[sub] < value[sub2],
        which preserves first-seen order on ties."""
        self.value[self.key == self.UNUSED] = -1
        order = np.argsort(-self.value, kind="stable")
        for arr in (self.key, self.value, self.score, self.rel):
            arr[:] = arr[order]


# ---------------------------------------------------------------------------
# Reliability (cldutil.cc:553-605)
# ---------------------------------------------------------------------------

def reliability_delta(value1: int, value2: int, gramcount: int) -> int:
    max_percent = 100 if gramcount >= 8 else 12 * gramcount
    thresh = min(max(MIN_GRAM_COUNT, (gramcount * 5) >> 3), MAX_GRAM_COUNT)
    delta = value1 - value2
    if delta >= thresh:
        return max_percent
    if delta <= 0:
        return 0
    return min(max_percent, (100 * delta) // thresh)


def reliability_expected(actual_per_kb: int, expected_per_kb: int) -> int:
    if expected_per_kb == 0:
        return 100
    if actual_per_kb == 0:
        return 0
    hi, lo = max(actual_per_kb, expected_per_kb), min(actual_per_kb,
                                                      expected_per_kb)
    ratio = hi / lo
    if ratio <= 1.5:
        return 100
    if ratio > 4.0:
        return 0
    return int(100.0 * (4.0 - ratio) / (4.0 - 1.5))


# ---------------------------------------------------------------------------
# Span scoring
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChunkSummary:
    """Per-chunk result (scoreonescriptspan.h:240-252)."""
    offset: int
    lang1: int
    lang2: int
    score1: int
    score2: int
    bytes: int
    grams: int
    ulscript: int
    reliability_delta: int
    reliability_score: int


class LangBoosts:
    """Rotating 4-slot langprob boost list (scoreonescriptspan.h:70-89)."""

    def __init__(self):
        self.langprob = [0] * MAX_BOOSTS
        self.n = 0

    def add(self, langprob: int):
        self.langprob[self.n] = langprob
        self.n = (self.n + 1) % MAX_BOOSTS


@dataclasses.dataclass
class ResultChunk:
    """Per-range result (compact_lang_det.h:147-154): byte range of the
    ORIGINAL input and its detected language."""
    offset: int
    bytes: int
    lang1: int


UNRELIABLE_PERCENT_THRESHOLD = 75  # scoreonescriptspan.cc:33


@dataclasses.dataclass
class ScoringContext:
    tables: ScoringTables
    registry: Registry
    flags: int = 0
    distinct_boost_latn: LangBoosts = dataclasses.field(default_factory=LangBoosts)
    distinct_boost_othr: LangBoosts = dataclasses.field(default_factory=LangBoosts)
    ulscript: int = 0
    hint_boosts: object = None  # hints.HintBoosts from apply_hints, or None
    # per-chunk records for the result vector, or None when not wanted:
    # (span, round_id, lo_off, nbytes, lang1, lang2, rel_delta, rel_score)
    chunk_records: list | None = None
    round_id: int = 0
    trace: object = None  # debug.DetectionTrace sink, or None

    def distinct_boost(self) -> LangBoosts:
        if self.ulscript == ULSCRIPT_LATIN:
            return self.distinct_boost_latn
        return self.distinct_boost_othr

    def prior_boosts(self) -> list:
        if self.hint_boosts is None:
            return ()
        return self.hint_boosts.boost_latn if \
            self.ulscript == ULSCRIPT_LATIN else self.hint_boosts.boost_othr

    def prior_whacks(self) -> list:
        if self.hint_boosts is None:
            return ()
        return self.hint_boosts.whack_latn if \
            self.ulscript == ULSCRIPT_LATIN else self.hint_boosts.whack_othr


def resolve_indirect(ind: int, base_obj: NgramTable,
                     base_obj2: NgramTable) -> list[int]:
    """Indirect subscript -> 1 or 2 packed langprobs
    (LinearizeAll, scoreonescriptspan.cc:926-964)."""
    obj = base_obj
    if ind & DUAL_TABLE_FLAG:
        obj = base_obj2
        ind &= ~DUAL_TABLE_FLAG
    if ind < obj.size_one:
        lp = int(obj.ind[ind])
        return [lp] if lp > 0 else []
    i = ind + (ind - obj.size_one)
    out = []
    for lp in (int(obj.ind[i]), int(obj.ind[i + 1])):
        if lp > 0:
            out.append(lp)
    return out


def default_langprob(ctx: ScoringContext) -> int:
    """Seed hit: script's default language at qprob 1 (MakeLangProb via
    DefaultLangProb, scoreonescriptspan.cc:846-851, cldutil.cc:610)."""
    lang = ctx.registry.default_language(ctx.ulscript)
    pslang = ctx.registry.per_script_number(ULSCRIPT_LATIN, lang)
    backmap = [0, 0, 1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 66]
    return (pslang << 8) | backmap[1]


def linearize(ctx: ScoringContext, score_cjk: bool,
              base: HitList, delta: HitList, distinct: HitList,
              lowest_offset: int, end_offset: int):
    """Merge-sort hits by offset, resolving indirects to langprobs
    (scoreonescriptspan.cc:856-975). Returns (offsets, types, langprobs)."""
    t = ctx.tables
    if score_cjk:
        base_obj = base_obj2 = t.cjkcompat
        delta_obj, distinct_obj = t.cjkdeltabi, t.distinctbi
        base_hit = UNIHIT
    else:
        base_obj, base_obj2 = t.quadgram, t.quadgram2
        delta_obj, distinct_obj = t.deltaocta, t.distinctocta
        base_hit = QUADHIT

    offs = [lowest_offset]
    types = [base_hit]
    lps = [default_langprob(ctx)]

    bi = di = xi = 0
    bn, dn, xn = len(base.offsets), len(delta.offsets), len(distinct.offsets)
    INF = 1 << 30

    def off(arr, i, n):
        return int(arr.offsets[i]) if i < n else INF

    while bi < bn or di < dn or xi < xn:
        bo, do, xo = off(base, bi, bn), off(delta, di, dn), off(distinct, xi, xn)
        if di < dn and do <= bo and do <= xo:
            lp = int(delta_obj.ind[int(delta.indirects[di])])
            if lp > 0:
                offs.append(do); types.append(DELTAHIT); lps.append(lp)
            di += 1
        elif xi < xn and xo <= bo and xo <= do:
            lp = int(distinct_obj.ind[int(distinct.indirects[xi])])
            if lp > 0:
                offs.append(xo); types.append(DISTINCTHIT); lps.append(lp)
            xi += 1
        else:
            for lp in resolve_indirect(int(base.indirects[bi]), base_obj,
                                       base_obj2):
                offs.append(bo); types.append(base_hit); lps.append(lp)
            bi += 1

    return (np.array(offs, dtype=np.int64), np.array(types, dtype=np.int64),
            np.array(lps, dtype=np.int64), end_offset)


def chunk_boundaries(n_base: int, chunksize: int) -> list[int]:
    """Base-hit counts per chunk with runt merging
    (ChunkAll, scoreonescriptspan.cc:994-1003)."""
    out = []
    left = n_base
    while left > 0:
        if left < chunksize + (chunksize >> 1):
            take = left
        elif left < 2 * chunksize:
            take = (left + 1) >> 1
        else:
            take = chunksize
        out.append(take)
        left -= take
    return out or [0]


def score_span_hits(ctx: ScoringContext, span: ScriptSpan, score_cjk: bool,
                    doc_tote: DocTote):
    """Score a span in hitbuffer rounds of <=1000 base hits, each with its
    own seed hit, chunking, and repeat caches (ScoreCJKScriptSpan /
    ScoreQuadScriptSpan fill loops, scoreonescriptspan.cc:1163-1277)."""
    letter_limit = span.text_bytes
    letter_offset = 1
    while letter_offset < letter_limit:
        if score_cjk:
            base, next_offset = get_uni_hits(span, ctx.tables, letter_offset)
            delta, distinct = get_bi_hits(span, ctx.tables, letter_offset,
                                          next_offset)
        else:
            base, next_offset = get_quad_hits(span, ctx.tables, letter_offset)
            delta, distinct = get_octa_hits(span, ctx.tables, letter_offset,
                                            next_offset)
        _score_round(ctx, span, score_cjk, base, delta, distinct, doc_tote,
                     letter_offset, next_offset)
        ctx.round_id += 1
        if next_offset <= letter_offset:
            break  # no forward progress possible
        letter_offset = next_offset


def _score_round(ctx: ScoringContext, span: ScriptSpan, score_cjk: bool,
                 base: HitList, delta: HitList, distinct: HitList,
                 doc_tote: DocTote, lowest_offset: int, end_offset: int):
    """Linearize + chunk + tote one hitbuffer fill, adding one ChunkSummary
    per chunk to the doc tote (ProcessHitBuffer + ScoreAllHits +
    SummaryBufferToDocTote)."""
    reg = ctx.registry
    t = ctx.tables
    offs, types, lps, end_off = linearize(
        ctx, score_cjk, base, delta, distinct, lowest_offset, end_offset)

    base_hit = UNIHIT if score_cjk else QUADHIT
    chunksize = CHUNKSIZE_UNIS if score_cjk else CHUNKSIZE_QUADS
    is_base = types == base_hit
    n_base = len(base.offsets)

    takes = chunk_boundaries(n_base, chunksize)
    # chunk_start[i] = first linear index of chunk i: advance until
    # `take` base hits consumed (the initial seed entry counts as base)
    chunk_starts = [0]
    li = 0
    nlin = len(offs)
    for take in takes:
        cnt = 0
        while cnt < take and li < nlin:
            if is_base[li]:
                cnt += 1
            li += 1
        chunk_starts.append(li)
    chunk_starts[-1] = nlin

    tote = Tote()
    lg = t.lg_prob
    summaries: list[ChunkSummary] = []
    for ci in range(len(takes)):
        lo_i, hi_i = chunk_starts[ci], chunk_starts[ci + 1]
        tote.reinit()
        for i in range(lo_i, hi_i):
            lp = int(lps[i])
            for pslang, qprob in decode_langprob(lp, lg):
                tote.add(pslang, qprob)
            if types[i] <= QUADHIT:
                tote.score_count += 1
            if types[i] == DISTINCTHIT:
                ctx.distinct_boost().add(lp)
        # ScoreBoosts (scoreonescriptspan.cc:125-152): hint prior boosts,
        # then distinct-word rotating boosts, then close-set whacks
        for lp in ctx.prior_boosts():
            if lp > 0:
                for pslang, qprob in decode_langprob(lp, lg):
                    tote.add(pslang, qprob)
        for lp in ctx.distinct_boost().langprob:
            if lp > 0:
                for pslang, qprob in decode_langprob(lp, lg):
                    tote.add(pslang, qprob)
        for lp in ctx.prior_whacks():
            if lp > 0:
                tote.score[(lp >> 8) & 0xFF] = 0  # ZeroPSLang

        lo_off = int(offs[lo_i])
        hi_off = int(offs[hi_i]) if hi_i < nlin else end_off
        cs = _make_chunk_summary(ctx, tote, lo_off, hi_off - lo_off)
        summaries.append(cs)

    if ctx.chunk_records is not None:
        # vector path only, exactly like the reference (sharpening runs
        # before the DocTote adds, so chunk byte counts shift too;
        # scoreonescriptspan.cc:1099-1111)
        _sharpen_boundaries(ctx, offs, lps, chunk_starts, summaries)
    for cs in summaries:
        doc_tote.add(cs.lang1, cs.bytes, cs.score1,
                     min(cs.reliability_delta, cs.reliability_score))
        if ctx.chunk_records is not None:
            ctx.chunk_records.append(
                (span, ctx.round_id, cs.offset, cs.bytes, cs.lang1,
                 cs.lang2, cs.reliability_delta, cs.reliability_score,
                 False))
        if ctx.trace is not None:
            ctx.trace.add("chunk", offset=cs.offset, bytes=cs.bytes,
                          lang1=cs.lang1, score1=cs.score1,
                          lang2=cs.lang2, score2=cs.score2,
                          grams=cs.grams, rel_delta=cs.reliability_delta,
                          rel_score=cs.reliability_score)


def get_lang_score(lp: int, pslang: int, lg_prob: np.ndarray) -> int:
    """qprob of one pslang within a packed langprob (GetLangScore,
    cldutil.cc:141-152)."""
    entry = lg_prob[lp & 0xFF]
    for j, shift in enumerate((8, 16, 24)):
        if (lp >> shift) & 0xFF == pslang:
            return int(entry[5 + j])
    return 0


def _better_boundary(lps, lg, pslang0: int, pslang1: int,
                     linear0: int, linear1: int, linear2: int) -> int:
    """Sharpest lang0/lang1 split within [linear0, linear2): max of the
    8-wide (+ + + + - - - -) running difference of per-hit score deltas
    (BetterBoundary, scoreonescriptspan.cc:671-734)."""
    if linear2 - linear0 <= 8:
        return linear1
    running = 0
    diff = [0] * 8
    for i in range(linear0, linear0 + 8):
        j = i & 7
        lp = int(lps[i])
        diff[j] = get_lang_score(lp, pslang0, lg) - \
            get_lang_score(lp, pslang1, lg)
        if i < linear0 + 4:
            running += diff[j]
        else:
            running -= diff[j]
    best_value = 0
    best = linear1
    for i in range(linear0, linear2 - 8):
        j = i & 7
        if best_value < running:
            has_plus = any(d > 0 for d in diff)
            has_minus = any(d < 0 for d in diff)
            if has_plus and has_minus:
                best_value = running
                best = i + 4
        lp = int(lps[i + 8])
        newdiff = get_lang_score(lp, pslang0, lg) - \
            get_lang_score(lp, pslang1, lg)
        middiff = diff[(i + 4) & 7]
        olddiff = diff[j]
        diff[j] = newdiff
        running += -olddiff + 2 * middiff - newdiff
    return best


def _sharpen_boundaries(ctx: ScoringContext, offs, lps,
                        chunk_starts: list, summaries: list) -> None:
    """Move chunk boundaries between different-language neighbors to the
    sharpest per-hit score split, shifting the byte counts accordingly
    (SharpenBoundaries, scoreonescriptspan.cc:780-845). Runs only on the
    result-vector path, exactly like the reference."""
    if len(summaries) < 2:
        return
    reg = ctx.registry
    lg = ctx.tables.lg_prob
    prior_linear = chunk_starts[0]
    prior_lang = summaries[0].lang1
    for i in range(1, len(summaries)):
        cs = summaries[i]
        this_lang = cs.lang1
        if this_lang == prior_lang:
            prior_linear = chunk_starts[i]
            continue
        this_linear = chunk_starts[i]
        next_linear = chunk_starts[i + 1]
        if _same_close_set(reg, prior_lang, this_lang):
            prior_linear = this_linear
            prior_lang = this_lang
            continue
        pslang0 = reg.per_script_number(ctx.ulscript, prior_lang)
        pslang1 = reg.per_script_number(ctx.ulscript, this_lang)
        better = _better_boundary(lps, lg, pslang0, pslang1,
                                  prior_linear, this_linear, next_linear)
        old_offset = int(offs[this_linear])
        new_offset = int(offs[better])
        chunk_starts[i] = better
        cs.offset = new_offset
        cs.bytes -= new_offset - old_offset
        summaries[i - 1].bytes += new_offset - old_offset
        prior_linear = better
        prior_lang = this_lang


def _make_chunk_summary(ctx: ScoringContext, tote: Tote, offset: int,
                        nbytes: int) -> ChunkSummary:
    """SetChunkSummary (scoreonescriptspan.cc:60-96)."""
    reg = ctx.registry
    t = ctx.tables
    k3 = tote.top_three_keys()
    lang1 = reg.from_per_script_number(ctx.ulscript, max(k3[0], 0))
    lang2 = reg.from_per_script_number(ctx.ulscript, max(k3[1], 0))
    score1 = int(tote.score[k3[0]]) if k3[0] >= 0 else 0
    score2 = int(tote.score[k3[1]]) if k3[1] >= 0 else 0
    actual_per_kb = (score1 << 10) // nbytes if nbytes > 0 else 0
    expected_per_kb = int(
        t.avg_delta_octa_score[lang1, _lscript4(ctx.ulscript)])
    rd = reliability_delta(score1, score2, tote.score_count)
    if _same_close_set(reg, lang1, lang2):
        rd = 100
    rs = reliability_expected(actual_per_kb, expected_per_kb)
    return ChunkSummary(offset=offset, lang1=lang1, lang2=lang2,
                        score1=score1, score2=score2, bytes=nbytes,
                        grams=tote.score_count, ulscript=ctx.ulscript,
                        reliability_delta=rd, reliability_score=rs)


def _lscript4(ulscript: int) -> int:
    """Script -> {Latn, Cyrl, Arab, Other} index (lang_script.h LScript4)."""
    if ulscript == ULSCRIPT_LATIN:
        return 0
    if ulscript == 3:   # Cyrillic
        return 1
    if ulscript == 6:   # Arabic
        return 2
    return 3


def _same_close_set(reg: Registry, lang1: int, lang2: int) -> bool:
    s1 = reg.close_set(lang1)
    return s1 != 0 and s1 == reg.close_set(lang2)


# ---------------------------------------------------------------------------
# Document-level pipeline
# ---------------------------------------------------------------------------

def score_one_span(ctx: ScoringContext, span: ScriptSpan, doc_tote: DocTote):
    """ScoreOneScriptSpan (scoreonescriptspan.cc:1302)."""
    reg = ctx.registry
    ctx.ulscript = span.ulscript
    rtype = reg.rtype(span.ulscript)
    if (ctx.flags & FLAG_SCORE_AS_QUADS) and rtype != RTYPE_CJK:
        rtype = RTYPE_MANY
    if rtype in (RTYPE_NONE, RTYPE_ONE):
        lang = reg.default_language(span.ulscript)
        doc_tote.add(lang, span.text_bytes, span.text_bytes, 100)
        if ctx.chunk_records is not None:
            # JustOneItemToVector (scoreonescriptspan.cc:513-548): offsets
            # map straight through ItemToVector — no word-boundary trim,
            # no reliability/close-set relabeling
            ctx.chunk_records.append(
                (span, ctx.round_id, 1, span.text_bytes - 1, lang,
                 UNKNOWN_LANGUAGE, 100, 100, True))
            ctx.round_id += 1
        if ctx.trace is not None:
            # vector-record view: [1, text_bytes) like JustOneItemToVector
            ctx.trace.add("chunk", offset=1, bytes=span.text_bytes - 1,
                          lang1=lang, score1=span.text_bytes,
                          lang2=UNKNOWN_LANGUAGE, score2=0, grams=0,
                          rel_delta=100, rel_score=100)
    else:
        score_span_hits(ctx, span, rtype == RTYPE_CJK, doc_tote)


def refine_close_pairs(reg: Registry, doc_tote: DocTote):
    """Winner-take-all within close sets (RefineScoredClosePairs,
    compact_lang_det_impl.cc:1154-1203)."""
    for sub in range(DocTote.MAX):
        lang = int(doc_tote.key[sub])
        if lang == DocTote.UNUSED:
            continue
        cs = reg.close_set(lang)
        if cs == 0:
            continue
        for sub2 in range(sub + 1, DocTote.MAX):
            lang2 = int(doc_tote.key[sub2])
            if lang2 == DocTote.UNUSED or reg.close_set(lang2) != cs:
                continue
            frm, to = (sub, sub2) if doc_tote.value[sub] < doc_tote.value[sub2] \
                else (sub2, sub)
            doc_tote.value[to] += doc_tote.value[frm]
            doc_tote.score[to] += doc_tote.score[frm]
            doc_tote.rel[to] += doc_tote.rel[frm]
            doc_tote.key[frm] = DocTote.UNUSED
            doc_tote.value[frm] = 0
            doc_tote.score[frm] = 0
            doc_tote.rel[frm] = 0
            break


def remove_unreliable(reg: Registry, doc_tote: DocTote):
    """Merge/delete languages below 41% reliability
    (RemoveUnreliableLanguages, compact_lang_det_impl.cc:997-1101)."""
    for sub in range(DocTote.MAX):
        lang = int(doc_tote.key[sub])
        if lang == DocTote.UNUSED:
            continue
        nbytes = int(doc_tote.value[sub])
        if nbytes == 0:
            continue
        pct = int(doc_tote.rel[sub]) // nbytes
        if pct >= MIN_RELIABLE_KEEP_PERCENT:
            continue
        alt = reg.closest_alt(lang)
        if alt == UNKNOWN_LANGUAGE:
            continue
        altsub = doc_tote.find(alt)
        if altsub < 0:
            continue
        bytes2 = int(doc_tote.value[altsub])
        if bytes2 == 0:
            continue
        pct2 = int(doc_tote.rel[altsub]) // bytes2
        tosub, fromsub = (altsub, sub)
        if pct2 < pct or (pct2 == pct and lang < alt):
            tosub, fromsub = (sub, altsub)
        newpct = max(pct, pct2, MIN_RELIABLE_KEEP_PERCENT)
        newbytes = nbytes + bytes2
        doc_tote.key[fromsub] = DocTote.UNUSED
        doc_tote.score[fromsub] = 0
        doc_tote.rel[fromsub] = 0
        doc_tote.score[tosub] = newbytes   # reference stores bytes via SetScore
        doc_tote.rel[tosub] = newpct * newbytes

    for sub in range(DocTote.MAX):
        lang = int(doc_tote.key[sub])
        if lang == DocTote.UNUSED:
            continue
        nbytes = int(doc_tote.value[sub])
        if nbytes == 0:
            continue
        pct = int(doc_tote.rel[sub]) // nbytes
        if pct < MIN_RELIABLE_KEEP_PERCENT:
            doc_tote.key[sub] = DocTote.UNUSED
            doc_tote.score[sub] = 0
            doc_tote.rel[sub] = 0


def extract_lang_etc(doc_tote: DocTote, total_text_bytes: int):
    """Top-3 languages, percents, scores (ExtractLangEtc,
    compact_lang_det_impl.cc:1276-1384)."""
    lang3 = [UNKNOWN_LANGUAGE] * 3
    percent3 = [0] * 3
    rel3 = [0] * 3
    ns3 = [0.0] * 3
    bc = [0] * 3
    for i in range(3):
        lang = int(doc_tote.key[i])
        if lang != DocTote.UNUSED and lang != UNKNOWN_LANGUAGE:
            lang3[i] = lang
            bc[i] = int(doc_tote.value[i])
            rel3[i] = int(doc_tote.rel[i]) // max(bc[i], 1)
            # GetNormalizedScore does C integer division (impl.cc:1269-1273)
            ns3[i] = float((int(doc_tote.score[i]) << 10) // bc[i]) \
                if bc[i] else 0.0

    total12 = bc[0] + bc[1]
    total123 = total12 + bc[2]
    total = max(total_text_bytes, total123)
    div = max(1, total)
    percent3[0] = bc[0] * 100 // div
    percent3[1] = total12 * 100 // div
    percent3[2] = total123 * 100 // div
    percent3[2] -= percent3[1]
    percent3[1] -= percent3[0]
    if percent3[1] < percent3[2]:
        percent3[1] += 1
        percent3[2] -= 1
    if percent3[0] < percent3[1]:
        percent3[0] += 1
        percent3[1] -= 1

    is_reliable = False
    if lang3[0] != UNKNOWN_LANGUAGE:
        is_reliable = rel3[0] >= MIN_RELIABLE_KEEP_PERCENT
    ignore_percent = 100 - sum(percent3)
    if ignore_percent > IGNORE_MAX_PERCENT:
        is_reliable = False
    return lang3, percent3, rel3, ns3, total, is_reliable


def _is_figs(lang: int, reg: Registry) -> bool:
    return reg.code(lang) in ("fr", "it", "de", "es")


def _is_efigs(lang: int, reg: Registry) -> bool:
    return lang == ENGLISH or _is_figs(lang, reg)


def calc_summary_lang(reg: Registry, lang3, percent3, total_text_bytes: int,
                      is_reliable: bool, flags: int):
    """CalcSummaryLang (compact_lang_det_impl.cc:1414-1522)."""
    slot = [0, 1, 2]
    slot_count = 3
    ignore_percent = 0
    return_percent = percent3[0]
    summary = lang3[0]
    reliable = True
    if percent3[0] < KEEP_MIN_PERCENT:
        reliable = False

    for i in range(3):
        if lang3[i] == TG_UNKNOWN_LANGUAGE:
            ignore_percent += percent3[i]
            for j in range(i + 1, 3):
                slot[j - 1] = slot[j]
            slot_count -= 1
            return_percent = (percent3[0] * 100) // (101 - ignore_percent)
            summary = lang3[slot[0]]
            if percent3[slot[0]] < KEEP_MIN_PERCENT:
                reliable = False

    second_bytes = (total_text_bytes * percent3[slot[1]]) // 100
    if (lang3[slot[0]] == ENGLISH and lang3[slot[1]] != ENGLISH and
            lang3[slot[1]] != UNKNOWN_LANGUAGE and
            percent3[slot[1]] >= NON_EN_BOILERPLATE_MIN_PERCENT and
            second_bytes >= GOOD_SECOND_T1T2_MIN_BYTES):
        ignore_percent += percent3[slot[0]]
        return_percent = (percent3[slot[1]] * 100) // (101 - ignore_percent)
        summary = lang3[slot[1]]
        if percent3[slot[1]] < KEEP_MIN_PERCENT:
            reliable = False
    elif (_is_figs(lang3[slot[0]], reg) and
          not _is_efigs(lang3[slot[1]], reg) and
          lang3[slot[1]] != UNKNOWN_LANGUAGE and
          percent3[slot[1]] >= NON_FIGS_BOILERPLATE_MIN_PERCENT and
          second_bytes >= GOOD_SECOND_T1T2_MIN_BYTES):
        ignore_percent += percent3[slot[0]]
        return_percent = (percent3[slot[1]] * 100) // (101 - ignore_percent)
        summary = lang3[slot[1]]
        if percent3[slot[1]] < KEEP_MIN_PERCENT:
            reliable = False
    elif lang3[slot[1]] == ENGLISH and lang3[slot[0]] != ENGLISH:
        ignore_percent += percent3[slot[1]]
        return_percent = (percent3[slot[0]] * 100) // (101 - ignore_percent)
    elif (_is_figs(lang3[slot[1]], reg) and
          not _is_efigs(lang3[slot[0]], reg)):
        ignore_percent += percent3[slot[1]]
        return_percent = (percent3[slot[0]] * 100) // (101 - ignore_percent)

    if return_percent < GOOD_FIRST_MIN_PERCENT and \
            not (flags & FLAG_BEST_EFFORT):
        summary = UNKNOWN_LANGUAGE
        reliable = False
    if return_percent < GOOD_FIRST_RELIABLE_MIN_PERCENT:
        reliable = False
    ignore_percent = 100 - sum(percent3)
    if ignore_percent > IGNORE_MAX_PERCENT:
        reliable = False
    if slot_count == 0:
        summary = UNKNOWN_LANGUAGE
        reliable = False
    return summary, (is_reliable and reliable)


@dataclasses.dataclass
class ScalarResult:
    summary_lang: int
    language3: list
    percent3: list
    normalized_score3: list
    text_bytes: int
    is_reliable: bool
    chunks: list | None = None  # ResultChunk vector when requested
    # per-span verdicts [(byte_offset, byte_len, code, pct, reliable)]
    # — filled only by the LDT_SPANS surfaces (engine detect_spans /
    # detector span synthesis); None everywhere else
    spans: list | None = None


# -- per-span output (LDT_SPANS) --------------------------------------------
#
# The span contract (docs/ACCURACY.md): spans TILE the document's bytes.
# Sub-document k's scored extent starts at its first letter char, so
# span 0 pulls its start back to byte 0, span k ends where span k+1
# starts, and the last span ends at the document's last byte —
# non-letter gaps between scored extents attach to the preceding span.
# The default split budget matches the pack ladder's mid tier (~4KB of
# text per span group).

SPAN_SPLIT_SLOTS = 1024


def span_coverage_records(text: str, bounds: list,
                          verdicts: list) -> list:
    """(char extents, per-sub verdicts) -> covering span records
    [(byte_offset, byte_len, code, pct, reliable)]. bounds[k] = (a, b)
    char extent of sub-doc k (split_longdoc want_bounds); verdicts[k] =
    (code, pct, reliable). Shared between the batched engine's span
    lane and the scalar oracle so both emit byte-identical records."""
    n = len(bounds)
    starts = [0] + [bounds[k][0] for k in range(1, n)]
    ends = starts[1:] + [len(text)]
    spans = []
    off = 0
    for k in range(n):
        seg = text[starts[k]:ends[k]]
        blen = len(seg.encode("utf-8", "surrogatepass"))
        code, pct, rel = verdicts[k]
        spans.append((off, blen, code, pct, rel))
        off += blen
    return spans


def split_for_spans(text: str, tables, split_slots: int,
                    segment=None):
    """(subs, bounds) for the span surfaces: the long-doc lane's
    span-aligned split (the only exact split points), or one whole-doc
    span when the document is under budget / refuses to split.
    segment: split_longdoc's span scan (None: the Python scan)."""
    from .preprocess.pack import split_longdoc
    got = split_longdoc(text, tables, max(split_slots, 1),
                        want_bounds=True, segment=segment)
    if not got:
        return [text], [(0, len(text))]
    return got


def detect_scalar_spans(text: str, tables, reg, flags: int = 0,
                        split_slots: int = SPAN_SPLIT_SLOTS
                        ) -> "ScalarResult":
    """Scalar oracle for the LDT_SPANS surface: the same span-aligned
    split as the batched engine's span lane, each sub-document through
    detect_scalar, records via the shared coverage builder. The batched
    lane resolves every exception sub-doc through detect_scalar and
    agrees with it everywhere else (the engine's core invariant), so
    its spans are bit-identical to this function's by construction
    (tests/test_spans.py pins it)."""
    subs, bounds = split_for_spans(text, tables, split_slots)
    res = detect_scalar(text, tables, reg, flags)
    verdicts = []
    for sub in subs:
        r = detect_scalar(sub, tables, reg, flags)
        verdicts.append((reg.code(r.summary_lang), int(r.percent3[0]),
                         bool(r.is_reliable)))
    res.spans = span_coverage_records(text, bounds, verdicts)
    return res


def _respan(text_bytes: bytes, ulscript: int,
            src_idx: np.ndarray | None = None) -> ScriptSpan:
    """Rebuild a ScriptSpan around squeezed/stripped span text. src_idx is
    carried through only for the length-preserving Overwrite rewrites,
    where byte offsets still map to the original input."""
    buf = np.zeros(len(text_bytes) + 32, dtype=np.uint8)
    buf[:len(text_bytes)] = np.frombuffer(text_bytes, dtype=np.uint8)
    buf[len(text_bytes):len(text_bytes) + 3] = 0x20
    cps = np.frombuffer(
        text_bytes.decode("utf-8", errors="replace").encode("utf-32-le"),
        dtype=np.uint32)
    return ScriptSpan(buf=buf, text_bytes=len(text_bytes), ulscript=ulscript,
                      cps=np.concatenate([cps, [0x20]]).astype(np.uint32),
                      src_idx=src_idx)


def build_result_chunks(orig_text: str, records: list, reg: Registry,
                        html_offsets=None) -> list:
    """Chunk records -> merged ResultChunk vector over ORIGINAL byte
    offsets (SummaryBufferToVector scoreonescriptspan.cc:389-509 +
    ItemToVector :341-378 + FinishResultVector impl.cc:1688-1704).

    Offset mapping composes the span src_idx arrays (span-buffer byte ->
    segmenter-input char), the optional HTML clean-text offset map
    (clean char -> original char), and the original text's char->byte
    cumsum — the index-array equivalent of the reference's composed
    OffsetMaps (offsetmap.cc:428-496). The merge itself runs in
    merge_mapped_records, shared with the batched engine's chunk-vector
    path (which arrives with offsets already mapped)."""
    raw = orig_text.encode("utf-8", "surrogatepass")
    cps = np.frombuffer(orig_text.encode("utf-32-le", "surrogatepass"),
                        np.uint32)
    from .preprocess.segment import utf8_len_of_cps
    byte_of_char = np.zeros(len(cps) + 1, np.int64)
    if len(cps):
        np.cumsum(utf8_len_of_cps(cps), out=byte_of_char[1:])

    def map_back(span, off):
        src = int(span.src_idx[min(off, len(span.src_idx) - 1)])
        if html_offsets is not None:
            src = int(html_offsets[min(src, len(html_offsets) - 1)]) \
                if len(html_offsets) else 0
        return int(byte_of_char[min(src, len(byte_of_char) - 1)])

    # map ends lazily: merge_mapped_records consults `end` only for the
    # final record (consecutive chunks are contiguous)
    mapped = [(rid,
               map_back(span, lo),
               map_back(span, lo + nbytes) if i == len(records) - 1
               else 0,
               lang1, lang2, rd, rs, is_one)
              for i, (span, rid, lo, nbytes, lang1, lang2, rd, rs,
                      is_one) in enumerate(records)]
    return merge_mapped_records(raw, mapped, reg)


def merge_mapped_records(raw: bytes, records: list, reg: Registry) -> list:
    """Mapped chunk records -> merged ResultChunk vector. records:
    (rid, start, end, lang1, lang2, rd, rs, is_one) with start/end in
    ORIGINAL byte offsets; `end` is consulted only for the final record
    (the reference's continuous offset maps make consecutive chunks
    contiguous, so every other end IS the next record's start). The
    word-boundary trim, reliability/close-set relabeling, same-language
    merge, and FinishResultVector semantics live here, shared verbatim
    between the scalar engine and the batched engine's vector path."""
    raw_starts = [start for _, start, *_ in records]
    vec: list = []
    for i, (rid, start, end_mapped, lang1, lang2, rd, rs, is_one) in \
            enumerate(records):
        mapped_offset = raw_starts[i]
        # Trim back to a word boundary (scoreonescriptspan.cc:419-460);
        # JustOneItem records skip the trim (scoreonescriptspan.cc:513-548)
        if mapped_offset > 0 and not is_one:
            prior_size = vec[-1].bytes if vec else 0
            n_limit = min(prior_size - 3, mapped_offset, 12)
            n = 0
            while n < n_limit and raw[mapped_offset - n - 1] >= 0x41:
                n += 1
            if n >= n_limit:
                n = 0
            if n < n_limit and \
                    raw[mapped_offset - n - 1:mapped_offset - n] in \
                    (b"'", b'"', b"#", b"@"):
                n += 1
            if n > 0 and vec:
                vec[-1].bytes -= n
                mapped_offset -= n
        end = raw_starts[i + 1] if i + 1 < len(records) \
            else end_mapped
        mapped_len = end - mapped_offset

        new_lang = lang1
        if not is_one:
            # reliability / close-set relabeling (SummaryBufferToVector,
            # scoreonescriptspan.cc:462-505); JustOneItem records bypass it
            rd_bad = rd < UNRELIABLE_PERCENT_THRESHOLD
            rs_bad = rs < UNRELIABLE_PERCENT_THRESHOLD
            prior_lang = vec[-1].lang1 if vec else UNKNOWN_LANGUAGE
            if prior_lang == lang1:
                rd_bad = False
            if _same_close_set(reg, lang1, prior_lang):
                new_lang = prior_lang
                rd_bad = False
            if _same_close_set(reg, lang1, lang2) and prior_lang == lang2:
                new_lang = prior_lang
                rd_bad = False
            # next chunk's lang1, within the same hitbuffer round only
            next_lang = records[i + 1][3] if i + 1 < len(records) and \
                records[i + 1][0] == rid else UNKNOWN_LANGUAGE
            if rd_bad and prior_lang == lang2 and next_lang == lang2:
                new_lang = prior_lang
                rd_bad = False
            if rd_bad or rs_bad:
                new_lang = UNKNOWN_LANGUAGE

        # ItemToVector: extend the prior entry on same language
        if vec and vec[-1].lang1 == new_lang:
            vec[-1].bytes = (mapped_offset + mapped_len) - vec[-1].offset
        else:
            vec.append(ResultChunk(offset=mapped_offset, bytes=mapped_len,
                                   lang1=new_lang))

    # FinishResultVector: cover [0, len) exactly
    if vec:
        if vec[0].offset > 0:
            vec[0].bytes += vec[0].offset
            vec[0].offset = 0
        last = vec[-1]
        if last.offset + last.bytes < len(raw):
            last.bytes = len(raw) - last.offset
    return vec


def detect_scalar(text: str, tables: ScoringTables | None = None,
                  reg: Registry | None = None,
                  flags: int = 0, is_plain_text: bool = True,
                  hints=None, want_chunks: bool = False,
                  _hint_boosts=None, _vec_src=None,
                  _trace=None) -> ScalarResult:
    """Full-document detection (DetectLanguageSummaryV2,
    compact_lang_det_impl.cc:1707-2106), including the squeeze/repeat
    anti-spam recursion. is_plain_text=False strips HTML tags / expands
    entities first (preprocess/html.py). hints is an optional
    hints.CLDHints; HTML lang= attributes are always scanned for
    non-plain text (ApplyHints, impl.cc:1587)."""
    tables = tables or load_tables()
    reg = reg or default_registry
    if _hint_boosts is None and (hints is not None or not is_plain_text):
        from .hints import apply_hints
        _hint_boosts = apply_hints(text, is_plain_text, hints, tables, reg)
    if _vec_src is None:
        orig_text = text
        html_offsets = None
        if not is_plain_text:
            from .preprocess.html import clean_html
            text, html_offsets = clean_html(text, tables)
        # Recursive passes receive the already-cleaned text plus this
        # mapping context so result chunks always cover the ORIGINAL input
        _vec_src = (orig_text, html_offsets)
    else:
        orig_text, html_offsets = _vec_src
    # When chunks are wanted, squeeze/repeat-strip switch to the
    # length-preserving Overwrite rewrites so span offsets keep mapping to
    # the original input (impl.cc:1856-1862, :1908-1916) — detection then
    # scores the dotted text, exactly as the reference's vector path does.
    collect = want_chunks
    if _trace is not None:
        _trace.add("pass", flags=flags)
    ctx = ScoringContext(tables=tables, registry=reg, flags=flags,
                         hint_boosts=_hint_boosts,
                         chunk_records=[] if collect else None,
                         trace=_trace)
    doc_tote = DocTote()
    total_text_bytes = 0
    if flags & FLAG_REPEATS:
        rep_hash = [0]
        predict_tbl = np.zeros(PREDICTION_TABLE_SIZE, dtype=np.int64)
    for span in segment_text(text, tables):
        if flags & FLAG_SQUEEZE:
            # Remove repetitive or mostly-space chunks (impl.cc:1852-1864)
            if collect:
                dotted = cheap_squeeze_overwrite(span.buf.tobytes(),
                                                 span.text_bytes)
                span = _respan(dotted, span.ulscript, src_idx=span.src_idx)
            else:
                squeezed = cheap_squeeze(span.buf.tobytes(), span.text_bytes)
                span = _respan(squeezed, span.ulscript)
        elif (TEST_THRESH >> 1) < span.text_bytes and \
                not (flags & FLAG_FINISH):
            # Should the whole doc be re-scanned with squeezing on?
            # (impl.cc:1866-1901)
            if cheap_squeeze_trigger_test(span.buf.tobytes(),
                                          span.text_bytes):
                return detect_scalar(text, tables, reg,
                                     flags | FLAG_SQUEEZE,
                                     want_chunks=want_chunks,
                                     _hint_boosts=_hint_boosts,
                                     _vec_src=_vec_src, _trace=_trace)
        if flags & FLAG_REPEATS:
            # Remove repeated words (impl.cc:1905-1918)
            if collect:
                dotted = cheap_rep_words_overwrite(
                    span.buf.tobytes(), span.text_bytes, rep_hash,
                    predict_tbl)
                span = _respan(dotted, span.ulscript, src_idx=span.src_idx)
            else:
                stripped = cheap_rep_words(span.buf.tobytes(),
                                           span.text_bytes,
                                           rep_hash, predict_tbl)
                span = _respan(stripped, span.ulscript)
        if _trace is not None:
            _trace.add("span", script=span.ulscript,
                       bytes=span.text_bytes,
                       rtype=reg.rtype(span.ulscript))
        score_one_span(ctx, span, doc_tote)
        total_text_bytes += span.text_bytes

    if _trace is not None:
        _trace.add_tote("scored", doc_tote, reg)
    refine_close_pairs(reg, doc_tote)
    doc_tote.sort()
    if _trace is not None:
        _trace.add_tote("close_pairs_refined", doc_tote, reg)
    lang3, percent3, rel3, ns3, total, is_reliable = extract_lang_etc(
        doc_tote, total_text_bytes)

    good = (flags & FLAG_FINISH) or total <= SHORT_TEXT_THRESH or \
        (is_reliable and percent3[0] >= GOOD_LANG1_PERCENT) or \
        (is_reliable and percent3[0] + percent3[1] >= GOOD_LANG1AND2_PERCENT)

    if not good:
        # Refine with repeat-stripping and a forced finish
        # (compact_lang_det_impl.cc:2061-2105; Top40/Short/UseWords are
        # vestigial in this CLD2 version -- only Repeats/Finish act).
        extra = FLAG_TOP40 | FLAG_REPEATS | FLAG_FINISH
        if total < SHORT_TEXT_THRESH:
            extra |= FLAG_SHORT | FLAG_USE_WORDS
        return detect_scalar(text, tables, reg, flags | extra,
                             want_chunks=want_chunks,
                             _hint_boosts=_hint_boosts, _vec_src=_vec_src,
                             _trace=_trace)

    if not (flags & FLAG_BEST_EFFORT):
        remove_unreliable(reg, doc_tote)
        if _trace is not None:
            _trace.add_tote("unreliable_removed", doc_tote, reg)
    doc_tote.sort()
    lang3, percent3, rel3, ns3, total, is_reliable = extract_lang_etc(
        doc_tote, total_text_bytes)
    summary, reliable = calc_summary_lang(reg, lang3, percent3, total,
                                          is_reliable, flags)
    if _trace is not None:
        _trace.add("summary", lang=summary, reliable=reliable,
                   top3=list(zip(lang3, percent3)), text_bytes=total)
    chunks = build_result_chunks(orig_text, ctx.chunk_records, reg,
                                 html_offsets) if collect else None
    return ScalarResult(summary_lang=summary, language3=lang3,
                        percent3=percent3, normalized_score3=ns3,
                        text_bytes=total, is_reliable=reliable,
                        chunks=chunks)


def result_from_epilogue_row(row) -> ScalarResult:
    """ldt_epilogue_flat [14]-lane row -> ScalarResult (shared by the
    batched engine's retry path and the all-C detect() fast path —
    lives here so the C path needs no jax import)."""
    return ScalarResult(
        summary_lang=int(row[0]),
        language3=[int(row[1]), int(row[2]), int(row[3])],
        percent3=[int(row[4]), int(row[5]), int(row[6])],
        normalized_score3=[float(row[7]), float(row[8]), float(row[9])],
        text_bytes=int(row[10]),
        is_reliable=bool(row[11]))
