"""Host-side batch packer: texts -> fixed-shape candidate tensors.

The TPU engine's front half. For each document the host performs the
inherently sequential byte work (segmentation, gram positions, fingerprints,
the hash-only word repeat filter, squeeze triggers) and emits a *linear
candidate list* in the exact merge order the scalar engine scores hits
(delta <= distinct <= base at equal offsets, seed first). The device then
probes tables, applies the hit-dependent quad repeat filter, assigns chunks,
and reduces — all in fixed [B, L] shapes.

Documents that exceed the slot budget or need multiple hitbuffer rounds per
span are flagged for the scalar fallback path (the long tail; service
traffic is short).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np

from ..registry import (RTYPE_CJK, RTYPE_MANY, RTYPE_NONE, RTYPE_ONE,
                        ULSCRIPT_LATIN, Registry)
from ..tables import ScoringTables
from .grams import MAX_SCORING_HITS, quad_positions, word_positions
from .hashing import bi_hash_v2, octa_hash40, pair_hash, quad_hash_v2
from .segment import ScriptSpan, segment_text, utf8_len_of_cps
from .squeeze import TEST_THRESH, cheap_squeeze_trigger_test

# Candidate kinds (device dispatch)
PAD, SEED, QUAD, UNI, DELTA_OCTA, DISTINCT_OCTA, BI_DELTA, BI_DISTINCT = \
    range(8)

# -- shape-tier ladder (bucketed batch scheduler) ---------------------------
#
# The scheduler in models/ngram.py partitions large streams by estimated
# per-doc slot demand into a small fixed ladder of dispatch lanes, so the
# ~160-byte median service doc shares padded shapes with its peers instead
# of with the 100KB tail. Budgets are SLOT counts (the wire's padded unit);
# the estimate is deliberately cheap — one len() per doc — because it runs
# on the packing hot path. ~1 candidate slot per 4 text chars holds across
# the corpus mix (Latin quads + word grams dominate), plus a fixed floor
# for the per-span seed/dummy slots of short docs.
#
# Two budgets -> three tiers:
#   short  <= 128 slots  (~0.5KB of text: tweets, chat, the service median)
#   mid    <= 1024 slots (~4KB: articles, product pages)
#   long   everything else (the heavy tail gets its own lane)
SLOT_TIER_BUDGETS = (128, 1024)
TIER_NAMES = ("short", "mid", "long")
N_TIERS = len(SLOT_TIER_BUDGETS) + 1
_TIER_BASE_SLOTS = 8


def est_slot_demand(text: str) -> int:
    """Cheap per-doc slot-demand estimate for tier routing: a fixed
    per-span floor plus ~1 slot per 4 chars. Routing only — the packer
    still computes exact n_slots; a misrouted doc just pads a little
    more, it can never change results."""
    return _TIER_BASE_SLOTS + (len(text) >> 2)


def tier_of_text(text: str) -> int:
    """Tier index (0..N_TIERS-1) for a document."""
    est = est_slot_demand(text)
    for k, budget in enumerate(SLOT_TIER_BUDGETS):
        if est <= budget:
            return k
    return N_TIERS - 1


def tier_max_chars(k: int) -> int:
    """Largest text length (in chars) routed to tier k — the exact
    bucket boundary, for boundary-parity tests and the soak."""
    return (SLOT_TIER_BUDGETS[k] - _TIER_BASE_SLOTS) * 4 + 3

# Kinds that count as base hits (chunk quota; UNIHIT/QUADHIT analogue)
BASE_KINDS = (SEED, QUAD, UNI)


# -- long-document span splitting (the longdoc lane) ------------------------
#
# Documents whose slot demand exceeds the top shape bucket serialize the
# lane they ride (one 100KB doc costs as much wire as 600 tweets). The
# engine splits them into sub-documents at SCRIPT-SPAN boundaries so each
# sub-pack is ordinary bucket-ladder work, then merges the per-chunk score
# rows back into one document summary (result_vector.merge_longdoc_chunks).
# Span boundaries are the only exact split points: chunk assignment, the
# octa repeat cache, and word-pair hashes all reset at a span edge, so a
# sub-document packs chunk-for-chunk identically to its slice of the
# unsplit document. Splitting inside a span would drop cross-word pair
# candidates and shift chunk boundaries — never exact — so single-span
# documents (monolingual text under the scanner's ~40KB span cap) ride
# their tier unsplit.

def _maybe_multi_span(text: str, tables) -> bool:
    """Cheap vectorized pre-filter: can this text segment into more than
    one script span? One span is certain when the letters are a single
    script and the text sits under the scanner's span cap — the common
    monolingual long doc, which must not pay the Python span scan."""
    from .segment import MAX_SPAN_PUT_BYTES, _decode_utf32
    cps = _decode_utf32(text)
    if len(cps) == 0:
        return False
    scripts = tables.script_of_cp[np.minimum(cps, 0x10FFFF)]
    letters = scripts[(scripts != 0) & (scripts != 40)]  # 40 = Inherited
    if len(letters) == 0:
        return False
    if letters.min() != letters.max():
        return True  # two scripts -> at least two spans possible
    # single script: multiple spans only if the scanner's cap can split
    return len(text.encode("utf-8", "surrogatepass")) >= MAX_SPAN_PUT_BYTES


class SpanExtent(NamedTuple):
    """What split_longdoc reads of one script span: the source char
    index of its first letter, one past the source char of its closing
    separator (so text[start:end] holds the span), its ULScript, and its
    buffer bytes [0, text_bytes)."""
    start: int
    end: int
    ulscript: int
    text: bytes


def span_extents(text: str, tables: ScoringTables) -> list[SpanExtent]:
    """segment_text's spans as SpanExtents (the Python scan; the native
    packer's twin is native.span_extents_native)."""
    return [SpanExtent(int(sp.src_idx[1]), int(sp.src_idx[-1]) + 1,
                       sp.ulscript, sp.text)
            for sp in segment_text(text, tables)]


def split_longdoc(text: str, tables: ScoringTables,
                  max_slots: int,
                  want_bounds: bool = False,
                  segment: Callable[[str], list[SpanExtent]] | None = None,
                  spans: list[SpanExtent] | None = None
                  ) -> list[str] | None:
    """Split one oversized document into span-aligned sub-documents of
    about `max_slots` estimated slots each. Returns the sub-texts (>= 2,
    source-order slices of `text`), or None when the document cannot be
    split exactly (single span, or re-segmentation of a slice would not
    reproduce the document's own spans). want_bounds=True returns
    (subs, bounds) instead, bounds[i] = (a, b) char extent of subs[i]
    in `text` (subs[i] == text[a:b]) — the LDT_SPANS surface derives
    span byte offsets from these; None still means "cannot split".

    Exactness contract: each returned slice re-segments into exactly the
    spans the full document produced for that range, so packing the
    sub-documents yields the same per-span candidates and chunk layout
    as the unsplit pack. Slices under the scanner's span cap are exact
    by construction (no soft-limit or truncation rule can fire inside
    them); larger slices are verified by re-segmentation and the whole
    split is abandoned on any mismatch.

    segment: the span scan, text -> SpanExtents; None runs the Python
    scan (span_extents), the engine passes the native packer's. spans:
    segment(text), when the caller has scanned the text already."""
    from .segment import SOFT_SPAN_PUT_BYTES
    if max_slots <= 0 or est_slot_demand(text) <= max_slots:
        return None
    if not _maybe_multi_span(text, tables):
        return None
    if segment is None:
        def segment(t):
            return span_extents(t, tables)
    if spans is None:
        spans = segment(text)
    if len(spans) < 2:
        return None

    # source-char extent of each span (the closing separator's source is
    # the first char past the last letter run, so end is exclusive)
    extents = [(sp.start, sp.end) for sp in spans]

    # greedy grouping toward the per-sub-doc char budget; a span bigger
    # than the budget (e.g. a scanner-capped 40KB run) is its own group
    budget_chars = max(1, (max_slots - _TIER_BASE_SLOTS) * 4)
    groups: list[list[int]] = [[]]
    cur_chars = 0
    for i, (s0, s1) in enumerate(extents):
        span_chars = s1 - s0
        if groups[-1] and cur_chars + span_chars > budget_chars:
            groups.append([])
            cur_chars = 0
        groups[-1].append(i)
        cur_chars += span_chars
    if len(groups) < 2:
        return None

    subs = []
    bounds = []
    for g in groups:
        a = extents[g[0]][0]
        b = extents[g[-1]][1]
        sub = text[a:b]
        # consecutive same-script spans exist only where a scanner size
        # rule fired; re-segmenting the slice without that rule would
        # merge them, so they always need the verify pass
        same_script_pair = any(
            spans[i].ulscript == spans[j].ulscript
            for i, j in zip(g, g[1:]))
        if same_script_pair or \
                len(sub.encode("utf-8", "surrogatepass")) >= \
                SOFT_SPAN_PUT_BYTES:
            # the scanner's soft-limit / even-split rules could fire
            # inside a slice this big: verify the slice reproduces the
            # document's own spans, else refuse to split
            re_spans = segment(sub)
            if len(re_spans) != len(g):
                return None
            for rs, i in zip(re_spans, g):
                os_ = spans[i]
                if rs.ulscript != os_.ulscript or rs.text != os_.text:
                    return None
        subs.append(sub)
        bounds.append((a, b))
    return (subs, bounds) if want_bounds else subs


@dataclasses.dataclass
class PackedBatch:
    """Fixed-shape candidate tensors for one batch of documents."""

    # Per-slot arrays [B, L]
    kind: np.ndarray          # int8 candidate kind
    offset: np.ndarray        # int32 span-buffer offset
    fp: np.ndarray            # uint32 fingerprint low 32 bits / direct
                              # payload (seed langprob, uni compat class)
    fp_hi: np.ndarray         # uint8 bits 32-39 of the 40-bit octa hash
    chunk_base: np.ndarray    # int32 first chunk id of the slot's span
    span_start: np.ndarray    # int32 first slot index of the slot's span
    span_end_off: np.ndarray  # int32 span end offset (dummy entry offset)
    side: np.ndarray          # int8 0=latn 1=othr boost stream
    cjk: np.ndarray           # int8 1 if CJK-scored span
    script: np.ndarray        # int16 span ULScript
    # Per-chunk arrays [B, C]
    chunk_script: np.ndarray  # int16 ULScript of the chunk's span
    chunk_cjk: np.ndarray     # int8
    chunk_side: np.ndarray    # int8
    chunk_span_end: np.ndarray  # int32 span end offset of the chunk's span
    # Direct doc-tote adds for RTypeNone/One spans [B, 4, 3]
    # (chunk_id, lang, bytes): each add owns a chunk id so the host epilogue
    # can replay all doc-tote adds in original span order.
    direct_adds: np.ndarray
    # Per-doc [B]
    text_bytes: np.ndarray    # int32 total scored text bytes
    fallback: np.ndarray      # bool: needs scalar path
    n_slots: np.ndarray       # int32 slots used (for wire-shape bucketing)
    n_chunks: np.ndarray      # int32 chunk ids allocated
    n_docs: int


def _seed_langprob(reg: Registry, ulscript: int) -> int:
    lang = reg.default_language(ulscript)
    pslang = reg.per_script_number(ULSCRIPT_LATIN, lang)
    return (pslang << 8) | 0  # qprob 1 -> backmap[1] = 0


def _pack_quad_span(span: ScriptSpan, tables: ScoringTables):
    """Quad + word candidates of one RTypeMany span, in linear merge order.

    Returns (records, overflow): records are dicts with kind/offset/... The
    quad repeat filter is left to the device (it depends on hit results);
    the word repeat filter and pair construction are hash-only and happen
    here, exactly as the scalar engine does."""
    limit = span.text_bytes
    qpos, qlens, _ = quad_positions(span.buf, 1, limit)
    if len(qpos) > MAX_SCORING_HITS:
        return None  # multi-round span -> scalar fallback
    qfps = quad_hash_v2(span.buf, qpos, qlens) if len(qpos) else \
        np.zeros(0, np.uint32)

    wstarts, wlens, wpriors = word_positions(span.buf, 1, limit)
    wfps = octa_hash40(span.buf, wstarts, wlens) if len(wstarts) else \
        np.zeros(0, np.uint64)

    # Hash-only octa repeat filter + pair hashes (cldutil.cc:459-502).
    # Records carry the 40-bit fingerprint (low 32 + high 8); the device
    # derives each table's bucket subscript and key (ops/score.py).
    recs = []
    cache = [np.uint64(0), np.uint64(0)]
    nxt = 0
    n_delta = n_distinct = 0
    for i in range(len(wfps)):
        fpw = wfps[i]
        if fpw == cache[0] or fpw == cache[1]:
            continue
        cache[nxt] = fpw
        nxt = 1 - nxt
        prior = cache[nxt]
        if prior != 0 and prior != fpw:
            pfp = int(pair_hash(prior, fpw))
            recs.append(dict(kind=DISTINCT_OCTA, offset=int(wpriors[i]),
                             fp=pfp & 0xFFFFFFFF, fp_hi=(pfp >> 32) & 0xFF))
            n_distinct += 1
        w = int(fpw)
        recs.append(dict(kind=DISTINCT_OCTA, offset=int(wstarts[i]),
                         fp=w & 0xFFFFFFFF, fp_hi=(w >> 32) & 0xFF))
        recs.append(dict(kind=DELTA_OCTA, offset=int(wstarts[i]),
                         fp=w & 0xFFFFFFFF, fp_hi=(w >> 32) & 0xFF))
        n_delta += 1
        n_distinct += 1
        if n_delta >= MAX_SCORING_HITS or n_distinct >= MAX_SCORING_HITS - 1:
            break

    for i in range(len(qpos)):
        recs.append(dict(kind=QUAD, offset=int(qpos[i]), fp=int(qfps[i])))
    return recs


def _pack_cjk_span(span: ScriptSpan, tables: ScoringTables):
    """Unigram + bigram candidates of one RTypeCJK span."""
    lens = utf8_len_of_cps(span.cps)
    ends = np.cumsum(lens)
    starts = ends - lens
    prop = tables.cjk_uni_prop[np.minimum(span.cps, 0x10FFFF)]
    sel = (prop > 0) & (starts >= 1) & (starts < span.text_bytes)
    if int(sel.sum()) > MAX_SCORING_HITS:
        return None  # multi-round span -> scalar fallback
    recs = []
    for e, p in zip(ends[sel].tolist(), prop[sel].tolist()):
        recs.append(dict(kind=UNI, offset=int(e), direct=int(p)))

    len2 = lens[:-1] + lens[1:]
    ok = (len2 >= 6) & (starts[:-1] >= 1) & (starts[:-1] < span.text_bytes)
    idx = np.flatnonzero(ok)
    if len(idx):
        fps = bi_hash_v2(span.buf, starts[idx], len2[idx])
        xt = tables.distinctbi
        # Bigram records carry the raw 32-bit fingerprint; per-table
        # sub/key derive on device (ops/score.py _quad_sub_key).
        for j, i in enumerate(idx.tolist()):
            recs.append(dict(kind=BI_DELTA, offset=int(starts[i]),
                             fp=int(fps[j])))
            if not xt.empty:
                recs.append(dict(kind=BI_DISTINCT, offset=int(starts[i]),
                                 fp=int(fps[j])))
    return recs


# Linear merge priority at equal offsets (LinearizeAll order: delta,
# distinct, base; seed always first)
_PRIORITY = {SEED: -1, DELTA_OCTA: 0, BI_DELTA: 0, DISTINCT_OCTA: 1,
             BI_DISTINCT: 1, QUAD: 2, UNI: 2}


def pack_batch(texts: list[str], tables: ScoringTables, reg: Registry,
               max_slots: int = 2048, max_chunks: int = 64,
               max_direct: int = 4, flags: int = 0) -> PackedBatch:
    """Pack a batch for device scoring.

    `flags` are the engine's scoring flags: FLAG_FINISH (bit 0,
    compact_lang_det_impl.h:31) disables the squeeze-trigger fallback test,
    matching the scalar engine's recursion guard."""
    from ..engine_scalar import FLAG_FINISH
    B = len(texts)
    L, C = max_slots, max_chunks
    out = PackedBatch(
        kind=np.zeros((B, L), np.int8),
        offset=np.zeros((B, L), np.int32),
        fp=np.zeros((B, L), np.uint32),
        fp_hi=np.zeros((B, L), np.uint8),
        chunk_base=np.zeros((B, L), np.int32),
        span_start=np.zeros((B, L), np.int32),
        span_end_off=np.zeros((B, L), np.int32),
        side=np.zeros((B, L), np.int8),
        cjk=np.zeros((B, L), np.int8),
        script=np.zeros((B, L), np.int16),
        chunk_script=np.zeros((B, C), np.int16),
        chunk_cjk=np.zeros((B, C), np.int8),
        chunk_side=np.zeros((B, C), np.int8),
        chunk_span_end=np.zeros((B, C), np.int32),
        direct_adds=np.full((B, max_direct, 3), -1, np.int32),
        text_bytes=np.zeros(B, np.int32),
        fallback=np.zeros(B, bool),
        n_slots=np.zeros(B, np.int32),
        n_chunks=np.zeros(B, np.int32),
        n_docs=B,
    )

    for b, text in enumerate(texts):
        spans = segment_text(text, tables)
        slot = 0
        chunk_base = 0
        n_direct = 0
        total = 0
        ok = True
        for span in spans:
            total += span.text_bytes
            rtype = reg.rtype(span.ulscript)
            # Squeeze-trigger documents take the scalar path (rare/spam);
            # the scalar engine tests every span (impl.cc:1866-1901).
            if not (flags & FLAG_FINISH) and \
                    (TEST_THRESH >> 1) < span.text_bytes and \
                    cheap_squeeze_trigger_test(span.buf.tobytes(),
                                               span.text_bytes):
                ok = False
                break
            if rtype in (RTYPE_NONE, RTYPE_ONE):
                if n_direct >= max_direct or chunk_base >= C:
                    ok = False
                    break
                out.direct_adds[b, n_direct] = (
                    chunk_base, reg.default_language(span.ulscript),
                    span.text_bytes)
                n_direct += 1
                chunk_base += 1
                continue
            if span.text_bytes <= 1:
                continue
            cjk = rtype == RTYPE_CJK
            recs = _pack_cjk_span(span, tables) if cjk \
                else _pack_quad_span(span, tables)
            if recs is None:
                ok = False
                break
            recs.append(dict(kind=SEED, offset=1,
                             direct=_seed_langprob(reg, span.ulscript)))
            recs.sort(key=lambda r: (r["offset"], _PRIORITY[r["kind"]]))
            # Worst-case chunk count if every base candidate hits
            n_base_max = sum(1 for r in recs if r["kind"] in BASE_KINDS)
            span_chunks = max(1, -(-n_base_max //
                                   (50 if cjk else 20)) + 1)
            if slot + len(recs) > L or chunk_base + span_chunks > C:
                ok = False
                break
            side = 0 if span.ulscript == ULSCRIPT_LATIN else 1
            for r in recs:
                out.kind[b, slot] = r["kind"]
                out.offset[b, slot] = r["offset"]
                out.fp[b, slot] = r.get("fp", r.get("direct", 0))
                out.fp_hi[b, slot] = r.get("fp_hi", 0)
                out.chunk_base[b, slot] = chunk_base
                out.span_end_off[b, slot] = span.text_bytes
                out.side[b, slot] = side
                out.cjk[b, slot] = cjk
                out.script[b, slot] = span.ulscript
                slot += 1
            start = slot - len(recs)
            out.span_start[b, start:slot] = start
            sl = slice(chunk_base, chunk_base + span_chunks)
            out.chunk_script[b, sl] = span.ulscript
            out.chunk_cjk[b, sl] = cjk
            out.chunk_side[b, sl] = side
            out.chunk_span_end[b, sl] = span.text_bytes
            chunk_base += span_chunks
        out.text_bytes[b] = total
        out.fallback[b] = not ok
        out.n_slots[b] = slot
        out.n_chunks[b] = chunk_base
    return out
