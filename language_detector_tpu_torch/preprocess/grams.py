"""Hit gathering: scan a script span for n-gram candidates and probe tables.

Re-implements the reference hot loops (cldutil.cc GetQuadHits:315,
GetOctaHits:416, GetUniHits:201, GetBiHits:248) in a host-friendly split:
positions are found with a small sequential scan (data-dependent strides),
then fingerprints and 4-way bucket probes run as vectorized numpy over all
candidates at once — the same shape the TPU path uses on device.

Hit records are (offset, indirect) pairs exactly as the reference's
ScoringHitBuffer holds them; `indirect` carries the 0x80000000 dual-table
flag for quadgram table-2 hits (cldutil.cc:360-373).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..tables import NgramTable, ScoringTables
from .hashing import (bi_hash_v2, octa_hash40, octa_subscript_key, pair_hash,
                      quad_hash_v2, quad_subscript_key)
from .segment import ScriptSpan, utf8_len_of_cps

DUAL_TABLE_FLAG = 0x80000000

# Hitbuffer capacity per scoring round (kMaxScoringHits,
# scoreonescriptspan.h:93): base hits fill in rounds of <=1000; delta and
# distinct hits are capped per round and excess is dropped.
MAX_SCORING_HITS = 1000

# Byte-class advance tables (cldutil_shared.h:462, cldutil.cc:49-99)
_ADV_BUT_SPACE = np.zeros(256, dtype=np.int64)   # 0 for <=0x20
_ADV_BUT_SPACE[0x21:0xC0] = 1
_ADV_BUT_SPACE[0xC0:0xE0] = 2
_ADV_BUT_SPACE[0xE0:0xF0] = 3
_ADV_BUT_SPACE[0xF0:0x100] = 4

_ADV_ONE = np.ones(256, dtype=np.int64)
_ADV_ONE[0xC0:0xE0] = 2
_ADV_ONE[0xE0:0xF0] = 3
_ADV_ONE[0xF0:0x100] = 4

_ADV_SPACE_VOWEL = np.zeros(256, dtype=np.int64)  # 1 on space/vowel/cont/ctrl
_ADV_SPACE_VOWEL[0x00:0x21] = 1
for _c in b"AEIOUaeiou":
    _ADV_SPACE_VOWEL[_c] = 1
_ADV_SPACE_VOWEL[0x80:0xC0] = 1


@dataclasses.dataclass
class HitList:
    offsets: np.ndarray    # int32 span-buffer offsets
    indirects: np.ndarray  # uint32 indirect subscripts (maybe dual-flagged)

    @staticmethod
    def empty() -> "HitList":
        return HitList(np.zeros(0, np.int32), np.zeros(0, np.uint32))


def lookup4(table: NgramTable, fps: np.ndarray, *, octa: bool) -> np.ndarray:
    """Vectorized 4-way associative probe (cldutil_shared.h:403-454).

    Returns the matching keyvalue word per fingerprint, or 0 on miss.
    """
    if len(fps) == 0:
        return np.zeros(0, dtype=np.uint32)
    if octa:
        sub, key = octa_subscript_key(fps, table.keymask, table.size)
    else:
        sub, key = quad_subscript_key(fps, table.keymask, table.size)
    rows = table.buckets[sub]                       # [n, 4]
    match = ((rows ^ key[:, None]) & np.uint32(table.keymask)) == 0
    hit = match.any(axis=1)
    slot = match.argmax(axis=1)
    kv = rows[np.arange(len(fps)), slot]
    return np.where(hit, kv, np.uint32(0))


def quad_positions(buf: np.ndarray, letter_offset: int,
                   letter_limit: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Candidate quadgram (pos, len) pairs with the reference advance rule:
    jump to word end when the quad ends a word, else 2 chars, then skip one
    space/ASCII-vowel byte (cldutil.cc:338-395). Also returns the final scan
    position (the dummy-entry offset)."""
    adv_bs = _ADV_BUT_SPACE
    adv_sv = _ADV_SPACE_VOWEL
    b = buf.tolist()
    src = letter_offset
    if b[src] == 0x20:
        src += 1
    pos, lens = [], []
    while src < letter_limit:
        e = src
        e += adv_bs[b[e]]
        e += adv_bs[b[e]]
        mid = e
        e += adv_bs[b[e]]
        e += adv_bs[b[e]]
        pos.append(src)
        lens.append(e - src)
        src = e if b[e] == 0x20 else mid
        if src < letter_limit:
            src += adv_sv[b[src]]
        else:
            src = letter_limit
    return (np.array(pos, dtype=np.int64), np.array(lens, dtype=np.int64),
            src)


def get_quad_hits(span: ScriptSpan, tables: ScoringTables,
                  letter_offset: int = 1,
                  max_hits: int = MAX_SCORING_HITS) -> tuple[HitList, int]:
    """Quadgram hits with dual-table fallback and 2-entry repeat cache.

    Returns (hits, next_offset): scanning stops after max_hits recorded hits
    (hitbuffer fill, cldutil.cc:394), next_offset resumes the next round.
    """
    limit = span.text_bytes
    pos, lens, final_src = quad_positions(span.buf, letter_offset, limit)
    if len(pos) == 0:
        return HitList.empty(), final_src
    fps = quad_hash_v2(span.buf, pos, lens)
    kv1 = lookup4(tables.quadgram, fps, octa=False)
    use2 = not tables.quadgram2.empty and tables.quadgram2.size != 0
    kv2 = (lookup4(tables.quadgram2, fps, octa=False)
           if use2 else np.zeros_like(kv1))

    not_key1 = np.uint32(~np.uint32(tables.quadgram.keymask))
    not_key2 = np.uint32(~np.uint32(tables.quadgram2.keymask))
    offs, inds = [], []
    prior = [np.uint32(0), np.uint32(0)]
    nxt = 0
    next_offset = final_src
    for i in range(len(fps)):
        fp = fps[i]
        if fp == prior[0] or fp == prior[1]:
            continue  # repeat filter (cldutil.cc:352)
        if kv1[i] != 0:
            ind = np.uint32(kv1[i]) & not_key1
        elif kv2[i] != 0:
            ind = (np.uint32(kv2[i]) & not_key2) | np.uint32(DUAL_TABLE_FLAG)
        else:
            continue
        prior[nxt] = fp
        nxt ^= 1
        offs.append(pos[i])
        inds.append(ind)
        if len(offs) >= max_hits:
            # Buffer full: the round ends at the position the scan loop
            # would process next.
            next_offset = int(pos[i + 1]) if i + 1 < len(pos) else final_src
            break
    return (HitList(np.array(offs, dtype=np.int32),
                    np.array(inds, dtype=np.uint32)), next_offset)


def word_positions(buf: np.ndarray, letter_offset: int,
                   letter_limit: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(word_start, hashed_len, prior_word_start) per word; words are
    space-delimited and hashed truncated to 8 characters (cldutil.cc:443-517).
    """
    b = buf.tolist()
    src = letter_offset
    if b[src] == 0x20:
        src += 1
    starts, lens, priors = [], [], []
    srclimit = letter_limit + 1  # include trailing space off the end
    charcount = 0
    prior_word_start = src
    word_start = src
    word_end = word_start
    while src < srclimit:
        if b[src] == 0x20:
            if word_end > word_start:
                starts.append(word_start)
                lens.append(word_end - word_start)
                priors.append(prior_word_start)
            charcount = 0
            prior_word_start = word_start
            word_start = src + 1
            word_end = word_start
        else:
            charcount += 1
        src += _ADV_ONE[b[src]]
        if charcount <= 8:
            word_end = src
    return (np.array(starts, dtype=np.int64), np.array(lens, dtype=np.int64),
            np.array(priors, dtype=np.int64))


def get_octa_hits(span: ScriptSpan, tables: ScoringTables,
                  letter_offset: int = 1,
                  letter_limit: int | None = None) -> tuple[HitList, HitList]:
    """Word (delta-octa) and distinct-word/word-pair hits over
    [letter_offset, letter_limit).

    Returns (delta_hits, distinct_hits); distinct includes single words and
    consecutive-word pairs at the prior word's offset (cldutil.cc:470-502).
    """
    if letter_limit is None:
        letter_limit = span.text_bytes
    starts, lens, priors = word_positions(span.buf, letter_offset,
                                          letter_limit)
    if len(starts) == 0:
        return HitList.empty(), HitList.empty()
    fps = octa_hash40(span.buf, starts, lens)

    # Sequential repeat filter; cache updates even on table miss.
    keep = np.zeros(len(fps), dtype=bool)
    prior_hash = np.zeros(len(fps), dtype=np.uint64)  # other cache slot
    cache = [np.uint64(0), np.uint64(0)]
    nxt = 0
    for i in range(len(fps)):
        fp = fps[i]
        if fp == cache[0] or fp == cache[1]:
            continue
        keep[i] = True
        cache[nxt] = fp
        nxt = 1 - nxt
        prior_hash[i] = cache[nxt]

    k = np.flatnonzero(keep)
    kfps = fps[k]
    # (1) word pairs: rotate(prev,13)+cur, recorded at prior word start
    pair_ok = (prior_hash[k] != 0) & (prior_hash[k] != kfps)
    pfps = pair_hash(prior_hash[k], kfps)
    kv_pair = lookup4(tables.distinctocta, pfps, octa=True)
    kv_pair = np.where(pair_ok, kv_pair, np.uint32(0))
    # (2) distinct single words
    kv_dist = lookup4(tables.distinctocta, kfps, octa=True)
    # (3) delta words
    kv_delta = lookup4(tables.deltaocta, kfps, octa=True)

    not_key_d = np.uint32(~np.uint32(tables.deltaocta.keymask))
    not_key_x = np.uint32(~np.uint32(tables.distinctocta.keymask))
    d_off, d_ind, x_off, x_ind = [], [], [], []
    for j, i in enumerate(k):
        if kv_pair[j] != 0:
            x_off.append(priors[i])
            x_ind.append(np.uint32(kv_pair[j]) & not_key_x)
        if kv_dist[j] != 0:
            x_off.append(starts[i])
            x_ind.append(np.uint32(kv_dist[j]) & not_key_x)
        if kv_delta[j] != 0:
            d_off.append(starts[i])
            d_ind.append(np.uint32(kv_delta[j]) & not_key_d)
        # Per-round hitbuffer caps: excess words are dropped
        # (cldutil.cc:429-435, :520-521)
        if len(d_off) >= MAX_SCORING_HITS or \
                len(x_off) >= MAX_SCORING_HITS - 1:
            break
    return (HitList(np.array(d_off, np.int32), np.array(d_ind, np.uint32)),
            HitList(np.array(x_off, np.int32), np.array(x_ind, np.uint32)))


def _char_geometry(span: ScriptSpan):
    """(starts, ends) byte offsets per codepoint of the span buffer."""
    lens = utf8_len_of_cps(span.cps)
    ends = np.cumsum(lens)
    starts = ends - lens
    return starts.astype(np.int64), ends.astype(np.int64), lens


def get_uni_hits(span: ScriptSpan, tables: ScoringTables,
                 letter_offset: int = 1,
                 max_hits: int = MAX_SCORING_HITS) -> tuple[HitList, int]:
    """CJK unigram hits: per-character compat-class lookup (cldutil.cc:201).

    Offsets are recorded past the character (reference records src - text
    after advancing, cldutil.cc:222-230). Returns (hits, next_offset);
    scanning stops after max_hits recorded hits (hitbuffer fill)."""
    starts, ends, _ = _char_geometry(span)
    prop = tables.cjk_uni_prop[np.minimum(span.cps, 0x10FFFF)]
    sel = (prop > 0) & (starts >= letter_offset) & (starts < span.text_bytes)
    hit_ends = ends[sel]
    hit_props = prop[sel]
    if len(hit_ends) >= max_hits:
        # Round ends right after the max_hits-th hit's character (the
        # reference breaks even when it is the last hit, cldutil.cc:233).
        next_offset = int(hit_ends[max_hits - 1])
        hit_ends = hit_ends[:max_hits]
        hit_props = hit_props[:max_hits]
    else:
        next_offset = span.text_bytes
    return (HitList(hit_ends.astype(np.int32), hit_props.astype(np.uint32)),
            next_offset)


def get_bi_hits(span: ScriptSpan, tables: ScoringTables,
                letter_offset: int = 1,
                letter_limit: int | None = None) -> tuple[HitList, HitList]:
    """CJK bigram hits over [letter_offset, letter_limit): two >=3-byte
    chars hashed together (cldutil.cc:248)."""
    if letter_limit is None:
        letter_limit = span.text_bytes
    starts, ends, lens = _char_geometry(span)
    # bigram i = chars i, i+1; need len2 >= 6 bytes (two CJK chars)
    len2 = lens[:-1] + lens[1:]
    ok = ((len2 >= 6) & (starts[:-1] >= letter_offset) &
          (starts[:-1] < letter_limit))
    idx = np.flatnonzero(ok)
    if len(idx) == 0:
        return HitList.empty(), HitList.empty()
    fps = bi_hash_v2(span.buf, starts[idx], len2[idx])
    kv_delta = lookup4(tables.cjkdeltabi, fps, octa=False)
    kv_dist = lookup4(tables.distinctbi, fps, octa=False)
    nk_d = np.uint32(~np.uint32(tables.cjkdeltabi.keymask))
    nk_x = np.uint32(~np.uint32(tables.distinctbi.keymask))
    dsel = kv_delta != 0
    xsel = kv_dist != 0
    d_off = starts[idx][dsel].astype(np.int32)[:MAX_SCORING_HITS]
    d_ind = (kv_delta[dsel] & nk_d).astype(np.uint32)[:MAX_SCORING_HITS]
    x_off = starts[idx][xsel].astype(np.int32)[:MAX_SCORING_HITS - 1]
    x_ind = (kv_dist[xsel] & nk_x).astype(np.uint32)[:MAX_SCORING_HITS - 1]
    return HitList(d_off, d_ind), HitList(x_off, x_ind)
