"""Detection hints: content-language / TLD / encoding / language /
HTML lang= tags -> per-script chunk boosts and close-set whacks.

Rebuild of the reference hints engine (compact_lang_det_hint_code.cc:
941-1651 and ApplyHints, compact_lang_det_impl.cc:1587-1684). The three
hand-curated lookup tables (long lang-tags, short lang codes, TLDs) are
data extracted into the table artifact; this module implements the
merge/trim prior algebra, the HTML lang-attribute scanner, and the
conversion into the boost/whack lists that chunk scoring applies
(ScoreBoosts, scoreonescriptspan.cc:125-152).

Prior packing (OneCLDLangPrior, compact_lang_det_hint_code.h:30-44):
language id in the low 10 bits, signed weight above (lang + (w << 10)).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .registry import Registry, UNKNOWN_LANGUAGE
from .tables import ScoringTables

MAX_PRIORS = 14                 # kMaxOneCLDLangPrior
PRIOR_ENCODING_WEIGHT = 4       # kCLDPriorEncodingWeight
PRIOR_LANGUAGE_WEIGHT = 8       # kCLDPriorLanguageWeight
MAX_LANG_TAG_SCAN_BYTES = 8 << 10   # FLAGS_cld_max_lang_tag_scan_kb

# kLgProbV2Tbl backmap (cldutil_shared.h:311-314; MakeLangProb cldutil.cc:610)
_BACKMAP = [0, 0, 1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 66]


@dataclasses.dataclass
class CLDHints:
    """compact_lang_det.h:134-139."""
    content_language_hint: str | None = None   # HTTP Content-Language
    tld_hint: str | None = None                # hostname last element
    encoding_hint: str | int | None = None     # legacy encoding name/id
    language_hint: int = UNKNOWN_LANGUAGE


def prior_lang(olp: int) -> int:
    return olp & 0x3FF


def prior_weight(olp: int) -> int:
    return olp >> 10  # arithmetic: weights may be negative


def _merge_max(olp: int, priors: list):
    """MergeCLDLangPriorsMax (hint_code.cc:941-956)."""
    if olp == 0:
        return
    lang = prior_lang(olp)
    for i, p in enumerate(priors):
        if prior_lang(p) == lang:
            w = max(prior_weight(p), prior_weight(olp))
            priors[i] = lang + (w << 10)
            return
    if len(priors) < MAX_PRIORS:
        priors.append(olp)


def _merge_boost(olp: int, priors: list):
    """MergeCLDLangPriorsBoost (hint_code.cc:958-973): +2 if present."""
    if olp == 0:
        return
    lang = prior_lang(olp)
    for i, p in enumerate(priors):
        if prior_lang(p) == lang:
            priors[i] = lang + ((prior_weight(p) + 2) << 10)
            return
    if len(priors) < MAX_PRIORS:
        priors.append(olp)


def _trim(priors: list, max_entries: int = 4):
    """TrimCLDLangPriors (hint_code.cc:975-996): stable sort by
    descending |weight|, keep the top max_entries."""
    if len(priors) <= max_entries:
        return priors
    priors.sort(key=lambda p: -abs(prior_weight(p)))
    del priors[max_entries:]
    return priors


class _HintTables:
    """Binary-searchable views of the artifact's hint tables."""

    def __init__(self, t: ScoringTables):
        z = t
        self.lt1 = {str(k): (int(a), int(b)) for k, a, b in
                    zip(z.langtag1_keys, z.langtag1_prior1,
                        z.langtag1_prior2)}
        self.lt2 = {str(k): (int(a), int(b)) for k, a, b in
                    zip(z.langtag2_keys, z.langtag2_prior1,
                        z.langtag2_prior2)}
        self.tld = {str(k): (int(a), int(b)) for k, a, b in
                    zip(z.tld_hint_keys, z.tld_hint_prior1,
                        z.tld_hint_prior2)}
        self.encoding_id = {str(n): i for i, n in
                            enumerate(z.encoding_names)}


_tables_cache: tuple = ()


def _hint_tables(t: ScoringTables) -> _HintTables:
    global _tables_cache
    if _tables_cache and _tables_cache[0] is t:
        return _tables_cache[1]
    h = _HintTables(t)
    _tables_cache = (t, h)
    return h


# ---------------------------------------------------------------------------
# Lang-tag list normalization + the SetCLD* family
# ---------------------------------------------------------------------------

def copy_one_quoted_string(s: str) -> str:
    """Normalize a language attribute value into a comma-separated list
    (CopyOneQuotedString's 3-state scanner, hint_code.cc:1100-1207):
    letters lowercase, underscore -> minus, tab/space/comma separate,
    any other character poisons the rest of the token (a comma is
    emitted at the start of skipping), consecutive commas collapse.
    Returns '' or a list ending in a comma."""
    out = []
    state = 1   # 0 = after letter, 1 = after comma, 2 = skipping
    for c in s:
        o = ord(c)
        if o < 256 and (0x41 <= o <= 0x5A or 0x61 <= o <= 0x7A):
            cls = "letter"
        elif c in "-_":
            cls = "minus"
        elif c in " \t,":
            cls = "comma"
        else:
            cls = "bad"
        if state == 0:
            if cls == "letter" or cls == "minus":
                out.append("-" if cls == "minus" else c.lower())
            elif cls == "comma":
                out.append(",")
                state = 1
            else:
                out.append(",")
                state = 2
        elif state == 1:
            if cls == "letter":
                out.append(c.lower())
                state = 0
            elif cls == "comma":
                pass
            else:
                state = 2
        else:  # skipping
            if cls == "comma":
                state = 1
    if state == 0:
        out.append(",")
    return "".join(out)


def set_lang_tags_hint(langtags: str, priors: list, t: ScoringTables):
    """SetCLDLangTagsHint (hint_code.cc:1394-1435): comma-separated
    normalized tags through lookup table 1 (long tags), falling back to
    table 2 with the code truncated at the first hyphen."""
    if not langtags:
        return
    if langtags.count(",") > 4:
        return
    ht = _hint_tables(t)
    for tag in langtags.split(","):
        if not tag or len(tag) > 16:
            continue
        entry = ht.lt1.get(tag)
        if entry is None:
            short = tag.split("-", 1)[0]
            if len(short) <= 3:
                entry = ht.lt2.get(short)
        if entry is not None:
            _merge_max(entry[0], priors)
            _merge_max(entry[1], priors)


def set_content_lang_hint(contentlang: str, priors: list,
                          t: ScoringTables):
    """SetCLDContentLangHint (hint_code.cc:1439-1443)."""
    set_lang_tags_hint(copy_one_quoted_string(contentlang), priors, t)


def set_tld_hint(tld: str, priors: list, t: ScoringTables):
    """SetCLDTLDHint (hint_code.cc:1446-1464)."""
    if not tld or len(tld) > 3:
        return
    entry = _hint_tables(t).tld.get(tld.lower())
    if entry is not None:
        _merge_boost(entry[0], priors)
        _merge_boost(entry[1], priors)


# SetCLDEncodingHint (hint_code.cc:1466-1501): encoding families -> lang
_ENCODING_LANG = {}
for _names, _code in [
        (("CHINESE_GB", "GBK", "GB18030", "ISO_2022_CN", "HZ_GB_2312"),
         "zh"),
        (("CHINESE_BIG5", "CHINESE_BIG5_CP950", "BIG5_HKSCS"), "zh-Hant"),
        (("JAPANESE_EUC_JP", "JAPANESE_SHIFT_JIS", "JAPANESE_CP932",
          "JAPANESE_JIS"), "ja"),
        (("KOREAN_EUC_KR", "ISO_2022_KR"), "ko")]:
    for _n in _names:
        _ENCODING_LANG[_n] = _code


def set_encoding_hint(enc: str | int, priors: list, t: ScoringTables,
                      reg: Registry):
    ht = _hint_tables(t)
    if isinstance(enc, int):
        names = list(ht.encoding_id)
        name = names[enc] if 0 <= enc < len(names) else None
    else:
        name = enc
    code = _ENCODING_LANG.get(name or "")
    if code is None:
        return
    lang = reg.code_to_lang.get(code)
    if lang is not None:
        _merge_boost(lang + (PRIOR_ENCODING_WEIGHT << 10), priors)


def set_language_hint(lang: int, priors: list):
    """SetCLDLanguageHint (hint_code.cc:1503-1508)."""
    if lang != UNKNOWN_LANGUAGE:
        _merge_boost(lang + (PRIOR_LANGUAGE_WEIGHT << 10), priors)


# ---------------------------------------------------------------------------
# HTML lang= attribute scanner (GetLangTagsFromHtml, hint_code.cc:1557-1645)
# ---------------------------------------------------------------------------

def _find_after(body: str, pos: int, max_pos: int, s: str) -> bool:
    i = pos
    while i < max_pos - len(s) and body[i] in " \"'":
        i += 1
    return body[i:i + len(s)].lower() == s


def _find_before(body: str, min_pos: int, pos: int, s: str) -> bool:
    i = pos
    while i > min_pos + len(s) and body[i - 1] == " ":
        i -= 1
    i -= len(s)
    if i < min_pos:
        return False
    return body[i:i + len(s)].lower() == s


def _find_equal_sign(body: str, pos: int, max_pos: int) -> int:
    i = pos
    while i < max_pos:
        c = body[i]
        if c == "=":
            return i
        if c in "\"'":
            q = c
            j = i + 1
            while j < max_pos:
                if body[j] == q:
                    break
                if body[j] == "\\":
                    j += 1
                j += 1
            i = j
        i += 1
    return -1


def _copy_quoted_string(body: str, pos: int, max_pos: int) -> str:
    i = pos
    while i < max_pos and body[i] == " ":
        i += 1
    if i >= max_pos or body[i] not in "\"'":
        return ""
    start = i + 1
    j = start
    while j < max_pos and body[j] not in "\"'><=&":
        j += 1
    if j >= max_pos:
        return ""
    return copy_one_quoted_string(body[start:j])


def get_lang_tags_from_html(body: str,
                            max_scan: int = MAX_LANG_TAG_SCAN_BYTES) -> str:
    """Scan the first max_scan BYTES for lang= / xml:lang= /
    <meta http-equiv=content-language content=...> attributes
    (the reference budget is bytes, not characters)."""
    if len(body) > max_scan:  # chars >= bytes, so only then can it exceed
        # surrogatepass: lone surrogates must not crash the scanner
        # (the ignore-decode then drops any split/invalid tail bytes)
        body = body.encode("utf-8", "surrogatepass")[:max_scan] \
            .decode("utf-8", "ignore")
    n = len(body)
    out = ""
    k = 0
    while k < n:
        start = body.find("<", k)
        if start < 0 or start >= n:
            break
        # FindTagEnd: stop at > (tag), or back off at < or &
        end = -1
        for i in range(start + 1, n):
            c = body[i]
            if c == ">":
                end = i
                break
            if c in "<&":
                end = i - 1
                break
        if end < 0:
            break
        if any(_find_after(body, start + 1, end, s) for s in
               ("!--", "font ", "script ", "link ", "img ", "a ")):
            k = end + 1
            continue
        in_meta = _find_after(body, start + 1, end, "meta ")
        content_is_lang = False
        kk = start + 1
        while True:
            eq = _find_equal_sign(body, kk, end)
            if eq < 0:
                break
            if in_meta:
                if _find_before(body, kk, eq, " http-equiv") and \
                        _find_after(body, eq + 1, end, "content-language "):
                    content_is_lang = True
                elif _find_before(body, kk, eq, " name") and \
                        (_find_after(body, eq + 1, end, "dc.language ") or
                         _find_after(body, eq + 1, end, "language ")):
                    content_is_lang = True
            if (content_is_lang and
                    _find_before(body, kk, eq, " content")) or \
                    _find_before(body, kk, eq, " lang") or \
                    _find_before(body, kk, eq, ":lang"):
                temp = _copy_quoted_string(body, eq + 1, end)
                if temp and temp not in out:
                    out += temp
            kk = eq + 1
        k = end + 1
    return out[:-1] if len(out) > 1 else out


# ---------------------------------------------------------------------------
# ApplyHints -> per-script boost/whack lists
# ---------------------------------------------------------------------------

class _Rotating4(list):
    """4-slot rotating langprob buffer (LangBoosts,
    scoreonescriptspan.h:70-89): past 4 entries, the oldest is
    overwritten, not the newest dropped."""

    def __init__(self):
        super().__init__()
        self._n = 0

    def add(self, lp: int):
        if len(self) < 4:
            self.append(lp)
        else:
            self[self._n] = lp
        self._n = (self._n + 1) & 3


@dataclasses.dataclass
class HintBoosts:
    """Per-script-side langprob lists for chunk scoring (ScoringContext
    langprior_boost/langprior_whack, scoreonescriptspan.h)."""
    boost_latn: _Rotating4
    boost_othr: _Rotating4
    whack_latn: _Rotating4
    whack_othr: _Rotating4

    def empty(self) -> bool:
        return not (self.boost_latn or self.boost_othr or
                    self.whack_latn or self.whack_othr)


def make_langprob(reg: Registry, lang: int, qprob: int) -> int:
    """MakeLangProb (cldutil.cc:610-614)."""
    pslang = reg.per_script_number(1, lang)
    return (pslang << 8) | _BACKMAP[max(1, min(qprob, 12))]


def prior_vector(hb: "HintBoosts | None",
                 tables: ScoringTables) -> np.ndarray | None:
    """One document's HintBoosts -> dense per-side prior vector
    [2, 256] u8 for the device reduction (LDT_HINTS=1), or None when
    the document carries no boosts.

    Each boost langprob decodes exactly as the chunk tote would decode
    a hint slot (plane 0 only — make_langprob fills one plane): pslang
    from bits 8-15, qprob from lg_prob plane 0 of the row in bits 0-7.
    The vector is the per-chunk score the reduction adds to every
    POSITIVE post-whack tote entry before the top-2 select
    (ops/score.py _chunk_out_word prior term); zero entries stay zero,
    so a prior can never promote a language with no chunk evidence."""
    if hb is None or hb.empty():
        return None
    lg3 = np.asarray(tables.lg_prob[:, 5:8], dtype=np.uint8)
    pv = np.zeros((2, 256), np.int32)
    any_set = False
    for side, boosts in ((0, hb.boost_latn), (1, hb.boost_othr)):
        for lp in list(boosts):
            if lp <= 0:
                continue
            ps = (lp >> 8) & 0xFF
            if ps == 0:
                continue
            row = min(lp & 0xFF, lg3.shape[0] - 1)
            pv[side, ps] += int(lg3[row, 0])
            any_set = True
    if not any_set:
        return None
    return np.minimum(pv, 255).astype(np.uint8)


def _is_latn_lang(reg: Registry, lang: int) -> bool:
    return int(reg.plang_to_lang_latn[reg.per_script_number(1, lang)]) \
        == lang


def _is_othr_lang(reg: Registry, lang: int) -> bool:
    return int(reg.plang_to_lang_othr[reg.per_script_number(1, lang)]) \
        == lang


def apply_hints(text: str, is_plain_text: bool, hints: CLDHints | None,
                tables: ScoringTables, reg: Registry) -> HintBoosts:
    """ApplyHints (compact_lang_det_impl.cc:1587-1684)."""
    priors: list = []
    if not is_plain_text:
        set_lang_tags_hint(get_lang_tags_from_html(text), priors, tables)
    if hints is not None:
        if hints.content_language_hint:
            set_content_lang_hint(hints.content_language_hint, priors,
                                  tables)
        if hints.tld_hint:
            set_tld_hint(hints.tld_hint, priors, tables)
        if hints.encoding_hint is not None:
            set_encoding_hint(hints.encoding_hint, priors, tables, reg)
        if hints.language_hint != UNKNOWN_LANGUAGE:
            set_language_hint(hints.language_hint, priors)
    _trim(priors, 4)

    hb = HintBoosts(_Rotating4(), _Rotating4(), _Rotating4(), _Rotating4())
    for p in priors:
        lang = prior_lang(p)
        qprob = prior_weight(p)
        if qprob > 0:
            lp = make_langprob(reg, lang, qprob)
            if _is_latn_lang(reg, lang):
                hb.boost_latn.add(lp)
            if _is_othr_lang(reg, lang):
                hb.boost_othr.add(lp)

    # Whacks: when exactly one member of a close set is hinted, suppress
    # the others (zh/zh-Hant form an honorary close pair here)
    zh = reg.code_to_lang.get("zh")
    zht = reg.code_to_lang.get("zh-Hant")
    close_count: dict = {}
    zh_count = 0
    for p in priors:
        lang = prior_lang(p)
        cs = reg.close_set(lang)
        close_count[cs] = close_count.get(cs, 0) + 1
        if lang in (zh, zht):
            zh_count += 1

    def add_whack(whacker: int, whackee: int):
        # AddOneWhack (impl.cc:1541-1561): the whacker must share the
        # script side — hr-Latn must not whack sr-Cyrl, only sr-Latn
        lp = make_langprob(reg, whackee, 1)
        if _is_latn_lang(reg, whacker) and _is_latn_lang(reg, whackee):
            hb.whack_latn.add(lp)
        if _is_othr_lang(reg, whacker) and _is_othr_lang(reg, whackee):
            hb.whack_othr.add(lp)

    for p in priors:
        lang = prior_lang(p)
        if prior_weight(p) <= 0:
            continue
        if lang == zh and zh_count == 1:
            add_whack(lang, zht)
            continue
        if lang == zht and zh_count == 1:
            add_whack(lang, zh)
            continue
        cs = reg.close_set(lang)
        if cs > 0 and close_count.get(cs) == 1:
            for lang2 in range(reg.num_languages):
                if lang2 != lang and reg.close_set(lang2) == cs:
                    add_whack(lang, lang2)
    return hb
