"""Per-language vocabulary extraction from babel's CLDR locale data.

The port of the reference package's tools/cldr_vocab.py, line for line
but for its imports. The snapshot's quadgram tables are missing, and
the only labeled word data inside the snapshot is the ~80K octagram-table
comment words — too sparse for 140+ languages. This tool mines the CLDR
locale data shipped with the `babel` package for additional labeled
vocabulary: calendar terms, relative-date phrases, unit/currency/list
patterns (function-word rich), and language/territory/script display
names (broad orthography coverage).

Inheritance is deliberately NOT merged (babel.localedata.load(...,
merge_inherited=False)): merged data falls back to the root locale, which
would attribute English/root strings to every minor language.

Output: [(phrase, lang_id, qprob)] where phrase is a lowercased
space-separated token string (scanned whole, so word-boundary quadgrams are
trained too) and qprob is a CLD2-style 1..12 log-scale weight class.

babel is imported only when the CLDR source is read; a host without it
(the card's machine) trains from already-collected phrases instead
(train_quad_tables.collect_corpus's `phrases`).

Usage:
  python -m language_detector_tpu_torch.tools.cldr_vocab
"""
from __future__ import annotations

import re
import unicodedata
from pathlib import Path

# babel language code -> CLD2 registry code where they differ
ALIASES = {
    "he": "iw", "jv": "jw", "fil": "tl", "nb": "no", "ckb": "ku",
    "mni": "mni-Mtei",
}

# Languages whose CLD2 scoring path is not quadgram-based (CJK uni/bigrams
# or single-script nilgram); their CLDR vocab would waste table buckets.
SKIP_LANGS = {"zh", "zh-Hant", "yue", "ja", "ko"}

_PLACEHOLDER = re.compile(r"\{\d+\}|%\w|''")
_NONWORD = re.compile(r"[0-9_/\\(){}\[\]<>#@&+=*%°§©®™.,;:!?"
                      r"‘’“”\"'|~^$-]+")

# (data key, qprob): calendar + pattern sources carry running-text function
# words (high weight); display-name catalogs are broad but proper-noun-ish.
SOURCES = [
    ("months", 8), ("days", 8), ("quarters", 6), ("eras", 6),
    ("day_periods", 7), ("date_fields", 8), ("list_patterns", 8),
    ("unit_patterns", 7), ("unit_display_names", 7),
    ("compound_unit_patterns", 7), ("currency_unit_patterns", 6),
    ("measurement_systems", 5),
    ("languages", 4), ("territories", 4), ("scripts", 4),
    ("variants", 4), ("currency_names", 4), ("currency_names_plural", 4),
]


def _strings_of(node):
    """All str leaves of a nested CLDR data node."""
    if isinstance(node, str):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _strings_of(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _strings_of(v)
    # babel wraps some leaves in DayPeriodRule / pattern objects; their
    # `pattern` attr is a format string
    elif hasattr(node, "pattern") and isinstance(node.pattern, str):
        yield node.pattern


def _clean_phrase(s: str) -> str:
    """Pattern string -> lowercase letter phrase ('' if nothing left)."""
    s = _PLACEHOLDER.sub(" ", s)
    s = _NONWORD.sub(" ", s)
    s = " ".join(s.split())
    if not s:
        return ""
    s = s.lower()
    # Drop phrases that are pure ASCII codes/symbols with no letters
    if not any(unicodedata.category(c).startswith("L") for c in s):
        return ""
    return s


def _base_lang(locale_id: str) -> str:
    return locale_id.split("_")[0]


def collect_cldr_words(reg) -> list:
    """[(phrase, lang_id, qprob)] deduplicated per (lang, phrase) keeping
    the highest qprob seen."""
    import babel.localedata as localedata

    best: dict = {}
    for locale_id in localedata.locale_identifiers():
        code = ALIASES.get(_base_lang(locale_id), _base_lang(locale_id))
        if code in SKIP_LANGS:
            continue
        lang = reg.code_to_lang.get(code)
        if lang is None:
            continue
        try:
            data = localedata.load(locale_id, merge_inherited=False)
        except Exception:  # noqa: BLE001 - a locale babel cannot load
            continue
        for key, q in SOURCES:
            node = data.get(key)
            if not node:
                continue
            for s in _strings_of(node):
                phrase = _clean_phrase(s)
                if not phrase or len(phrase) > 80:
                    continue
                k = (lang, phrase)
                if best.get(k, 0) < q:
                    best[k] = q
    return [(phrase, lang, q) for (lang, phrase), q in best.items()]


def collect_mo_phrases(reg) -> list:
    """[(phrase, lang_id, qprob)] from gettext catalogs (.mo) shipped
    inside installed packages (humanize etc.): translated UI sentences
    rich in the function words the octa delta tables deliberately omit
    (the reference's quad tables covered them). Depends on the host's
    installed packages."""
    import gettext
    import site
    out = []
    seen = set()
    roots = [Path(p) for p in site.getsitepackages()]
    for root in roots:
        for mo in root.glob("*/locale/*/LC_MESSAGES/*.mo"):
            code = mo.parent.parent.name.split("_")[0]
            code = ALIASES.get(code, code)
            if code in SKIP_LANGS:
                continue
            lang = reg.code_to_lang.get(code)
            if lang is None:
                continue
            try:
                with mo.open("rb") as f:
                    cat = gettext.GNUTranslations(f)._catalog
            except Exception:  # noqa: BLE001 - an unreadable catalog
                continue
            for msg in cat.values():
                for s in (msg if isinstance(msg, (list, tuple)) else [msg]):
                    phrase = _clean_phrase(s)
                    if not phrase or len(phrase) > 120:
                        continue
                    k = (lang, phrase)
                    if k not in seen:
                        seen.add(k)
                        out.append((phrase, lang, 8))
    return out


# English function words (sklearn's ENGLISH_STOP_WORDS is itself the
# classic Glasgow IR list): the delta-octa word source systematically
# lacks them because the reference's real quadgram tables already scored
# them (so they never made the "delta" cut).
def collect_english_stopwords(reg) -> list:
    try:
        from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS
    except ImportError:
        return []
    lang = reg.code_to_lang.get("en")
    if lang is None:
        return []
    return [(w, lang, 9) for w in sorted(ENGLISH_STOP_WORDS)]


def main():
    import collections

    from ..registry import registry
    words = collect_cldr_words(registry)
    mo = collect_mo_phrases(registry)
    sw = collect_english_stopwords(registry)
    print(f"mo phrases: {len(mo)}; en stopwords: {len(sw)}")
    words = words + mo + sw
    per_lang = collections.Counter(lang for _, lang, _ in words)
    print(f"phrases: {len(words)} across {len(per_lang)} languages")
    for lang, n in per_lang.most_common(10):
        print(f"  {registry.code(lang):10s} {n}")
    print("fewest:")
    for lang, n in per_lang.most_common()[-10:]:
        print(f"  {registry.code(lang):10s} {n}")


if __name__ == "__main__":
    main()
