"""HTML stripping for non-plain-text input.

The reference interleaves tag skipping and entity expansion with its
script scanner (GetOneScriptSpan's kTagParseTbl_0 state machine,
getonescriptspan.cc:150-196, and ReadEntity/EntityToBuffer :393-480). The
TPU-first design separates concerns: one host pre-pass turns HTML into
the equivalent clean text (tags become a single non-letter, entities
become their decoded characters), and the unchanged plain-text
segmentation/packing pipeline runs on the result. An offset map from
cleaned characters back to original character positions supports
per-range results.

Tag grammar reproduced from the reference state machine:
  - '<' opens a tag; it ends at '>'; quoted attribute values ("..."
    '...') may contain '>' / '<'
  - another '<' inside an unquoted tag body aborts: the original '<' is
    treated as a plain character (kTagParseTbl_0 state 3/9 column '<')
  - '<!--' comments run to '-->'
  - <script> and <style> swallow their content through the matching
    close tag
  - an unterminated construct swallows the rest of the input

Entity grammar (ReadEntity, getonescriptspan.cc:393-449): numeric
entities (&#123; &#x1F;) end at the first non-digit; named entities end
at the first non-alphanumeric; values >= 256 must be ';'-terminated
(the IE6 '&lang=' URL compatibility rule); a ';' terminator is consumed.
Values are clamped like FixUnicodeValue (surrogates/overflow -> U+FFFD,
C0/C1 controls preserved, fixunicodevalue.cc:22-54).
"""
from __future__ import annotations

import numpy as np

from ..tables import ScoringTables, load_tables

_WS = " \t\r\n"


def _fix_unicode_value(cp: int) -> int:
    """FixUnicodeValue (fixunicodevalue.cc:22-54)."""
    if 0 <= cp < 0xD800:
        return cp
    if 0xE000 <= cp <= 0x10FFFF:
        return cp
    return 0xFFFD


class _Entities:
    def __init__(self, tables: ScoringTables):
        self.map = {str(n): int(v) for n, v in
                    zip(tables.entity_names, tables.entity_values)}


_entities_cache: tuple = ()


def _entity_map(tables: ScoringTables) -> dict:
    global _entities_cache
    if _entities_cache and _entities_cache[0] is tables:
        return _entities_cache[1]
    m = _Entities(tables).map
    _entities_cache = (tables, m)
    return m


def _read_entity(text: str, i: int, entities: dict) -> tuple:
    """(codepoint | None, chars_consumed) for the '&' at text[i]."""
    n = len(text)
    j = i + 1
    if j >= n:
        return None, 1
    if text[j] == "#":
        if j + 2 >= n:
            return None, 1
        if text[j + 1] in "xX":
            k = j + 2
            start = k
            val = 0
            while k < n and text[k] in "0123456789abcdefABCDEF":
                val = min(val * 16 + int(text[k], 16), 0x110000)
                k += 1
            if k == start:
                return None, 1
        else:
            k = j + 1
            start = k
            val = 0
            while k < n and text[k].isdigit():
                val = min(val * 10 + int(text[k]), 0x110000)
                k += 1
            if k == start:
                return None, 1
        end = k
    else:
        k = j
        while k < n and text[k].isalnum() and ord(text[k]) < 128:
            k += 1
        name = text[j:k]
        if name not in entities:
            return None, 1
        val = entities[name]
        # IE6 rule: high-value entities require the ';' terminator
        if val >= 256 and not (k < n and text[k] == ";"):
            return None, 1
        end = k
    if end < n and text[end] == ";":
        end += 1
    return _fix_unicode_value(val), end - i


def _nl_or_gt_class(c: str) -> bool:
    """True for '>' and the CR/NL byte classes of kCharToSub
    (getonescriptspan.cc:81-103): ASCII whitespace/digits/punctuation
    other than the special tag chars. Non-ASCII characters present their
    UTF-8 LEAD byte (0xC2..) to the reference state machine, which is PL
    class — ordinary-tag routing."""
    if c == ">" or c in "\r\n":
        return True
    o = ord(c)
    if o >= 0x80:
        return False
    return not c.isalpha() and c not in "!\"&'-/<>"


def _skip_element_content(lower: str, i: int, elem: str) -> int:
    """Consume from '<elem' through the matching '</elem...>' (or to end
    of input), mirroring kTagParseTbl states 19-27/32-39 (CR/NL may
    separate '</' from the element name)."""
    n = len(lower)
    k = i + 1 + len(elem)
    close = "</"
    while k < n:
        idx = lower.find(close, k)
        if idx < 0:
            return n - i
        j = idx + 2
        while j < n and lower[j] in "\r\n":
            j += 1
        if lower.startswith(elem, j):
            end = lower.find(">", j + len(elem))
            return (n - i) if end < 0 else (end + 1 - i)
        k = idx + 2
    return n - i


def _skip_tag(text: str, lower: str, i: int) -> int:
    """Characters consumed from the '<' at text[i] (1 = treat '<' as a
    plain character)."""
    n = len(text)
    # comment?
    if text.startswith("<!--", i):
        end = text.find("-->", i + 4)
        return (n - i) if end < 0 else (end + 3 - i)
    # <script> / <style> swallow their content when the element name is
    # followed by '>', CR/NL, or any NL-class byte (whitespace, digit,
    # most punctuation — kCharToSub, getonescriptspan.cc:81-103; state
    # 18/31 routes those to the content states, so attributed
    # <script src=...> swallows too); a letter or one of !"&'-/< routes
    # to the ordinary-tag states instead (e.g. <scripts>)
    for elem in ("script", "style"):
        nxt = i + 1 + len(elem)
        if lower.startswith(elem, i + 1) and nxt < n and \
                _nl_or_gt_class(text[nxt]):
            return _skip_element_content(lower, i, elem)
    # ordinary tag: find '>' honoring quoted attribute values; a bare '<'
    # inside aborts (state 3/9 column '<'); a newline inside a quote
    # drops quote handling for the rest of the tag (state 10/11 -> 12)
    j = i + 1
    quote = None
    no_more_quotes = False
    while j < n:
        c = text[j]
        if quote is not None:
            if c == quote:
                quote = None
            elif c in "\r\n":
                quote = None
                no_more_quotes = True
        elif c == ">":
            break
        elif not no_more_quotes and c in "\"'":
            quote = c
        elif c == "<":
            return 1  # kTagParseTbl state 3/9 column '<': not a tag
        j += 1
    if j >= n:
        return n - i  # unterminated tag swallows the rest
    return j + 1 - i


def clean_html(text: str, tables: ScoringTables | None = None) -> tuple:
    """HTML -> (clean text, offsets): tags collapse to one space, entities
    decode in place. offsets[k] = original character index that produced
    clean[k] (space separators map to the position they replaced)."""
    tables = tables or load_tables()
    entities = _entity_map(tables)
    out: list = []
    offs: list = []
    i = 0
    n = len(text)
    lower = text.lower()
    while i < n:
        c = text[i]
        if c == "<":
            took = _skip_tag(text, lower, i)
            if took == 1:
                out.append("<")
                offs.append(i)
                i += 1
            else:
                out.append(" ")
                offs.append(i)
                i += took
        elif c == "&":
            cp, took = _read_entity(text, i, entities)
            if cp is not None and cp > 0:
                out.append(chr(cp))
                offs.append(i)
            # invalid entity: the '&' is consumed and dropped entirely,
            # so adjacent letters join ("R&D" -> "RD"; EntityToBuffer
            # getonescriptspan.cc:471-479 take=1, put=0)
            i += took
        else:
            out.append(c)
            offs.append(i)
            i += 1
    return "".join(out), np.array(offs, dtype=np.int32)
