"""Host-side script segmentation: UTF-8 text -> per-script letter spans.

TPU-first split of responsibilities: everything byte-level and inherently
sequential (codepoint decode, letters-vs-rest classification, script runs,
lowercasing, whitespace collapsing) runs on the host; the output spans are
clean " letters letters " byte buffers ready for vectorized n-gram hashing
and device scoring.

Behavioral contract follows the reference scanner
(getonescriptspan.cc:799 GetOneScriptSpan / :1033 LowerScriptSpan /
:1059 GetOneScriptSpanLower): spans contain lowercased letters/marks of a
single script, non-letter runs collapsed to one space, with a leading space
and trailing "   \\0"; spans are capped at ~40KB.

Classification and lowercasing use the per-codepoint tables extracted from
the reference's UTF-8 DFAs (utf8prop_lettermarkscriptnum.h,
utf8repl_lettermarklower.h), so letter/script/case decisions are identical.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from ..tables import ScoringTables, load_tables

# kMaxScriptBytes = kMaxScriptBuffer - 32 = 40928 (getonescriptspan.h:29-32);
# the letter loop hard-stops there, the outer loop soft-stops a word earlier.
MAX_SPAN_PUT_BYTES = 40960 - 32
SOFT_SPAN_PUT_BYTES = MAX_SPAN_PUT_BYTES - 32  # kWithinScriptTail
# Buffer tail: " \x20\x20\x20\x00" plus slack so 32-bit gram loads with up to
# 20-byte group offsets never run off the end (hashing.py contract).
_TAIL_PAD = 32


def utf8_len_of_cps(cps) -> np.ndarray:
    """UTF-8 encoded byte length per codepoint (shared across preprocess)."""
    cps = np.asarray(cps)
    return np.where(cps < 0x80, 1,
                    np.where(cps < 0x800, 2,
                             np.where(cps < 0x10000, 3, 4)))


@dataclasses.dataclass
class ScriptSpan:
    """One same-script letters-only span (reference LangSpan, langspan.h)."""

    buf: np.ndarray        # uint8 bytes: b' ' + text + b'   \0' + pad
    text_bytes: int        # length counted like the reference: 1 + letters
    ulscript: int          # ULScript id
    cps: np.ndarray        # decoded codepoints of buf[:text_bytes+1]
    # source char index per buffer byte [text_bytes + 1]: maps span-buffer
    # offsets back to the segment_text input (the per-range results
    # equivalent of the reference's composed OffsetMaps, offsetmap.cc)
    src_idx: np.ndarray | None = None

    @property
    def text(self) -> bytes:
        return self.buf[:self.text_bytes].tobytes()


@lru_cache(maxsize=1)
def _lower_table() -> np.ndarray:
    """Full codepoint -> lowercase-codepoint map (identity unless mapped)."""
    t = load_tables()
    lower = np.arange(0x110000, dtype=np.uint32)
    lower[t.lower_pairs[:, 0]] = t.lower_pairs[:, 1]
    return lower


def _decode_utf32(text: str) -> np.ndarray:
    # surrogatepass: lone surrogates (e.g. from surrogatepass-decoded
    # byte input) must detect as non-letters, not crash — the native
    # packer round-trips them through UTF-8 the same way
    return np.frombuffer(text.encode("utf-32-le", "surrogatepass"),
                         dtype=np.uint32)


def segment_text(text: str,
                 tables: ScoringTables | None = None,
                 is_plain_text: bool = True) -> list[ScriptSpan]:
    """Split text into per-script spans of lowercased letters.

    is_plain_text=False first strips HTML tags and expands entities
    (preprocess/html.py), the separated-concerns equivalent of the
    reference scanner's inline tag state machine (getonescriptspan.cc
    :150-196, :393-480).

    (The reference computes a 160KB textlimit, compact_lang_det_impl.cc:1811,
    but never consults it in this version; the whole document is scanned.)
    """
    tables = tables or load_tables()
    if not is_plain_text:
        from .html import clean_html
        text, _ = clean_html(text, tables)
    cps = _decode_utf32(text)
    if len(cps) == 0:
        return []

    ULSCRIPT_INHERITED = 40
    capped = np.minimum(cps, 0x10FFFF)
    script = tables.script_of_cp[capped].tolist()
    lower_cps = _lower_table()[capped].tolist()
    # Original-case UTF-8 byte length per codepoint: the reference scanner's
    # buffer-size accounting runs before lowercasing.
    u8len = utf8_len_of_cps(capped).tolist()
    n = len(cps)

    # Cumulative raw byte offsets, for the near-end soft-limit rule
    byte_before = [0]
    for l in u8len:
        byte_before.append(byte_before[-1] + l)
    total_bytes = byte_before[-1]

    spans: list[ScriptSpan] = []
    i = 0
    while i < n:
        # Near the end of input, split the last two fragments evenly instead
        # of leaving a runt (getonescriptspan.cc:814-819).
        remaining = total_bytes - byte_before[i]
        soft_limit = SOFT_SPAN_PUT_BYTES
        if MAX_SPAN_PUT_BYTES <= remaining < 2 * MAX_SPAN_PUT_BYTES:
            soft_limit = remaining // 2
        # SkipToFrontOfSpan: advance to the first letter; its script (even
        # Inherited) names the span (getonescriptspan.cc:592-642, :855).
        while i < n and script[i] == 0:
            i += 1
        if i >= n:
            break
        spanscript = script[i]
        cur: list[int] = []
        cur_src: list[int] = []
        put = 1  # leading space, counted like the reference's put cursor

        # Alternate letter runs and non-letter runs (single space each)
        # until a letter of a genuinely different script, a full buffer, or
        # end of input (getonescriptspan.cc:858-1000).
        while i < n:
            # --- letter run ---
            while i < n:
                sc = script[i]
                if sc == 0:
                    break  # non-letter ends the run
                if sc != spanscript and sc != ULSCRIPT_INHERITED:
                    # Allow one embedded foreign letter when the following
                    # character is Common or back in-script
                    # (getonescriptspan.cc:900-930).
                    sc2 = script[i + 1] if i + 1 < n else 0
                    if sc2 != 0 and sc2 != spanscript:
                        break  # genuine script change: span ends here
                cur.append(lower_cps[i])
                cur_src.append(i)
                put += u8len[i]
                i += 1
                if put >= MAX_SPAN_PUT_BYTES:
                    break  # buffer full (truncated span)
            # --- non-letter run -> single separating space ---
            cur.append(0x20)
            cur_src.append(min(i, n - 1))
            put += 1
            while i < n and script[i] == 0:
                i += 1
            if i >= n:
                break
            if script[i] != spanscript and script[i] != ULSCRIPT_INHERITED:
                break  # next letter belongs to a different span
            if put >= soft_limit:
                break  # almost-full buffer: stop at this word boundary

        if len(cur) > 1:
            spans.append(_build_span(cur, spanscript, cur_src))
    return spans


def _build_span(span_cps: list[int], ulscript: int,
                src: list[int] | None = None) -> ScriptSpan:
    cps = np.array([0x20] + span_cps, dtype=np.uint32)
    text = cps.tobytes().decode("utf-32-le", "surrogatepass") \
        .encode("utf-8", "surrogatepass")
    buf = np.zeros(len(text) + _TAIL_PAD, dtype=np.uint8)
    buf[:len(text)] = np.frombuffer(text, dtype=np.uint8)
    buf[len(text):len(text) + 3] = 0x20  # trailing "   " then NULs
    src_idx = None
    if src is not None:
        # span-buffer byte -> source char: repeat each cp's source index
        # by its encoded length (leading space inherits the first letter)
        lens = utf8_len_of_cps(cps).astype(np.int64)
        per_cp = np.array([src[0] if src else 0] + src, dtype=np.int32)
        src_idx = np.repeat(per_cp, lens)
        src_idx = np.concatenate([src_idx, src_idx[-1:]])
    # text_bytes counts the leading space + letters (reference convention:
    # scriptspan.text[0]==' ' and text[text_bytes]==' ').
    return ScriptSpan(buf=buf, text_bytes=len(text), ulscript=int(ulscript),
                      cps=np.concatenate([cps, [0x20]]).astype(np.uint32),
                      src_idx=src_idx)
