"""Per-range ResultChunkVector from the batched (device) path.

The reference exposes per-byte-range languages on its main Ext entry
points (compact_lang_det.h:147-154, :380) by post-processing scored
chunks on the host (SummaryBufferToVector scoreonescriptspan.cc:389-509,
SharpenBoundaries :780-845, FinishResultVector impl.cc:1688-1704). The
batched engine does the same: the packer's want_ranges sidecars carry
per-slot span/original offsets and per-chunk original byte ranges, the
device's full-output word adds lang2/rd/rs per chunk, and this module
replays the EXACT scalar-path algorithms — boundary sharpening over the
resolved hit lanes, then the shared merge_mapped_records — so the
batched vector agrees with the scalar engine (itself oracle-pinned,
tests/test_result_vector.py) document for document.

Sharpening runs only on the vector path, exactly like the reference,
and shifts chunk byte counts BEFORE the document epilogue consumes them
— build_doc_records therefore also edits the epilogue rows in place.
"""
from __future__ import annotations

import numpy as np

from .engine_scalar import (UNKNOWN_LANGUAGE, _better_boundary,
                            _same_close_set, merge_mapped_records)
from .registry import Registry
from .tables import ScoringTables


def _sharpen_round(reg: Registry, lg: np.ndarray, ulscript: int,
                   offs: list, origs: list, lps: list,
                   chunk_starts: list, langs: list,
                   starts_out: list, deltas_out: list) -> None:
    """SharpenBoundaries (scoreonescriptspan.cc:780-845) over one hit
    round's filtered linear lanes; identical control flow to the scalar
    engine's _sharpen_boundaries. starts_out[i] (original-byte chunk
    starts) and deltas_out[i] (span-coord byte shifts) update in place;
    chunk_starts updates so later boundaries see earlier moves."""
    n = len(langs)
    if n < 2:
        return
    lps = np.asarray(lps)
    prior_linear = chunk_starts[0]
    prior_lang = langs[0]
    for i in range(1, n):
        this_lang = langs[i]
        if this_lang == prior_lang:
            prior_linear = chunk_starts[i]
            continue
        this_linear = chunk_starts[i]
        next_linear = chunk_starts[i + 1]
        if _same_close_set(reg, prior_lang, this_lang):
            prior_linear = this_linear
            prior_lang = this_lang
            continue
        pslang0 = reg.per_script_number(ulscript, prior_lang)
        pslang1 = reg.per_script_number(ulscript, this_lang)
        better = _better_boundary(lps, lg, pslang0, pslang1,
                                  prior_linear, this_linear, next_linear)
        old_offset = offs[this_linear]
        new_offset = offs[better]
        chunk_starts[i] = better
        starts_out[i] = origs[better]
        deltas_out[i] -= new_offset - old_offset
        deltas_out[i - 1] += new_offset - old_offset
        prior_linear = better
        prior_lang = this_lang


def build_doc_records(b: int, cb, rows: np.ndarray, rows2: np.ndarray,
                     cstart_flat: np.ndarray, cat_ind2: np.ndarray,
                     tables: ScoringTables, reg: Registry):
    """One packed document -> mapped chunk records for
    merge_mapped_records, or None when the doc's offsets cannot map back
    (squeeze/repeat rewrites — the caller resolves such docs via the
    scalar engine). Also applies the sharpened byte shifts to rows[:, 1]
    (the epilogue's chunk byte weights), mirroring the scalar vector
    path where sharpening precedes the DocTote adds."""
    if cb.fallback[b] or cb.squeezed[b]:
        return None
    r = cb.ranges
    g0 = int(cb.doc_chunk_start[b])
    nc = int(cb.n_chunks[b])
    idx = cb.wire["idx"].reshape(-1)
    cnsl = cb.wire["cnsl"].reshape(-1)
    cscript = cb.wire["cscript"].reshape(-1)
    soff = r["soff"].reshape(-1)
    sorig = r["sorig"].reshape(-1)
    clo = r["clo"].reshape(-1)
    chi = r["chi"].reshape(-1)
    crid = r["crid"].reshape(-1)
    cdir = r["cdir"].reshape(-1)
    lg = tables.lg_prob

    # direct-add chunk -> language (doc-local chunk position, packer
    # dadds rows [chunk_pos, lang, bytes], -1-terminated)
    dir_lang = {}
    for pos, lang, _ in cb.direct_adds[b]:
        if pos < 0:
            break
        dir_lang[int(pos)] = int(lang)

    chunks = range(g0, g0 + nc)
    if any(clo[c] < 0 for c in chunks):
        return None  # unmappable range (rewritten span)

    # per-chunk working state
    langs1 = [int(rows[c, 0]) for c in chunks]
    starts = [int(clo[c]) for c in chunks]
    deltas = [0] * nc

    # sharpen per hit round (consecutive same-rid non-direct chunks)
    i = 0
    while i < nc:
        if cdir[g0 + i]:
            i += 1
            continue
        j = i
        while j < nc and not cdir[g0 + j] and \
                crid[g0 + j] == crid[g0 + i]:
            j += 1
        if j - i >= 2:
            offs: list = []
            origs: list = []
            lps: list = []
            chunk_starts: list = []
            for k in range(i, j):
                c = g0 + k
                chunk_starts.append(len(offs))
                s0 = int(cstart_flat[c])
                for s in range(s0, s0 + int(cnsl[c])):
                    if soff[s] < 0:
                        continue  # boost/hint slot: not a linear hit
                    offs.append(int(soff[s]))
                    origs.append(int(sorig[s]))
                    lps.append(int(cat_ind2[int(idx[s])]))
            chunk_starts.append(len(offs))
            sub_starts = starts[i:j]
            sub_deltas = deltas[i:j]
            _sharpen_round(reg, lg, int(cscript[g0 + i]), offs, origs,
                           lps, chunk_starts, langs1[i:j], sub_starts,
                           sub_deltas)
            starts[i:j] = sub_starts
            deltas[i:j] = sub_deltas
        i = j

    # apply byte shifts to the epilogue rows (vector-path DocTote
    # weights use the SHARPENED chunk bytes, impl.cc:1099-1111)
    for k in range(nc):
        if deltas[k]:
            rows[g0 + k, 1] += deltas[k]

    # records in scalar round-id order: hit rounds and JustOneItem spans
    # consume ids from one sequence (scalar ctx.round_id)
    recs: list = []
    rid_seq = -1
    prev_crid = None
    for k in range(nc):
        c = g0 + k
        if cdir[c]:
            rid_seq += 1
            prev_crid = None
            recs.append((rid_seq, int(clo[c]), int(chi[c]),
                         dir_lang.get(k, UNKNOWN_LANGUAGE),
                         UNKNOWN_LANGUAGE, 100, 100, True))
            continue
        if prev_crid is None or crid[c] != prev_crid:
            rid_seq += 1
            prev_crid = crid[c]
        recs.append((rid_seq, starts[k], int(chi[c]), langs1[k],
                     int(rows2[c, 0]), int(rows2[c, 1]),
                     int(rows2[c, 2]), False))
    return recs


def chunks_for_doc(text: str, records: list, reg: Registry):
    """Mapped records -> ResultChunk vector over the original bytes."""
    raw = text.encode("utf-8", "surrogatepass")
    return merge_mapped_records(raw, records, reg)


# -- long-doc chunk merge (the engine's longdoc lane) ------------------------


def merge_longdoc_chunks(rows: np.ndarray, cb, groups: list,
                         keep_spans: bool = False):
    """Per-chunk score rows of span-aligned sub-documents -> one virtual
    document per group, ready for the flat epilogue.

    `rows` is the fetched [G, 5] chunk-summary array for a ChunkBatch
    whose B docs are sub-documents (preprocess/pack.py split_longdoc);
    `groups` lists (first_subdoc, n_subdocs) per original document, in
    order, covering all B sub-docs. Returns (merged_rows, merged_cb):
    merged_cb is a ChunkBatch-shaped view whose doc b replays exactly
    the chunk sequence the unsplit document would have produced —
    sub-doc row slices concatenate in source order, direct-add chunk
    ids shift by the chunks of prior sub-docs (they are doc-local in
    the wire, epilogue.cc ldt_epilogue_flat), text bytes sum, and
    fallback/squeeze on ANY sub-doc marks the whole document (those
    resolve via the scalar engine, same as an unsplit fallback). The
    DocTote is purely additive over chunks, so epilogue(merged) ==
    epilogue(unsplit) whenever the split was span-exact.

    keep_spans=True returns (merged_rows, merged_cb, span_rows):
    span_rows[j] lists one (row_start, n_chunks, text_bytes) record per
    sub-document of group j, with row_start indexing into merged_rows —
    the per-sub-doc verdict rows the merge used to discard (the
    LDT_SPANS surface replays the epilogue over each slice for per-span
    verdicts; tests/test_longdoc_span_merge.py pins that the retained
    slices sum exactly to the merged totals)."""
    from .native import ChunkBatch
    rows = np.asarray(rows)
    n_out = len(groups)
    total_chunks = int(cb.n_chunks.sum())
    merged_rows = np.zeros((max(total_chunks, 1), rows.shape[1]),
                           np.int32)
    # widest merged direct-add row set decides the output Dcap
    dcap = 1
    for s, n in groups:
        valid = int((cb.direct_adds[s:s + n, :, 0] >= 0).sum())
        dcap = max(dcap, valid)
    doc_chunk_start = np.zeros(n_out, np.int64)
    direct_adds = np.full((n_out, dcap, 3), -1, np.int32)
    text_bytes = np.zeros(n_out, np.int32)
    fallback = np.zeros(n_out, bool)
    squeezed = np.zeros(n_out, bool)
    n_slots = np.zeros(n_out, np.int32)
    n_chunks = np.zeros(n_out, np.int32)

    span_rows: list = [[] for _ in range(n_out)] if keep_spans else []
    pos = 0  # write cursor in merged_rows
    for j, (s, n) in enumerate(groups):
        doc_chunk_start[j] = pos
        chunk_off = 0  # doc-local chunk ids of later sub-docs shift up
        nd = 0
        for i in range(s, s + n):
            nc = int(cb.n_chunks[i])
            g0 = int(cb.doc_chunk_start[i])
            merged_rows[pos:pos + nc] = rows[g0:g0 + nc]
            if keep_spans:
                span_rows[j].append((pos, nc, int(cb.text_bytes[i])))
            for pos_d in range(cb.direct_adds.shape[1]):
                c, lang, nbytes = cb.direct_adds[i, pos_d]
                if c < 0:
                    break
                direct_adds[j, nd] = (int(c) + chunk_off, lang, nbytes)
                nd += 1
            pos += nc
            chunk_off += nc
            text_bytes[j] += int(cb.text_bytes[i])
            fallback[j] |= bool(cb.fallback[i])
            squeezed[j] |= bool(cb.squeezed[i])
            n_slots[j] += int(cb.n_slots[i])
        n_chunks[j] = chunk_off
    merged = ChunkBatch(wire={}, doc_chunk_start=doc_chunk_start,
                        direct_adds=direct_adds, text_bytes=text_bytes,
                        fallback=fallback, squeezed=squeezed,
                        n_slots=n_slots, n_chunks=n_chunks,
                        n_docs=n_out)
    if keep_spans:
        return merged_rows, merged, span_rows
    return merged_rows, merged
