"""Regenerate the expected-score table from a labeled corpus.

The port of the reference package's tools/gen_expected_score.py (the
rebuild of CLD2's cld2_do_score, cld2_do_score.cc:34-270): detect every
labeled line, and for lines whose top-1 language matches the label,
accumulate raw score and bytes per (language, script4); each table cell
is then round(total_score * 1024 / total_bytes) — the kAvgDeltaOctaScore
"expected score per KB" that drives ReliabilityExpected
(cldutil.cc:587-605).

Input: a TSV of "code<TAB>text" lines (the eval harness format),
streamed in 65,536-line blocks. The label's script4 comes from the
document's dominant RTypeMany span (TSV labels are bare codes).
Detection runs the port's batched engine (detect_many) on --device:
cuda by default, which raises without CUDA; cpu scores with the plain
PyTorch version. There is no scalar fallback.

Output: an npz holding `expected_score_override` [614, 4] int16 plus a
coverage report. Not applied to the live tables: expected scores
trained on unrepresentative text mis-calibrate ReliabilityExpected, so
the array is copied into the tables deliberately.

Usage:
  python -m language_detector_tpu_torch.tools.gen_expected_score
      --corpus file.tsv --out exp.npz [--limit N] [--device {cuda,cpu}]
"""
from __future__ import annotations

import argparse

import numpy as np

from .eval_corpus import iter_pairs

BLOCK = 65536  # lines per streamed detection block


def _doc_script4(text: str, tables, reg) -> int:
    """script4 of the document's dominant RTypeMany span (Latn=0,
    Cyrl=1, Arab=2, other=3 — ops/score.py _lscript4)."""
    from ..preprocess.segment import segment_text
    best = (0, 0)  # (bytes, script)
    for span in segment_text(text, tables):
        if reg.rtype(span.ulscript) >= 2 and span.text_bytes > best[0]:
            best = (span.text_bytes, span.ulscript)
    s = best[1]
    return 0 if s == 1 else 1 if s == 3 else 2 if s == 6 else 3


def expected_scores(pair_iter, detect, tables, reg) -> tuple:
    """(table [n_lang, 4] int16, lines, label-agreeing lines): detect
    maps a block of texts to results carrying language3,
    normalized_score3 and text_bytes."""
    n_lang = reg.num_languages
    score = np.zeros((n_lang, 4), np.float64)
    byts = np.zeros((n_lang, 4), np.float64)
    n_match = n_lines = 0
    code_to_lang = reg.code_to_lang

    def flush(block):
        nonlocal n_match, n_lines
        results = detect([t for _, t in block])
        n_lines += len(block)
        for (label, text), r in zip(block, results):
            lang = code_to_lang.get(label)
            if lang is None or r.language3[0] != lang:
                continue  # only label-agreeing lines (cld2_do_score)
            s4 = _doc_script4(text, tables, reg)
            # the reference's exact accumulation (cld2_do_score.cc:255):
            # normalized_score3[0] (score per 1024 bytes) x text_bytes /
            # 1024 — including its approximation on multilingual lines,
            # where the score is normalized by per-language bytes but
            # weighted here by whole-document bytes
            score[lang, s4] += r.normalized_score3[0] * r.text_bytes \
                / 1024.0
            byts[lang, s4] += r.text_bytes
            n_match += 1

    # stream in blocks: multi-GB corpora never materialize
    block: list = []
    for pair in pair_iter:
        block.append(pair)
        if len(block) >= BLOCK:
            flush(block)
            block = []
    if block:
        flush(block)

    table = np.round(score * 1024.0 / np.maximum(byts, 1.0)) \
        .astype(np.int16)
    return table, n_lines, n_match


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default=None,
                    help="TSV code<TAB>text (default: golden suite)")
    ap.add_argument("--out", default="expected_score.npz")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without CUDA) or cpu "
                         "(the plain PyTorch scorer)")
    args = ap.parse_args(argv)

    from ..models.ngram import NgramBatchEngine
    from ..registry import registry
    from ..tables import load_tables
    tables = load_tables()
    eng = NgramBatchEngine(tables, registry, device=args.device)
    table, n_lines, n_match = expected_scores(
        iter_pairs(args.corpus, args.limit), eng.detect_many, tables,
        registry)
    n_lang = table.shape[0]
    covered = int((table > 0).sum())
    cur = tables.avg_delta_octa_score.astype(np.int32)
    both = (table > 0) & (cur[:n_lang] > 0)
    drift = (np.abs(table[both] - cur[:n_lang][both]).mean()
             if both.any() else 0.0)
    np.savez_compressed(args.out, expected_score_override=table)
    print(f"{n_lines} lines, {n_match} label-agreeing; "
          f"{covered} (lang, script4) cells covered; "
          f"mean |delta| vs current table on shared cells: {drift:.1f}")
    print(f"wrote {args.out} (apply deliberately — see module docstring)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
