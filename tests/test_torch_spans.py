"""The torch port's per-span verdicts equal the reference's.

NgramBatchEngine.detect_spans of the port (device="cpu": the plain
PyTorch scorer) against the JAX engine's detect_spans and the port's own
scalar oracle detect_scalar_spans, exactly (every summary field and
every span record), on a multi-script corpus, with the default budget
and with small budgets that force splits; spans tile the document's
bytes; LanguageDetector.detect_spans answers like the JAX detector's.
"""
from __future__ import annotations

import dataclasses

import pytest

from language_detector_tpu.evalsuite import corpus_pairs
from language_detector_tpu_torch.detector import \
    LanguageDetector as TorchDetector
from language_detector_tpu_torch.engine_scalar import (SPAN_SPLIT_SLOTS,
                                                       detect_scalar_spans)
from language_detector_tpu_torch.models.ngram import NgramBatchEngine
from torch_support import jax_packer

# while this worker collects, before any of its tests run
jax_packer()


@pytest.fixture(scope="module")
def eng():
    return NgramBatchEngine(device="cpu")


@pytest.fixture(scope="module")
def jax_eng():
    from language_detector_tpu.models.ngram import \
        NgramBatchEngine as JaxEngine
    return JaxEngine()


def _span_corpus() -> list:
    """The eval corpus's first 90 docs, cross-script concatenations (the
    docs that produce several spans), a long mixed document and
    degenerate ones."""
    pairs = corpus_pairs()
    texts = [t for _, t in pairs][:90]
    by_code = dict(pairs)
    mixes = [("en", "ru"), ("fr", "ja"), ("de", "ar"), ("es", "el"),
             ("it", "zh"), ("pt", "iw"), ("nl", "th"), ("sv", "ko"),
             ("pl", "hi"), ("tr", "uk")]
    for a, b in mixes:
        texts.append(by_code[a] + " " + by_code[b])
        texts.append(by_code[b] + " " + by_code[a] + " " + by_code[a])
    texts.append(" ".join(t for _, t in pairs[::3]))
    texts += ["", "a", "   ", "é", ("buy cheap now " * 200).strip()]
    return texts


def _records(r) -> tuple:
    return (r.summary_lang, tuple(r.language3), tuple(r.percent3),
            tuple(r.normalized_score3), r.is_reliable, r.text_bytes,
            tuple(tuple(s) for s in (r.spans or [])))


def test_spans_match_reference_and_scalar(eng, jax_eng):
    texts = _span_corpus()
    got = [_records(r) for r in eng.detect_spans(texts)]
    assert got == [_records(r) for r in jax_eng.detect_spans(texts)]
    for text, g in zip(texts, got):
        want = detect_scalar_spans(text, eng.tables, eng.reg, eng.flags,
                                   eng.longdoc_chunk_slots or
                                   SPAN_SPLIT_SLOTS)
        assert g == _records(want), text[:60]
    assert any(len(g[-1]) > 1 for g in got)


def test_spans_tile_document_bytes(eng):
    """Spans partition the document's bytes: offsets start at 0, are
    contiguous, and sum to the UTF-8 length."""
    texts = _span_corpus()
    for text, r in zip(texts, eng.detect_spans(texts)):
        nbytes = len(text.encode("utf-8"))
        if nbytes == 0:
            continue
        assert r.spans, text[:60]
        pos = 0
        for off, ln, code, pct, rel in r.spans:
            assert off == pos and ln > 0
            assert isinstance(code, str) and 0 <= pct <= 100
            assert isinstance(rel, bool)
            pos += ln
        assert pos == nbytes


@pytest.mark.parametrize("budget", [8, 64])
def test_small_budget_forces_splits(eng, budget):
    """A small sub-document budget splits every long doc into several
    spans; the records still equal the JAX engine's and the scalar
    oracle's at the same budget."""
    from language_detector_tpu.models.ngram import \
        NgramBatchEngine as JaxEngine
    small = NgramBatchEngine(eng.tables, eng.reg, device="cpu",
                             longdoc_chunk_slots=budget)
    jsmall = JaxEngine(longdoc_chunk_slots=budget)
    by_code = dict(corpus_pairs())
    texts = [(by_code["en"] + " " + by_code["ru"]) * 2,
             (by_code["ja"] + by_code["fr"]) * 3,
             by_code["ar"] + " " + by_code["el"] + " " + by_code["de"],
             " ".join(by_code.values())]
    got = [_records(r) for r in small.detect_spans(texts)]
    assert got == [_records(r) for r in jsmall.detect_spans(texts)]
    for text, g in zip(texts, got):
        assert g == _records(detect_scalar_spans(
            text, eng.tables, eng.reg, eng.flags, budget))
        assert len(g[-1]) > 1  # the budget actually split


def test_longdoc_budget_reads_environment(monkeypatch):
    """longdoc_chunk_slots=None reads LDT_LONGDOC_CHUNK_SLOTS (default
    0 in the port: the long-doc lane off, spans split at
    SPAN_SPLIT_SLOTS)."""
    monkeypatch.delenv("LDT_LONGDOC_CHUNK_SLOTS", raising=False)
    assert NgramBatchEngine(device="cpu").longdoc_chunk_slots == 0
    monkeypatch.setenv("LDT_LONGDOC_CHUNK_SLOTS", "64")
    assert NgramBatchEngine(device="cpu").longdoc_chunk_slots == 64
    monkeypatch.setenv("LDT_LONGDOC_CHUNK_SLOTS", "not-a-number")
    assert NgramBatchEngine(device="cpu").longdoc_chunk_slots == 0


def test_detector_spans_match_reference():
    """LanguageDetector.detect_spans: the same DetectionResults as the
    JAX detector's, spans included."""
    from language_detector_tpu.detector import \
        LanguageDetector as JaxDetector
    texts = ["hello world this is english text ok",
             "это русское предложение о языках",
             " ".join(t for _, t in corpus_pairs()[::3]), ""]
    got = TorchDetector(device="cpu").detect_spans(texts)
    want = JaxDetector().detect_spans(texts)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert got[2].spans and len(got[2].spans) > 1
