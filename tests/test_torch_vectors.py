"""The torch port's per-range chunk vectors equal the reference's.

NgramBatchEngine.detect_batch(return_chunks=True) of the port
(device="cpu": a want_ranges pack and the plain scorer's full-output
words) against the JAX engine and the port's detect_scalar(want_chunks=
True), exactly (every chunk record and summary field), on the TEXTS of
tests/test_result_vector.py and the batch-agreement construction fuzz.
Also the rest of the detector's surface against the JAX detector: chunk
vectors through detect, detect_bytes, span_interchange_valid and
detect_language_version.
"""
from __future__ import annotations

import dataclasses
import random

import pytest

from language_detector_tpu.detector import LanguageDetector as JaxDetector
from language_detector_tpu.detector import \
    detect_language_version as jversion
from language_detector_tpu_torch import detect_language_version as tversion
from language_detector_tpu_torch.detector import \
    LanguageDetector as TorchDetector
from language_detector_tpu_torch.engine_scalar import detect_scalar
from language_detector_tpu_torch.models.ngram import NgramBatchEngine
from language_detector_tpu_torch.tables import DATA_DIR
from test_batch_agreement import _fill_fuzz_docs
from test_result_vector import TEXTS
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


def _vector(r) -> tuple:
    return (r.summary_lang, tuple(r.language3), tuple(r.percent3),
            tuple(r.normalized_score3), r.text_bytes, r.is_reliable,
            tuple((c.offset, c.bytes, c.lang1) for c in (r.chunks or [])))


def _docs(kind: str) -> list[str]:
    if kind == "result-vector-texts":
        return [t for plain, t in TEXTS if plain] + \
            ["buy cheap now " * 400, "word " * 600]
    # the batch-agreement fuzz (_fuzz_docs(48, seed=20260801)) over the
    # eval corpus: its golden texts need the reference snapshot
    texts = [ln.split("\t", 1)[1].rstrip("\n") for ln in
             open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")]
    docs: list = []
    _fill_fuzz_docs(docs, random.Random(20260801), texts, 48)
    return docs


@pytest.mark.parametrize("kind", ["result-vector-texts", "fuzz"])
def test_chunk_vectors_match_reference_and_scalar(eng, jax_eng, kind):
    docs = _docs(kind)
    before = eng.stats_snapshot()["device_dispatches"]
    got = [_vector(r) for r in eng.detect_batch(docs, return_chunks=True)]
    assert eng.stats_snapshot()["device_dispatches"] == before + 1
    assert got == [_vector(r) for r in
                   jax_eng.detect_batch(docs, return_chunks=True)]
    for text, g in zip(docs, got):
        want = detect_scalar(text, eng.tables, eng.reg, want_chunks=True)
        assert g == _vector(want), text[:60]
    assert sum(len(g[-1]) > 1 for g in got) > 3


def test_html_and_hinted_chunk_vectors_match_reference(eng, jax_eng):
    """return_chunks with HTML input or hints answers through the scalar
    engine, as the reference's engine routes it."""
    from language_detector_tpu.hints import CLDHints as JaxHints
    from language_detector_tpu_torch.hints import CLDHints
    html = [t for plain, t in TEXTS if not plain]
    got = eng.detect_batch(html, is_plain_text=False, return_chunks=True)
    want = jax_eng.detect_batch(html, is_plain_text=False,
                                return_chunks=True)
    assert [_vector(r) for r in got] == [_vector(r) for r in want]
    plain = [t for p, t in TEXTS if p][:8]
    got = eng.detect_batch(plain, hints=CLDHints(tld_hint="jp"),
                           return_chunks=True)
    want = jax_eng.detect_batch(plain, hints=JaxHints(tld_hint="jp"),
                                return_chunks=True)
    assert [_vector(r) for r in got] == [_vector(r) for r in want]


def test_detector_chunks_match_reference():
    """LanguageDetector.detect and detect_batch with return_chunks: the
    same DetectionResults, chunk ranges included, as the JAX
    detector's."""
    docs = [t for plain, t in TEXTS if plain][:10]
    td, jd = TorchDetector(device="cpu"), JaxDetector()
    assert [dataclasses.astuple(r) for r in
            td.detect_batch(docs, return_chunks=True)] == \
        [dataclasses.astuple(r) for r in
         jd.detect_batch(docs, return_chunks=True)]
    for d in docs[:5]:
        assert dataclasses.astuple(td.detect(d, return_chunks=True)) == \
            dataclasses.astuple(jd.detect(d, return_chunks=True))


BYTES_CASES = [b"hello world this is plainly english text",
               "Привет, как дела? Это русский текст.".encode(),
               b"abc \xff\xfe broken utf-8",
               b"valid prefix then \xed\xa0\x80 a surrogate",
               "tab\tand control \x01 chars".encode(),
               b"", "日本語のテキストです".encode()[:-1]]


@pytest.mark.parametrize("check_utf8", [True, False])
def test_detect_bytes_matches_reference(check_utf8):
    td, jd = TorchDetector(device="cpu"), JaxDetector()
    for data in BYTES_CASES:
        assert td.span_interchange_valid(data) == \
            jd.span_interchange_valid(data)
        assert dataclasses.astuple(td.detect_bytes(
            data, check_utf8=check_utf8)) == dataclasses.astuple(
            jd.detect_bytes(data, check_utf8=check_utf8)), data


def test_detect_language_version_matches_reference():
    assert tversion() == jversion()
    assert tversion().startswith("V")


def test_engine_stats():
    """engine_stats is {} until the batched engine is built, then its
    counters (one device dispatch for one plain batch of > 64 docs)."""
    td = TorchDetector(device="cpu")
    assert td.engine_stats() == {}
    td.detect_batch(["hello world"] * 70)
    st = td.engine_stats()
    assert st["batches"] >= 1 and st["device_dispatches"] >= 1
