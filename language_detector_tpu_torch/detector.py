"""Public detection API.

`LanguageDetector` wraps the engines: the scalar host engine (reference
semantics, used for validation and as fallback for rare recursion paths) and
the batched engine (models/ngram.py), which scores on a CUDA card unless the
caller asks for the CPU. Mirrors the service surface of the reference wrapper
(wrapper.cc:7-16 detect_language) and the richer ExtDetectLanguageSummary
(compact_lang_det.h:168-426): hints, HTML input, per-range chunk vectors and
per-span verdicts.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import native
from .engine_scalar import (ScalarResult, detect_scalar,
                            result_from_epilogue_row)
from .registry import Registry, UNKNOWN_LANGUAGE, registry as default_registry
from .tables import ScoringTables, load_tables


@dataclasses.dataclass
class DetectionResult:
    """Top-3 detection result (compact_lang_det.h:147-165 contract)."""

    language: str             # ISO code of summary language ("un" if unknown)
    language_id: int
    is_reliable: bool
    top3: list                # [(code, percent, normalized_score)] * 3
    text_bytes: int
    # bytes of the longest interchange-valid UTF-8 prefix; set by the
    # CheckUTF8 entry points (compact_lang_det.h:168+ *CheckUTF8 contract)
    valid_prefix_bytes: int | None = None
    # per-range results: [(offset, bytes, iso_code)] covering the original
    # input when requested (ResultChunkVector, compact_lang_det.h:147-154)
    chunks: list | None = None
    # per-span verdicts: [(byte_offset, byte_len, iso_code, percent,
    # reliable)] tiling the document (LDT_SPANS surfaces; span contract
    # in docs/ACCURACY.md — engine_scalar.span_coverage_records)
    spans: list | None = None

    @classmethod
    def from_scalar(cls, r: ScalarResult, reg: Registry) -> "DetectionResult":
        return cls(
            language=reg.code(r.summary_lang),
            language_id=r.summary_lang,
            is_reliable=r.is_reliable,
            top3=[(reg.code(l), p, s) for l, p, s in
                  zip(r.language3, r.percent3, r.normalized_score3)],
            text_bytes=r.text_bytes,
            chunks=None if r.chunks is None else
            [(c.offset, c.bytes, reg.code(c.lang1)) for c in r.chunks],
            spans=getattr(r, "spans", None),
        )


class LanguageDetector:
    """Configurable detector over a table artifact."""

    def __init__(self, tables: ScoringTables | None = None,
                 reg: Registry | None = None, flags: int = 0,
                 device=None):
        """device: None = "cuda" (raises without CUDA); "cpu" runs the
        batched engine's plain PyTorch scorer."""
        from .models.ngram import resolve_device
        self.device = resolve_device(device)
        self.tables = tables or load_tables()
        self.registry = reg or default_registry
        self.flags = flags
        self._batch_engine = None  # lazily built batched engine

    def detect(self, text: str, is_plain_text: bool = True,
               hints=None, return_chunks: bool = False) -> DetectionResult:
        """hints: optional hints.CLDHints (content-language / TLD /
        encoding / explicit language priors; ExtDetectLanguageSummary
        contract, compact_lang_det.h:168+). return_chunks additionally
        fills `.chunks` with per-byte-range languages over the original
        input (the ResultChunkVector overload, compact_lang_det.h:380).

        Plain, unhinted, chunk-less calls run the all-C single-document
        pipeline (native detect_one_row: pack -> C chunk scorer ->
        epilogue -> gate recursion, agreement-pinned against the device
        and scalar engines). Hints, HTML, chunk vectors, non-default
        flags, docs past the C seam's 160KB reference subset, or no
        native library keep the scalar engine."""
        if (is_plain_text and hints is None and not return_chunks
                and self.flags == 0):
            row = native.detect_one_native(text, self.tables,
                                           self.registry)
            if row is not None:
                return DetectionResult.from_scalar(
                    result_from_epilogue_row(row), self.registry)
        r = detect_scalar(text, self.tables, self.registry, self.flags,
                          is_plain_text=is_plain_text, hints=hints,
                          want_chunks=return_chunks)
        return DetectionResult.from_scalar(r, self.registry)

    def span_interchange_valid(self, data: bytes) -> int:
        """Length of the longest structurally-valid, interchange-valid
        UTF-8 prefix (SpanInterchangeValid, compact_lang_det_impl.cc:74-80
        over the utf8acceptinterchange scanner)."""
        try:
            text = data.decode("utf-8")
            struct_ok = len(data)
        except UnicodeDecodeError as e:
            struct_ok = e.start
            text = data[:e.start].decode("utf-8")
        if not text:
            return 0
        cps = np.frombuffer(text.encode("utf-32-le"), np.uint32)
        ok = self.tables.interchange_ok[cps] != 0
        if ok.all():
            return struct_ok
        bad = int(np.argmin(ok))
        return len(text[:bad].encode("utf-8"))

    def detect_bytes(self, data: bytes, is_plain_text: bool = True,
                     check_utf8: bool = True,
                     hints=None) -> DetectionResult:
        """Detect raw UTF-8 bytes. With check_utf8 (the reference's
        *CheckUTF8 entry points, compact_lang_det.cc:317), input that is
        not fully interchange-valid answers UNKNOWN with
        valid_prefix_bytes set instead of laundering bad bytes."""
        valid = self.span_interchange_valid(data)
        if check_utf8 and valid < len(data):
            return DetectionResult(
                language=self.registry.code(UNKNOWN_LANGUAGE),
                language_id=UNKNOWN_LANGUAGE, is_reliable=False,
                top3=[(self.registry.code(UNKNOWN_LANGUAGE), 0, 0.0)] * 3,
                text_bytes=0, valid_prefix_bytes=valid)
        r = self.detect(data.decode("utf-8", errors="replace"),
                        is_plain_text=is_plain_text, hints=hints)
        r.valid_prefix_bytes = valid
        return r

    def detect_batch(self, texts: list[str], hints=None,
                     is_plain_text: bool = True,
                     return_chunks: bool = False) -> list[DetectionResult]:
        """Batched detection through the device engine. hints /
        is_plain_text ride the device path too: priors become wire-level
        chunk boosts, HTML cleans on the host before packing.
        return_chunks fills per-byte-range vectors from the batched
        path's offset sidecars (result_vector.py)."""
        rs = self._get_batch_engine().detect_batch(
            texts, hints=hints, is_plain_text=is_plain_text,
            return_chunks=return_chunks)
        return [DetectionResult.from_scalar(r, self.registry) for r in rs]

    def detect_spans(self, texts: list[str]) -> list[DetectionResult]:
        """Per-span detection: every result carries `.spans` records
        tiling the document bytes (byte_offset, byte_len, iso_code,
        percent, reliable) alongside the usual top-3 summary, from the
        device engine's detect_spans (equal to
        engine_scalar.detect_scalar_spans)."""
        rs = self._get_batch_engine().detect_spans(texts)
        return [DetectionResult.from_scalar(r, self.registry) for r in rs]

    def engine_stats(self) -> dict:
        """Snapshot of the batched engine's counters (batches, device
        dispatches, fallback and retry docs, all-C docs; see
        models/ngram.py NgramBatchEngine.stats). {} when the batched
        engine is not built yet; never builds one."""
        if self._batch_engine is None:
            return {}
        return self._batch_engine.stats_snapshot()

    def _get_batch_engine(self):
        """The batched engine, built at first use on this detector's
        device. A failed build raises: there is no scalar fallback."""
        if self._batch_engine is None:
            from .models.ngram import NgramBatchEngine
            self._batch_engine = NgramBatchEngine(
                self.tables, self.registry, self.flags, device=self.device)
        return self._batch_engine


def detect_language_version(tables: ScoringTables | None = None) -> str:
    """Version string "code_version - data_build_date"
    (DetectLanguageVersion, compact_lang_det_impl.cc:2112-2119). Empty
    when no quadgram tables are loaded, like the reference's dynamic mode
    before data load."""
    t = tables or load_tables()
    if t.quadgram.empty:
        return ""
    from . import __version__
    return f"V{__version__} - {t.quadgram.build_date}"


_default_detector: LanguageDetector | None = None


def _get_default() -> LanguageDetector:
    global _default_detector
    if _default_detector is None:
        _default_detector = LanguageDetector()
    return _default_detector


def detect(text: str, is_plain_text: bool = True, hints=None,
           return_chunks: bool = False) -> DetectionResult:
    return _get_default().detect(text, is_plain_text=is_plain_text,
                                 hints=hints, return_chunks=return_chunks)


def detect_batch(texts: list[str], hints=None, is_plain_text: bool = True,
                 return_chunks: bool = False) -> list[DetectionResult]:
    return _get_default().detect_batch(texts, hints=hints,
                                       is_plain_text=is_plain_text,
                                       return_chunks=return_chunks)
