"""Public detection API.

`LanguageDetector` wraps the engines: the scalar host engine (reference
semantics, used for validation and as fallback for rare recursion paths) and
the batched engine (models/ngram.py), which scores on a CUDA card unless the
caller asks for the CPU. Mirrors the service surface of the reference wrapper
(wrapper.cc:7-16 detect_language).

Hints, HTML input, per-range chunk vectors and spans are not ported yet:
those arguments raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses

from . import native
from .engine_scalar import (ScalarResult, detect_scalar,
                            result_from_epilogue_row)
from .registry import Registry, registry as default_registry
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
        """Plain calls run the all-C single-document pipeline (native
        detect_one_row: pack -> C chunk scorer -> epilogue -> gate
        recursion, agreement-pinned against the device and scalar
        engines); non-default flags, docs past the C seam's 160KB
        reference subset, or no native library keep the scalar
        engine."""
        _plain_only(hints, is_plain_text, return_chunks)
        if self.flags == 0:
            row = native.detect_one_native(text, self.tables,
                                           self.registry)
            if row is not None:
                return DetectionResult.from_scalar(
                    result_from_epilogue_row(row), self.registry)
        r = detect_scalar(text, self.tables, self.registry, self.flags)
        return DetectionResult.from_scalar(r, self.registry)

    def detect_batch(self, texts: list[str], hints=None,
                     is_plain_text: bool = True,
                     return_chunks: bool = False) -> list[DetectionResult]:
        """Batched detection through the device engine."""
        _plain_only(hints, is_plain_text, return_chunks)
        rs = self._get_batch_engine().detect_batch(texts)
        return [DetectionResult.from_scalar(r, self.registry) for r in rs]

    def _get_batch_engine(self):
        if self._batch_engine is None:
            from .models.ngram import NgramBatchEngine
            self._batch_engine = NgramBatchEngine(
                self.tables, self.registry, self.flags, device=self.device)
        return self._batch_engine


def _plain_only(hints, is_plain_text: bool, return_chunks: bool) -> None:
    if hints is not None or not is_plain_text or return_chunks:
        raise NotImplementedError(
            "hints, HTML input and chunk vectors are not ported to "
            "language_detector_tpu_torch yet")


_default_detector: LanguageDetector | None = None


def _get_default() -> LanguageDetector:
    global _default_detector
    if _default_detector is None:
        _default_detector = LanguageDetector()
    return _default_detector


def detect(text: str) -> DetectionResult:
    return _get_default().detect(text)


def detect_batch(texts: list[str]) -> list[DetectionResult]:
    return _get_default().detect_batch(texts)
