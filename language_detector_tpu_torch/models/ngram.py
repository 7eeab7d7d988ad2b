"""Batched n-gram detection engine on a CUDA device.

Pipeline per batch (DetectLanguageSummaryV2, compact_lang_det_impl.cc:
1707-2106, split between host and device):

  host   pack_chunks     texts -> chunk-major flat wire (C++: segmentation,
                         hashing, table probes, repeat cache, chunk
                         assignment, boost rotation — native/packer.cc)
  device score_chunks    langprob decode + chunk totes + top-2 + reliability
                         over the [G, K] chunk grid: the fused-tote CUDA
                         kernel (ops/kernels.py), one launch per dispatch
  host   epilogue_flat   DocTote replay + close pairs + unreliable removal +
                         summary language (C++: native/epilogue.cc)

Documents the packer flags (per-doc budget overflow, adversarially fat
chunks) fall back to the scalar engine; documents failing the good-answer
gate (impl.cc:1978-1991) re-score as a batch with the recursion flags.
Answers equal the reference package's engine and `detect_scalar` on every
document.

This engine serves plain-text batches through `detect_batch`,
`detect_codes` and `detect_many`, one slice at a time. Hints, HTML input
and per-range chunk vectors are not ported yet and raise
NotImplementedError.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .. import native
from ..engine_scalar import (FLAG_BEST_EFFORT, FLAG_FINISH, FLAG_REPEATS,
                             FLAG_SHORT, FLAG_SQUEEZE, FLAG_TOP40,
                             FLAG_USE_WORDS, ScalarResult, detect_scalar,
                             result_from_epilogue_row as _result_from_row)
from ..ops import kernels
from ..ops.device_tables import DeviceTables
from ..ops.score import unpack_chunks_out, wire_to_device
from ..registry import Registry, registry as default_registry
from ..tables import ScoringTables, load_tables

# Flags the device path supports. FINISH/BEST_EFFORT alter only the
# epilogue gate; SQUEEZE/REPEATS run natively in the packer (squeeze_span /
# cheap_rep_words_inplace); TOP40/SHORT/USE_WORDS are vestigial in this
# CLD2 version (set by the recursion, read nowhere). Anything else
# (score-as-quads) routes the batch to the scalar engine.
_DEVICE_OK_FLAGS = (FLAG_FINISH | FLAG_BEST_EFFORT | FLAG_SQUEEZE |
                    FLAG_REPEATS | FLAG_TOP40 | FLAG_SHORT |
                    FLAG_USE_WORDS)


def resolve_device(device=None) -> torch.device:
    """None means the CUDA card. A CUDA device without CUDA raises: the
    caller must ask for the CPU (the plain scorer) explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to score with the "
            "plain PyTorch version")
    return dev


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to language_detector_tpu_torch yet")


class DeviceResult:
    """A launched scorer's output. np.asarray(result) waits for the
    kernel (a CUDA event recorded after the launch) and returns the
    packed words as a host np.uint32 array."""

    __slots__ = ("out", "event")

    def __init__(self, out: torch.Tensor):
        self.out = out
        self.event = None
        if out.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(out.device))

    def __array__(self, dtype=None, copy=None):
        if self.event is not None:
            self.event.synchronize()
        a = self.out.cpu().numpy().view(np.uint32)
        return a if dtype is None else a.astype(dtype)


class NgramBatchEngine:
    """Batched detector over a table artifact, scoring on one device."""

    # Per-dispatch content budget (chars; bytes <= 4x): device memory is
    # linear in total chunk rows, so slices bound TEXT VOLUME as well as
    # document count.
    DISPATCH_CHAR_BUDGET = 3 << 20

    # detect_codes batches at or under this size answer on the all-C
    # path instead of dispatching
    TINY_BATCH_C_PATH = 64

    def __init__(self, tables: ScoringTables | None = None,
                 reg: Registry | None = None, flags: int = 0,
                 device=None, max_slots: int = 1 << 17,
                 max_chunks: int = 1 << 14):
        """device: None = "cuda" (raises without CUDA); "cpu" scores
        with the plain PyTorch version. max_slots / max_chunks:
        PER-DOCUMENT packer budgets; a document exceeding either falls
        back to the scalar engine."""
        self.device = resolve_device(device)
        self.tables = tables or load_tables()
        self.reg = reg or default_registry
        self.flags = flags
        self.max_slots = max_slots
        self.max_chunks = max_chunks
        if not native.available():
            raise RuntimeError(
                "batched engine requires the native packer "
                "(language_detector_tpu_torch/native/build.sh); "
                "use detect_scalar without it")
        self.dt = DeviceTables.from_host(self.tables, self.reg,
                                         self.device)
        # running totals: batches scored, device launches, packer
        # fallbacks, gate-failed docs re-scored, all-C tiny-batch docs
        self.stats = {"batches": 0, "device_dispatches": 0,
                      "fallback_docs": 0, "scalar_recursion_docs": 0,
                      "c_path_docs": 0}
        self._stats_lock = threading.Lock()

    def stats_snapshot(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)

    # -- device dispatch ----------------------------------------------------

    def _launch(self, cb) -> DeviceResult:
        """Copy the wire to the device and launch the scorer; returns
        before the kernel finishes."""
        wire = wire_to_device(cb.wire, self.device)
        return DeviceResult(kernels.score_chunks(self.dt, wire))

    def _fetch_rows(self, cb, fut) -> np.ndarray:
        """Wait for a launch and unpack its words against the wire's
        chunk meta into the flat [G, 5] rows the epilogue reads."""
        return unpack_chunks_out(np.asarray(fut), cb.wire["cmeta"])

    # -- public API ---------------------------------------------------------

    def detect_batch(self, texts: list[str], hints=None,
                     is_plain_text: bool = True,
                     return_chunks: bool = False) -> list:
        """ScalarResult-compatible results, one per text (EpilogueResult
        views for device-scored docs, ScalarResults for scalar-path
        docs)."""
        if hints is not None:
            _not_ported("hinted detection")
        if not is_plain_text:
            _not_ported("HTML input (is_plain_text=False)")
        if return_chunks:
            _not_ported("per-range chunk vectors (return_chunks=True)")
        if not texts:
            return []
        if self.flags & ~_DEVICE_OK_FLAGS:
            return [detect_scalar(t, self.tables, self.reg, self.flags)
                    for t in texts]
        if sum(len(t) for t in texts) > self.DISPATCH_CHAR_BUDGET:
            return self.detect_many(texts, batch_size=len(texts))
        cb, fut = self._dispatch(texts)
        return self._finish(texts, cb, fut)

    def detect_many(self, texts: list[str],
                    batch_size: int = 16384) -> list:
        """Multi-slice detection: slices by count and content volume,
        one dispatch each, then one batched retry pass over every
        gate-failed document of the stream."""
        if self.flags & ~_DEVICE_OK_FLAGS or not texts:
            return self.detect_batch(texts)
        return self._detect_stream(texts, batch_size, self._finish)

    def detect_codes(self, texts: list[str],
                     batch_size: int = 16384) -> list[str]:
        """Summary ISO codes only — the reference's production semantic
        (wrapper.cc:7-16 discards everything but the code string). Skips
        per-document result materialization."""
        if self.flags & ~_DEVICE_OK_FLAGS or not texts:
            return [self.reg.code(r.summary_lang)
                    for r in self.detect_batch(texts)]
        # tiny batches skip the device: the all-C pipeline answers them
        # (agreement-pinned against the device path)
        if len(texts) <= self.TINY_BATCH_C_PATH and self.flags == 0:
            ids = native.detect_batch_codes_native(texts, self.tables,
                                                   self.reg)
            if ids is not None:
                with self._stats_lock:
                    self.stats["batches"] += 1
                    self.stats["c_path_docs"] += len(texts)
                return self.reg.lang_code[ids].tolist()
        vals = self._detect_stream(
            texts, batch_size, self._finish_codes,
            patch_value=lambda r: int(r.summary_lang))
        ids = np.fromiter((int(v) for v in vals), np.int32,
                          count=len(vals))
        return self.reg.lang_code[ids].tolist()

    # -- scheduling -----------------------------------------------------------

    def _detect_stream(self, texts: list[str], batch_size: int,
                       finish_fn, patch_value=None) -> list:
        """Serial slice loop: pack -> launch -> epilogue per slice, gate
        failures deferred into ONE batched recursion pass at the end.
        Returns the per-doc value list in input order."""
        if patch_value is None:
            patch_value = lambda r: r  # noqa: E731
        out: list = [None] * len(texts)
        deferred: list = []
        for s, e in self._slice_bounds([len(t) for t in texts],
                                       batch_size):
            txts = texts[s:e]
            cb = self._pack(txts)
            d: list = []
            out[s:e] = finish_fn(txts, cb, self._launch(cb), deferred=d)
            deferred.extend((s + b, t, sq) for b, t, sq in d)
        for g, r in self._retry_deferred(deferred).items():
            out[g] = patch_value(r)
        return out

    def _slices(self, texts: list[str], batch_size: int):
        """Batch slicing by document count AND content volume, order
        preserving; every slice holds at least one document."""
        for s, e in self._slice_bounds([len(t) for t in texts],
                                       batch_size):
            yield texts[s:e]

    def _slice_bounds(self, lengths: list[int], batch_size: int):
        """(start, end) bounds over lengths. The volume target is
        BALANCED: total content divided over the minimum number of
        budget-respecting slices (never exceeding DISPATCH_CHAR_BUDGET,
        the device memory bound)."""
        total = sum(lengths)
        n_slices = max(-(-total // self.DISPATCH_CHAR_BUDGET), 1)
        target = max(-(-total // n_slices), 1)
        start = 0
        vol = 0
        for i, ln in enumerate(lengths):
            if i > start and (i - start >= batch_size or
                              vol + ln > target):
                yield start, i
                start, vol = i, 0
            vol += ln
        if start < len(lengths):
            yield start, len(lengths)

    def _pack(self, texts: list[str], flags: int | None = None):
        """Pack only (no device launch)."""
        fl = self.flags if flags is None else flags
        return native.pack_chunks_native(
            texts, self.tables, self.reg, flags=fl,
            l_doc=self.max_slots, c_doc=self.max_chunks)

    def _dispatch(self, texts: list[str], flags: int | None = None):
        """Pack + launch; returns (ChunkBatch, DeviceResult)."""
        cb = self._pack(texts, flags)
        return cb, self._launch(cb)

    def _epilogue(self, texts: list[str], cb, fut, deferred=None):
        """Fetch the device result, run the C++ document epilogue, and
        resolve the exception docs: packer fallbacks go scalar; docs
        failing the good-answer gate re-score as a BATCH with the
        recursion flags (TOP40|REPEATS|FINISH, plus SQUEEZE for docs
        whose first pass squeezed) — the reference's recursive
        DetectLanguageSummaryV2 call (impl.cc:2061-2105).

        deferred: when given, gate-failed docs are appended as (local
        index, text, squeezed) for the caller's one retry pass instead
        of being retried here. Returns (ep [B, 14], {doc index:
        ScalarResult} patches)."""
        rows = self._fetch_rows(cb, fut)
        B = len(texts)
        ep = native.epilogue_flat_native(rows, cb, self.flags, self.reg)
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["device_dispatches"] += 1
            self.stats["fallback_docs"] += int(cb.fallback[:B].sum())
        patches: dict[int, ScalarResult] = {}
        local_retry: list = []  # (index, text, squeezed)
        for b in np.flatnonzero(ep[:B, 12]):
            b = int(b)
            if cb.fallback[b]:
                patches[b] = detect_scalar(texts[b], self.tables,
                                           self.reg, self.flags)
            elif deferred is not None:
                deferred.append((b, texts[b], bool(cb.squeezed[b])))
            else:
                local_retry.append((b, texts[b], bool(cb.squeezed[b])))
        patches.update(self._retry_deferred(local_retry))
        return ep, patches

    def _retry_flags(self, squeezed: bool) -> int:
        return (self.flags | FLAG_TOP40 | FLAG_REPEATS | FLAG_FINISH |
                (FLAG_SQUEEZE if squeezed else 0))

    def _retry_deferred(self, deferred: list) -> dict:
        """One batched recursion pass over gate-failed docs:
        {index: ScalarResult}."""
        if not deferred:
            return {}
        with self._stats_lock:
            self.stats["scalar_recursion_docs"] += len(deferred)
        patches: dict = {}
        for squeezed in (False, True):
            group = [(g, t) for g, t, sq in deferred if sq == squeezed]
            if not group:
                continue
            rs = self._score_with_flags([t for _, t in group],
                                        self._retry_flags(squeezed))
            for (g, _), r in zip(group, rs):
                patches[g] = r
        return patches

    def _finish(self, texts: list[str], cb, fut, deferred=None) -> list:
        ep, patches = self._epilogue(texts, cb, fut, deferred)
        results = [EpilogueResult(r) for r in ep[:len(texts)].tolist()]
        for b, r in patches.items():
            results[b] = r
        return results

    def _finish_codes(self, texts: list[str], cb, fut,
                      deferred=None) -> np.ndarray:
        """Summary-language ids only (no per-doc result objects)."""
        ep, patches = self._epilogue(texts, cb, fut, deferred)
        out = ep[:len(texts), 0].astype(np.int32)
        for b, r in patches.items():
            out[b] = r.summary_lang
        return out

    def _score_with_flags(self, texts: list[str],
                          flags: int) -> list[ScalarResult]:
        """Device passes with explicit flags (the gate-failure retry;
        FINISH forces the gate so no further recursion happens), sliced
        by the same content-volume budget as the main path. Docs the
        packer cannot place, or that still fail, fall back to the scalar
        engine with the engine's own flags."""
        results: list = []
        for chunk in self._slices(texts, 16384):
            cb, fut = self._dispatch(chunk, flags)
            rows = self._fetch_rows(cb, fut)
            with self._stats_lock:
                self.stats["device_dispatches"] += 1
            ep = native.epilogue_flat_native(rows, cb, flags, self.reg)
            for b, text in enumerate(chunk):
                row = ep[b]
                if cb.fallback[b] or row[12]:
                    results.append(detect_scalar(text, self.tables,
                                                 self.reg, self.flags))
                else:
                    results.append(_result_from_row(row))
        return results


class EpilogueResult:
    """Lazy ScalarResult-compatible view over one ldt_epilogue_flat row
    (a plain 14-int list). Field extraction happens on attribute
    access."""
    __slots__ = ("_r",)
    chunks = None  # ResultChunk vectors come from the scalar engine only
    spans = None

    def __init__(self, row: list):
        self._r = row

    @property
    def summary_lang(self) -> int:
        return self._r[0]

    @property
    def language3(self) -> list:
        return self._r[1:4]

    @property
    def percent3(self) -> list:
        return self._r[4:7]

    @property
    def normalized_score3(self) -> list:
        return [float(x) for x in self._r[7:10]]

    @property
    def text_bytes(self) -> int:
        return self._r[10]

    @property
    def is_reliable(self) -> bool:
        return self._r[11] != 0

    def __repr__(self):
        return (f"EpilogueResult(summary_lang={self.summary_lang}, "
                f"language3={self.language3}, percent3={self.percent3}, "
                f"is_reliable={self.is_reliable})")
