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

Every surface runs one slice at a time through the same kernel:
plain-text `detect_batch` / `detect_codes` / `detect_many`; hinted and
HTML batches (hint boosts, close-set whacks and, with hint priors on,
per-document prior planes ride the wire); per-range chunk vectors (a
want_ranges pack and the kernel's full-output word); and per-span
verdicts (`detect_spans`: split sub-documents in one flat pack).
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from .. import faults, knobs, native, telemetry
from ..engine_scalar import (FLAG_BEST_EFFORT, FLAG_FINISH, FLAG_REPEATS,
                             FLAG_SHORT, FLAG_SQUEEZE, FLAG_TOP40,
                             FLAG_USE_WORDS, SPAN_SPLIT_SLOTS, ScalarResult,
                             detect_scalar, detect_scalar_spans,
                             result_from_epilogue_row as _result_from_row,
                             span_coverage_records, split_for_spans)
from ..hints import apply_hints, prior_vector
from ..locks import make_lock
from ..ops import kernels
from ..ops.device_tables import DeviceTables, host_tables
from ..ops.score import (unpack_chunks_out, unpack_chunks_out2,
                         wire_to_device)
from ..preprocess.html import clean_html
from ..registry import Registry, registry as default_registry
from ..result_vector import (build_doc_records, chunks_for_doc,
                             merge_longdoc_chunks)
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


class DeviceResult:
    """A launched scorer's output. np.asarray(result) waits for the
    kernel (a CUDA event recorded after the launch on the launching
    thread's stream, so it waits for that launch and the work queued
    before it there, not for other threads' launches) and returns the
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
                 max_chunks: int = 1 << 14,
                 hint_priors: bool | None = None,
                 longdoc_chunk_slots: int | None = None):
        """device: None = "cuda" (raises without CUDA); "cpu" scores
        with the plain PyTorch version. max_slots / max_chunks:
        PER-DOCUMENT packer budgets; a document exceeding either falls
        back to the scalar engine. hint_priors: hinted batches also
        carry per-document prior planes (hints.prior_vector) that the
        kernel adds to languages a chunk already scored, before its
        top-2; None reads LDT_HINTS (default off). longdoc_chunk_slots:
        the sub-document slot budget `detect_spans` splits at; None
        reads LDT_LONGDOC_CHUNK_SLOTS (default 1024), 0 means the scalar
        engine's SPAN_SPLIT_SLOTS."""
        self.device = resolve_device(device)
        self.tables = tables or load_tables()
        self.reg = reg or default_registry
        self.flags = flags
        self.max_slots = max_slots
        self.max_chunks = max_chunks
        self.hint_priors_enabled = (knobs.get_bool("LDT_HINTS")
                                    if hint_priors is None
                                    else bool(hint_priors))
        self.longdoc_chunk_slots = (
            knobs.get_int("LDT_LONGDOC_CHUNK_SLOTS")
            if longdoc_chunk_slots is None else longdoc_chunk_slots)
        if not native.available():
            raise RuntimeError(
                "batched engine requires the native packer "
                "(language_detector_tpu_torch/native/build.sh); "
                "use detect_scalar without it")
        self.dt = DeviceTables.from_host(self.tables, self.reg,
                                         self.device)
        if self.device.type == "cuda":
            # build (or load) the kernel library now, not inside the
            # first flush: a service's flush timeout must not pay nvcc
            kernels._load()
        # running totals: batches scored, device launches, packer
        # fallbacks, gate-failed docs re-scored, all-C tiny-batch docs.
        # The key set is fixed here: snapshots copy under the lock while
        # flush workers update it
        self.stats = {"batches": 0, "device_dispatches": 0,
                      "fallback_docs": 0, "scalar_recursion_docs": 0,
                      "c_path_docs": 0}
        self._stats_lock = make_lock("engine.stats")
        # one CUDA stream per launching thread (concurrent flushes)
        self._streams = threading.local()

    def stats_snapshot(self) -> dict:
        """Copy of the running stats under the stats lock — the only
        safe way for another thread (the /metrics renderers) to read
        them."""
        with self._stats_lock:
            return dict(self.stats)

    def pipeline_stats(self) -> dict:
        """Dispatch snapshot for /metrics and /debug/vars, with the
        reference engine's keys and what this engine has: pipeline
        depth 1 (each call packs, launches and finishes one slice at a
        time, so no pack overlaps its own call's launch), no staging
        ring and no buffer donation; the kernel is "cuda"
        (csrc/fused_tote.cu) or "plain" (ops/score.py) by the engine's
        device."""
        kernel = "cuda" if self.device.type == "cuda" else "plain"
        return {
            "depth": 1,
            "kernel": kernel,
            "kernel_requested": kernel,
            "kernel_reason": f"engine device {self.device}",
            "overlap_ratio": 0.0,
            "pack_ms_total": 0.0,
            "pack_ms_overlapped": 0.0,
            "inflight": 0,
            "donation_hits": 0,
            "longdoc_chunks": 0,
            "staging_ring_occupancy": 0,
            "staging_ring_hits": 0,
            "staging_ring_misses": 0,
            "staging_ring_shapes": 0,
        }

    # -- device dispatch ----------------------------------------------------

    def _stream(self):
        """This thread's CUDA stream on the engine's device: flush
        workers copy, launch and read back on their own streams, so one
        flush's readback never waits for another's launch."""
        s = getattr(self._streams, "stream", None)
        if s is None:
            s = self._streams.stream = torch.cuda.Stream(self.device)
        return s

    def _launch(self, cb, full_out: bool = False) -> DeviceResult:
        """Copy the wire to the device and launch the scorer (word1, or
        [G, 2] words when full_out); returns before the kernel
        finishes."""
        if faults.ACTIVE is not None:
            faults.hit("scorer_launch")
        with (torch.cuda.stream(self._stream())
              if self.device.type == "cuda"
              else contextlib.nullcontext()):
            wire = wire_to_device(cb.wire, self.device)
            return DeviceResult(
                kernels.score_chunks(self.dt, wire, full_out))

    def _fetch_rows(self, cb, fut) -> np.ndarray:
        """Wait for a launch and unpack its words against the wire's
        chunk meta into the flat [G, 5] rows the epilogue reads."""
        return unpack_chunks_out(np.asarray(fut), cb.wire["cmeta"])

    def score_chunk_batch(self, cb) -> np.ndarray:
        """Score a packed ChunkBatch; returns the flat [G, 5]
        chunk-summary rows on the host (test/debug seam)."""
        return self._fetch_rows(cb, self._launch(cb))

    # -- public API ---------------------------------------------------------

    def detect_batch(self, texts: list[str], hints=None,
                     is_plain_text: bool = True,
                     return_chunks: bool = False) -> list:
        """ScalarResult-compatible results, one per text (EpilogueResult
        views for device-scored docs, ScalarResults for scalar-path
        docs). hints: optional hints.CLDHints applied to every document
        of the call; is_plain_text=False strips HTML on the host and
        scans lang= tags into per-document hints; both stay on the
        device path. return_chunks fills each result's per-byte-range
        vector through a want_ranges pack and the full-output word
        (hinted or HTML chunk vectors, whose offset maps live in the
        scalar engine, resolve there)."""
        if not texts:
            return []
        if self.flags & ~_DEVICE_OK_FLAGS:
            return [detect_scalar(t, self.tables, self.reg, self.flags,
                                  hints=hints,
                                  is_plain_text=is_plain_text,
                                  want_chunks=return_chunks)
                    for t in texts]
        if return_chunks:
            if hints is not None or not is_plain_text:
                return [detect_scalar(t, self.tables, self.reg,
                                      self.flags, hints=hints,
                                      is_plain_text=is_plain_text,
                                      want_chunks=True)
                        for t in texts]
            return self._detect_with_chunks(texts)
        if hints is not None or not is_plain_text:
            return self._detect_hinted(texts, hints, is_plain_text)
        if sum(len(t) for t in texts) > self.DISPATCH_CHAR_BUDGET:
            return self.detect_many(texts, batch_size=len(texts))
        cb, fut = self._dispatch(texts)
        return self._finish(texts, cb, fut)

    def _detect_with_chunks(self, texts: list[str]) -> list:
        """Batched detection WITH per-range chunk vectors: a want_ranges
        pack (per-slot / per-chunk offset sidecars) and one full-output
        launch per slice (word2: lang2, rd, rs), then the host replays
        the scalar vector path exactly: boundary sharpening over the
        resolved hit lanes (it shifts the epilogue's chunk byte weights,
        as the reference's vector mode does), the shared record merge,
        and the scalar engine for any doc whose offsets cannot map back
        (squeeze, fallback, gate retry)."""
        cat_ind2 = host_tables(self.tables, self.reg).cat_ind2
        out: list = []
        for chunk in self._slices(texts, 16384):
            cb = self._pack(chunk, want_ranges=True)
            full = np.asarray(self._launch(cb, full_out=True))
            rows = unpack_chunks_out(full[..., 0], cb.wire["cmeta"])
            rows2 = unpack_chunks_out2(full[..., 1])
            cnsl2 = cb.wire["cnsl"].astype(np.int64)
            cstart_flat = (np.cumsum(cnsl2, axis=-1) - cnsl2).reshape(-1)
            # records first: sharpening edits rows' byte weights, which
            # the epilogue must consume (vector-mode DocTote semantics)
            doc_recs = [build_doc_records(b, cb, rows, rows2,
                                          cstart_flat, cat_ind2,
                                          self.tables, self.reg)
                        for b in range(len(chunk))]
            ep = native.epilogue_flat_native(rows, cb, self.flags,
                                             self.reg)
            n_fb = n_retry = 0
            for b, text in enumerate(chunk):
                if doc_recs[b] is None or ep[b, 12]:
                    if cb.fallback[b]:
                        n_fb += 1
                    else:
                        n_retry += 1
                    out.append(detect_scalar(
                        text, self.tables, self.reg, self.flags,
                        want_chunks=True))
                    continue
                res = _result_from_row(ep[b])
                res.chunks = chunks_for_doc(text, doc_recs[b], self.reg)
                out.append(res)
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["device_dispatches"] += 1
                self.stats["fallback_docs"] += n_fb
                self.stats["scalar_recursion_docs"] += n_retry
        return out

    def detect_spans(self, texts: list[str]) -> list:
        """Per-span language verdicts: each text splits on script-span
        boundaries (engine_scalar.split_for_spans, the only exact split
        points), every sub-document scores as its own row range of one
        flat pack, the MERGED epilogue yields the whole-document summary
        (identical to the unsplit answer) and the UNMERGED per-sub-doc
        epilogue yields the span verdicts. Results are
        ScalarResult-compatible with .spans = [(byte_offset, byte_len,
        code, pct, reliable)] tiling the document's bytes
        (engine_scalar.span_coverage_records). A sub-doc the packer
        flagged or that failed the gate resolves its span through the
        scalar engine, and a merged-doc exception resolves the whole
        summary there, so the records equal detect_scalar_spans on
        every document."""
        if not texts:
            return []
        budget = self.longdoc_chunk_slots or SPAN_SPLIT_SLOTS
        if self.flags & ~_DEVICE_OK_FLAGS:
            return [detect_scalar_spans(t, self.tables, self.reg,
                                        self.flags, budget)
                    for t in texts]
        out: list = []
        for chunk in self._slices(texts, 16384):
            out.extend(self._detect_spans_slice(chunk, budget))
        return out

    def _detect_spans_slice(self, texts: list[str],
                            budget: int) -> list:
        subs_all: list = []
        groups: list = []
        bounds_all: list = []
        for t in texts:
            subs, bounds = split_for_spans(t, self.tables, budget)
            groups.append((len(subs_all), len(subs)))
            subs_all.extend(subs)
            bounds_all.append(bounds)
        cb = self._pack(subs_all)
        rows = self._fetch_rows(cb, self._launch(cb))
        sub_ep = native.epilogue_flat_native(rows, cb, self.flags,
                                             self.reg)
        mrows, mcb, _ = merge_longdoc_chunks(rows, cb, groups,
                                             keep_spans=True)
        ep = native.epilogue_flat_native(mrows, mcb, self.flags,
                                         self.reg)
        results: list = []
        n_fb = 0
        for j, text in enumerate(texts):
            s, n = groups[j]
            verdicts = []
            for i in range(s, s + n):
                row = sub_ep[i]
                if cb.fallback[i] or cb.squeezed[i] or row[12]:
                    r = detect_scalar(subs_all[i], self.tables,
                                      self.reg, self.flags)
                    verdicts.append((self.reg.code(r.summary_lang),
                                     int(r.percent3[0]),
                                     bool(r.is_reliable)))
                else:
                    verdicts.append((self.reg.code(int(row[0])),
                                     int(row[4]), bool(row[11])))
            if mcb.fallback[j] or mcb.squeezed[j] or ep[j, 12]:
                n_fb += 1
                res = detect_scalar(text, self.tables, self.reg,
                                    self.flags)
            else:
                res = _result_from_row(ep[j])
            res.spans = span_coverage_records(text, bounds_all[j],
                                              verdicts)
            results.append(res)
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["device_dispatches"] += 1
            self.stats["fallback_docs"] += n_fb
        return results

    def _detect_hinted(self, texts: list[str], hints,
                       is_plain_text: bool) -> list:
        """Hinted / HTML detection on the device path: hint boosts ride
        the wire as extra chunk slots (the hint_lp window), whacks as
        per-chunk mask rows, priors (when enabled) as per-chunk prior
        planes, and HTML cleans on the host before packing (the scalar
        engine does the same pre-pass, so segmentation sees identical
        bytes). Slices respect the plain path's content-volume budget
        and run one after another: pipelining them comes with the
        dispatch pipeline (pipeline depth > 1). Gate-failing and
        fallback docs run the scalar engine with the ORIGINAL text and
        hints."""
        if is_plain_text:
            # without HTML there is no per-document hint input (lang=
            # scanning is the only one): one HintBoosts serves the batch
            shared_hb = apply_hints("", True, hints, self.tables,
                                    self.reg)
            hbs = [shared_hb] * len(texts)
            clean = texts
        else:
            hbs = [apply_hints(t, False, hints, self.tables, self.reg)
                   for t in texts]
            clean = [clean_html(t, self.tables)[0] for t in texts]
        # densify each doc's boosts into the prior plane the kernel adds
        # before its top-2; the plain-text batch shares one plane (same
        # HintBoosts), deduped to one table row by the pack
        prs = ([prior_vector(hb, self.tables) for hb in hbs]
               if self.hint_priors_enabled else None)
        out: list = []
        for s, e in self._slice_bounds([len(t) for t in clean], 16384):
            cb = self._pack(clean[s:e], hint_boosts=hbs[s:e],
                            hint_priors=prs[s:e] if prs is not None
                            else None)
            rows = self._fetch_rows(cb, self._launch(cb))
            ep = native.epilogue_flat_native(rows, cb, self.flags,
                                             self.reg)
            # both exception classes (packer fallback, gate failure)
            # resolve through the scalar engine with the ORIGINAL text
            # and hints: the batched retry pass carries no hint state
            n_fb = n_retry = 0
            for b, text in enumerate(texts[s:e]):
                if ep[b, 12]:
                    if cb.fallback[b]:
                        n_fb += 1
                    else:
                        n_retry += 1
                    out.append(detect_scalar(
                        text, self.tables, self.reg, self.flags,
                        hints=hints, is_plain_text=is_plain_text))
                else:
                    out.append(EpilogueResult(ep[b].tolist()))
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["device_dispatches"] += 1
                self.stats["fallback_docs"] += n_fb
                self.stats["scalar_recursion_docs"] += n_retry
        return out

    def detect_many(self, texts: list[str],
                    batch_size: int = 16384) -> list:
        """Multi-slice detection: slices by count and content volume,
        one dispatch each, then one batched retry pass over every
        gate-failed document of the stream."""
        if self.flags & ~_DEVICE_OK_FLAGS or not texts:
            return self.detect_batch(texts)
        return self._detect_stream(texts, batch_size, self._finish)

    def detect_codes(self, texts: list[str], batch_size: int = 16384,
                     trace=None) -> list[str]:
        """Summary ISO codes only — the reference's production semantic
        (wrapper.cc:7-16 discards everything but the code string), so
        the service fronts consume this. Skips per-document result
        materialization. trace: a telemetry.Trace that records the
        stages (c_path; pack, dispatch, epilogue, retry_lane)."""
        if self.flags & ~_DEVICE_OK_FLAGS or not texts:
            return [self.reg.code(r.summary_lang)
                    for r in self.detect_batch(texts)]
        # tiny batches skip the device: the all-C pipeline answers them
        # (agreement-pinned against the device path)
        if len(texts) <= self.TINY_BATCH_C_PATH and self.flags == 0:
            t0 = time.monotonic()
            ids = native.detect_batch_codes_native(texts, self.tables,
                                                   self.reg)
            if ids is not None:
                telemetry.observe_stage("c_path", t0, trace=trace)
                with self._stats_lock:
                    self.stats["batches"] += 1
                    self.stats["c_path_docs"] += len(texts)
                return self.reg.lang_code[ids].tolist()
        vals = self._detect_stream(
            texts, batch_size, self._finish_codes,
            patch_value=lambda r: int(r.summary_lang), trace=trace)
        ids = np.fromiter((int(v) for v in vals), np.int32,
                          count=len(vals))
        return self.reg.lang_code[ids].tolist()

    # -- scheduling -----------------------------------------------------------

    def _detect_stream(self, texts: list[str], batch_size: int,
                       finish_fn, patch_value=None, trace=None) -> list:
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
            t0 = time.monotonic()
            cb = self._pack(txts)
            telemetry.observe_stage("pack", t0, trace=trace)
            d: list = []
            out[s:e] = finish_fn(txts, cb, self._launch(cb), deferred=d,
                                 trace=trace)
            deferred.extend((s + b, t, sq) for b, t, sq in d)
        if deferred:
            t0 = time.monotonic()
            for g, r in self._retry_deferred(deferred).items():
                out[g] = patch_value(r)
            telemetry.observe_stage("retry_lane", t0, trace=trace)
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

    def _pack(self, texts: list[str], flags: int | None = None,
              hint_boosts: list | None = None,
              hint_priors: list | None = None,
              want_ranges: bool = False):
        """Pack only (no device launch). Without hints the wire is the
        plain one: no whack rows, no prior planes."""
        fl = self.flags if flags is None else flags
        return native.pack_chunks_native(
            texts, self.tables, self.reg, flags=fl,
            l_doc=self.max_slots, c_doc=self.max_chunks,
            hint_boosts=hint_boosts, hint_priors=hint_priors,
            want_ranges=want_ranges)

    def _dispatch(self, texts: list[str], flags: int | None = None):
        """Pack + launch; returns (ChunkBatch, DeviceResult)."""
        cb = self._pack(texts, flags)
        return cb, self._launch(cb)

    def _epilogue(self, texts: list[str], cb, fut, deferred=None,
                  trace=None):
        """Fetch the device result, run the C++ document epilogue, and
        resolve the exception docs: packer fallbacks go scalar; docs
        failing the good-answer gate re-score as a BATCH with the
        recursion flags (TOP40|REPEATS|FINISH, plus SQUEEZE for docs
        whose first pass squeezed) — the reference's recursive
        DetectLanguageSummaryV2 call (impl.cc:2061-2105).

        deferred: when given, gate-failed docs are appended as (local
        index, text, squeezed) for the caller's one retry pass instead
        of being retried here. Returns (ep [B, 14], {doc index:
        ScalarResult} patches). The "dispatch" stage is the device wait,
        from fetch start to rows on the host."""
        if faults.ACTIVE is not None:
            faults.hit("device_flush")
        t0 = time.monotonic()
        rows = self._fetch_rows(cb, fut)
        t1 = time.monotonic()
        B = len(texts)
        ep = native.epilogue_flat_native(rows, cb, self.flags, self.reg)
        t2 = time.monotonic()
        # stages and stats record only after every fallible step, so a
        # flush the batcher retries counts once
        telemetry.observe_stage("dispatch", t0, t1, trace=trace)
        telemetry.observe_stage("epilogue", t1, t2, trace=trace)
        telemetry.REGISTRY.histogram(
            "ldt_device_ms", phase="device").observe((t1 - t0) * 1000.0)
        telemetry.REGISTRY.histogram(
            "ldt_device_ms", phase="host").observe((t2 - t1) * 1000.0)
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

    def _finish(self, texts: list[str], cb, fut, deferred=None,
                trace=None) -> list:
        ep, patches = self._epilogue(texts, cb, fut, deferred, trace)
        results = [EpilogueResult(r) for r in ep[:len(texts)].tolist()]
        for b, r in patches.items():
            results[b] = r
        return results

    def _finish_codes(self, texts: list[str], cb, fut,
                      deferred=None, trace=None) -> np.ndarray:
        """Summary-language ids only (no per-doc result objects)."""
        ep, patches = self._epilogue(texts, cb, fut, deferred, trace)
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
    # chunk vectors and spans come back as ScalarResults
    # (_detect_with_chunks, detect_spans)
    chunks = None
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
