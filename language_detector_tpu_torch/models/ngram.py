"""Batched n-gram detection engine on a CUDA device.

Pipeline per batch (DetectLanguageSummaryV2, compact_lang_det_impl.cc:
1707-2106, split between host and device):

  host   pack_chunks     texts -> chunk-major flat wire (C++: segmentation,
                         hashing, table probes, repeat cache, chunk
                         assignment, boost rotation — native/packer.cc),
                         written into a pinned staging lease
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

`detect_codes` and `detect_many` run the reference's stream scheduler
(_detect_stream / _run_scheduler): batch-internal dedup, the short / mid
/ long tier lanes, the long-doc lane (span-exact sub-packs merged back
into one summary; off unless LDT_LONGDOC_CHUNK_SLOTS sets a sub-pack
size), a retry lane whose recursion dispatches overlap the
main lanes, and LDT_PIPELINE_DEPTH jobs in flight. The main thread only
packs; worker threads copy each job's wire from its pinned lease to the
card, launch, read back and run the epilogue, every job on one CUDA
stream of the engine's fixed set. Hinted / HTML batches and the
gate-retry passes share the same pipeline core (_pipelined_jobs);
per-range chunk vectors and per-span verdicts stay serial, as in the
reference.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

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
from ..preprocess.pack import (N_TIERS, TIER_NAMES, _TIER_BASE_SLOTS,
                               _maybe_multi_span, split_longdoc,
                               tier_of_text)
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
    """A launched scorer's output. np.asarray(result) reads the packed
    words back on the stream that launched them (so it waits for that
    job's copies and kernel, not for other jobs' work on other streams)
    and returns them as a host np.uint32 array."""

    __slots__ = ("out", "stream")

    def __init__(self, out: torch.Tensor, stream=None):
        self.out = out
        self.stream = stream

    def __array__(self, dtype=None, copy=None):
        if self.stream is None:
            host = self.out.cpu()
        else:
            with torch.cuda.stream(self.stream):
                host = self.out.cpu()    # copy + wait on the job's stream
        a = host.numpy().view(np.uint32)
        return a if dtype is None else a.astype(dtype)


class NgramBatchEngine:
    """Batched detector over a table artifact, scoring on one device."""

    # process-global interpreter-tuning state for _gc_paused (shared
    # across engines: the knobs it guards are process-global too)
    _bulk_lock = make_lock("engine.bulk")
    _bulk_depth = 0
    _bulk_saved = (True, 0.005)
    # bulk calls completed since the last forced gc.collect(): under
    # sustained overlapping flushes the pause depth may never return to
    # 0, so cyclic garbage made by OTHER threads while the GC is paused
    # must be bounded by forcing a collection every N bulk exits
    _bulk_since_collect = 0
    GC_COLLECT_EVERY = 64

    # Per-dispatch content budget (chars; bytes <= 4x): device memory is
    # linear in total chunk rows, so slices bound TEXT VOLUME as well as
    # document count.
    DISPATCH_CHAR_BUDGET = 3 << 20

    # detect_codes batches at or under this size answer on the all-C
    # path instead of dispatching
    TINY_BATCH_C_PATH = 64
    # the long-doc lane's engage threshold in estimated slots (~16 KB of
    # text; the reference's LDT_LONGDOC_SPLIT_SLOTS default)
    LONGDOC_SPLIT_SLOTS = 4096

    def __init__(self, tables: ScoringTables | None = None,
                 reg: Registry | None = None, flags: int = 0,
                 device=None, max_slots: int = 1 << 17,
                 max_chunks: int = 1 << 14,
                 hint_priors: bool | None = None,
                 longdoc_chunk_slots: int | None = None,
                 longdoc_split_slots: int | None = None,
                 pipeline_depth: int | None = None):
        """device: None = "cuda" (raises without CUDA); "cpu" scores
        with the plain PyTorch version. max_slots / max_chunks:
        PER-DOCUMENT packer budgets; a document exceeding either falls
        back to the scalar engine. hint_priors: hinted batches also
        carry per-document prior planes (hints.prior_vector) that the
        kernel adds to languages a chunk already scored, before its
        top-2; None reads LDT_HINTS (default off).
        longdoc_chunk_slots: the long-doc lane's sub-pack size, also the
        sub-document budget `detect_spans` splits at; None reads
        LDT_LONGDOC_CHUNK_SLOTS (default 0: the lane off, detect_spans
        splitting at the scalar engine's SPAN_SPLIT_SLOTS; 1024 is
        the reference's default). longdoc_split_slots: the slot
        demand past which a document enters the lane at all (clamped
        up to the sub-pack size); None is LONGDOC_SPLIT_SLOTS.
        pipeline_depth: scheduler jobs in flight; None reads
        LDT_PIPELINE_DEPTH (default 2), 1 is the serial path."""
        self.device = resolve_device(device)
        self.tables = tables or load_tables()
        self.reg = reg or default_registry
        self.flags = flags
        self.max_slots = max_slots
        self.max_chunks = max_chunks
        self.hint_priors_enabled = (knobs.get_bool("LDT_HINTS")
                                    if hint_priors is None
                                    else bool(hint_priors))
        if not native.available():
            raise RuntimeError(
                "batched engine requires the native packer "
                "(language_detector_tpu_torch/native/build.sh); "
                "use detect_scalar without it")
        self.dt = DeviceTables.from_host(self.tables, self.reg,
                                         self.device)
        # stats: batches scored, device launches, packer fallbacks,
        # gate-failed docs re-scored, all-C tiny-batch docs, and the
        # scheduler's counters (the reference engine's key set). The key
        # set is fixed here: snapshots copy under the lock while flush
        # workers update it
        self.stats = {"batches": 0, "fallback_docs": 0,
                      "scalar_recursion_docs": 0,
                      "device_dispatches": 0,
                      # dispatches per tier lane ("mixed": streams too
                      # small to split), retry-lane dispatches, and
                      # documents answered by batch-internal dedup
                      "tier_short_dispatches": 0,
                      "tier_mid_dispatches": 0,
                      "tier_long_dispatches": 0,
                      "tier_mixed_dispatches": 0,
                      "retry_lane_dispatches": 0,
                      "dedup_docs": 0,
                      # gate-failed docs resolved scalar because the
                      # flush was near its deadline (trace.no_retry)
                      "retry_skipped_docs": 0,
                      # long-doc lane: split documents, the
                      # sub-documents they became, lane dispatches
                      "longdoc_split_docs": 0,
                      "longdoc_subdocs": 0,
                      "tier_longdoc_dispatches": 0,
                      # retried docs packed into a lane other than their
                      # own tier; the tier-keyed retry bins hold it at 0
                      "retry_offtier_docs": 0,
                      "c_path_docs": 0}
        self._stats_lock = make_lock("engine.stats")
        # depth = scheduler jobs in flight; 1 = the strictly serial
        # pack -> score -> epilogue path
        self.pipeline_depth = max(1, (knobs.get_int("LDT_PIPELINE_DEPTH")
                                      or 1) if pipeline_depth is None
                                  else pipeline_depth)
        self.longdoc_chunk_slots = (
            knobs.get_int("LDT_LONGDOC_CHUNK_SLOTS") or 0
            if longdoc_chunk_slots is None else longdoc_chunk_slots)
        # engage threshold: splitting costs a span scan plus a
        # merge, and a gate-failed doc re-scores whole anyway, so the
        # lane takes only the fat tail; docs between the sub-pack size
        # and this ride their tier unsplit
        self.longdoc_split_slots = max(
            self.longdoc_chunk_slots,
            self.LONGDOC_SPLIT_SLOTS if longdoc_split_slots is None
            else longdoc_split_slots)
        cuda = self.device.type == "cuda"
        # host staging ring for the wire's bucketed arrays (pinned on
        # the card): the in-flight bound plus the batch being packed
        self._staging = native.StagingRing(
            cap=self._inflight_bound() + 1, pinned=cuda)
        # one CUDA stream per job slot, handed out in turn: a job copies
        # its wire, launches and reads back on one stream, so its
        # readback waits for its own work and no other job's
        self._streams = ([torch.cuda.Stream(self.device)
                          for _ in range(self._inflight_bound() + 1)]
                         if cuda else [])
        self._stream_seq = itertools.count()
        # overlap accounting: pack wall time total / overlapped (a pack
        # counts as overlapped when a dispatch was in flight while it
        # ran) and long-doc chunk rows; own lock, off the stats path
        self._pipe = {"pack_ms_total": 0.0, "pack_ms_overlapped": 0.0,
                      "longdoc_chunks": 0}
        self._inflight = 0
        self._pipe_lock = make_lock("engine.pipe")
        if cuda:
            # build (or load) the kernel library now, not inside the
            # first flush: a service's flush timeout must not pay nvcc;
            # and finish the table upload before other streams read it
            kernels._load()
            torch.cuda.synchronize(self.device)

    def stats_snapshot(self) -> dict:
        """Copy of the running stats under the stats lock — the only
        safe way for another thread (the /metrics renderers) to read
        them."""
        with self._stats_lock:
            return dict(self.stats)

    def _inflight_bound(self) -> int:
        """Scheduler in-flight bound: how many dispatched jobs may be
        outstanding while the main thread packs the next one. Depth 1
        is strictly serial (0 outstanding — collect right after every
        submit); depth d >= 2 allows d+1 so one job can drain while d
        queue behind it."""
        d = self.pipeline_depth
        return 0 if d == 1 else d + 1

    def staging_stats(self) -> dict:
        """The staging ring's counters: leases out, hits, misses,
        shapes, and releases that found their copy still in flight
        (pending_releases; the readback orders every release after its
        copy, so it stays 0)."""
        return self._staging.stats()

    def pipeline_stats(self) -> dict:
        """Dispatch-pipeline snapshot for /metrics and /debug/vars, with
        the reference engine's keys: depth, overlap ratio (overlapped
        pack wall time / total pack wall time), jobs in flight, long-doc
        chunk rows and the staging ring. The kernel is "cuda"
        (csrc/fused_tote.cu) or "plain" (ops/score.py) by the engine's
        device; donation_hits stays 0 (CUDA has no buffer donation)."""
        with self._pipe_lock:
            p = dict(self._pipe)
            inflight = self._inflight
        ring = self._staging.stats()
        total = p["pack_ms_total"]
        kernel = "cuda" if self.device.type == "cuda" else "plain"
        return {
            "depth": self.pipeline_depth,
            "kernel": kernel,
            "kernel_requested": kernel,
            "kernel_reason": f"engine device {self.device}",
            "overlap_ratio":
                round(p["pack_ms_overlapped"] / total, 4) if total
                else 0.0,
            "pack_ms_total": round(total, 3),
            "pack_ms_overlapped": round(p["pack_ms_overlapped"], 3),
            "inflight": inflight,
            "donation_hits": 0,
            "longdoc_chunks": p["longdoc_chunks"],
            "staging_ring_occupancy": ring["occupancy"],
            "staging_ring_hits": ring["hits"],
            "staging_ring_misses": ring["misses"],
            "staging_ring_shapes": ring["shapes"],
        }

    # -- device dispatch ----------------------------------------------------

    def _launch(self, cb, lane: str = "main",
                full_out: bool = False) -> DeviceResult:
        """Copy the wire to the device and launch the scorer (word1, or
        [G, 2] words when full_out); returns before the kernel
        finishes. lane names the dispatch as the reference does (a tier
        name, "longdoc", "retry", "spans", "main") for whoever wraps
        this seam. On the card the job takes the next stream of the
        engine's set, and the lease records the event after its copy.
        A failed launch retires the dispatch (its lease goes back) and
        re-raises."""
        with self._pipe_lock:
            self._inflight += 1
        try:
            if faults.ACTIVE is not None:
                faults.hit("scorer_launch")
            if not self._streams:
                wire = wire_to_device(cb.wire, self.device)
                return DeviceResult(
                    kernels.score_chunks(self.dt, wire, full_out))
            stream = self._streams[next(self._stream_seq) %
                                   len(self._streams)]
            with torch.cuda.stream(stream):
                wire = wire_to_device(cb.wire, self.device)
                if cb.staging is not None:
                    cb.staging.copied = wire["copied"]
                return DeviceResult(
                    kernels.score_chunks(self.dt, wire, full_out), stream)
        except BaseException:
            self._retire(cb)
            raise

    def _retire(self, cb) -> None:
        """A dispatch is over: one fewer in flight, and its staging
        lease goes back to the ring."""
        with self._pipe_lock:
            self._inflight -= 1
        cb.release_staging()

    def _fetch_rows(self, cb, fut, unpack=None):
        """Wait for a launch and unpack its words against the wire's
        chunk meta into the flat [G, 5] rows the epilogue reads (or
        apply `unpack` to the words), then retire the dispatch. The
        lease goes back only after the unpack, which reads cmeta on the
        host, and after the readback, which waited for the job's
        stream and so for its wire copy."""
        try:
            words = np.asarray(fut)
            rows = (unpack_chunks_out(words, cb.wire["cmeta"])
                    if unpack is None else unpack(words))
        except BaseException:
            self._retire(cb)
            raise
        self._retire(cb)
        return rows

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
        (squeeze, fallback, gate retry). Serial, as in the reference;
        its packs stay off the staging ring, since the records read the
        wire after the readback."""
        cat_ind2 = host_tables(self.tables, self.reg).cat_ind2
        out: list = []
        for chunk in self._slices(texts, 16384):
            cb = self._pack(chunk, want_ranges=True, staging=False)
            rows, rows2 = self._fetch_rows(
                cb, self._launch(cb, full_out=True),
                unpack=lambda full: (
                    unpack_chunks_out(full[..., 0], cb.wire["cmeta"]),
                    unpack_chunks_out2(full[..., 1])))
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
        every document. Serial, as in the reference."""
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
            subs, bounds = split_for_spans(t, self.tables, budget,
                                           segment=self._span_scan)
            groups.append((len(subs_all), len(subs)))
            subs_all.extend(subs)
            bounds_all.append(bounds)
        cb = self._pack(subs_all)
        rows = self._fetch_rows(cb, self._launch(cb, "spans"))
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
        and run through the shared pipeline (_pipelined_jobs).
        Gate-failing and fallback docs run the scalar engine with the
        ORIGINAL text and hints."""
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

        def pack(job):
            s, e = job
            return self._pack(clean[s:e], hint_boosts=hbs[s:e],
                              hint_priors=prs[s:e] if prs is not None
                              else None)

        def finish(job, cb, fut):
            # both exception classes (packer fallback, gate failure)
            # resolve through the scalar engine with the ORIGINAL text
            # and hints: the batched retry pass carries no hint state
            s, e = job
            rows = self._fetch_rows(cb, fut)
            ep = native.epilogue_flat_native(rows, cb, self.flags,
                                             self.reg)
            out: list = []
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

        results: list = []
        with self._gc_paused():
            for part in self._pipelined_jobs(
                    self._slice_bounds([len(t) for t in clean], 16384),
                    pack, finish):
                results.extend(part)
        return results

    @staticmethod
    @contextlib.contextmanager
    def _gc_paused():
        """Interpreter tuning for a bulk-detection call, always restored
        on exit: the cyclic GC pauses (each batch makes a few small
        acyclic objects per document, which trip young-generation scans
        with nothing cyclic to find) and the GIL switch interval drops
        from 5 ms to 1 ms (the packing main thread re-takes the GIL
        after every C++ pack while workers hold it for result building).

        Used by the non-generator entry points only, so the try/finally
        always runs. Both knobs are process-global, so a depth counter
        makes overlapping bulk calls from different threads safe: the
        first entry saves and sets, the last exit restores. Cyclic
        garbage made by other threads while the GC is paused is bounded
        by a forced gc.collect() every GC_COLLECT_EVERY bulk exits
        (under sustained overlapping flushes the depth may never reach
        0); the collect runs outside the lock."""
        import gc
        import sys
        cls = NgramBatchEngine
        with cls._bulk_lock:
            cls._bulk_depth += 1
            if cls._bulk_depth == 1:
                cls._bulk_saved = (gc.isenabled(),
                                   sys.getswitchinterval())
                if cls._bulk_saved[0]:
                    gc.disable()
                sys.setswitchinterval(0.001)
        try:
            yield
        finally:
            collect_now = False
            with cls._bulk_lock:
                cls._bulk_depth -= 1
                cls._bulk_since_collect += 1
                if cls._bulk_depth == 0:
                    was_enabled, prev_si = cls._bulk_saved
                    sys.setswitchinterval(prev_si)
                    if was_enabled:
                        gc.enable()
                if cls._bulk_since_collect >= cls.GC_COLLECT_EVERY:
                    cls._bulk_since_collect = 0
                    collect_now = True
            if collect_now:
                gc.collect()

    # Streams with more unique documents than this partition into
    # per-tier dispatch lanes (the preprocess.pack shape-tier ladder);
    # smaller streams keep one mixed lane: every dispatch pays a fixed
    # per-launch cost, so splitting a small flush three ways buys
    # nothing and costs two extra launches.
    TIER_MIN_DOCS = 1024

    # A tier lane below this many docs folds into the next wider lane
    # instead of paying its own dispatch. Routing-only, like the ladder.
    TIER_COALESCE_MIN = 256

    # Retry lane: gate-failed docs accumulate across slices and dispatch
    # as soon as this many are pending, overlapping the recursion pass
    # with still-running main lanes instead of serializing one batched
    # pass at stream end. Smaller residues flush during the drain.
    RETRY_LANE_MIN = 64

    def detect_many(self, texts: list[str],
                    batch_size: int = 16384, trace=None) -> list:
        """Multi-batch detection through the stream scheduler; returns
        ScalarResult-compatible rows (EpilogueResult views; scalar-path
        docs get real ScalarResults). trace: optional telemetry.Trace
        the scheduler records its stage spans into (dedup, tier
        planning, pack, dispatch, retry lane)."""
        if self.flags & ~_DEVICE_OK_FLAGS or not texts:
            return self.detect_batch(texts)
        with self._gc_paused():
            return self._detect_stream(texts, batch_size, self._finish,
                                       trace=trace)

    def detect_codes(self, texts: list[str], batch_size: int = 16384,
                     trace=None) -> list[str]:
        """Summary ISO codes only — the reference's production semantic
        (wrapper.cc:7-16 discards everything but the code string), so
        the service fronts consume this. Skips per-document result
        materialization. trace: a telemetry.Trace that records the
        stages (c_path; dedup, longdoc_split, tier_plan, pack, dispatch,
        epilogue, longdoc, retry_lane)."""
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
        with self._gc_paused():
            vals = self._detect_stream(
                texts, batch_size, self._finish_codes,
                patch_value=lambda r: int(r.summary_lang), trace=trace)
        ids = np.fromiter((int(v) for v in vals), np.int32,
                          count=len(vals))
        return self.reg.lang_code[ids].tolist()

    # -- scheduling -----------------------------------------------------------

    def _detect_stream(self, texts: list[str], batch_size: int,
                       finish_fn, patch_value=None, trace=None):
        """The stream scheduler, three moves on top of slicing:

        1. batch-internal DEDUP: each distinct text is scored once and
           its result fanned out to every duplicate position;
        2. TIER PARTITION: unique docs split by estimated slot demand
           into the pack ladder's short / mid / long lanes, so each
           lane's slices pad against peers instead of the global worst
           case; documents past the long-doc threshold go to the
           long-doc lane instead;
        3. pipelined RETRY LANE: gate-failed docs aggregate across
           slices and re-dispatch mid-stream (_run_scheduler).

        finish_fn is _finish or _finish_codes (must accept deferred=);
        patch_value converts a retry/fallback ScalarResult into the
        stream's value type (identity for results, summary id for
        codes). Returns the complete per-doc value list in input
        order."""
        if patch_value is None:
            patch_value = lambda r: r  # noqa: E731
        # near-deadline flushes skip the pipelined retry lane: a gate
        # recursion is a second device round the budget cannot cover,
        # while the scalar resolution in _epilogue is immediate and
        # exact. 2x expected latency = this flush + a retry round.
        if trace is not None and not getattr(trace, "no_retry", False):
            dl = getattr(trace, "deadline", None)
            if dl is not None:
                from ..service.admission import expected_flush_ms
                if dl.remaining_ms() < 2.0 * expected_flush_ms():
                    trace.no_retry = True
        out: list = [None] * len(texts)
        # -- dedup: first occurrence scores, the rest copy ------------
        t_stage = time.monotonic()
        first: dict = {}
        uniq_idx: list = []   # global index of each unique doc
        uniq_txt: list = []
        dups: list = []       # (duplicate global index, unique position)
        for i, t in enumerate(texts):
            p = first.get(t)
            if p is None:
                first[t] = len(uniq_txt)
                uniq_idx.append(i)
                uniq_txt.append(t)
            else:
                dups.append((i, p))
        if dups:
            with self._stats_lock:
                self.stats["dedup_docs"] += len(dups)
        t_stage = telemetry.observe_stage("dedup", t_stage, trace=trace)
        # -- long-doc lane pre-gate -----------------------------------
        # Only the cheap pre-gate runs here (length bound + one
        # vectorized script scan); the span scan itself runs in the
        # scheduler's dispatch loop, under earlier jobs' device work. A
        # candidate that then fails to split rides the widest lane.
        ld_cand: set = set()
        if self.longdoc_chunk_slots > 0:
            # est_slot_demand is 8 + len//4, so docs under the char
            # threshold can never exceed the engage threshold
            min_chars = (self.longdoc_split_slots
                         - _TIER_BASE_SLOTS) << 2
            for p, t in enumerate(uniq_txt):
                if len(t) > min_chars and \
                        _maybe_multi_span(t, self.tables):
                    ld_cand.add(p)
        ld_cands = [(uniq_idx[p], uniq_txt[p]) for p in sorted(ld_cand)]
        t_stage = telemetry.observe_stage("longdoc_split", t_stage,
                                          trace=trace)
        # -- tier partition + per-lane volume slicing -----------------
        positions = ([p for p in range(len(uniq_txt))
                      if p not in ld_cand]
                     if ld_cand else list(range(len(uniq_txt))))
        if len(positions) > self.TIER_MIN_DOCS:
            by_tier: list = [[] for _ in range(N_TIERS)]
            for p in positions:
                by_tier[tier_of_text(uniq_txt[p])].append(p)
            # coalesce undersized lanes upward into the next wider
            # budget (a wider lane holds smaller docs bit-exactly); the
            # widest lane never coalesces: isolating the fat tail from
            # the main lane is the point of the ladder
            for k in range(N_TIERS - 1):
                if 0 < len(by_tier[k]) < self.TIER_COALESCE_MIN:
                    by_tier[k + 1] = sorted(by_tier[k] + by_tier[k + 1])
                    by_tier[k] = []
            lanes = [(TIER_NAMES[k], lane)
                     for k, lane in enumerate(by_tier) if lane]
        else:
            lanes = [("mixed", positions)] if positions else []
        jobs: list = []  # (tier name, global indices, texts)
        for name, lane in lanes:
            ltxt = [uniq_txt[p] for p in lane]
            for s, e in self._slice_bounds([len(t) for t in ltxt],
                                           batch_size):
                jobs.append((name,
                             [uniq_idx[lane[p]] for p in range(s, e)],
                             ltxt[s:e]))
        telemetry.observe_stage("tier_plan", t_stage, trace=trace)
        # -- dispatch -------------------------------------------------
        if len(jobs) == 1 and not ld_cands:
            # single-dispatch fast path (the service batcher's common
            # flush): no worker pool, local deferred retry
            name, idxs, txts = jobs[0]
            self._count_tier(name)
            t0 = time.monotonic()
            cb = self._pack(txts)
            telemetry.observe_stage("pack", t0, trace=trace)
            d: list = []
            vals = finish_fn(txts, cb, self._launch(cb, name),
                             deferred=d, trace=trace)
            for g, v in zip(idxs, vals):
                out[g] = v
            if d:
                t0 = time.monotonic()
                for g, r in self._retry_deferred(
                        [(idxs[b], t, sq) for b, t, sq in d]).items():
                    out[g] = patch_value(r)
                telemetry.observe_stage("retry_lane", t0, trace=trace)
        elif jobs or ld_cands:
            self._run_scheduler(jobs, batch_size, finish_fn,
                                patch_value, out, trace=trace,
                                ld_cands=ld_cands)
        for i, p in dups:
            out[i] = out[uniq_idx[p]]
        return out

    def _run_scheduler(self, jobs, batch_size, finish_fn, patch_value,
                       out, trace=None, ld_cands=None):
        """Multi-lane pipeline with the overlapped retry lane. The main
        thread only packs (C++, GIL released); worker threads launch on
        their job's stream, read back and run the epilogue. At most
        _inflight_bound() jobs stay outstanding while the next one
        packs (depth 1 collects every dispatch before the next pack).
        Main jobs drop their gate failures into (squeezed, tier)-keyed
        retry bins; whenever a bin reaches RETRY_LANE_MIN the bin
        re-packs AT ITS OWN TIER and dispatches as a retry job on the
        same pending queue, so recursion rounds overlap main-lane
        scoring without inflating every retried doc to the tail lane's
        shape (retry_offtier_docs audits that; it stays 0). Retry jobs
        carry FINISH so they never defer again, and the drain ends.
        Long-doc candidates stream through the loop after the main
        jobs: their span scan (one threaded native call, GIL released)
        and split_longdoc run on the main thread while earlier jobs
        score on the card; split docs
        group by char volume into long-doc jobs whose per-chunk rows
        merge back into one document each
        (result_vector.merge_longdoc_chunks); candidates that refuse to
        split ride the long lane unsplit at the end."""
        retry_lock = make_lock("engine.retry")
        # (squeezed, tier) -> [(gidx, text)]
        retry_bins: dict = {}

        def run_main(lane, idxs, txts, cb):
            d: list = []
            vals = finish_fn(txts, cb, self._launch(cb, lane),
                             deferred=d, trace=trace)
            if d:
                with self._stats_lock:
                    self.stats["scalar_recursion_docs"] += len(d)
                with retry_lock:
                    for b, t, sq in d:
                        retry_bins.setdefault(
                            (sq, tier_of_text(t)), []).append((idxs[b], t))
            return ("main", idxs, vals)

        def run_longdoc(cb, groups, gidx, origs):
            """One long-doc job: sub-documents score as a normal pack,
            then merge back into per-document chunk sequences for the
            flat epilogue (the split is span-aligned and the DocTote
            additive, so the merged epilogue equals the unsplit one).
            Fallback or squeeze on any sub-doc resolves the WHOLE doc
            through the scalar engine; gate failures re-enter the retry
            bins UNSPLIT at their own tier: the REPEATS squeeze of the
            recursion dedups words across the whole document, so only
            the clean first pass is safe to split."""
            t0 = time.monotonic()
            rows = self._fetch_rows(cb, self._launch(cb, "longdoc"))
            with self._stats_lock:
                self.stats["device_dispatches"] += 1
            mrows, mcb = merge_longdoc_chunks(rows, cb, groups)
            nch = int(mcb.n_chunks.sum())
            with self._pipe_lock:
                self._pipe["longdoc_chunks"] += nch
            telemetry.REGISTRY.counter_inc(
                "ldt_pipeline_longdoc_chunks_total", nch)
            ep = native.epilogue_flat_native(mrows, mcb, self.flags,
                                             self.reg)
            no_retry = trace is not None and getattr(trace, "no_retry",
                                                     False)
            patches: dict = {}
            gate_fail: list = []
            n_fb = n_skip = 0
            for j, g in enumerate(gidx):
                if mcb.fallback[j] or mcb.squeezed[j]:
                    n_fb += 1
                    patches[g] = detect_scalar(origs[j], self.tables,
                                               self.reg, self.flags)
                elif ep[j, 12]:
                    if no_retry:
                        n_skip += 1
                        patches[g] = detect_scalar(
                            origs[j], self.tables, self.reg, self.flags)
                    else:
                        gate_fail.append(j)
                else:
                    patches[g] = _result_from_row(ep[j])
            if gate_fail:
                with retry_lock:
                    for j in gate_fail:
                        retry_bins.setdefault(
                            (False, tier_of_text(origs[j])),
                            []).append((gidx[j], origs[j]))
            with self._stats_lock:
                self.stats["fallback_docs"] += n_fb
                self.stats["retry_skipped_docs"] += n_skip
                self.stats["scalar_recursion_docs"] += len(gate_fail)
            telemetry.observe_stage("longdoc", t0, trace=trace)
            return ("retry", patches)

        def run_retry(idxs, txts, cb, flags):
            t0 = time.monotonic()
            rows = self._fetch_rows(cb, self._launch(cb, "retry"))
            with self._stats_lock:
                self.stats["device_dispatches"] += 1
                self.stats["retry_lane_dispatches"] += 1
            ep = native.epilogue_flat_native(rows, cb, flags, self.reg)
            patches: dict = {}
            for b, text in enumerate(txts):
                # FINISH pass: a doc the packer still can't place, or
                # that still fails the (now forced) gate, goes scalar —
                # identical to _score_with_flags resolution
                if cb.fallback[b] or ep[b, 12]:
                    patches[idxs[b]] = detect_scalar(
                        text, self.tables, self.reg, self.flags)
                else:
                    patches[idxs[b]] = _result_from_row(ep[b])
            telemetry.observe_stage("retry_lane", t0, trace=trace)
            return ("retry", patches)

        pending: deque = deque()

        def collect(res):
            if res[0] == "main":
                _, idxs, vals = res
                for g, v in zip(idxs, vals):
                    out[g] = v
            else:
                for g, r in res[1].items():
                    out[g] = patch_value(r)

        bound = self._inflight_bound()
        with ThreadPoolExecutor(max(1, bound)) as pool:

            def submit_retries(min_docs):
                grabbed = []
                with retry_lock:
                    for key, docs in retry_bins.items():
                        if docs and len(docs) >= max(min_docs, 1):
                            grabbed.append((key, docs))
                            retry_bins[key] = []
                for (sq, tier), group in grabbed:
                    flags = self._retry_flags(sq)
                    gidx = [g for g, _ in group]
                    gtxt = [t for _, t in group]
                    # tier-keyed bins repack each doc at its own shape;
                    # any doc landing off-tier is a routing bug
                    off = sum(1 for t in gtxt if tier_of_text(t) != tier)
                    if off:
                        with self._stats_lock:
                            self.stats["retry_offtier_docs"] += off
                    for s, e in self._slice_bounds(
                            [len(t) for t in gtxt], batch_size):
                        t0 = time.monotonic()
                        cb = self._pack(gtxt[s:e], flags=flags)
                        telemetry.observe_stage("pack", t0, trace=trace)
                        pending.append(pool.submit(
                            run_retry, gidx[s:e], gtxt[s:e], cb, flags))

            def keep_bound():
                while len(pending) > bound:
                    collect(pending.popleft().result())
                submit_retries(self.RETRY_LANE_MIN)

            # long-doc job accumulator: each doc's sub-packs stay
            # contiguous in one job — the merge needs the whole chunk
            # sequence in one fetch
            cur_txt: list = []
            cur_groups: list = []
            cur_gidx: list = []
            cur_orig: list = []
            cur_vol = 0

            def flush_ld():
                nonlocal cur_txt, cur_groups, cur_gidx, cur_orig, \
                    cur_vol
                if not cur_txt:
                    return
                t0 = time.monotonic()
                self._count_tier("longdoc")
                cb = self._pack(cur_txt)
                telemetry.observe_stage("pack", t0, trace=trace)
                pending.append(pool.submit(run_longdoc, cb, cur_groups,
                                           cur_gidx, cur_orig))
                cur_txt, cur_groups, cur_gidx, cur_orig = \
                    [], [], [], []
                cur_vol = 0
                keep_bound()

            # main jobs first: their dispatches put work on the card so
            # the long-doc span scans below run under it
            for name, idxs, txts in jobs:
                t0 = time.monotonic()
                self._count_tier(name)
                cb = self._pack(txts)
                telemetry.observe_stage("pack", t0, trace=trace)
                pending.append(pool.submit(run_main, name, idxs,
                                           txts, cb))
                keep_bound()
            # stream the long-doc candidates: one threaded native span
            # scan of them all (GIL released, under the in-flight device
            # rounds), then split, group by char volume, dispatch as the
            # budget fills
            spill_idx: list = []
            spill_txt: list = []
            t0 = time.monotonic()
            ld_spans = (native.span_extents_native(
                [t for _, t in ld_cands], self.tables, self.reg)
                if ld_cands else [])
            for (gidx_one, text), spans in zip(ld_cands or [], ld_spans):
                subs = split_longdoc(text, self.tables,
                                     self.longdoc_chunk_slots,
                                     segment=self._span_scan, spans=spans)
                t0 = telemetry.observe_stage("longdoc_split", t0,
                                             trace=trace)
                if not subs:
                    spill_idx.append(gidx_one)
                    spill_txt.append(text)
                    continue
                with self._stats_lock:
                    self.stats["longdoc_split_docs"] += 1
                    self.stats["longdoc_subdocs"] += len(subs)
                vol = sum(len(s) for s in subs)
                if cur_txt and cur_vol + vol > self.DISPATCH_CHAR_BUDGET:
                    flush_ld()
                cur_groups.append((len(cur_txt), len(subs)))
                cur_txt.extend(subs)
                cur_gidx.append(gidx_one)
                cur_orig.append(text)
                cur_vol += vol
            flush_ld()
            for s, e in self._slice_bounds(
                    [len(t) for t in spill_txt], batch_size):
                t0 = time.monotonic()
                self._count_tier("long")
                cb = self._pack(spill_txt[s:e])
                telemetry.observe_stage("pack", t0, trace=trace)
                pending.append(pool.submit(run_main, "long",
                                           spill_idx[s:e],
                                           spill_txt[s:e], cb))
                keep_bound()
            # drain: once pending empties no worker is running, so the
            # bins are stable and min_docs=1 flushes the residue
            while pending or any(retry_bins.values()):
                if pending:
                    collect(pending.popleft().result())
                submit_retries(self.RETRY_LANE_MIN if pending else 1)

    def _span_scan(self, text: str) -> list:
        """The long-doc split's span scan: the native packer's
        segmentation (preprocess.pack.span_extents in C++)."""
        return native.span_extents_native([text], self.tables,
                                          self.reg)[0]

    def _count_tier(self, name: str) -> None:
        with self._stats_lock:
            self.stats[f"tier_{name}_dispatches"] += 1

    def _pipelined_jobs(self, jobs, pack, finish):
        """Shared pipeline core: the main thread ONLY packs; each worker
        launches its slice on its job's stream, reads back and runs
        finish(job, cb, fut). Yields the finish values in job order,
        with at most _inflight_bound() jobs outstanding while the next
        one packs (depth 1 collects each dispatch before the next
        pack). A single-job call skips the pool: its flushes already
        overlap on the service batcher's workers."""
        jobs = iter(jobs)
        first = next(jobs, None)
        if first is None:
            return
        second = next(jobs, None)
        if second is None:
            cb = pack(first)
            yield finish(first, cb, self._launch(cb))
            return

        def launch_and_finish(job, cb):
            return finish(job, cb, self._launch(cb))

        bound = self._inflight_bound()
        pending: deque = deque()
        with ThreadPoolExecutor(max(1, bound)) as pool:
            for job in itertools.chain([first, second], jobs):
                cb = pack(job)
                pending.append(pool.submit(launch_and_finish, job, cb))
                while len(pending) > bound:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

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
              want_ranges: bool = False, staging: bool = True):
        """Pack only (no device launch). The wire's bucketed arrays come
        from the staging ring (pinned on the card) unless staging=False;
        without hints the wire is the plain one (no whack rows, no prior
        planes). The pack is timed for the overlap ratio: it counts as
        overlapped when a dispatch was in flight while it ran."""
        fl = self.flags if flags is None else flags
        t0 = time.monotonic()
        with self._pipe_lock:
            overlapped = self._inflight > 0
        cb = native.pack_chunks_native(
            texts, self.tables, self.reg, flags=fl,
            l_doc=self.max_slots, c_doc=self.max_chunks,
            hint_boosts=hint_boosts, hint_priors=hint_priors,
            want_ranges=want_ranges,
            staging=self._staging if staging else None)
        ms = (time.monotonic() - t0) * 1e3
        with self._pipe_lock:
            self._pipe["pack_ms_total"] += ms
            if overlapped or self._inflight > 0:
                self._pipe["pack_ms_overlapped"] += ms
        return cb

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
        DetectLanguageSummaryV2 call (impl.cc:2061-2105) — or, when the
        flush is near its deadline (trace.no_retry), resolve in the
        scalar engine at once (same answer, no second device round).

        deferred: when given, gate-failed docs are appended as (local
        index, text, squeezed) for the caller's retry lane instead of
        being retried here. Returns (ep [B, 14], {doc index:
        ScalarResult} patches). The "dispatch" stage is the device wait,
        from fetch start to rows on the host."""
        if faults.ACTIVE is not None:
            try:
                faults.hit("device_flush")
            except BaseException:
                # the flush dies before its fetch: retire the dispatch
                # so the in-flight count and the staging ring cannot
                # drift when the batcher's failure path re-dispatches
                self._retire(cb)
                raise
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
        need = np.flatnonzero(ep[:B, 12])
        if not need.size:
            return ep, patches
        local_retry: list = []  # (index, text, squeezed)
        no_retry = trace is not None and getattr(trace, "no_retry",
                                                 False)
        n_skipped = 0
        for b in need:
            b = int(b)
            if cb.fallback[b]:
                patches[b] = detect_scalar(texts[b], self.tables,
                                           self.reg, self.flags)
            elif no_retry:
                # detect_scalar runs the full reference algorithm, its
                # own recursion included: the batched retry's answer
                patches[b] = detect_scalar(texts[b], self.tables,
                                           self.reg, self.flags)
                n_skipped += 1
            elif deferred is not None:
                deferred.append((b, texts[b], bool(cb.squeezed[b])))
            else:
                local_retry.append((b, texts[b], bool(cb.squeezed[b])))
        if n_skipped:
            with self._stats_lock:
                self.stats["retry_skipped_docs"] += n_skipped
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
        by the same content-volume budget as the main path and run
        through the shared pipeline core. Docs the packer cannot place,
        or that still fail, fall back to the scalar engine with the
        engine's own flags."""

        def pack(chunk):
            return self._pack(chunk, flags=flags)

        def finish(chunk, cb, fut):
            rows = self._fetch_rows(cb, fut)
            with self._stats_lock:
                self.stats["device_dispatches"] += 1
            ep = native.epilogue_flat_native(rows, cb, flags, self.reg)
            out: list = []
            for b, text in enumerate(chunk):
                row = ep[b]
                if cb.fallback[b] or row[12]:
                    out.append(detect_scalar(text, self.tables,
                                             self.reg, self.flags))
                else:
                    out.append(_result_from_row(row))
            return out

        results: list = []
        for part in self._pipelined_jobs(self._slices(texts, 16384),
                                         pack, finish):
            results.extend(part)
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
