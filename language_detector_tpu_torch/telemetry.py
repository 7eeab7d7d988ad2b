"""Process-wide telemetry: latency histograms, request-scoped span
traces, compile-event tracking, and the slow-request sampler.

The port's copy of language_detector_tpu/telemetry.py. The reference
service exports four flat Prometheus counters (main.go:137-147); this
module is the observability layer that says WHERE a slow request spent
its time. Four pieces:

  Histogram        thread-safe fixed log-scaled latency buckets,
                   rendered in Prometheus exposition format
                   (`*_bucket`/`_sum`/`_count`) next to the counters
  Trace            request-scoped span recorder: monotonic-clock pairs,
                   one list append per span, no per-event allocation
                   beyond the span tuple — cheap enough for every
                   request on the hot path
  CompileTracker   first-execution detection per padded wire shape per
                   dispatch lane, exported as ldt_xla_compiles_total
                   (bucket-ladder churn becomes visible instead of
                   showing up as mystery multi-second requests)
  SlowTraceRing    bounded ring of full span trees for requests over
                   LDT_SLOW_TRACE_MS (off by default), served by
                   GET /debug/slow and `debug.py --slow-traces`

One module-level REGISTRY is shared by the sync and asyncio fronts, the
batcher flush workers, and the engine scheduler — a request's span tree
is assembled across all of them (handler spans + grafted flush spans),
and /metrics on either front renders the same registry.

Env knobs: LDT_SLOW_TRACE_MS (threshold, 0/unset = sampler off),
LDT_SLOW_TRACE_RING (ring capacity, default 64) — declared, like every
knob, in language_detector_tpu_torch/knobs.py.
"""
from __future__ import annotations

import os
import time
from bisect import bisect_left
from collections import deque

from . import knobs
from .locks import make_lock

_mono = time.monotonic

_PROCESS_START = time.time()

# Central declaration of every ldt_* Prometheus series the package
# emits: name -> (type, help). This is the single source the /metrics
# renderers pull HELP/TYPE text from. It is the reference's declaration,
# names kept (dashboards and debug.py read them), less two series of
# events the port does not have: ldt_xla_compile_ms (the port compiles
# nothing inside a flush, so the stall watchdog folds in no compile
# time) and ldt_pipeline_donation_hits_total (the port donates no
# device buffer). ldt_xla_compiles_total counts the kernel library's
# first load in a process (ops/kernels._load).
METRICS: dict = {
    "ldt_stage_latency_ms": (
        "histogram",
        "Per-stage wall time (ms) through the request pipeline."),
    "ldt_request_latency_ms": (
        "histogram",
        "End-to-end HTTP request wall time (ms)."),
    "ldt_xla_compiles_total": (
        "counter",
        "Jitted-scorer compilations: first execution of a new "
        "padded wire shape, per dispatch lane."),
    "ldt_shed_total": (
        "counter",
        "Requests shed by admission control, by reason "
        "(service/admission.py)."),
    "ldt_deadline_expired_total": (
        "counter",
        "Requests dropped at dequeue because their X-LDT-Deadline-Ms "
        "budget had already passed."),
    "ldt_batch_flushes_total": (
        "counter", "Engine batch flushes (all paths)."),
    "ldt_device_dispatches_total": (
        "counter",
        "Device program launches (recycle-watcher meter)."),
    "ldt_kernel_launches_total": (
        "counter",
        "Fused-tote CUDA kernel launches by this process "
        "(ops/kernels.py launches; 0 on the CPU's plain scorer). The "
        "port's series: it equals ldt_device_dispatches_total without a "
        "pool."),
    "ldt_fallback_documents_total": (
        "counter",
        "Documents resolved off the device path "
        "(packer fallback + gate recursion)."),
    "ldt_tier_dispatches_total": (
        "counter", "Dispatches per shape-tier lane."),
    "ldt_retry_lane_dispatches_total": (
        "counter", "Overlapped retry-lane dispatches."),
    "ldt_dedup_documents_total": (
        "counter", "Documents answered by batch-internal dedup."),
    "ldt_result_cache_hit_rate": (
        "gauge", "Result-cache hit rate since start."),
    "ldt_result_cache_hits_total": (
        "counter", "Result-cache hits."),
    "ldt_result_cache_bytes": (
        "gauge", "Result-cache resident bytes."),
    "ldt_admission_queue_docs": (
        "gauge", "Documents admitted and not yet completed."),
    "ldt_admission_queue_bytes": (
        "gauge",
        "Byte-weighted admission cost currently held "
        "(4 bytes per estimated packer slot)."),
    "ldt_admission_inflight": (
        "gauge", "HTTP requests admitted and in flight."),
    "ldt_brownout_level": (
        "gauge",
        "Graceful-degradation level (0=healthy 1=skip-retry-lane "
        "2=cache+scalar-only 3=shed-non-priority)."),
    "ldt_breaker_state": (
        "gauge",
        "Device-path circuit breaker (0=closed 1=half-open 2=open)."),
    "ldt_fault_injected_total": (
        "counter",
        "Injected faults that actually fired, by fault point "
        "(language_detector_tpu_torch/faults.py, LDT_FAULTS spec)."),
    "ldt_ready": (
        "gauge",
        "Readiness: 1 when the artifact is loaded, the breaker is not "
        "open, and brownout is below shed — the /readyz contract."),
    "ldt_worker_generation": (
        "gauge",
        "Worker generation under the supervisor (LDT_WORKER_GENERATION"
        "; 0 = unsupervised)."),
    "ldt_swap_total": (
        "counter",
        "Artifact hot swaps by result: ok (new tables serving — "
        "counted by a standby generation once ready, or by "
        "service/swap.py after an in-process rebind), error (aborted; "
        "the old tables keep serving), or integrity_refused (the "
        "standby artifact failed its digest footer; the old tables "
        "keep serving)."),
    "ldt_integrity_scrub_total": (
        "counter",
        "Integrity scrub passes per pool lane by result: ok, mismatch "
        "(digest or canary deviation — the lane quarantined), or "
        "error (the scrub itself failed; the lane keeps serving and "
        "the next pass retries)."),
    "ldt_integrity_detected_total": (
        "counter",
        "Corruption detections by kind (scrub = device table digest "
        "mismatch, canary = golden-query deviation, frame_crc = "
        "wire/shm payload CRC mismatch) and lane."),
    "ldt_integrity_healed_total": (
        "counter",
        "Quarantined lanes healed: fresh tables re-uploaded from the "
        "host mmap, fingerprint re-verified, lane re-admitted through "
        "the half-open probe flow."),
    "ldt_integrity_crc_total": (
        "counter",
        "Frame payload CRC32 checks by ingest lane and result "
        "(LDT_WIRE_CRC; a mismatch refuses the frame with a typed 400 "
        "before any parse)."),
    "ldt_warmup_ms": (
        "gauge",
        "Startup bucket-ladder warmup duration (LDT_WARMUP); 0 until "
        "warmup completes / when warmup is off."),
    "ldt_tenant_shed_total": (
        "counter",
        "Requests shed by admission control, by tenant and reason "
        "(X-LDT-Tenant header; absent = \"default\")."),
    "ldt_tenant_queue_bytes": (
        "gauge",
        "Byte-weighted admission cost currently held, per tenant."),
    "ldt_pool_lane_evicted_total": (
        "counter",
        "Device-pool lanes evicted from rotation after consecutive "
        "failures (parallel/pool.py), per lane."),
    "ldt_pool_lane_readmitted_total": (
        "counter",
        "Evicted lanes re-admitted to rotation after a successful "
        "half-open probe, per lane."),
    "ldt_pool_failover_total": (
        "counter",
        "Batches re-dispatched on a surviving lane after a lost-batch "
        "error on their original lane."),
    "ldt_pool_hedges_total": (
        "counter",
        "Straggler hedges by outcome: result=won (the hedge answered "
        "first) or result=lost (the original dispatch finished first)."),
    "ldt_pool_probe_admits_total": (
        "counter",
        "Requests admitted through a full-shed brownout as the pool's "
        "half-open probe vehicle (probes are traffic-driven; a blanket "
        "shed would leave a fully evicted pool down forever)."),
    "ldt_pool_lanes_active": (
        "gauge",
        "Device-pool lanes currently in rotation (active + probing)."),
    "ldt_pool_lanes_total": (
        "gauge", "Device-pool lane count (0 = pool disabled)."),
    "ldt_pipeline_overlap_ratio": (
        "gauge",
        "Fraction of host pack wall time that ran while a device "
        "dispatch was in flight (models/ngram.py pipeline; 0 = fully "
        "serial)."),
    "ldt_pipeline_depth": (
        "gauge",
        "Configured dispatch-pipeline depth (LDT_PIPELINE_DEPTH; 1 = "
        "serial reference path)."),
    "ldt_pipeline_staging_ring_occupancy": (
        "gauge",
        "Host staging-ring arrays currently checked out by in-flight "
        "dispatches (native pack staging; steady state stays below "
        "the ring capacity, so packing allocates nothing)."),
    "ldt_pipeline_longdoc_chunks_total": (
        "counter",
        "Span-aligned sub-documents created by the long-doc lane "
        "(LDT_LONGDOC_CHUNK_SLOTS splitting in preprocess/pack.py)."),
    "ldt_http_parse_ms": (
        "histogram",
        "Request-body parse wall time (ms) through the shared wire "
        "path (service/wire.py), fast scanner and json.loads "
        "fallback alike, on every lane."),
    "ldt_http_serialize_ms": (
        "histogram",
        "Response assembly wall time (ms): per-code fragment fill + "
        "writev-style buffer-list build (wire.post_detect)."),
    "ldt_http_parse_fast_total": (
        "counter",
        "Zero-copy scanner outcomes by result=hit|miss; a miss fell "
        "back to json.loads (non-conforming shape, escapes needing "
        "exact semantics, or invalid bodies)."),
    "ldt_http_requests_total": (
        "counter",
        "Detection requests by ingest lane (lane=tcp|uds), counted "
        "on both fronts."),
    "ldt_fleet_spawn_total": (
        "counter",
        "Fleet member spawns by reason=initial|restart|probe|swap "
        "(service/fleet.py)."),
    "ldt_fleet_worker_lost_total": (
        "counter",
        "Fleet members lost by reason=crash (nonzero exit) or "
        "reason=lost (killed via the worker_lost fault seam / health "
        "kill)."),
    "ldt_fleet_scale_total": (
        "counter",
        "Autoscale steps by direction=up|down (hysteresis-held queue "
        "depth / brownout signal)."),
    "ldt_fleet_desired": (
        "gauge",
        "Fleet desired member count (between LDT_FLEET_MIN/MAX)."),
    "ldt_fleet_ready": (
        "gauge", "Fleet members currently READY."),
    "ldt_fleet_members": (
        "gauge",
        "Fleet member slots (including spawning/dead/parked)."),
    "ldt_fleet_circuit_state": (
        "gauge",
        "Fleet crash circuit: 0 closed, 1 open (correlated crash — "
        "restarts parked), 2 half-open probe in flight."),
    "ldt_fleet_config_heal_total": (
        "counter",
        "Members re-pushed onto the fleet-committed config by the "
        "supervisor's heal pass (a respawn or missed fan-out left "
        "them on an older config generation)."),
    "ldt_shm_rings": (
        "gauge",
        "Shared-memory ring files currently attached by the scan "
        "thread (service/shmring.py)."),
    "ldt_shm_slots_free": (
        "gauge",
        "FREE slots across all attached shm rings (ring capacity "
        "headroom; equals total slots when the lane is idle)."),
    "ldt_shm_frames_total": (
        "counter",
        "Frames answered on the shm ring lane by result=ok|error|"
        "fenced (fenced = stale-generation frame failed back with an "
        "explicit error frame)."),
    "ldt_shm_reclaimed_total": (
        "counter",
        "Ring slots reclaimed by reason=writer-lost (client dead or "
        "stalled mid-WRITING), client-dead (unconsumed DONE), "
        "generation (fenced frame failed back), corrupt (header with "
        "no legal transition path), attach-fault (injected attach "
        "failure, ring retried)."),
    "ldt_quarantine_docs_total": (
        "counter",
        "Docs quarantined after bisection proved they "
        "deterministically kill a scorer batch; quarantined docs "
        "answer \"un\" and never reach the scorer again."),
    "ldt_quarantine_bisect_total": (
        "counter",
        "Bisection passes run while isolating poison docs from a "
        "killed batch (each pass re-scores the two halves)."),
    "ldt_device_ms": (
        "histogram",
        "Per-flush device-vs-host wall time split (ms) from the engine "
        "epilogue: phase=device is the device wait (fetch start to "
        "rows on host), phase=host is the native epilogue."),
    "ldt_error_traces_total": (
        "counter",
        "Span trees force-recorded into the slow ring because the "
        "request answered 5xx (reason:error capture — recorded "
        "regardless of LDT_SLOW_TRACE_MS)."),
    "ldt_flightrec_events_total": (
        "counter",
        "Structured events written to the crash-safe flight recorder "
        "(language_detector_tpu_torch/flightrec.py, LDT_FLIGHTREC_DIR)."),
    "ldt_flightrec_dropped_total": (
        "counter",
        "Flight-recorder events dropped because their payload "
        "exceeded the ring's slot capacity."),
    "ldt_postmortem_total": (
        "counter",
        "Dead-member flight recorders harvested into postmortem JSON "
        "by the fleet/worker supervisor, by result=ok|empty|error."),
    "ldt_profile_captures_total": (
        "counter",
        "On-demand device-profiler capture windows, by "
        "result=ok|error|busy|unavailable (POST /profilez, SIGUSR2)."),
    "ldt_aot_loads_total": (
        "counter",
        "Kernel libraries loaded from the bundle (LDT_AOT_DIR, aot.py) "
        "instead of built by nvcc — the boot-hot path; at most one per "
        "process."),
    "ldt_aot_exports_total": (
        "counter",
        "Kernel libraries written into the bundle (write-back after a "
        "build or a compile-cache load); the next generation loads "
        "these."),
    "ldt_aot_refused_total": (
        "counter",
        "Bundle entries refused by reason=missing|corrupt|"
        "digest_mismatch|torch_mismatch|cuda_mismatch|arch_mismatch|"
        "kernel_mismatch|source_mismatch|undeserializable|io_error|"
        "empty — each refusal falls back to an nvcc build (or raises "
        "under LDT_AOT_REQUIRE) and is overwritten by write-back."),
    "ldt_shared_cache_hits_total": (
        "counter",
        "Fleet-shared result-cache hits (LDT_RESULT_CACHE_SHM_MB, "
        "service/sharedcache.py): a doc answered from another "
        "worker's published result."),
    "ldt_shared_cache_misses_total": (
        "counter",
        "Fleet-shared result-cache lookups that found no live entry "
        "(absent, epoch-stale, torn, or CRC-refused slots all count "
        "here — the read path never distinguishes, it just misses)."),
    "ldt_shared_cache_evictions_total": (
        "counter",
        "Shared-cache slots overwritten by a new key whose probe "
        "window was full (deterministic displacement eviction)."),
    "ldt_shared_cache_epoch_flush_total": (
        "counter",
        "Shared-cache entries invalidated by an artifact-swap epoch "
        "sweep (stale-epoch slots freed so a new artifact can never "
        "serve the old artifact's results)."),
    # -- traffic capture plane (capture.py) ---------------------------
    "ldt_capture_records_total": (
        "counter",
        "Requests recorded by the traffic-capture plane (committed "
        "into the capture ring; excludes sampled-out requests)."),
    "ldt_capture_sampled_out_total": (
        "counter",
        "Requests skipped by LDT_CAPTURE_SAMPLE probabilistic "
        "sampling (capture armed but the coin came up tails)."),
    "ldt_capture_ring_occupancy": (
        "gauge",
        "Committed records currently in this process's active capture "
        "ring (seals into a segment at LDT_CAPTURE_RING_RECORDS)."),
    "ldt_capture_segments_total": (
        "counter",
        "Capture rings sealed into immutable segment files (size-"
        "bounded rotation; oldest segments pruned past "
        "LDT_CAPTURE_MAX_SEGMENTS)."),
    # -- SLO engine (slo.py) ------------------------------------------
    "ldt_slo_events_total": (
        "counter",
        "Completed requests scored by the SLO engine, labelled by "
        "result: good, bad (error or over-target latency), or shed "
        "(load-shedding rejections burn error budget separately)."),
    "ldt_slo_breaches_total": (
        "counter",
        "SLO burn-rate alerts fired (fleet scope and per-tenant "
        "scopes both count; see slo_breach flight-recorder events "
        "for the attribution)."),
    "ldt_slo_alert": (
        "gauge",
        "1 while a fleet-scope SLO burn-rate alert is firing, else 0 "
        "(per-tenant alert states are on /sloz)."),
    "ldt_slo_burn_rate": (
        "gauge",
        "Fleet-scope error-budget burn rate per window (window=fast|"
        "slow): 1.0 burns exactly the declared budget; sustained "
        ">1.0 in both windows fires the alert."),
    "ldt_slo_budget_remaining": (
        "gauge",
        "Fraction of the fleet-scope error budget left in the slow "
        "window (1.0 = untouched, 0 = fully burned)."),
    # -- runtime config plane (configplane.py) ------------------------
    "ldt_config_generation": (
        "gauge",
        "Last COMMITTED runtime-config generation in this process "
        "(0 = no POST /configz apply ever committed)."),
    "ldt_config_state": (
        "gauge",
        "Config-plane FSM state (0=idle 1=staged 2=probation "
        "3=committed 4=rolled_back)."),
    "ldt_config_applies_total": (
        "counter",
        "POST /configz apply outcomes by result: applied (live under "
        "SLO probation), committed (survived the window), rolled_back "
        "(fast-window burn crossed 1.0 — the prior overrides were "
        "restored), or refused (registry type/bound/range validation "
        "failed; nothing applied)."),
    # -- SLO autotuner (autotune.py, bench.py --autotune) -------------
    "ldt_autotune_evals_total": (
        "counter",
        "Autotuner candidate-config evaluations: one scored probe "
        "(replayed traffic slice) per candidate in the coordinate-"
        "descent search over the mutable-knob space."),
    "ldt_autotune_rounds_total": (
        "counter",
        "Autotuner coordinate-descent passes over the declared "
        "mutable-knob space (a pass with no improvement ends the "
        "search)."),
    # -- disk-full hardening (capture.py, flightrec.py, aot.py) -------
    "ldt_capture_disabled_total": (
        "counter",
        "Traffic-capture plane disabled at runtime by reason=enospc "
        "(ring create or segment seal hit a disk-full/unwritable "
        "OSError); serving continues, capture becomes a no-op."),
    "ldt_flightrec_disabled_total": (
        "counter",
        "Flight recorder disabled at runtime by reason=enospc (ring "
        "create/mmap hit a disk-full OSError); serving continues, "
        "every emit is one None check."),
    "ldt_aot_disabled_total": (
        "counter",
        "AOT export write-back disabled for the process by "
        "reason=enospc (a bundle write hit a disk-full OSError); "
        "loads keep working and serving is untouched."),
    # -- accuracy plane (evalsuite.py, detect_spans lane) -------------
    "ldt_span_docs_total": (
        "counter",
        "Documents answered through the per-span lane (detect_spans; "
        "LDT_SPANS=1 surfaces). Each doc also appears in the regular "
        "dispatch counters — this series measures span-lane share."),
    "ldt_eval_docs_total": (
        "counter",
        "Labeled corpus documents scored by the eval scorecard "
        "(evalsuite.run_eval; bench.py --eval). Counts per run, so "
        "rate() over it shows scorecard cadence, not serving load."),
}


def metric_help(name: str) -> str:
    return METRICS[name][1] if name in METRICS else name


def metric_family(name: str, samples: list) -> tuple:
    """(name, type, help, samples) exposition family for a DECLARED
    ldt_* series — the renderers build gauge/counter families through
    this so HELP/TYPE text has exactly one source."""
    mtype, help_text = METRICS[name]
    return (name, mtype, help_text, samples)

# Log-scaled (base-2) latency bucket upper bounds in milliseconds:
# 0.05ms .. ~105s. One fixed ladder for every latency series keeps the
# exposition predictable and cross-stage comparisons trivial.
BUCKET_EDGES_MS = tuple(0.05 * 2 ** k for k in range(22))


class Histogram:
    """Thread-safe fixed-bucket latency histogram.

    Cumulative-bucket semantics match Prometheus: bucket i counts
    observations <= BUCKET_EDGES_MS[i] when rendered (counts are stored
    per-bucket and cumulated at render/percentile time, so observe()
    stays one bisect + two adds under the lock)."""

    __slots__ = ("edges", "counts", "sum", "count", "max", "_lock")

    def __init__(self, edges=BUCKET_EDGES_MS):
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.max = 0.0
        self._lock = make_lock("telemetry.histogram")

    def observe(self, value_ms: float):
        i = bisect_left(self.edges, value_ms)
        with self._lock:
            self.counts[i] += 1
            self.sum += value_ms
            self.count += 1
            if value_ms > self.max:
                self.max = value_ms

    def snapshot(self):
        """(per-bucket counts, sum, count, max) under one lock."""
        with self._lock:
            return list(self.counts), self.sum, self.count, self.max

    def percentile(self, q: float):
        """Approximate q-th percentile (q in [0, 100]) by linear
        interpolation inside the holding bucket; the +Inf bucket answers
        the observed max. None when empty."""
        counts, _, total, vmax = self.snapshot()
        if total == 0:
            return None
        target = total * q / 100.0
        cum = 0
        lo = 0.0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c > 0:
                if i >= len(self.edges):
                    return vmax
                hi = min(self.edges[i], vmax) if vmax > 0 else \
                    self.edges[i]
                if hi < lo:
                    hi = self.edges[i]
                frac = (target - (cum - c)) / c
                return lo + (hi - lo) * frac
            if i < len(self.edges):
                lo = self.edges[i]
        return vmax


class Trace:
    """One request's span recorder.

    Spans are (name, depth, start, end) tuples of monotonic seconds —
    recorded with a single list append (GIL-atomic, so flush workers on
    other threads may add() into a request's trace concurrently).
    Parent/child structure is carried by `depth` plus time order; the
    tree is reconstructed at render time, never maintained on the hot
    path."""

    __slots__ = ("t0", "t_wall", "spans", "deadline", "no_retry",
                 "tenant", "request_id", "finished")

    def __init__(self):
        self.t0 = _mono()
        self.t_wall = time.time()
        self.spans: list = []
        # admission-control freight riding the existing trace plumbing
        # (service/admission.py): the request's Deadline, whether
        # the engine should resolve gate failures scalar instead of
        # running the pipelined retry lane (brownout / near-deadline),
        # and the tenant identity for fair-queueing at dequeue
        self.deadline = None
        self.no_retry = False
        self.tenant = None
        # end-to-end correlation id (X-LDT-Request-Id / UDS v2 ext /
        # shm slot header): stamped by the front, echoed on the
        # response, carried into slow traces and flight-recorder
        # request events so /tracez can join one document's journey
        # across processes
        self.request_id = None
        # completion latch: finish_request() is the single
        # authoritative completion path and flips this exactly once,
        # so telemetry, capture, and SLO can never double-count a
        # request whose handler unwinds through two finish sites
        # (e.g. a 504-after-shed)
        self.finished = False

    def add(self, name: str, t0: float, t1: float, depth: int = 0):
        self.spans.append((name, depth, t0, t1))

    def graft(self, other: "Trace", depth: int = 1):
        """Adopt another trace's spans (a batch flush shared by several
        requests) as children at `depth` — called once per request per
        flush, off the per-event path."""
        self.spans.extend((n, d + depth, s, e)
                          for n, d, s, e in other.spans)

    def adopt_constraints(self, traces):
        """Flush-scoped traces inherit the TIGHTEST deadline and any
        no-retry flag of the request traces batched into them — the
        engine scheduler reads constraints off the one trace it is
        handed (both batchers call this when building a flush)."""
        for tr in traces:
            if tr is None:
                continue
            dl = tr.deadline
            if dl is not None and (self.deadline is None or
                                   dl.t_end < self.deadline.t_end):
                self.deadline = dl
            if tr.no_retry:
                self.no_retry = True

    def total_ms(self) -> float:
        return (_mono() - self.t0) * 1e3

    def span_ms(self, name: str) -> float:
        """Total milliseconds across spans with this name (a request can
        record several dispatch spans)."""
        return sum((e - s) for n, _, s, e in self.spans if n == name) \
            * 1e3

    def to_dict(self, total_ms: float | None = None,
                meta: dict | None = None) -> dict:
        base = self.t0
        spans = sorted(self.spans, key=lambda sp: (sp[2], sp[1]))
        out = {
            "ts": self.t_wall,
            "total_ms": round(self.total_ms()
                              if total_ms is None else total_ms, 3),
            "meta": meta or {},
            "spans": [{"name": n, "depth": d,
                       "start_ms": round((s - base) * 1e3, 3),
                       "dur_ms": round((e - s) * 1e3, 3)}
                      for n, d, s, e in spans],
        }
        if self.request_id is not None:
            out["request_id"] = self.request_id
        return out


class CompileTracker:
    """First-execution detection for jitted entry points: one padded
    wire shape per dispatch lane counts exactly once. The engine keys on
    (lane, mesh size, wire array shapes) — the same signature XLA's jit
    cache keys on (dtypes are fixed), so a fresh key means the dispatch
    about to run pays a trace + compile."""

    def __init__(self):
        self._seen: set = set()
        self._lock = make_lock("telemetry.compiles")

    def first_seen(self, lane: str, key) -> bool:
        k = (lane, key)
        with self._lock:
            if k in self._seen:
                return False
            self._seen.add(k)
            return True

    def __len__(self):
        with self._lock:
            return len(self._seen)

    def clear(self):
        with self._lock:
            self._seen.clear()


class SlowTraceRing:
    """Bounded ring of span trees for requests over the threshold.

    Off by default: LDT_SLOW_TRACE_MS unset/0 means maybe_record is a
    single float compare. The deque's maxlen IS the eviction policy —
    the newest `capacity` slow traces win."""

    def __init__(self, capacity: int | None = None,
                 threshold_ms: float | None = None):
        if capacity is None:
            capacity = knobs.get_int("LDT_SLOW_TRACE_RING") or 64
        if threshold_ms is None:
            threshold_ms = knobs.get_float("LDT_SLOW_TRACE_MS") or 0.0
        self.capacity = max(capacity, 1)
        self.threshold_ms = threshold_ms
        self.recorded = 0  # total ever recorded (evictions included)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = make_lock("telemetry.slow_ring")

    def maybe_record(self, trace: Trace, total_ms: float,
                     meta: dict | None = None) -> bool:
        if self.threshold_ms <= 0 or total_ms < self.threshold_ms:
            return False
        self.record(trace, total_ms, meta=meta)
        return True

    def record(self, trace: Trace, total_ms: float,
               meta: dict | None = None) -> None:
        """Unconditional record — the error-capture path (5xx answers
        keep their span tree regardless of the sampling threshold)."""
        d = trace.to_dict(total_ms=total_ms, meta=meta)
        with self._lock:
            self._ring.append(d)
            self.recorded += 1

    def snapshot(self) -> list:
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self.recorded = 0


# -- Prometheus exposition rendering ----------------------------------------


def escape_label_value(v) -> str:
    """Label-value escaping per the exposition format: backslash, double
    quote, and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def render_exposition(families) -> str:
    """families: iterable of (name, type, help, samples); each sample is
    (series_name, labels dict | None, value). Emits `# HELP` + `# TYPE`
    for every family and escapes every label value — the whole /metrics
    body passes a strict exposition parser
    (tests/test_telemetry.py::test_metrics_exposition_lint)."""
    lines: list = []
    for name, mtype, help_text, samples in families:
        lines.append(f"# HELP {name} {_escape_help(help_text)}")
        lines.append(f"# TYPE {name} {mtype}")
        for series, labels, value in samples:
            lines.append(f"{series}{_fmt_labels(labels)} "
                         f"{_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def histogram_family(name: str, help_text: str, labeled_hists) -> tuple:
    """One histogram family from {labels-tuple: Histogram}: cumulative
    `_bucket` series (le as the LAST label), `_sum`, `_count`."""
    samples: list = []
    for label_items, hist in sorted(labeled_hists.items()):
        base = dict(label_items)
        counts, total_sum, total, _ = hist.snapshot()
        cum = 0
        for i, edge in enumerate(hist.edges):
            cum += counts[i]
            samples.append((f"{name}_bucket",
                            {**base, "le": repr(float(edge))}, cum))
        cum += counts[len(hist.edges)]
        samples.append((f"{name}_bucket", {**base, "le": "+Inf"}, cum))
        samples.append((f"{name}_sum", base or None,
                        round(total_sum, 6)))
        samples.append((f"{name}_count", base or None, total))
    return (name, "histogram", help_text, samples)


# -- registry ---------------------------------------------------------------


class TelemetryRegistry:
    """Histograms + counters keyed (name, sorted label items), plus the
    compile tracker and the slow-trace ring. Shared process-wide (module
    REGISTRY below); reset() clears in place so every holder of the
    reference sees the fresh state (tests)."""

    def __init__(self):
        self._lock = make_lock("telemetry.registry")
        self._hists: dict = {}     # (name, label items) -> Histogram
        self._counters: dict = {}  # (name, label items) -> number
        self.compiles = CompileTracker()
        self.slow = SlowTraceRing()

    @staticmethod
    def _key(name: str, labels: dict):
        return name, tuple(sorted(labels.items()))

    def histogram(self, name: str, **labels) -> Histogram:
        k = self._key(name, labels)
        # ldt-lint: disable=lock-discipline -- benign racy fast path: dict.get on a grow-only map; a miss falls through to the locked setdefault below
        h = self._hists.get(k)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(k, Histogram())
        return h

    def histogram_peek(self, name: str, **labels) -> "Histogram | None":
        """Read-only lookup: None instead of creating — load estimators
        (admission.expected_flush_ms) poll stages that may never run on
        this front, and each poll must not mint an empty series into
        the exposition."""
        return self._hists.get(self._key(name, labels))  # ldt-lint: disable=lock-discipline -- benign racy read of a grow-only map; a stale None only delays one estimator poll

    def counter_inc(self, name: str, amount=1, **labels):
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + amount

    def counter_value(self, name: str, **labels):
        with self._lock:
            return self._counters.get(self._key(name, labels), 0)

    def families(self) -> list:
        """Exposition families for everything in the registry."""
        with self._lock:
            hists = dict(self._hists)
            counters = dict(self._counters)
        fams: list = []
        by_name: dict = {}
        for (name, litems), h in hists.items():
            by_name.setdefault(name, {})[litems] = h
        for name in sorted(by_name):
            fams.append(histogram_family(
                name, metric_help(name), by_name[name]))
        cnt_by_name: dict = {}
        for (name, litems), v in counters.items():
            cnt_by_name.setdefault(name, []).append((litems, v))
        for name in sorted(cnt_by_name):
            samples = [(name, dict(litems) or None, v)
                       for litems, v in sorted(cnt_by_name[name])]
            fams.append((name, "counter", metric_help(name), samples))
        return fams

    def stage_percentiles(self) -> dict:
        """{stage: {count, p50, p95, p99, mean}} over the
        ldt_stage_latency_ms histograms — bench.py's per-stage report
        and /debug/vars both read this."""
        with self._lock:
            hists = {litems: h for (name, litems), h
                     in self._hists.items()
                     if name == "ldt_stage_latency_ms"}
        out: dict = {}
        for litems, h in hists.items():
            stage = dict(litems).get("stage", "?")
            _, total_sum, total, _ = h.snapshot()
            if not total:
                continue
            out[stage] = {
                "count": total,
                "mean": round(total_sum / total, 3),
                "p50": round(h.percentile(50), 3),
                "p95": round(h.percentile(95), 3),
                "p99": round(h.percentile(99), 3),
            }
        return out

    def compile_counts(self) -> dict:
        """{lane: count} view of ldt_xla_compiles_total."""
        with self._lock:
            items = [(dict(litems).get("lane", "?"), v)
                     for (name, litems), v in self._counters.items()
                     if name == "ldt_xla_compiles_total"]
        return dict(items)

    def reset(self):
        """Clear in place (module REGISTRY is shared by reference)."""
        with self._lock:
            self._hists.clear()
            self._counters.clear()
        self.compiles.clear()
        self.slow.clear()
        # re-read env knobs so tests that monkeypatch them take effect
        self.slow.__init__()


REGISTRY = TelemetryRegistry()


def observe_stage(stage: str, t0: float, t1: float | None = None,
                  trace: Trace | None = None, depth: int = 0) -> float:
    """Record one pipeline stage: observe its latency histogram and,
    when a trace rides along, append the span. Returns t1 so callers can
    chain stages without re-reading the clock."""
    if t1 is None:
        t1 = _mono()
    REGISTRY.histogram("ldt_stage_latency_ms", stage=stage) \
        .observe((t1 - t0) * 1e3)
    if trace is not None:
        trace.add(stage, t0, t1, depth)
    return t1


def finish_request(trace: Trace, meta: dict | None = None) -> float:
    """End-of-request hook for both fronts and every ingest lane:
    total latency into the request histogram, span tree into the slow
    ring when over threshold — or unconditionally, tagged
    reason:error, when the request answered 5xx (a failing request's
    trace is exactly the one an operator needs, and sampling only
    slow-but-successful requests would discard it). Also stamps the
    request id into the meta and emits the flight-recorder
    request_end event, then feeds the capture plane and SLO engine —
    this is the single authoritative completion path, and the trace's
    `finished` latch makes it idempotent: a handler that unwinds
    through two finish sites (504-after-shed) counts exactly once in
    telemetry, capture, and SLO alike. Returns total ms."""
    total = trace.total_ms()
    if getattr(trace, "finished", False):
        return total
    trace.finished = True
    REGISTRY.histogram("ldt_request_latency_ms").observe(total)
    if meta is not None and trace.request_id is not None:
        meta.setdefault("request_id", trace.request_id)
    status = (meta or {}).get("status")
    from . import flightrec
    if isinstance(status, int) and status >= 500:
        err_meta = dict(meta or {})
        err_meta["reason"] = "error"
        REGISTRY.slow.record(trace, total, meta=err_meta)
        REGISTRY.counter_inc("ldt_error_traces_total")
        flightrec.emit_event("slow_trace", request_id=trace.request_id,
                             total_ms=round(total, 3), reason="error")
    elif REGISTRY.slow.maybe_record(trace, total, meta=meta):
        flightrec.emit_event("slow_trace", request_id=trace.request_id,
                             total_ms=round(total, 3),
                             reason="threshold")
    flightrec.emit_event("request_end",
                         request_id=trace.request_id,
                         status=status,
                         total_ms=round(total, 3),
                         **({"front": meta["front"]}
                            if meta and "front" in meta else {}))
    # capture plane + SLO engine ride the same completion edge (both
    # are a single None check when their knob is unset); lazy imports
    # keep module-load order acyclic
    from . import capture as _capture
    from . import slo as _slo
    _capture.observe(trace, meta, total)
    _slo.observe(trace, meta, total)
    # a config probation, if one is in flight, advances on the same
    # edge (one module-attribute check when no plane exists)
    from . import configplane as _configplane
    _configplane.maybe_tick()
    return total


# -- /debug/vars ------------------------------------------------------------


def _rss_bytes() -> int:
    """Current RSS from /proc (Linux); ru_maxrss (peak) as fallback."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource
            return resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # noqa: BLE001 - best-effort gauge
            return 0


def debug_vars(metrics=None) -> dict:
    """statusz-style process snapshot: engine stats, cache stats,
    request counters, process uptime/RSS, stage percentiles, compile
    counts, slow-ring occupancy. One serializer shared by both fronts'
    GET /debug/vars."""
    d: dict = {
        "pid": os.getpid(),
        "uptime_sec": round(time.time() - _PROCESS_START, 3),
        "rss_bytes": _rss_bytes(),
    }
    if metrics is not None:
        with metrics._lock:
            d["counters"] = dict(metrics.counters)
            d["objects"] = dict(metrics.objects)
            d["languages"] = dict(metrics.languages)
        d["engine"] = dict(metrics.engine_stats() or {})
        d["cache"] = metrics.cache_stats()
        adm_fn = getattr(metrics, "admission_stats", None)
        if adm_fn is not None:
            adm = adm_fn()
            if adm:
                d["admission"] = adm
        ready_fn = getattr(metrics, "readiness", None)
        if ready_fn is not None:
            r = ready_fn()
            if r is not None:
                d["ready"] = r
        pool_fn = getattr(metrics, "pool_stats", None)
        if pool_fn is not None:
            p = pool_fn()
            if p:
                d["pool"] = p
        pipeline_fn = getattr(metrics, "pipeline_stats", None)
        if pipeline_fn is not None:
            pl = pipeline_fn()
            if pl:
                d["pipeline"] = pl
        shm_fn = getattr(metrics, "shm_stats", None)
        if shm_fn is not None:
            sh = shm_fn()
            if sh:
                d["shm"] = sh
        quar_fn = getattr(metrics, "quarantine_stats", None)
        if quar_fn is not None:
            qs = quar_fn()
            if qs:
                d["quarantine"] = qs
        shc_fn = getattr(metrics, "shared_cache_stats", None)
        if shc_fn is not None:
            sc = shc_fn()
            if sc:
                d["shared_cache"] = sc
        slo_fn = getattr(metrics, "slo_stats", None)
        if slo_fn is not None:
            sl = slo_fn()
            if sl:
                d["slo"] = sl
        cap_fn = getattr(metrics, "capture_stats", None)
        if cap_fn is not None:
            cp = cap_fn()
            if cp:
                d["capture"] = cp
    rh = REGISTRY.histogram("ldt_request_latency_ms")
    _, rsum, rcount, rmax = rh.snapshot()
    d["requests"] = {"count": rcount,
                     "mean_ms": round(rsum / rcount, 3) if rcount else 0,
                     "max_ms": round(rmax, 3),
                     "p95_ms": round(rh.percentile(95) or 0, 3)}
    d["stage_latency_ms"] = REGISTRY.stage_percentiles()
    d["xla_compiles"] = REGISTRY.compile_counts()
    d["slow_traces"] = {"threshold_ms": REGISTRY.slow.threshold_ms,
                        "capacity": REGISTRY.slow.capacity,
                        "recorded": REGISTRY.slow.recorded,
                        "held": len(REGISTRY.slow.snapshot())}
    from . import flightrec
    fr = flightrec.stats()
    if fr is not None:
        d["flightrec"] = fr
    # effective runtime config: generation + per-process mutable-knob
    # values, so a /configz rollback is observable after the fact
    # (rendered even before any apply — the fleet's health scrape
    # reads the generation off every member unconditionally)
    from . import configplane
    cfg = configplane.stats()
    if cfg is None:
        cfg = {"state": "idle", "generation": 0,
               "values": {k.name: knobs.value(k.name)
                          for k in knobs.mutable_knobs()}}
    d["config"] = cfg
    return d
