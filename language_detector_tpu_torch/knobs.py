"""Central registry of environment knobs — the only legal way to read
env configuration inside the package.

Every knob the port's serving stack honors is declared here once, with
its name, type, default, and documentation; it is the port's copy of
language_detector_tpu/knobs.py, holding only the knobs the port reads,
each described as the port uses it. Call sites read through the typed
accessors (get_int / get_float / get_str / get_bool / get_levels), and
reading an undeclared name raises.

Semantics (shared by every knob, formerly re-implemented per file):

  - unset or blank -> the declared default (None for off-by-default
    bounds);
  - a mistyped value logs a loud warning and falls back to the default
    instead of silently disabling the guard the operator thinks is
    active (the rule service/recycle.py established);
  - `bound=True` knobs treat non-positive values as "feature off"
    (returns None), matching the admission/recycle bound contract.

Values are read from the environment at every call (no import-time
caching) so tests that monkeypatch a knob and re-init a component see
the change.

Knobs declared `mutable=True` form the runtime config plane's settable
surface: POST /configz stages a validated override batch
(apply_overrides) that the accessors consult before the environment,
and `current()` returns a versioned snapshot of the whole mutable
surface. Mutable knobs must therefore be read at use time, never
cached at import.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

_log = logging.getLogger(__name__)

_FALSE_WORDS = frozenset(("", "0", "false", "no", "off"))


@dataclass(frozen=True)
class Knob:
    """One declared environment knob."""

    name: str
    ktype: str              # "int" | "float" | "str" | "bool" | "levels"
    default: object         # typed default (None = off / not set)
    doc: str
    bound: bool = field(default=False)   # <= 0 means "off" -> None
    mutable: bool = field(default=False)  # runtime-settable through the
    # config plane (POST /configz -> apply_overrides); mutable knobs
    # must be read at use time, never cached at import
    mrange: tuple | None = field(default=None)  # (lo, hi) inclusive
    # bounds a runtime override must satisfy


def _k(name: str, ktype: str, default: object, doc: str,
       bound: bool = False, mutable: bool = False,
       mrange: tuple | None = None) -> Knob:
    return Knob(name, ktype, default, doc, bound, mutable, mrange)


_DECLARATIONS: tuple[Knob, ...] = (
    # -- telemetry (telemetry.py) -------------------------------------
    _k("LDT_SLOW_TRACE_MS", "float", 0.0,
       "Slow-request sampler threshold in ms; requests over it record "
       "their full span tree into the /debug/slow ring. 0/unset = off."),
    _k("LDT_SLOW_TRACE_RING", "int", 64,
       "Capacity of the slow-trace ring (newest traces win)."),
    # -- result cache (service/batcher.py wiring) ---------------------
    _k("LDT_RESULT_CACHE_MB", "float", 0.0,
       "Batcher result-cache budget in MB; 0/unset disables the cache."),
    # -- worker self-recycle (service/recycle.py) ---------------------
    _k("LDT_MAX_DISPATCHES", "int", None,
       "Recycle the worker after this many device dispatches "
       "(ldt_device_dispatches_total; all-C tiny flushes do not "
       "count).",
       bound=True),
    _k("LDT_MAX_RSS_MB", "float", None,
       "Recycle the worker when process RSS exceeds this many MB.",
       bound=True),
    _k("LDT_RECYCLE_CHECK_SEC", "float", 5.0,
       "Recycle-watcher poll period in seconds (floor 0.05)."),
    _k("LDT_RECYCLE_DRAIN_SEC", "float", 5.0,
       "Bounded window for in-flight handlers to finish their response "
       "during a planned recycle before their sockets are aborted."),
    # -- admission control (service/admission.py) ---------------------
    _k("LDT_MAX_QUEUE_DOCS", "int", None,
       "Admission bound: max documents admitted and not yet completed; "
       "past it requests shed with 429.", bound=True,
       mutable=True, mrange=(1, 1_000_000)),
    _k("LDT_MAX_QUEUE_BYTES", "int", None,
       "Admission bound: max byte-weighted cost (4 bytes per estimated "
       "packer slot) held at once.", bound=True,
       mutable=True, mrange=(1, 1 << 31)),
    _k("LDT_MAX_INFLIGHT", "int", None,
       "Admission bound: max HTTP requests in flight.", bound=True,
       mutable=True, mrange=(1, 65536)),
    _k("LDT_DEFAULT_DEADLINE_MS", "float", None,
       "Default request deadline when X-LDT-Deadline-Ms is absent; "
       "expired work is dropped at dequeue (504).", bound=True,
       mutable=True, mrange=(1.0, 600_000.0)),
    _k("LDT_BROWNOUT_ALPHA", "float", 0.3,
       "EWMA smoothing factor for the brownout ladder's load signal.",
       mutable=True, mrange=(0.01, 1.0)),
    _k("LDT_BROWNOUT_ENTER", "levels", (0.60, 0.80, 0.95),
       "Comma-separated occupancy thresholds to ENTER brownout levels "
       "1..3."),
    _k("LDT_BROWNOUT_EXIT", "levels", (0.45, 0.65, 0.80),
       "Comma-separated occupancy thresholds to EXIT brownout levels "
       "1..3 (must sit below the enter thresholds: hysteresis)."),
    _k("LDT_BROWNOUT_P95_MS", "float", None,
       "Optional latency target: flush p95 over this feeds the "
       "brownout load signal.", bound=True),
    _k("LDT_BREAKER_FAILURES", "int", 5,
       "Consecutive device-flush failures that trip the circuit "
       "breaker open."),
    _k("LDT_BREAKER_COOLDOWN_SEC", "float", 10.0,
       "Seconds an open breaker waits before admitting a half-open "
       "probe."),
    _k("LDT_BREAKER_STALL_FACTOR", "float", 10.0,
       "A flush slower than factor x compile-aware expected p95 counts "
       "as a breaker failure (stall watchdog)."),
    _k("LDT_BREAKER_STALL_MIN_MS", "float", 2000.0,
       "Floor of the stall watchdog threshold in ms."),
    # -- fault injection & flush timeout (faults.py, both fronts) -----
    _k("LDT_FAULTS", "str", None,
       "Fault-injection spec, comma-separated "
       "`point:action[:p=][:seed=][:once][:after=]` rules "
       "(docs/ROBUSTNESS.md). Unset = injection disabled (seams cost "
       "one attribute check)."),
    _k("LDT_FLUSH_TIMEOUT_SEC", "float", 60.0,
       "How long a handler waits on its flush future before answering "
       "504 (both fronts; formerly a hardcoded 60 s)."),
    # -- supervisor crash policy (service/supervisor.py) --------------
    _k("LDT_RESTART_ON_CRASH", "bool", False,
       "Supervisor restarts a crashed worker (any exit other than 0 / "
       "recycle) with exponential backoff instead of propagating the "
       "first crash."),
    _k("LDT_CRASH_BACKOFF_BASE_SEC", "float", 0.5,
       "First crash-restart backoff; doubles per consecutive crash "
       "(x0.5-1.5 jitter). The fleet uses it per member and as the "
       "retry delay after a failed spawn."),
    _k("LDT_CRASH_BACKOFF_MAX_SEC", "float", 30.0,
       "Ceiling of the crash-restart backoff."),
    _k("LDT_CRASH_LOOP_WINDOW_SEC", "float", 60.0,
       "Crash-loop window: this many seconds of crash history count "
       "toward the loop detector (the supervisor's, each fleet "
       "member's, and the fleet-wide crash circuit's)."),
    _k("LDT_CRASH_LOOP_MAX", "int", 5,
       "Crashes inside the window that declare a crash loop: the "
       "supervisor stops restarting and propagates the exit code; the "
       "fleet parks the member (and, counted fleet-wide, opens the "
       "crash circuit)."),
    _k("LDT_WORKER_GENERATION", "int", 0,
       "Set BY the supervisor on each spawned worker (1, 2, ...); "
       "exported as the ldt_worker_generation gauge. 0 = running "
       "unsupervised."),
    # -- fleet supervisor (service/fleet.py) --------------------------
    _k("LDT_FLEET_WORKERS", "int", 0,
       "Worker count for the fleet supervisor: N members share the "
       "listen port via SO_REUSEPORT, each with its own generation, "
       "ready handshake, and crash policy; on one card every member "
       "opens its own CUDA context and uploads its own tables. "
       "0/unset = classic single-worker supervisor."),
    _k("LDT_FLEET_MIN", "int", None,
       "Autoscale floor (defaults to LDT_FLEET_WORKERS): scale-down "
       "never drains below this many members.", bound=True),
    _k("LDT_FLEET_MAX", "int", None,
       "Autoscale ceiling (defaults to LDT_FLEET_WORKERS; equal "
       "min/max disables autoscaling).", bound=True),
    _k("LDT_FLEET_HEALTH_SEC", "float", 1.0,
       "Per-member health-scrape period: the fleet GETs each member's "
       "/debug/vars for readiness, queue depth, and brownout level."),
    _k("LDT_FLEET_DEGRADED_FAILS", "int", 3,
       "Consecutive failed health scrapes that mark a member DEGRADED "
       "(at 3x this the member is killed and respawned)."),
    _k("LDT_FLEET_SCALE_UP_DEPTH", "int", 64,
       "Sustained per-member admission queue depth (or brownout level "
       ">= 2) that scales the fleet up one member.",
       mutable=True, mrange=(1, 100_000)),
    _k("LDT_FLEET_SCALE_DOWN_DEPTH", "int", 0,
       "Queue depth at or below which (with no brownout) the fleet "
       "scales down one member via a zero-drop drain.",
       mutable=True, mrange=(0, 100_000)),
    _k("LDT_FLEET_SCALE_HOLD_SEC", "float", 10.0,
       "Hysteresis hold: the overload/idle condition must persist this "
       "long before one scale step fires (and the timer re-arms).",
       mutable=True, mrange=(0.1, 3600.0)),
    _k("LDT_FLEET_CIRCUIT_COOLDOWN_SEC", "float", 5.0,
       "Open fleet-circuit cooldown before one half-open probe member "
       "is spawned; its readiness closes the circuit."),
    _k("LDT_FLEET_STATUS_PORT", "int", 0,
       "Fleet control-plane HTTP port (127.0.0.1): GET /fleetz (JSON "
       "member table), /sloz, /tracez and /metrics (the fleet "
       "series), POST /configz (canary-then-fan-out config push). "
       "0 = off."),
    _k("LDT_FLEET_SLOT", "int", None,
       "Set BY the fleet supervisor on each member (0, 1, ...): its "
       "stable slot index, independent of generation numbers.",
       bound=True),
    # -- artifact & hot swap (supervisor + service/swap.py) -----------
    _k("LDT_ARTIFACT_PATH", "str", None,
       "Path to the .ldta scoring artifact to serve. Unset -> the "
       "packaged data/model.ldta. The supervisor rewrites it on each "
       "standby spawn during a swap drill."),
    _k("LDT_ARTIFACT_POINTER", "str", None,
       "Path to a one-line text file naming the current artifact. The "
       "supervisor (and the fleet's rolling swap) re-reads it on every "
       "SIGHUP swap drill, so an operator retargets a deployment by "
       "rewriting the pointer and signaling."),
    _k("LDT_SWAP_TIMEOUT_SEC", "float", 30.0,
       "How long the supervisor holds a standby worker waiting for its "
       "ready file before aborting the swap and keeping the old "
       "generation serving."),
    _k("LDT_READY_FILE", "str", None,
       "Set BY the supervisor on a standby worker: the front writes "
       "this file (JSON: generation/pid/ports/warmup_ms) once /readyz "
       "is true, signaling the supervisor to cut traffic over."),
    _k("LDT_SWAPPED", "bool", False,
       "Set BY the supervisor on a standby worker spawned for a swap "
       "drill; the front counts ldt_swap_total{result=ok} once it "
       "becomes ready, so the drill is visible on the new generation's "
       "/metrics."),
    _k("LDT_REUSEPORT", "bool", False,
       "Bind both fronts' listeners with SO_REUSEPORT so an old and a "
       "standby generation can overlap on the same port during a "
       "blue/green swap. Required (on the supervisor env) for "
       "zero-downtime SIGHUP drills on a fixed port."),
    # -- wire fast path & unix-socket lane (service/wire.py) ----------
    _k("LDT_UNIX_SOCKET", "str", None,
       "Filesystem path for the unix-domain-socket ingest lane on "
       "both fronts (length-prefixed frames, wire.py contract). "
       "Co-located callers skip HTTP parsing entirely; responses are "
       "byte-identical to the TCP front. Unset: no UDS listener."),
    _k("LDT_WIRE_FASTPATH", "bool", True,
       "Use the zero-copy request scanner for the strict common "
       "request shape (wire.fast_parse_texts); any deviation falls "
       "back to json.loads either way. Set 0 to force the json.loads "
       "path (parity debugging)."),
    _k("LDT_FRAME_READ_TIMEOUT_SEC", "float", 5.0,
       "Slow-loris guard for the UDS frame lane on both fronts: once "
       "the first byte of a frame arrives, the rest of the header and "
       "body must land within this budget or the connection is "
       "answered with a 408 error frame and closed (idle keep-alive "
       "between frames stays unbounded). 0 = off.", bound=True),
    # -- shared-memory ring ingest lane (service/shmring.py) ----------
    _k("LDT_SHM_DIR", "str", None,
       "Directory of mmap'd shared-memory ring files: the worker "
       "scans it and serves frames written by co-located RingClient "
       "processes in place (zero-copy twin of the UDS lane; the ring "
       "files are byte-compatible with the reference's, so either "
       "package's client can drive either package's server). Under "
       "the fleet supervisor each member gets its own m<slot>/ "
       "subdir. Unset: no shm lane."),
    _k("LDT_SHM_SLOTS", "int", 8,
       "Slots per ring a RingClient creates (max 63): the client's "
       "max in-flight frames on the shm lane."),
    _k("LDT_SHM_SLOT_BYTES", "int", 65536,
       "Payload capacity per ring slot in bytes (rounded up to the "
       "mmap allocation granularity so each slot maps page-aligned); "
       "bounds both request and response frame size on the shm lane."),
    _k("LDT_SHM_LEASE_TIMEOUT_SEC", "float", 2.0,
       "Crash-reclaim horizon for ring slots: a WRITING slot whose "
       "client died (or stalled) longer than this is reclaimed to "
       "FREE, and a DONE slot with a dead client is reclaimed after "
       "the same grace."),
    _k("LDT_SHM_SCAN_INTERVAL_MS", "float", 1.0,
       "Idle sleep of the shm scan thread between sweeps when no "
       "frame was handled; the worst-case added latency for a frame "
       "landing in an idle ring."),
    # -- startup warmup (service/server.py, service/swap.py) ----------
    _k("LDT_WARMUP", "bool", False,
       "Drive one 96-document flush through the device path at "
       "startup (the kernel library is already loaded with the "
       "engine) and gate /readyz on it finishing; the duration lands "
       "in the ldt_warmup_ms gauge."),
    # -- kernel library cache and bundle (ops/kernels.py, aot.py) -----
    _k("LDT_COMPILE_CACHE_DIR", "str", None,
       "Directory the fused-tote kernel library is built into by nvcc "
       "at first use and loaded from by later processes (unset: the "
       "checkout's build/torch_kernels/). The supervisor and the fleet "
       "hand every generation and member the same one. Created if "
       "missing."),
    _k("LDT_AOT_DIR", "str", None,
       "Directory of the kernel-library bundle (aot.py): one entry "
       "per kernel library, keyed on the table digest, torch and CUDA "
       "versions, device arch, kernel mode and kernel source. Engine "
       "init loads the library from its entry without a compiler, and "
       "writes back an entry it had to build. The supervisor and fleet "
       "default it to a shared per-supervisor dir so spawned and "
       "standby generations boot hot. Created (with a structured log) "
       "if missing. Unset under no supervisor = bundle off."),
    _k("LDT_AOT_REQUIRE", "bool", False,
       "Strict bundle mode: a missing, stale, or corrupt bundle entry "
       "raises AotError out of engine init instead of building the "
       "library with nvcc (deploy guard: a fleet that must boot hot "
       "fails loud when it cannot)."),
    # -- fleet-shared result cache (service/sharedcache.py) -----------
    _k("LDT_RESULT_CACHE_SHM_MB", "float", 0.0,
       "Budget in MB for the shm-backed fleet-shared result-cache "
       "tier (service/sharedcache.py): a fixed-slot open-addressed "
       "mmap table under LDT_SHM_DIR (or /dev/shm) that every "
       "SO_REUSEPORT fleet member reads and writes, so duplicate "
       "docs hit across workers; the file layout is the reference's, "
       "so both packages read each other's entries. 0/unset disables "
       "the shared tier (the per-worker LRU is unaffected). The tier "
       "rides the per-worker ResultCache, so LDT_RESULT_CACHE_MB must "
       "also be > 0 for it to see any traffic."),
    _k("LDT_SHARED_CACHE_FILE", "str", None,
       "Explicit path of the fleet-shared result-cache mmap file. "
       "Unset = <LDT_SHM_DIR or /dev/shm>/ldt-shared-cache.bin; the "
       "fleet pins a per-fleet path here because its members get "
       "per-slot LDT_SHM_DIR values and must still share ONE table."),
    # -- frame integrity (service/wire.py) ----------------------------
    _k("LDT_WIRE_CRC", "bool", False,
       "End-to-end frame payload CRC32 on the wire lanes: UDS v2 "
       "frames carry a CRC ext-flag + trailer word and shm slots "
       "carry a CRC header word; the server verifies before parsing "
       "and refuses a mismatched frame with a typed 400 instead of "
       "scoring flipped bytes (ldt_integrity_crc_total). Both sides "
       "of the shm lane must agree on this knob."),
    # -- dispatch pipeline & long-doc lane (models/ngram.py) ----------
    _k("LDT_PIPELINE_DEPTH", "int", 2,
       "Dispatch-pipeline depth of the engine's stream scheduler: at "
       "most depth+1 jobs (tier-lane slices, long-doc sub-packs, "
       "retry-lane bins) outstanding on the engine's CUDA streams while "
       "the main thread packs the next one, each job's wire copied "
       "from a pinned staging lease. 1 = strictly serial "
       "pack->score->epilogue, one job at a time; 2 (default) keeps "
       "jobs scoring while the next packs. Answers do not depend on "
       "it."),
    _k("LDT_LONGDOC_CHUNK_SLOTS", "int", 0,
       "Long-document lane sub-pack size: documents past 4096 "
       "estimated slots (the engine's LONGDOC_SPLIT_SLOTS) are cut at "
       "script-span boundaries into sub-documents of about this many "
       "slots, scored as ordinary packs and merged back into one "
       "summary; also the sub-document budget of the per-span path "
       "(detect_spans). 0 (default) disables the lane: oversized docs "
       "ride the long tier unsplit, and detect_spans splits at the "
       "scalar engine's SPAN_SPLIT_SLOTS. The reference defaults to "
       "1024; on an H100 the lane gives the same answers at about "
       "1.6x the time a call (the kernel gains nothing from the "
       "smaller wires), so the port leaves it off."),
    # -- device-pool scheduler (parallel/pool.py) ---------------------
    _k("LDT_POOL_LANES", "int", None,
       "Dispatch-lane count for the fault-tolerant device pool. On a "
       "mesh the devices partition into this many sub-meshes (one lane "
       "each); on CPU the lanes share the single scorer (simulated "
       "lanes for chaos tests). Unset/0 = no pool: dispatch takes "
       "exactly the direct single-lane path.", bound=True),
    _k("LDT_POOL_HEDGE_FACTOR", "float", 4.0,
       "Straggler hedge threshold: a fetch slower than factor x the "
       "lane's observed p95 latency re-dispatches the batch on another "
       "healthy lane (first result wins). 0 disables hedging."),
    _k("LDT_POOL_HEDGE_MIN_MS", "float", 500.0,
       "Floor of the hedge threshold in ms, so cold lanes with "
       "microsecond p95s don't hedge every warm launch."),
    _k("LDT_POOL_EVICT_FAILURES", "int", 3,
       "Consecutive fetch/dispatch failures that evict a lane from "
       "rotation (per-lane circuit breaker)."),
    _k("LDT_POOL_PROBE_COOLDOWN_SEC", "float", 5.0,
       "Seconds an evicted lane waits before it may carry a half-open "
       "probe batch; a successful probe re-admits the lane."),
    _k("LDT_POOL_MAX_REDISPATCH", "int", 8,
       "Failover budget per batch: how many lane attempts (initial + "
       "re-dispatches) before the error surfaces to the batch's "
       "futures."),
    # -- data-plane integrity (integrity.py) --------------------------
    _k("LDT_SCRUB_INTERVAL_SEC", "float", 0.0,
       "On-device table-scrub cadence for pooled engines: between "
       "flushes, each pool lane's device table planes fold to a "
       "digest on device and compare against the fingerprint recorded "
       "at upload; a mismatch (or a canary deviation) quarantines the "
       "lane CORRUPT, re-uploads fresh tables from the host mmap, and "
       "re-admits it through the half-open probe flow. 0 (default) "
       "disables scrubbing entirely — the epilogue hook is a single "
       "attribute test."),
    _k("LDT_CANARY_DOCS", "int", 8,
       "Golden-query canary pack size per scrub pass (first N of the "
       "pinned 8-doc pack, expected codes baked into model.ldta at "
       "pack time): each lane scores the pack and any code deviation "
       "quarantines the lane — catching compute faults a table digest "
       "can't see. 0 disables the canary (digest scrub still runs). "
       "Values past the pinned pack extend it with deterministic draws "
       "from the bundled eval corpus (evalsuite.py) and the gate "
       "becomes the LDT_CANARY_FLOOR agreement floor instead of "
       "exact-8 equality."),
    _k("LDT_CANARY_FLOOR", "float", 0.95,
       "Agreement floor for the statistical canary gate: when "
       "LDT_CANARY_DOCS extends past the pinned 8-doc pack, a scrub "
       "pass quarantines the lane when the fraction of canary docs "
       "matching their expected codes drops below this (the pinned "
       "core 8 still require exact equality — any deviation there is "
       "a quarantine regardless of the floor)."),
    # -- accuracy plane (models/ngram.py, both fronts) ----------------
    _k("LDT_SPANS", "bool", False,
       "Per-span language output: detector results carry a spans list "
       "[(byte_offset, byte_len, code, pct, reliable)] tiling the "
       "document (script-span-aligned, engine detect_spans), the HTTP "
       "front adds a per-item \"spans\" JSON field, and UDS v2 frames "
       "honor the FRAME_SPANS ext flag. Off (default): responses and "
       "every device program are byte-identical to the pre-span "
       "stack."),
    _k("LDT_HINTS", "bool", False,
       "Hint priors in the device reduction: hinted batches carry "
       "per-doc dense prior vectors (hints.prior_vector — the boost "
       "algebra's qprob deltas) that the scorer adds to languages a "
       "chunk already observed, post-whack and before the top-2 "
       "select, in the fused-tote kernel and its plain version. Equal "
       "to the reference engine's (tests/test_torch_hints.py); off "
       "(default) the "
       "wire carries no prior keys and hint-off results stay "
       "byte-identical."),
    # -- per-tenant isolation (service/admission.py) ------------------
    _k("LDT_TENANT_QUOTA_DOCS", "int", None,
       "Per-tenant cap on queued documents (X-LDT-Tenant header; "
       "absent header = tenant \"default\"); over it the tenant sheds "
       "429 tenant_docs while other tenants keep admitting.",
       bound=True, mutable=True, mrange=(1, 1_000_000)),
    _k("LDT_TENANT_QUOTA_BYTES", "int", None,
       "Per-tenant cap on queued byte-weighted cost (same accounting "
       "as LDT_MAX_QUEUE_BYTES); over it the tenant sheds 429 "
       "tenant_bytes.", bound=True, mutable=True, mrange=(1, 1 << 31)),
    _k("LDT_TENANT_WEIGHTS", "str", None,
       "Deficit-weighted fair queueing weights as "
       "\"tenantA=4,tenantB=1\" (unlisted tenants weigh 1). Setting it "
       "turns on DRR dequeue in both fronts' batchers; unset keeps "
       "strict FIFO."),
    _k("LDT_WFQ_QUANTUM_BYTES", "int", 65536,
       "DRR quantum: bytes of queued cost a weight-1 tenant may "
       "dequeue per scheduler round."),
    # -- flight recorder & device profiling (flightrec.py) ------------
    _k("LDT_FLIGHTREC_DIR", "str", None,
       "Directory for the crash-safe flight recorder: each process "
       "writes flightrec-<pid>.ring there (mmap'd bounded event ring, "
       "readable after SIGKILL; see docs/OBSERVABILITY.md). The fleet "
       "supervisor harvests a dead member's ring into a postmortem on "
       "/fleetz. Unset: recorder off, every emit is one None check."),
    _k("LDT_FLIGHTREC_SLOTS", "int", 256,
       "Event slots per flight-recorder ring (newest events win; the "
       "total committed count survives eviction)."),
    _k("LDT_FLIGHTREC_SLOT_BYTES", "int", 512,
       "Bytes per flight-recorder slot including the 16-byte header; "
       "an event whose JSON payload exceeds the slot is dropped and "
       "counted in ldt_flightrec_dropped_total."),
    _k("LDT_PROFILE_DIR", "str", None,
       "Output directory for on-demand device-profiler captures "
       "(POST /profilez or SIGUSR2 arms torch.profiler for a bounded "
       "window, written as a Chrome trace). Unset: /profilez answers "
       "503 profiling_disabled."),
    _k("LDT_PROFILE_WINDOW_SEC", "float", 5.0,
       "Capture window for an on-demand profile: the trace stops "
       "itself this many seconds after it was armed.", bound=True),
    # -- traffic capture & SLO engine (capture.py, slo.py) ------------
    _k("LDT_CAPTURE_DIR", "str", None,
       "Directory for the traffic-capture plane: each front writes "
       "one fixed-width anonymized record per completed request into "
       "capture-<pid>.ring (mmap'd, commit-word-published, readable "
       "after SIGKILL), sealing full rings into segment-*.cap files. "
       "The fleet gives each member its own m<slot>/ subdirectory. "
       "bench.py --replay re-drives a capture; see "
       "docs/OBSERVABILITY.md. Unset: capture off, zero-cost."),
    _k("LDT_CAPTURE_SAMPLE", "float", 1.0,
       "Fraction of completed requests recorded by the capture plane "
       "(probabilistic per-request sampling; 1.0 keeps everything, "
       "0.01 keeps ~1%)."),
    _k("LDT_CAPTURE_RING_RECORDS", "int", 4096,
       "Records per capture ring before it is sealed into an "
       "immutable segment file and restarted."),
    _k("LDT_CAPTURE_MAX_SEGMENTS", "int", 64,
       "Sealed capture segments kept per writer; the oldest are "
       "unlinked first, bounding on-disk capture size."),
    _k("LDT_SLO", "str", None,
       "SLO spec armed at front startup, e.g. "
       "'p99_ms=50,err_pct=0.5,window_sec=300': latency-percentile "
       "target, error-budget percentage, and fast-window seconds "
       "(the slow window is 12x). Drives per-tenant + fleet SLIs, "
       "multi-window burn rates, /sloz, and slo_breach / "
       "slo_recovered flight-recorder events. Unset: SLO engine off."),
    _k("LDT_SLO_MIN_EVENTS", "int", 4,
       "Minimum fast-window events before a burn-rate breach may "
       "fire; suppresses alerts on near-idle traffic."),
    # -- runtime config plane (configplane.py) ------------------------
    _k("LDT_CONFIG_PROBATION_SEC", "float", 10.0,
       "Default probation window for a POST /configz apply: the new "
       "config serves under SLO watch this long; a fast-window burn "
       "rate >= 1.0 inside the window auto-rolls the apply back "
       "(configplane.py). A per-request probation_sec overrides it; "
       "0 commits immediately (the fleet's fan-out of an already-"
       "proven config)."),
    # -- debug / CI ---------------------------------------------------
    _k("LDT_LOCK_DEBUG", "bool", False,
       "Build order-checking debug locks (locks.py): records lock "
       "acquisition order and raises on inversion or self-deadlock."),
    # -- service ports (reference contract, main.go:91-116) -----------
    _k("LISTEN_PORT", "int", 3000,
       "HTTP service port for both fronts."),
    _k("PROMETHEUS_PORT", "int", 30000,
       "Metrics/debug HTTP port for both fronts."),
    # -- multi-host launch contract (parallel/distributed.py) ---------
    # the reference's names, kept so deployments keep their
    # configuration; here they set up torch.distributed's control plane
    _k("JAX_COORDINATOR_ADDRESS", "str", None,
       "Coordinator address (host:port) of a multi-process run; "
       "process 0 listens there (torch.distributed over tcp://)."),
    _k("JAX_NUM_PROCESSES", "int", None,
       "Total process count of a multi-process run."),
    _k("JAX_PROCESS_ID", "int", None,
       "This process's index (rank) in a multi-process run."),
    # -- CUDA toolkit --------------------------------------------------
    _k("CUDA_HOME", "str", None,
       "CUDA toolkit root whose bin/nvcc builds the fused-tote kernel "
       "library (unset or empty: /usr/local/cuda, then nvcc on PATH)."),
    # -- offline tools (tools/) ----------------------------------------
    _k("LDT_REFERENCE_DIR", "str", None,
       "Root of a CLD2 source snapshot (holding cld2/internal/"
       "unittest_data.h). The offline tools read its golden suite: the "
       "evaluator's default corpus and the soak's fuzz texts. Unset or "
       "absent: no golden suite (the soak builds its texts from the "
       "bench corpus)."),
)

KNOBS: dict[str, Knob] = {k.name: k for k in _DECLARATIONS}

# Runtime overrides for MUTABLE knobs, applied by the config plane
# (configplane.apply -> apply_overrides). Stored as raw env-style
# strings so every override rides the exact same parse / bound
# semantics as an environment value. _VERSION bumps on every change so
# components that cache derived state (AdmissionController) can detect
# staleness with one int compare per call.
_OVERRIDES: dict[str, str] = {}
_VERSION: int = 0


def raw(name: str) -> str | None:
    """The registry's single environment touch: the raw string value of
    a DECLARED knob, or None when unset. Reading an undeclared name is
    a programming error (declare it above). Mutable knobs consult the
    runtime override map first, so an applied /configz change is live
    for every accessor without re-exec."""
    knob = KNOBS.get(name)
    if knob is None:
        raise KeyError(f"undeclared env knob {name!r}; declare it in "
                       "language_detector_tpu_torch/knobs.py")
    if knob.mutable and name in _OVERRIDES:
        return _OVERRIDES[name]
    return os.environ.get(name)


def is_set(name: str) -> bool:
    """True when the knob has a non-blank value in the environment."""
    v = raw(name)
    return v is not None and v != ""


def _parse_scalar(knob: Knob, v: str) -> object:
    if knob.ktype == "int":
        # accept "8e3"-style floats the way the old per-file parsers
        # accepted them for byte/MB counts
        return int(v) if v.lstrip("+-").isdigit() else int(float(v))
    if knob.ktype == "float":
        return float(v)
    return v


def value(name: str) -> object:
    """Typed value of a declared knob, applying the shared default /
    mistype / bound semantics. Prefer the typed get_* accessors at call
    sites."""
    knob = KNOBS[name]
    v = raw(name)
    if knob.ktype == "bool":
        if v is None:
            return bool(knob.default)
        return v.strip().lower() not in _FALSE_WORDS
    if v in (None, ""):
        return knob.default
    if knob.ktype == "levels":
        try:
            parts = tuple(float(x) for x in v.split(","))
        except ValueError:
            parts = ()
        if len(parts) != len(knob.default):  # type: ignore[arg-type]
            _log.warning(
                "%s=%r must be %d comma-separated numbers — using %r",
                name, v, len(knob.default),  # type: ignore[arg-type]
                knob.default)
            return knob.default
        return parts
    if knob.ktype == "str":
        return v
    try:
        n = _parse_scalar(knob, v)
    except ValueError:
        _log.warning("%s=%r is not a valid %s — using default %r",
                     name, v, knob.ktype, knob.default)
        return knob.default
    if knob.bound and n <= 0:  # type: ignore[operator]
        return None  # non-positive bound = feature off
    return n


def get_int(name: str) -> int | None:
    knob = KNOBS[name]
    assert knob.ktype == "int", f"{name} is {knob.ktype}, not int"
    v = value(name)
    return None if v is None else int(v)  # type: ignore[call-overload]


def get_float(name: str) -> float | None:
    knob = KNOBS[name]
    assert knob.ktype == "float", f"{name} is {knob.ktype}, not float"
    v = value(name)
    return None if v is None else float(v)  # type: ignore[arg-type]


def get_str(name: str) -> str | None:
    knob = KNOBS[name]
    assert knob.ktype == "str", f"{name} is {knob.ktype}, not str"
    v = value(name)
    return None if v is None else str(v)


def get_bool(name: str) -> bool:
    knob = KNOBS[name]
    assert knob.ktype == "bool", f"{name} is {knob.ktype}, not bool"
    return bool(value(name))


def get_levels(name: str) -> tuple[float, ...]:
    knob = KNOBS[name]
    assert knob.ktype == "levels", f"{name} is {knob.ktype}, not levels"
    v = value(name)
    assert isinstance(v, tuple)
    return v


def mutable_knobs() -> tuple[Knob, ...]:
    """Every knob declared runtime-settable, in declaration order —
    the config plane's settable surface and the autotuner's search
    space."""
    return tuple(k for k in _DECLARATIONS if k.mutable)


def overrides_version() -> int:
    """Monotonic version of the runtime-override state; bumps on every
    apply_overrides / clear_overrides so callers can cache derived
    config behind one int compare."""
    return _VERSION


def current() -> dict:
    """Versioned snapshot of the mutable-knob surface: the effective
    (env + overrides, fully parsed) value of every mutable knob, the
    raw override map, and the override version. Components that must
    see /configz changes read through this (or the typed accessors,
    which consult the same override map) — never an import-time
    cache."""
    return {
        "version": _VERSION,
        "values": {k.name: value(k.name) for k in mutable_knobs()},
        "overrides": dict(_OVERRIDES),
    }


def _validate_override(name: str, rawv: str) -> str | None:
    """Error string when `rawv` is not a legal runtime value for the
    mutable knob `name`, else None. Validation is the same parse the
    environment gets, plus the declared mrange — an apply must refuse
    loudly where an env mistype merely warns-and-defaults."""
    knob = KNOBS.get(name)
    if knob is None:
        return f"undeclared knob {name!r}"
    if not knob.mutable:
        return f"{name} is not mutable"
    if knob.ktype not in ("int", "float"):
        return f"{name}: mutable {knob.ktype} knobs are unsupported"
    try:
        n = _parse_scalar(knob, rawv)
    except ValueError:
        return f"{name}={rawv!r} is not a valid {knob.ktype}"
    if knob.bound and n <= 0:  # type: ignore[operator]
        return None  # non-positive bound = "feature off": always legal
    if knob.mrange is not None:
        lo, hi = knob.mrange
        if not (lo <= n <= hi):  # type: ignore[operator]
            return (f"{name}={rawv} outside declared range "
                    f"[{lo}, {hi}]")
    return None


def apply_overrides(updates: dict) -> dict:
    """Validate and apply a runtime override batch atomically: every
    entry must pass the type/bound/mrange contract or the whole batch
    is refused with ValueError (no partial applies). A None value
    removes that knob's override (reverts to the environment). Returns
    the post-apply current() snapshot."""
    global _VERSION
    staged: dict[str, str | None] = {}
    errors: list[str] = []
    for name, v in updates.items():
        if v is None:
            knob = KNOBS.get(name)
            if knob is None or not knob.mutable:
                errors.append(f"{name} is not a mutable knob")
            else:
                staged[name] = None
            continue
        rawv = str(v)
        err = _validate_override(name, rawv)
        if err is not None:
            errors.append(err)
        else:
            staged[name] = rawv
    if errors:
        raise ValueError("; ".join(errors))
    for name, rawv in staged.items():
        if rawv is None:
            _OVERRIDES.pop(name, None)
        else:
            _OVERRIDES[name] = rawv
    _VERSION += 1
    return current()


def clear_overrides() -> None:
    """Drop every runtime override (rollback to pure-environment
    config). Bumps the version so cached derived state refreshes."""
    global _VERSION
    _OVERRIDES.clear()
    _VERSION += 1


def doc_table() -> str:
    """Markdown table of every declared knob, written into
    docs/TORCH_OBSERVABILITY.md between the ldt-knob-table markers by
    `python -m tools.lint_torch --write-knob-docs` and drift-checked by
    the knob-registry analyzer (the reference's doc_table over the
    port's knobs)."""
    rows = ["| Knob | Type | Default | Mutable | Meaning |",
            "| --- | --- | --- | --- | --- |"]
    for knob in _DECLARATIONS:
        if knob.default is None:
            dflt = "off" if knob.bound else "unset"
        elif knob.ktype == "levels":
            dflt = ",".join(f"{x:g}" for x in knob.default)  # type: ignore[attr-defined]
        elif knob.default == "":
            dflt = "(empty)"
        else:
            dflt = f"{knob.default}"
        if knob.mutable and knob.mrange is not None:
            lo, hi = knob.mrange
            mut = f"yes [{lo:g}, {hi:g}]"
        elif knob.mutable:
            mut = "yes"
        else:
            mut = ""
        rows.append(f"| `{knob.name}` | {knob.ktype} | {dflt} | {mut} "
                    f"| {knob.doc} |")
    return "\n".join(rows)
