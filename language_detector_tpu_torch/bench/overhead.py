"""The always-on observability costs and the --smoke gates (bench.py
`bench_telemetry_overhead`, `bench_capture_overhead` and its `--smoke`
branch), with the reference's budgets unchanged.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
import time

from . import PKG, ROOT, check_device, child_env, run_child

# Budget for one full `python -m tools.lint_torch` run (the reference's
# analyzers over the port); --smoke fails when it stops being cheap.
LINT_BUDGET_MS = 30_000

# Per-record budgets for the always-on observability hot paths: one
# flight-recorder emit (JSON encode + mmap store) and one trace span.
TELEM_BUDGET_NS = 50_000

# Integrity scrub overhead ceiling: one scrub+canary cycle amortized
# over LDT_SCRUB_INTERVAL_SEC must stay under 1% of serving capacity.
SCRUB_BUDGET_FRAC = 0.01

# capture-plane overhead budget: one record append must stay under 1%
# of a cheap request's cost; --smoke recomputes the 1% bound from the
# measured engine throughput and also enforces this absolute ceiling
CAPTURE_BUDGET_NS = 50_000

# the scrub gate's engine, as the reference sets it
SCRUB_ENV = {"LDT_POOL_LANES": "2", "LDT_SCRUB_INTERVAL_SEC": "30",
             "LDT_CANARY_DOCS": "8"}


def bench_telemetry_overhead(n: int = 20_000) -> dict:
    """ns per flight-recorder event and per trace span, on the real
    code paths (armed recorder into a temp ring, module-level
    emit_event; Trace spans via observe_stage)."""
    from .. import flightrec, telemetry

    tmp = tempfile.mkdtemp(prefix="ldt-bench-fr-")
    saved = flightrec.RECORDER
    try:
        flightrec.RECORDER = flightrec.FlightRecorder(
            flightrec.ring_path(tmp), slots=256, slot_bytes=512)
        t0 = time.perf_counter()
        for _ in range(n):
            flightrec.emit_event("request_end", request_id="bench",
                                 status=200, total_ms=1.25)
        event_ns = (time.perf_counter() - t0) * 1e9 / n
        flightrec.RECORDER.close()
    finally:
        flightrec.RECORDER = saved
        shutil.rmtree(tmp, ignore_errors=True)
    spans_per_trace = 8
    t0 = time.perf_counter()
    for _ in range(n // spans_per_trace):
        tr = telemetry.Trace()
        t = tr.t0
        for _ in range(spans_per_trace):
            t = telemetry.observe_stage("bench", t, trace=tr)
    span_ns = (time.perf_counter() - t0) * 1e9 \
        / ((n // spans_per_trace) * spans_per_trace)
    # the calibration loops above are not workload: drop their stage
    # histograms so the bench summary stays clean
    telemetry.REGISTRY.reset()
    return {"flightrec_ns_per_event": round(event_ns, 1),
            "trace_ns_per_span": round(span_ns, 1)}


def bench_capture_overhead(n: int = 4000) -> dict:
    """ns per capture record on the real hot path (module-level
    capture.observe with an armed writer, spans on the trace, counters
    included): what finish_request pays per request when
    LDT_CAPTURE_DIR is set."""
    from .. import capture as cap
    from .. import telemetry

    tmp = tempfile.mkdtemp(prefix="ldt-bench-cap-")
    saved = cap.WRITER
    try:
        cap.WRITER = cap.CaptureWriter(tmp, ring_records=1024,
                                       sample=1.0, seed=0)
        tr = telemetry.Trace()
        tr.tenant = "bench"
        t = tr.t0
        for stage in ("parse", "detect", "encode"):
            t = telemetry.observe_stage(stage, t, trace=tr)
        meta = {"front": "sync", "docs": 256, "bytes": 40_000,
                "status": 200, "priority": False}
        t0 = time.perf_counter()
        for _ in range(n):
            cap.observe(tr, meta, 4.2)
        record_ns = (time.perf_counter() - t0) * 1e9 / n
        cap.WRITER.close()
    finally:
        cap.WRITER = saved
        shutil.rmtree(tmp, ignore_errors=True)
    telemetry.REGISTRY.reset()
    return {"capture_ns_per_record": round(record_ns, 1)}


def scrub_child(device: str) -> dict:
    """One scrub+canary cycle's overhead on an engine built under
    SCRUB_ENV (in the process --smoke starts with it set)."""
    from .. import integrity
    from ..models.ngram import NgramBatchEngine
    eng = NgramBatchEngine(device=device)
    scrub = integrity.bench_scrub_overhead(eng)
    if eng.pool is not None:
        eng.pool.close()
    if scrub is None:
        raise RuntimeError("integrity monitor failed to build "
                           "(LDT_SCRUB_INTERVAL_SEC set but no monitor)")
    return scrub


def smoke(device: str = "cuda") -> dict:
    """--smoke: the lint suite timed against LINT_BUDGET_MS, the
    telemetry and capture overheads against theirs, a small headline
    (2,048-document batches, no service bench), and the scrub overhead
    in a fresh process against SCRUB_BUDGET_FRAC. Raises SystemExit
    with the reference's message on the first gate that fails."""
    from .engine import bench

    check_device(device)
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "tools.lint_torch"],
                       cwd=str(ROOT), capture_output=True, text=True,
                       timeout=10 * LINT_BUDGET_MS / 1e3)
    lint_ms = round((time.time() - t0) * 1e3, 1)
    if r.returncode != 0:
        raise SystemExit(f"bench --smoke: lint violations:\n"
                         f"{r.stdout}{r.stderr}")
    if lint_ms > LINT_BUDGET_MS:
        raise SystemExit(f"bench --smoke: lint suite took {lint_ms:.0f}ms "
                         f"(budget {LINT_BUDGET_MS}ms)")
    telem = bench_telemetry_overhead()
    for key, ns in telem.items():
        if ns > TELEM_BUDGET_NS:
            raise SystemExit(f"bench --smoke: {key} = {ns:.0f}ns "
                             f"(budget {TELEM_BUDGET_NS}ns)")
    out = bench(batch_size=2048, n_batches=2, http_bench=False,
                device=device)
    out["detail"]["lint_ms"] = lint_ms
    out["detail"].update(telem)
    # one capture record per request: under 1% of a 256-doc request at
    # THIS run's engine throughput, CAPTURE_BUDGET_NS the ceiling
    capt = bench_capture_overhead()
    docs_sec = out.get("value") or 0
    request_ns = 256 / docs_sec * 1e9 if docs_sec else 0
    budget_ns = min(CAPTURE_BUDGET_NS, request_ns * 0.01) \
        if request_ns else CAPTURE_BUDGET_NS
    if capt["capture_ns_per_record"] > budget_ns:
        raise SystemExit(f"bench --smoke: capture overhead "
                         f"{capt['capture_ns_per_record']:.0f}ns/record "
                         f"(budget {budget_ns:.0f}ns = min(1% of a "
                         f"256-doc request, {CAPTURE_BUDGET_NS}ns))")
    capt["capture_budget_ns"] = round(budget_ns, 1)
    if request_ns:
        capt["capture_frac_of_request"] = round(
            capt["capture_ns_per_record"] / request_ns, 6)
    out["detail"].update(capt)
    scrub = run_child(["-m", PKG + ".bench", "--scrub-child", "--device",
                       device], 600, env=child_env(SCRUB_ENV),
                      what="scrub overhead child")
    if scrub["overhead_frac"] > SCRUB_BUDGET_FRAC:
        raise SystemExit(f"bench --smoke: scrub overhead "
                         f"{scrub['overhead_frac']:.4f} of capacity "
                         f"(budget {SCRUB_BUDGET_FRAC}); cycle "
                         f"{scrub['scrub_cycle_ms']}ms per "
                         f"{scrub['interval_ms']:.0f}ms interval")
    out["detail"]["scrub"] = scrub
    return out
