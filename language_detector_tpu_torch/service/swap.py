"""In-process artifact hot swap and the standby readiness handshake.

Two ways to roll a new scoring artifact without dropping traffic:

1. **In-process swap** — ``swap_artifact(svc, path)``: load a FRESH
   mmap of the artifact (bypassing the process-wide tables cache),
   build a new engine against it, and rebind the service's scorer
   reference between flushes. One GIL-atomic rebind: in-flight flushes
   finish on the engine they captured at call entry, new flushes pick
   up the new one. Both metrics fronts expose it as ``POST /swap``.

2. **Blue/green generation swap** — the supervisor's SIGHUP drill
   (service/supervisor.py) spawns a standby worker generation, holds
   it until ``startup_ready_task`` below reports ready (warmup done),
   then cuts over and drains the old
   generation. This module owns only the worker side of that
   handshake: the LDT_READY_FILE drop.

Every swap outcome counts into ``ldt_swap_total{result=}``; an aborted
swap (corrupt artifact, open breaker, injected ``swap_cutover`` fault)
leaves the old tables serving — the swap path never degrades the
running service.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

from .. import artifact, faults, knobs, telemetry
from .admission import BREAKER_OPEN


class SwapError(RuntimeError):
    """A refused or aborted artifact swap. The old artifact is still
    serving whenever this is raised — callers surface it (HTTP 409)
    but never tear anything down."""


# In-process swap phases, declared in tools/lint/fsm_registry.py
# (machine "artifact-swap"): the `swap` local in swap_artifact()
# tracks the attempt, and the conformance analyzer proves the phase
# changes match the declared table (e.g. REBOUND is only reachable
# through LOADING — never from a refused precondition).
SWAP_IDLE = 0     # under the swap lock, preconditions being checked
SWAP_LOADING = 1  # fresh mmap + engine build in progress
SWAP_REBOUND = 2  # service references rebound to the new artifact
SWAP_REFUSED = 3  # precondition refused the swap (breaker open)
SWAP_ABORTED = 4  # load/cutover failed; old tables keep serving


def _swap_engine(svc, tables):
    """Build a new batched engine over `tables`, on the device of the
    engine it replaces, and rebind. Stats carry over so the
    ldt_engine_* counters stay monotonic across swaps."""
    from ..models.ngram import NgramBatchEngine
    old = svc._engine
    new_eng = NgramBatchEngine(tables=tables, device=old.device)
    snap = old.stats_snapshot()
    with new_eng._stats_lock:
        for k, v in snap.items():
            new_eng.stats[k] = new_eng.stats.get(k, 0) + v
    svc._engine = new_eng


def swap_artifact(svc, path) -> dict:
    """Swap the service onto the artifact at `path`. Serialized by the
    service's swap lock; raises SwapError (old tables keep serving) if
    the breaker is open, the artifact fails verification, or the
    injected ``swap_cutover`` fault fires. Returns an info dict for
    the POST /swap response."""
    from ..tables import ScoringTables
    path = str(path)
    swap = SWAP_IDLE
    with svc._swap_lock:
        # a swap while the device is circuit-broken would build the
        # new engine straight onto the failing device — refuse
        # and let the operator retry once the breaker closes
        if svc._engine is not None and \
                svc.admission.breaker.stats()["state"] == BREAKER_OPEN:
            swap = SWAP_REFUSED
            telemetry.REGISTRY.counter_inc("ldt_swap_total",
                                           result="error")
            raise SwapError("swap refused: device circuit breaker is "
                            "open; retry once it closes")
        # verify the standby artifact's digest footer BEFORE any
        # rebind work: a bit-flipped standby must never replace
        # serving tables (the old artifact keeps serving)
        try:
            digest = artifact.verify_artifact(path)
        except artifact.ArtifactIntegrityError as e:
            swap = SWAP_REFUSED
            telemetry.REGISTRY.counter_inc(
                "ldt_swap_total", result="integrity_refused")
            raise SwapError(
                f"swap refused: standby artifact failed integrity "
                f"verification ({e}); old tables keep serving") from e
        except (OSError, artifact.ArtifactError) as e:
            swap = SWAP_REFUSED
            telemetry.REGISTRY.counter_inc("ldt_swap_total",
                                           result="error")
            raise SwapError(f"swap refused: cannot read standby "
                            f"artifact ({e})") from e
        t0 = time.monotonic()
        swap = SWAP_LOADING
        try:
            # FRESH mmap, never the process-wide cache: the whole point
            # is picking up new bytes at an already-seen path
            tables = ScoringTables.load_mmap(Path(path))
            if faults.ACTIVE is not None:
                faults.hit("swap_cutover")
            if svc._engine is not None:
                _swap_engine(svc, tables)
            else:
                svc._tables = tables
        except SwapError:
            swap = SWAP_ABORTED
            raise
        except Exception as e:
            swap = SWAP_ABORTED
            telemetry.REGISTRY.counter_inc("ldt_swap_total",
                                           result="error")
            raise SwapError(f"swap aborted ({path}): {e}") from e
        swap = SWAP_REBOUND
        svc._artifact_path = path
        svc._swap_count += 1
        count = svc._swap_count
        # the rebind invalidates every cached result: namespace the
        # result caches (sync Batcher's + any front-registered one)
        # to the new artifact's generation so a post-swap request can
        # never be served a pre-swap answer
        epoch = digest or f"swap-{count}"
        caches = [getattr(getattr(svc, "batcher", None), "_cache",
                          None)]
        caches.extend(getattr(svc, "_result_caches", ()))
        for c in caches:
            if c is not None:
                c.set_epoch(epoch)
        telemetry.REGISTRY.counter_inc("ldt_swap_total", result="ok")
        ms = (time.monotonic() - t0) * 1e3
    print(json.dumps({"msg": "artifact swap complete",
                      "path": path, "swap_count": count,
                      "ms": round(ms, 1)}), flush=True)
    return {"swapped": True, "path": path, "swap_count": count,
            "engine": svc._engine is not None, "ms": round(ms, 1)}


def startup_ready_task(svc, ports) -> None:
    """Post-bind startup duties, run off the serving threads by both
    fronts: run the warmup batch when LDT_WARMUP is set (readiness
    gates on it), then drop the LDT_READY_FILE handshake the
    supervisor's swap drill polls for. Never raises — a warmup failure
    leaves readiness not-ok, which IS the signal."""
    if knobs.get_bool("LDT_WARMUP"):
        try:
            svc.warm()
        except Exception as e:
            print(json.dumps({"msg": "warmup failed",
                              "error": repr(e)}), flush=True)
            return
    ready_file = knobs.get_str("LDT_READY_FILE")
    if not ready_file:
        return
    # wait until the full readiness gate (warmup, breaker, brownout)
    # opens before telling the supervisor to cut over
    deadline = time.monotonic() + \
        (knobs.get_float("LDT_SWAP_TIMEOUT_SEC") or 30.0)
    while time.monotonic() < deadline:
        try:
            rd = svc.readiness()
        except Exception:
            rd = {"ok": False}
        if rd.get("ok"):
            break
        time.sleep(0.05)
    else:
        print(json.dumps({"msg": "ready file withheld: readiness "
                          "never opened", "path": ready_file}),
              flush=True)
        return
    if knobs.get_bool("LDT_SWAPPED"):
        # this generation exists because a blue/green cutover promoted
        # it — count the swap on the side that survived
        telemetry.REGISTRY.counter_inc("ldt_swap_total", result="ok")
    info = {"generation": knobs.get_int("LDT_WORKER_GENERATION") or 1,
            "pid": os.getpid(), "port": ports[0],
            "metrics_port": ports[1],
            "warmup_ms": round(getattr(svc, "_warmup_ms", 0.0), 3)}
    tmp = f"{ready_file}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(info, f)
        os.replace(tmp, ready_file)
    except OSError as e:
        print(json.dumps({"msg": "ready file write failed",
                          "path": ready_file, "error": repr(e)}),
              flush=True)
