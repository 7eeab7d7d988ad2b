"""Worker supervisor: restart the serving process on planned recycles,
and (opt-in) on crashes — with backoff and crash-loop detection.

The original Go service ships its restart story as a container policy
(its Dockerfile); this is the same story for bare-metal and for the
repo's own Dockerfile CMD: run the HTTP front as a child and restart it
per policy (docs/ROBUSTNESS.md):

  - exit RECYCLE_EXIT_CODE (planned self-recycle, service/recycle.py):
    restart immediately, always — a recycle is healthy behavior, it
    resets the crash counter;
  - exit 0, or a signal-initiated stop: propagate (done);
  - any other exit ("crash"): propagate by default, so crashes surface
    to the outer restart policy / operator. With LDT_RESTART_ON_CRASH
    set, restart after an exponential backoff with jitter
    (LDT_CRASH_BACKOFF_BASE_SEC doubling per consecutive crash up to
    LDT_CRASH_BACKOFF_MAX_SEC, scaled x0.5-1.5) — unless
    LDT_CRASH_LOOP_MAX crashes landed inside the trailing
    LDT_CRASH_LOOP_WINDOW_SEC, which declares a crash loop: a worker
    that cannot hold a generation up is broken, not unlucky, and
    restarting it forever hides the outage. The loop propagates the
    last exit code.

Each spawned worker gets LDT_WORKER_GENERATION=<n> in its environment
(1, 2, ...), which the fronts export as the ldt_worker_generation
gauge. Every generation also gets the same LDT_COMPILE_CACHE_DIR (the
directory the fused-tote kernel library is built into and loaded from;
operator value, else the checkout's build/torch_kernels/, which
already holds the library a checkout built) and the same LDT_AOT_DIR
(the kernel-library bundle, aot.py; operator value, else a
per-supervisor dir under tempdir), so generation 2+ loads the library
generation 1 built or exported instead of running nvcc. Every
generation opens its own CUDA context and uploads its own tables; the
supervisor itself never touches the card, and spawns its children with
fork+exec (subprocess), so no CUDA state is ever forked.
Every lifecycle event is one structured JSON log line with a "reason"
field (recycle | crash | crash-loop | clean-exit | signal | swap |
swap-abort).

SIGHUP runs the blue/green swap drill (docs/ROBUSTNESS.md): spawn a
STANDBY generation (LDT_SWAPPED=1, optionally pointed at a new
artifact via the LDT_ARTIFACT_POINTER file), hold it until its
LDT_READY_FILE handshake lands (readiness open: warmup done, one
flush driven through the card — service/swap.startup_ready_task), then
cut over
by SIGTERM-draining the old generation. Zero dropped requests when the
operator sets LDT_REUSEPORT in the supervisor's env (both generations
then share the listening port while the old one drains); any abort —
standby dies, readiness times out, pointer unreadable, injected
``standby_spawn`` fault — leaves the old generation serving untouched.

Run: python -m language_detector_tpu_torch.service.supervisor [module]
     (module defaults to language_detector_tpu_torch.service.aioserver,
      the single-core production front; pass .service.server for the
      threaded one)
"""
from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time

from .. import aot, faults, flightrec, knobs, telemetry
from .recycle import RECYCLE_EXIT_CODE


def _log(msg: str, **fields):
    print(json.dumps({"msg": msg, **fields}), flush=True)


def _harvest_crash(pid: int | None, rc) -> dict | None:
    """Read the crashed worker's flight-recorder ring (it inherited
    the supervisor's LDT_FLIGHTREC_DIR) into a postmortem log line.
    Best-effort: no recorder dir / no ring file is not an error."""
    base = knobs.get_str("LDT_FLIGHTREC_DIR")
    if not base or not pid:
        return None
    path = flightrec.ring_path(base, pid)
    try:
        pm = flightrec.harvest_postmortem(path, reason="crash", rc=rc)
    except (OSError, ValueError) as e:
        telemetry.REGISTRY.counter_inc("ldt_postmortem_total",
                                       result="missing")
        _log("supervisor: postmortem harvest failed — no readable "
             "recorder ring", reason="postmortem", pid=pid,
             error=repr(e))
        return None
    telemetry.REGISTRY.counter_inc("ldt_postmortem_total",
                                   result="harvested")
    flightrec.emit_event("postmortem", pid=pid, rc=rc, reason="crash",
                         events_total=pm.get("events_total"),
                         inflight=len(
                             pm.get("inflight_request_ids") or ()))
    _log("supervisor: postmortem harvested", reason="postmortem",
         pid=pid, rc=rc, events_total=pm.get("events_total"),
         events_held=pm.get("events_held"),
         inflight_request_ids=pm.get("inflight_request_ids"))
    flightrec.discard(path)  # consumed: the respawn starts clean
    return pm


# Worker lifecycle states, declared in tools/lint/fsm_registry.py
# (machine "supervisor-worker"): the `worker` local in main() tracks
# which phase the current generation is in, and the conformance
# analyzer proves every phase change below matches the declared table.
WORKER_IDLE = 0      # no generation spawned yet
WORKER_RUNNING = 1   # child alive, supervisor in the wait loop
WORKER_STOPPED = 2   # signal-initiated stop: propagate rc
WORKER_RECYCLED = 3  # planned self-recycle: respawn immediately
WORKER_EXITED = 4    # clean exit 0: propagate
WORKER_CRASHED = 5   # crash: propagate or backoff-respawn

# Blue/green swap drill phases (machine "supervisor-swap-drill"):
# tracked by the `drill` local in _swap_drill().
DRILL_IDLE = 0      # drill requested, standby not spawned yet
DRILL_SPAWNED = 1   # standby alive, waiting on the ready handshake
DRILL_CUTOVER = 2   # standby ready: draining the old generation
DRILL_PROMOTED = 3  # standby is now the supervised child
DRILL_ABORTED = 4   # any failure: old generation keeps serving


def _forward_stop(child, signaled, signum=None):
    """Forward a stop signal to `child` exactly once across all three
    forwarding sites (signal handler, spawn race, wait loop). Returns
    the new already-signaled child. A repeat SIGTERM can land
    mid-shutdown, after the worker's handler is gone, and turn a clean
    drain into a SIGTERM death — hence the `signaled` latch."""
    if child is not None and child is not signaled \
            and child.poll() is None:
        child.send_signal(signum if signum is not None
                          else signal.SIGTERM)
        return child
    return signaled


def handed_down_dirs() -> tuple:
    """(compile-cache dir, bundle dir) every generation or member of
    this supervisor gets, each created up front (None when it cannot
    be). LDT_COMPILE_CACHE_DIR defaults to the checkout's build
    directory, which already holds the library nvcc built there, so
    generation 1 of a supervised deploy pays no build the checkout
    has made; LDT_AOT_DIR defaults to a per-supervisor dir under
    tempdir, which keeps concurrent supervisors (tests, canaries) from
    sharing entries."""
    cache_dir = str(aot.compile_cache_dir())
    aot_dir = knobs.get_str("LDT_AOT_DIR") or os.path.join(
        tempfile.gettempdir(), f"ldt-aot-{os.getpid()}")
    out = []
    for d in (cache_dir, aot_dir):
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            d = None
        out.append(d)
    return tuple(out)


def _hand_down(env: dict, cache_dir: str | None,
               aot_dir: str | None) -> None:
    if cache_dir:
        env["LDT_COMPILE_CACHE_DIR"] = cache_dir
    if aot_dir:
        env["LDT_AOT_DIR"] = aot_dir


def main() -> int:
    module = sys.argv[1] if len(sys.argv) > 1 else \
        "language_detector_tpu_torch.service.aioserver"
    if (knobs.get_int("LDT_FLEET_WORKERS") or 0) >= 1:
        # N-member front tier: same entry point, fleet control plane
        # (health-gated membership, crash circuit, rolling SIGHUP swap,
        # autoscaling) — see service/fleet.py
        from .fleet import fleet_main
        return fleet_main(module)
    flightrec.init_from_env(role="supervisor")
    restart_on_crash = knobs.get_bool("LDT_RESTART_ON_CRASH")
    backoff_base = knobs.get_float("LDT_CRASH_BACKOFF_BASE_SEC") or 0.5
    backoff_max = knobs.get_float("LDT_CRASH_BACKOFF_MAX_SEC") or 30.0
    loop_window = knobs.get_float("LDT_CRASH_LOOP_WINDOW_SEC") or 60.0
    loop_max = knobs.get_int("LDT_CRASH_LOOP_MAX") or 5
    cache_dir, aot_dir = handed_down_dirs()

    generation = 0
    consec_crashes = 0
    crash_times: list = []  # wall times of recent crashes (loop window)
    child: subprocess.Popen | None = None
    stopping = False
    swap_requested = False
    signaled: subprocess.Popen | None = None  # child already SIGTERMed
    worker = WORKER_IDLE
    t0 = time.time()

    # PID-1 duty (the Dockerfile CMD): forward SIGTERM/SIGINT to the
    # worker so `docker stop` gives it a graceful shutdown instead of
    # the namespace teardown SIGKILLing it mid-request; then stop
    # restarting and exit with the worker's code.
    def _forward(signum, frame):
        nonlocal stopping, signaled
        stopping = True
        signaled = _forward_stop(child, signaled, signum)

    signal.signal(signal.SIGTERM, _forward)
    signal.signal(signal.SIGINT, _forward)

    # SIGHUP = "roll to a new generation without dropping traffic";
    # the flag is drained by the wait loop below, never the handler
    def _request_swap(signum, frame):
        nonlocal swap_requested
        swap_requested = True

    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, _request_swap)

    def _swap_drill():
        nonlocal child, generation, t0, signaled
        drill = DRILL_IDLE
        old = child
        gen = generation + 1
        _log("supervisor: swap drill starting", reason="swap",
             generation=generation, standby_generation=gen)
        artifact = None
        pointer = knobs.get_str("LDT_ARTIFACT_POINTER")
        if pointer:
            try:
                with open(pointer) as f:
                    artifact = f.read().strip()
            except OSError as e:
                drill = DRILL_ABORTED
                _log("supervisor: swap aborted — artifact pointer "
                     "unreadable", reason="swap-abort",
                     pointer=pointer, error=repr(e))
                return
        try:
            if faults.ACTIVE is not None:
                faults.hit("standby_spawn")
        except faults.FaultInjected as e:
            drill = DRILL_ABORTED
            _log("supervisor: swap aborted — injected fault",
                 reason="swap-abort", error=repr(e))
            return
        ready_file = os.path.join(
            tempfile.gettempdir(),
            f"ldt-ready-{os.getpid()}-{gen}.json")
        try:
            os.remove(ready_file)
        except OSError:
            pass
        env = dict(os.environ)  # ldt-lint: disable=knob-direct-env -- building the child environment, not reading config
        env["LDT_WORKER_GENERATION"] = str(gen)
        env["LDT_SWAPPED"] = "1"
        env["LDT_READY_FILE"] = ready_file
        _hand_down(env, cache_dir, aot_dir)
        if artifact:
            env["LDT_ARTIFACT_PATH"] = artifact
        standby = subprocess.Popen([sys.executable, "-m", module],
                                   env=env)
        drill = DRILL_SPAWNED
        st0 = time.time()
        timeout = knobs.get_float("LDT_SWAP_TIMEOUT_SEC") or 30.0
        deadline = st0 + timeout
        ready = False
        while time.time() < deadline:
            if standby.poll() is not None:
                # a standby that dies before ready (corrupt artifact,
                # port clash) aborts the drill; old keeps serving
                drill = DRILL_ABORTED
                _log("supervisor: swap aborted — standby died before "
                     "ready", reason="swap-abort",
                     rc=standby.returncode, standby_generation=gen)
                return
            if os.path.exists(ready_file):
                ready = True
                break
            # the ready check comes FIRST: a SIGTERM racing the
            # handshake must not abort a standby that already landed
            # its ready file — the cutover completes and the main loop
            # forwards the stop to the promoted generation
            if stopping:
                break
            time.sleep(0.05)
        if not ready:
            drill = DRILL_ABORTED
            standby.kill()
            standby.wait()
            _log("supervisor: swap aborted — standby not ready "
                 "in time", reason="swap-abort",
                 standby_generation=gen, timeout_sec=timeout)
            return
        # cutover: standby is warmed and listening (share the port via
        # LDT_REUSEPORT for zero-drop) — drain the old generation
        # gracefully (SIGTERM: stop accepting, flush in-flight, exit 0)
        drill = DRILL_CUTOVER
        _log("supervisor: swap cutover — draining old generation",
             reason="swap", generation=generation,
             standby_generation=gen)
        # the drain shares the exactly-once latch: if a stop already
        # SIGTERMed the old generation mid-drill, a second SIGTERM here
        # could land after its handler is gone and kill the drain
        signaled = _forward_stop(old, signaled)
        try:
            old.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            old.kill()
            old.wait()
        try:
            os.remove(ready_file)
        except OSError:
            pass
        child = standby
        drill = DRILL_PROMOTED
        generation = gen
        t0 = st0
        _log("supervisor: swap complete", reason="swap",
             generation=gen,
             standby_ready_sec=round(time.time() - st0, 3))

    while True:
        generation += 1
        _log(f"supervisor: starting {module} (generation {generation})",
             generation=generation)
        t0 = time.time()
        # the supervisor WRITES the child's env; its own reads above go
        # through the registry
        env = dict(os.environ)  # ldt-lint: disable=knob-direct-env -- building the child environment, not reading config
        env["LDT_WORKER_GENERATION"] = str(generation)
        _hand_down(env, cache_dir, aot_dir)
        child = subprocess.Popen([sys.executable, "-m", module], env=env)
        worker = WORKER_RUNNING
        if stopping:  # signal raced the spawn: stop the new worker too
            signaled = _forward_stop(child, signaled)
        while True:
            try:
                # short-poll wait so a SIGHUP swap request is noticed
                # while the worker is healthy (the only time a drill
                # makes sense)
                rc = child.wait(timeout=0.2)
                break
            except subprocess.TimeoutExpired:
                if stopping:
                    # a stop that raced a swap drill forwarded the
                    # signal to the OLD child; make sure whichever
                    # generation is current hears it — exactly once
                    # (a repeat can land mid-shutdown, after the
                    # worker's handler is gone, and turn a clean drain
                    # into a SIGTERM death)
                    signaled = _forward_stop(child, signaled)
                elif swap_requested:
                    swap_requested = False
                    _swap_drill()
                continue
            except KeyboardInterrupt:  # Ctrl+C raced the handler
                continue
        uptime = round(time.time() - t0, 3)
        if stopping:
            worker = WORKER_STOPPED
            _log("supervisor: worker stopped by signal — propagating",
                 reason="signal", rc=rc, generation=generation,
                 uptime_sec=uptime)
            return rc
        if rc == RECYCLE_EXIT_CODE:
            # planned recycle: healthy; restart now and forget crashes
            worker = WORKER_RECYCLED
            consec_crashes = 0
            _log("supervisor: worker recycled", reason="recycle",
                 rc=rc, generation=generation, uptime_sec=uptime)
            continue
        if rc == 0:
            worker = WORKER_EXITED
            _log("supervisor: worker exited cleanly — propagating",
                 reason="clean-exit", rc=rc, generation=generation,
                 uptime_sec=uptime)
            return rc
        worker = WORKER_CRASHED
        _harvest_crash(child.pid, rc)
        if not restart_on_crash:
            _log("supervisor: worker crashed — propagating "
                 "(LDT_RESTART_ON_CRASH not set)", reason="crash",
                 rc=rc, generation=generation, uptime_sec=uptime)
            return rc
        now = time.time()
        crash_times = [t for t in crash_times if now - t <= loop_window]
        crash_times.append(now)
        if len(crash_times) >= loop_max:
            _log(f"supervisor: crash-loop — {len(crash_times)} crashes "
                 f"in {loop_window:g}s, propagating",
                 reason="crash-loop", rc=rc, generation=generation,
                 uptime_sec=uptime)
            return rc
        consec_crashes += 1
        backoff = min(backoff_base * (2 ** (consec_crashes - 1)),
                      backoff_max)
        backoff *= 0.5 + random.random()  # jitter: x0.5 - x1.5
        _log("supervisor: worker crashed — restarting after backoff",
             reason="crash", rc=rc, generation=generation,
             uptime_sec=uptime, backoff_sec=round(backoff, 3),
             consecutive_crashes=consec_crashes)
        # interruptible backoff: a SIGTERM during the wait must end the
        # supervisor, not spawn one more doomed generation
        deadline = time.time() + backoff
        while time.time() < deadline:
            if stopping:
                _log("supervisor: stopped during backoff — propagating",
                     reason="signal", rc=rc, generation=generation)
                return rc
            try:
                time.sleep(min(0.1, max(deadline - time.time(), 0)))
            except KeyboardInterrupt:
                continue


if __name__ == "__main__":
    sys.exit(main())
