"""Fleet supervisor: N supervised worker generations behind one port.

`service/supervisor.py` manages exactly one worker (plus a SIGHUP
standby); this module generalizes the same policies to a fleet of
`LDT_FLEET_WORKERS` members that share the listen port via the
SO_REUSEPORT path the swap drill already requires (the fleet forces
LDT_REUSEPORT=1 into every member env) — turning a single-worker box
into a many-core front tier a load balancer can sit on
(docs/ROBUSTNESS.md, "Fleet supervisor").

Per member, the fleet keeps the single-worker contracts intact:

  - its own generation number, ready-file handshake
    (service/swap.startup_ready_task), and an exactly-once stop latch
    (supervisor._forward_stop);
  - crash backoff with jitter and a per-member crash-loop detector
    (LDT_CRASH_LOOP_MAX crashes in LDT_CRASH_LOOP_WINDOW_SEC parks the
    member instead of restarting it forever);
  - a per-member unix socket (`LDT_UNIX_SOCKET` + ".<slot>") and a
    per-member metrics port, recovered from the ready-file JSON when
    the operator binds port 0.

LISTEN_PORT=0 asks the fleet for a free listen port: it binds one
itself (SO_REUSEPORT, not listening), holds it for its life and hands
it to every member, so no other bind of port 0 can be given it while
members come and go; a negative LDT_FLEET_STATUS_PORT likewise binds
the control plane on a free port. Both ports are on the fleet's
`fleet: starting` log line and /fleetz. A port probed free and closed
before the members bind it can be handed to another fleet in the
meantime, and SO_REUSEPORT then lets the two fleets share it silently.

On top sits the fleet control plane, modeled on the device pool
(parallel/pool.py):

  - member health states SPAWNING -> READY -> DEGRADED -> DEAD ->
    RESTARTING (declared in tools/lint/fsm_registry.py, machine
    "fleet-member"), driven by the ready-file handshake plus periodic
    /debug/vars scrapes (queue depth, brownout level, readiness);
  - a fleet-wide crash circuit (machine "fleet-circuit"): the same
    LDT_CRASH_LOOP_MAX/_WINDOW_SEC counted across ALL members, OR a
    bootstrapped fleet losing its last accepting member, opens the
    circuit — restarts stop (no N-way restart storm; surviving members
    and worker-level brownout/breaker provide the scalar/503 posture)
    until a cooldown admits exactly one half-open probe member whose
    readiness closes the circuit and re-arms restarts;
  - autoscale between LDT_FLEET_MIN/MAX on sustained admission queue
    depth and brownout level with hold-time hysteresis; scale-down
    drains the victim through the ordinary SIGTERM path (stop
    accepting, flush in-flight, exit 0), so shrink is zero-drop;
  - SIGHUP runs the blue/green drill as a ROLLING swap: one warmed
    standby at a time, each roll preconditioned on every other member
    being READY, so the fleet never drops below N-1 ready workers.

The bounded model checker (tools/lint/model_check.py, product
"fleet-control") drives the real FleetMember/FleetControl classes over
every crash/ready/probe interleaving and proves the headline
invariant: while the fleet is nominally up (bootstrapped, circuit
closed) at least one member is accepting.

On one card the members share the device: each member process opens
its own CUDA context, uploads its own DeviceTables and loads the one
fused-tote kernel library. Every member and every generation gets the
same LDT_COMPILE_CACHE_DIR (where nvcc builds the library; default the
checkout's build/torch_kernels/) and the same LDT_AOT_DIR (the
kernel-library bundle, aot.py; default a per-fleet dir under tempdir),
as the supervisor hands them down: the first member to build the
library exports it, every other member and every rolling-swap standby
loads it. The fleet process itself never touches the card; members are
spawned with fork+exec (subprocess), so no CUDA state is ever forked.
Two members on one card need the card's compute mode to be Default.

Run: the classic entry point dispatches here —
     LDT_FLEET_WORKERS=3 python -m language_detector_tpu_torch.service.supervisor
"""
from __future__ import annotations

import http.server
import json
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

from .. import faults, flightrec, knobs, telemetry
from ..locks import make_lock
from .recycle import RECYCLE_EXIT_CODE
from .supervisor import (_forward_stop, _hand_down, _log,
                         handed_down_dirs)

# Member lifecycle states, declared in tools/lint/fsm_registry.py
# (machine "fleet-member"): FleetMember.state only moves through the
# guarded mark_* methods below, so the conformance pass proves every
# write against the declared table.
FLEET_SPAWNING = 0    # process launched, ready handshake pending
FLEET_READY = 1       # ready file landed / health scrape passing
FLEET_DEGRADED = 2    # consecutive health-scrape failures
FLEET_DEAD = 3        # process exited (crash, recycle, drain)
FLEET_RESTARTING = 4  # respawn decided, Popen not issued yet

STATE_NAMES = {FLEET_SPAWNING: "spawning", FLEET_READY: "ready",
               FLEET_DEGRADED: "degraded", FLEET_DEAD: "dead",
               FLEET_RESTARTING: "restarting"}

# Fleet crash-circuit states (machine "fleet-circuit"): open means
# "stop respawning members", not "stop serving" — survivors keep
# serving and worker-level admission provides the 429/503 posture.
CIRCUIT_CLOSED = 0  # restarts allowed
CIRCUIT_OPEN = 1    # correlated crash: restarts parked until cooldown
CIRCUIT_PROBE = 2   # one half-open probe member spawning

CIRCUIT_NAMES = {CIRCUIT_CLOSED: "closed", CIRCUIT_OPEN: "open",
                 CIRCUIT_PROBE: "probe"}


class FleetMember:
    """One supervised worker slot. The object persists across respawns
    (state, crash history, and backoff are per-slot, not per-process).

    Deliberately lock-free: every field is owned by the fleet main
    loop — the status thread reads only the immutable snapshots
    FleetStatus holds (same confinement argument as admission's
    FairScheduler)."""

    def __init__(self, slot: int):
        self.slot = slot
        self.state = FLEET_SPAWNING
        self.proc: subprocess.Popen | None = None
        self.signaled: subprocess.Popen | None = None  # stop latch arg
        self.generation = 0
        self.ready_file = ""
        self.metrics_port = 0
        self.ready_deadline = 0.0
        self.last_scrape = 0.0
        self.fail_streak = 0
        self.queue_docs = 0
        self.brownout = 0
        self.config_generation = 0  # from the member's /debug/vars
        self.crash_times: list = []
        self.consec_crashes = 0
        self.next_spawn_at = 0.0
        self.parked = False     # per-member crash loop: stop respawning
        self.retiring = False   # scale-down drain in progress

    # -- guarded FSM writes (one declared transition per branch) ------

    def mark_ready(self) -> None:
        if self.state == FLEET_SPAWNING:
            self.state = FLEET_READY
        elif self.state == FLEET_DEGRADED:
            self.state = FLEET_READY

    def mark_degraded(self) -> None:
        if self.state == FLEET_READY:
            self.state = FLEET_DEGRADED

    def mark_dead(self) -> None:
        if self.state == FLEET_SPAWNING:
            self.state = FLEET_DEAD
        elif self.state == FLEET_READY:
            self.state = FLEET_DEAD
        elif self.state == FLEET_DEGRADED:
            self.state = FLEET_DEAD

    def mark_restarting(self) -> None:
        if self.state == FLEET_DEAD:
            self.state = FLEET_RESTARTING

    def mark_spawning(self) -> None:
        if self.state == FLEET_RESTARTING:
            self.state = FLEET_SPAWNING

    def accepting(self) -> bool:
        """A member whose process is up with a bound listener: READY,
        or DEGRADED (scrapes failing but the socket still answers —
        eviction happens by death, not by flapping health)."""
        return self.state == FLEET_READY or self.state == FLEET_DEGRADED


class FleetControl:
    """Fleet-wide crash circuit + autoscale hysteresis. Pure policy —
    no I/O, injectable clock — so the bounded model checker can drive
    it composed with FleetMember (product "fleet-control").

    Main-loop confined like FleetMember: no locks."""

    def __init__(self, loop_max: int, loop_window: float,
                 cooldown_sec: float, scale_hold_sec: float,
                 up_depth: int, down_depth: int):
        self.loop_max = loop_max
        self.loop_window = loop_window
        self.cooldown_sec = cooldown_sec
        self.scale_hold_sec = scale_hold_sec
        self.up_depth = up_depth
        self.down_depth = down_depth
        self.circuit = CIRCUIT_CLOSED
        self.crash_times: list = []
        self.opened_at = 0.0
        self.bootstrapped = False  # a member has been READY at least once
        self._over_since: float | None = None
        self._idle_since: float | None = None

    # -- crash circuit ------------------------------------------------

    def record_crash(self, now: float, accepting: int) -> bool:
        """Account one member crash. Trips the circuit (returns True)
        on a correlated crash: LDT_CRASH_LOOP_MAX crashes across the
        fleet inside the window, OR a bootstrapped fleet left with
        zero accepting members — by definition every member failed
        together, and N independent restart storms would hide it."""
        self.crash_times = [t for t in self.crash_times
                            if now - t <= self.loop_window]
        self.crash_times.append(now)
        correlated = len(self.crash_times) >= self.loop_max
        wipeout = self.bootstrapped and accepting == 0
        if (correlated or wipeout) and self.circuit == CIRCUIT_CLOSED:
            self.circuit = CIRCUIT_OPEN
            self.opened_at = now
            return True
        return False

    def probe_due(self, now: float) -> bool:
        return (self.circuit == CIRCUIT_OPEN
                and now - self.opened_at >= self.cooldown_sec)

    def begin_probe(self) -> None:
        if self.circuit == CIRCUIT_OPEN:
            self.circuit = CIRCUIT_PROBE

    def probe_ok(self) -> None:
        """A probe member reached READY (or capacity was still there):
        close the circuit and forget the crash history — the next
        correlated crash must re-accumulate its own evidence."""
        if self.circuit == CIRCUIT_PROBE:
            self.circuit = CIRCUIT_CLOSED
            self.crash_times = []

    def probe_failed(self, now: float) -> None:
        if self.circuit == CIRCUIT_PROBE:
            self.circuit = CIRCUIT_OPEN
            self.opened_at = now

    # -- autoscale hysteresis -----------------------------------------

    def scale_delta(self, now: float, depth: int, brownout: int) -> int:
        """+1 / -1 / 0: the overload (queue depth >= up_depth, or
        brownout >= 2) or idle (depth <= down_depth and no brownout)
        condition must HOLD for scale_hold_sec before a step fires,
        and firing re-arms the timer — one step per held window, never
        a flap per sample."""
        overloaded = depth >= self.up_depth or brownout >= 2
        idle = depth <= self.down_depth and brownout == 0
        if overloaded:
            self._idle_since = None
            if self._over_since is None:
                self._over_since = now
            elif now - self._over_since >= self.scale_hold_sec:
                self._over_since = None
                return 1
        elif idle:
            self._over_since = None
            if self._idle_since is None:
                self._idle_since = now
            elif now - self._idle_since >= self.scale_hold_sec:
                self._idle_since = None
                return -1
        else:
            self._over_since = None
            self._idle_since = None
        return 0


class FleetStatus:
    """Snapshot shared between the fleet main loop (writer) and the
    status endpoint thread (reader)."""

    def __init__(self):
        self._lock = make_lock("fleet.status")
        self._snap: dict = {"members": [], "desired": 0, "ready": 0,
                            "circuit": "closed"}

    def update(self, snap: dict) -> None:
        with self._lock:
            self._snap = snap

    def read(self) -> dict:
        with self._lock:
            return self._snap


class FleetConfig:
    """The fleet-committed runtime-config batch: the result of the
    last canary-proven POST /configz push. Written by the status-server
    thread, read by the main loop's heal pass (which re-pushes it onto
    respawned or fan-out-missed members), so a SIGKILLed member cannot
    leave the fleet split-brained on config generation."""

    def __init__(self):
        self._lock = make_lock("fleet.config")
        # serializes whole canary-push campaigns (non-blocking acquire:
        # a second concurrent POST /configz answers 409, mirroring the
        # per-member probation-in-flight refusal)
        self.push_lock = make_lock("fleet.config.push")
        self.generation = 0
        self.values: dict = {}

    def next_generation(self) -> int:
        with self._lock:
            return self.generation + 1

    def commit(self, generation: int, values: dict) -> None:
        with self._lock:
            if generation > self.generation:
                self.generation = generation
                self.values = dict(values)

    def read(self) -> tuple:
        with self._lock:
            return self.generation, dict(self.values)


def _member_configz(port: int, payload: dict | None = None,
                    timeout: float = 2.0) -> tuple:
    """POST (payload given) or GET one member's /configz. Returns
    (status, body dict); a 4xx refusal still carries the member's JSON
    body, so callers can surface the member's own error."""
    url = f"http://127.0.0.1:{port}/configz"
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode() or "{}")
        except ValueError:
            return e.code, {}


def _fleet_config_push(snap: dict, fleet_config: FleetConfig,
                       body: bytes) -> tuple:
    """The supervisor's guarded fleet-wide config push: canary first,
    fan out only after the canary survives probation.

    1. Stage the batch on ONE ready member (the canary) with the
       requested probation window, so every other member — at least
       N-1 of the fleet — keeps serving on the old config.
    2. Poll the canary's GET /configz (each poll drives its probation
       tick) until it reports committed or rolled_back.
    3. Only on commit: fan the batch out to the rest of the fleet with
       probation 0 and the SAME generation stamp, record it as the
       fleet-committed config (the main loop heals any member the
       fan-out missed), and apply it to the supervisor's own process so
       fleet-scoped knobs (autoscale thresholds) go live too.

    Returns (http status, response dict) for the status server."""
    try:
        req = json.loads(body or b"{}")
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        updates = req.get("set")
        if not isinstance(updates, dict) or not updates:
            raise ValueError('body must carry a non-empty "set" object')
        probation = req.get("probation_sec")
        probation = float(probation) if probation is not None else (
            knobs.get_float("LDT_CONFIG_PROBATION_SEC") or 0.0)
    except (ValueError, json.JSONDecodeError) as e:
        return 400, {"error": f"bad /configz request: {e}"}
    ports = [int(m.get("metrics_port") or 0)
             for m in snap.get("members", ())
             if m.get("state") in ("ready", "degraded")
             and int(m.get("metrics_port") or 0) > 0]
    if not ports:
        return 503, {"error": "no ready member to canary the config on"}
    if not fleet_config.push_lock.acquire(blocking=False):
        return 409, {"error": "a fleet config push is already in flight"}
    try:
        generation = fleet_config.next_generation()
        canary, rest = ports[0], ports[1:]
        try:
            st, result = _member_configz(
                canary, {"set": updates, "probation_sec": probation,
                         "generation": generation})
        except Exception as e:  # noqa: BLE001 - surface, don't crash
            return 503, {"error": f"canary push failed: {e!r}"}
        if st != 200:
            return st, {"error": "canary refused the config",
                        "canary": result}
        deadline = time.time() + probation + 10.0
        while True:
            state = (result or {}).get("state")
            if state == "committed" \
                    and result.get("generation") == generation:
                break
            if state == "rolled_back" \
                    and result.get("staged_generation") == generation:
                flightrec.emit_event("config_rolled_back",
                                     generation=generation,
                                     reason="canary rolled back")
                return 409, {"error": "canary rolled the config back",
                             "generation": generation,
                             "canary": result}
            if time.time() >= deadline:
                return 504, {"error": "canary probation did not "
                                      "resolve in time",
                             "generation": generation,
                             "canary": result}
            time.sleep(0.2)
            try:
                _, result = _member_configz(canary)
            except Exception:  # canary mid-restart: keep polling
                pass
        fanout = {"set": updates, "probation_sec": 0,
                  "generation": generation}
        pushed, heal_pending = [canary], []
        for port in rest:
            try:
                st, _r = _member_configz(port, fanout)
            except Exception:  # noqa: BLE001 - heal pass converges it
                st = 0
            (pushed if st == 200 else heal_pending).append(port)
        fleet_config.commit(generation, updates)
        try:
            # the supervisor's own process: autoscale knobs go live
            knobs.apply_overrides(updates)
        except ValueError as e:
            _log("fleet: committed batch refused by supervisor's own "
                 "registry", reason="config-push", error=repr(e))
        telemetry.REGISTRY.counter_inc("ldt_config_applies_total",
                                       result="committed")
        flightrec.emit_event("config_committed", generation=generation)
        _log("fleet: config push committed", reason="config-push",
             generation=generation, canary_port=canary,
             pushed=len(pushed), heal_pending=len(heal_pending))
        return 200, {"generation": generation, "values": updates,
                     "probation_sec": probation, "canary_port": canary,
                     "pushed": pushed, "heal_pending": heal_pending,
                     "canary": result}
    finally:
        fleet_config.push_lock.release()


def _fleet_families(snap: dict) -> list:
    """Gauge families for the fleet control plane, rendered from the
    latest snapshot (counters come from the process registry)."""
    circuit_num = {"closed": 0, "open": 1, "probe": 2}.get(
        snap.get("circuit", "closed"), 0)
    return [
        telemetry.metric_family(
            "ldt_fleet_desired",
            [("ldt_fleet_desired", None, snap.get("desired", 0))]),
        telemetry.metric_family(
            "ldt_fleet_ready",
            [("ldt_fleet_ready", None, snap.get("ready", 0))]),
        telemetry.metric_family(
            "ldt_fleet_members",
            [("ldt_fleet_members", None,
              len(snap.get("members", ())))]),
        telemetry.metric_family(
            "ldt_fleet_circuit_state",
            [("ldt_fleet_circuit_state", None, circuit_num)]),
    ]


def _member_slow_traces(metrics_port: int) -> list:
    """One member's /debug/slow ring, [] when the scrape fails (a dead
    or mid-restart member must not fail the whole merge)."""
    try:
        url = f"http://127.0.0.1:{metrics_port}/debug/slow"
        with urllib.request.urlopen(url, timeout=2.0) as r:
            return json.loads(r.read().decode()).get("traces") or []
    except Exception:  # noqa: BLE001 - merge is best-effort per member
        return []


def _member_sloz(metrics_port: int) -> "dict | None":
    """One member's /sloz document, None when the scrape fails (a dead
    or mid-restart member must not fail the fleet merge)."""
    try:
        url = f"http://127.0.0.1:{metrics_port}/sloz"
        with urllib.request.urlopen(url, timeout=2.0) as r:
            return json.loads(r.read().decode())
    except Exception:  # noqa: BLE001 - merge is best-effort per member
        return None


def _fleet_slo(snap: dict) -> dict:
    """The fleet-scoped SLO merge for /fleetz and /sloz: every live
    member's /sloz joined; per-tenant SLIs aggregate as summed counts
    and WORST (max) burn rate across members — one hot member breaching
    a tenant's budget is a breach, averaging would hide it."""
    members: list = []
    tenants: dict = {}
    alert = False
    enabled = False
    spec = None
    for mem in snap.get("members", ()):
        port = int(mem.get("metrics_port") or 0)
        if port <= 0:
            continue
        sz = _member_sloz(port)
        if not sz:
            continue
        members.append({"slot": mem.get("slot"),
                        "pid": mem.get("pid"), "sloz": sz})
        if not sz.get("enabled"):
            continue
        enabled = True
        spec = spec or sz.get("spec")
        if (sz.get("alert") or {}).get("state") == "breach":
            alert = True
        for tenant, view in (sz.get("tenants") or {}).items():
            fast = view.get("fast") or {}
            agg = tenants.setdefault(
                tenant, {"count": 0, "bad": 0, "shed": 0,
                         "burn_rate_max": 0.0, "members": 0})
            agg["count"] += fast.get("count", 0)
            agg["bad"] += fast.get("bad", 0)
            agg["shed"] += fast.get("shed", 0)
            agg["burn_rate_max"] = max(agg["burn_rate_max"],
                                       fast.get("burn_rate", 0.0))
            agg["members"] += 1
    return {"enabled": enabled, "spec": spec,
            "alert": "breach" if alert else "ok",
            "tenants": tenants, "members": members}


def _fleet_traces(snap: dict, flightrec_base: str | None) -> dict:
    """The fleet-scoped /tracez merge: every live member's slow-trace
    ring (scraped over its metrics port) joined with every recorder
    ring file under LDT_FLIGHTREC_DIR, grouped by request id. One
    request that crossed processes (HTTP front here, shm worker there)
    renders as ONE entry whose `processes` list spans them."""
    by_id: dict = {}

    def _entry(rid: str) -> dict:
        return by_id.setdefault(
            rid, {"request_id": rid, "traces": [], "events": [],
                  "processes": []})

    def _saw(e: dict, proc: str) -> None:
        if proc not in e["processes"]:
            e["processes"].append(proc)

    for mem in snap.get("members", ()):
        port = int(mem.get("metrics_port") or 0)
        if port <= 0:
            continue
        for tr in _member_slow_traces(port):
            rid = tr.get("request_id")
            if not rid:
                continue
            e = _entry(rid)
            e["traces"].append(dict(tr, slot=mem.get("slot")))
            _saw(e, f"pid:{mem.get('pid')}")
    if flightrec_base:
        import glob
        try:
            ring_files = sorted(glob.glob(
                os.path.join(flightrec_base, "**", "flightrec-*.ring"),
                recursive=True))
        except OSError:
            ring_files = []
        for path in ring_files:
            for ev in flightrec.request_events(path):
                rid = ev.get("request_id")
                if not rid:
                    continue
                e = _entry(rid)
                e["events"].append(ev)
                _saw(e, f"pid:{ev.get('pid')}")
    entries = sorted(by_id.values(),
                     key=lambda e: -(len(e["traces"]) + len(e["events"])))
    return {"requests": entries, "count": len(entries)}


def _start_status_server(port: int, status: FleetStatus,
                         flightrec_base: str | None = None,
                         fleet_config: FleetConfig | None = None):
    """GET /fleetz (JSON control-plane view: per-member slot, pid,
    generation, state — the chaos smoke picks its SIGKILL victim here),
    GET /tracez (fleet-scoped request-id merge across member slow rings
    and recorder files), GET /metrics (ldt_fleet_* exposition) and
    POST /configz (canary-then-fan-out fleet config push,
    _fleet_config_push) on a daemon thread."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
            if not self.path.startswith("/configz") \
                    or fleet_config is None:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(min(length, 65536)) if length else b""
            code, payload = _fleet_config_push(status.read(),
                                               fleet_config, raw)
            body = json.dumps(payload, indent=2).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            snap = status.read()
            if self.path.startswith("/fleetz"):
                body = json.dumps(dict(snap, slo=_fleet_slo(snap)),
                                  indent=2).encode()
                ctype = "application/json"
            elif self.path.startswith("/sloz"):
                body = json.dumps(_fleet_slo(snap), indent=2).encode()
                ctype = "application/json"
            elif self.path.startswith("/tracez"):
                body = json.dumps(
                    _fleet_traces(snap, flightrec_base),
                    indent=2).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                fams = list(telemetry.REGISTRY.families())
                fams.extend(_fleet_families(snap))
                body = telemetry.render_exposition(fams).encode()
                ctype = "text/plain; version=0.0.4"
            else:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet: fleet logs are structured
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="fleet-status")
    t.start()
    return srv


def _read_ready(path: str) -> dict:
    try:
        with open(path) as f:
            return json.loads(f.read() or "{}")
    except (OSError, ValueError):
        return {}


def _hold_listen_port() -> tuple[socket.socket, int]:
    """A free port for every member of a LISTEN_PORT=0 fleet: bound with
    SO_REUSEPORT (the members join it) and never listened on (it takes
    no connections), kept open by the caller for the fleet's life."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("0.0.0.0", 0))
    return s, s.getsockname()[1]


def fleet_main(module: str) -> int:
    """Supervise LDT_FLEET_WORKERS members of `module`. Returns the
    exit code to propagate (0 on a clean signal-initiated drain)."""
    n = knobs.get_int("LDT_FLEET_WORKERS") or 1
    fmin = min(knobs.get_int("LDT_FLEET_MIN") or n, n)
    fmax = max(knobs.get_int("LDT_FLEET_MAX") or n, n)
    health_sec = knobs.get_float("LDT_FLEET_HEALTH_SEC") or 1.0
    degraded_fails = knobs.get_int("LDT_FLEET_DEGRADED_FAILS") or 3
    backoff_base = knobs.get_float("LDT_CRASH_BACKOFF_BASE_SEC") or 0.5
    backoff_max = knobs.get_float("LDT_CRASH_BACKOFF_MAX_SEC") or 30.0
    loop_window = knobs.get_float("LDT_CRASH_LOOP_WINDOW_SEC") or 60.0
    loop_max = knobs.get_int("LDT_CRASH_LOOP_MAX") or 5
    swap_timeout = knobs.get_float("LDT_SWAP_TIMEOUT_SEC") or 30.0
    status_port = knobs.get_int("LDT_FLEET_STATUS_PORT") or 0
    listen_port = knobs.get_int("LISTEN_PORT")
    port_hold = None
    if listen_port == 0:
        port_hold, listen_port = _hold_listen_port()
    metrics_base = knobs.get_int("PROMETHEUS_PORT") or 0
    uds_base = knobs.get_str("LDT_UNIX_SOCKET")
    shm_base = knobs.get_str("LDT_SHM_DIR")
    flightrec_base = knobs.get_str("LDT_FLIGHTREC_DIR")
    capture_base = knobs.get_str("LDT_CAPTURE_DIR")
    # the fleet's own recorder lands directly under the base dir;
    # members get per-slot subdirectories (see _member_env)
    flightrec.init_from_env(role="fleet")

    control = FleetControl(
        loop_max=loop_max, loop_window=loop_window,
        cooldown_sec=(knobs.get_float("LDT_FLEET_CIRCUIT_COOLDOWN_SEC")
                      or 5.0),
        scale_hold_sec=(knobs.get_float("LDT_FLEET_SCALE_HOLD_SEC")
                        or 10.0),
        up_depth=knobs.get_int("LDT_FLEET_SCALE_UP_DEPTH") or 64,
        down_depth=knobs.get_int("LDT_FLEET_SCALE_DOWN_DEPTH") or 0)
    # one compile cache and one bundle dir for the whole fleet: SHARED
    # across slots on purpose, unlike the per-slot shm/flightrec dirs —
    # the library is content-keyed, not owner-keyed
    cache_dir, aot_dir = handed_down_dirs()

    members: list = [FleetMember(slot) for slot in range(n)]
    desired = n
    generation = 0
    probe_slot: int | None = None
    stopping = False
    swap_requested = False
    exit_rc = 0

    def _member_env(m: FleetMember, gen: int, swapped: bool = False,
                    artifact: str | None = None) -> dict:
        env = dict(os.environ)  # ldt-lint: disable=knob-direct-env -- building the child environment, not reading config
        env["LDT_WORKER_GENERATION"] = str(gen)
        env["LDT_FLEET_SLOT"] = str(m.slot)
        # members must overlap on the listen port — with each other and
        # with their own rolling-swap standbys
        env["LDT_REUSEPORT"] = "1"
        env["LISTEN_PORT"] = str(listen_port)
        env["LDT_READY_FILE"] = m.ready_file
        env["PROMETHEUS_PORT"] = \
            str(metrics_base + m.slot) if metrics_base > 0 else "0"
        if uds_base:
            env["LDT_UNIX_SOCKET"] = f"{uds_base}.{m.slot}"
        if shm_base:
            # per-member ring directory: each member's scan thread owns
            # its own rings, and a respawn re-attaches the same dir —
            # the generation bump fences whatever the dead member left
            shm_dir = os.path.join(shm_base, f"m{m.slot}")
            try:
                os.makedirs(shm_dir, exist_ok=True)
            except OSError:
                pass
            env["LDT_SHM_DIR"] = shm_dir
        if flightrec_base:
            # per-member recorder directory, same pattern as the shm
            # rings: the harvest path after a crash is deterministic —
            # <base>/m<slot>/flightrec-<pid>.ring
            fr_dir = os.path.join(flightrec_base, f"m{m.slot}")
            try:
                os.makedirs(fr_dir, exist_ok=True)
            except OSError:
                pass
            env["LDT_FLIGHTREC_DIR"] = fr_dir
        if capture_base:
            # per-member capture directory (same pattern): the merged
            # replay input is <base>/m<slot>/{segment-*.cap,*.ring}
            cap_dir = os.path.join(capture_base, f"m{m.slot}")
            try:
                os.makedirs(cap_dir, exist_ok=True)
            except OSError:
                pass
            env["LDT_CAPTURE_DIR"] = cap_dir
        _hand_down(env, cache_dir, aot_dir)
        # the fleet-shared result cache must be ONE file for every
        # member, but LDT_SHM_DIR above is per-slot — pin the path
        # explicitly so members actually share (operator value wins)
        if not knobs.get_str("LDT_SHARED_CACHE_FILE"):
            env["LDT_SHARED_CACHE_FILE"] = os.path.join(
                shm_base or tempfile.gettempdir(),
                f"ldt-shared-cache-{os.getpid()}.bin")
        if swapped:
            env["LDT_SWAPPED"] = "1"
        if artifact:
            env["LDT_ARTIFACT_PATH"] = artifact
        return env

    def _new_ready_file(slot: int, gen: int) -> str:
        path = os.path.join(
            tempfile.gettempdir(),
            f"ldt-fleet-{os.getpid()}-{slot}-{gen}.json")
        try:
            os.remove(path)
        except OSError:
            pass
        return path

    def _spawn(m: FleetMember, reason: str) -> bool:
        nonlocal generation
        generation += 1
        m.ready_file = _new_ready_file(m.slot, generation)
        try:
            if faults.ACTIVE is not None:
                faults.hit("worker_spawn")
            proc = subprocess.Popen(
                [sys.executable, "-m", module],
                env=_member_env(m, generation))
        except (faults.FaultInjected, OSError) as e:
            m.next_spawn_at = time.time() + backoff_base
            _log("fleet: member spawn failed — retrying after backoff",
                 reason="spawn-failed", slot=m.slot,
                 generation=generation, error=repr(e))
            return False
        m.proc = proc
        m.generation = generation
        m.metrics_port = 0
        m.fail_streak = 0
        m.queue_docs = 0
        m.brownout = 0
        m.config_generation = 0  # fresh process: heal re-pushes
        m.last_scrape = 0.0
        m.ready_deadline = time.time() + 2 * swap_timeout
        telemetry.REGISTRY.counter_inc("ldt_fleet_spawn_total", 1,
                                       reason=reason)
        flightrec.emit_event("fleet_member_state", slot=m.slot,
                             state="spawning", reason=reason,
                             pid=proc.pid)
        _log("fleet: member spawned", reason=reason, slot=m.slot,
             generation=generation, pid=proc.pid)
        return True

    def _stop_all(signum=None) -> None:
        for m in members:
            m.signaled = _forward_stop(m.proc, m.signaled)

    # PID-1 duty at fleet scale: any stop signal triggers a graceful
    # SIGTERM drain of every member (exactly once per process via the
    # per-member latch), so `docker stop` and Ctrl+C both exit 0 once
    # every member drains cleanly.
    def _stop_handler(signum, frame):
        nonlocal stopping
        stopping = True
        _stop_all(signum)

    signal.signal(signal.SIGTERM, _stop_handler)
    signal.signal(signal.SIGINT, _stop_handler)

    def _request_swap(signum, frame):
        nonlocal swap_requested
        swap_requested = True

    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, _request_swap)

    status = FleetStatus()
    fleet_config = FleetConfig()
    status_srv = _start_status_server(max(status_port, 0), status,
                                      flightrec_base, fleet_config) \
        if status_port != 0 else None
    if status_srv is not None:
        status_port = status_srv.server_address[1]
    postmortems: list = []  # newest-last, bounded below

    _log("fleet: starting", reason="fleet-start", workers=n,
         fleet_min=fmin, fleet_max=fmax, module=module,
         listen_port=listen_port, status_port=status_port)

    def _accepting_count() -> int:
        return sum(1 for m in members if m.accepting())

    def _backoff_for(m: FleetMember) -> float:
        b = min(backoff_base * (2 ** max(m.consec_crashes - 1, 0)),
                backoff_max)
        return b * (0.5 + random.random())  # jitter: x0.5 - x1.5

    def _harvest(m: FleetMember, pid: int | None, rc,
                 reason: str) -> None:
        """Pull the dead member's flight recorder into a postmortem:
        the crash-safe ring outlives the process, so the last events
        and the request ids still in flight survive a SIGKILL."""
        if not flightrec_base or not pid:
            return
        path = flightrec.ring_path(
            os.path.join(flightrec_base, f"m{m.slot}"), pid)
        try:
            pm = flightrec.harvest_postmortem(path, reason=reason,
                                              rc=rc)
        except (OSError, ValueError) as e:
            telemetry.REGISTRY.counter_inc("ldt_postmortem_total",
                                           result="missing")
            _log("fleet: postmortem harvest failed — no readable "
                 "recorder ring", reason="postmortem", slot=m.slot,
                 pid=pid, error=repr(e))
            return
        pm["slot"] = m.slot
        pm["generation"] = m.generation
        telemetry.REGISTRY.counter_inc("ldt_postmortem_total",
                                       result="harvested")
        flightrec.emit_event("postmortem", slot=m.slot, pid=pid,
                             rc=rc, reason=reason,
                             events_total=pm.get("events_total"),
                             inflight=len(
                                 pm.get("inflight_request_ids") or ()))
        _log("fleet: postmortem harvested", reason="postmortem",
             slot=m.slot, pid=pid, rc=rc,
             events_total=pm.get("events_total"),
             events_held=pm.get("events_held"),
             inflight_request_ids=pm.get("inflight_request_ids"))
        postmortems.append(pm)
        del postmortems[:-8]  # keep the newest 8 on /fleetz
        flightrec.discard(path)  # consumed: a respawn starts clean

    def _reap() -> None:
        nonlocal probe_slot
        for m in list(members):
            if m.proc is None:
                continue
            lost = False
            dead_pid = m.proc.pid
            rc = m.proc.poll()
            if rc is None:
                if faults.ACTIVE is not None:
                    try:
                        faults.hit("worker_lost")
                    except faults.FaultInjected:
                        # simulated silent loss: the member dies
                        # without a goodbye and the reap treats it
                        # exactly like a crash
                        m.proc.kill()
                        m.proc.wait()
                        rc = m.proc.returncode
                        lost = True
                if rc is None:
                    continue
            m.proc = None
            m.signaled = None
            now = time.time()
            if m.retiring and rc == 0:
                m.mark_dead()
                members.remove(m)
                _log("fleet: member drained for scale-down",
                     reason="scale-down-done", slot=m.slot, rc=rc)
                continue
            if rc == RECYCLE_EXIT_CODE:
                m.mark_dead()
                m.consec_crashes = 0
                m.next_spawn_at = 0.0
                _log("fleet: member recycled", reason="recycle",
                     slot=m.slot, rc=rc, generation=m.generation)
                continue
            if rc == 0:
                # unplanned-but-clean exit: respawn without crash
                # accounting (a drain we did not order, e.g. an
                # operator SIGTERMing one member by hand)
                m.mark_dead()
                m.next_spawn_at = 0.0
                _log("fleet: member exited cleanly — respawning",
                     reason="clean-exit", slot=m.slot, rc=rc)
                continue
            # crash
            m.mark_dead()
            crash_kind = "lost" if lost else "crash"
            flightrec.emit_event("fleet_member_state", slot=m.slot,
                                 state="dead", reason=crash_kind,
                                 rc=rc)
            _harvest(m, dead_pid, rc, crash_kind)
            accepting = _accepting_count()
            m.crash_times = [t for t in m.crash_times
                             if now - t <= loop_window]
            m.crash_times.append(now)
            m.consec_crashes += 1
            telemetry.REGISTRY.counter_inc(
                "ldt_fleet_worker_lost_total", 1,
                reason=crash_kind)
            if m.retiring:
                # the scale-down victim crashed instead of draining:
                # its slot is already surplus, so drop it
                members.remove(m)
                _log("fleet: retiring member crashed — removed",
                     reason="scale-down-done", slot=m.slot, rc=rc)
                continue
            if len(m.crash_times) >= loop_max:
                m.parked = True
                _log("fleet: member crash-loop — parked",
                     reason="crash-loop", slot=m.slot, rc=rc,
                     crashes=len(m.crash_times),
                     window_sec=loop_window)
            m.next_spawn_at = now + _backoff_for(m)
            if probe_slot == m.slot:
                probe_slot = None
                control.probe_failed(now)
                _log("fleet: probe member died — circuit re-opened",
                     reason="fleet-circuit-reopen", slot=m.slot, rc=rc)
            elif control.record_crash(now, accepting):
                _log("fleet: correlated crash — fleet circuit open",
                     reason="fleet-circuit-open", slot=m.slot, rc=rc,
                     crashes_in_window=len(control.crash_times),
                     accepting=accepting)
            else:
                _log("fleet: member crashed — respawn after backoff",
                     reason="crash", slot=m.slot, rc=rc,
                     consecutive_crashes=m.consec_crashes)

    def _probe_step(now: float) -> None:
        nonlocal probe_slot
        if not control.probe_due(now):
            return
        control.begin_probe()
        if _accepting_count() > 0:
            # capacity survived the correlated crash: no probe spawn
            # needed, resume normal restarts
            control.probe_ok()
            _log("fleet: circuit closed — capacity held through "
                 "cooldown", reason="fleet-circuit-close")
            return
        cand = next((m for m in members
                     if m.state == FLEET_DEAD and not m.parked
                     and not m.retiring), None)
        if cand is None:
            control.probe_failed(now)
            _log("fleet: no probe candidate (all members parked) — "
                 "operator action required",
                 reason="fleet-circuit-stuck")
            return
        probe_slot = cand.slot
        cand.next_spawn_at = 0.0
        _log("fleet: spawning half-open probe member",
             reason="fleet-probe", slot=cand.slot)

    def _spawn_step(now: float) -> None:
        for m in members:
            if m.proc is not None or m.parked or m.retiring:
                continue
            if control.circuit != CIRCUIT_CLOSED \
                    and m.slot != probe_slot:
                continue
            if now < m.next_spawn_at:
                continue
            if m.state == FLEET_DEAD:
                m.mark_restarting()
            reason = "probe" if m.slot == probe_slot else (
                "initial" if m.generation == 0 else "restart")
            if _spawn(m, reason):
                m.mark_spawning()

    def _config_heal(m: FleetMember) -> None:
        """Converge a drifted member (respawned after a crash, or one
        the fan-out missed) onto the fleet-committed config: re-push
        the committed batch with no probation and the committed
        generation stamp. The fleet's view wins — a member whose local
        generation ran ahead through direct pushes is pulled back."""
        fgen, fvalues = fleet_config.read()
        if fgen <= 0 or m.config_generation == fgen or not fvalues:
            return
        try:
            st, _resp = _member_configz(
                m.metrics_port,
                {"set": fvalues, "probation_sec": 0, "generation": fgen})
        except Exception as e:  # noqa: BLE001 - retried next scrape
            _log("fleet: config heal push failed",
                 reason="config-heal", slot=m.slot, error=repr(e))
            return
        if st == 200:
            m.config_generation = fgen
            telemetry.REGISTRY.counter_inc(
                "ldt_fleet_config_heal_total", 1)
            _log("fleet: member healed onto committed config",
                 reason="config-heal", slot=m.slot, generation=fgen)
        else:
            # e.g. 409: the member has its own probation in flight —
            # the next health scrape retries
            _log("fleet: config heal refused", reason="config-heal",
                 slot=m.slot, status=st)

    knob_version = knobs.overrides_version()

    def _refresh_control_knobs() -> None:
        """The autoscale thresholds are mutable knobs: re-derive the
        FleetControl fields when a committed push bumped the override
        version (one int compare per loop otherwise)."""
        nonlocal knob_version
        v = knobs.overrides_version()
        if v == knob_version:
            return
        knob_version = v
        control.scale_hold_sec = (
            knobs.get_float("LDT_FLEET_SCALE_HOLD_SEC") or 10.0)
        control.up_depth = knobs.get_int("LDT_FLEET_SCALE_UP_DEPTH") or 64
        control.down_depth = (
            knobs.get_int("LDT_FLEET_SCALE_DOWN_DEPTH") or 0)
        _log("fleet: autoscale knobs refreshed from committed config",
             reason="config-push", up_depth=control.up_depth,
             down_depth=control.down_depth,
             scale_hold_sec=control.scale_hold_sec)

    def _health_step(now: float) -> None:
        nonlocal probe_slot
        for m in members:
            if m.proc is None:
                continue
            if m.state == FLEET_SPAWNING:
                if os.path.exists(m.ready_file):
                    info = _read_ready(m.ready_file)
                    m.metrics_port = int(info.get("metrics_port") or 0)
                    m.mark_ready()
                    m.fail_streak = 0
                    control.bootstrapped = True
                    if probe_slot == m.slot:
                        probe_slot = None
                        control.probe_ok()
                        _log("fleet: probe member ready — circuit "
                             "closed", reason="fleet-circuit-close",
                             slot=m.slot)
                    flightrec.emit_event("fleet_member_state",
                                         slot=m.slot, state="ready")
                    _log("fleet: member ready", reason="ready",
                         slot=m.slot, generation=m.generation,
                         metrics_port=m.metrics_port)
                elif now > m.ready_deadline:
                    _log("fleet: member never became ready — killing",
                         reason="ready-timeout", slot=m.slot,
                         generation=m.generation)
                    m.proc.kill()  # the reap treats it as a crash
                continue
            if m.metrics_port <= 0:
                continue  # liveness-only member (no metrics listener)
            if now - m.last_scrape < health_sec:
                continue
            m.last_scrape = now
            ok = True
            try:
                if faults.ACTIVE is not None:
                    faults.hit("fleet_route")
                url = (f"http://127.0.0.1:{m.metrics_port}"
                       f"/debug/vars")
                with urllib.request.urlopen(url, timeout=2.0) as r:
                    d = json.loads(r.read().decode())
                adm = d.get("admission") or {}
                m.queue_docs = int(adm.get("queue_docs") or 0)
                m.brownout = int(adm.get("brownout_level") or 0)
                cfg = d.get("config") or {}
                m.config_generation = int(cfg.get("generation") or 0)
                rd = d.get("ready")
                if isinstance(rd, dict) and rd.get("ready") is False:
                    ok = False
            except Exception:
                ok = False
            if ok:
                if m.fail_streak:
                    _log("fleet: member healthy again", reason="ready",
                         slot=m.slot, fails=m.fail_streak)
                m.fail_streak = 0
                m.mark_ready()
                _config_heal(m)
            else:
                m.fail_streak += 1
                if m.fail_streak == degraded_fails:
                    flightrec.emit_event("fleet_member_state",
                                         slot=m.slot, state="degraded",
                                         fails=m.fail_streak)
                    _log("fleet: member degraded — health scrapes "
                         "failing", reason="degraded", slot=m.slot,
                         fails=m.fail_streak)
                if m.fail_streak >= degraded_fails:
                    m.mark_degraded()
                if m.fail_streak >= 3 * degraded_fails:
                    _log("fleet: member unresponsive — killing for "
                         "restart", reason="health-kill", slot=m.slot,
                         fails=m.fail_streak)
                    m.proc.kill()  # the reap respawns it

    def _roll_one(m: FleetMember, artifact: str | None) -> bool:
        """Blue/green one slot: warmed standby up, old drained, standby
        promoted in place. False aborts the remaining rolls."""
        nonlocal generation
        try:
            if faults.ACTIVE is not None:
                faults.hit("standby_spawn")
        except faults.FaultInjected as e:
            _log("fleet: roll aborted — injected fault",
                 reason="swap-abort", slot=m.slot, error=repr(e))
            return False
        generation += 1
        gen = generation
        ready_file = _new_ready_file(m.slot, gen)
        old_ready_file, m.ready_file = m.ready_file, ready_file
        standby = subprocess.Popen(
            [sys.executable, "-m", module],
            env=_member_env(m, gen, swapped=True, artifact=artifact))
        m.ready_file = old_ready_file
        telemetry.REGISTRY.counter_inc("ldt_fleet_spawn_total", 1,
                                       reason="swap")
        deadline = time.time() + swap_timeout
        ready = False
        while time.time() < deadline:
            if standby.poll() is not None:
                _log("fleet: roll aborted — standby died before ready",
                     reason="swap-abort", slot=m.slot,
                     rc=standby.returncode, standby_generation=gen)
                return False
            if os.path.exists(ready_file):
                ready = True
                break
            # ready check FIRST: a stop racing the handshake must not
            # abort a standby that already landed its ready file — the
            # promote completes and the drain loop stops the promoted
            # process (supervisor.py established the ordering)
            if stopping:
                break
            time.sleep(0.05)
        if not ready:
            standby.kill()
            standby.wait()
            _log("fleet: roll aborted — standby not ready in time",
                 reason="swap-abort", slot=m.slot,
                 standby_generation=gen, timeout_sec=swap_timeout)
            return False
        old = m.proc
        _log("fleet: roll cutover — draining old generation",
             reason="swap", slot=m.slot, generation=m.generation,
             standby_generation=gen)
        m.signaled = _forward_stop(old, m.signaled)
        try:
            old.wait(timeout=swap_timeout)
        except subprocess.TimeoutExpired:
            old.kill()
            old.wait()
        m.proc = standby
        m.generation = gen
        m.ready_file = ready_file
        m.metrics_port = int(_read_ready(ready_file)
                             .get("metrics_port") or 0)
        m.last_scrape = 0.0
        m.fail_streak = 0
        m.config_generation = 0  # promoted process: heal re-pushes
        _log("fleet: roll complete", reason="swap", slot=m.slot,
             generation=gen)
        return True

    def _rolling_swap() -> None:
        artifact = None
        pointer = knobs.get_str("LDT_ARTIFACT_POINTER")
        if pointer:
            try:
                with open(pointer) as f:
                    artifact = f.read().strip()
            except OSError as e:
                _log("fleet: rolling swap aborted — artifact pointer "
                     "unreadable", reason="swap-abort", pointer=pointer,
                     error=repr(e))
                return
        _log("fleet: rolling swap starting", reason="swap",
             members=len(members))
        for m in sorted(members, key=lambda x: x.slot):
            if stopping:
                _log("fleet: rolling swap stopped by signal",
                     reason="swap-abort", slot=m.slot)
                return
            if m.retiring or m.parked or m.proc is None:
                continue
            # the never-below-N-1-ready invariant: a roll only starts
            # while every OTHER active member is READY, so the one
            # draining slot is the only capacity briefly in flux
            others_ready = all(
                x.state == FLEET_READY for x in members
                if x is not m and not x.retiring and not x.parked)
            if m.state != FLEET_READY or not others_ready:
                _log("fleet: rolling swap aborted — fleet not fully "
                     "ready", reason="swap-abort", slot=m.slot,
                     state=STATE_NAMES.get(m.state))
                return
            if not _roll_one(m, artifact):
                return
            _reap()  # a member death during the roll heals before the
            _health_step(time.time())  # next roll's precondition check
        _log("fleet: rolling swap complete", reason="swap",
             members=len(members))

    def _autoscale_step(now: float) -> None:
        nonlocal desired
        ready = [m for m in members if m.state == FLEET_READY]
        depth = max((m.queue_docs for m in ready), default=0)
        brown = max((m.brownout for m in ready), default=0)
        delta = control.scale_delta(now, depth, brown)
        if delta > 0 and desired < fmax \
                and control.circuit == CIRCUIT_CLOSED:
            desired += 1
            slot = max((m.slot for m in members), default=-1) + 1
            members.append(FleetMember(slot))
            telemetry.REGISTRY.counter_inc("ldt_fleet_scale_total", 1,
                                           direction="up")
            _log("fleet: scaling up", reason="scale-up", slot=slot,
                 desired=desired, queue_docs=depth, brownout=brown)
        elif delta < 0 and desired > fmin:
            victim = next(
                (m for m in sorted(members, key=lambda x: -x.slot)
                 if m.state == FLEET_READY and not m.retiring), None)
            if victim is not None:
                desired -= 1
                victim.retiring = True
                # zero-drop shrink: the ordinary graceful drain (stop
                # accepting, flush in-flight, exit 0) — the reap
                # removes the member once it exits clean
                victim.signaled = _forward_stop(victim.proc,
                                                victim.signaled)
                telemetry.REGISTRY.counter_inc("ldt_fleet_scale_total",
                                               1, direction="down")
                _log("fleet: scaling down — draining member",
                     reason="scale-down", slot=victim.slot,
                     desired=desired, queue_docs=depth)

    def _snapshot() -> dict:
        fgen, fvalues = fleet_config.read()
        return {
            "listen_port": listen_port,
            "members": [
                {"slot": m.slot,
                 "pid": m.proc.pid if m.proc is not None else None,
                 "generation": m.generation,
                 "state": STATE_NAMES.get(m.state, "?"),
                 "metrics_port": m.metrics_port,
                 "queue_docs": m.queue_docs,
                 "brownout": m.brownout,
                 "config_generation": m.config_generation,
                 "parked": m.parked,
                 "retiring": m.retiring}
                for m in sorted(members, key=lambda x: x.slot)],
            "config": {"generation": fgen, "values": fvalues},
            "desired": desired,
            "ready": sum(1 for m in members
                         if m.state == FLEET_READY),
            "accepting": _accepting_count(),
            "circuit": CIRCUIT_NAMES.get(control.circuit, "?"),
            "bootstrapped": control.bootstrapped,
            "postmortems": list(postmortems),
        }

    def _drain_all() -> int:
        _stop_all()
        rc = 0
        for m in members:
            if m.proc is None:
                continue
            m.signaled = _forward_stop(m.proc, m.signaled)
            try:
                r = m.proc.wait(timeout=swap_timeout)
            except subprocess.TimeoutExpired:
                m.proc.kill()
                r = m.proc.wait()
            m.mark_dead()
            if r not in (0, None) and rc == 0:
                rc = r
            _log("fleet: member stopped", reason="signal", slot=m.slot,
                 rc=r)
        _log("fleet: stopped — propagating", reason="signal", rc=rc)
        return rc

    try:
        while True:
            if stopping:
                exit_rc = _drain_all()
                return exit_rc
            now = time.time()
            _reap()
            if stopping:
                continue
            _probe_step(now)
            _spawn_step(now)
            _health_step(now)
            if swap_requested:
                swap_requested = False
                _rolling_swap()
            _refresh_control_knobs()
            _autoscale_step(now)
            status.update(_snapshot())
            try:
                time.sleep(0.05)
            except KeyboardInterrupt:  # Ctrl+C raced the handler
                continue
    finally:
        if status_srv is not None:
            status_srv.shutdown()
        if port_hold is not None:
            port_hold.close()
