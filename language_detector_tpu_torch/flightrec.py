"""Crash-safe flight recorder: a per-process mmap'd bounded ring of
typed structured events that stays readable after SIGKILL.

The slow-trace ring, breaker history, and admission counters all live
in process memory — a member that dies hard takes its last minutes of
history to the grave. This module writes the same story into a small
mmap'd file with the publish-order header discipline proven in
service/shmring.py: every record's payload and length land in the map
BEFORE the 4-byte commit word (the record's sequence number) is
stored, so a reader — the fleet supervisor harvesting a postmortem, or
/tracez merging recorder tails — never observes a torn-but-published
record. The one record in flight at the moment of death has a stale
commit word and a possibly half-written payload; the reader's JSON
parse rejects it (documented reader contract, not a checksum).

File layout (little-endian):

    FILE_HDR   magic "LDFR", version, slot_count, slot_bytes, pid,
               start_ts
    slot[i]    SLOT_HDR (commit seq u32, payload length u32, ts f64)
               + payload (compact JSON: {"ev": <name>, ...fields})

seq starts at 1 and increments per event; slot index = (seq-1) %
slot_count, so the ring holds the newest slot_count events and
`events_total` (the max committed seq) survives eviction.

Event types are DECLARED in the EVENTS registry below — same contract
as telemetry.METRICS / knobs / faults: an event emitted in code but
not declared, declared but never emitted, or missing from the event
table in docs/OBSERVABILITY.md fails `python -m tools.lint` (the
event-registry analyzer). Emitting an undeclared name raises KeyError
at the call site.

Enabled by LDT_FLIGHTREC_DIR (unset = every emit is one attribute
check, the faults.ACTIVE cost contract); the fleet supervisor points
each member at its own subdirectory and harvests
`flightrec-<pid>.ring` when the member dies.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
import time
from pathlib import Path

from . import knobs
from .locks import make_lock

MAGIC = b"LDFR"
VERSION = 1

FILE_HDR = struct.Struct("<4sIIIId")   # magic, version, slots,
#                                        slot_bytes, pid, start_ts
SLOT_HDR = struct.Struct("<IId")       # commit seq, payload len, ts

# pinned on-disk geometry: a drive-by field edit must fail at import,
# not corrupt rings at runtime (tools/lint/layout_registry.py declares
# the same widths; layout-drift keeps module and registry in sync)
assert FILE_HDR.size == 28
assert SLOT_HDR.size == 16

# Declared event types: name -> (category, operator-facing doc). The
# event-registry analyzer (tools/lint/event_registry.py) keeps this
# dict, the emit_event call sites, and the event table in
# docs/OBSERVABILITY.md from drifting — both ways.
EVENTS: dict = {
    "proc_start": (
        "lifecycle",
        "Recorder armed: process pid, role, and generation."),
    "proc_exit": (
        "lifecycle",
        "Front shutting down cleanly (planned drain/recycle); absent "
        "from a postmortem tail = the process died hard."),
    "request_start": (
        "request",
        "A request entered a front or ingest lane, with its request "
        "id and lane."),
    "request_end": (
        "request",
        "telemetry.finish_request: status, total ms, request id — "
        "start ids without a matching end are the in-flight set a "
        "postmortem recovers."),
    "slow_trace": (
        "request",
        "A span tree was recorded into the slow ring (threshold or "
        "reason:error capture)."),
    "breaker_state": (
        "transition",
        "Device circuit breaker state change (service/admission.py)."),
    "brownout_level": (
        "transition",
        "Brownout ladder level change (service/admission.py)."),
    "pool_lane_state": (
        "transition",
        "Device-pool lane evicted from / re-admitted to rotation "
        "(parallel/pool.py)."),
    "fleet_member_state": (
        "transition",
        "Fleet member lifecycle edge seen by the control plane: "
        "spawned, ready, crashed (service/fleet.py)."),
    "shm_ring_state": (
        "transition",
        "Shm ingest lane edge: ring attached, ring unlinked, doc "
        "quarantined (service/shmring.py)."),
    "fault_fired": (
        "fault",
        "An injected fault actually fired at a seam "
        "(language_detector_tpu_torch/faults.py)."),
    "integrity_detected": (
        "fault",
        "Data corruption detected: a lane's device-table digest or "
        "canary deviated, or a frame payload failed its CRC "
        "(integrity.py; kind + lane/request attribution)."),
    "integrity_healed": (
        "transition",
        "A quarantined CORRUPT lane healed: fresh tables re-uploaded "
        "and verified, lane re-admitted as a half-open probe "
        "(integrity.py)."),
    "slo_breach": (
        "transition",
        "An SLO error-budget burn-rate alert fired: both the fast and "
        "slow windows are burning budget faster than allowed "
        "(slo.py; scope fleet or tenant, burn rates attached)."),
    "slo_recovered": (
        "transition",
        "A firing SLO burn-rate alert cleared: the fast window's burn "
        "rate dropped back under 1.0 (slo.py)."),
    "config_staged": (
        "transition",
        "A runtime config batch passed registry validation and was "
        "staged for apply (configplane.py; generation + knob names "
        "attached)."),
    "config_applied": (
        "transition",
        "A staged config batch went live under SLO probation "
        "(configplane.py; the generation serves but is not yet "
        "committed)."),
    "config_committed": (
        "transition",
        "A config generation survived its probation window and "
        "committed (configplane.py)."),
    "config_rolled_back": (
        "transition",
        "A config generation was auto-rolled-back: the SLO fast-window "
        "burn rate crossed 1.0 during probation, or an operator "
        "reverted it — the prior overrides are restored "
        "(configplane.py)."),
    "postmortem": (
        "lifecycle",
        "A dead member's recorder was harvested into postmortem JSON "
        "(fleet/worker supervisor)."),
    "profile_capture": (
        "profiling",
        "On-demand device-profiler window armed or completed "
        "(POST /profilez, SIGUSR2)."),
}


class FlightRecorder:
    """One process's mmap'd event ring (single writer, any readers)."""

    def __init__(self, path: str, slots: int | None = None,
                 slot_bytes: int | None = None):
        if slots is None:
            slots = knobs.get_int("LDT_FLIGHTREC_SLOTS") or 256
        if slot_bytes is None:
            slot_bytes = knobs.get_int("LDT_FLIGHTREC_SLOT_BYTES") \
                or 512
        self.path = str(path)
        self.slots = max(int(slots), 8)
        self.slot_bytes = max(int(slot_bytes), SLOT_HDR.size + 64)
        self._seq = 0
        self._dropped = 0
        self._lock = make_lock("flightrec.ring")
        size = FILE_HDR.size + self.slots * self.slot_bytes
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR | os.O_TRUNC,
                     0o644)
        try:
            os.ftruncate(fd, size)
            self.mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.mm[:FILE_HDR.size] = FILE_HDR.pack(
            MAGIC, VERSION, self.slots, self.slot_bytes, os.getpid(),
            time.time())

    def emit(self, name: str, fields: dict) -> bool:
        """Write one event. Publish order: zero the slot's commit
        word (a wrapped slot holds the previous lap's committed
        record), then payload + header tail, then the 4-byte
        commit/seq word LAST — its store is the publication point, so
        a reader (even of a SIGKILLed writer's file) never sees a
        committed-but-torn record."""
        payload = json.dumps({"ev": name, **fields},
                             separators=(",", ":"),
                             default=str).encode("utf-8")
        cap = self.slot_bytes - SLOT_HDR.size
        if len(payload) > cap:
            with self._lock:
                self._dropped += 1
            from . import telemetry
            telemetry.REGISTRY.counter_inc(
                "ldt_flightrec_dropped_total")
            return False
        with self._lock:
            self._seq += 1
            seq = self._seq
            off = FILE_HDR.size + ((seq - 1) % self.slots) \
                * self.slot_bytes
            rec = SLOT_HDR.pack(seq & 0xFFFFFFFF, len(payload),
                                time.time())
            mm = self.mm
            # after the first lap this slot still holds a COMMITTED
            # record: zero its seq word before touching the tail or
            # payload, or a crash mid-rewrite leaves the OLD seq
            # presiding over NEW length/payload bytes — a torn record
            # a reader would accept
            mm[off:off + 4] = b"\0\0\0\0"
            mm[off + 4:off + SLOT_HDR.size] = rec[4:]
            mm[off + SLOT_HDR.size:off + SLOT_HDR.size + len(payload)] \
                = payload
            mm[off:off + 4] = rec[:4]
        return True

    def stats(self) -> dict:
        with self._lock:
            return {"path": self.path, "slots": self.slots,
                    "slot_bytes": self.slot_bytes,
                    "events_total": self._seq,
                    "dropped": self._dropped}

    def close(self) -> None:
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass


# Module-level recorder: None = disabled (the fast-path check). Armed
# by init_from_env() at front startup; rebound atomically, never
# mutated in place.
RECORDER: FlightRecorder | None = None


def ring_path(directory: str, pid: int | None = None) -> str:
    """Recorder file path for a pid inside a flightrec directory — the
    naming contract the fleet's postmortem harvest relies on."""
    return os.path.join(directory, f"flightrec-{pid or os.getpid()}"
                                   ".ring")


def init_from_env(role: str = "worker") -> FlightRecorder | None:
    """Arm the process recorder from LDT_FLIGHTREC_DIR (unset = stay
    disabled). Called by both fronts' startup and by the fleet
    supervisor itself; idempotent per process."""
    global RECORDER
    if RECORDER is not None:
        return RECORDER
    directory = knobs.get_str("LDT_FLIGHTREC_DIR")
    if not directory:
        return None
    try:
        os.makedirs(directory, exist_ok=True)
        rec = FlightRecorder(ring_path(directory))
    except OSError as e:
        # best-effort observability, never a startup fail — but a
        # counted, logged disable (a full disk silently eating the
        # postmortem recorder is how outages lose their evidence)
        import errno

        from . import telemetry
        reason = "enospc" if e.errno == errno.ENOSPC else "oserror"
        telemetry.REGISTRY.counter_inc("ldt_flightrec_disabled_total",
                                       reason=reason)
        print(json.dumps({"msg": "flightrec disabled",
                          "reason": reason, "dir": directory,
                          "detail": repr(e)}), flush=True)
        return None
    RECORDER = rec
    emit_event("proc_start", role=role,
               generation=knobs.get_int("LDT_WORKER_GENERATION") or 0)
    return rec


def emit_event(name: str, **fields) -> bool:
    """Record one typed event into the process recorder. No-op (one
    attribute check + dict membership) when the recorder is off; an
    undeclared event name is a programming error (KeyError), exactly
    like an undeclared knob or fault point."""
    if name not in EVENTS:
        raise KeyError(f"undeclared flight-recorder event {name!r}; "
                       "declare it in language_detector_tpu_torch/"
                       "flightrec.py EVENTS")
    rec = RECORDER
    if rec is None:
        return False
    ok = rec.emit(name, {k: v for k, v in fields.items()
                         if v is not None})
    if ok:
        from . import telemetry
        telemetry.REGISTRY.counter_inc("ldt_flightrec_events_total")
    return ok


def stats() -> dict | None:
    rec = RECORDER
    return rec.stats() if rec is not None else None


# -- readers (harvest / /tracez merge) --------------------------------------


def read_ring(path: str) -> dict:
    """Parse a recorder file — live or left by a dead process — into
    {pid, start_ts, events_total, events: [...]}. Records whose commit
    word is set but whose payload fails to parse (the one write that
    can be in flight at SIGKILL) are skipped, not fatal."""
    data = Path(path).read_bytes()
    if len(data) < FILE_HDR.size:
        raise ValueError(f"{path}: truncated flight-recorder file")
    magic, version, slots, slot_bytes, pid, start_ts = \
        FILE_HDR.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: bad magic {magic!r}")
    if version != VERSION:
        raise ValueError(f"{path}: recorder version {version} "
                         f"(reader speaks {VERSION})")
    events: list = []
    top = 0
    for i in range(slots):
        off = FILE_HDR.size + i * slot_bytes
        if off + SLOT_HDR.size > len(data):
            break
        seq, length, ts = SLOT_HDR.unpack_from(data, off)
        if seq == 0 or length > slot_bytes - SLOT_HDR.size:
            continue
        raw = data[off + SLOT_HDR.size:off + SLOT_HDR.size + length]
        try:
            doc = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            continue  # torn in-flight write at death: reject, move on
        if not isinstance(doc, dict) or "ev" not in doc:
            continue
        doc["seq"] = seq
        doc["ts"] = ts
        events.append(doc)
        top = max(top, seq)
    events.sort(key=lambda e: e["seq"])
    return {"pid": pid, "start_ts": start_ts, "events_total": top,
            "events": events}


def harvest_postmortem(path: str, reason: str = "crash",
                       rc: int | None = None,
                       tail_events: int = 32) -> dict:
    """Read a dead process's recorder into postmortem JSON: event
    counts, the tail, and the request ids that were in flight (a
    request_start without a matching request_end) when it died."""
    info = read_ring(path)
    events = info["events"]
    started = [e.get("request_id") for e in events
               if e["ev"] == "request_start" and e.get("request_id")]
    ended = {e.get("request_id") for e in events
             if e["ev"] == "request_end"}
    inflight = sorted({r for r in started if r not in ended})
    return {
        "pid": info["pid"],
        "start_ts": info["start_ts"],
        "reason": reason,
        "rc": rc,
        "clean_exit": any(e["ev"] == "proc_exit" for e in events),
        "events_total": info["events_total"],
        "events_held": len(events),
        "inflight_request_ids": inflight,
        "tail": events[-tail_events:],
    }


def request_events(path: str) -> list:
    """Request-scoped recorder events (for the /tracez merge): every
    event carrying a request_id, in commit order, tagged with the
    writing process's pid so the merge can attribute them."""
    try:
        info = read_ring(path)
    except (OSError, ValueError):
        return []
    return [dict(e, pid=info["pid"])
            for e in info["events"] if e.get("request_id")]


def discard(path: str) -> None:
    """Remove a harvested (or stale) recorder file; missing is fine."""
    try:
        os.remove(path)
    except OSError:
        pass
