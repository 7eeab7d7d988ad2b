"""Crash-safe shared-memory ring ingest lane (LDT_SHM_DIR).

The zero-serialization twin of the unix-socket frame lane: a co-located
client writes request bodies straight into a mmap'd, length-prefixed
SPSC ring file and the worker parses them *in place* (the wire fast
scanner slices doc strings directly off the shared mapping — the frame
bytes are never copied into a per-request buffer, so leased frames feed
the pack staging rings with no host-side copy). A ring is shared with
an untrusted client process, which makes this above all a robustness
problem; the protocol is built so that no client crash, worker crash,
fleet roll, or malformed frame can wedge a slot:

  - Slot lifecycle FREE -> WRITING -> READY -> LEASED -> DONE (machine
    "shm-slot" in tools/lint/fsm_registry.py; RingSlot below is the
    in-process mirror whose guarded writes the conformance pass proves
    against the table, and the `ring-reclaim` model-check product
    drives client-crash x worker-crash x generation-bump interleavings
    over it).
  - Generation fencing: the worker bumps the ring header's generation
    on every attach, and clients stamp each frame with the generation
    they observed. A restarted worker (or a fleet roll re-attaching a
    member's ring directory) fails every stale READY/LEASED frame back
    to the client with an explicit error frame — never a hang.
  - Lease reclaim: every slot state carries the writer's PID and a
    lease timestamp. A client killed mid-WRITING is reclaimed to FREE
    once its PID is gone or LDT_SHM_LEASE_TIMEOUT_SEC elapses; a DONE
    frame whose client never returned is reclaimed the same way, and a
    fully-FREE ring with a dead client is unlinked.
  - Poison-frame quarantine: a frame whose docs deterministically kill
    a scorer batch is bisected down to the exact poison docs, which are
    quarantined (answered "un", skipped on re-submission) instead of
    burning pool redispatch budget — `ldt_quarantine_*` series and
    /debug/vars "quarantine".

File layout (little-endian, one page of headers + page-aligned slots so
each slot payload can be mapped at offset 0 of its own mmap):

  0     ring header:  u32 magic "LDSR", u32 version, u32 generation,
                      u32 nslots, u32 client_pid, u32 worker_pid,
                      u64 slot_bytes
  64+i*64  slot i header: u32 state, u32 generation, u32 owner_pid,
                      u32 reserved, f64 lease_ts, u32 length,
                      u32 status; at byte 32 of the 64-byte header
                      region, u32 crc32(payload) when LDT_WIRE_CRC
                      is set on both sides (zero otherwise)
  4096+i*slot_bytes  slot i payload (request body in READY, response
                      body in DONE — same JSON contract as the UDS
                      frame lane, byte-identical responses)

Fault points: shm_attach (worker ring attach), shm_lease (frame lease),
shm_reclaim (reclaim/fence sweep), poison_doc (scorer-kill seam for the
quarantine drills). Run a client via RingClient; both fronts start a
ShmRingServer when LDT_SHM_DIR is set, and fleet.py gives each member
its own ring directory under it.

This is the port's copy of the reference package's ring lane. The file
layout, the slot headers and the CRC word are the reference's byte for
byte, so a client of either package is served by a server of either
package. Frames score through the port's DetectorService (on the card,
the port's engine and its fused-tote kernel). One departure: the
port's device service has no scalar engine to fall back on, so a
device failure reaches this lane. Only a failure that a document can
cause deterministically is bisected: the poison_doc seam's fault, or
the host side refusing a document's text (ValueError, UnicodeError and
the like). A RuntimeError (the open breaker's DeviceUnavailable, a
torch CUDA launch, out-of-memory or readback error, the kernel
wrapper's launch error, a fault at a device seam) or an OSError is the
device's, fails every half alike, and answers the frame 503
(DeviceFailed) without quarantining a document.
"""
from __future__ import annotations

import hashlib
import json
import mmap
import os
import random
import struct
import threading
import time
import zlib
from concurrent.futures import TimeoutError as FuturesTimeout

from .. import faults, flightrec, knobs, telemetry
from ..locks import make_lock
from . import wire
from .admission import DeadlineExceeded, DeviceUnavailable

# the scorer's refusals and failures that are not a poison batch:
# re-raised, never bisected (a wedged, expired, shed or failing device
# fails every half alike). DeviceUnavailable and torch's CUDA errors
# are RuntimeErrors, TimeoutError is an OSError
_NOT_POISON = (DeadlineExceeded, FuturesTimeout, RuntimeError, OSError)
# ... of which the fronts answer these as they are (504 / 503), and
# the rest as DeviceFailed
_ANSWERED = (DeadlineExceeded, DeviceUnavailable, TimeoutError,
             FuturesTimeout)


class _PoisonBatch(Exception):
    """The poison_doc seam fired on a batch: its FaultInjected is a
    RuntimeError, and this is the one such error a document causes."""


class DeviceFailed(DeviceUnavailable):
    """A flush the device failed, as the ring lane answers it: 503 like
    an open breaker (the client retries; the breaker has counted the
    failure), never a bisection."""

    body = b'{"error":"device unavailable: flush failed"}'

    def __init__(self, cause: BaseException):
        RuntimeError.__init__(self, f"device flush failed: {cause!r}")
        self.retry_after = 1


def _device_failed(e: BaseException) -> DeviceFailed:
    """A device failure as the lane raises it (logged, answered 503)."""
    print(json.dumps({"msg": "shm frame: device flush failed",
                      "error": repr(e)}), flush=True)
    return DeviceFailed(e)

RING_MAGIC = 0x5253444C          # "LDSR"
RING_VERSION = 1
HEADER_PAGE = 4096               # ring + slot headers live in page 0
SLOT_HDR_OFF = 64                # first slot header
SLOT_HDR_SIZE = 64
MAX_SLOTS = (HEADER_PAGE - SLOT_HDR_OFF) // SLOT_HDR_SIZE
_PAGE = mmap.ALLOCATIONGRANULARITY or 4096

RING_HDR = struct.Struct("<IIIIII Q")    # magic, version, generation,
#                                          nslots, client_pid,
#                                          worker_pid, slot_bytes
SLOT_HDR = struct.Struct("<IIII d II")   # state, generation, owner_pid,
#                                          reserved, lease_ts, length,
#                                          status

# pinned shm geometry: a drive-by field edit must fail at import, not
# tear slots under every attached peer
# (tools/lint/layout_registry.py declares the same widths)
assert RING_HDR.size == 32
assert SLOT_HDR.size == 32

# Slot lifecycle states, declared in tools/lint/fsm_registry.py
# (machine "shm-slot"): RingSlot.state only moves through the guarded
# mark_* methods below, so the conformance pass proves every write
# against the declared table, and the `ring-reclaim` model-check
# product explores the crash/fence interleavings over the same class.
SLOT_FREE = 0     # unowned, reusable
SLOT_WRITING = 1  # client mid-write (owner_pid = client)
SLOT_READY = 2    # frame committed, waiting for a lease
SLOT_LEASED = 3   # worker scoring the frame (owner_pid = worker)
SLOT_DONE = 4     # response (or error frame) written, client to consume

SLOT_STATE_NAMES = {SLOT_FREE: "free", SLOT_WRITING: "writing",
                    SLOT_READY: "ready", SLOT_LEASED: "leased",
                    SLOT_DONE: "done"}

# explicit error frames (the fail-back contract: a fenced or orphaned
# frame always answers, never hangs the client)
FENCED_BODY = json.dumps(
    {"error": "shm ring fenced: worker generation changed mid-frame; "
              "resubmit"}).encode()
RESP_OVERFLOW_BODY = json.dumps(
    {"error": "response exceeds slot capacity"}).encode()

# poison drill marker: with the poison_doc fault armed, any frame doc
# containing this literal deterministically kills its scorer batch, so
# tests and the ci chaos smoke exercise the real bisection path
POISON_MARKER = "__ldt_poison__"


class RingError(RuntimeError):
    """A ring file that cannot be attached (bad magic/version, or a
    geometry that disagrees with the file size)."""


class RingSlot:
    """Pure in-process mirror of one slot's lifecycle state.

    Both sides of the ring keep a mirror per slot and replay every
    observed cross-process state change through these guarded writes
    (see _advance_mirror): an observed change that no legal transition
    path can explain is a protocol violation and the slot is
    force-reclaimed. The class is deliberately I/O-free so the
    `ring-reclaim` model-check product drives it directly."""

    def __init__(self, index: int):
        self.index = index
        self.state = SLOT_FREE

    # -- guarded FSM writes (one declared transition per branch) ------

    def mark_writing(self) -> None:
        if self.state == SLOT_FREE:
            self.state = SLOT_WRITING

    def mark_ready(self) -> None:
        if self.state == SLOT_WRITING:
            self.state = SLOT_READY

    def mark_leased(self) -> None:
        if self.state == SLOT_READY:
            self.state = SLOT_LEASED

    def mark_done(self) -> None:
        if self.state == SLOT_LEASED:
            self.state = SLOT_DONE

    def mark_failed(self) -> None:
        """Fail-back: a fenced READY frame or an orphaned LEASED frame
        moves to DONE carrying an explicit error frame."""
        if self.state == SLOT_READY:
            self.state = SLOT_DONE
        elif self.state == SLOT_LEASED:
            self.state = SLOT_DONE

    def mark_free(self) -> None:
        """Consume (DONE) or reclaim (a dead client's WRITING)."""
        if self.state == SLOT_DONE:
            self.state = SLOT_FREE
        elif self.state == SLOT_WRITING:
            self.state = SLOT_FREE


def _advance_mirror(s: RingSlot, raw: int) -> bool:
    """Replay the mirror through declared transitions until it matches
    the observed raw state. Returns False when no legal path reaches
    `raw` (a corrupt header) — the caller force-reclaims the slot."""
    for _ in range(6):
        if s.state == raw:
            return True
        if s.state == SLOT_FREE:
            s.mark_writing()
        elif s.state == SLOT_WRITING:
            if raw == SLOT_FREE:
                s.mark_free()
            else:
                s.mark_ready()
        elif s.state == SLOT_READY:
            if raw == SLOT_DONE:
                s.mark_failed()
            else:
                s.mark_leased()
        elif s.state == SLOT_LEASED:
            s.mark_done()
        else:
            s.mark_free()
    return s.state == raw


def _force_free(s: RingSlot) -> None:
    """Walk the mirror to FREE along declared transitions (reclaim)."""
    s.mark_failed()   # READY / LEASED -> DONE
    s.mark_free()     # DONE / WRITING -> FREE


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


def _geometry(slots: int | None, slot_bytes: int | None) -> tuple:
    n = slots or knobs.get_int("LDT_SHM_SLOTS") or 8
    n = max(1, min(int(n), MAX_SLOTS))
    sb = slot_bytes or knobs.get_int("LDT_SHM_SLOT_BYTES") or 65536
    sb = max(int(sb), _PAGE)
    sb = -(-sb // _PAGE) * _PAGE      # page multiple: payloads map at
    return n, sb                      # offset 0 of their own mmap


def lease_timeout_sec() -> float:
    return knobs.get_float("LDT_SHM_LEASE_TIMEOUT_SEC") or 2.0


# ---------------------------------------------------------------------
# ring file mapping (shared by client and worker)


class RingFile:
    """One mmap'd ring file: header accessors over the shared mapping.
    Single-threaded by contract on each side (SPSC): the client object
    is confined to its caller, the worker side to the scan thread."""

    def __init__(self, path: str, create: bool = False,
                 slots: int | None = None,
                 slot_bytes: int | None = None):
        self.path = path
        if create:
            n, sb = _geometry(slots, slot_bytes)
            total = HEADER_PAGE + n * sb
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.truncate(total)
                f.seek(0)
                f.write(RING_HDR.pack(RING_MAGIC, RING_VERSION, 0, n,
                                      os.getpid(), 0, sb))
            os.replace(tmp, path)     # scanners only see whole rings
        self._f = open(path, "r+b")
        size = os.fstat(self._f.fileno()).st_size
        if size < HEADER_PAGE:
            self._f.close()
            raise RingError(f"{path}: shorter than the header page")
        self.mm = mmap.mmap(self._f.fileno(), 0)
        magic, version, _gen, n, _cp, _wp, sb = \
            RING_HDR.unpack_from(self.mm, 0)
        if magic != RING_MAGIC or version != RING_VERSION:
            self.close()
            raise RingError(f"{path}: not an LDSR v{RING_VERSION} ring")
        if not 1 <= n <= MAX_SLOTS or sb % _PAGE or \
                size != HEADER_PAGE + n * sb:
            self.close()
            raise RingError(f"{path}: geometry disagrees with file size")
        self.nslots = n
        self.slot_bytes = sb

    # -- ring header --------------------------------------------------

    @property
    def generation(self) -> int:
        return RING_HDR.unpack_from(self.mm, 0)[2]

    @property
    def client_pid(self) -> int:
        return RING_HDR.unpack_from(self.mm, 0)[4]

    @property
    def worker_pid(self) -> int:
        return RING_HDR.unpack_from(self.mm, 0)[5]

    def set_generation(self, gen: int, worker_pid: int) -> None:
        magic, version, _g, n, cp, _wp, sb = \
            RING_HDR.unpack_from(self.mm, 0)
        RING_HDR.pack_into(self.mm, 0, magic, version, gen, n, cp,
                           worker_pid, sb)

    # -- slot headers -------------------------------------------------

    def read_slot(self, i: int) -> tuple:
        """(state, generation, owner_pid, lease_ts, length, status)."""
        st, gen, pid, _r, ts, ln, status = SLOT_HDR.unpack_from(
            self.mm, SLOT_HDR_OFF + i * SLOT_HDR_SIZE)
        return st, gen, pid, ts, ln, status

    def slot_request_id(self, i: int) -> int:
        """The slot's correlation-id word (the u32 the client stamped
        on submit and the worker echoes on DONE); 0 = no id."""
        return SLOT_HDR.unpack_from(
            self.mm, SLOT_HDR_OFF + i * SLOT_HDR_SIZE)[3]

    def write_slot(self, i: int, state: int, gen: int, pid: int,
                   ts: float, length: int, status: int,
                   reqid: int = 0) -> None:
        # publish order matters: the peer polls the state word, so every
        # other field must land BEFORE it. A single pack_into is a
        # forward memcpy — state first — and a reader could observe the
        # new state with the OLD length/status still in place (a torn
        # frame). Writing the state word last, as its own aligned
        # 4-byte store, makes the state transition the publication
        # point.
        off = SLOT_HDR_OFF + i * SLOT_HDR_SIZE
        rec = SLOT_HDR.pack(state, gen, pid, reqid, ts, length, status)
        self.mm[off + 4:off + SLOT_HDR.size] = rec[4:]
        self.mm[off:off + 4] = rec[:4]

    def write_crc(self, i: int, crc: int) -> None:
        """Stamp the slot's payload-guard word (u32 crc32 at byte 32 of
        the header region). Written BEFORE the READY publish so a
        reader that observes READY sees a settled crc."""
        struct.pack_into("<I", self.mm,
                         SLOT_HDR_OFF + i * SLOT_HDR_SIZE
                         + SLOT_HDR.size, crc)

    def read_crc(self, i: int) -> int:
        return struct.unpack_from(
            "<I", self.mm,
            SLOT_HDR_OFF + i * SLOT_HDR_SIZE + SLOT_HDR.size)[0]

    def payload_off(self, i: int) -> int:
        return HEADER_PAGE + i * self.slot_bytes

    def write_payload(self, i: int, chunks) -> int:
        pos = self.payload_off(i)
        start = pos
        for b in chunks:
            self.mm[pos:pos + len(b)] = b
            pos += len(b)
        return pos - start

    def read_payload(self, i: int, length: int) -> bytes:
        off = self.payload_off(i)
        return self.mm[off:off + length]

    def close(self) -> None:
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass
        try:
            self._f.close()
        except OSError:
            pass


# ---------------------------------------------------------------------
# client side (producer)


def client_ring_path(shm_dir: str, pid: int | None = None) -> str:
    return os.path.join(shm_dir, f"client-{pid or os.getpid()}.ring")


class RingClient:
    """Producer side of one SPSC ring: creates the ring file in the
    worker's LDT_SHM_DIR, writes request frames into FREE slots and
    collects responses from DONE slots. Confined to a single caller
    thread (SPSC contract) — no locks."""

    def __init__(self, shm_dir: str, slots: int | None = None,
                 slot_bytes: int | None = None,
                 path: str | None = None):
        os.makedirs(shm_dir, exist_ok=True)
        self.path = path or client_ring_path(shm_dir)
        self.rf = RingFile(self.path, create=True, slots=slots,
                           slot_bytes=slot_bytes)
        self.slots = [RingSlot(i) for i in range(self.rf.nslots)]
        self.last_request_id: str | None = None  # echo of last wait()

    def _refresh(self, i: int) -> tuple:
        raw = self.rf.read_slot(i)
        if not _advance_mirror(self.slots[i], raw[0]):
            # the worker force-reclaimed (or the header tore): resync
            _force_free(self.slots[i])
            self.rf.write_slot(i, SLOT_FREE, 0, 0, 0.0, 0, 0)
        return raw

    def attached(self) -> bool:
        """True once a worker has adopted this ring (attach bumps the
        generation past the client's initial 0)."""
        return self.rf.generation > 0

    def wait_attached(self, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        while not self.attached():
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no worker attached {self.path} within {timeout}s")
            time.sleep(0.001)

    def submit(self, body: bytes,
               request_id: str | None = None) -> int | None:
        """Write one frame into a FREE slot -> slot index, or None when
        the ring is full (the caller drains with wait() first) or no
        worker has attached yet (a frame stamped with the pre-attach
        generation would only be fenced). The shm lane's correlation
        id is natively the slot header's u32: request_id must be its
        1-8 hex-char rendering (the same shape server-generated ids
        use on every lane); the worker echoes it on the DONE header."""
        if len(body) > self.rf.slot_bytes:
            raise ValueError(
                f"frame of {len(body)} bytes exceeds slot capacity "
                f"{self.rf.slot_bytes}")
        reqid = 0
        if request_id is not None:
            try:
                reqid = int(request_id, 16)
            except ValueError:
                reqid = -1
            if not 0 < reqid <= 0xFFFFFFFF:
                raise ValueError(
                    "shm lane request_id must be 1-8 hex chars "
                    f"(u32 slot-header carrier), got {request_id!r}")
        if not self.attached():
            return None
        for i, s in enumerate(self.slots):
            raw = self._refresh(i)
            if self.slots[i].state != SLOT_FREE:
                continue
            del raw
            gen = self.rf.generation   # stamp what we observed: a
            now = time.time()          # worker restart mid-frame fences
            s.mark_writing()
            self.rf.write_slot(i, SLOT_WRITING, gen, os.getpid(), now,
                               0, 0, reqid=reqid)
            self.rf.write_payload(i, (body,))
            if knobs.get_bool("LDT_WIRE_CRC"):
                # guard word must settle before the READY publish:
                # the worker reads it only after observing READY
                self.rf.write_crc(i, zlib.crc32(body))
            s.mark_ready()
            self.rf.write_slot(i, SLOT_READY, gen, os.getpid(), now,
                               len(body), 0, reqid=reqid)
            return i
        return None

    def wait(self, i: int, timeout: float = 30.0) -> tuple:
        """Block (poll) until slot i answers -> (status, body bytes).
        Raises TimeoutError past `timeout` — the protocol's reclaim and
        fencing are designed to make that unreachable for a live
        worker, and the chaos tests pin it.

        The poll backs off exponentially (20us -> 1ms): on a machine
        with fewer cores than processes, a tight fixed-interval spin
        steals the very CPU the worker needs to answer the frame, while
        a pipelining client that keeps other slots READY loses nothing
        to a late wake-up."""
        deadline = time.monotonic() + timeout
        nap = 2e-5
        while True:
            st, _gen, _pid, _ts, length, status = self._refresh(i)
            if self.slots[i].state == SLOT_DONE:
                # surface the DONE header's echoed correlation id (the
                # SPSC contract confines this attribute to the caller)
                rq = self.rf.slot_request_id(i)
                self.last_request_id = ("%08x" % rq) if rq else None
                body = self.rf.read_payload(i, length)
                self.slots[i].mark_free()
                self.rf.write_slot(i, SLOT_FREE, 0, 0, 0.0, 0, 0)
                return status, body
            if self.slots[i].state == SLOT_FREE:
                # reclaimed under us (fence + dead-client sweep raced
                # our poll): surface as an explicit error, not a hang
                return 503, FENCED_BODY
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"slot {i} still {SLOT_STATE_NAMES.get(st, st)} "
                    f"after {timeout}s")
            time.sleep(nap)
            nap = min(nap * 2, 1e-3)

    def request(self, body: bytes, timeout: float = 30.0,
                request_id: str | None = None) -> tuple:
        """submit + wait convenience for sequential callers."""
        deadline = time.monotonic() + timeout
        while True:
            i = self.submit(body, request_id=request_id)
            if i is not None:
                return self.wait(i, timeout=timeout)
            if time.monotonic() >= deadline:
                raise TimeoutError("ring full: no slot freed in time")
            time.sleep(0.0002)

    def close(self, unlink: bool = False) -> None:
        self.rf.close()
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


# ---------------------------------------------------------------------
# quarantine (poison-doc registry)


class Quarantine:
    """Registry of docs proven to deterministically kill a scorer
    batch. Shared between the scan thread (add/known during bisection)
    and the metrics/debug threads (stats), so the dict lives under its
    own lock (tools/lint/ownership.py)."""

    def __init__(self):
        self._lock = make_lock("shmring.quarantine")
        self._docs: dict = {}     # digest -> hit count
        self.total = 0            # docs quarantined (unique)
        self.bisects = 0          # bisection batch retries

    @staticmethod
    def _digest(text: str) -> str:
        return hashlib.sha1(text.encode("utf-8", "replace")).hexdigest()

    def add(self, text: str) -> bool:
        """Quarantine one doc; True when it is newly quarantined."""
        d = self._digest(text)
        with self._lock:
            fresh = d not in self._docs
            self._docs[d] = self._docs.get(d, 0) + 1
            if fresh:
                self.total += 1
            return fresh

    def known(self, text: str) -> bool:
        d = self._digest(text)
        with self._lock:
            hit = d in self._docs
            if hit:
                self._docs[d] += 1
            return hit

    def note_bisect(self) -> None:
        with self._lock:
            self.bisects += 1

    def stats(self) -> dict:
        with self._lock:
            return {"quarantined_docs": self.total,
                    "bisect_batches": self.bisects,
                    "hits": sum(self._docs.values()) - self.total}


# ---------------------------------------------------------------------
# worker side (consumer)


class _WorkerRing:
    """Worker-side attachment state for one ring: the shared header
    mapping plus one offset-mmap per slot payload, so each frame body
    parses in place starting at offset 0 (wire.fast_parse_texts slices
    doc strings straight off the mapping — zero copy into the pack
    staging path)."""

    def __init__(self, rf: RingFile):
        self.rf = rf
        self.mirrors = [RingSlot(i) for i in range(rf.nslots)]
        self.pmaps = [
            mmap.mmap(rf._f.fileno(), rf.slot_bytes,
                      offset=rf.payload_off(i))
            for i in range(rf.nslots)]
        self.generation = rf.generation

    def close(self) -> None:
        for p in self.pmaps:
            try:
                p.close()
            except (BufferError, ValueError):
                pass
        self.rf.close()


class ShmRingServer:
    """Directory scanner + frame pump + reclaim sweep, one daemon
    thread (the SPSC consumer for every attached ring). Frames parse
    and answer in place on the slot's own mmap — no socket syscalls,
    no frame copies — and a pipelining client keeps the other slots
    full while one scores, so the sweep almost never sleeps under
    load. All mutable state is confined to the scan thread; stats()
    readers get the immutable snapshot dict republished each sweep
    (the FleetStatus confinement argument — a dict rebind is one
    GIL-atomic store)."""

    def __init__(self, svc, shm_dir: str | None = None, detect=None):
        self.svc = svc
        self.dir = shm_dir or knobs.get_str("LDT_SHM_DIR")
        self._base_detect = detect
        self.quarantine = Quarantine()
        self._rings: dict = {}        # path -> _WorkerRing
        self._bad: dict = {}          # path -> mtime of refused file
        self._closing = False
        self._thread: threading.Thread | None = None
        self._stat_lock = make_lock("shmring.stats")
        self._frames = 0
        self._snap: dict = {"rings": 0, "slots_total": 0,
                            "slots_free": 0, "frames": 0}
        self._detect = self._make_detect()

    # -- scoring with poison bisection --------------------------------

    def _make_detect(self):
        svc = self.svc
        base = self._base_detect
        q = self.quarantine

        def score(texts, trace=None):
            # poison_doc drill seam: with the fault armed, any marked
            # doc deterministically kills its batch — the same code
            # path a real deterministic scorer kill takes
            if faults.ACTIVE is not None and \
                    any(POISON_MARKER in t for t in texts):
                try:
                    faults.hit("poison_doc")
                except faults.FaultInjected as e:
                    raise _PoisonBatch(str(e)) from e
            fn = base if base is not None else svc.detect_codes
            return fn(texts, trace=trace)

        def detect(texts, trace=None):
            if q.total:
                # known-poison pre-filter: a quarantined doc never
                # reaches the scorer again (no redispatch budget burned)
                keep = [i for i, t in enumerate(texts)
                        if not q.known(t)]
                if len(keep) != len(texts):
                    out = ["un"] * len(texts)
                    sub = [texts[i] for i in keep]
                    codes = self._score_or_bisect(sub, trace, score) \
                        if sub else []
                    for i, c in zip(keep, codes):
                        out[i] = c
                    return out
            return self._score_or_bisect(texts, trace, score)

        return detect

    def _score_or_bisect(self, texts, trace, score):
        try:
            return score(texts, trace=trace)
        except _PoisonBatch:
            return self._bisect(texts, trace, score)
        except _ANSWERED:
            raise          # backend wedged/expired/shed, not a poison frame
        except _NOT_POISON as e:
            raise _device_failed(e) from e
        except Exception:  # noqa: BLE001 - bisect isolates the doc
            return self._bisect(texts, trace, score)

    def _bisect(self, texts, trace, score):
        """A batch the scorer killed: split until the poison docs are
        isolated and quarantined; every healthy doc still answers."""
        self.quarantine.note_bisect()
        telemetry.REGISTRY.counter_inc("ldt_quarantine_bisect_total")
        if len(texts) == 1:
            if self.quarantine.add(texts[0]):
                telemetry.REGISTRY.counter_inc(
                    "ldt_quarantine_docs_total")
                flightrec.emit_event("shm_ring_state",
                                     state="quarantined")
            return ["un"]
        mid = len(texts) // 2
        out: list = []
        for part in (texts[:mid], texts[mid:]):
            try:
                out.extend(score(part, trace=trace))
            except _PoisonBatch:
                out.extend(self._bisect(part, trace, score))
            except _ANSWERED:
                raise
            except _NOT_POISON as e:
                raise _device_failed(e) from e
            except Exception:  # noqa: BLE001 - recurse on the half
                out.extend(self._bisect(part, trace, score))
        return out

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        m = getattr(self.svc, "metrics", None)
        if m is not None:
            m.shm_stats = self.stats
            m.quarantine_stats = self.quarantine.stats
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ldt-shm-scan")
        self._thread.start()

    def close(self, drain_sec: float = 0.0) -> None:
        self._closing = True
        if self._thread is not None:
            self._thread.join(max(drain_sec, 0.2))
        for ring in self._rings.values():
            ring.close()
        self._rings.clear()

    def stats(self) -> dict:
        # slot/ring counts come from the sweep's snapshot; the frame
        # count reads live (pool jobs increment it between sweeps, and
        # a client can observe its response before the next republish)
        with self._stat_lock:
            frames = self._frames
        return dict(self._snap, frames=frames)

    # -- scan loop ----------------------------------------------------

    def _run(self) -> None:
        next_dir_scan = 0.0
        idle = 0
        while not self._closing:
            now = time.monotonic()
            if now >= next_dir_scan:
                self._scan_dir()
                next_dir_scan = now + 0.05
            handled = 0
            for path, ring in list(self._rings.items()):
                handled += self._sweep_ring(path, ring)
            self._publish()
            if handled == 0:
                # adaptive nap: right after serving traffic the next
                # frame is usually mid-flight (the client drains and
                # refills within ~0.1ms), so a pass boundary gets a few
                # short naps before falling back to the idle interval —
                # otherwise every pipelined pass pays a full interval
                # stall, which is the difference between beating the
                # UDS lane and trailing it
                idle += 1
                ms = knobs.get_float("LDT_SHM_SCAN_INTERVAL_MS") or 1.0
                time.sleep(ms / 1e3 if idle > 8 else 5e-5)
            else:
                idle = 0

    def _scan_dir(self) -> None:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for name in names:
            if not name.endswith(".ring"):
                continue
            path = os.path.join(self.dir, name)
            if path in self._rings:
                continue
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            if self._bad.get(path) == mtime:
                continue
            try:
                self._attach(path)
            except faults.FaultInjected:
                telemetry.REGISTRY.counter_inc(
                    "ldt_shm_reclaimed_total", reason="attach-fault")
                continue       # injected attach failure: retried next
            except (RingError, OSError, ValueError):
                self._bad[path] = mtime
                continue

    def _attach(self, path: str) -> None:
        if faults.ACTIVE is not None:
            faults.hit("shm_attach")
        rf = RingFile(path)
        # generation fence: every attach (first, restart, fleet roll)
        # bumps the ring generation, so frames stamped by the previous
        # worker's era deterministically fail back, never dangle
        gen = rf.generation + 1
        rf.set_generation(gen, os.getpid())
        ring = _WorkerRing(rf)
        ring.generation = gen
        self._rings[path] = ring
        self._bad.pop(path, None)
        flightrec.emit_event("shm_ring_state", state="attached",
                             ring=os.path.basename(path),
                             generation=gen)
        print(json.dumps({"msg": f"shm ring attached: {path} "
                                 f"(generation {gen})"}), flush=True)

    def _detach(self, path: str, ring: _WorkerRing,
                unlink: bool) -> None:
        self._rings.pop(path, None)
        ring.close()
        if unlink:
            flightrec.emit_event("shm_ring_state", state="unlinked",
                                 ring=os.path.basename(path))
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- per-ring sweep -----------------------------------------------

    def _sweep_ring(self, path: str, ring: _WorkerRing) -> int:
        rf = ring.rf
        gen = ring.generation
        timeout = lease_timeout_sec()
        client_alive = _pid_alive(rf.client_pid)
        handled = 0
        free = 0
        for i in range(rf.nslots):
            raw, sgen, pid, ts, length, _status = rf.read_slot(i)
            s = ring.mirrors[i]
            if raw not in SLOT_STATE_NAMES or \
                    not _advance_mirror(s, raw):
                # corrupt header: no legal transition path explains the
                # observed state — repair to FREE
                if not self._reclaim(rf, s, i, "corrupt"):
                    continue
                free += 1
                continue
            if s.state == SLOT_READY:
                if sgen != gen:
                    self._fail_frame(ring, i, "fenced")
                elif length > rf.slot_bytes:
                    self._fail_frame(ring, i, "oversize")
                elif self._lease(ring, i, length):
                    self._complete(ring, i, length)
                    handled += 1
            elif s.state == SLOT_LEASED:
                if sgen != gen:
                    # a previous worker crashed mid-lease: fail the
                    # frame back with an explicit error frame
                    self._fail_frame(ring, i, "fenced")
            elif s.state == SLOT_WRITING:
                stale = time.time() - ts > timeout
                if not _pid_alive(pid) or stale:
                    self._reclaim(rf, s, i, "writer-lost")
            elif s.state == SLOT_DONE:
                if not client_alive and \
                        time.time() - ts > timeout:
                    self._reclaim(rf, s, i, "client-dead")
            if s.state == SLOT_FREE:
                free += 1
        if not client_alive and free == rf.nslots:
            # every frame resolved and the producer is gone: the ring
            # file has no owner left — drop it
            self._detach(path, ring, unlink=True)
        return handled

    def _reclaim(self, rf: RingFile, s: RingSlot, i: int,
                 reason: str) -> bool:
        try:
            if faults.ACTIVE is not None:
                faults.hit("shm_reclaim")
        except faults.FaultInjected:
            return False       # injected reclaim failure: retried next
        _force_free(s)
        rf.write_slot(i, SLOT_FREE, 0, 0, 0.0, 0, 0)
        telemetry.REGISTRY.counter_inc("ldt_shm_reclaimed_total",
                                       reason=reason)
        return True

    def _fail_frame(self, ring: _WorkerRing, i: int,
                    reason: str) -> None:
        """Explicit error frame for a frame that can never score
        (stale generation, oversize length): DONE with a 503/413 so the
        waiting client resolves instead of hanging."""
        body = FENCED_BODY if reason == "fenced" else wire.OVERSIZE_BODY
        status = 503 if reason == "fenced" else 413
        rf = ring.rf
        s = ring.mirrors[i]
        reqid = rf.slot_request_id(i)  # error frames echo the id too
        s.mark_failed()
        rf.write_payload(i, (body,))
        rf.write_slot(i, SLOT_DONE, ring.generation, os.getpid(),
                      time.time(), len(body), status, reqid=reqid)
        telemetry.REGISTRY.counter_inc("ldt_shm_frames_total",
                                       result="fenced")
        telemetry.REGISTRY.counter_inc("ldt_shm_reclaimed_total",
                                       reason="generation")

    def _lease(self, ring: _WorkerRing, i: int, length: int) -> bool:
        """Lease one READY frame: the fault seam and the FSM edge."""
        try:
            if faults.ACTIVE is not None:
                faults.hit("shm_lease")
        except faults.FaultInjected:
            return False       # lease fault: frame stays READY, retried
        ring.mirrors[i].mark_leased()
        ring.rf.write_slot(i, SLOT_LEASED, ring.generation, os.getpid(),
                           time.time(), length, 0)
        return True

    def _complete(self, ring: _WorkerRing, i: int, length: int) -> None:
        """Score one leased frame and publish its response.
        Zero-copy frame feed: the slot's own mmap IS the request
        buffer — the wire fast scanner decodes doc strings straight
        off it, then the response overwrites the same payload region.
        Every exit path writes a DONE header, so the client's wait()
        always resolves."""
        rf = ring.rf
        s = ring.mirrors[i]
        reqid = rf.slot_request_id(i)
        if knobs.get_bool("LDT_WIRE_CRC"):
            if faults.ACTIVE is not None and length:
                # chaos seam: seeded single-bit flip in the shared
                # payload — exactly the corruption the guard word
                # must catch before the frame reaches the parser
                seed = faults.corruption("frame_payload")
                if seed is not None:
                    off = rf.payload_off(i)
                    rng = random.Random(seed)
                    b = rng.randrange(length)
                    rf.mm[off + b] ^= 1 << rng.randrange(8)
            ok = zlib.crc32(rf.read_payload(i, length)) \
                == rf.read_crc(i)
            telemetry.REGISTRY.counter_inc(
                "ldt_integrity_crc_total", lane="shm",
                result="ok" if ok else "mismatch")
            if not ok:
                telemetry.REGISTRY.counter_inc(
                    "ldt_integrity_detected_total",
                    kind="frame_crc", lane="shm")
                body = wire.CRC_ERROR_BODY
                s.mark_done()
                rf.write_payload(i, (body,))
                rf.write_slot(i, SLOT_DONE, ring.generation,
                              os.getpid(), time.time(), len(body),
                              400, reqid=reqid)
                telemetry.REGISTRY.counter_inc(
                    "ldt_shm_frames_total", result="error")
                return
        try:
            status, buffers = wire.handle_frame(
                self.svc, ring.pmaps[i], detect=self._detect,
                nbytes=length, lane="shm",
                request_id=("%08x" % reqid) if reqid else None)
        except Exception as e:  # noqa: BLE001 - typed 500, never a hang
            print(json.dumps({"msg": "shm frame failed",
                              "error": repr(e)}), flush=True)
            status, buffers = 500, [b'{"error":"internal error"}']
        # join before the mmap store: post_detect returns one chunk per
        # doc, and N small slice-assigns into the mapping cost far more
        # than one join + one store (the UDS lane pays one writev)
        resp = buffers[0] if len(buffers) == 1 else b"".join(buffers)
        blen = len(resp)
        if blen > rf.slot_bytes:
            resp, status = RESP_OVERFLOW_BODY, 500
            blen = len(resp)
        rf.write_payload(i, (resp,))
        s.mark_done()
        rf.write_slot(i, SLOT_DONE, ring.generation, os.getpid(),
                      time.time(), blen, status, reqid=reqid)
        with self._stat_lock:
            self._frames += 1
        telemetry.REGISTRY.counter_inc(
            "ldt_shm_frames_total",
            result="ok" if status < 400 else "error")

    def _publish(self) -> None:
        total = 0
        free = 0
        for ring in self._rings.values():
            total += ring.rf.nslots
            free += sum(1 for m in ring.mirrors
                        if m.state == SLOT_FREE)
        with self._stat_lock:
            frames = self._frames
        self._snap = {"rings": len(self._rings), "slots_total": total,
                      "slots_free": free, "frames": frames}
