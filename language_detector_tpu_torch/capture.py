"""Traffic capture plane: crash-safe, anonymized, fixed-width request
records for replay and knob tuning.

The flight recorder (flightrec.py) records EVENTS; nothing records the
WORKLOAD — request shapes, arrival times, tenants, deadlines — which is
exactly what tuning the fleet's ~60 knobs (ROADMAP item 5) needs. When
LDT_CAPTURE_DIR is set, every completed request appends one fixed-width
binary record to an mmap'd capture ring using flightrec.py's
publish-order commit-word discipline: the record body lands in the map
BEFORE the 4-byte commit word is stored, so a reader — including one
harvesting the file of a SIGKILLed process — never observes a
torn-but-published record.

Record layout (little-endian, RECORD below; the struct sizes are
pinned by tests/test_capture.py so the format cannot drift silently):

    arrival_mono_ns  u64  monotonic arrival (trace.t0); the file
                          header's wall/mono anchor pair converts it
                          to comparable wall time across processes
    tenant_hash      u64  blake2b-8 of the tenant id — anonymized:
                          raw tenant strings never touch disk
    cache_bits       u64  per-doc cache-hit bitmap (first 64 docs)
                          when the front reports it; 0 otherwise
    docs             u32  documents in the request
    deadline_ms      f32  declared deadline budget (0 = none)
    total_ms         f32  end-to-end latency
    parse_ms         f32  } per-stage breakdown summed from the
    detect_ms        f32  } request's existing Trace spans
    encode_ms        f32  }
    status           u16  final HTTP status
    size_bucket      u8   log2 bucket of the request body bytes
    lane             u8   0=tcp 1=uds 2=shm
    verdict          u8   0=ok 1=shed 2=error 3=timeout 4=invalid
    flags            u8   bit0 priority, bit1 shed

Rotation is size-bounded: the active ring holds
LDT_CAPTURE_RING_RECORDS records; when it fills, the committed records
are sealed into an immutable segment file via tmp+rename (the aot.py
publication idiom — a crashed writer leaves only a torn tmp file no
reader ever opens) and the ring restarts. At most
LDT_CAPTURE_MAX_SEGMENTS sealed segments are kept per writer (oldest
unlinked first). LDT_CAPTURE_SAMPLE keeps a probabilistic fraction of
requests; the RNG is injectable/seedable so sampling is deterministic
under test.

Readers: read_capture(dir) parses one directory's sealed segments and
live/abandoned rings; merge_captures(dir) walks a directory tree (the
fleet gives each member m<slot>/ its own subdir, same pattern as
flightrec) and merges every record by wall-clock arrival time — the
input `bench.py --replay` re-drives against a live fleet.
"""
from __future__ import annotations

import errno
import glob
import hashlib
import json
import mmap
import os
import random
import struct
import time

from . import knobs
from .locks import make_lock


def _log(msg: str, **fields) -> None:
    print(json.dumps({"msg": msg, **fields}), flush=True)

RING_MAGIC = b"LDCR"
SEG_MAGIC = b"LDCS"
VERSION = 1

# ring/segment file header: magic, version, slots (record capacity;
# for segments: committed record count), record size, pid,
# wall anchor (epoch seconds), monotonic anchor (ns) — the anchor pair
# converts per-record monotonic arrivals to comparable wall time
FILE_HDR = struct.Struct("<4sIIIIdQ")
COMMIT = struct.Struct("<I")         # per-slot commit word (index + 1)
RECORD = struct.Struct("<QQQIfffffHBBBB")
SLOT_BYTES = COMMIT.size + RECORD.size

# pinned on-disk geometry: a drive-by field edit must fail at import,
# not corrupt capture rings or strand sealed segments
# (tools/lint/layout_registry.py declares the same widths)
assert FILE_HDR.size == 36
assert COMMIT.size == 4
assert RECORD.size == 54

LANES = {"tcp": 0, "uds": 1, "shm": 2}
LANE_NAMES = {v: k for k, v in LANES.items()}
# both HTTP fronts are the tcp lane; wire.handle_frame tags uds/shm
_FRONT_LANE = {"sync": 0, "aio": 0, "tcp": 0, "uds": 1, "shm": 2}

VERDICTS = {"ok": 0, "shed": 1, "error": 2, "timeout": 3, "invalid": 4}
VERDICT_NAMES = {v: k for k, v in VERDICTS.items()}

FLAG_PRIORITY = 0x01
FLAG_SHED = 0x02


def tenant_hash(tenant: str | None) -> int:
    """Stable anonymized tenant identity: 8-byte blake2b of the raw id.
    Raw tenant strings never reach the capture file; replay re-drives
    distinct tenants as t<hash hex>."""
    raw = (tenant or "default").encode("utf-8", "replace")
    return int.from_bytes(
        hashlib.blake2b(raw, digest_size=8).digest(), "little")


def size_bucket(nbytes: int) -> int:
    """Log2 byte-size bucket (0 for empty); anonymization by design —
    the capture stores shape, never content."""
    return max(int(nbytes).bit_length(), 0) if nbytes > 0 else 0


def _verdict(status, meta: dict) -> int:
    if meta.get("shed"):
        return VERDICTS["shed"]
    if isinstance(status, int) and status >= 500:
        return VERDICTS["timeout"] if meta.get("timeout") \
            else VERDICTS["error"]
    if isinstance(status, int) and status >= 400:
        return VERDICTS["invalid"]
    return VERDICTS["ok"]


def record_from(trace, meta: dict | None, total_ms: float) -> tuple:
    """One request -> the RECORD field tuple, built entirely from the
    Trace and the completion meta both fronts already assemble."""
    meta = meta or {}
    status = meta.get("status")
    deadline = getattr(trace, "deadline", None)
    deadline_ms = 0.0
    if deadline is not None:
        deadline_ms = float(getattr(deadline, "budget_ms", 0.0) or 0.0)
    flags = 0
    if meta.get("priority"):
        flags |= FLAG_PRIORITY
    if meta.get("shed"):
        flags |= FLAG_SHED
    return (
        int(trace.t0 * 1e9) & 0xFFFFFFFFFFFFFFFF,
        tenant_hash(getattr(trace, "tenant", None)),
        int(meta.get("cache_bits", 0)) & 0xFFFFFFFFFFFFFFFF,
        int(meta.get("docs", 0)) & 0xFFFFFFFF,
        deadline_ms,
        float(total_ms),
        float(trace.span_ms("parse")),
        float(trace.span_ms("detect")),
        float(trace.span_ms("encode")),
        int(status) & 0xFFFF if isinstance(status, int) else 0,
        min(size_bucket(int(meta.get("bytes", 0) or 0)), 255),
        _FRONT_LANE.get(meta.get("front"), 0),
        _verdict(status, meta),
        flags,
    )


class CaptureWriter:
    """One process's capture ring + sealed segments (single writer)."""

    def __init__(self, directory: str, ring_records: int | None = None,
                 sample: float | None = None,
                 max_segments: int | None = None,
                 seed: int | None = None):
        if ring_records is None:
            ring_records = knobs.get_int("LDT_CAPTURE_RING_RECORDS") \
                or 4096
        if sample is None:
            sample = knobs.get_float("LDT_CAPTURE_SAMPLE")
            sample = 1.0 if sample is None else sample
        if max_segments is None:
            max_segments = knobs.get_int("LDT_CAPTURE_MAX_SEGMENTS") \
                or 64
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.ring_records = max(int(ring_records), 16)
        self.sample = min(max(float(sample), 0.0), 1.0)
        self.max_segments = max(int(max_segments), 1)
        self._rng = random.Random(seed)
        self._lock = make_lock("capture.ring")
        # set by _seal_locked on a disk-full seal; observe() reads it
        # outside the ring lock and retires the plane for good
        self.disabled_reason: str | None = None
        self._seq = 0            # committed records in the active ring
        self._segments = 0       # segments sealed over the lifetime
        self._records_total = 0
        self._sampled_out = 0
        self.path = os.path.join(self.dir,
                                 f"capture-{os.getpid()}.ring")
        self._wall_anchor = time.time()
        self._mono_anchor = time.monotonic_ns()
        size = FILE_HDR.size + self.ring_records * SLOT_BYTES
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR | os.O_TRUNC,
                     0o644)
        try:
            os.ftruncate(fd, size)
            self.mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.mm[:FILE_HDR.size] = FILE_HDR.pack(
            RING_MAGIC, VERSION, self.ring_records, RECORD.size,
            os.getpid(), self._wall_anchor, self._mono_anchor)

    # -- hot path -----------------------------------------------------------

    def append(self, rec: tuple) -> bool:
        """Record one request. Publish order: record body first, the
        commit word (slot index + 1) LAST — its store is the
        publication point (flightrec.emit discipline). Returns False
        when sampled out."""
        if self.sample < 1.0 and self._rng.random() >= self.sample:
            with self._lock:
                self._sampled_out += 1
            return False
        payload = RECORD.pack(*rec)
        with self._lock:
            if self._seq >= self.ring_records:
                self._seal_locked()
            i = self._seq
            off = FILE_HDR.size + i * SLOT_BYTES
            mm = self.mm
            mm[off + COMMIT.size:off + SLOT_BYTES] = payload
            mm[off:off + COMMIT.size] = COMMIT.pack(i + 1)
            self._seq = i + 1
            self._records_total += 1
        return True

    # -- rotation -----------------------------------------------------------

    def _seal_locked(self) -> None:
        """Seal the full ring into an immutable segment file (tmp +
        rename, aot.py publication idiom) and restart the ring. Prunes
        this writer's oldest segments past max_segments."""
        n = self._seq
        body = self.mm[FILE_HDR.size:FILE_HDR.size + n * SLOT_BYTES]
        records = bytearray()
        for i in range(n):
            off = i * SLOT_BYTES
            (commit,) = COMMIT.unpack_from(body, off)
            if commit != i + 1:
                continue  # torn slot: sealed segments hold only
                # committed records
            records += body[off + COMMIT.size:off + SLOT_BYTES]
        count = len(records) // RECORD.size
        self._segments += 1
        seg = os.path.join(
            self.dir,
            f"segment-{os.getpid()}-{self._segments:06d}.cap")
        tmp = f"{seg}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(FILE_HDR.pack(SEG_MAGIC, VERSION, count,
                                      RECORD.size, os.getpid(),
                                      self._wall_anchor,
                                      self._mono_anchor))
                f.write(bytes(records))
            os.replace(tmp, seg)
        except OSError as e:
            # a full disk is terminal for the plane, not the service:
            # flag it here (observe() retires the writer outside this
            # lock) instead of burning a failed seal every ring fill
            if e.errno == errno.ENOSPC:
                self.disabled_reason = "enospc"
            try:
                os.remove(tmp)
            except OSError:
                pass
        # restart the ring: zero every commit word so stale records
        # from the sealed generation can never be re-read
        self.mm[FILE_HDR.size:] = b"\0" * (len(self.mm) - FILE_HDR.size)
        self._seq = 0
        self._prune_locked()

    def _prune_locked(self) -> None:
        mine = sorted(glob.glob(os.path.join(
            self.dir, f"segment-{os.getpid()}-*.cap")))
        for path in mine[:max(len(mine) - self.max_segments, 0)]:
            try:
                os.remove(path)
            except OSError:
                pass

    # -- views --------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"dir": self.dir,
                    "records_total": self._records_total,
                    "sampled_out": self._sampled_out,
                    "segments_sealed": self._segments,
                    "ring_records": self.ring_records,
                    "ring_occupancy": self._seq,
                    "sample": self.sample}

    def close(self) -> None:
        try:
            self.mm.flush()
            self.mm.close()
        except (BufferError, ValueError, OSError):
            pass


# Module-level writer: None = disabled (the fast-path check). Armed by
# init_from_env() at front startup; rebound atomically.
WRITER: CaptureWriter | None = None


def init_from_env() -> CaptureWriter | None:
    """Arm the process capture writer from LDT_CAPTURE_DIR (unset =
    stay disabled). Idempotent; best-effort — capture must never fail
    a front's startup."""
    global WRITER
    if WRITER is not None:
        return WRITER
    directory = knobs.get_str("LDT_CAPTURE_DIR")
    if not directory:
        return None
    try:
        WRITER = CaptureWriter(directory)
    except OSError as e:
        _disable("enospc" if e.errno == errno.ENOSPC else "oserror",
                 directory, repr(e))
        return None
    return WRITER


def _disable(reason: str, directory: str, detail: str) -> None:
    """Retire the capture plane: structured log + counted disable. The
    service keeps serving — capture is observability, never load-
    bearing."""
    from . import telemetry
    telemetry.REGISTRY.counter_inc("ldt_capture_disabled_total",
                                   reason=reason)
    _log("capture disabled", reason=reason, dir=directory,
         detail=detail)


def observe(trace, meta: dict | None, total_ms: float) -> None:
    """finish_request's capture hook: one record per completed
    request. No-op (one attribute check) when capture is off. Counter
    increments happen HERE, outside the ring lock — the telemetry
    registry lock must never nest inside capture.ring."""
    global WRITER
    w = WRITER
    if w is None:
        return
    if w.disabled_reason:
        # a seal hit disk-full: unbind the writer so the fast path
        # returns to one attribute check, and keep serving
        WRITER = None
        _disable(w.disabled_reason, w.dir, "seal failed")
        w.close()
        return
    segments_before = w._segments
    kept = w.append(record_from(trace, meta, total_ms))
    from . import telemetry
    if kept:
        telemetry.REGISTRY.counter_inc("ldt_capture_records_total")
    else:
        telemetry.REGISTRY.counter_inc("ldt_capture_sampled_out_total")
    if w._segments > segments_before:
        telemetry.REGISTRY.counter_inc("ldt_capture_segments_total")


def stats() -> dict | None:
    w = WRITER
    return w.stats() if w is not None else None


def reset_for_tests() -> None:
    global WRITER
    if WRITER is not None:
        WRITER.close()
    WRITER = None


# -- readers ----------------------------------------------------------------


def _decode(raw: bytes, off: int, wall_anchor: float,
            mono_anchor: int) -> dict:
    (arr_ns, thash, cache_bits, docs, deadline_ms, total_ms, parse_ms,
     detect_ms, encode_ms, status, sbucket, lane, verdict,
     flags) = RECORD.unpack_from(raw, off)
    return {
        "arrival_ns": int(wall_anchor * 1e9) + (arr_ns - mono_anchor),
        "arrival_mono_ns": arr_ns,
        "tenant": f"t{thash:016x}",
        "tenant_hash": thash,
        "cache_bits": cache_bits,
        "docs": docs,
        "deadline_ms": round(deadline_ms, 3),
        "total_ms": round(total_ms, 3),
        "parse_ms": round(parse_ms, 3),
        "detect_ms": round(detect_ms, 3),
        "encode_ms": round(encode_ms, 3),
        "status": status,
        "size_bucket": sbucket,
        "approx_bytes": (1 << max(sbucket - 1, 0)) if sbucket else 0,
        "lane": LANE_NAMES.get(lane, "tcp"),
        "verdict": VERDICT_NAMES.get(verdict, "ok"),
        "priority": bool(flags & FLAG_PRIORITY),
        "shed": bool(flags & FLAG_SHED),
    }


def _read_file(path: str) -> list:
    """Parse one ring or segment file into record dicts. A slot whose
    commit word is unset or wrong (the one write in flight at SIGKILL)
    is skipped, not fatal — the documented reader contract."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FILE_HDR.size:
        raise ValueError(f"{path}: truncated capture file")
    magic, version, slots, rec_size, _pid, wall_anchor, mono_anchor = \
        FILE_HDR.unpack_from(data, 0)
    if magic not in (RING_MAGIC, SEG_MAGIC):
        raise ValueError(f"{path}: bad magic {magic!r}")
    if version != VERSION:
        raise ValueError(f"{path}: capture version {version} "
                         f"(reader speaks {VERSION})")
    if rec_size != RECORD.size:
        raise ValueError(f"{path}: record size {rec_size} "
                         f"(reader speaks {RECORD.size})")
    out: list = []
    if magic == SEG_MAGIC:
        for i in range(slots):
            off = FILE_HDR.size + i * RECORD.size
            if off + RECORD.size > len(data):
                break
            out.append(_decode(data, off, wall_anchor, mono_anchor))
        return out
    for i in range(slots):
        off = FILE_HDR.size + i * SLOT_BYTES
        if off + SLOT_BYTES > len(data):
            break
        (commit,) = COMMIT.unpack_from(data, off)
        if commit != i + 1:
            continue  # uncommitted / torn slot
        out.append(_decode(data, off + COMMIT.size, wall_anchor,
                           mono_anchor))
    return out


def read_capture(directory: str) -> list:
    """Every record in one capture directory (sealed segments + live or
    abandoned rings), sorted by wall-clock arrival. Unreadable files
    are skipped — a reader must survive whatever a crash left."""
    records: list = []
    for pattern in ("segment-*.cap", "capture-*.ring"):
        for path in sorted(glob.glob(os.path.join(directory, pattern))):
            try:
                records.extend(_read_file(path))
            except (OSError, ValueError):
                continue
    records.sort(key=lambda r: r["arrival_ns"])
    return records


def merge_captures(directory: str) -> list:
    """Records from a capture directory TREE — the fleet writes each
    member's capture under m<slot>/ — merged by wall-clock arrival
    time (the anchor pair in every file header makes per-process
    monotonic arrivals comparable). This is the replay input."""
    records: list = []
    seen: set = set()
    for pattern in ("**/segment-*.cap", "**/capture-*.ring"):
        for path in sorted(glob.glob(os.path.join(directory, pattern),
                                     recursive=True)):
            real = os.path.realpath(path)
            if real in seen:
                continue
            seen.add(real)
            try:
                records.extend(_read_file(path))
            except (OSError, ValueError):
                continue
    records.sort(key=lambda r: r["arrival_ns"])
    return records


def summarize(directory: str) -> dict:
    """Capture-dir summary for `debug.py --capture-summary`: file and
    record counts, the time span, and top tenants/lanes/statuses."""
    seg_files = glob.glob(os.path.join(directory, "**/segment-*.cap"),
                          recursive=True)
    ring_files = glob.glob(os.path.join(directory, "**/capture-*.ring"),
                           recursive=True)
    records = merge_captures(directory)
    tenants: dict = {}
    lanes: dict = {}
    statuses: dict = {}
    sheds = 0
    for r in records:
        tenants[r["tenant"]] = tenants.get(r["tenant"], 0) + 1
        lanes[r["lane"]] = lanes.get(r["lane"], 0) + 1
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
        if r["shed"]:
            sheds += 1
    span_sec = 0.0
    if len(records) >= 2:
        span_sec = (records[-1]["arrival_ns"]
                    - records[0]["arrival_ns"]) / 1e9
    top = sorted(tenants.items(), key=lambda kv: -kv[1])[:10]
    return {"dir": directory,
            "segments": len(seg_files),
            "rings": len(ring_files),
            "records": len(records),
            "span_sec": round(span_sec, 3),
            "sheds": sheds,
            "tenants": len(tenants),
            "top_tenants": [{"tenant": t, "records": n}
                            for t, n in top],
            "lanes": lanes,
            "statuses": {str(k): v for k, v in sorted(statuses.items())}}
