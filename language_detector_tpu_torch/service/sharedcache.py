"""Fleet-shared result cache: an mmap seqlock table every worker shares.

Each SO_REUSEPORT fleet member keeps a private ResultCache, so a
retweet storm re-scores the same hot document once per worker. This
module holds the L2 those workers share: one fixed-geometry mmap file
(LDT_RESULT_CACHE_SHM_MB, normally under /dev/shm; the fleet pins one
path for all members through LDT_SHARED_CACHE_FILE) holding an
open-addressed table of
(doc-hash -> packed result fragment), readable and writable by every
process with zero locks, built on the same publish-order discipline as
the shmring ingest plane (service/shmring.py):

  slot layout (SLOT_BYTES, 64-byte aligned)
      u32  seq       seqlock word: even = published/free, odd = a
                     writer is inside (or died inside) the slot;
                     written LAST on publish
      u32  crc       crc32 over (epoch, key, vlen, payload) as written
      u64  epoch     artifact-epoch hash: a result is only legal
                     against the tables that produced it
      16s  key       sha256(hints_key, normalized text), truncated
      u32  vlen      payload length; 0 = free slot
      u32  (pad)
      ...  payload   the result fragment (ISO code string, utf-8)

Write protocol (single-writer-per-slot, CAS-style claim): read an even
seq s, publish s+1 (claim), write fields, publish s+2 — the seq bump is
the commit point, exactly shmring's state-word-last rule. Two writers
racing one slot both see s and both write: the final even seq publishes
interleaved bytes, and the CRC — computed by each writer over its OWN
data — then refuses the slot on read. The race loses a cache fill,
never correctness. A writer killed mid-slot leaves seq odd: readers and
the free-slot scan skip it forever, and the displacement-eviction path
adopts the stale odd seq as its claim, so the slot heals on the next
overwrite instead of leaking.

Read protocol (torn-read-safe): seq1 even -> copy fields -> seq2 ==
seq1 -> epoch matches -> key matches -> CRC verifies, else miss. Every
failure mode (absent, epoch-stale, torn, corrupt) is just a miss; the
shared tier can lose entries but can never serve a wrong or stale one.

Epoch flush on swap: set_epoch() re-keys the reader check immediately
(old-epoch entries are unreachable the moment the local epoch word
changes) and then sweeps the table freeing stale-epoch slots, counting
``ldt_shared_cache_epoch_flush_total`` — so a mid-burst artifact swap
yields zero stale hits by construction, and the capacity comes back.

Geometry is fixed at file creation (header wins over a later knob
change); creation is flock-serialized so N members starting at once
initialize the file exactly once.
"""
from __future__ import annotations

import hashlib
import mmap
import os
import struct
import zlib

from .. import knobs, telemetry
from ..locks import make_lock

MAGIC = b"LDTSHC1\n"
VERSION = 1
_HEADER = struct.Struct("<8sIII")   # magic, version, slot_count, slot_bytes
HEADER_BYTES = 64
SLOT_BYTES = 128
_SLOT_HDR = struct.Struct("<IIQ16sII")  # seq, crc, epoch, key, vlen, pad
SLOT_HDR_BYTES = _SLOT_HDR.size          # 40
PAYLOAD_CAP = SLOT_BYTES - SLOT_HDR_BYTES
PROBE_WINDOW = 8

_U32 = struct.Struct("<I")

# pinned shm geometry: a drive-by field edit must fail at import, not
# hand torn slots to every attached worker
# (tools/lint/layout_registry.py declares the same widths)
assert _HEADER.size == 20
assert _SLOT_HDR.size == 40
assert _U32.size == 4


def _key_hash(key) -> bytes:
    """16-byte content hash of a (hints_key, text) cache key. repr of
    the hints tuple is stable across processes for the str/int/tuple
    values the service builds them from."""
    return hashlib.sha256(repr(key).encode(
        "utf-8", "surrogatepass")).digest()[:16]


def _epoch_hash(epoch) -> int:
    """u64 epoch word from the artifact epoch object (digest string,
    swap counter string, or the initial None)."""
    return int.from_bytes(
        hashlib.sha256(repr(epoch).encode()).digest()[:8], "little")


class SharedResultCache:
    """One process's view of the shared table. Thread-safe: the mmap
    protocol is lock-free by design and the per-process stats counters
    take their own lock."""

    def __init__(self, path: str, max_bytes: int):
        self.path = path
        self._lock = make_lock("sharedcache.stats")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.epoch_flushes = 0
        self._epoch_word = _epoch_hash(None)
        self._mm, self.slot_count = self._attach(path, max_bytes)

    @staticmethod
    def _attach(path: str, max_bytes: int):
        slots = max(PROBE_WINDOW,
                    (max_bytes - HEADER_BYTES) // SLOT_BYTES)
        size = HEADER_BYTES + slots * SLOT_BYTES
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            # creation race: first member in initializes, the rest
            # adopt whatever geometry the header already declares
            import fcntl
            fcntl.flock(fd, fcntl.LOCK_EX)
            try:
                head = os.pread(fd, HEADER_BYTES, 0)
                init = len(head) < _HEADER.size or \
                    head[:len(MAGIC)] != MAGIC
                if init:
                    os.ftruncate(fd, 0)
                    os.ftruncate(fd, size)
                    os.pwrite(fd, _HEADER.pack(MAGIC, VERSION, slots,
                                               SLOT_BYTES), 0)
                else:
                    _, ver, slots, slot_bytes = _HEADER.unpack(
                        head[:_HEADER.size])
                    if ver != VERSION or slot_bytes != SLOT_BYTES:
                        raise RuntimeError(
                            f"shared cache {path}: incompatible layout "
                            f"(version {ver}, slot {slot_bytes}B) — "
                            f"remove the file or point "
                            f"LDT_SHARED_CACHE_FILE elsewhere")
                    size = HEADER_BYTES + slots * SLOT_BYTES
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        return mm, slots

    # -- slot access ---------------------------------------------------

    def _off(self, idx: int) -> int:
        return HEADER_BYTES + idx * SLOT_BYTES

    def _seq(self, off: int) -> int:
        return _U32.unpack_from(self._mm, off)[0]

    @staticmethod
    def _crc(epoch: int, key: bytes, payload: bytes) -> int:
        return zlib.crc32(struct.pack("<Q16sI", epoch, key,
                                      len(payload)) + payload)

    def set_epoch(self, epoch) -> None:
        """Swap to a new artifact epoch: rebind the local epoch word
        (stale entries become unreachable instantly), then sweep the
        table freeing slots the old artifact wrote so the capacity is
        reusable. Concurrent sweeps from several members are benign —
        freeing a free slot is a no-op."""
        word = _epoch_hash(epoch)
        if word == self._epoch_word:
            return
        self._epoch_word = word
        mm = self._mm
        flushed = 0
        for idx in range(self.slot_count):
            off = self._off(idx)
            s = self._seq(off)
            if s & 1:
                continue  # dead/active writer; eviction will heal it
            _, _, slot_epoch, _, vlen, _ = _SLOT_HDR.unpack_from(
                mm, off)
            if vlen == 0 or slot_epoch == word:
                continue
            # claim, clear, publish — the standard write protocol with
            # an empty body
            _U32.pack_into(mm, off, s + 1)
            _SLOT_HDR.pack_into(mm, off, s + 1, 0, 0, b"\0" * 16, 0, 0)
            _U32.pack_into(mm, off, s + 2)
            flushed += 1
        if flushed:
            with self._lock:
                self.epoch_flushes += flushed
            telemetry.REGISTRY.counter_inc(
                "ldt_shared_cache_epoch_flush_total", flushed)

    def get(self, key):
        """The published value for `key` under the current epoch, or
        None. Torn, stale, and corrupt slots all read as a miss."""
        kh = _key_hash(key)
        base = int.from_bytes(kh[:8], "little") % self.slot_count
        mm = self._mm
        for i in range(PROBE_WINDOW):
            off = self._off((base + i) % self.slot_count)
            seq1 = self._seq(off)
            if seq1 & 1:
                continue
            _, crc, epoch, skey, vlen, _ = _SLOT_HDR.unpack_from(
                mm, off)
            if skey != kh or vlen == 0:
                continue
            if vlen > PAYLOAD_CAP:
                continue  # corrupt length: never slice garbage
            payload = bytes(mm[off + SLOT_HDR_BYTES:
                               off + SLOT_HDR_BYTES + vlen])
            if self._seq(off) != seq1:
                continue  # torn read: a writer moved under us
            if epoch != self._epoch_word:
                continue
            if self._crc(epoch, skey, payload) != crc:
                continue
            with self._lock:
                self.hits += 1
            telemetry.REGISTRY.counter_inc(
                "ldt_shared_cache_hits_total")
            try:
                return payload.decode("utf-8")
            except UnicodeDecodeError:
                return None
        with self._lock:
            self.misses += 1
        telemetry.REGISTRY.counter_inc("ldt_shared_cache_misses_total")
        return None

    def put(self, key, value: str) -> None:
        """Publish a result under the current epoch. Best-effort: an
        oversized value, a full probe window, or a lost write race cost
        a future cache fill, nothing else."""
        payload = value.encode("utf-8", "surrogatepass")
        if len(payload) > PAYLOAD_CAP:
            return
        kh = _key_hash(key)
        base = int.from_bytes(kh[:8], "little") % self.slot_count
        mm = self._mm
        target = None
        evict = False
        for i in range(PROBE_WINDOW):
            off = self._off((base + i) % self.slot_count)
            s = self._seq(off)
            if s & 1:
                continue
            _, _, epoch, skey, vlen, _ = _SLOT_HDR.unpack_from(mm, off)
            if skey == kh and epoch == self._epoch_word and vlen:
                return  # already published (results are deterministic)
            if vlen == 0 and target is None:
                target = off
            elif epoch != self._epoch_word and target is None:
                # stale-epoch slot: as good as free
                target = off
        if target is None:
            # window full of live same-epoch entries (or dead writers):
            # deterministic displacement — the key picks its victim, so
            # racing writers of one key agree on the slot
            evict = True
            target = self._off((base + kh[8] % PROBE_WINDOW)
                               % self.slot_count)
        off = target
        s = self._seq(off)
        # claim: odd means a writer died here (or is live — then our
        # write loses to its CRC, see module docstring); adopt the odd
        # seq as the claim so dead slots heal instead of leaking
        writing = s + 1 if (s & 1) == 0 else s
        _U32.pack_into(mm, off, writing)
        crc = self._crc(self._epoch_word, kh, payload)
        _SLOT_HDR.pack_into(mm, off, writing, crc, self._epoch_word,
                            kh, len(payload), 0)
        mm[off + SLOT_HDR_BYTES:off + SLOT_HDR_BYTES + len(payload)] \
            = payload
        _U32.pack_into(mm, off, writing + 1)
        if evict:
            with self._lock:
                self.evictions += 1
            telemetry.REGISTRY.counter_inc(
                "ldt_shared_cache_evictions_total")

    def stats(self) -> dict:
        with self._lock:
            hits, misses = self.hits, self.misses
            evictions = self.evictions
            flushes = self.epoch_flushes
        total = hits + misses
        return {"path": self.path, "slots": self.slot_count,
                "slot_bytes": SLOT_BYTES, "hits": hits,
                "misses": misses, "evictions": evictions,
                "epoch_flushes": flushes,
                "hit_rate": hits / total if total else 0.0}

    def close(self) -> None:
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass


def default_path() -> str:
    explicit = knobs.get_str("LDT_SHARED_CACHE_FILE")
    if explicit:
        return explicit
    base = knobs.get_str("LDT_SHM_DIR")
    if not base:
        base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    if not base:
        import tempfile
        base = tempfile.gettempdir()
    return os.path.join(base, "ldt-shared-cache.bin")


_TIER = None
_TIER_BUILT = False


def shared_tier():
    """Process-wide singleton view of the shared table, lazily built
    from the knobs on first use — the sync batcher's cache and the aio
    front's cache must write through ONE mmap, not two. Built during
    single-threaded service init; tests reset via reset_shared_tier."""
    global _TIER, _TIER_BUILT
    if not _TIER_BUILT:
        _TIER = build_from_env()
        _TIER_BUILT = True
    return _TIER


def reset_shared_tier() -> None:
    global _TIER, _TIER_BUILT
    if _TIER is not None:
        _TIER.close()
    _TIER, _TIER_BUILT = None, False


def build_from_env():
    """The process's shared tier per LDT_RESULT_CACHE_SHM_MB, or None
    when the knob is unset/0. Never raises: a failed attach logs and
    runs private-cache-only."""
    mb = knobs.get_float("LDT_RESULT_CACHE_SHM_MB") or 0.0
    if mb <= 0:
        return None
    path = default_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cache = SharedResultCache(path, int(mb * 1024 * 1024))
    except Exception as e:  # noqa: BLE001 - degraded, not down
        import json
        print(json.dumps({"msg": "shared result cache unavailable — "
                                 "running with private caches only",
                          "path": path, "error": repr(e)}),
              flush=True)
        return None
    import json
    print(json.dumps({"msg": "shared result cache attached",
                      "path": path, "slots": cache.slot_count,
                      "mb": mb}), flush=True)
    # pre-touch so a scrape shows the series at 0 before any traffic
    for name in ("ldt_shared_cache_hits_total",
                 "ldt_shared_cache_misses_total",
                 "ldt_shared_cache_evictions_total",
                 "ldt_shared_cache_epoch_flush_total"):
        telemetry.REGISTRY.counter_inc(name, 0)
    return cache
