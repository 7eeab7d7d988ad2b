"""The kernel-library bundle (LDT_AOT_DIR): boot-hot start for the port.

The port's copy of language_detector_tpu/aot.py. The reference ships
one serialized XLA executable per bucket-ladder tier shape; the port's
only compiled artefact is the fused-tote kernel library
(csrc/fused_tote.cu), which ops/kernels.py builds with nvcc at first
use into LDT_COMPILE_CACHE_DIR. So the port's bundle holds one entry
per kernel library:

  - After a process builds the library (or loads it from the compile
    cache), the library is written into a bundle entry under
    LDT_AOT_DIR (write-back, one file per library).
  - A later process (generation N+1, a standby, a new fleet member, a
    fresh host or container with no compiler) finds the entry at
    engine init, writes the library to a private file under the build
    directory and loads it: no nvcc run.

Each entry carries TWO payloads, in the reference's entry format:

  - the portable section: the .cu source text and its nvcc flags;
    loading from it costs exactly one nvcc build and nothing else (the
    counterpart of the reference's exported StableHLO). It may be
    empty;
  - the native section: the built shared library, pinned to (torch,
    CUDA, device arch) — the boot-hot fast path, preferred at load.

Refusal is loud, never silent: every entry is keyed and cross-checked
against (table digest, torch version, CUDA version, device arch,
kernel mode, a digest of the kernel source and its flags) plus a
whole-entry CRC, and a mismatched or corrupt bundle counts
``ldt_aot_refused_total{reason=}``, logs a structured line, and falls
back to an nvcc build (or raises the typed ``AotError`` under
LDT_AOT_REQUIRE=1 — the deploy guard for fleets that must boot hot).
It never falls back to the plain scorer. A refused entry is
overwritten by the build path's write-back, so a stale bundle heals on
the first generation that builds through it.

The bundle directory is created if missing (with a structured log —
a nonexistent dir must enable the feature, not silently disable it),
and entries are written atomically (tmp + rename) so a crashed writer
can only ever leave a torn tmp file, which readers never open.

The store takes its library loader and builder as arguments
(ops/kernels.py passes ctypes and nvcc), so the CPU tests drive every
refusal with a stand-in library. This module imports no torch at
import time: the supervisor reads `compile_cache_dir` from it.
"""
from __future__ import annotations

import errno
import hashlib
import itertools
import json
import os
import struct
import time
import zlib
from pathlib import Path

from . import faults, knobs, telemetry
from .locks import make_lock

MAGIC = b"LDTAOT1\n"
_LEN = struct.Struct("<Q")
_CRC = struct.Struct("<I")

# pinned bundle geometry: a drive-by field edit must fail at import,
# not strand every deployed bundle (the reference's entry format)
assert _LEN.size == 8
assert _CRC.size == 4

# memo sentinel: the bundle has no (usable) entry for this library —
# the build path owns it now and will write one back
_ABSENT = object()

# the one kernel library and the kernel mode that launches it
LIBRARY = "fused_tote"
KERNEL_MODE = "cuda"

# the checkout's build directory: the compile cache's default
DEFAULT_COMPILE_CACHE_DIR = (Path(__file__).resolve().parent.parent
                             / "build" / "torch_kernels")


class AotError(RuntimeError):
    """A refused bundle entry: stale key (digest / torch / CUDA / arch /
    kernel mode / source), corrupt bytes, or an unloadable payload.
    Raised out of engine init only under LDT_AOT_REQUIRE=1; otherwise
    the engine logs, counts the refusal, and builds with nvcc."""


# -- keys --------------------------------------------------------------


def compile_cache_dir() -> Path:
    """LDT_COMPILE_CACHE_DIR, or the checkout's build/torch_kernels/:
    the directory the kernel library is built into and loaded from."""
    d = knobs.get_str("LDT_COMPILE_CACHE_DIR")
    return Path(d) if d else DEFAULT_COMPILE_CACHE_DIR


def table_digest_hex(dt) -> str:
    """Content digest of the serving tables: the per-plane host
    fingerprint (ops/device_tables.py) folded to hex, as the
    reference's. Any retrain changes the key."""
    from .ops.device_tables import fingerprint
    return hashlib.sha256(
        repr(fingerprint(dt)).encode()).hexdigest()[:16]


def source_digest(source: str, flags) -> str:
    """Digest of a kernel source text and the nvcc flags it is built
    with: an edited kernel or a changed flag refuses the entry."""
    return hashlib.sha256(source.encode() + json.dumps(
        list(flags)).encode()).hexdigest()[:16]


def portable_payload(source: str, flags) -> bytes:
    """The portable section: the source text and its flags."""
    return json.dumps({"flags": list(flags), "source": source},
                      sort_keys=True).encode()


def library_key(dt, source: str, flags,
                kernel_mode: str = KERNEL_MODE) -> dict:
    """The identity an entry must carry to load in this process, in
    the order the fields are checked."""
    import torch
    dev = dt.device
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        arch = f"sm_{major}{minor}"
    else:
        arch = dev.type
    return {"digest": table_digest_hex(dt), "torch": torch.__version__,
            "cuda": torch.version.cuda, "arch": arch,
            "kernel": kernel_mode,
            "source": source_digest(source, flags)}


def entry_name(kernel_mode: str, library: str) -> str:
    return f"{kernel_mode}-{library}.ldtx"


def _log(msg: str, **fields) -> None:
    print(json.dumps({"msg": msg, **fields}), flush=True)


def _refuse(reason: str, path: str, detail: str, require: bool):
    telemetry.REGISTRY.counter_inc("ldt_aot_refused_total",
                                   reason=reason)
    _log("aot bundle entry refused", reason=reason, path=path,
         detail=detail, require=require)
    if require:
        raise AotError(f"AOT entry refused ({reason}): {path}: "
                       f"{detail} — unset LDT_AOT_REQUIRE to fall "
                       "back to an nvcc build")
    return None


# -- entry file format (the reference's, byte for byte) ----------------


def _pack_entry(meta: dict, hlo: bytes, xc: bytes) -> bytes:
    """hlo: the portable section; xc: the native section."""
    mb = json.dumps(meta, sort_keys=True).encode()
    body = _LEN.pack(len(mb)) + mb + _LEN.pack(len(hlo)) + hlo \
        + _LEN.pack(len(xc)) + xc
    return MAGIC + body + _CRC.pack(zlib.crc32(body))


def _unpack_entry(raw: bytes):
    """(meta, hlo, xc) or raises AotError naming what is wrong."""
    if len(raw) < len(MAGIC) + _LEN.size + _CRC.size or \
            raw[:len(MAGIC)] != MAGIC:
        raise AotError("not an LDTX AOT entry (bad magic or truncated)")
    body, crc = raw[len(MAGIC):-_CRC.size], raw[-_CRC.size:]
    if zlib.crc32(body) != _CRC.unpack(crc)[0]:
        raise AotError("entry CRC mismatch (torn or corrupt bytes)")
    off = 0

    def take(n):
        nonlocal off
        if off + n > len(body):
            raise AotError("entry truncated inside a section")
        out = body[off:off + n]
        off += n
        return out

    mlen = _LEN.unpack(take(_LEN.size))[0]
    meta = json.loads(take(mlen).decode())
    hlen = _LEN.unpack(take(_LEN.size))[0]
    hlo = take(hlen)
    xlen = _LEN.unpack(take(_LEN.size))[0]
    xc = take(xlen)
    return meta, bytes(hlo), bytes(xc)


# -- the store ---------------------------------------------------------


class AotStore:
    """Per-engine view of one bundle directory: lookup-first library
    load plus build write-back. Thread-safe.

    key: library_key's fields, checked in order against every entry.
    loader(path) -> library handle (ctypes.CDLL in the port).
    builder(source, flags, out) builds `source` with `flags` into the
    library file `out` (nvcc in the port). scratch: the directory the
    private library files are written to before they are loaded (the
    build directory)."""

    def __init__(self, directory: str, key: dict, require: bool,
                 loader, builder, scratch):
        self.dir = directory
        self.key = dict(key)
        self.digest = self.key["digest"]
        self.kernel_mode = self.key["kernel"]
        self.require = require
        self.loader = loader
        self.builder = builder
        self.scratch = Path(scratch)
        self._lock = make_lock("engine.aot")
        self._entries: dict = {}  # library -> handle | _ABSENT
        self._exported: set = set()  # libraries this store wrote
        self._seq = itertools.count()
        self.loads = 0
        self.exports = 0
        self.refusals = 0
        # flipped (sticky) by offer() on a disk-full export: loads
        # keep working, exports stop
        self.export_disabled = False

    # -- load path ----------------------------------------------------

    def lookup(self, library: str = LIBRARY):
        """The loaded library from its bundle entry, or None
        (absent/refused — build, then offer()). Never raises unless
        LDT_AOT_REQUIRE is set."""
        with self._lock:
            hit = self._entries.get(library)
        if hit is not None:
            return None if hit is _ABSENT else hit
        lib = self._load(library)
        with self._lock:
            # first loader wins
            cur = self._entries.setdefault(
                library, lib if lib is not None else _ABSENT)
        return None if cur is _ABSENT else cur

    def _refused(self, reason: str, path: str, detail: str):
        with self._lock:
            self.refusals += 1
        return _refuse(reason, path, detail, self.require)

    def _load(self, library: str):
        path = os.path.join(self.dir, entry_name(self.kernel_mode,
                                                 library))
        if faults.ACTIVE is not None:
            faults.hit("aot_load")
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            if self.require:
                return self._refused(
                    "missing", path, "no bundle entry for this kernel "
                    "library")
            return None
        except OSError as e:
            return self._refused("io_error", path, repr(e))
        if faults.ACTIVE is not None:
            seed = faults.corruption("aot_load")
            if seed is not None:
                # chaos seam: a seeded bit-flip models bit rot in the
                # bundle — the CRC must refuse it, never load it
                b = bytearray(raw)
                b[seed % len(b)] ^= 1 << (seed % 8)
                raw = bytes(b)
        t0 = time.monotonic()
        try:
            meta, portable, native = _unpack_entry(raw)
        except AotError as e:
            return self._refused("corrupt", path, str(e))
        for field, expect in self.key.items():
            got = meta.get(field)
            if got != expect:
                return self._refused(
                    f"{field}_mismatch", path,
                    f"entry {field}={got!r}, this process wants "
                    f"{expect!r}")
        lib = self._deserialize(path, library, portable, native)
        if lib is not None:
            with self._lock:
                self.loads += 1
            telemetry.REGISTRY.counter_inc("ldt_aot_loads_total")
            _log("aot kernel library loaded", path=path,
                 kernel=self.kernel_mode,
                 ms=round((time.monotonic() - t0) * 1e3, 1))
        return lib

    def _private(self, library: str) -> Path:
        self.scratch.mkdir(parents=True, exist_ok=True)
        return self.scratch / (f"aot-{library}-{os.getpid()}-"
                               f"{next(self._seq)}.so")

    def _load_native(self, library: str, native: bytes):
        """Write the built library to a private file and load it; the
        file goes once loaded (a mapped library outlives its name)."""
        out = self._private(library)
        try:
            out.write_bytes(native)
            return self.loader(str(out))
        finally:
            out.unlink(missing_ok=True)

    def _load_portable(self, library: str, portable: bytes):
        """One build of the entry's source with its flags, then load."""
        doc = json.loads(portable.decode())
        out = self._private(library)
        try:
            self.builder(doc["source"], doc["flags"], out)
            return self.loader(str(out))
        finally:
            out.unlink(missing_ok=True)

    def _deserialize(self, path: str, library: str, portable: bytes,
                     native: bytes):
        """Native library first (no compiler), the portable source as
        fallback (one nvcc build)."""
        if native:
            try:
                return self._load_native(library, native)
            except Exception as e:  # noqa: BLE001 - fall to the portable payload
                _log("aot native payload unusable — trying the "
                     "portable source", path=path, error=repr(e))
                if not portable:
                    return self._refused("undeserializable", path,
                                         repr(e))
        if portable:
            try:
                return self._load_portable(library, portable)
            except Exception as e:  # noqa: BLE001 - typed refusal below
                return self._refused("undeserializable", path, repr(e))
        return self._refused("empty", path, "entry carries no payload")

    # -- write-back path ----------------------------------------------

    def offer(self, library: str, lib_path, portable: bytes) -> bool:
        """Write the library this process built (or loaded from the
        compile cache) into the bundle. Best-effort: a failed export
        logs and counts, it never fails the engine that triggered
        it."""
        with self._lock:
            if self.export_disabled:
                return False  # disk full: stop paying exports
            known = self._entries.get(library)
            if library in self._exported:
                return False  # this store already wrote the entry
        if known is not None and known is not _ABSENT:
            return False  # loaded from the bundle: nothing to write
        path = os.path.join(self.dir, entry_name(self.kernel_mode,
                                                 library))
        try:
            if faults.ACTIVE is not None:
                faults.hit("aot_export")
            t0 = time.monotonic()
            native = Path(lib_path).read_bytes()
            if not native and not portable:
                raise AotError("neither payload serialized")
            blob = _pack_entry(dict(self.key), portable, native)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001 - write-back is best-effort
            if isinstance(e, OSError) and e.errno == errno.ENOSPC:
                # sticky: every later offer would fail the same write —
                # loads still work, the service keeps serving, the
                # disable is counted and logged
                with self._lock:
                    self.export_disabled = True
                telemetry.REGISTRY.counter_inc(
                    "ldt_aot_disabled_total", reason="enospc")
                _log("aot exports disabled", reason="enospc",
                     path=path, error=repr(e))
            else:
                _log("aot export failed", path=path, error=repr(e))
            return False
        with self._lock:
            self.exports += 1
            self._exported.add(library)
        telemetry.REGISTRY.counter_inc("ldt_aot_exports_total")
        _log("aot kernel library exported", path=path,
             kernel=self.kernel_mode, bytes=len(blob),
             ms=round((time.monotonic() - t0) * 1e3, 1))
        return True

    # -- eager preload ------------------------------------------------

    def preload(self) -> int:
        """Load every bundle entry of this kernel mode up front (the
        startup_ready_task hook). Returns the number of entries now
        live that were not before."""
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return 0
        live = 0
        prefix = f"{self.kernel_mode}-"
        for name in names:
            if not name.startswith(prefix) or \
                    not name.endswith(".ldtx"):
                continue
            library = name[len(prefix):-len(".ldtx")]
            with self._lock:
                if self._entries.get(library) is not None:
                    continue
            if self.lookup(library) is not None:
                live += 1
        return live

    def stats(self) -> dict:
        with self._lock:
            return {"dir": self.dir, "kernel": self.kernel_mode,
                    "digest": self.digest, "loads": self.loads,
                    "exports": self.exports,
                    "refusals": self.refusals,
                    "export_disabled": self.export_disabled,
                    "entries": sum(1 for v in self._entries.values()
                                   if v is not _ABSENT)}


def build_from_env(dt, kernel_mode: str = KERNEL_MODE) -> AotStore | None:
    """The engine's bundle store per LDT_AOT_DIR, or None when the knob
    is unset. Creates the bundle dir if missing — loudly: a deploy that
    points at a not-yet-existing dir gets an armed (empty) bundle and a
    structured log, never a silently disabled feature."""
    directory = knobs.get_str("LDT_AOT_DIR")
    if not directory:
        return None
    if not os.path.isdir(directory):
        try:
            os.makedirs(directory, exist_ok=True)
            _log("aot bundle dir created", dir=directory)
        except OSError as e:
            telemetry.REGISTRY.counter_inc(
                "ldt_aot_disabled_total",
                reason="enospc" if e.errno == errno.ENOSPC
                else "oserror")
            _log("aot bundle dir unusable — AOT disabled",
                 dir=directory, error=repr(e))
            return None
    from .ops import kernels
    # pre-touch so a scrape shows the series at 0 before any load
    telemetry.REGISTRY.counter_inc("ldt_aot_loads_total", 0)
    telemetry.REGISTRY.counter_inc("ldt_aot_exports_total", 0)
    key = library_key(dt, kernels.SOURCE.read_text(), kernels.NVCC_FLAGS,
                      kernel_mode)
    return AotStore(directory, key, knobs.get_bool("LDT_AOT_REQUIRE"),
                    loader=kernels.load_library,
                    builder=kernels.build_source,
                    scratch=compile_cache_dir())
