"""Native (C++) host runtime: the batch packer.

Loads libldtpack.so (built on demand from packer.cc) and exposes
`pack_batch_native`, an array-for-array drop-in for the Python
preprocess.pack.pack_batch (tests/test_native_pack.py asserts equality).
Falls back gracefully: `available()` is False when no compiler/library
exists and callers keep using the Python packer.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..locks import make_lock
from ..registry import Registry, ULSCRIPT_LATIN
from ..tables import ScoringTables
from ..preprocess.pack import PackedBatch, SpanExtent

_DIR = Path(__file__).parent
# own library names: the reference package loads libldtpack.so and
# libldtglue.so, and both packages may share one process (the tests)
_SO = _DIR / "libldtpack_torch.so"
_GLUE_SO = _DIR / "libldtglue_torch.so"

_lib = None
_init_keepalive: list = []
_lock = threading.Lock()


@contextlib.contextmanager
def build_lock(path: Path):
    """Exclusive lock on `path` across processes (flock; the kernel
    drops it when its holder exits). Loaders take it around their
    check-and-build, so processes that start on one checkout at once
    (test workers, spawned references) build a library once and never
    load one that another process is still writing."""
    import fcntl
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


_BUILD_LOCK = _DIR / "libldtpack_torch.lock"


def _install_built(tmp: str, final: Path) -> None:
    """Move a library build.sh wrote under a temporary name (and its
    .host sidecar) into place; os.replace is atomic, so a reader sees
    the old file or the new one, never a partial one."""
    side = _DIR / f"{tmp}.host"
    if side.exists():
        os.replace(side, final.with_suffix(".so.host"))
    os.replace(_DIR / tmp, final)


def _build() -> bool:
    """build.sh under temporary names, then both libraries moved into
    place. The caller holds _BUILD_LOCK."""
    tag = f".{os.getpid()}.tmp"
    so_tmp, glue_tmp = _SO.name + tag, _GLUE_SO.name + tag
    try:
        subprocess.run([str(_DIR / "build.sh"), so_tmp], check=True,
                       capture_output=True, timeout=120,
                       env={**os.environ, "LDT_GLUE_OUT": glue_tmp})  # ldt-lint: disable=knob-direct-env -- whole-environment passthrough to the build subprocess, not a config read
        if (_DIR / glue_tmp).exists():
            _install_built(glue_tmp, _GLUE_SO)
        _install_built(so_tmp, _SO)
        return _SO.exists()
    except Exception:
        return False
    finally:
        for name in (so_tmp, glue_tmp):
            for leftover in (_DIR / name, _DIR / f"{name}.host"):
                leftover.unlink(missing_ok=True)


_SYMBOLS = ("ldt_init", "ldt_pack_batch", "ldt_init_tables",
            "ldt_pack_flat_begin", "ldt_pack_flat_finish",
            "ldt_pack_flat_free", "ldt_epilogue_flat", "ldt_init_detect",
            "detect_language", "detect_language_n",
            "ldt_detect_one_full", "ldt_detect_batch_codes",
            "ldt_span_extents")
_ABI_VERSION = 11  # must match packer.cc ldt_abi_version()


def _try_load_all():
    """CDLL + symbol & ABI-version check; None for a missing or stale .so
    (older source set OR older ABI — signature/wire-layout changes bump
    _ABI_VERSION so a cached binary can never silently corrupt results)."""
    try:
        lib = ctypes.CDLL(str(_SO))
        lib.ldt_abi_version.restype = ctypes.c_int32
        if lib.ldt_abi_version() != _ABI_VERSION:
            return None
        for sym in _SYMBOLS:
            getattr(lib, sym).restype = None
        lib.ldt_pack_flat_begin.restype = ctypes.c_int64
        lib.detect_language.restype = ctypes.c_char_p
        lib.detect_language.argtypes = [ctypes.c_char_p]
        lib.detect_language_n.restype = ctypes.c_char_p
        lib.detect_language_n.argtypes = [ctypes.c_char_p,
                                          ctypes.c_int32]
        lib.ldt_detect_one_full.restype = ctypes.c_int32
        lib.ldt_span_extents.restype = ctypes.c_int32
        return lib
    except (OSError, AttributeError):
        return None


def _host_isa() -> str:
    """Fingerprint of this host's instruction set (build.sh writes the
    builder's into the .host sidecar). A mismatch means the cached .so
    was -march=native-compiled on different hardware — loading it risks
    SIGILL, so the loader rebuilds instead. md5 here is a checksum, not
    crypto (it matches build.sh's md5sum) — declared as such so FIPS
    OpenSSL builds allow it; where even that raises (md5 compiled out
    entirely), a constant that can never match any md5sum sidecar makes
    the loader rebuild once instead of crashing every native load."""
    import hashlib
    import platform
    flags = b""
    try:
        for line in Path("/proc/cpuinfo").read_bytes().splitlines():
            if line.startswith(b"flags"):
                flags = line + b"\n"  # grep emits the trailing newline
                break
    except OSError:
        pass
    try:
        digest = hashlib.md5(flags, usedforsecurity=False).hexdigest()
    except ValueError:
        digest = "md5-unavailable"
    return f"{platform.machine()}\n{digest}  -\n"


def _sidecar_ok(so: Path) -> bool:
    """ISA check for one .so via its .host sidecar. A MISSING or
    unreadable sidecar next to an existing .so means "ISA unknown, load
    anyway": read-only installs (containers, wheels) can never write
    sidecars, and rebuild-once-per-check would turn into
    rebuild-every-process there. Only a sidecar that EXISTS and
    disagrees forces a rebuild."""
    sidecar = so.with_suffix(".so.host")
    try:
        if not sidecar.exists():
            return True
        return sidecar.read_text() == _host_isa()
    except OSError:
        return True  # unreadable: treat as unknown, load anyway


def _isa_matches() -> bool:
    return _sidecar_ok(_SO)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with build_lock(_BUILD_LOCK):
            lib = (_try_load_all() if _SO.exists() and _isa_matches()
                   else None)
            if lib is None:
                # missing or stale: rebuild once (replacing the file in
                # place, never unlinking one another process may be
                # loading), then retry
                lib = _try_load_all() if _build() else None
        _lib = lib if lib is not None else False
        return _lib


def use_library(path) -> ctypes.CDLL:
    """Serve this process from the packer library at `path` instead of
    libldtpack_torch.so (tools/profile_pack.py's instrumented twin).
    Only before the library is first loaded; raises if it was, or if
    `path` fails the symbol and ABI checks (nothing is rebuilt)."""
    global _SO, _lib
    with _lock:
        if _lib is not None:
            raise RuntimeError("the packer library is loaded already")
        prev, _SO = _SO, Path(path)
        lib = _try_load_all()
        if lib is None:
            _SO = prev
            raise RuntimeError(f"{path}: not a packer library of ABI "
                               f"{_ABI_VERSION}")
        _lib = lib
        return lib


def available() -> bool:
    return bool(_load())


_initialized_for: tuple = ()

_glue = None
_GLUE_VERSION = 1  # must match pyglue.c ldt_glue_version()


def _try_load_glue(so: Path):
    """Load + contract-check the glue; None when unusable."""
    try:
        g = ctypes.PyDLL(str(so))
        g.ldt_glue_version.restype = ctypes.c_int64
        if g.ldt_glue_version() != _GLUE_VERSION:
            return None
        g.ldt_blob_from_list.restype = ctypes.c_int64
        g.ldt_blob_from_list.argtypes = [
            ctypes.py_object, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        g.ldt_blob_size.restype = ctypes.c_int64
        g.ldt_blob_size.argtypes = [ctypes.py_object]
        return g
    except (OSError, AttributeError):
        return None


def _load_glue():
    """Optional GIL-held marshalling helper (libldtglue.so, built by
    build.sh when CPython headers exist). ctypes.PyDLL: the GIL stays
    held across calls — every function inside touches CPython API.

    A unusable binary (missing, older than its source, wrong contract
    version, or foreign-ISA sidecar) triggers ONE glue-only rebuild —
    never the full build, which would rewrite the already-dlopen'd
    libldtpack.so in place — and only where CPython headers exist (a
    host without them must not recompile the packer per process).
    Failure after that caches False: Python marshalling path."""
    global _glue
    if _glue is not None:
        return _glue or None
    with _lock, build_lock(_BUILD_LOCK):
        if _glue is not None:
            return _glue or None
        so = _GLUE_SO

        def fresh() -> bool:
            try:
                return (so.exists()
                        and so.stat().st_mtime >=
                        (_DIR / "pyglue.c").stat().st_mtime
                        and _sidecar_ok(so))
            except OSError:
                return False

        g = _try_load_glue(so) if fresh() else None
        if g is None:
            import sysconfig
            incdir = sysconfig.get_paths()["include"]
            if (Path(incdir) / "Python.h").exists():
                tmp = f"{so.name}.{os.getpid()}.tmp"
                try:
                    subprocess.run(
                        [str(_DIR / "build.sh"), "--glue-only"],
                        check=True, capture_output=True, timeout=120,
                        # ldt-lint: disable=knob-direct-env -- whole-environment passthrough to the build subprocess, not a config read
                        env={**os.environ, "LDT_PYINC": incdir,
                             "LDT_GLUE_OUT": tmp})
                    if (_DIR / tmp).exists():
                        _install_built(tmp, so)
                    # re-verify freshness: build.sh exits 0 even when
                    # it could not compile, and loading the stale
                    # binary the check above just rejected would
                    # bypass the mtime/ISA protection entirely
                    if fresh():
                        g = _try_load_glue(so)
                except Exception:  # noqa: BLE001 - fall back quietly
                    g = None
                finally:
                    (_DIR / tmp).unlink(missing_ok=True)
                    (_DIR / f"{tmp}.host").unlink(missing_ok=True)
        _glue = g if g is not None else False
        return _glue or None


def _marshal_texts(texts: list):
    """list[str] -> (utf-8 blob u8 ndarray, bounds i64 ndarray). The C
    glue path is one encode + one memcpy with no per-doc bytes objects
    (~6ms/16K docs saved on the single-core host); the Python path
    handles everything else — non-list inputs, lone surrogates (encoded
    surrogatepass, exactly as before), or a missing glue .so.

    Memory trade-off, deliberate: PyUnicode_AsUTF8AndSize caches each
    non-ASCII str's UTF-8 form ON the str for its lifetime. Service
    texts are request-scoped (cache freed with them); a caller that
    detects a long-lived in-memory corpus pays ~2x its non-ASCII text
    RSS — such callers can pre-encode and use the bytes-based eval
    harness instead."""
    B = len(texts)
    g = _load_glue()
    if g is not None and type(texts) is list:
        bounds = np.empty(B + 1, np.int64)
        total = g.ldt_blob_size(ctypes.py_object(texts))
        if total >= 0:
            blob = np.empty(max(int(total), 1), np.uint8)
            r = g.ldt_blob_from_list(ctypes.py_object(texts),
                                     ctypes.c_int64(B),
                                     _ptr(blob, np.uint8),
                                     ctypes.c_int64(blob.nbytes),
                                     _ptr(bounds, np.int64))
            if r == total:
                return blob, bounds
    enc = [t.encode("utf-8", errors="surrogatepass") for t in texts]
    bounds = np.zeros(B + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=bounds[1:])
    blob = np.frombuffer(b"".join(enc), dtype=np.uint8) if bounds[-1] \
        else np.zeros(1, np.uint8)
    return np.ascontiguousarray(blob), bounds


def _ptr(a: np.ndarray, dtype):
    assert a.dtype == dtype and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


def _installed(tables: ScoringTables, reg: Registry) -> bool:
    return bool(_initialized_for) and _initialized_for[0] is tables \
        and _initialized_for[1] is reg


class _TableGate:
    """The library holds ONE set of tables for the whole process, and
    every pack or C-path detection reads it while it runs. A call
    enters the gate as a reader of the (tables, registry) pair it
    needs; installing another pair (a hot swap's new engine, a second
    engine in the process) waits until no reader is left, so it never
    frees or overwrites tables a running call still reads. Readers of
    the installed pair wait while a call for another pair is waiting,
    so two engines take turns instead of starving each other."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._waiting = 0   # calls waiting for another pair

    @contextlib.contextmanager
    def reading(self, tables: ScoringTables, reg: Registry):
        with self._cond:
            mine = False    # this call counts in _waiting
            while True:
                if _installed(tables, reg):
                    if mine or self._waiting == 0:
                        break
                    self._cond.wait()
                    continue
                if not mine:
                    mine = True
                    self._waiting += 1
                if self._readers == 0:
                    try:
                        _install(tables, reg)
                    except BaseException:
                        self._waiting -= 1
                        self._cond.notify_all()
                        raise
                else:
                    self._cond.wait()
            if mine:
                self._waiting -= 1
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                self._cond.notify_all()


_gate = _TableGate()


def _install(tables: ScoringTables, reg: Registry):
    """Upload table pointers for a (tables, registry) pair. Holds
    strong references to the actual objects (not ids — CPython recycles
    addresses). Called only through _TableGate, with no reader in the
    library."""
    global _initialized_for
    key = (tables, reg)
    lib = _load()
    with _lock:
        # nothing counts as installed until the whole upload is done
        _initialized_for = ()
        seed_lp = np.zeros(reg.num_scripts, np.uint32)
        for s in range(reg.num_scripts):
            lang = reg.default_language(s)
            seed_lp[s] = np.uint32(
                reg.per_script_number(ULSCRIPT_LATIN, lang) << 8)
        rtype = np.ascontiguousarray(reg.ulscript_rtype.astype(np.int32))
        deflang = np.ascontiguousarray(
            reg.ulscript_default_lang.astype(np.int32))
        script_of = np.ascontiguousarray(tables.script_of_cp, dtype=np.uint8)
        lower = np.arange(0x110000, dtype=np.uint32)
        lower[tables.lower_pairs[:, 0]] = tables.lower_pairs[:, 1]
        cjk_prop = np.ascontiguousarray(tables.cjk_uni_prop, dtype=np.uint8)
        _init_keepalive.clear()
        _init_keepalive.extend([seed_lp, rtype, deflang, script_of, lower,
                                cjk_prop])
        lib.ldt_init(
            _ptr(script_of, np.uint8), _ptr(lower, np.uint32),
            _ptr(cjk_prop, np.uint8), _ptr(rtype, np.int32),
            _ptr(deflang, np.int32), _ptr(seed_lp, np.uint32),
            ctypes.c_int32(reg.num_scripts),
            ctypes.c_int32(1 if tables.distinctbi.empty else 0))
        # host resolution tables (packer.cc resolve path); HostTables is
        # cached per (tables, reg) so the pointers stay alive with it
        from ..ops.device_tables import host_tables
        ht = host_tables(tables, reg)
        _init_keepalive.append(ht)
        # scoring indices and the per-script seeds must stay below the
        # hint-boost window, or wire idx values would alias into it
        if len(ht.cat_ind) + reg.num_scripts > HINT_BASE:
            raise RuntimeError(
                f"scoring tables too large for the u16 wire: "
                f"{len(ht.cat_ind)} + {reg.num_scripts} seed rows "
                f"reach the hint window at {HINT_BASE}")
        lib.ldt_init_tables(
            _ptr(ht.cat_buckets, np.uint32), _ptr(ht.cat_ind2, np.uint32),
            ctypes.c_int64(len(ht.cat_ind)),
            _ptr(ht.bucket_off, np.int64), _ptr(ht.size, np.uint32),
            _ptr(ht.keymask, np.uint32), _ptr(ht.ind_off, np.int32),
            _ptr(ht.size_one, np.int32), _ptr(ht.probes, np.uint8),
            ctypes.c_int64(ht.q2.bucket_off),
            ctypes.c_uint32(ht.q2.size), ctypes.c_uint32(ht.q2.keymask),
            ctypes.c_int32(ht.q2.ind_off), ctypes.c_int32(ht.q2.size_one),
            ctypes.c_int32(1 if ht.q2_enabled else 0),
            ctypes.c_int32(ht.seed_ind_base))
        # C ABI detection path (wrapper.h:8 seam): scoring + epilogue
        # tables so detect_language()/ldt_detect_batch_codes() run with
        # no Python in the loop
        lg3 = np.zeros((256, 3), np.uint8)
        lg3[:tables.lg_prob.shape[0]] = tables.lg_prob[:, 5:8]
        plang = np.ascontiguousarray(np.stack([
            reg.plang_to_lang_latn.astype(np.int32),
            reg.plang_to_lang_othr.astype(np.int32)]))
        n = reg.num_languages
        expected = np.zeros((n, 4), np.int32)
        es = tables.avg_delta_octa_score.astype(np.int32).reshape(-1, 4)
        expected[:min(n, es.shape[0])] = es[:n]
        close, alt, figs = _epilogue_reg_arrays(reg)
        stride = 8
        codes = np.zeros(n * stride, np.uint8)
        for lang in range(n):
            b = str(reg.lang_code[lang]).encode()[:stride - 1]
            codes[lang * stride:lang * stride + len(b)] = \
                np.frombuffer(b, np.uint8)
        _init_keepalive.extend([lg3, plang, expected, close, alt, figs,
                                codes])
        lib.ldt_init_detect(
            _ptr(lg3, np.uint8), _ptr(plang, np.int32),
            _ptr(expected, np.int32), _ptr(close, np.int32),
            _ptr(alt, np.int32), _ptr(figs, np.uint8),
            ctypes.c_int32(n),
            codes.ctypes.data_as(ctypes.c_char_p),
            ctypes.c_int32(stride))
        _initialized_for = key


def ensure_init(tables: ScoringTables, reg: Registry):
    """Public init seam for C-ABI hosts and tests: upload every table the
    native library needs (packing + the C-only detection path), exactly
    as the batched engine's first pack would."""
    lib = _load()
    if not lib:
        raise RuntimeError("native library unavailable")
    with _gate.reading(tables, reg):
        pass
    return lib


def pack_batch_native(texts: list[str], tables: ScoringTables,
                      reg: Registry, max_slots: int = 2048,
                      max_chunks: int = 64, max_direct: int = 4,
                      flags: int = 0, n_threads: int = 0) -> PackedBatch:
    """Native twin of preprocess.pack.pack_batch (same output contract)."""
    lib = _load()
    if not lib:
        raise RuntimeError("native packer unavailable")

    B, L, C, D = len(texts), max_slots, max_chunks, max_direct
    blob, bounds = _marshal_texts(texts)

    out = PackedBatch(
        kind=np.zeros((B, L), np.int8),
        offset=np.zeros((B, L), np.int32),
        fp=np.zeros((B, L), np.uint32),
        fp_hi=np.zeros((B, L), np.uint8),
        chunk_base=np.zeros((B, L), np.int32),
        span_start=np.zeros((B, L), np.int32),
        span_end_off=np.zeros((B, L), np.int32),
        side=np.zeros((B, L), np.int8),
        cjk=np.zeros((B, L), np.int8),
        script=np.zeros((B, L), np.int16),
        chunk_script=np.zeros((B, C), np.int16),
        chunk_cjk=np.zeros((B, C), np.int8),
        chunk_side=np.zeros((B, C), np.int8),
        chunk_span_end=np.zeros((B, C), np.int32),
        direct_adds=np.full((B, D, 3), -1, np.int32),
        text_bytes=np.zeros(B, np.int32),
        fallback=np.zeros(B, bool),
        n_slots=np.zeros(B, np.int32),
        n_chunks=np.zeros(B, np.int32),
        n_docs=B,
    )
    if n_threads <= 0:
        import os
        n_threads = min(8, os.cpu_count() or 1)
    with _gate.reading(tables, reg):
        lib.ldt_pack_batch(
            _ptr(blob, np.uint8), _ptr(bounds, np.int64),
            ctypes.c_int32(B), ctypes.c_int32(L), ctypes.c_int32(C),
            ctypes.c_int32(D), ctypes.c_int32(flags),
            ctypes.c_int32(n_threads),
            _ptr(out.kind, np.int8), _ptr(out.offset, np.int32),
            _ptr(out.fp, np.uint32), _ptr(out.fp_hi, np.uint8),
            _ptr(out.chunk_base, np.int32),
            _ptr(out.span_start, np.int32),
            _ptr(out.span_end_off, np.int32), _ptr(out.side, np.int8),
            _ptr(out.cjk, np.int8), _ptr(out.script, np.int16),
            _ptr(out.chunk_script, np.int16),
            _ptr(out.chunk_cjk, np.int8),
            _ptr(out.chunk_side, np.int8),
            _ptr(out.chunk_span_end, np.int32),
            out.direct_adds.ctypes.data_as(ctypes.c_void_p),
            _ptr(out.text_bytes, np.int32),
            out.fallback.ctypes.data_as(ctypes.c_void_p),
            _ptr(out.n_slots, np.int32), _ptr(out.n_chunks, np.int32))
    return out


# -- chunk-major flat wire (packer.cc ldt_pack_flat_begin/finish) -----------


@dataclasses.dataclass
class ChunkBatch:
    """Chunk-major flat wire + the per-doc host arrays the epilogue needs.

    The wire has NO document axis: all docs' resolved slots concatenate
    into idx, chunks are rows addressed by (cstart, cnsl), and the device
    program shape depends only on content volume (N slots, Gs chunks per
    shard, K = fattest chunk) — never on batch size or document length.
    """
    wire: dict               # idx [D,N] u16; cnsl [D,Gs] u8 (chunk
                             # starts derive on device by cumsum);
                             # cmeta [D,Gs] u32; cscript [D,Gs] u8;
                             # cwhack [D,Gs] u16 or [D,1] dummy when no
                             # doc carries whacks; k_iota [K] u8
    doc_chunk_start: np.ndarray  # [B] i64 first chunk row in flat [D*Gs]
    direct_adds: np.ndarray  # [B, Dcap, 3] i32
    text_bytes: np.ndarray   # [B] i32
    fallback: np.ndarray     # [B] bool
    squeezed: np.ndarray     # [B] bool
    n_slots: np.ndarray      # [B] i32 (0 for fallback docs)
    n_chunks: np.ndarray     # [B] i32
    n_docs: int = 0
    # want_ranges packs only — host-side result-vector sidecars, never
    # shipped to the device: soff/sorig [D,N] i32 per-slot span/original
    # offsets (-1 = boost/hint slot), clo/chi [D,Gs] i32 chunk ranges in
    # original bytes, crid [D,Gs] i32 hit-round ids (-1 = direct-add),
    # cdir [D,Gs] u8 direct-add flags
    ranges: dict | None = None
    # staging-ring lease backing the wire's bucketed arrays (None when
    # the pack allocated fresh arrays). The OWNER of the dispatch calls
    # release() once nothing can read the wire again: after its result
    # is back on the host and unpacked against cmeta.
    staging: "StagingLease | None" = None

    def release_staging(self, wait: bool = False) -> None:
        if self.staging is not None:
            self.staging.release(wait)
            self.staging = None


class StagingLease:
    """One checked-out set of staging arrays; release() returns it to
    its ring exactly once (idempotent, thread-safe via the ring lock).

    `copies` holds the CUDA event recorded after each asynchronous copy
    that reads the lease (ops/score.py wire_to_device): one per launch
    attempt, so a pool's hedge or failover relaunch of the same wire
    adds its own. release() hands the arrays back only once every event
    has completed. By default a release that finds one still pending
    waits for it and is counted (StagingRing.stats "pending_releases"),
    so the engine can show its readbacks order every release after its
    copies; release(wait=True) is the pooled path's explicit wait for
    the attempts no readback of the caller's ordered (a hedge loser's
    copy on another stream), and counts nothing."""

    __slots__ = ("ring", "key", "arrays", "copies", "_done")

    def __init__(self, ring: "StagingRing", key: tuple, arrays: dict):
        self.ring = ring
        self.key = key
        self.arrays = arrays
        self.copies: list = []
        self._done = False

    def add_copies(self, events) -> None:
        self.copies.extend(events)

    def release(self, wait: bool = False) -> None:
        evs, self.copies = self.copies, []
        if wait:
            for ev in evs:
                ev.synchronize()
        elif any(not ev.query() for ev in evs):
            self.ring._note_pending_release()
            for ev in evs:
                ev.synchronize()
        self.ring._release(self)


# numpy dtype -> the torch dtype of the same width that carries its bits
# in a pinned host tensor (torch's unsigned 16/32-bit support is partial)
_PIN_CARRIERS = {np.dtype(np.uint8): "uint8", np.dtype(np.uint16): "int16",
                 np.dtype(np.uint32): "int32"}


class StagingRing:
    """Per-bucket-tier ring of pre-allocated host staging arrays for the
    flat wire's bucketed lanes (idx/cnsl/cmeta/cscript/cwhack).

    The pipelined engine packs batch N+1 while batch N scores; without a
    ring every pack allocates (and the allocator touches) megabytes of
    fresh pages per dispatch. Arrays are keyed by the padded shape
    bucket (D, N, Gs, whacked), so steady state allocates nothing:
    acquire() hands back a zeroed lease from the free list, the pack
    writes it, the dispatch copies it to the device, and the engine
    releases it once its result is back on the host. Over-depth demand
    (ring empty) allocates a fresh set that joins the ring on release,
    up to `cap` sets per shape; beyond that the arrays are dropped.

    pinned=True (the CUDA engine): every array is a numpy view of a
    page-locked torch tensor, so the wire copies to the card
    asynchronously on the job's stream and the lease waits for that
    copy before it is reused (StagingLease.release). A failed pinned
    allocation raises; there is no pageable stand-in. pinned=False
    (the CPU engine) holds plain numpy arrays."""

    _KEYS = ("idx", "cnsl", "cmeta", "cscript", "cwhack")

    def __init__(self, cap: int = 4, pinned: bool = False):
        self.cap = cap
        self.pinned = pinned
        self._free: dict = {}      # key -> list[dict of arrays]
        self._out = 0              # leases currently checked out
        self._hits = 0             # acquires served from the free list
        self._misses = 0           # acquires that had to allocate
        self._pending = 0          # releases that found a copy in flight
        self._lock = make_lock("staging.ring")

    def _zeros(self, shape: tuple, dtype) -> np.ndarray:
        if not self.pinned:
            return np.zeros(shape, dtype)
        import torch
        carrier = getattr(torch, _PIN_CARRIERS[np.dtype(dtype)])
        t = torch.zeros(shape, dtype=carrier, pin_memory=True)
        return t.numpy().view(dtype)   # the view keeps the tensor alive

    def _alloc(self, key: tuple) -> dict:
        D, N, Gs, whacked = key
        return dict(idx=self._zeros((D, N), np.uint16),
                    cnsl=self._zeros((D, Gs), np.uint8),
                    cmeta=self._zeros((D, Gs), np.uint32),
                    cscript=self._zeros((D, Gs), np.uint8),
                    cwhack=self._zeros((D, Gs if whacked else 1),
                                       np.uint16))

    def acquire(self, D: int, N: int, Gs: int,
                whacked: bool) -> StagingLease:
        key = (D, N, Gs, whacked)
        with self._lock:
            free = self._free.get(key)
            arrays = free.pop() if free else None
            self._out += 1
            if arrays is not None:
                self._hits += 1
            else:
                self._misses += 1
        if arrays is None:
            try:
                arrays = self._alloc(key)
            except BaseException:
                with self._lock:
                    self._out -= 1
                raise
        else:
            for a in arrays.values():
                a.fill(0)  # pack relies on zero-initialized padding
        return StagingLease(self, key, arrays)

    def _note_pending_release(self) -> None:
        with self._lock:
            self._pending += 1

    def _release(self, lease: StagingLease) -> None:
        with self._lock:
            if lease._done:
                return
            lease._done = True
            self._out -= 1
            free = self._free.setdefault(lease.key, [])
            if len(free) < self.cap:
                free.append(lease.arrays)

    def stats(self) -> dict:
        with self._lock:
            return {"occupancy": self._out,
                    "hits": self._hits,
                    "misses": self._misses,
                    "shapes": len(self._free),
                    "pending_releases": self._pending}


def _next_pow2_min(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def _bucket_step(n: int, step: int, lo: int) -> int:
    """Shape bucket: powers of two from lo up to step, then multiples of
    step — small batches get small programs, large batches bound padding
    waste to one step, and the compiled program set stays small."""
    n = max(n, 1)
    if n >= step:
        return -(-n // step) * step
    b = lo
    while b < n:
        b <<= 1
    return b


# K buckets: the slot axis of one chunk row. Slot counts concentrate at
# 10-40; the ladder keeps padding compute <= 2x while capping the
# program count at 4 per (N, Gs) shape.
_K_BUCKETS = (32, 64, 128, 256)


# Hint-boost window base: wire idx values >= this address the per-batch
# hint_lp table instead of cat_ind2 (packer.cc kHintBase; scoring tables
# end well below it — validated at init)
HINT_BASE = 40960


def _hint_arrays(hint_boosts, B: int):
    """Per-doc HintBoosts -> (hint_lp table, hint_boost [B,2,4] window
    indices, whack_tbl [W,2,256] masks, doc_whack [B] rows). None when
    no doc carries hints (the common case packs hint-free)."""
    if hint_boosts is None or all(
            hb is None or hb.empty() for hb in hint_boosts):
        return None, None, None, None
    lp_index: dict = {}
    whack_index: dict = {((), ()): 0}  # row 0 = no whacks
    hint_boost = np.full((B, 2, 4), -1, np.int32)
    doc_whack = np.zeros(B, np.int32)
    whack_sets: list = [((), ())]
    for b, hb in enumerate(hint_boosts):
        if hb is None or hb.empty():
            continue
        for side, boosts in ((0, hb.boost_latn), (1, hb.boost_othr)):
            for s, lp in enumerate(list(boosts)[:4]):
                if lp <= 0:
                    continue
                w = lp_index.setdefault(int(lp), len(lp_index))
                hint_boost[b, side, s] = w
        wset = (tuple(sorted({(lp >> 8) & 0xFF
                              for lp in hb.whack_latn if lp > 0})),
                tuple(sorted({(lp >> 8) & 0xFF
                              for lp in hb.whack_othr if lp > 0})))
        if wset != ((), ()):
            row = whack_index.get(wset)
            if row is None:
                row = len(whack_sets)
                whack_index[wset] = row
                whack_sets.append(wset)
            doc_whack[b] = row
    if len(lp_index) > 16384:
        raise ValueError("too many distinct hint langprobs in one batch")
    hint_lp = np.zeros(max(len(lp_index), 1), np.uint32)
    for lp, w in lp_index.items():
        hint_lp[w] = lp
    whack_tbl = np.zeros((len(whack_sets), 2, 256), np.uint8)
    for row, (wl, wo) in enumerate(whack_sets):
        for ps in wl:
            whack_tbl[row, 0, ps] = 1
        for ps in wo:
            whack_tbl[row, 1, ps] = 1
    return hint_lp, hint_boost, whack_tbl, doc_whack


def pack_chunks_native(texts: list[str], tables: ScoringTables,
                       reg: Registry, flags: int = 0, n_shards: int = 1,
                       l_doc: int = 1 << 17, c_doc: int = 1 << 14,
                       max_direct: int = 64, n_threads: int = 0,
                       hint_boosts: list | None = None,
                       hint_priors: list | None = None,
                       want_ranges: bool = False,
                       staging: "StagingRing | None" = None) -> ChunkBatch:
    """texts -> chunk-major flat wire (one dispatch regardless of the
    batch's document-length mix). len(texts) must divide n_shards.
    hint_boosts: optional per-doc hints.HintBoosts (None entries fine) —
    prior boosts ride the wire as extra chunk slots addressing the
    hint_lp window; whacks become per-chunk mask rows.
    hint_priors: optional per-doc [2, 256] u8 prior vectors
    (hints.prior_vector, None entries fine) for the LDT_HINTS=1
    reduction term — deduped into a prior_tbl wire plane plus a
    per-chunk cprior row index. The cprior/prior_tbl keys exist ONLY
    when at least one document carries a prior, so prior-free batches
    trace the identical device program they always did."""
    lib = _load()
    if not lib:
        raise RuntimeError("native packer unavailable")

    B, Dc = len(texts), max_direct
    hint_lp, hint_boost, whack_tbl, doc_whack = _hint_arrays(
        hint_boosts, B)
    assert B % n_shards == 0, (B, n_shards)
    blob, bounds = _marshal_texts(texts)

    direct_adds = np.full((B, Dc, 3), -1, np.int32)
    text_bytes = np.zeros(B, np.int32)
    fallback = np.zeros(B, bool)
    squeezed = np.zeros(B, bool)
    n_slots = np.zeros(B, np.int32)
    n_chunks = np.zeros(B, np.int32)
    max_nsl = ctypes.c_int32(0)
    if n_threads <= 0:
        import os
        # CPU-bound work: one worker per core. Oversubscribing a
        # single-core host costs ~4ms/16K-doc batch in fresh-thread
        # page faults and context switches (workers spawn per batch,
        # so their thread-local scratch never stays warm), while the
        # nt=1 path packs on the calling thread with persistent
        # scratch.
        n_threads = min(16, os.cpu_count() or 1)
    # begin packs (it reads the installed tables); finish only lays the
    # packed batch out into the wire arrays
    with _gate.reading(tables, reg):
        handle = lib.ldt_pack_flat_begin(
            _ptr(blob, np.uint8), _ptr(bounds, np.int64),
            ctypes.c_int32(B), ctypes.c_int32(l_doc),
            ctypes.c_int32(c_doc), ctypes.c_int32(Dc),
            ctypes.c_int32(flags), ctypes.c_int32(n_threads),
            ctypes.c_int32(1 if want_ranges else 0),
            _ptr(hint_boost, np.int32) if hint_boost is not None
            else ctypes.c_void_p(None),
            _ptr(direct_adds, np.int32), _ptr(text_bytes, np.int32),
            fallback.ctypes.data_as(ctypes.c_void_p),
            squeezed.ctypes.data_as(ctypes.c_void_p),
            _ptr(n_slots, np.int32), _ptr(n_chunks, np.int32),
            ctypes.byref(max_nsl))

    lease = None
    try:
        D = n_shards
        shard_slots = n_slots.reshape(D, B // D).sum(axis=1)
        shard_chunks = n_chunks.reshape(D, B // D).sum(axis=1)
        # 32K-slot / 8K-chunk step granularity: padding waste stays
        # bounded while the compiled program set stays small (shapes
        # repeat across batches)
        N = _bucket_step(int(shard_slots.max()), 32768, 4096)
        Gs = _bucket_step(int(shard_chunks.max()), 8192, 512)
        K = next(k for k in _K_BUCKETS if k >= max(int(max_nsl.value), 1))

        if staging is not None:
            lease = staging.acquire(D, N, Gs, doc_whack is not None)
            idx = lease.arrays["idx"]
            cnsl = lease.arrays["cnsl"]
            cmeta = lease.arrays["cmeta"]
            cscript = lease.arrays["cscript"]
            cwhack = lease.arrays["cwhack"]
        else:
            idx = np.zeros((D, N), np.uint16)
            cnsl = np.zeros((D, Gs), np.uint8)
            cmeta = np.zeros((D, Gs), np.uint32)
            cscript = np.zeros((D, Gs), np.uint8)
            # hint-free batches (the overwhelmingly common case) ship a
            # 1-wide dummy whack lane: the scorer skips the whack gather
            # at trace time and ~64KB/batch stays off the wire
            cwhack = np.zeros((D, Gs if doc_whack is not None else 1),
                              np.uint16)
        doc_chunk_start = np.zeros(B, np.int64)
        # hint leaves pad to power-of-two buckets to bound program-count
        # growth with hint-table size. Per (N, Gs, K) shape there are
        # exactly TWO program variants — whack-free (1-wide cwhack
        # dummy, the overwhelmingly common case, 64KB/batch lighter) and
        # whacked — a deliberate trade of one extra compile at a warm
        # shape's first whacked batch for wire off every plain batch
        Hb = _next_pow2_min(len(hint_lp) if hint_lp is not None else 1,
                            32)
        hint_lp_w = np.zeros(Hb, np.uint32)
        if hint_lp is not None:
            hint_lp_w[:len(hint_lp)] = hint_lp
        Wb = _next_pow2_min(
            whack_tbl.shape[0] if whack_tbl is not None else 1, 1)
        whack_w = np.zeros((Wb, 2, 256), np.uint8)
        if whack_tbl is not None:
            whack_w[:whack_tbl.shape[0]] = whack_tbl
        if want_ranges:
            ranges = dict(soff=np.zeros((D, N), np.int32),
                          sorig=np.zeros((D, N), np.int32),
                          clo=np.zeros((D, Gs), np.int32),
                          chi=np.zeros((D, Gs), np.int32),
                          crid=np.zeros((D, Gs), np.int32),
                          cdir=np.zeros((D, Gs), np.uint8))
        else:
            ranges = None
    except BaseException:
        # finish() is the only free-er; without this the C++-owned
        # compacted batch would leak on allocation failure / interrupt
        if lease is not None:
            lease.release()
        lib.ldt_pack_flat_free(ctypes.c_int64(handle))
        raise
    lib.ldt_pack_flat_finish(
        ctypes.c_int64(handle), ctypes.c_int32(B), ctypes.c_int32(D),
        ctypes.c_int32(N), ctypes.c_int32(Gs),
        _ptr(n_slots, np.int32), _ptr(n_chunks, np.int32),
        _ptr(doc_whack, np.int32) if doc_whack is not None
        else ctypes.c_void_p(None),
        _ptr(idx, np.uint16),
        _ptr(cnsl, np.uint8), _ptr(cmeta, np.uint32),
        _ptr(cscript, np.uint8),
        _ptr(cwhack, np.uint16) if doc_whack is not None
        else ctypes.c_void_p(None),
        _ptr(doc_chunk_start, np.int64),
        _ptr(ranges["soff"], np.int32) if ranges is not None
        else ctypes.c_void_p(None),
        _ptr(ranges["sorig"], np.int32) if ranges is not None
        else ctypes.c_void_p(None),
        _ptr(ranges["clo"], np.int32) if ranges is not None
        else ctypes.c_void_p(None),
        _ptr(ranges["chi"], np.int32) if ranges is not None
        else ctypes.c_void_p(None),
        _ptr(ranges["crid"], np.int32) if ranges is not None
        else ctypes.c_void_p(None),
        _ptr(ranges["cdir"], np.uint8) if ranges is not None
        else ctypes.c_void_p(None))
    wire = dict(idx=idx, cnsl=cnsl, cmeta=cmeta,
                cscript=cscript, cwhack=cwhack, hint_lp=hint_lp_w,
                whack_tbl=whack_w, k_iota=np.zeros(K, np.uint8))
    if hint_priors is not None and any(p is not None for p in hint_priors):
        # LDT_HINTS=1 prior term: dedup the per-doc [2, 256] planes into
        # a pow2-padded table (row 0 = the no-prior zero plane) and mark
        # each document's chunks with its row via the flat contiguity
        # invariant. Fresh allocations, not the staging ring — priors
        # ride only the rare hinted lane, so pinning ring capacity for
        # them would tax every plain batch.
        planes: list[bytes] = [bytes(2 * 256)]
        plane_row: dict[bytes, int] = {planes[0]: 0}
        cprior = np.zeros((D, Gs), np.uint16)
        cprior_flat = cprior.reshape(-1)
        for b in range(min(B, len(hint_priors))):
            pv = hint_priors[b]
            if pv is None:
                continue
            key = np.ascontiguousarray(pv, dtype=np.uint8).tobytes()
            row = plane_row.get(key)
            if row is None:
                row = len(planes)
                planes.append(key)
                plane_row[key] = row
            s = int(doc_chunk_start[b])
            cprior_flat[s:s + int(n_chunks[b])] = row
        Pb = _next_pow2_min(len(planes), 1)
        prior_tbl = np.zeros((Pb, 2, 256), np.uint8)
        for row, key in enumerate(planes):
            prior_tbl[row] = np.frombuffer(key, np.uint8).reshape(2, 256)
        wire["cprior"] = cprior
        wire["prior_tbl"] = prior_tbl
    return ChunkBatch(wire=wire, doc_chunk_start=doc_chunk_start,
                      direct_adds=direct_adds, text_bytes=text_bytes,
                      fallback=fallback, squeezed=squeezed,
                      n_slots=n_slots, n_chunks=n_chunks, n_docs=B,
                      ranges=ranges, staging=lease)


# Reference 160KB-per-document scoring subset (packer.cc
# kCabiMaxScoreBytes; compact_lang_det_impl.h:159-161): the all-C
# single-doc path answers anything real at or under this (only
# adversarial >32K-script-flip constructions exceed its budget ladder,
# and those report failure so callers can fall back).
MAX_SCORE_BYTES = 160 << 10


def detect_one_native(text: str, tables: ScoringTables, reg: Registry):
    """One document through the all-C pipeline (pack -> C chunk scorer
    -> epilogue -> gate recursion; packer.cc detect_one_row): the fast
    path behind the public detect(). Returns the ldt_epilogue_flat
    14-lane row as a list, or None when the native library is
    unavailable or the text exceeds the C seam's 160KB scoring subset
    (the scalar engine scans everything, so oversized docs keep
    Python-visible behavior)."""
    lib = _load()
    if not lib:
        return None
    enc = text.encode("utf-8", errors="surrogatepass")
    if len(enc) > MAX_SCORE_BYTES:
        return None
    out = (ctypes.c_int64 * 14)()
    with _gate.reading(tables, reg):
        ok = lib.ldt_detect_one_full(enc, ctypes.c_int32(len(enc)), out)
    if not ok:
        return None  # adversarial budget overflow: caller goes scalar
    return list(out)


def span_extents_native(texts: list[str], tables: ScoringTables,
                        reg: Registry,
                        n_threads: int = 0) -> list[list[SpanExtent]]:
    """preprocess.pack.span_extents for each text, through the packer's
    own C++ segmentation (ldt_span_extents: the GIL released, the texts
    shared among n_threads threads; 0 = one a core up to 8). The
    long-doc lane's span scan. Raises when the library is unavailable."""
    lib = _load()
    if not lib:
        raise RuntimeError("native library unavailable")
    if not texts:
        return []
    B = len(texts)
    blob, bounds = _marshal_texts(texts)
    lens = np.diff(bounds)
    # a span holds at least one letter; its buffer at most a leading
    # space, 4 bytes a source letter byte (lowercasing can lengthen a
    # letter) and one separator a letter run
    ext_off = np.zeros(B + 1, np.int64)
    np.cumsum(lens + 1, out=ext_off[1:])
    byte_off = np.zeros(B + 1, np.int64)
    np.cumsum(6 * lens + 16, out=byte_off[1:])
    ext = np.empty(4 * int(ext_off[-1]), np.int32)
    out = np.empty(int(byte_off[-1]), np.uint8)
    n_spans = np.empty(B, np.int32)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    with _gate.reading(tables, reg):
        lib.ldt_span_extents(
            _ptr(blob, np.uint8), _ptr(bounds, np.int64), ctypes.c_int32(B),
            ctypes.c_int32(n_threads), _ptr(ext_off, np.int64),
            _ptr(ext, np.int32), _ptr(byte_off, np.int64),
            _ptr(out, np.uint8), _ptr(n_spans, np.int32))
    if (n_spans < 0).any():
        raise RuntimeError("ldt_span_extents failed")
    res = []
    for b, k in enumerate(n_spans.tolist()):
        e0, off = 4 * int(ext_off[b]), int(byte_off[b])
        spans = []
        for s0, s1, script, tb in \
                ext[e0:e0 + 4 * k].reshape(k, 4).tolist():
            spans.append(SpanExtent(s0, s1, script,
                                    out[off:off + tb].tobytes()))
            off += tb
        res.append(spans)
    return res


def detect_batch_codes_native(texts: list[str], tables: ScoringTables,
                              reg: Registry,
                              n_threads: int = 0) -> np.ndarray | None:
    """Language ids for a small batch through the all-C pipeline
    (ldt_detect_batch_codes) — no device dispatch, so a tiny service
    flush answers in ~1ms instead of paying the backend's fixed
    dispatch latency. Returns None when the native library is
    unavailable or any document exceeds the 160KB C-path subset."""
    lib = _load()
    if not lib:
        return None
    B = len(texts)
    blob, bounds = _marshal_texts(texts)
    if int(np.diff(bounds).max(initial=0)) > MAX_SCORE_BYTES:
        return None
    out = np.zeros(B, np.int32)
    if n_threads <= 0:
        import os
        n_threads = min(8, os.cpu_count() or 1)
    with _gate.reading(tables, reg):
        lib.ldt_detect_batch_codes(
            _ptr(blob, np.uint8), _ptr(bounds, np.int64),
            ctypes.c_int32(B), ctypes.c_int32(n_threads),
            _ptr(out, np.int32))
    return out


def epilogue_flat_native(rows: np.ndarray, cb: ChunkBatch, flags: int,
                         reg: Registry,
                         skip: np.ndarray | None = None) -> np.ndarray:
    """Chunk-major document epilogue (epilogue.cc ldt_epilogue_flat).

    rows: [G, 5] int32 chunk summaries in flat wire order.
    Returns the ldt_epilogue_batch [B, 14] contract."""
    lib = _load()
    if not lib:
        raise RuntimeError("native epilogue unavailable")
    B = cb.n_docs
    Dc = cb.direct_adds.shape[1]
    close, alt, figs = _epilogue_reg_arrays(reg)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    sk = np.ascontiguousarray(
        cb.fallback if skip is None else skip, dtype=np.uint8)
    out = np.zeros((B, 14), np.int64)
    lib.ldt_epilogue_flat(
        _ptr(rows, np.int32), _ptr(cb.doc_chunk_start, np.int64),
        _ptr(cb.n_chunks, np.int32), _ptr(cb.direct_adds, np.int32),
        _ptr(cb.text_bytes, np.int32), _ptr(sk, np.uint8),
        ctypes.c_int32(B), ctypes.c_int32(Dc), ctypes.c_int32(flags),
        _ptr(close, np.int32), _ptr(alt, np.int32), _ptr(figs, np.uint8),
        ctypes.c_int32(len(close)), _ptr(out, np.int64))
    return out


# -- batched document epilogue (epilogue.cc) --------------------------------

_epi_reg_cache: tuple = ()  # single slot: (registry object, arrays)


def _epilogue_reg_arrays(reg: Registry):
    """close_set / closest_alt / is_figs as flat arrays, cached for the
    last-used registry object (held by strong reference — never key by
    id(), CPython recycles addresses)."""
    global _epi_reg_cache
    if _epi_reg_cache and _epi_reg_cache[0] is reg:
        return _epi_reg_cache[1]
    n = reg.num_languages
    close = np.zeros(n, np.int32)
    for lang in range(n):
        close[lang] = reg.close_set(lang)
    alt = np.full(n, 26, np.int32)
    alt[:len(reg.closest_alt_lang)] = reg.closest_alt_lang.astype(np.int32)
    figs = np.zeros(n, np.uint8)
    for code in ("fr", "it", "de", "es"):
        figs[reg.code_to_lang[code]] = 1
    arrays = (close, alt, figs)
    _epi_reg_cache = (reg, arrays)
    return arrays
