"""The port's kernel-library bundle (language_detector_tpu_torch/aot.py)
on the CPU.

tests/test_aot.py's cases, ported: every key field (table digest, torch,
CUDA, device arch, kernel mode, kernel source) refuses loudly on a
mismatch under its own reason; a corrupt entry is refused by the CRC
(driven through the `aot_load` seam's corrupt rule); LDT_AOT_REQUIRE
escalates refusal to the typed AotError; a refused entry is rebuilt and
overwritten (self-heal); the bundle dir is created when missing; the
bundle is off without the knob; preload loads every entry once. The
store takes its loader and builder as arguments, so a stand-in library
(bytes a stand-in compiler writes) drives every path here; the load
order of ops/kernels.py (loaded library, bundle entry, compile cache,
nvcc) runs with the stand-ins patched into the kernel module. The entry
framing is byte for byte the reference's, and ENOSPC disables exports
for good. The card-side proof (a fresh process with no nvcc loading the
real library) is tests/test_torch_cuda.py's and chip_smoke.py's phase
`coldstart`.
"""
from __future__ import annotations

import errno
import hashlib
import json
import os
from pathlib import Path

import pytest

from language_detector_tpu import aot as jaot
from language_detector_tpu_torch import aot, faults, telemetry
from language_detector_tpu_torch.ops import kernels
from language_detector_tpu_torch.ops.device_tables import DeviceTables
from language_detector_tpu_torch.registry import registry
from language_detector_tpu_torch.tables import load_tables

KEY = {"digest": "d" * 16, "torch": "2.9.0+cu128", "cuda": "12.8",
       "arch": "sm_90", "kernel": "cuda", "source": "5" * 16}
SOURCE = "extern \"C\" int ldt_fused_tote() { return 0; }\n"
FLAGS = ["-O3", "-shared"]


class FakeLib:
    """Stand-in for a loaded library: the bytes it was loaded from."""

    def __init__(self, data: bytes):
        self.data = data


def fake_loader(path) -> FakeLib:
    data = Path(path).read_bytes()
    if data.startswith(b"BAD"):
        raise OSError(f"{path}: invalid ELF header")
    return FakeLib(data)


def fake_library(source: str, flags) -> bytes:
    return b"LIB:" + hashlib.sha256(source.encode() + json.dumps(
        list(flags)).encode()).digest()


class FakeCompiler:
    """Stand-in builder (AotStore's signature) that counts its runs."""

    def __init__(self):
        self.runs = 0

    def __call__(self, source: str, flags, out) -> Path:
        self.runs += 1
        Path(out).write_bytes(fake_library(source, flags))
        return Path(out)


def _store(tmp_path, key=None, require=False, sub="bundle"):
    d = tmp_path / sub
    d.mkdir(exist_ok=True)
    comp = FakeCompiler()
    st = aot.AotStore(str(d), key or KEY, require, loader=fake_loader,
                      builder=comp, scratch=tmp_path / "scratch")
    st.compiler = comp
    return st


def _write_entry(store, native: bytes = b"LIB:native",
                 portable: bytes | None = None) -> Path:
    lib = Path(store.dir) / "built.so"
    lib.write_bytes(native)
    assert store.offer(aot.LIBRARY, lib, aot.portable_payload(
        SOURCE, FLAGS) if portable is None else portable)
    lib.unlink()
    return Path(store.dir) / aot.entry_name("cuda", aot.LIBRARY)


def _refused(reason: str) -> int:
    return telemetry.REGISTRY.counter_value("ldt_aot_refused_total",
                                            reason=reason)


# -- entry framing -------------------------------------------------------------


@pytest.mark.parametrize("hlo,xc", [(b"", b""), (b"source", b""),
                                    (b"", b"\x7fELF" + bytes(range(256))),
                                    (b'{"flags": []}', b"\x00" * 4097)])
def test_pack_entry_is_the_references_bytes(hlo, xc):
    meta = dict(KEY, shapes=[["idx", [3], "int16"]])
    blob = aot._pack_entry(meta, hlo, xc)
    assert blob == jaot._pack_entry(meta, hlo, xc)
    assert aot._unpack_entry(blob) == jaot._unpack_entry(blob)
    assert (aot.MAGIC, aot._LEN.format, aot._CRC.format) == \
        (jaot.MAGIC, jaot._LEN.format, jaot._CRC.format)


@pytest.mark.parametrize("mangle", [lambda b: b[:-1],
                                    lambda b: b"NOTMAGIC" + b[8:],
                                    lambda b: b[:20],
                                    lambda b: b[:30] + bytes([b[30] ^ 4])
                                    + b[31:]])
def test_unpack_refuses_damaged_entries(mangle):
    blob = aot._pack_entry(KEY, b"p", b"n")
    with pytest.raises(aot.AotError):
        aot._unpack_entry(mangle(blob))


def test_table_digest_equals_reference():
    from language_detector_tpu.ops.device_tables import \
        DeviceTables as JaxTables
    from language_detector_tpu.registry import registry as jreg
    from language_detector_tpu.tables import load_tables as jload
    tdt = DeviceTables.from_host(load_tables(), registry, "cpu")
    assert aot.table_digest_hex(tdt) == \
        jaot.table_digest_hex(JaxTables.from_host(jload(), jreg))


def test_library_key_fields():
    import torch
    dt = DeviceTables.from_host(load_tables(), registry, "cpu")
    key = aot.library_key(dt, SOURCE, FLAGS)
    assert list(key) == ["digest", "torch", "cuda", "arch", "kernel",
                         "source"]
    assert key["torch"] == torch.__version__
    assert key["arch"] == "cpu" and key["kernel"] == "cuda"
    assert key["source"] != aot.library_key(dt, SOURCE + " ",
                                            FLAGS)["source"]
    assert key["source"] != aot.library_key(dt, SOURCE,
                                            FLAGS[:1])["source"]


# -- happy path ----------------------------------------------------------------


def test_export_then_load_native(tmp_path):
    writer = _store(tmp_path)
    entry = _write_entry(writer, b"LIB:bytes-of-the-library")
    assert entry.exists() and writer.stats()["exports"] == 1
    reader = _store(tmp_path)
    lib = reader.lookup()
    assert lib.data == b"LIB:bytes-of-the-library"
    assert reader.compiler.runs == 0
    st = reader.stats()
    assert (st["loads"], st["refusals"], st["entries"]) == (1, 0, 1)
    # memoized: a second lookup loads nothing
    assert reader.lookup() is lib and reader.stats()["loads"] == 1
    # the private file the library was loaded from is gone
    assert not list((tmp_path / "scratch").glob("*.so"))


def test_portable_payload_costs_one_build(tmp_path):
    """A native payload that does not load falls to the portable source:
    one build, then load."""
    writer = _store(tmp_path)
    _write_entry(writer, b"BAD native library")
    reader = _store(tmp_path)
    lib = reader.lookup()
    assert lib.data == fake_library(SOURCE, FLAGS)
    assert reader.compiler.runs == 1
    assert reader.stats()["refusals"] == 0


def test_preload_loads_every_entry(tmp_path):
    _write_entry(_store(tmp_path))
    store = _store(tmp_path)
    assert store.preload() == 1
    assert store.stats()["loads"] == 1
    assert store.preload() == 0


def test_offer_skips_loaded_and_written(tmp_path):
    writer = _store(tmp_path)
    _write_entry(writer)
    lib = tmp_path / "again.so"
    lib.write_bytes(b"LIB:again")
    assert not writer.offer(aot.LIBRARY, lib, b"")  # already wrote it
    reader = _store(tmp_path)
    assert reader.lookup() is not None
    assert not reader.offer(aot.LIBRARY, lib, b"")  # loaded it


# -- refusal matrix --------------------------------------------------------------


@pytest.mark.parametrize("field", list(KEY))
def test_key_mismatch_refused(tmp_path, field):
    """An entry whose meta lies in one field (valid CRC, the original
    file name: only the key cross-check can catch it)."""
    entry = _write_entry(_store(tmp_path))
    meta, hlo, xc = aot._unpack_entry(entry.read_bytes())
    entry.write_bytes(aot._pack_entry(dict(meta, **{field: "other"}),
                                      hlo, xc))
    before = _refused(f"{field}_mismatch")
    store = _store(tmp_path)
    assert store.lookup() is None
    assert store.stats()["refusals"] == 1
    assert _refused(f"{field}_mismatch") == before + 1
    assert store.compiler.runs == 0


@pytest.mark.parametrize("reason,make", [
    ("corrupt", lambda e: e.write_bytes(e.read_bytes()[:-3])),
    ("io_error", lambda e: (e.unlink(), e.mkdir())),
    ("empty", lambda e: e.write_bytes(aot._pack_entry(KEY, b"", b""))),
    ("undeserializable",
     lambda e: e.write_bytes(aot._pack_entry(KEY, b"", b"BAD lib"))),
    ("undeserializable",
     lambda e: e.write_bytes(aot._pack_entry(KEY, b"{not json", b"")))])
def test_unusable_entry_refused(tmp_path, reason, make):
    make(_write_entry(_store(tmp_path)))
    before = _refused(reason)
    store = _store(tmp_path)
    assert store.lookup() is None
    assert _refused(reason) == before + 1
    assert store.stats()["refusals"] == 1


def test_missing_entry_is_silent_unless_required(tmp_path):
    before = _refused("missing")
    assert _store(tmp_path).lookup() is None
    assert _refused("missing") == before
    with pytest.raises(aot.AotError, match="missing"):
        _store(tmp_path, require=True).lookup()
    assert _refused("missing") == before + 1


def test_corrupt_entry_refused_via_fault_seam(tmp_path):
    _write_entry(_store(tmp_path))
    faults.configure("aot_load:corrupt:seed=5")
    try:
        store = _store(tmp_path)
        assert store.preload() == 0
        assert store.stats()["refusals"] == 1
        with pytest.raises(aot.AotError, match="corrupt"):
            _store(tmp_path, require=True).lookup()
    finally:
        faults.configure(None)
    assert _store(tmp_path).lookup() is not None  # the file is intact


def test_require_escalates_to_typed_error(tmp_path):
    _write_entry(_store(tmp_path))
    store = _store(tmp_path, key=dict(KEY, digest="f" * 16), require=True)
    with pytest.raises(aot.AotError, match="digest_mismatch"):
        store.preload()


# -- write-back: ENOSPC, the export seam ---------------------------------------


def test_export_enospc_sticky_disable(tmp_path, monkeypatch):
    store = _store(tmp_path)
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"LIB:x")
    before = telemetry.REGISTRY.counter_value("ldt_aot_disabled_total",
                                              reason="enospc")

    def full(*a):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(aot.os, "replace", full)
    assert store.offer(aot.LIBRARY, lib, b"") is False
    assert store.export_disabled is True
    assert store.stats()["export_disabled"] is True
    assert telemetry.REGISTRY.counter_value(
        "ldt_aot_disabled_total", reason="enospc") == before + 1
    monkeypatch.undo()
    # sticky: the next offer is refused before any write
    assert store.offer(aot.LIBRARY, lib, b"") is False
    assert telemetry.REGISTRY.counter_value(
        "ldt_aot_disabled_total", reason="enospc") == before + 1
    assert not list(Path(store.dir).glob("*.ldtx"))


def test_export_seam_error_not_sticky(tmp_path):
    store = _store(tmp_path)
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"LIB:x")
    faults.configure("aot_export:error:once")
    try:
        assert store.offer(aot.LIBRARY, lib, b"") is False
        assert store.export_disabled is False
        assert store.offer(aot.LIBRARY, lib, b"") is True
    finally:
        faults.configure(None)
    assert store.stats()["exports"] == 1


# -- the kernel module's load order, with a stand-in toolchain -------------------


@pytest.fixture
def toolchain(tmp_path, monkeypatch):
    """kernels' nvcc run and ctypes load replaced by the stand-ins, its
    process state reset; returns a function that starts a fresh
    'process' (library unloaded, builds 0) on a compile-cache dir."""

    def fake_nvcc(src, flags, out, verbose):
        kernels.builds += 1
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(fake_library(Path(src).read_text(), flags))
        return out

    monkeypatch.setattr(kernels, "_nvcc_build", fake_nvcc)
    monkeypatch.setattr(kernels, "load_library", fake_loader)
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "builds", 0)
    monkeypatch.setenv("LDT_AOT_DIR", str(tmp_path / "bundle"))
    monkeypatch.delenv("LDT_AOT_REQUIRE", raising=False)
    dt = DeviceTables.from_host(load_tables(), registry, "cpu")

    def fresh(cache: str, require: bool = False):
        monkeypatch.setattr(kernels, "_lib", None)
        monkeypatch.setattr(kernels, "builds", 0)
        monkeypatch.setenv("LDT_COMPILE_CACHE_DIR", str(tmp_path / cache))
        monkeypatch.setenv("LDT_AOT_REQUIRE", "1" if require else "0")
        return aot.build_from_env(dt)

    return fresh


def _entry(tmp_path) -> Path:
    return tmp_path / "bundle" / aot.entry_name("cuda", aot.LIBRARY)


def test_kernels_load_order(toolchain, tmp_path):
    """Cold: one build into the compile cache, one export. Boot-hot: an
    empty compile cache, the bundle, REQUIRE: no build, one load of the
    same library bytes. Already loaded: nothing at all."""
    store = toolchain("cache-a")
    lib = kernels._load(store)
    assert kernels.builds == 1 and store.stats()["exports"] == 1
    assert (tmp_path / "cache-a" / kernels.LIB_NAME).exists()
    built = lib.data

    store = toolchain("cache-b", require=True)
    hot = kernels._load(store)
    assert kernels.builds == 0 and hot.data == built
    assert store.stats()["loads"] == 1
    assert not (tmp_path / "cache-b" / kernels.LIB_NAME).exists()

    other = aot.build_from_env(DeviceTables.from_host(
        load_tables(), registry, "cpu"))
    assert kernels._load(other) is hot and other.stats()["loads"] == 0


def test_kernels_load_compile_cache_hit_exports(toolchain, tmp_path):
    """A compile cache that already holds the library: no build, and the
    library is still written into the empty bundle."""
    kernels._load(toolchain("cache"))
    _entry(tmp_path).unlink()
    store = toolchain("cache")
    kernels._load(store)
    assert kernels.builds == 0 and store.stats()["exports"] == 1
    assert _entry(tmp_path).exists()


def test_kernels_corrupt_entry_require_raises_else_heals(toolchain,
                                                         tmp_path):
    kernels._load(toolchain("cold"))
    faults.configure("aot_load:corrupt:seed=11")
    try:
        with pytest.raises(aot.AotError, match="corrupt"):
            kernels._load(toolchain("c1", require=True))
        assert kernels._lib is None and kernels.builds == 0
        store = toolchain("c2")
        kernels._load(store)
    finally:
        faults.configure(None)
    st = store.stats()
    assert (st["refusals"], st["exports"], kernels.builds) == (1, 1, 1)
    healed = toolchain("c3", require=True)
    kernels._load(healed)
    assert kernels.builds == 0 and healed.stats()["loads"] == 1


def test_refused_entry_falls_back_and_self_heals(toolchain, tmp_path):
    """A stale bundle (wrong digest in the entry) is refused, rebuilt
    and overwritten with the live key."""
    kernels._load(toolchain("cold"))
    e = _entry(tmp_path)
    meta, hlo, xc = aot._unpack_entry(e.read_bytes())
    e.write_bytes(aot._pack_entry(dict(meta, digest="0" * 16), hlo, xc))
    store = toolchain("fresh")
    kernels._load(store)
    st = store.stats()
    assert st["refusals"] == 1 and st["exports"] == 1
    assert kernels.builds == 1
    meta, _, _ = aot._unpack_entry(e.read_bytes())
    assert meta["digest"] == store.digest


def test_kernels_without_bundle_never_exports(toolchain, tmp_path,
                                              monkeypatch):
    monkeypatch.delenv("LDT_AOT_DIR")
    assert toolchain("cache") is None
    kernels._load(None)
    assert kernels.builds == 1 and not (tmp_path / "bundle").exists()


# -- the engine's store -------------------------------------------------------


def _engine(monkeypatch, **env):
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    monkeypatch.delenv("LDT_AOT_DIR", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return NgramBatchEngine(device="cpu")


def test_aot_dir_created_when_missing(monkeypatch, tmp_path):
    target = tmp_path / "nested" / "aot-bundle"
    eng = _engine(monkeypatch, LDT_AOT_DIR=str(target))
    assert eng._aot is not None and target.is_dir()
    assert eng._aot.digest == aot.table_digest_hex(eng.dt)
    st = eng.stats_snapshot()
    assert (st["aot_loads"], st["aot_exports"], st["aot_refusals"]) == \
        (0, 0, 0)


def test_aot_off_without_knob(monkeypatch):
    eng = _engine(monkeypatch)
    assert eng._aot is None
    assert "aot_loads" not in eng.stats_snapshot()


def test_compile_cache_dir_knob(monkeypatch, tmp_path):
    monkeypatch.delenv("LDT_COMPILE_CACHE_DIR", raising=False)
    assert kernels.build_dir() == aot.DEFAULT_COMPILE_CACHE_DIR
    assert aot.DEFAULT_COMPILE_CACHE_DIR == \
        Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
    monkeypatch.setenv("LDT_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    assert kernels.lib_path() == tmp_path / "cc" / kernels.LIB_NAME


def test_preload_in_startup_ready_task(monkeypatch, tmp_path):
    """service/swap.startup_ready_task preloads the engine's bundle
    before warmup; under LDT_AOT_REQUIRE a refusal withholds the ready
    file, so a supervisor keeps the old generation."""
    from language_detector_tpu_torch.service import swap

    class Svc:
        pass

    ready = tmp_path / "ready.json"
    monkeypatch.setenv("LDT_READY_FILE", str(ready))
    monkeypatch.setenv("LDT_AOT_REQUIRE", "1")
    svc = Svc()
    svc._engine = Svc()
    svc._engine._aot = _store(tmp_path, key=dict(KEY, digest="e" * 16),
                              require=True)
    svc.readiness = lambda: {"ok": True}
    _write_entry(_store(tmp_path))
    swap.startup_ready_task(svc, (0, 0))
    assert not ready.exists()
    assert svc._engine._aot.stats()["refusals"] == 1
    monkeypatch.setenv("LDT_AOT_REQUIRE", "0")
    svc._engine._aot = _store(tmp_path)
    swap.startup_ready_task(svc, (1, 2))
    assert svc._engine._aot.stats()["loads"] == 1
    assert json.loads(ready.read_text())["port"] == 1
    assert os.path.exists(ready)
