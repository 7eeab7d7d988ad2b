"""The port's fleet-shared result cache (service/sharedcache.py) on
the CPU.

The first seventeen cases are tests/test_shared_cache.py's, run
against the port's copy: the seqlock protocol, cross-process hits, a
writer killed mid-slot, a torn payload refused by the CRC, dead-slot
adoption, eviction, the artifact-epoch discipline, and the per-worker
ResultCache's write-through, promotion and single-flight claims. Then
the process-wide tier the fronts open (build_from_env / default_path /
shared_tier, LDT_RESULT_CACHE_SHM_MB and LDT_SHARED_CACHE_FILE), and
the two packages on one file: each package's SharedResultCache reads
the entries the other wrote, byte for byte the same slots.
"""
import os
import struct
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from language_detector_tpu.service import sharedcache as jsc
from language_detector_tpu_torch.service import sharedcache as sc
from language_detector_tpu_torch.service.batcher import _MISS, ResultCache

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def cache_path(tmp_path):
    return str(tmp_path / "shared.bin")


def _cache(path, mb=1.0):
    return sc.SharedResultCache(path, int(mb * 1024 * 1024))


def _slot_off(cache, key, probe=0):
    kh = sc._key_hash(key)
    base = int.from_bytes(kh[:8], "little") % cache.slot_count
    return cache._off((base + probe) % cache.slot_count)


# -- basic protocol ----------------------------------------------------------


def test_put_get_roundtrip(cache_path):
    c = _cache(cache_path)
    c.set_epoch("digest-1")
    key = (None, "bonjour tout le monde")
    assert c.get(key) is None
    c.put(key, "fr")
    assert c.get(key) == "fr"
    st = c.stats()
    assert st["hits"] == 1 and st["misses"] == 1
    c.close()


def test_two_attached_views_share_entries(cache_path):
    a, b = _cache(cache_path), _cache(cache_path)
    a.set_epoch("d1")
    b.set_epoch("d1")
    a.put((None, "hola"), "es")
    assert b.get((None, "hola")) == "es"
    # geometry comes from the header, not the attacher's knob
    c = _cache(cache_path, mb=4.0)
    assert c.slot_count == a.slot_count
    for x in (a, b, c):
        x.close()


def test_incompatible_layout_refused(cache_path):
    c = _cache(cache_path)
    c.close()
    with open(cache_path, "r+b") as f:
        f.write(sc._HEADER.pack(sc.MAGIC, sc.VERSION + 9,
                                c.slot_count, sc.SLOT_BYTES))
    with pytest.raises(RuntimeError, match="incompatible layout"):
        _cache(cache_path)


def test_oversized_value_never_published(cache_path):
    c = _cache(cache_path)
    c.set_epoch("d1")
    c.put((None, "big"), "x" * (sc.PAYLOAD_CAP + 1))
    assert c.get((None, "big")) is None
    c.close()


# -- cross-process -----------------------------------------------------------


def _child(path, body):
    code = ("import sys, os, struct\n"
            "from language_detector_tpu_torch.service import sharedcache as sc\n"
            f"c = sc.SharedResultCache(sys.argv[1], 1 << 20)\n"
            f"c.set_epoch('E1')\n" + body)
    return subprocess.run([sys.executable, "-c", code, path], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_cross_process_hits(cache_path):
    r = _child(cache_path,
               "for i in range(20):\n"
               "    c.put((None, f'doc-{i}'), 'fr')\n")
    assert r.returncode == 0, r.stderr
    c = _cache(cache_path)
    c.set_epoch("E1")
    assert all(c.get((None, f"doc-{i}")) == "fr" for i in range(20))
    c.close()


def test_writer_killed_mid_slot_never_serves_and_stays_live(cache_path):
    # the child claims a slot (seq -> odd) and dies there: exactly what
    # a SIGKILL between the claim and the publish leaves behind
    r = _child(cache_path,
               "key = (None, 'victim-doc')\n"
               "kh = sc._key_hash(key)\n"
               "base = int.from_bytes(kh[:8], 'little') % c.slot_count\n"
               "off = c._off(base)\n"
               "struct.pack_into('<I', c._mm, off, c._seq(off) + 1)\n"
               "os._exit(9)\n")
    assert r.returncode == 9
    c = _cache(cache_path)
    c.set_epoch("E1")
    key = (None, "victim-doc")
    off = _slot_off(c, key)
    assert c._seq(off) & 1, "child should have left an odd seq behind"
    # the dead slot reads as a miss, never garbage
    assert c.get(key) is None
    # ...and the table stays writable: put() probes past the dead slot
    c.put(key, "de")
    assert c.get(key) == "de"
    c.close()


# -- chaos: torn entries, dead-slot adoption, eviction -----------------------


def test_torn_payload_refused_by_crc(cache_path):
    c = _cache(cache_path)
    c.set_epoch("d1")
    key = (None, "torn-doc")
    c.put(key, "ru")
    # find the published slot and flip one payload byte under it
    for i in range(sc.PROBE_WINDOW):
        off = _slot_off(c, key, probe=i)
        _, _, _, skey, vlen, _ = sc._SLOT_HDR.unpack_from(c._mm, off)
        if skey == sc._key_hash(key) and vlen:
            p = off + sc.SLOT_HDR_BYTES
            c._mm[p] ^= 0x40
            break
    else:
        pytest.fail("published slot not found in the probe window")
    assert c.get(key) is None  # CRC refuses; a miss, not a wrong answer
    c.close()


def test_displacement_adopts_dead_slots(cache_path):
    c = _cache(cache_path)
    c.set_epoch("d1")
    key = (None, "heal-me")
    # leave every slot in the key's probe window with a dead writer
    for i in range(sc.PROBE_WINDOW):
        off = _slot_off(c, key, probe=i)
        s = c._seq(off)
        if not s & 1:
            struct.pack_into("<I", c._mm, off, s + 1)
    assert c.get(key) is None
    # the displacement path adopts the odd seq as its claim: the slot
    # heals on this overwrite instead of leaking forever
    c.put(key, "ja")
    assert c.get(key) == "ja"
    victim = _slot_off(c, key, probe=sc._key_hash(key)[8]
                       % sc.PROBE_WINDOW)
    assert not c._seq(victim) & 1
    c.close()


def test_eviction_on_full_window(tmp_path):
    # tiny table (minimum geometry = one probe window) so distinct keys
    # must displace each other
    c = sc.SharedResultCache(str(tmp_path / "tiny.bin"), 0)
    assert c.slot_count == sc.PROBE_WINDOW
    c.set_epoch("d1")
    for i in range(4 * sc.PROBE_WINDOW):
        c.put((None, f"k-{i}"), "en")
    assert c.stats()["evictions"] > 0
    # displaced or not, reads stay coherent: every hit is a real value
    alive = sum(1 for i in range(4 * sc.PROBE_WINDOW)
                if c.get((None, f"k-{i}")) == "en")
    assert 0 < alive <= sc.PROBE_WINDOW
    c.close()


# -- epoch discipline --------------------------------------------------------


def test_epoch_roll_flushes_and_refuses_stale(cache_path):
    a, b = _cache(cache_path), _cache(cache_path)
    a.set_epoch("digest-old")
    b.set_epoch("digest-old")
    for i in range(10):
        a.put((None, f"doc-{i}"), "fr")
    assert b.get((None, "doc-0")) == "fr"
    # one member swaps to a new artifact: its reads refuse instantly
    # and the sweep frees the old generation's slots
    b.set_epoch("digest-new")
    assert b.get((None, "doc-0")) is None
    assert b.stats()["epoch_flushes"] >= 10
    # the not-yet-swapped member now misses too (entries are gone) but
    # never sees a value from the wrong generation
    assert a.get((None, "doc-0")) is None
    # re-rolling to the same epoch is a no-op
    before = b.stats()["epoch_flushes"]
    b.set_epoch("digest-new")
    assert b.stats()["epoch_flushes"] == before
    for x in (a, b):
        x.close()


def test_put_under_new_epoch_reclaims_stale_slots(cache_path):
    c = _cache(cache_path)
    c.set_epoch("e1")
    key = (None, "reused")
    c.put(key, "fr")
    c2 = _cache(cache_path)  # fresh view still on the default epoch
    c2.set_epoch("e2")
    c2.put(key, "de")
    assert c2.get(key) == "de"
    assert c.get(key) is None  # e1 view refuses the e2 entry
    for x in (c, c2):
        x.close()


# -- ResultCache integration: L2 + single-flight -----------------------------


def test_result_cache_writes_through_and_promotes(cache_path):
    shared = _cache(cache_path)
    a = ResultCache(1 << 20, shared=shared)
    b = ResultCache(1 << 20, shared=shared)
    a.set_epoch("d1")
    b.set_epoch("d1")
    key = (None, "hola amigos")
    a.put(key, "es", key[-1])
    # b's L1 is empty: the hit comes from the shared tier and promotes
    assert b.get(key) == "es"
    assert b.stats()["hits"] == 1
    assert b.get(key) == "es"  # second read answers from L1
    assert shared.stats()["hits"] == 1  # the shm tier was probed once
    shared.close()


def test_result_cache_rich_values_stay_private(cache_path):
    shared = _cache(cache_path)
    a = ResultCache(1 << 20, shared=shared)
    b = ResultCache(1 << 20, shared=shared)
    a.set_epoch("d1")
    b.set_epoch("d1")
    key = (None, "rich result")
    a.put(key, {"lang": "en", "scores": [1, 2, 3]}, key[-1])
    assert a.get(key) == {"lang": "en", "scores": [1, 2, 3]}
    # only code-string production values travel through the shm slots
    assert b.get(key) is _MISS
    shared.close()


def test_result_cache_epoch_forwarded_to_shared(cache_path):
    shared = _cache(cache_path)
    a = ResultCache(1 << 20, shared=shared)
    a.set_epoch("d1")
    a.put((None, "x"), "en", "x")
    a.set_epoch("d2")
    assert a.get((None, "x")) is _MISS
    assert shared.stats()["epoch_flushes"] >= 1
    shared.close()


def test_single_flight_claim_resolve():
    cache = ResultCache(1 << 20)
    key = (None, "dup doc")
    assert cache.claim(key) is None  # first claimer owns the key
    ev = cache.claim(key)
    assert isinstance(ev, threading.Event) and not ev.is_set()
    cache.resolve(key)
    assert ev.is_set()
    # resolved: the key is claimable again
    assert cache.claim(key) is None
    cache.resolve(key)


def test_single_flight_epoch_roll_wakes_waiters():
    cache = ResultCache(1 << 20)
    key = (None, "swapped away")
    assert cache.claim(key) is None
    ev = cache.claim(key)
    cache.set_epoch("new-digest")
    assert ev.is_set()  # waiters re-probe and dispatch themselves
    # the old owner's late resolve is a harmless no-op
    cache.resolve(key)
    assert cache.claim(key) is None


def test_single_flight_collapses_concurrent_fills():
    import time
    cache = ResultCache(1 << 20)
    key = (None, "hot doc")
    assert cache.claim(key) is None  # main thread is the slow owner
    results = []

    def waiter():
        v = cache.get(key)
        if v is _MISS:
            ev = cache.claim(key)
            assert ev is not None  # the owner still holds the key
            assert ev.wait(5.0)
            v = cache.get(key)
        results.append(v)

    threads = [threading.Thread(target=waiter) for _ in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.05)  # let the stampede park on the event
    cache.put(key, "en", key[-1])
    cache.resolve(key)
    for t in threads:
        t.join()
    assert results == ["en"] * 8


# -- the process-wide tier the fronts open -----------------------------------


@pytest.fixture()
def tier_env(monkeypatch):
    for k in ("LDT_RESULT_CACHE_SHM_MB", "LDT_SHARED_CACHE_FILE",
              "LDT_SHM_DIR"):
        monkeypatch.delenv(k, raising=False)
    sc.reset_shared_tier()
    yield monkeypatch
    sc.reset_shared_tier()


def test_default_path_precedence(tier_env, tmp_path):
    """LDT_SHARED_CACHE_FILE wins, then <LDT_SHM_DIR>, then /dev/shm
    (or the temp dir): the reference's rule, path for path."""
    got, want = [sc.default_path()], [jsc.default_path()]
    tier_env.setenv("LDT_SHM_DIR", str(tmp_path / "rings"))
    got.append(sc.default_path())
    want.append(jsc.default_path())
    tier_env.setenv("LDT_SHARED_CACHE_FILE", str(tmp_path / "pinned.bin"))
    got.append(sc.default_path())
    want.append(jsc.default_path())
    assert got == want
    assert got[0].endswith("ldt-shared-cache.bin")
    assert got[1:] == [str(tmp_path / "rings" / "ldt-shared-cache.bin"),
                       str(tmp_path / "pinned.bin")]


def test_build_from_env_off_by_default(tier_env):
    assert sc.build_from_env() is None
    assert sc.shared_tier() is None
    tier_env.setenv("LDT_RESULT_CACHE_SHM_MB", "0")
    assert sc.build_from_env() is None


def test_build_from_env_attaches_pinned_file(tier_env, tmp_path):
    """LDT_RESULT_CACHE_SHM_MB > 0 attaches the table at the pinned
    path with the reference's geometry for that budget, and
    shared_tier() hands every caller of the process the one view."""
    path = tmp_path / "fleet" / "cache.bin"
    tier_env.setenv("LDT_RESULT_CACHE_SHM_MB", "2")
    tier_env.setenv("LDT_SHARED_CACHE_FILE", str(path))
    tier = sc.shared_tier()
    assert tier is not None and tier is sc.shared_tier()
    assert tier.path == str(path) and path.exists()
    want = jsc.SharedResultCache(str(tmp_path / "ref.bin"), 2 << 20)
    assert tier.slot_count == want.slot_count
    assert os.path.getsize(path) == os.path.getsize(tmp_path / "ref.bin")
    want.close()


def test_build_from_env_failure_runs_private(tier_env, tmp_path):
    """An attach that fails (here: a file of another layout) logs and
    returns None — the worker runs on its private cache, never down."""
    path = tmp_path / "bad.bin"
    c = _cache(str(path))
    c.close()
    with open(path, "r+b") as f:
        f.write(sc._HEADER.pack(sc.MAGIC, sc.VERSION + 1, 16,
                                sc.SLOT_BYTES))
    tier_env.setenv("LDT_RESULT_CACHE_SHM_MB", "1")
    tier_env.setenv("LDT_SHARED_CACHE_FILE", str(path))
    assert sc.build_from_env() is None


def test_service_result_cache_writes_through_tier(tier_env, tmp_path):
    """The port's DetectorService with LDT_RESULT_CACHE_MB and
    LDT_RESULT_CACHE_SHM_MB set: its batcher's cache writes through the
    shared tier, the metrics read the tier's live stats, and a second
    service on the same file (a second fleet member) hits it."""
    from language_detector_tpu_torch.service.server import DetectorService
    tier_env.setenv("LDT_RESULT_CACHE_MB", "4")
    tier_env.setenv("LDT_RESULT_CACHE_SHM_MB", "1")
    tier_env.setenv("LDT_SHARED_CACHE_FILE", str(tmp_path / "tier.bin"))
    docs = [f"le gouvernement a annonce de nouvelles mesures {i}"
            for i in range(4)]
    a = DetectorService(device="cpu", max_delay_ms=1.0)
    try:
        first = a.detect_codes(docs)
        st = a.metrics.shared_cache_stats()
        assert st is not None and st["path"] == str(tmp_path / "tier.bin")
    finally:
        a.batcher.close()
    other = sc.SharedResultCache(str(tmp_path / "tier.bin"), 1 << 20)
    other.set_epoch(a.batcher._cache._epoch)
    assert [other.get((None, d)) for d in docs] == first
    other.close()


# -- the two packages on one file --------------------------------------------


def test_cross_package_entries(cache_path):
    """The port's and the JAX package's SharedResultCache open one
    file: each reads the other's entries (keys with and without hints),
    the geometry comes from the file's header either way, and an epoch
    roll by one package flushes the other's entries."""
    t = _cache(cache_path)
    j = jsc.SharedResultCache(cache_path, 4 << 20)
    assert (t.slot_count, jsc.SLOT_BYTES, jsc.PROBE_WINDOW) == (
        j.slot_count, sc.SLOT_BYTES, sc.PROBE_WINDOW)
    for x in (t, j):
        x.set_epoch("digest-1")
    t.put((None, "bonjour tout le monde"), "fr")
    t.put((("fr", "", ""), "hinted doc"), "fr")
    j.put((None, "hola amigos"), "es")
    j.put((None, "日本語の文章です"), "ja")
    assert j.get((None, "bonjour tout le monde")) == "fr"
    assert j.get((("fr", "", ""), "hinted doc")) == "fr"
    assert t.get((None, "hola amigos")) == "es"
    assert t.get((None, "日本語の文章です")) == "ja"
    for key in ((None, "hola amigos"), (None, "bonjour tout le monde")):
        assert sc._key_hash(key) == jsc._key_hash(key)
    j.set_epoch("digest-2")
    assert t.get((None, "hola amigos")) is None
    t.close()
    j.close()


def test_cross_package_same_bytes(tmp_path):
    """The same puts through each package give the same file, byte for
    byte."""
    files = []
    for mod in (sc, jsc):
        p = str(tmp_path / f"{mod.__name__}.bin")
        c = mod.SharedResultCache(p, 1 << 20)
        c.set_epoch("epoch-x")
        for i in range(50):
            c.put((None, f"doc-{i}"), ("en", "fr", "ja")[i % 3])
        c.close()
        files.append(Path(p).read_bytes())
    assert files[0] == files[1]
