"""The port's shared-memory ring lane (service/shmring.py) on the CPU.

The first seven cases are tests/test_shmring.py's, run against the
port's copy: byte-identity with the UDS frame contract, client SIGKILL
mid-WRITING reclaimed, worker crash fenced by the generation bump,
poison-doc bisection and quarantine, the lease fault, and the oversize
refusal. The rest hold the port's lane against the reference package's
on one ring file: a JAX RingClient served by the port's ShmRingServer
and a port RingClient served by the JAX server, the two packages' page-0
headers and slot words as the same bytes, and the port's
DetectorService(device="cpu") behind the ring answering as the JAX
DetectorService does. Tolerance: exact bytes.
"""
from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time

import pytest

from language_detector_tpu import faults as jfaults
from language_detector_tpu.service import server as jserver
from language_detector_tpu.service import shmring as jshmring
from language_detector_tpu.service import wire as jwire
from language_detector_tpu_torch import faults, telemetry
from language_detector_tpu_torch.service import server, shmring, wire
from language_detector_tpu_torch.service.server import DetectorService
from language_detector_tpu_torch.tables import DATA_DIR
from torch_support import jax_packer

# while this worker collects, before any of its tests run
jax_packer()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _echo(texts, trace=None):
    return ["en"] * len(texts)


def _svc():
    return DetectorService(use_device=False, start_batcher=False)


def _body(n=1, poison_at=None):
    docs = [{"text": f"plain document number {i}"} for i in range(n)]
    if poison_at is not None:
        docs[poison_at]["text"] = \
            f"bad doc {shmring.POISON_MARKER} kills the batch"
    return json.dumps({"request": docs}).encode()


def _reclaims(reason):
    return telemetry.REGISTRY.counter_value(
        "ldt_shm_reclaimed_total", reason=reason)


# -- tests/test_shmring.py's cases, on the port -----------------------------


def test_roundtrip_parity_and_pipelining(tmp_path):
    """Responses on the shm lane are byte-identical to handle_frame's
    UDS output, and several frames pipeline across slots."""
    svc = _svc()
    srv = shmring.ShmRingServer(svc, str(tmp_path), detect=_echo)
    srv.start()
    cli = shmring.RingClient(str(tmp_path))
    try:
        cli.wait_attached(10.0)
        body = _body(3)
        st, resp = cli.request(body, timeout=10.0)
        st2, bufs = wire.handle_frame(svc, body, detect=_echo)
        assert (st, resp) == (st2, b"".join(bufs))
        assert json.loads(resp)["response"][0]["iso6391code"] == "en"
        idxs = [cli.submit(body) for _ in range(4)]
        assert all(i is not None for i in idxs)
        for i in idxs:
            s, r = cli.wait(i, timeout=10.0)
            assert (s, r) == (st, resp)
        stats = srv.stats()
        assert stats["rings"] == 1
        assert stats["frames"] >= 5
    finally:
        cli.close(unlink=True)
        srv.close()


def test_error_frames_match_uds_contract(tmp_path):
    """Malformed bodies answer the SAME error frames as the UDS lane."""
    svc = _svc()
    srv = shmring.ShmRingServer(svc, str(tmp_path), detect=_echo)
    srv.start()
    cli = shmring.RingClient(str(tmp_path))
    try:
        cli.wait_attached(10.0)
        for body in (b"not json{{", b'{"request": [{"other": 1}]}'):
            st, resp = cli.request(body, timeout=10.0)
            st2, bufs = wire.handle_frame(svc, body, detect=_echo)
            assert (st, resp) == (st2, b"".join(bufs)), body
    finally:
        cli.close(unlink=True)
        srv.close()


_CHILD_MID_WRITING = """
import os, sys, time
sys.path.insert(0, sys.argv[2])
from language_detector_tpu_torch.service import shmring
c = shmring.RingClient(sys.argv[1])
c.slots[0].mark_writing()
c.rf.write_slot(0, shmring.SLOT_WRITING, c.rf.generation, os.getpid(),
                time.time(), 0, 0)
print("WRITING", flush=True)
time.sleep(60)
"""


def test_client_sigkill_mid_writing_is_reclaimed(tmp_path, monkeypatch):
    """SIGKILL a client that claimed a slot mid-WRITING: the lease
    sweep reclaims the slot (dead owner pid), and once every slot of
    the dead client's ring is FREE the ring file itself is GC'd."""
    monkeypatch.setenv("LDT_SHM_LEASE_TIMEOUT_SEC", "0.2")
    before = _reclaims("writer-lost")
    svc = _svc()
    srv = shmring.ShmRingServer(svc, str(tmp_path), detect=_echo)
    srv.start()
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD_MID_WRITING, str(tmp_path), ROOT],
        stdout=subprocess.PIPE, text=True)
    try:
        assert "WRITING" in child.stdout.readline()
        ring = shmring.client_ring_path(str(tmp_path), child.pid)
        assert os.path.exists(ring)
        # live writer with a fresh lease: the sweep must NOT reclaim
        time.sleep(0.15)
        rf = shmring.RingFile(ring)
        assert rf.read_slot(0)[0] == shmring.SLOT_WRITING
        rf.close()
        child.kill()
        child.wait(10)
        deadline = time.monotonic() + 10.0
        while os.path.exists(ring) and time.monotonic() < deadline:
            time.sleep(0.02)
        # slot reclaimed -> all-FREE ring of a dead client -> unlinked
        assert not os.path.exists(ring)
        assert _reclaims("writer-lost") >= before + 1
    finally:
        if child.poll() is None:
            child.kill()
        child.wait(10)
        srv.close()


def test_worker_crash_fences_old_generation_no_hang(tmp_path):
    """A previous worker attached the ring (generation 1), leased one
    frame, and died with another frame committed READY. The restarted
    worker's attach bumps the generation, and BOTH stale frames come
    back as explicit 503 error frames — the client's wait() resolves,
    it never hangs."""
    cli = shmring.RingClient(str(tmp_path))
    dead_pid = 2 ** 22 + 1025     # beyond pid_max: definitely dead
    cli.rf.set_generation(1, dead_pid)   # the "previous worker"
    body = _body(2)
    i0 = cli.submit(body)
    i1 = cli.submit(body)
    assert i0 is not None and i1 is not None
    # the old worker leased i1 mid-score and crashed
    cli.rf.write_slot(i1, shmring.SLOT_LEASED, 1, dead_pid,
                      time.time(), len(body), 0)
    svc = _svc()
    srv = shmring.ShmRingServer(svc, str(tmp_path), detect=_echo)
    srv.start()
    try:
        for i in (i0, i1):
            st, resp = cli.wait(i, timeout=10.0)
            assert st == 503
            assert b"fenced" in resp
        # the ring stays serviceable on the new generation
        st, resp = cli.request(body, timeout=10.0)
        assert st in (200, 203)
    finally:
        cli.close(unlink=True)
        srv.close()


def test_quarantine_bisection_isolates_poison_doc(tmp_path):
    """A 32-doc frame with ONE poison doc (deterministically kills its
    scorer batch under the poison_doc fault): bisection isolates and
    quarantines exactly that doc, the other 31 docs still answer, and a
    re-submission pre-filters the quarantined doc without re-bisecting."""
    docs_before = telemetry.REGISTRY.counter_value(
        "ldt_quarantine_docs_total")
    svc = _svc()
    srv = shmring.ShmRingServer(svc, str(tmp_path), detect=_echo)
    srv.start()
    cli = shmring.RingClient(str(tmp_path))
    faults.configure("poison_doc:error")
    try:
        cli.wait_attached(10.0)
        body = _body(32, poison_at=13)
        st, resp = cli.request(body, timeout=30.0)
        codes = [r["iso6391code"]
                 for r in json.loads(resp)["response"]]
        assert len(codes) == 32
        assert codes[13] == "un"
        assert codes.count("un") == 1          # exactly the poison doc
        assert set(codes) == {"en", "un"}
        assert srv.quarantine.total == 1
        assert srv.quarantine.stats()["bisect_batches"] >= 5
        assert telemetry.REGISTRY.counter_value(
            "ldt_quarantine_docs_total") == docs_before + 1
        # resubmit: the quarantined doc is pre-filtered (answers "un"
        # without touching the scorer) — no new bisection burned
        bisects = srv.quarantine.stats()["bisect_batches"]
        st, resp = cli.request(body, timeout=30.0)
        codes = [r["iso6391code"]
                 for r in json.loads(resp)["response"]]
        assert codes[13] == "un" and codes.count("un") == 1
        assert srv.quarantine.stats()["bisect_batches"] == bisects
        assert srv.quarantine.total == 1
    finally:
        faults.configure(None)
        cli.close(unlink=True)
        srv.close()


def test_lease_fault_retries_frame(tmp_path):
    """An injected shm_lease fault leaves the frame READY; the next
    sweep (fault disarmed) serves it — no frame is lost."""
    svc = _svc()
    srv = shmring.ShmRingServer(svc, str(tmp_path), detect=_echo)
    srv.start()
    cli = shmring.RingClient(str(tmp_path))
    faults.configure("shm_lease:error:p=0.5:seed=7")
    try:
        cli.wait_attached(10.0)
        for _ in range(8):
            st, resp = cli.request(_body(2), timeout=10.0)
            assert st in (200, 203)
    finally:
        faults.configure(None)
        cli.close(unlink=True)
        srv.close()


def test_oversize_frame_refused_at_submit(tmp_path):
    cli = shmring.RingClient(str(tmp_path), slot_bytes=4096)
    try:
        with pytest.raises(ValueError, match="slot capacity"):
            cli.submit(b"x" * (cli.rf.slot_bytes + 1))
    finally:
        cli.close(unlink=True)


# -- the port's lane against the reference's --------------------------------


def _corpus_bodies() -> list:
    """Request bodies over the eval corpus (1, 3, 40 and 100 documents,
    escaped and raw UTF-8) plus the error shapes the lane answers."""
    lines = [ln.split("\t", 1)[1].rstrip("\n") for ln in
             open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")]
    out = []
    for k, (lo, n) in enumerate(((0, 1), (5, 3), (20, 40), (0, 100))):
        out.append(json.dumps(
            {"request": [{"text": t} for t in lines[lo:lo + n]]},
            ensure_ascii=k % 2 == 0).encode())
    out += [b"not json{{", b'{"request": [{"other": 1}]}',
            json.dumps({"request": [{"text": "?!"}, {"no": 1},
                                    {"text": ""}]}).encode()]
    return out


BODIES = _corpus_bodies()

# (client package, server package): each package's client on the other
# package's server, and on its own
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]
PKG = {"jax": (jshmring, jserver), "port": (shmring, server)}


@pytest.mark.parametrize("crc", ["0", "1"])
@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_cross_package_ring_bytes(tmp_path, monkeypatch, pair, crc):
    """A client of one package on the other package's server: every
    (status, body) equals the JAX wire.handle_frame's bytes for the
    same body, and both packages decode the ring file's headers alike,
    slot by slot. With LDT_WIRE_CRC the client's guard word is written
    and checked across the packages."""
    monkeypatch.setenv("LDT_WIRE_CRC", crc)
    cmod, _ = PKG[pair[0]]
    smod, sserver = PKG[pair[1]]
    svc = sserver.DetectorService(use_device=False, start_batcher=False)
    jsvc = jserver.DetectorService(use_device=False, start_batcher=False)
    srv = smod.ShmRingServer(svc, str(tmp_path), detect=_echo)
    srv.start()
    cli = cmod.RingClient(str(tmp_path), slots=4, slot_bytes=1 << 18)
    try:
        cli.wait_attached(10.0)
        for body in BODIES:
            got = cli.request(body, timeout=30.0)
            st, bufs = jwire.handle_frame(jsvc, body, detect=_echo)
            assert got == (st, b"".join(bufs)), body[:60]
        # a pipelined pass across the slots, answered in order
        idxs = [cli.submit(b) for b in BODIES[:4]]
        assert None not in idxs
        for i, body in zip(idxs, BODIES[:4]):
            st, bufs = jwire.handle_frame(jsvc, body, detect=_echo)
            assert cli.wait(i, timeout=30.0) == (st, b"".join(bufs))
        views = [m.RingFile(cli.path) for m in (jshmring, shmring)]
        try:
            a, b = views
            assert (a.nslots, a.slot_bytes, a.generation, a.client_pid,
                    a.worker_pid) == (b.nslots, b.slot_bytes,
                                      b.generation, b.client_pid,
                                      b.worker_pid) == (
                4, 1 << 18, 1, os.getpid(), os.getpid())
            for i in range(a.nslots):
                assert a.read_slot(i) == b.read_slot(i)
                assert a.read_crc(i) == b.read_crc(i)
                assert a.slot_request_id(i) == b.slot_request_id(i)
        finally:
            for v in views:
                v.close()
    finally:
        cli.close(unlink=True)
        srv.close()


def test_ring_layout_same_bytes(tmp_path, monkeypatch):
    """The two packages write the same bytes: a fresh ring file, a
    committed READY frame with its CRC word and request id, and a DONE
    response header, each compared with the other package's for the
    same calls (the lease timestamps set to one value)."""
    monkeypatch.setenv("LDT_WIRE_CRC", "1")
    files = {}
    for name, mod in (("jax", jshmring), ("port", shmring)):
        d = tmp_path / name
        cli = mod.RingClient(str(d), slots=3, slot_bytes=8192)
        fresh = bytes(cli.rf.mm[:])
        cli.rf.set_generation(7, 4242)
        i = cli.submit(BODIES[1], request_id="00c0ffee")
        ts = struct.pack("<d", 1.5)
        off = mod.SLOT_HDR_OFF + i * mod.SLOT_HDR_SIZE
        cli.rf.mm[off + 16:off + 24] = ts
        ready = bytes(cli.rf.mm[:])
        cli.rf.write_payload(i, (b'{"response":[]}',))
        cli.rf.write_slot(i, mod.SLOT_DONE, 7, 4242, 1.5, 15, 200,
                          reqid=0xC0FFEE)
        files[name] = (fresh, ready, bytes(cli.rf.mm[:]))
        cli.close(unlink=True)
    assert files["jax"] == files["port"]
    assert len(files["port"][0]) == shmring.HEADER_PAGE + 3 * 8192
    assert (shmring.RING_MAGIC, shmring.RING_VERSION, shmring.HEADER_PAGE,
            shmring.SLOT_HDR_OFF, shmring.SLOT_HDR_SIZE,
            shmring.RING_HDR.format, shmring.SLOT_HDR.format) == (
        jshmring.RING_MAGIC, jshmring.RING_VERSION, jshmring.HEADER_PAGE,
        jshmring.SLOT_HDR_OFF, jshmring.SLOT_HDR_SIZE,
        jshmring.RING_HDR.format, jshmring.SLOT_HDR.format)
    assert (shmring.FENCED_BODY, shmring.RESP_OVERFLOW_BODY,
            shmring.POISON_MARKER) == (jshmring.FENCED_BODY,
                                       jshmring.RESP_OVERFLOW_BODY,
                                       jshmring.POISON_MARKER)


def test_port_detector_behind_ring_equals_jax_detector(tmp_path):
    """The port's DetectorService(device="cpu") behind the port's ring
    (no detect= override: frames score through the service's batcher
    and its batched engine on the plain scorer) answers every body with
    the bytes the JAX DetectorService answers behind the JAX ring."""
    out = {}
    for name, mod, svc in (
            ("port", shmring, DetectorService(device="cpu",
                                              max_delay_ms=1.0)),
            ("jax", jshmring, jserver.DetectorService(
                use_device=False, max_delay_ms=1.0))):
        d = str(tmp_path / name)
        srv = mod.ShmRingServer(svc, d)
        srv.start()
        cli = mod.RingClient(d, slots=4, slot_bytes=1 << 18)
        try:
            cli.wait_attached(10.0)
            out[name] = [cli.request(b, timeout=60.0) for b in BODIES]
            out[name + "_frames"] = srv.stats()["frames"]
        finally:
            cli.close(unlink=True)
            srv.close()
            svc.batcher.close()
    assert out["port"] == out["jax"]
    assert out["port_frames"] == len(BODIES)
    assert sum(st in (200, 203) for st, _ in out["port"]) >= 4


def test_device_unavailable_is_not_poison(tmp_path):
    """An open breaker's refusal (DeviceUnavailable) answers the frame
    503 without bisecting it or quarantining a document."""
    from language_detector_tpu_torch.service.admission import \
        DeviceUnavailable

    def shed(texts, trace=None):
        raise DeviceUnavailable(3)

    svc = _svc()
    srv = shmring.ShmRingServer(svc, str(tmp_path), detect=shed)
    srv.start()
    cli = shmring.RingClient(str(tmp_path))
    try:
        cli.wait_attached(10.0)
        st, resp = cli.request(_body(8), timeout=10.0)
        assert (st, resp) == (DeviceUnavailable.status,
                              DeviceUnavailable.body)
        assert srv.quarantine.stats() == {
            "quarantined_docs": 0, "bisect_batches": 0, "hits": 0}
    finally:
        cli.close(unlink=True)
        srv.close()


@pytest.mark.parametrize("n_docs", [1, 2])
@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    "out_of_memory", RuntimeError("fused_tote launch failed: CUDA error 700"),
    OSError("libldt_fused_tote.so: cannot open shared object file"),
    faults.FaultInjected("injected fault at 'lane_lost' (LDT_FAULTS)")],
    ids=["cuda", "oom", "launch", "library", "device_seam"])
def test_device_failure_is_not_poison(tmp_path, n_docs, error):
    """A scorer that fails the way a device does (a torch CUDA error, an
    out-of-memory, the kernel wrapper's launch error, a library it
    cannot load, a fault at a device seam) answers the frame 503 and
    quarantines nothing: on a 1-document frame bisection would quarantine
    the document without scoring it again, and the lane would answer it
    "un" for as long as the process lives."""
    import torch
    if error == "out_of_memory":
        error = torch.cuda.OutOfMemoryError("CUDA out of memory")
    calls = []

    def failing(texts, trace=None):
        calls.append(len(texts))
        raise error

    svc = _svc()
    srv = shmring.ShmRingServer(svc, str(tmp_path), detect=failing)
    srv.start()
    cli = shmring.RingClient(str(tmp_path))
    try:
        cli.wait_attached(10.0)
        st, resp = cli.request(_body(n_docs), timeout=10.0)
        assert (st, resp) == (503, shmring.DeviceFailed.body)
        assert calls == [n_docs]               # scored once, not bisected
        assert srv.quarantine.stats() == {
            "quarantined_docs": 0, "bisect_batches": 0, "hits": 0}
        # the device is back: the same documents answer
        calls.clear()
        srv._base_detect = _echo
        srv._detect = srv._make_detect()
        st, resp = cli.request(_body(n_docs), timeout=10.0)
        assert st == 200
        assert [r["iso6391code"] for r in json.loads(resp)["response"]] \
            == ["en"] * n_docs
    finally:
        cli.close(unlink=True)
        srv.close()


def test_poison_bisection_equals_reference(tmp_path):
    """Under the poison_doc fault both packages' servers bisect the
    same 32-document frame to the same bytes."""
    out = {}
    for name, mod, fmod, srv_mod in (("port", shmring, faults, server),
                                     ("jax", jshmring, jfaults, jserver)):
        svc = srv_mod.DetectorService(use_device=False,
                                      start_batcher=False)
        d = str(tmp_path / name)
        srv = mod.ShmRingServer(svc, d, detect=_echo)
        srv.start()
        cli = mod.RingClient(d)
        fmod.configure("poison_doc:error")
        try:
            cli.wait_attached(10.0)
            out[name] = (cli.request(_body(32, poison_at=5),
                                     timeout=30.0),
                         srv.quarantine.stats())
        finally:
            fmod.configure(None)
            cli.close(unlink=True)
            srv.close()
    assert out["port"] == out["jax"]
    assert out["port"][1]["quarantined_docs"] == 1
