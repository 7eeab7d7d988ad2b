"""Drills of the reference's ci.sh that no other port test holds, over
members of the port's front on the CPU (tests/torch_cpu_front.py under
the port's supervisor), for ci_torch.sh.

test_postmortem_drill is ci.sh's `postmortem chaos smoke`: a 2-member
fleet with LDT_FLIGHTREC_DIR and a unix-socket lane a member, under the
lock-order watchdog; 32 clients burst with X-LDT-Request-Id headers,
then a READY member is SIGKILLed. /fleetz must carry its postmortem,
harvested from its crash-safe ring (rc -SIGKILL, not a clean exit,
recorder events and the request ids in flight at the kill), the fleet
recovers to 2 READY members, one correlation id sent over both members'
unix-socket lanes merges into one /tracez entry spanning two pids with
a `uds` request_start, and SIGINT drains the fleet to exit 0.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import threading
import time
import urllib.request

import chip_smoke
from language_detector_tpu_torch.service import wire

MODULE = "tests.torch_cpu_front"
BODY = json.dumps({"request": [
    {"text": f"the quick brown fox jumps over the lazy dog {i}"}
    for i in range(4)]}).encode()


def _uds_request_id(path: str, rid: str) -> int:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(30)
    s.connect(path)
    try:
        s.sendall(wire.pack_frame(BODY, request_id=rid))
        status, echoed, _ = wire.recv_response_frame(s)
        assert echoed == rid, f"UDS echo {echoed!r} != {rid!r}"
        return status
    finally:
        s.close()


def test_postmortem_drill(tmp_path):
    uds = str(tmp_path / "pm.sock")
    fleet = chip_smoke.Fleet(2, str(tmp_path), MODULE,
                             LDT_UNIX_SOCKET=uds, LDT_LOCK_DEBUG=1,
                             LDT_RESULT_CACHE_MB=0,
                             LDT_RESULT_CACHE_SHM_MB=0)
    stop = threading.Event()
    lock = threading.Lock()
    served, seq, echo_bad = [0], [0], []
    threads: list = []

    def client():
        while not stop.is_set():
            with lock:
                seq[0] += 1
                rid = f"pm-{seq[0]}"
            req = urllib.request.Request(
                f"http://127.0.0.1:{fleet.port}/", data=BODY,
                headers={"Content-Type": "application/json",
                         "X-LDT-Request-Id": rid})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    r.read()
                    with lock:
                        if r.headers.get("X-LDT-Request-Id") != rid:
                            echo_bad.append(rid)
                        served[0] += 1
            except OSError:
                time.sleep(0.05)     # kill blips retry; the harvest is
                                     # what is tested

    rc = None
    try:
        snap = fleet.wait(lambda s: s["ready"] == 2, "2 READY members",
                          120)
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(32)]
        for t in threads:
            t.start()
        chip_smoke.wait_for(lambda: served[0] >= 20, "burst served", 60,
                            fleet.proc)
        victim = next(m for m in snap["members"] if m["state"] == "ready")
        os.kill(victim["pid"], signal.SIGKILL)    # mid-burst hard loss
        snap = fleet.wait(
            lambda s: s["ready"] == 2 and any(
                p.get("pid") == victim["pid"]
                for p in s.get("postmortems", [])),
            "postmortem harvested + 2 READY", 120)
        pm = next(p for p in snap["postmortems"]
                  if p["pid"] == victim["pid"])
        assert pm["reason"] in ("crash", "lost"), pm["reason"]
        assert pm["rc"] == -signal.SIGKILL, pm["rc"]
        assert pm["clean_exit"] is False
        assert pm["events_total"] > 0, "empty ring survived the SIGKILL?"
        assert pm["tail"], "no recorder tail in the postmortem"
        inflight = pm["inflight_request_ids"]
        assert inflight and all(r.startswith("pm-") for r in inflight), \
            f"in-flight ids not recovered from the dead member: {inflight}"
        stop.set()
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads), "client hung"
        assert not echo_bad, f"request ids not echoed: {echo_bad[:5]}"

        rid = "cafe0001"
        for slot in (0, 1):
            assert _uds_request_id(f"{uds}.{slot}", rid) < 500
        st, body = chip_smoke.get_url(
            f"http://127.0.0.1:{fleet.sport}/tracez")
        assert st == 200, st
        tz = json.loads(body)
        entry = next((e for e in tz["requests"]
                      if e["request_id"] == rid), None)
        assert entry is not None, \
            f"/tracez lost the correlation id: {tz['count']} entries"
        pids = {p for p in entry["processes"] if p.startswith("pid:")}
        assert len(pids) >= 2, \
            f"one id across two members merged to {sorted(pids)}"
        lanes = {e.get("lane") for e in entry["events"]
                 if e["ev"] == "request_start"}
        assert "uds" in lanes, f"recorder lanes: {lanes}"
        rc = fleet.close()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        if rc is None:
            fleet.close()
    assert rc == 0, fleet.log()[-2000:]
