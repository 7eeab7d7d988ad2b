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

The kill waits until the victim's live recorder ring shows a pm- id in
flight, and the members hold each request DRILL_FAULTS' 200 ms in
flight (an asyncio sleep at the enqueue seam, after request_start), so
an id seen there is still in flight when the SIGKILL lands. The CPU
front answers ci.sh's 4-document request on its C path in milliseconds,
far sooner than the reference's XLA flush, and its clients run in
waves: a kill at a random instant of the burst could find the victim
with nothing in flight (more often the more the clients were starved of
CPU, as under the tier-1 command's six workers), and the harvest then
had no in-flight id to recover. test_drill_requests_stay_in_flight
holds the rule.
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
from language_detector_tpu_torch import flightrec
from language_detector_tpu_torch.service import wire

MODULE = "tests.torch_cpu_front"
DRILL_FAULTS = "queue_put:delay_ms=200"
BODY = json.dumps({"request": [
    {"text": f"the quick brown fox jumps over the lazy dog {i}"}
    for i in range(4)]}).encode()


def _pm_in_flight(ring: str) -> list:
    """The drill's request ids a live member's recorder shows in flight."""
    return [r for r in flightrec.harvest_postmortem(ring)[
        "inflight_request_ids"] if r.startswith("pm-")]


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
                             LDT_FAULTS=DRILL_FAULTS,
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
        ring = flightrec.ring_path(os.path.join(
            fleet.dir, "fr", f"m{victim['slot']}"), victim["pid"])
        chip_smoke.wait_for(lambda: _pm_in_flight(ring),
                            "a pm- request in flight at the victim", 60,
                            fleet.proc)
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


def test_drill_requests_stay_in_flight(tmp_path):
    """Under DRILL_FAULTS every request spends at least the rule's
    200 ms between request_start and request_end, so a pm- id the
    drill sees in flight in a live member's ring is still in flight a
    moment later, when its SIGKILL lands; during a 16-client burst the
    ring shows such ids."""
    fleet = chip_smoke.Fleet(1, str(tmp_path), MODULE,
                             LDT_FAULTS=DRILL_FAULTS,
                             LDT_RESULT_CACHE_MB=0,
                             LDT_RESULT_CACHE_SHM_MB=0)
    stop = threading.Event()
    threads: list = []

    def client(k):
        i = 0
        while not stop.is_set():
            i += 1
            req = urllib.request.Request(
                f"http://127.0.0.1:{fleet.port}/", data=BODY,
                headers={"Content-Type": "application/json",
                         "X-LDT-Request-Id": f"pm-{k}-{i}"})
            with urllib.request.urlopen(req, timeout=60) as r:
                r.read()

    try:
        snap = fleet.wait(lambda s: s["ready"] == 1, "1 READY member", 120)
        ring = flightrec.ring_path(os.path.join(fleet.dir, "fr", "m0"),
                                   snap["members"][0]["pid"])
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(16)]
        for t in threads:
            t.start()
        chip_smoke.wait_for(lambda: _pm_in_flight(ring),
                            "a pm- request in flight", 60, fleet.proc)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "client hung"
        events = flightrec.read_ring(ring)["events"]
        start = {e["request_id"]: e["ts"] for e in events
                 if e["ev"] == "request_start"}
        spans = {e["request_id"]: e["ts"] - start[e["request_id"]]
                 for e in events
                 if e["ev"] == "request_end" and e["request_id"] in start}
        assert spans and min(spans.values()) >= 0.2, min(spans.values())
    finally:
        stop.set()
        rc = fleet.close()
    assert rc == 0, fleet.log()[-2000:]
