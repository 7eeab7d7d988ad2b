"""The reference ci.sh's capture/replay + SLO drill on the port, on the
CPU.

Two members of tests/torch_cpu_front.py (the port's asyncio front over
DetectorService(device="cpu")) run under the port's supervisor with the
lock-order watchdog on, LDT_CAPTURE_DIR, LDT_FLIGHTREC_DIR,
LDT_SLO=p99_ms=1,err_pct=2,window_sec=8 and a per-tenant quota of 8
documents (chip_smoke.capture_drill, which phase `capture` runs over
the card's members). The burn-rate alert fires on /sloz and recovers;
the throttled tenant's sheds show on /fleetz while the other tenant is
served; the capture holds one record a request, sheds included, from
both members in arrival order; slo_breach and slo_recovered reach the
flight recorder. The merged capture is then replayed at 4x against a
fresh fleet through the port bench's replay_records: every request
completes and none drops. Ports come from chip_smoke.free_port, so the
drill runs beside other workers.
"""
from __future__ import annotations

import time

import chip_smoke

MODULE = "tests.torch_cpu_front"


def test_capture_replay_slo_drill(tmp_path):
    t0 = time.monotonic()
    got = chip_smoke.capture_drill(str(tmp_path / "drill"), MODULE)
    records = got["records"]
    assert len(records) == chip_smoke.CAPTURE_REQUESTS == 72
    assert got["members"] == ["m0", "m1"]
    # two tenants, anonymized in the records
    assert len(got["tenants"]) == 2 and "base" not in got["tenants"]
    assert got["hot_shed"] > 0 and got["hot_ok"] > 0
    assert {"slo_breach", "slo_recovered"} <= set(got["slo_events"])
    # the CPU scorer launches no kernel
    assert sorted(got["counts"]) == [0, 1]
    assert all(c["launches"] == 0 for c in got["counts"].values())

    fleet = chip_smoke.Fleet(chip_smoke.FLEET_WORKERS,
                             str(tmp_path / "replay"), MODULE,
                             LDT_RESULT_CACHE_MB=0,
                             LDT_RESULT_CACHE_SHM_MB=0, LDT_LOCK_DEBUG=1)
    rc = None
    try:
        fleet.wait(lambda s: s["ready"] == chip_smoke.FLEET_WORKERS,
                   "replay fleet ready", 120)
        rep = chip_smoke.capture_replay(records, fleet.port)
        rc = fleet.close()
    finally:
        if rc is None:
            fleet.close()
    assert rc == 0, fleet.log()[-2000:]
    assert rep["completed"] == rep["requests"] == len(records)
    assert rep["counts"]["drop"] == 0
    assert rep["speedup"] == chip_smoke.CAPTURE_SPEEDUP
    assert time.monotonic() - t0 < 90
