"""chip_smoke.py stops every process it started before it exits.

The smoke adopts its orphaned descendants (become_subreaper) and, when
main returns or raises, stop_descendants closes multiprocessing's
resource tracker and stops whatever else is left below it: a worker
whose parent died, a child that ignores SIGTERM. Each case runs in a
subprocess of its own, since becoming a subreaper changes the process
that does it.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import chip_smoke

SCRIPT = r"""
import concurrent.futures, json, multiprocessing, os, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs


def double(x):
    return 2 * x


if __name__ == "__main__":
    cs.become_subreaper()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as p:
        assert p.submit(double, 3).result() == 6
    # an orphan: its shell exits at once and leaves the sleeper behind
    subprocess.run(["sh", "-c", "sleep 120 & exit 0"], check=True)
    stubborn = subprocess.Popen(["sh", "-c", "trap '' TERM; sleep 120"])
    time.sleep(0.3)
    before = cs.descendants(os.getpid())
    left = cs.stop_descendants(limit_s=1.0)
    print(json.dumps({"before": sorted(v[1] for v in before.values()),
                      "left": sorted(v[1] for v in left.values()),
                      "left_pids": sorted(left),
                      "after": len(cs.descendants(os.getpid())),
                      "stubborn": stubborn.pid}))
"""


def test_stop_descendants_stops_orphans_stubborn_children_and_tracker(
        tmp_path):
    script = tmp_path / "reap.py"
    script.write_text(SCRIPT)
    r = subprocess.run([sys.executable, str(script), str(chip_smoke.ROOT)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.splitlines()[-1])
    assert any("resource_tracker" in c for c in out["before"])
    # the tracker ends by its pipe; the two sleepers and the trapping
    # shell needed a signal
    assert not any("resource_tracker" in c for c in out["left"])
    assert sum("sleep 120" in c for c in out["left"]) == 3
    assert out["stubborn"] in out["left_pids"]
    assert out["after"] == 0
    for pid in out["left_pids"]:
        assert not os.path.exists(f"/proc/{pid}"), pid


def test_smoke_without_cuda_fails_and_leaves_no_process(tmp_path):
    shutil.copy(chip_smoke.ROOT / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "still running" not in r.stderr
