"""The port's fleet supervisor (language_detector_tpu_torch/service/
fleet.py) on the CPU: tests/test_supervisor.py's fleet cases — N
members spawned and drained, two simultaneous recycles, SIGTERM during
a rolling swap, a member death mid-roll, the per-member crash loop and
the fleet-wide crash circuit, the worker_spawn and worker_lost faults
— through the port's supervisor (LDT_FLEET_WORKERS dispatches to the
port's fleet) with tests/fake_worker.py members. One case runs a
2-member fleet of the port's real asyncio front on the CPU
(tests/torch_cpu_front.py) and holds its HTTP answers byte for byte to
the JAX fronts', with each member's ring directory and one shared
result-cache file; one `cuda` case runs a 1-member fleet of the port's
default front on the card. Every subprocess is bounded by a timeout.
"""
from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import chip_smoke
from language_detector_tpu_torch.service.recycle import RECYCLE_EXIT_CODE
from language_detector_tpu_torch.tables import DATA_DIR

REPO = Path(__file__).resolve().parent.parent
SUPERVISOR = [sys.executable, "-m",
              "language_detector_tpu_torch.service.supervisor",
              "tests.fake_worker"]


def _wait_for(path: Path, timeout: float = 20) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if path.exists():
            return True
        time.sleep(0.05)
    return False


def _stop(proc) -> str:
    """SIGTERM the supervisor and return its full stdout."""
    try:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate(timeout=10)
    return out


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_fleet(tmp_path, n: int, env_extra=None):
    """(Popen, status_port) for an n-member fake-worker fleet with the
    control-plane endpoint enabled."""
    port = _free_port()
    env = dict(os.environ)
    env["FAKE_WORKER_SERVE"] = str(tmp_path)
    env["LDT_FLEET_WORKERS"] = str(n)
    env["LDT_FLEET_STATUS_PORT"] = str(port)
    env["LDT_SWAP_TIMEOUT_SEC"] = "20"
    env["LDT_CRASH_BACKOFF_BASE_SEC"] = "0.2"
    env["LDT_CRASH_BACKOFF_MAX_SEC"] = "0.5"
    env.update(env_extra or {})
    proc = subprocess.Popen(SUPERVISOR, cwd=REPO, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, port


def _fleetz(port: int):
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/fleetz", timeout=2) as r:
            return json.loads(r.read())
    except Exception:  # noqa: BLE001 - not up yet / mid-teardown
        return None


def _wait_fleet(port: int, pred, timeout: float = 30):
    """Poll /fleetz until pred(snapshot) holds; the snapshot or None."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        snap = _fleetz(port)
        if snap is not None and pred(snap):
            return snap
        time.sleep(0.05)
    return None


def test_fleet_spawns_n_members_and_drains_clean(tmp_path):
    proc, port = _start_fleet(tmp_path, 3)
    try:
        snap = _wait_fleet(port, lambda s: s["ready"] == 3)
        assert snap, "fleet never reached 3 ready members"
        assert [m["slot"] for m in snap["members"]] == [0, 1, 2]
        assert {m["generation"] for m in snap["members"]} == {1, 2, 3}
        assert snap["circuit"] == "closed" and snap["bootstrapped"]
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    slots = sorted(json.loads(line)["fake_worker_slot"]
                   for line in out.splitlines()
                   if "fake_worker_slot" in line)
    assert slots == ["0", "1", "2"]
    assert '"reason": "fleet-start"' in out


def test_fleet_members_share_compile_cache_and_bundle(tmp_path):
    """Every member gets the same LDT_COMPILE_CACHE_DIR (default: the
    checkout's build/torch_kernels/) and the same LDT_AOT_DIR (default:
    one per fleet): the first member to build the kernel library
    exports it, the others load it."""
    env = dict(os.environ, FAKE_WORKER_SERVE=str(tmp_path),
               LDT_FLEET_WORKERS="2", LDT_FLEET_STATUS_PORT=str(
                   _free_port()))
    env.pop("LDT_AOT_DIR", None)
    env.pop("LDT_COMPILE_CACHE_DIR", None)
    proc = subprocess.Popen(SUPERVISOR[:-1] + ["tests.torch_dirs_worker"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        assert _wait_fleet(int(env["LDT_FLEET_STATUS_PORT"]),
                           lambda s: s["ready"] == 2), "fleet never ready"
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    # members share the supervisor's stdout: read the fields, not lines
    caches = re.findall(r'"fake_worker_cache_dir": "([^"]*)"', out)
    bundles = re.findall(r'"fake_worker_aot_dir": "([^"]*)"', out)
    assert caches == [str(REPO / "build" / "torch_kernels")] * 2
    assert len(bundles) == 2 and bundles[0] == bundles[1] != "unset"
    assert f"ldt-aot-{proc.pid}" in bundles[0]
    os.rmdir(bundles[0])


def test_fleet_two_simultaneous_recycles(tmp_path):
    """Both members exiting RECYCLE_EXIT_CODE in the same reap window
    must respawn immediately (no crash accounting, no circuit trip)."""
    proc, port = _start_fleet(tmp_path, 2, {
        "FAKE_WORKER_CRASH_FILE": str(tmp_path / "crash-%SLOT%")})
    try:
        assert _wait_fleet(port, lambda s: s["ready"] == 2)
        (tmp_path / "crash-0").write_text(str(RECYCLE_EXIT_CODE))
        (tmp_path / "crash-1").write_text(str(RECYCLE_EXIT_CODE))
        snap = _wait_fleet(
            port, lambda s: s["ready"] == 2 and
            {m["generation"] for m in s["members"]} == {3, 4})
        assert snap, "fleet never recovered from the double recycle"
        assert snap["circuit"] == "closed"
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    assert out.count('"reason": "recycle"') == 2
    assert '"fleet-circuit-open"' not in out


def test_fleet_sigterm_during_rolling_swap(tmp_path):
    """SIGHUP roll in flight, then SIGTERM (and another SIGHUP for good
    measure): the roll aborts, the standby is killed, every member
    drains, exit 0 — the N>1 generalization of the signal-race
    contract."""
    proc, port = _start_fleet(tmp_path, 2, {
        "FAKE_WORKER_READY_DELAY": "1.0"})
    try:
        assert _wait_fleet(port, lambda s: s["ready"] == 2)
        proc.send_signal(signal.SIGHUP)
        # the slot-0 standby (generation 3) starts, then holds in its
        # ready delay — SIGTERM lands inside the roll window
        assert _wait_for(tmp_path / "gen-3.up"), "standby never spawned"
        proc.send_signal(signal.SIGTERM)
        proc.send_signal(signal.SIGHUP)   # queued swap must be ignored
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    assert '"swap-abort"' in out
    assert '"reason": "signal"' in out
    assert "rolling swap complete" not in out


def test_fleet_member_death_during_rolling_swap(tmp_path):
    """A member dying while another slot is mid-roll: the roll for the
    rolling slot completes, the dead member is reaped and respawned,
    and the fleet returns to full strength."""
    proc, port = _start_fleet(tmp_path, 2, {
        "FAKE_WORKER_READY_DELAY": "1.0",
        "FAKE_WORKER_CRASH_FILE": str(tmp_path / "crash-%SLOT%")})
    try:
        assert _wait_fleet(port, lambda s: s["ready"] == 2)
        proc.send_signal(signal.SIGHUP)
        assert _wait_for(tmp_path / "gen-3.up"), "standby never spawned"
        (tmp_path / "crash-1").write_text("9")    # dies mid-roll
        snap = _wait_fleet(
            port, lambda s: s["ready"] == 2 and
            {m["generation"] for m in s["members"]} == {3, 4},
            timeout=40)
        assert snap, "fleet never healed after the mid-roll death"
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    assert "roll complete" in out
    assert '"reason": "crash"' in out


def test_fleet_crash_loop_parks_member_and_circuit_recovers(tmp_path):
    """Per-member crash-loop parks the flapping slot; the SAME two
    crashes counted fleet-wide trip the circuit; the cooldown probe
    sees the surviving member still accepting and closes it again."""
    proc, port = _start_fleet(tmp_path, 2, {
        "FAKE_WORKER_CRASH_FILE": str(tmp_path / "crash-%SLOT%"),
        "LDT_CRASH_LOOP_MAX": "2",
        "LDT_CRASH_LOOP_WINDOW_SEC": "60",
        "LDT_FLEET_CIRCUIT_COOLDOWN_SEC": "0.5"})
    try:
        assert _wait_fleet(port, lambda s: s["ready"] == 2)
        (tmp_path / "crash-0").write_text("9")
        # first crash: below the loop max, slot 0 respawns
        assert _wait_fleet(port, lambda s: any(
            m["slot"] == 0 and m["generation"] == 3
            and m["state"] == "ready" for m in s["members"]))
        (tmp_path / "crash-0").write_text("9")
        snap = _wait_fleet(port, lambda s: any(
            m["slot"] == 0 and m["parked"] for m in s["members"]))
        assert snap, "slot 0 never parked after its crash loop"
        snap = _wait_fleet(port, lambda s: s["circuit"] == "closed")
        assert snap, "circuit never closed after the cooldown probe"
        assert any(m["slot"] == 1 and m["state"] == "ready"
                   for m in snap["members"])
        assert not any(m["slot"] == 0 and m["state"] == "ready"
                       for m in snap["members"])
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    assert '"reason": "crash-loop"' in out
    assert '"fleet-circuit-open"' in out
    assert '"fleet-circuit-close"' in out


def test_fleet_spawn_fault_retries_after_backoff(tmp_path):
    """worker_spawn fault point: the injected spawn failure costs one
    attempt, the member retries after backoff, the fleet still reaches
    full strength."""
    proc, port = _start_fleet(tmp_path, 2, {
        "LDT_FAULTS": "worker_spawn:error:once"})
    try:
        assert _wait_fleet(port, lambda s: s["ready"] == 2), \
            "fleet never recovered from the injected spawn failure"
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    assert '"reason": "spawn-failed"' in out


def test_fleet_worker_lost_fault_fails_over(tmp_path):
    """worker_lost fault point: a silently-lost member is SIGKILLed by
    the seam, treated as a crash, and replaced; the loss shows up on
    the status /metrics exposition."""
    import urllib.request
    proc, port = _start_fleet(tmp_path, 2, {
        "LDT_FAULTS": "worker_lost:error:once"})
    try:
        snap = _wait_fleet(
            port, lambda s: s["ready"] == 2 and
            max(m["generation"] for m in s["members"]) >= 3)
        assert snap, "fleet never replaced the lost member"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            metrics = r.read().decode()
        assert 'ldt_fleet_worker_lost_total{reason="lost"} 1' in metrics
        assert "ldt_fleet_ready 2" in metrics
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out


# -- members of the port's real front ----------------------------------------


def _bodies() -> list:
    lines = [ln.split("\t", 1)[1].rstrip("\n") for ln in
             open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")]
    out = [json.dumps({"request": [{"text": t} for t in lines[i:i + n]]},
                      ensure_ascii=k % 2 == 0).encode()
           for k, (i, n) in enumerate(((0, 1), (3, 7), (10, 70),
                                       (0, 100), (40, 2)))]
    return out + [b"{nope", json.dumps({"request": [
        {"text": "?!"}, {"no": 1}, {"text": ""}]}).encode()]


def _reference_answers(tmp_path, bodies) -> list:
    """The JAX asyncio front's HTTP answers (its scalar service)."""
    ref = chip_smoke.Fronts(
        "language_detector_tpu",
        lambda server, threaded: server.DetectorService(
            use_device=False, start_batcher=threaded, max_delay_ms=1.0),
        str(tmp_path / "ref"))
    try:
        return chip_smoke.drive_lane(ref, "aio-http", bodies, 2)[0]
    finally:
        ref.close()


def test_fleet_of_port_fronts_answers_as_jax_fronts(tmp_path):
    """Two members of the port's asyncio front on the CPU behind one
    SO_REUSEPORT port, each with its own ring directory, sharing one
    result-cache tier file: every HTTP answer (status, echoed id,
    payload) equals the JAX front's, twice over (the second pass hits
    the caches), and SIGINT drains both members to exit 0."""
    bodies = _bodies()
    want = _reference_answers(tmp_path, bodies)
    fleet = chip_smoke.Fleet(2, str(tmp_path), "tests.torch_cpu_front",
                             LDT_FLEET_HEALTH_SEC=0.5)
    rc = None
    try:
        snap = fleet.wait(lambda s: s["ready"] == 2, "2 members ready",
                          120)
        assert all(m["metrics_port"] > 0 for m in snap["members"])
        for _ in range(2):
            load = chip_smoke.HttpLoad(fleet.port, bodies, 4)
            load.run()
            assert load.answers == want
            assert load.failed == 0 and load.retries == 0
        shm = [d for d in os.listdir(os.path.join(
            os.path.dirname(fleet.log_path), "shm"))]
        assert sorted(d for d in shm if d.startswith("m")) == ["m0", "m1"]
        assert any(d.startswith("ldt-shared-cache-") for d in shm)
        counts = fleet.counts()
        assert sorted(counts) == [0, 1]
        assert all(c["launches"] == 0 for c in counts.values())
    finally:
        rc = fleet.close()
    assert rc == 0, fleet.log()[-2000:]


@pytest.mark.cuda
def test_fleet_member_on_card_answers_as_cpu_front(tmp_path):
    """A 1-member fleet of the supervisor's default module (the port's
    asyncio front on the card) answers one request as the port's CPU
    front does, and its /metrics counts a kernel launch a dispatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fleet's default member is "
                    "the port's front on the card")
    bodies = _bodies()[3:4]
    cpu = chip_smoke.Fronts(
        "language_detector_tpu_torch",
        lambda server, threaded: server.DetectorService(
            start_batcher=threaded, device="cpu", max_delay_ms=1.0),
        str(tmp_path / "cpu"))
    try:
        want = chip_smoke.drive_lane(cpu, "aio-http", bodies, 1)[0]
    finally:
        cpu.close()
    fleet = chip_smoke.Fleet(1, str(tmp_path))
    try:
        fleet.wait(lambda s: s["ready"] == 1, "member ready", 240)
        load = chip_smoke.HttpLoad(fleet.port, bodies, 1)
        load.run()
        assert load.answers == want
        (c,) = fleet.counts().values()
        assert c["launches"] > 0 and c["launches"] == c["dispatches"]
    finally:
        assert fleet.close() == 0
