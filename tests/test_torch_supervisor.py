"""The port's supervisor (language_detector_tpu_torch/service/
supervisor.py) on the CPU: tests/test_supervisor.py's single-worker
cases — restart-on-recycle, exit-code propagation, restart-on-crash
with backoff, the crash-loop detector, generation numbering, the SIGHUP
blue/green drill and its aborts (standby death, injected standby_spawn
fault, unreadable artifact pointer), and PID-1 signal forwarding —
run through the port's supervisor against the same scriptable
tests/fake_worker.py child over real subprocesses. The reference's
LDT_COMPILE_CACHE_DIR continuity cases run through
tests/torch_dirs_worker.py, which also prints LDT_AOT_DIR: every
generation gets one compile-cache dir (default: the checkout's
build/torch_kernels/, where nvcc builds the kernel library) and one
kernel-library bundle dir (default: per supervisor). The reference's
warmup-timing case (generation 2 warms in under 0.6x generation 1's
time) is replaced by a check that needs no clock: the blue/green
standby, generation 2, is handed generation 1's bundle dir. The fleet's
cases are in tests/test_torch_fleet.py."""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from language_detector_tpu_torch.service.recycle import RECYCLE_EXIT_CODE

REPO = Path(__file__).resolve().parent.parent
SUPERVISOR = [sys.executable, "-m",
              "language_detector_tpu_torch.service.supervisor",
              "tests.fake_worker"]


def _run(env_extra: dict, timeout: float = 30):
    env = dict(os.environ)
    env.update(env_extra)
    return subprocess.run(SUPERVISOR, cwd=REPO, env=env,
                          capture_output=True, text=True,
                          timeout=timeout)


def test_child_exit_code_propagates():
    r = _run({"FAKE_WORKER_EXIT": "5"})
    assert r.returncode == 5
    assert "propagating" in r.stdout


def test_clean_exit_propagates_zero():
    r = _run({"FAKE_WORKER_EXIT": "0"})
    assert r.returncode == 0
    assert "generation 1" in r.stdout
    assert "generation 2" not in r.stdout


def test_recycle_restarts_then_propagates(tmp_path):
    marker = tmp_path / "recycled.marker"
    r = _run({"FAKE_WORKER_RECYCLE": str(marker)})
    # generation 1 exits RECYCLE_EXIT_CODE -> supervisor restarts;
    # generation 2 sees the marker and exits 0, which propagates
    assert r.returncode == 0
    assert marker.exists()
    assert "generation 1" in r.stdout and "generation 2" in r.stdout
    assert "worker recycled" in r.stdout
    assert str(RECYCLE_EXIT_CODE) not in str(r.returncode)


def test_restart_on_crash_recovers(tmp_path):
    counter = tmp_path / "crashes.count"
    r = _run({"FAKE_WORKER_CRASH_UNTIL": f"{counter}:2",
              "LDT_RESTART_ON_CRASH": "1",
              "LDT_CRASH_BACKOFF_BASE_SEC": "0.01",
              "LDT_CRASH_BACKOFF_MAX_SEC": "0.05"})
    # generations 1 and 2 crash (exit 9), generation 3 exits 0
    assert r.returncode == 0, r.stdout + r.stderr
    assert counter.read_text() == "3"
    assert "restarting after backoff" in r.stdout
    for gen in (1, 2, 3):
        assert f"generation {gen}" in r.stdout
    assert "generation 4" not in r.stdout


def test_crash_without_optin_propagates(tmp_path):
    counter = tmp_path / "crashes.count"
    r = _run({"FAKE_WORKER_CRASH_UNTIL": f"{counter}:2"})
    # no LDT_RESTART_ON_CRASH: the first crash propagates immediately
    assert r.returncode == 9
    assert counter.read_text() == "1"
    assert "LDT_RESTART_ON_CRASH" in r.stdout


def test_crash_loop_detected(tmp_path):
    counter = tmp_path / "crashes.count"
    # the worker would need 10 crashes to heal, but the loop detector
    # gives up after 3 inside the window and propagates the exit code
    r = _run({"FAKE_WORKER_CRASH_UNTIL": f"{counter}:10",
              "LDT_RESTART_ON_CRASH": "1",
              "LDT_CRASH_BACKOFF_BASE_SEC": "0.01",
              "LDT_CRASH_BACKOFF_MAX_SEC": "0.05",
              "LDT_CRASH_LOOP_MAX": "3",
              "LDT_CRASH_LOOP_WINDOW_SEC": "60"})
    assert r.returncode == 9
    assert "crash-loop" in r.stdout
    assert counter.read_text() == "3"


def test_generation_env_handed_to_children(tmp_path):
    marker = tmp_path / "recycled.marker"
    r = _run({"FAKE_WORKER_RECYCLE": str(marker)})
    assert r.returncode == 0
    gens = [json.loads(line)["fake_worker_generation"]
            for line in r.stdout.splitlines()
            if "fake_worker_generation" in line]
    assert gens == ["1", "2"]


DIRS_SUPERVISOR = SUPERVISOR[:-1] + ["tests.torch_dirs_worker"]


def _dirs(stdout: str, key: str) -> list:
    return [json.loads(line)[key] for line in stdout.splitlines()
            if key in line]


def _run_dirs(env: dict, timeout: float = 30):
    return subprocess.run(DIRS_SUPERVISOR, cwd=REPO, env=env,
                          capture_output=True, text=True,
                          timeout=timeout)


def test_compile_cache_dir_shared_across_generations(tmp_path):
    """Every spawned generation gets the SAME LDT_COMPILE_CACHE_DIR and
    LDT_AOT_DIR in its env (operator-set here), so generation 2+ loads
    the kernel library generation 1 built or exported instead of
    running nvcc; the supervisor creates both up front."""
    cache, bundle = tmp_path / "kernel-cache", tmp_path / "aot-bundle"
    env = dict(os.environ, FAKE_WORKER_RECYCLE=str(tmp_path / "marker"),
               LDT_COMPILE_CACHE_DIR=str(cache), LDT_AOT_DIR=str(bundle))
    r = _run_dirs(env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert _dirs(r.stdout, "fake_worker_cache_dir") == [str(cache)] * 2
    assert _dirs(r.stdout, "fake_worker_aot_dir") == [str(bundle)] * 2
    assert cache.is_dir() and bundle.is_dir()


def test_compile_cache_dir_defaults_per_supervisor(tmp_path):
    """Without the operator knobs every generation still shares one
    compile-cache dir, the checkout's build/torch_kernels/ (which holds
    the library the checkout built: generation 1 pays no nvcc build it
    already has), and one per-supervisor bundle dir under tempdir."""
    env = dict(os.environ, FAKE_WORKER_RECYCLE=str(tmp_path / "marker"))
    env.pop("LDT_COMPILE_CACHE_DIR", None)
    env.pop("LDT_AOT_DIR", None)
    r = _run_dirs(env)
    assert r.returncode == 0, r.stdout + r.stderr
    caches = _dirs(r.stdout, "fake_worker_cache_dir")
    bundles = _dirs(r.stdout, "fake_worker_aot_dir")
    assert caches == [str(REPO / "build" / "torch_kernels")] * 2
    assert len(bundles) == 2 and bundles[0] == bundles[1] != "unset"
    assert "ldt-aot-" in bundles[0]
    os.rmdir(bundles[0])


# -- blue/green swap drill (SIGHUP) ------------------------------------------


def _start_serving_supervisor(tmp_path, env_extra=None):
    env = dict(os.environ)
    env["FAKE_WORKER_SERVE"] = str(tmp_path)
    env["LDT_SWAP_TIMEOUT_SEC"] = "20"
    env.update(env_extra or {})
    return subprocess.Popen(SUPERVISOR, cwd=REPO, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


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


def test_sighup_swap_drill_promotes_standby(tmp_path):
    proc = _start_serving_supervisor(tmp_path)
    try:
        assert _wait_for(tmp_path / "gen-1.up"), "gen 1 never served"
        proc.send_signal(signal.SIGHUP)
        # the drill spawns generation 2 with the ready-file handshake;
        # once it lands the old generation is drained and gen 2 serves
        assert _wait_for(tmp_path / "gen-2.up"), "standby never spawned"
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    assert "swap drill starting" in out
    assert "swap cutover" in out
    assert "swap complete" in out
    assert "swap-abort" not in out
    # the promoted standby carried the swap env contract
    gens = [json.loads(line)["fake_worker_generation"]
            for line in out.splitlines()
            if "fake_worker_generation" in line]
    assert gens == ["1", "2"]


def test_standby_generation_inherits_the_bundle_dir(tmp_path):
    """Boot-hot continuity without a clock (the reference's timing case
    fails under load): the SIGHUP standby, generation 2, is handed
    generation 1's LDT_AOT_DIR and LDT_COMPILE_CACHE_DIR, so it loads
    the library generation 1 exported instead of building it."""
    env = dict(os.environ, FAKE_WORKER_SERVE=str(tmp_path),
               LDT_SWAP_TIMEOUT_SEC="20")
    env.pop("LDT_AOT_DIR", None)
    env.pop("LDT_COMPILE_CACHE_DIR", None)
    proc = subprocess.Popen(DIRS_SUPERVISOR, cwd=REPO, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        assert _wait_for(tmp_path / "gen-1.up"), "gen 1 never served"
        proc.send_signal(signal.SIGHUP)
        assert _wait_for(tmp_path / "gen-2.up"), "standby never spawned"
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    assert "swap complete" in out
    gens = _dirs(out, "fake_worker_generation")
    bundles = _dirs(out, "fake_worker_aot_dir")
    caches = _dirs(out, "fake_worker_cache_dir")
    assert gens == ["1", "2"]
    assert len(bundles) == 2 and bundles[0] == bundles[1] != "unset"
    assert caches == [str(REPO / "build" / "torch_kernels")] * 2
    os.rmdir(bundles[0])


def test_sighup_swap_aborts_when_standby_dies(tmp_path):
    proc = _start_serving_supervisor(
        tmp_path, {"FAKE_WORKER_STANDBY_CRASH": "1"})
    try:
        assert _wait_for(tmp_path / "gen-1.up")
        proc.send_signal(signal.SIGHUP)
        # the standby starts (drops gen-2.up) then dies before its
        # ready file; give the drill a beat to notice and abort
        assert _wait_for(tmp_path / "gen-2.up")
        time.sleep(1.0)
    finally:
        out = _stop(proc)
    # the old generation kept serving until our SIGTERM — clean exit
    assert proc.returncode == 0, out
    assert "standby died before ready" in out
    assert "swap complete" not in out


def test_sighup_swap_aborts_on_injected_fault(tmp_path):
    proc = _start_serving_supervisor(
        tmp_path, {"LDT_FAULTS": "standby_spawn:error"})
    try:
        assert _wait_for(tmp_path / "gen-1.up")
        proc.send_signal(signal.SIGHUP)
        time.sleep(1.0)  # give the drill a beat to abort
        assert not (tmp_path / "gen-2.up").exists()
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    assert "injected fault" in out
    assert "swap complete" not in out


def test_sighup_swap_artifact_pointer(tmp_path):
    """LDT_ARTIFACT_POINTER names a file whose contents become the
    standby's LDT_ARTIFACT_PATH — the operator flips the pointer, then
    HUPs. An unreadable pointer aborts before any spawn."""
    pointer = tmp_path / "current.txt"
    pointer.write_text(str(tmp_path / "model-v2.ldta"))
    proc = _start_serving_supervisor(
        tmp_path, {"LDT_ARTIFACT_POINTER": str(pointer)})
    try:
        assert _wait_for(tmp_path / "gen-1.up")
        proc.send_signal(signal.SIGHUP)
        assert _wait_for(tmp_path / "gen-2.up")
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    assert "swap complete" in out

    # unreadable pointer: drill aborts, no standby
    missing_dir = tmp_path / "second"
    missing_dir.mkdir()
    proc = _start_serving_supervisor(
        missing_dir,
        {"LDT_ARTIFACT_POINTER": str(tmp_path / "missing.txt")})
    try:
        assert _wait_for(missing_dir / "gen-1.up")
        proc.send_signal(signal.SIGHUP)
        time.sleep(1.0)
        assert not (missing_dir / "gen-2.up").exists()
    finally:
        out = _stop(proc)
    assert proc.returncode == 0, out
    assert "artifact pointer" in out and "swap-abort" in out


@pytest.mark.parametrize("signum", [signal.SIGTERM, signal.SIGINT])
def test_signal_forwarded_to_child(tmp_path, signum):
    sigfile = tmp_path / "sig.txt"
    env = dict(os.environ)
    env["FAKE_WORKER_SIGFILE"] = str(sigfile)
    proc = subprocess.Popen(SUPERVISOR, cwd=REPO, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ready = sigfile.with_suffix(".txt.ready")
        deadline = time.time() + 20
        while not ready.exists() and time.time() < deadline:
            time.sleep(0.05)
        assert ready.exists(), "worker never became ready"
        proc.send_signal(signum)
        rc = proc.wait(timeout=20)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    # the worker received the forwarded signal, wrote it down, and
    # exited 0 — which the supervisor propagates without restarting
    assert sigfile.read_text() == str(int(signum))
    assert rc == 0


def test_default_module_is_the_ports_front():
    """With no module argument the supervisor runs the port's asyncio
    front (the reference runs its own). With no card visible that
    front raises at startup (it never falls back to the CPU) and the
    supervisor propagates the crash."""
    env = dict(os.environ)
    env.update({"LISTEN_PORT": "0", "PROMETHEUS_PORT": "0",
                "CUDA_VISIBLE_DEVICES": ""})
    r = subprocess.run(SUPERVISOR[:3], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert "starting language_detector_tpu_torch.service.aioserver " \
        "(generation 1)" in r.stdout
    assert r.returncode not in (0, RECYCLE_EXIT_CODE), r.stdout
    assert "CUDA is not available" in r.stderr
    assert '"reason": "crash"' in r.stdout
