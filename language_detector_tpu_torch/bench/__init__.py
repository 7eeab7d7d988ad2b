"""The port's measuring layer: the reference's bench.py (and
tools/bench_service.py, ported as ..tools.bench_service) over
language_detector_tpu_torch, mode for mode. Run as

    python -m language_detector_tpu_torch.bench [mode] [args]
        [--device {cuda,cpu}] [--out PATH]

with the reference's modes and arguments (see __main__.py). Each mode
prints one JSON line with the reference's keys and exit codes. Modules:

    corpus     the bench corpora and the synthetic capture
    engine     the headline (batch_detect_throughput), --longdoc and
               --multichip
    kernel     --kernel: the fused-tote kernel per tier wire
    fronts     --fleet and --shm over the port's fronts
    coldstart  --coldstart: cold, compile-cache and bundle starts
    replay     --replay and --replay-synth [--autotune]
    overhead   the telemetry, capture and scrub overheads and the
               --smoke gates

The engine's modes take --device: cuda (the default) raises without
CUDA, cpu scores with the plain PyTorch version; nothing falls back to
the scalar engine. The modes that start the port's fronts (--fleet,
--shm, --coldstart, --replay*) serve on the card only. Departures from
the reference: vs_baseline is null (the reference divides by a TPU
target) and every line carries `card`, the card's name and power limit
as nvidia-smi prints them (null on the CPU); no file is written unless
--out names one; --kernel times the one CUDA kernel with CUDA events (no
xla/fused/lax A/B); --multichip repeats the one card unless N cards are
present (`simulated`); a failed service bench fails the run; --profile
writes a torch.profiler trace.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

# the checkout holding the package: the children's working directory
ROOT = Path(__file__).resolve().parents[2]
PKG = "language_detector_tpu_torch"


def check_device(device: str) -> str:
    """`device` when the engine can run there: "cuda" raises without
    CUDA, as the engine does."""
    from ..models.ngram import resolve_device
    resolve_device(device)
    return device


def child_env(extra: dict | None = None) -> dict:
    """This process's environment for a child, with `extra`'s variables
    set (or removed where the value is None)."""
    env = dict(os.environ)  # ldt-lint: disable=knob-direct-env -- building the child environment, not reading config
    for k, v in (extra or {}).items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    return env


def check_front_device(device: str) -> str:
    """check_device for the modes that start the port's fronts, which
    serve on the card only: any device but "cuda" raises."""
    if device != "cuda":
        raise ValueError(f"the port's fronts serve on the card only; "
                         f"device {device!r} has no front to start")
    return check_device(device)


def card(device: str) -> str | None:
    """The card's name and power limit as nvidia-smi prints them; None
    on the CPU."""
    if device == "cpu":
        return None
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def last_json(stdout: str) -> dict | None:
    """The last JSON object line of a child's output."""
    for line in reversed(stdout.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return None


def run_child(argv: list, timeout: float, env: dict | None = None,
              what: str = "child") -> dict:
    """Run `python argv...` from the checkout and return its JSON line;
    raises with the tail of its stderr when it fails or prints none."""
    r = subprocess.run([sys.executable, *argv], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=timeout)
    out = last_json(r.stdout)
    if r.returncode != 0 or out is None:
        raise RuntimeError(f"{what} failed (rc={r.returncode}): "
                           f"{r.stderr[-4000:]}")
    return out


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def fleetz(status_port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{status_port}/fleetz",
                                timeout=5) as resp:
        return json.loads(resp.read().decode())


def wait_ready(ready, proc, what: str, limit_s: float = 300) -> None:
    """Poll ready() until it is true; raises when proc exits first or
    limit_s passes."""
    deadline = time.time() + limit_s
    while True:
        try:
            if ready():
                return
        except Exception:  # noqa: BLE001 - still booting
            pass
        if proc.poll() is not None:
            raise RuntimeError(f"{what} died rc={proc.poll()}")
        if time.time() > deadline:
            raise RuntimeError(f"{what} never became ready")
        time.sleep(0.2)


def require(ok: bool, msg: str) -> None:
    """A bench gate: raises AssertionError(msg) unless ok."""
    if not ok:
        raise AssertionError(msg)


def log_tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def start_fleet(workers: int, env_extra: dict, log_path: str) -> tuple:
    """The port's supervisor over `workers` asyncio-front members on
    free ports, in its own session, its output in log_path (env_extra:
    variables to set, or to remove where the value is None); returns
    (proc, port, status port) once /fleetz counts every member ready,
    else raises with the log's tail."""
    port, sport = free_port(), free_port()
    env = child_env({"LISTEN_PORT": str(port),
                     "LDT_FLEET_WORKERS": str(workers),
                     "LDT_FLEET_STATUS_PORT": str(sport), **env_extra})
    with open(log_path, "w") as log:
        sup = subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.service.supervisor",
             f"{PKG}.service.aioserver"],
            cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
    try:
        wait_ready(lambda: fleetz(sport)["ready"] == workers, sup,
                   f"{workers}-worker fleet")
    except RuntimeError as e:
        kill_group(sup)
        raise RuntimeError(f"{e}: {log_tail(log_path)}") from e
    except BaseException:
        kill_group(sup)
        raise
    return sup, port, sport


def kill_group(proc) -> None:
    """SIGKILL proc's session and reap proc."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    proc.wait(timeout=30)
