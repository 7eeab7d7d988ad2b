"""On-demand device profiling: a bounded torch.profiler window you can
arm against live traffic.

POST /profilez on either front's metrics port (or SIGUSR2 to the
worker) starts a torch.profiler capture (CPU activity, and CUDA
activity when a card is present) into LDT_PROFILE_DIR; a watchdog
thread stops it LDT_PROFILE_WINDOW_SEC later and writes the window as a
Chrome trace (trace.json in the capture's directory), so an operator
can never leave a profiler running against production. Exactly one
window can be armed at a time (a second request answers 409 busy), and
everything is defensive: no LDT_PROFILE_DIR or a profiler that fails to
start answers a typed 503, never a crash — the serving path must not
depend on profiler availability. Outcomes land in
ldt_profile_captures_total{result=} and the profile_capture
flight-recorder event.
"""
from __future__ import annotations

import json
import os
import threading
import time

from . import flightrec, knobs, telemetry
from .locks import make_lock

_LOCK = make_lock("profiling.window")
_ACTIVE: dict | None = None     # {"dir", "t0", "window_sec"} while armed


def _window(window_sec: float, out_dir: str, started: dict,
            ready: threading.Event) -> None:
    """One capture, start to stop, on this thread: torch.profiler keeps
    its session on the thread that started it, so the watchdog thread
    owns the whole window. The card's activity (kernels, copies) is
    traced process-wide; CPU operators only on this thread."""
    global _ACTIVE
    try:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    except Exception as e:  # noqa: BLE001 - arm() answers a typed 503
        started["error"] = e
        ready.set()
        return
    ready.set()
    time.sleep(window_sec)
    with _LOCK:
        _ACTIVE = None
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        result = "ok"
    except Exception as e:  # noqa: BLE001 - report, never crash serving
        print(json.dumps({"msg": "profiler stop failed",
                          "error": repr(e)}), flush=True)
        result = "error"
    telemetry.REGISTRY.counter_inc("ldt_profile_captures_total",
                                   result=result)
    flightrec.emit_event("profile_capture", phase="stop", result=result,
                         dir=out_dir)


def arm(window_sec: float | None = None) -> tuple:
    """Arm one bounded profiler window -> (status, payload dict).
    503 = disabled/unavailable, 409 = a window is already armed,
    200 = capture started (payload says where and for how long)."""
    global _ACTIVE
    base = knobs.get_str("LDT_PROFILE_DIR")
    if not base:
        telemetry.REGISTRY.counter_inc("ldt_profile_captures_total",
                                       result="unavailable")
        return 503, {"error": "profiling disabled: LDT_PROFILE_DIR "
                              "is not set"}
    if window_sec is None:
        window_sec = knobs.get_float("LDT_PROFILE_WINDOW_SEC") or 5.0
    window_sec = max(0.05, min(float(window_sec), 600.0))
    out_dir = os.path.join(base, f"profile-{os.getpid()}-{int(time.time())}")
    with _LOCK:
        if _ACTIVE is not None:
            telemetry.REGISTRY.counter_inc("ldt_profile_captures_total",
                                           result="busy")
            return 409, {"error": "a profiler window is already armed",
                         "dir": _ACTIVE["dir"]}
        _ACTIVE = {"dir": out_dir, "t0": time.time(),
                   "window_sec": window_sec}
    started: dict = {}
    ready = threading.Event()
    try:
        os.makedirs(out_dir, exist_ok=True)
        threading.Thread(target=_window,
                         args=(window_sec, out_dir, started, ready),
                         daemon=True, name="ldt-profile-window").start()
        ready.wait()
    except Exception as e:  # noqa: BLE001 - typed refusal, never a crash
        started["error"] = e
    if "error" in started:
        with _LOCK:
            _ACTIVE = None
        telemetry.REGISTRY.counter_inc("ldt_profile_captures_total",
                                       result="error")
        flightrec.emit_event("profile_capture", phase="start",
                             result="error")
        return 503, {"error": f"profiler unavailable: "
                              f"{started['error']!r}"}
    flightrec.emit_event("profile_capture", phase="start", result="ok",
                         dir=out_dir, window_sec=window_sec)
    return 200, {"profiling": "started", "dir": out_dir,
                 "window_sec": window_sec}


def active() -> dict | None:
    with _LOCK:
        return dict(_ACTIVE) if _ACTIVE is not None else None


def install_sigusr2() -> bool:
    """SIGUSR2 -> arm(): the no-HTTP path for profiling a wedged or
    fleet-fronted worker. Main-thread only (signal module contract);
    False when that's not the case (tests, embedded use)."""
    import signal
    try:
        signal.signal(signal.SIGUSR2, lambda *_: arm())
        return True
    except ValueError:
        return False
