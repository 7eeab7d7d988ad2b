"""Worker self-recycle: bounded memory for long-lived serving processes.

The reference package added this for a backend plugin that leaked host
memory per device dispatch; the port keeps the same bounds for any
long-lived worker. Both HTTP fronts periodically evaluate
`should_recycle` and, past a dispatch-count or RSS bound, exit cleanly
with RECYCLE_EXIT_CODE so a supervisor or a container restart policy
replaces the worker.

Configuration (env, unset = feature off; declared in knobs.py):
  LDT_MAX_DISPATCHES  recycle after this many engine batch dispatches
  LDT_MAX_RSS_MB      recycle when process RSS exceeds this many MB
"""
from __future__ import annotations

from .. import knobs

# Distinct from error exits so supervisors/restart policies can tell a
# planned recycle from a crash (and bare `docker restart: on-failure`
# still catches both).
RECYCLE_EXIT_CODE = 77


def check_interval_sec() -> float:
    """Watcher period (LDT_RECYCLE_CHECK_SEC env override, for tests)."""
    v = knobs.get_float("LDT_RECYCLE_CHECK_SEC")
    return max(v if v is not None else 5.0, 0.05)


def rss_mb() -> float:
    """Resident set size of this process in MB (0.0 if unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return 0.0


def limits_from_env() -> tuple[int | None, float | None]:
    """(max_dispatches, max_rss_mb) from the environment; None = off.
    Bound-knob semantics (knobs.py): unset, non-positive, or mistyped
    (loud warning) all answer None."""
    return (knobs.get_int("LDT_MAX_DISPATCHES"),
            knobs.get_float("LDT_MAX_RSS_MB"))


def should_recycle(dispatches: int,
                   max_dispatches: int | None,
                   max_rss_mb: float | None,
                   current_rss_mb: float | None = None) -> str | None:
    """Reason string when a bound is exceeded, else None."""
    if max_dispatches is not None and dispatches >= max_dispatches:
        return (f"dispatch bound reached ({dispatches} >= "
                f"{max_dispatches})")
    if max_rss_mb is not None:
        rss = rss_mb() if current_rss_mb is None else current_rss_mb
        if rss >= max_rss_mb:
            return f"RSS bound reached ({rss:.0f}MB >= {max_rss_mb:.0f}MB)"
    return None
