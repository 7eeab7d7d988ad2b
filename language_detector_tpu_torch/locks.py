"""Lock construction with an optional debug-mode order watchdog.

Every lock in the serving stack is built through make_lock(name). With
LDT_LOCK_DEBUG unset (production) that is a plain threading.Lock — zero
overhead, nothing recorded. With LDT_LOCK_DEBUG=1 (CI runs the whole
test suite this way) each lock is wrapped so the process-wide watchdog
records the acquisition-order graph BY LOCK NAME and raises
LockOrderInversion the moment any thread:

  - acquires lock B while holding lock A after some thread previously
    established the opposite A-after-B order (a cycle in the order
    graph = a latent deadlock, even if this run never interleaved into
    one); or
  - re-acquires the exact non-reentrant lock instance it already holds
    (guaranteed self-deadlock).

Names are stable per lock ROLE (e.g. "admission.controller",
"telemetry.histogram"), not per instance: two histograms are many
instances of one role, and an inversion between roles is the bug the
watchdog exists to catch. Nested acquisition of two same-name instances
is deliberately not ordered (the stack has no such pattern; adding one
requires a new role name so the graph sees it).

This is the port's copy of language_detector_tpu/locks.py. The static
lock-ownership check over the port is `python -m tools.lint_torch`
(the reference's analyzers, loaded over this package). The watchdog
also counts the debug locks made, the roles acquired and the
inversions it raised (stats()), so a run can show what it watched and
that it found nothing.
"""
from __future__ import annotations

import threading

from . import knobs


class LockOrderInversion(RuntimeError):
    """Two locks were acquired in opposite orders (latent deadlock), or
    a thread re-acquired a non-reentrant lock it already holds."""


class _Watchdog:
    """Process-wide acquisition-order graph + per-thread held stack."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}  # name -> names acquired
        # while it was held (the recorded legal order)
        self._tls = threading.local()
        self._made = 0          # DebugLocks built in this process
        self._inversions = 0    # LockOrderInversions raised
        self._taken: set[str] = set()  # role names acquired at least once

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def _reaches(self, src: str, dst: str) -> bool:
        seen: set[str] = set()
        frontier = [src]
        while frontier:
            n = frontier.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            frontier.extend(self._edges.get(n, ()))
        return False

    def before_acquire(self, lock: "DebugLock") -> None:
        st = self._stack()
        for held in st:
            if held is lock:
                with self._mu:
                    self._inversions += 1
                raise LockOrderInversion(
                    f"re-acquiring non-reentrant lock {lock.name!r} "
                    "already held by this thread (self-deadlock)")
        if not st:
            return
        a, b = st[-1].name, lock.name
        if a == b:
            return
        with self._mu:
            fwd = self._edges.setdefault(a, set())
            if b in fwd:
                return
            if self._reaches(b, a):
                self._inversions += 1
                raise LockOrderInversion(
                    f"lock-order inversion: acquiring {b!r} while "
                    f"holding {a!r}, but the opposite order "
                    f"({b!r} -> ... -> {a!r}) was previously recorded")
            fwd.add(b)

    def after_acquire(self, lock: "DebugLock") -> None:
        self._stack().append(lock)
        if lock.name not in self._taken:
            with self._mu:
                self._taken.add(lock.name)

    def after_release(self, lock: "DebugLock") -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is lock:
                del st[i]
                return

    def edges(self) -> dict[str, set[str]]:
        """Copy of the recorded order graph (tests/debugging)."""
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def note_made(self) -> None:
        with self._mu:
            self._made += 1

    def stats(self) -> dict:
        """{"locks": debug locks made, "edges": recorded order edges,
        "inversions": LockOrderInversions raised, "roles": the role
        names acquired at least once} in this process."""
        with self._mu:
            return {"locks": self._made,
                    "edges": sum(len(v) for v in self._edges.values()),
                    "inversions": self._inversions,
                    "roles": sorted(self._taken)}

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()


class DebugLock:
    """Order-checked wrapper over threading.Lock, same interface for
    the `with`-statement call sites the stack uses."""

    def __init__(self, name: str, watchdog: _Watchdog) -> None:
        self.name = name
        self._inner = threading.Lock()
        self._dog = watchdog
        watchdog.note_made()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        self._dog.before_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._dog.after_acquire(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._dog.after_release(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<DebugLock {self.name!r} {self._inner!r}>"


WATCHDOG = _Watchdog()


def make_lock(name: str) -> "threading.Lock | DebugLock":
    """The stack's lock constructor. `name` identifies the lock's ROLE
    for the debug order graph; with LDT_LOCK_DEBUG off it is ignored
    and a plain threading.Lock returns."""
    if knobs.get_bool("LDT_LOCK_DEBUG"):
        return DebugLock(name, WATCHDOG)
    return threading.Lock()
