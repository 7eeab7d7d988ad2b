"""Support for the port's tests that hold it against the JAX package.

The JAX package builds its native packer (libldtpack.so) in place on
first use, and every test worker process builds it at once while it
collects tests/test_aot.py. A worker that loaded the file while another
worker's linker was still writing it keeps that failure for the rest of
its life (language_detector_tpu/native/__init__.py `_load` caches False),
and every test there that needs the JAX engine or packer then fails.
`jax_packer()` undoes that: once the library file has stopped changing,
it clears the cached failure and loads the library again, one process
at a time. The port's test modules call it when they are imported, so
each worker is repaired while it collects, before any of its tests run.
Module-level skip marks that earlier modules evaluated while collecting
stay as they were, so such a worker skips JAX tests it should have run:
`jax_packer()` records the worker, and `lost_workers()` names every
worker of this test run that was repaired (tests/test_torch_engine.py
fails while any was, so the skips never go unseen).
"""
from __future__ import annotations

import fcntl
import os
import time
import uuid
from pathlib import Path

BUILD = Path(__file__).resolve().parent.parent / "build"
LOCK = BUILD / "jax_packer.lock"
# one record a repaired worker, named by the test run (every xdist
# worker of one run shares PYTEST_XDIST_TESTRUNUID)
LOST = BUILD / "jax_packer_lost"
RUN = os.environ.get("PYTEST_XDIST_TESTRUNUID") or uuid.uuid4().hex


def lost_workers() -> list[str]:
    """The workers of this test run whose first load of the JAX
    package's native packer failed (so JAX tests whose skip marks they
    evaluated before jax_packer() repaired them were skipped there)."""
    return sorted(p.read_text() for p in LOST.glob(f"{RUN}.*"))


def jax_packer(timeout_s: float = 300.0) -> None:
    """Make sure this process holds the JAX package's native packer;
    raises if it cannot be loaded within timeout_s."""
    from language_detector_tpu import native as jnative
    if jnative._lib:
        return
    BUILD.mkdir(parents=True, exist_ok=True)
    if jnative._lib is False:
        # an earlier load in this process failed: record the worker
        LOST.mkdir(exist_ok=True)
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        (LOST / f"{RUN}.{os.getpid()}").write_text(
            f"{worker} (pid {os.getpid()})")
    t_end = time.monotonic() + timeout_s
    last = None
    with open(LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            while not jnative._lib:
                try:
                    st = jnative._SO.stat()
                    seen = (st.st_size, st.st_mtime_ns)
                except OSError:
                    seen = "missing"
                # unchanged over a second (or absent twice): no linker
                # is writing it, so loading (or building) is safe
                if seen == last:
                    with jnative._lock:
                        jnative._lib = None
                    jnative._load()
                if time.monotonic() > t_end:
                    raise RuntimeError("the JAX package's native packer "
                                       "did not load")
                last = seen
                if not jnative._lib:
                    time.sleep(1.0)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
