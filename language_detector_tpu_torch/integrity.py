"""Data-plane integrity: scrubbing, canaries, quarantine, auto-heal.

The port's copy of language_detector_tpu/integrity.py. The serving
stack survives crashed workers and evicted lanes, but a bit-flip in
the mmap'd artifact, the device-resident tables, or a frame payload
silently yields WRONG languages at full throughput with no signal.
This module makes corruption detected, attributed, and healed:

  artifact digests   model.ldta carries a per-blob crc32 footer
                     (artifact.py) verified at every load and re-checked
                     before a swap cutover (service/swap.py refuses a
                     corrupt standby).
  device scrubbing   between flushes, on an LDT_SCRUB_INTERVAL_SEC
                     cadence, each pool lane's table planes fold to a
                     digest ON DEVICE (ops/kernels.table_digest, torch
                     ops on the tables' device, no host copy of the
                     planes) and compare against the fingerprint
                     recorded at upload (ops/device_tables.fingerprint).
  golden canaries    each scrub also scores a pinned canary pack whose
                     expected codes are baked into the artifact at pack
                     time (`python -m language_detector_tpu_torch.
                     tools.artifact_tool --pack`, the g/ arrays) and
                     scored through the lane's own scorer (the
                     fused-tote kernel on the card) — catching compute
                     faults a table digest can't see.
  quarantine + heal  a mismatch marks the lane CORRUPT
                     (parallel/pool.py): never drafted, excluded from
                     capacity. Heal re-uploads fresh tables from the
                     host mmap, verifies the new fingerprint, and
                     re-admits the lane through the half-open PROBING
                     flow — one healthy served batch completes it.

Every detection/heal counts into the ldt_integrity_* series and emits
a flight-recorder event.
"""
from __future__ import annotations

import dataclasses
import random
import time

import numpy as np
import torch

from . import faults, flightrec, knobs, telemetry
from .locks import make_lock
from .ops.device_tables import PLANES

# Pinned golden-query canary pack: 8 short, unambiguous, multi-script
# docs. Baked into the artifact with their expected codes at pack time
# (language_detector_tpu_torch/tools/artifact_tool.py --pack); the pack
# must stay deterministic on the device path (no packer fallback, no
# gate retry).
CANARY_DOCS = (
    "This is a simple English sentence about the weather today, "
    "which should be perfectly easy to detect.",
    "Ceci est une phrase française tout à fait ordinaire qui parle "
    "de la pluie et du beau temps.",
    "Dies ist ein ganz gewöhnlicher deutscher Satz über das Wetter "
    "und die Jahreszeiten.",
    "Esta es una frase española muy normal que habla del tiempo y "
    "de las estaciones del año.",
    "Это совершенно обычное русское предложение о погоде и "
    "временах года.",
    "これは天気と季節についてのごく普通の日本語の文章です。"
    "言語検出は簡単なはずです。",
    "هذه جملة عربية عادية تماما تتحدث عن الطقس والفصول "
    "في السنة.",
    "Αυτή είναι μια συνηθισμένη ελληνική πρόταση για τον καιρό "
    "και τις εποχές του χρόνου.",
)


def corrupt_tables(dt, seed: int):
    """Chaos helper: one seeded bit-flip in one plane of a DeviceTables
    — models HBM corruption for the table_upload fault seam and the
    scrub chaos smoke. The plane is chosen by the seed (seed %
    n_planes, in the reference's leaf order, device_tables.PLANES) and
    the bit exactly as faults.corrupt_buffer chooses it over the
    plane's bytes. The flip lands in a clone on the plane's device and
    a NEW DeviceTables is returned: simulated pool lanes share one
    DeviceTables, so an in-place flip would corrupt every lane."""
    name = PLANES[seed % len(PLANES)]
    bad = getattr(dt, name).clone()
    raw = bad.reshape(-1).view(torch.uint8)
    if raw.numel():
        rng = random.Random(seed)
        byte = rng.randrange(raw.numel())
        raw[byte] ^= 1 << rng.randrange(8)
    return dataclasses.replace(dt, **{name: bad})


class IntegrityMonitor:
    """Per-lane scrub/canary scheduler with quarantine + auto-heal.

    Decoupled from the engine through four closures so tests can drive
    the REAL detect/heal edges against fake digests:

      digest_fn(lane)    -> current per-plane digest tuple of the
                            lane's device tables (on-device fold)
      reupload_fn(lane)  -> fresh tables uploaded to the lane; returns
                            the new expected fingerprint
      canary_fn(lane)    -> True when the lane's canary pack scored
                            its expected codes (None = canary off)
      expected[lane.idx] -> the fingerprint recorded at upload

    maybe_scrub() is the engine hook (models/ngram._epilogue): a
    monotonic-clock cadence gate, one scrub in flight at most, never
    raises — a scrub error counts result="error" and the flush that
    triggered it proceeds untouched."""

    def __init__(self, lanes, expected: dict, digest_fn, reupload_fn,
                 canary_fn=None, interval_sec: float = 0.0,
                 clock=None) -> None:
        self.lanes = lanes
        self.expected = expected      # lane idx -> fingerprint tuple
        self.digest_fn = digest_fn
        self.reupload_fn = reupload_fn
        self.canary_fn = canary_fn
        self.interval_sec = interval_sec
        self._clock = clock or time.monotonic
        self._lock = make_lock("integrity.scrub")
        self._last_scrub = self._clock()
        # build_from_env's canary: its expected codes, where they came
        # from ("artifact": the g/ arrays baked at pack time, "scalar":
        # pinned at first use) and the last check's agreement
        self.canary_state: dict | None = None
        self.stats = {"scrubs": 0, "detected": 0, "healed": 0,
                      "last_scrub_ms": 0.0}

    # -- detection / heal edges (the model-checked state machine) -----

    def detect(self, lane, kind: str) -> bool:
        """Quarantine a lane the scrub or canary caught: ACTIVE ->
        CORRUPT. Returns False when the lane was already out of
        rotation (no double-count)."""
        if not lane.mark_corrupt(self._clock()):
            return False
        self.stats["detected"] += 1
        telemetry.REGISTRY.counter_inc("ldt_integrity_detected_total",
                                       kind=kind, lane=lane.name)
        flightrec.emit_event("integrity_detected", lane=lane.name,
                             kind=kind)
        flightrec.emit_event("pool_lane_state", lane=lane.name,
                             state="corrupt")
        return True

    def heal(self, lane) -> bool:
        """Re-upload fresh tables from the host copy, verify the new
        fingerprint, and hand the lane back to the pool's half-open
        flow (CORRUPT -> EVICTED with the probe immediately due; the
        next rotation admits it PROBING and one healthy served batch
        re-activates it). Returns False when the fresh upload itself
        fails verification (the lane stays quarantined; the next scrub
        retries)."""
        fp = self.reupload_fn(lane)
        self.expected[lane.idx] = fp
        if tuple(self.digest_fn(lane)) != tuple(fp):
            return False
        if not lane.mark_healed(self._clock()):
            return False
        self.stats["healed"] += 1
        telemetry.REGISTRY.counter_inc("ldt_integrity_healed_total",
                                       lane=lane.name)
        flightrec.emit_event("integrity_healed", lane=lane.name)
        return True

    # -- the scrub pass ----------------------------------------------

    def scrub_lane(self, lane) -> str:
        """One lane's scrub: digest compare, then canary. Returns the
        result label ("ok" | "mismatch" | "error")."""
        if faults.ACTIVE is not None:
            # chaos seam: a `corrupt` rule on table_upload bit-flips
            # one plane of THIS lane's device tables before the scan —
            # exactly what the scan must then catch
            seed = faults.corruption("table_upload")
            if seed is not None and lane.dt is not None:
                lane.dt = corrupt_tables(lane.dt, seed)
        if tuple(self.digest_fn(lane)) != \
                tuple(self.expected.get(lane.idx, ())):
            # detect() is a no-op for a lane already quarantined, but
            # heal() always retries: a lane whose earlier heal failed
            # (host artifact itself bad) must not be stranded CORRUPT
            self.detect(lane, "scrub")
            self.heal(lane)
            return "mismatch"
        if self.canary_fn is not None and not self.canary_fn(lane):
            self.detect(lane, "canary")
            self.heal(lane)
            return "mismatch"
        return "ok"

    def scrub_pass(self) -> None:
        """Scrub every lane once. Per-lane errors are contained: a
        lane whose digest launch itself dies counts result="error" and
        the pass moves on — the scrub must never take the flush path
        down with it."""
        t0 = self._clock()
        for lane in self.lanes:
            try:
                result = self.scrub_lane(lane)
            except Exception:  # noqa: BLE001 - scrub must not kill the flush
                result = "error"
            telemetry.REGISTRY.counter_inc("ldt_integrity_scrub_total",
                                           lane=lane.name,
                                           result=result)
        self.stats["scrubs"] += 1
        self.stats["last_scrub_ms"] = (self._clock() - t0) * 1e3

    def maybe_scrub(self) -> bool:
        """Engine hook: run a scrub pass when the cadence is due.
        Non-blocking — concurrent flushes skip instead of queueing
        behind an in-flight scrub."""
        if self.interval_sec <= 0:
            return False
        now = self._clock()
        if now - self._last_scrub < self.interval_sec:
            return False
        if not self._lock.acquire(blocking=False):
            return False
        try:
            if self._clock() - self._last_scrub < self.interval_sec:
                return False
            self.scrub_pass()
            self._last_scrub = self._clock()
            return True
        finally:
            self._lock.release()


def build_from_env(engine) -> IntegrityMonitor | None:
    """The engine's integrity monitor, or None when scrubbing is off
    (LDT_SCRUB_INTERVAL_SEC unset/0 — the epilogue hook is a single
    attribute test) or the engine has no device pool (no per-lane
    tables to scrub; artifact digests still verify at load)."""
    interval = knobs.get_float("LDT_SCRUB_INTERVAL_SEC") or 0.0
    if interval <= 0 or engine.pool is None:
        return None
    from .ops import kernels
    from .ops.device_tables import DeviceTables, fingerprint
    from .ops.score import unpack_chunks_out

    def digest_fn(lane):
        dt = lane.dt if lane.dt is not None else engine.dt
        return tuple(int(x) for x in kernels.table_digest(dt).tolist())

    def reupload_fn(lane):
        lane.dt = DeviceTables.from_host(engine.tables, engine.reg,
                                         engine.device)
        if engine.device.type == "cuda":
            # finish the upload before the lane's streams read it
            torch.cuda.synchronize(engine.device)
        return fingerprint(lane.dt)

    n_canary = knobs.get_int("LDT_CANARY_DOCS")
    n_canary = 8 if n_canary is None else n_canary
    # statistical canary gate: the first 8 docs are the pinned core
    # set (exact-match, any miss fails — they are chosen to be
    # unambiguous, so a single flip means real corruption); docs past
    # 8 draw deterministically from the evalsuite corpus and pass on
    # an agreement fraction >= LDT_CANARY_FLOOR, so a large canary set
    # scales confidence without turning one borderline eval doc into
    # a permanent false alarm
    n_core = min(max(0, n_canary), len(CANARY_DOCS))
    docs = list(CANARY_DOCS[:n_core])
    if n_canary > len(CANARY_DOCS):
        from .evalsuite import corpus_pairs
        extra = [t for _, t in corpus_pairs()]
        docs += extra[:n_canary - len(CANARY_DOCS)]
    floor = knobs.get_float("LDT_CANARY_FLOOR")
    floor = 0.95 if floor is None else floor
    canary_fn = None
    if docs:
        from . import native
        # expected codes: baked into the artifact at pack time (the
        # g/ canary arrays, tables.load_mmap) when present; else
        # pinned at first use from the engine's own trusted-at-init
        # tables via the scalar oracle
        state = {"expect": None, "source": None, "agreement": None}

        def expected_codes():
            if state["expect"] is None:
                baked_docs = getattr(engine.tables, "canary_docs",
                                     None)
                baked = getattr(engine.tables, "canary_codes", None)
                if baked is not None and baked_docs is not None \
                        and list(baked_docs) == docs:
                    state["expect"] = list(baked)
                    state["source"] = "artifact"
                else:
                    from .engine_scalar import detect_scalar
                    state["expect"] = [
                        engine.reg.code(detect_scalar(
                            t, engine.tables, engine.reg,
                            engine.flags).summary_lang)
                        for t in docs]
                    state["source"] = "scalar"
            return state["expect"]

        def canary_fn(lane):
            # the lane's own scorer and tables: the fused-tote kernel
            # on the card, one launch per canary batch
            cb = native.pack_chunks_native(
                docs, engine.tables, engine.reg, flags=engine.flags,
                l_doc=engine.max_slots, c_doc=engine.max_chunks)
            fut = engine._launch_raw(cb, lane="canary",
                                     score_fn=lane.score_fn,
                                     dt=lane.dt)
            rows = unpack_chunks_out(np.asarray(fut),
                                     cb.wire["cmeta"])
            ep = native.epilogue_flat_native(rows, cb, engine.flags,
                                             engine.reg)
            got = [engine.reg.code(int(ep[b][0]))
                   for b in range(len(docs))]
            want = expected_codes()
            state["agreement"] = sum(
                g == w for g, w in zip(got, want)) / len(docs)
            if got[:n_core] != want[:n_core]:
                return False
            ext_got, ext_want = got[n_core:], want[n_core:]
            if not ext_got:
                return True
            agree = sum(g == w for g, w in zip(ext_got, ext_want)) \
                / len(ext_got)
            return agree >= floor

    expected = {ln.idx: fingerprint(ln.dt)
                for ln in engine.pool.lanes if ln.dt is not None}
    mon = IntegrityMonitor(
        [ln for ln in engine.pool.lanes if ln.dt is not None],
        expected, digest_fn, reupload_fn, canary_fn=canary_fn,
        interval_sec=interval)
    if canary_fn is not None:
        mon.canary_state = state
    return mon


def bench_scrub_overhead(engine) -> dict | None:
    """Measure one full scrub+canary cycle on the engine's monitor: the
    cycle cost amortized over the scrub interval, which should stay
    under 1% of serving capacity."""
    mon = getattr(engine, "integrity", None)
    if mon is None:
        return None
    mon.scrub_pass()   # warm: first canary pack and launch
    t0 = time.monotonic()
    mon.scrub_pass()
    cycle_ms = (time.monotonic() - t0) * 1e3
    interval_ms = max(mon.interval_sec, 1e-9) * 1e3
    return {"scrub_cycle_ms": round(cycle_ms, 3),
            "interval_ms": interval_ms,
            "overhead_frac": cycle_ms / (cycle_ms + interval_ms)}
