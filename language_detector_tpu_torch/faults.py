"""Declared fault-injection points for chaos testing.

The port's copy of language_detector_tpu/faults.py. Same registry
discipline as knobs.py / telemetry.METRICS: every seam the port's
serving stack can fail at is declared ONCE in FAULT_POINTS below, and
hitting an undeclared point raises KeyError at the first call instead
of silently injecting nothing.

Injection is driven by the LDT_FAULTS env knob — a comma-separated
rule list parsed at import (and re-parseable via configure(), which is
what tests use):

    LDT_FAULTS="device_flush:error:p=0.2:seed=7,scorer_launch:delay_ms=500:once"

Rule grammar:  point:action[:p=F][:seed=N][:once][:after=N]

    action     `error` (raise FaultInjected at the seam),
               `delay_ms=<float>` (sleep that long at the seam), or
               `corrupt` (deterministic seeded bit-flip on the seam's
               named buffer — only the corruption seams honor it, via
               corruption()/corrupt_buffer(); error/delay seams skip
               corrupt rules without consuming their schedule)
    p=F        fire with probability F per arrival (default 1.0),
               drawn from a per-rule random.Random(seed) — the schedule
               is a pure function of (seed, arrival index), so chaos
               runs are reproducible
    seed=N     the schedule seed (default 0)
    once       fire at most once, then disarm the rule
    after=N    skip the first N arrivals (fire from arrival N+1 on)

Multiple rules may target one point; delays accumulate and any error
rule that fires raises. A bad spec or an unknown point fails LOUD
(ValueError at configure/import) — a typo'd chaos profile must not run
as a silently-healthy soak.

Cost contract: with LDT_FAULTS unset, ACTIVE is None and every seam
guards with `if faults.ACTIVE is not None:` — one module-attribute
load and an identity test, nothing else. Every fault that actually fires
counts into ldt_fault_injected_total{point=}.
"""
from __future__ import annotations

import random
import time

from . import knobs, telemetry
from .locks import make_lock

# point -> where the seam lives in the port (the reference declares
# more: its pool, fleet, shm ring, AOT and integrity seams, which the
# port does not have yet)
FAULT_POINTS: dict = {
    "frame_payload": "wire ingest, per received frame body before "
                     "the CRC check (a corrupt rule bit-flips one "
                     "payload byte; with LDT_WIRE_CRC the frame is "
                     "refused instead of parsed)",
    "device_flush": "models/ngram._epilogue, the device result fetch",
    "scorer_launch": "models/ngram._launch, every scorer launch (the "
                     "fused-tote kernel, or the plain version on the "
                     "CPU)",
    "queue_put": "both batchers' submit(), before the enqueue",
    "queue_get": "both batchers' collector, after dequeuing a batch "
                 "(an error fails that batch's futures, never the "
                 "collector)",
    "accept": "both HTTP fronts, per accepted connection (an error "
              "drops the connection before any read)",
    "swap_cutover": "service/swap.swap_artifact, after the fresh mmap "
                    "loads but before the engine reference rebinds (an "
                    "error aborts the swap; the old tables keep "
                    "serving)",
}


class FaultInjected(RuntimeError):
    """Raised at a seam by a point:error rule. A RuntimeError (not a
    service-specific type) on purpose: the recovery machinery under
    test must handle it through its generic failure paths, exactly
    like a real device/queue error."""


class _Rule:
    """One parsed LDT_FAULTS rule; mutable schedule state (calls,
    done, rng) is owned by the module _lock."""

    __slots__ = ("action", "delay_ms", "p", "rng", "seed", "once",
                 "after", "calls", "done")

    def __init__(self, action: str, delay_ms: float, p: float,
                 seed: int, once: bool, after: int):
        self.action = action        # "error" | "delay" | "corrupt"
        self.delay_ms = delay_ms
        self.p = p
        self.rng = random.Random(seed)
        self.seed = seed            # corrupt rules derive flip seeds
        self.once = once
        self.after = after
        self.calls = 0
        self.done = False


# None = injection disabled (the common case, and the whole fast-path
# check); {point: [_Rule, ...]} when armed. Rebound atomically by
# configure(), never mutated in place.
ACTIVE: dict | None = None

# serializes schedule state (call counters, rng draws, once latches)
# across flush workers / handler threads hitting seams concurrently
_lock = make_lock("faults.schedule")


def _parse(spec: str) -> dict:
    rules: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"LDT_FAULTS rule {part!r}: want "
                f"point:action[:p=][:seed=][:once][:after=]")
        point = fields[0].strip()
        if point not in FAULT_POINTS:
            raise ValueError(
                f"LDT_FAULTS: unknown fault point {point!r}; declared "
                f"points: {', '.join(sorted(FAULT_POINTS))}")
        action = fields[1].strip()
        delay_ms = 0.0
        if action in ("error", "corrupt"):
            kind = action
        elif action.startswith("delay_ms="):
            kind = "delay"
            delay_ms = float(action[len("delay_ms="):])
        else:
            raise ValueError(
                f"LDT_FAULTS rule {part!r}: action must be 'error', "
                f"'corrupt' or 'delay_ms=<float>', got {action!r}")
        p, seed, once, after = 1.0, 0, False, 0
        for opt in fields[2:]:
            opt = opt.strip()
            if opt == "once":
                once = True
            elif opt.startswith("p="):
                p = float(opt[2:])
            elif opt.startswith("seed="):
                seed = int(opt[5:])
            elif opt.startswith("after="):
                after = int(opt[6:])
            else:
                raise ValueError(
                    f"LDT_FAULTS rule {part!r}: unknown option {opt!r}")
        rules.setdefault(point, []).append(
            _Rule(kind, delay_ms, p, seed, once, after))
    return rules


def configure(spec: str | None) -> None:
    """Arm injection from a spec string, or disarm with None/blank.
    Tests drive this directly; the import-time call below arms from
    the LDT_FAULTS env knob so a supervised worker picks its chaos
    profile up at spawn."""
    global ACTIVE
    ACTIVE = _parse(spec) if spec else None


def evaluate(point: str) -> tuple:
    """Advance every rule targeting `point` by one arrival and return
    (delay_sec, inject_error). Callers on an event loop use this
    directly (await the sleep themselves); sync seams use hit().
    An undeclared point is a programming error: KeyError, exactly like
    an undeclared knob."""
    if point not in FAULT_POINTS:
        raise KeyError(f"undeclared fault point {point!r}; declare it "
                       "in language_detector_tpu_torch/faults.py")
    active = ACTIVE
    if active is None:
        return 0.0, False
    rules = active.get(point)
    if not rules:
        return 0.0, False
    delay = 0.0
    err = False
    fired = 0
    with _lock:
        for r in rules:
            if r.action == "corrupt":
                # corruption() owns these schedules: an error/delay
                # seam must not consume a corrupt rule's arrivals
                continue
            r.calls += 1
            if r.done or r.calls <= r.after:
                continue
            if r.p < 1.0 and r.rng.random() >= r.p:
                continue
            if r.once:
                r.done = True
            if r.action == "error":
                err = True
            else:
                delay += r.delay_ms / 1e3
            fired += 1
    if fired:
        telemetry.REGISTRY.counter_inc("ldt_fault_injected_total",
                                       fired, point=point)
        from . import flightrec
        flightrec.emit_event("fault_fired", point=point, fired=fired,
                             action="error" if err else "delay")
    return delay, err


def corruption(point: str) -> int | None:
    """Advance every `corrupt` rule targeting `point` by one arrival.
    Returns a deterministic flip seed when one fires (derived from the
    rule's seed and arrival index, so a chaos run corrupts the same
    bit every time), or None. Non-corrupt rules at the same point are
    untouched — evaluate() owns their schedules. The caller passes the
    seed to corrupt_buffer() against its named buffer."""
    if point not in FAULT_POINTS:
        raise KeyError(f"undeclared fault point {point!r}; declare it "
                       "in language_detector_tpu_torch/faults.py")
    active = ACTIVE
    if active is None:
        return None
    rules = active.get(point)
    if not rules:
        return None
    flip_seed = None
    with _lock:
        for r in rules:
            if r.action != "corrupt":
                continue
            r.calls += 1
            if r.done or r.calls <= r.after:
                continue
            if r.p < 1.0 and r.rng.random() >= r.p:
                continue
            if r.once:
                r.done = True
            flip_seed = r.seed + r.calls - 1
            break
    if flip_seed is not None:
        telemetry.REGISTRY.counter_inc("ldt_fault_injected_total",
                                       point=point)
        from . import flightrec
        flightrec.emit_event("fault_fired", point=point, fired=1,
                             action="corrupt")
    return flip_seed


def corrupt_buffer(arr, seed: int):
    """Deterministic single-bit flip: copy `arr`, flip one bit chosen
    by random.Random(seed) over the flat byte view, return the copy
    (same dtype/shape). The input is never mutated — artifact views
    are read-only mmaps and device tables re-upload from it."""
    import numpy as np
    a = np.asarray(arr)
    raw = bytearray(a.tobytes())
    if raw:
        rng = random.Random(seed)
        byte = rng.randrange(len(raw))
        raw[byte] ^= 1 << rng.randrange(8)
    return np.frombuffer(bytes(raw), dtype=a.dtype).reshape(a.shape)


def hit(point: str) -> None:
    """Synchronous seam entry: sleep any injected delay, raise
    FaultInjected if an error rule fired. Seams guard the call with
    `if faults.ACTIVE is not None:` so the disabled path is a single
    attribute check."""
    delay, err = evaluate(point)
    if delay > 0:
        time.sleep(delay)
    if err:
        raise FaultInjected(f"injected fault at {point!r} (LDT_FAULTS)")


async def hit_async(point: str) -> None:
    """Event-loop seam entry: same contract as hit(), but the delay is
    an asyncio sleep so an injected slowdown never blocks the loop."""
    delay, err = evaluate(point)
    if delay > 0:
        import asyncio
        await asyncio.sleep(delay)
    if err:
        raise FaultInjected(f"injected fault at {point!r} (LDT_FAULTS)")


# arm from the environment at import: a worker spawned with LDT_FAULTS
# set (the CI chaos smoke, an operator's game day) needs no extra
# wiring, and a bad spec fails startup loudly
configure(knobs.get_str("LDT_FAULTS"))
