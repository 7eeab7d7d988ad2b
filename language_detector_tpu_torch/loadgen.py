"""Seeded synthetic load model for replay benchmarking and autotuning.

The port's copy of language_detector_tpu/loadgen.py, over the port's
capture.tenant_hash: the same call returns the same records, and the
same json.dumps bytes, as the reference's.

The capture plane (capture.py) replays REAL traffic on its recorded
schedule; this module fabricates the traffic shapes an operator needs to
probe overload behaviour but rarely has a capture of: flash crowds (a
step x10 arrival-rate surge), diurnal ramps, burst/lull alternation,
and a tenant-skew shift where the zipf-hot tenant rotates mid-run.
Every scenario emits records in the capture.merge_captures() dict
shape, so a replay loop (chip_smoke.py's `replay_lap`) drives
them like a capture and the SLO autotuner (autotune.py) can search knob
settings against them.

Determinism contract (tests/test_torch_loadgen.py):

  - generate(scenario, seed=s, ...) is a pure function of its
    arguments — the same call returns a byte-identical schedule
    (reproducible benchmarks, resumable autotune searches);
  - distinct seeds jitter WHICH arrivals land where and what each
    request carries, but conserve the rate envelope: the arrival
    count, total span, and per-interval arrival counts match across
    seeds, because arrivals are inverse-CDF stratified samples of the
    scenario's intensity profile (arrival i lands at
    t_i = L^-1((i + u_i) / n) with u_i the only seeded freedom), not
    free-running exponential draws.
"""
from __future__ import annotations

import math
import random

from . import capture as _capture

# intensity profiles are tabulated on this many grid points; the
# cumulative inverse is linear-interpolated between them
_GRID = 4096

# flash crowd: the step surge multiplies the baseline arrival rate by
# this factor between CROWD_START and CROWD_END (fractions of the span)
FLASH_FACTOR = 10.0
CROWD_START = 0.4
CROWD_END = 0.7


def _flash_crowd(x: float) -> float:
    return FLASH_FACTOR if CROWD_START <= x < CROWD_END else 1.0


def _diurnal(x: float) -> float:
    # one full day compressed into the span: smooth ramp up to a
    # midday peak and back down, never fully idle
    return 1.0 + 0.8 * math.sin(2.0 * math.pi * (x - 0.25))


def _burst_lull(x: float) -> float:
    # square wave, five cycles per span, mean 1.0: the shape that
    # defeats naive rate averaging
    return 1.6 if (x * 10.0) % 2.0 < 1.0 else 0.4


def _flat(x: float) -> float:
    return 1.0


# name -> (intensity fn over [0,1), tenant-shift phases, doc)
SCENARIOS = {
    "flash_crowd": (_flash_crowd, 1, "step x10 arrival-rate surge "
                                     "over the middle of the span"),
    "diurnal": (_diurnal, 1, "sinusoidal ramp to a midday peak"),
    "burst_lull": (_burst_lull, 1, "alternating x1.6 bursts and x0.4 "
                                   "lulls, mean-conserving"),
    "tenant_shift": (_flat, 3, "flat rate; the zipf-hot tenant "
                               "rotates at each third of the span"),
}


def scenario_names() -> tuple:
    return tuple(sorted(SCENARIOS))


def _cumulative(intensity) -> list:
    """Tabulated cumulative intensity L(x) on the unit span,
    normalized so L(1) == 1 — the inverse maps uniform stratified
    samples onto the scenario's arrival envelope."""
    acc = 0.0
    cum = [0.0]
    for i in range(_GRID):
        acc += max(intensity((i + 0.5) / _GRID), 0.0) / _GRID
        cum.append(acc)
    total = cum[-1] or 1.0
    return [c / total for c in cum]


def _inverse(cum: list, u: float) -> float:
    """L^-1(u) by bisection + linear interpolation on the table."""
    lo, hi = 0, len(cum) - 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if cum[mid] <= u:
            lo = mid
        else:
            hi = mid
    span = cum[hi] - cum[lo]
    frac = (u - cum[lo]) / span if span > 0 else 0.0
    return (lo + frac) / (len(cum) - 1)


def _zipf_cdf(tenants: int) -> list:
    weights = [1.0 / r for r in range(1, tenants + 1)]
    total = sum(weights)
    cdf = []
    acc = 0.0
    for w in weights:
        acc += w / total
        cdf.append(acc)
    return cdf


def mean_intensity(scenario: str) -> float:
    """Span-mean of the scenario's intensity profile (flash_crowd
    > 1: the surge adds real load, it does not steal from the
    baseline)."""
    intensity, _phases, _doc = SCENARIOS[scenario]
    return sum(max(intensity((i + 0.5) / _GRID), 0.0)
               for i in range(_GRID)) / _GRID


def generate(scenario: str, n: int = 2000, tenants: int = 32,
             base_rps: float = 200.0, seed: int = 1234) -> list:
    """`n` capture-shaped records following `scenario`'s arrival
    envelope. `base_rps` is the BASELINE arrival rate (intensity 1.0);
    the span stretches so intensity-x regions really arrive at
    x * base_rps."""
    if scenario not in SCENARIOS:
        raise KeyError(f"unknown scenario {scenario!r} "
                       f"(have: {', '.join(scenario_names())})")
    intensity, phases, _doc = SCENARIOS[scenario]
    # string seeds hash via sha512 (deterministic across processes —
    # tuple seeds would go through the salted hash() and break the
    # byte-identical contract)
    rng = random.Random(f"{seed}:{scenario}:{n}:{tenants}")
    cum = _cumulative(intensity)
    # span such that the average arrival rate is mean(intensity) *
    # base_rps — i.e. intensity 1.0 regions run at exactly base_rps
    span_sec = n / (base_rps * mean_intensity(scenario))
    zipf = _zipf_cdf(tenants)
    out = []
    for i in range(n):
        # stratified inverse-CDF arrival: the seed only jitters WITHIN
        # stratum i, so every seed lands exactly one arrival per
        # stratum — rate conservation by construction
        u = (i + rng.random()) / n
        x = _inverse(cum, u)
        # tenant-shift scenarios re-rank the zipf order per phase:
        # the hot tenant is a different one in each third of the span
        phase = min(int(x * phases), phases - 1)
        uz = rng.random()
        rank = next(r for r, edge in enumerate(zipf) if uz <= edge)
        tenant = f"tenant-{(rank + phase * 7) % tenants:02d}"
        out.append({
            "arrival_ns": int(x * span_sec * 1e9),
            "tenant": tenant,
            "tenant_hash": _capture.tenant_hash(tenant),
            "docs": 1 + rng.randrange(8),
            "size_bucket": 8 + rng.randrange(4),
            "approx_bytes": 1 << (7 + rng.randrange(4)),
            "deadline_ms": 0.0,
            "priority": rng.random() < 0.10,
            "verdict": "ok",
        })
    return out


def interval_counts(records: list, buckets: int = 10) -> list:
    """Arrival count per equal time slice of the schedule's span —
    the rate envelope two seeds of the same scenario must share."""
    if not records:
        return [0] * buckets
    span = max(r["arrival_ns"] for r in records) + 1
    counts = [0] * buckets
    for r in records:
        counts[min(int(r["arrival_ns"] * buckets / span),
                   buckets - 1)] += 1
    return counts
