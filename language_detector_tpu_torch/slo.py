"""Per-tenant SLO engine: rolling SLI windows and error-budget burn
rates over the traffic both fronts already measure.

The histograms in telemetry.py say what latency the process HAS served
since boot; they cannot say whether the fleet is MEETING a target right
now, per tenant, or how fast a declared error budget is burning. This
module turns declared targets (the LDT_SLO spec string, e.g.
``p99_ms=50,err_pct=0.5,window_sec=300``) into:

  - rolling SLI windows — per tenant and fleet-wide — computing the
    windowed latency percentile and error ratio. Each window is a
    time-bucketed ring (`_WindowRing`): a fixed number of coarse time
    buckets, each holding log-scaled latency bucket counts, so one
    request costs one bisect plus a handful of integer adds (O(1),
    no per-request allocation) and expiry is bucket reuse, never a
    scan over stored events;
  - multi-window error-budget burn rates: the spec's window is the
    FAST window, the slow window is 12x it — the default 300 s gives
    the canonical fast-5m/slow-1h pair. burn = (bad fraction in
    window) / (err_pct/100); burn 1.0 means the budget burns exactly
    as fast as it accrues;
  - a breach/recover alert state machine: the alert fires when BOTH
    windows burn at >= 1.0 (a blip cannot page, and a long-stale slow
    window alone cannot either) with at least LDT_SLO_MIN_EVENTS fast-
    window events, and clears when the fast burn drops below 1.0.
    Transitions emit the `slo_breach`/`slo_recovered` flight-recorder
    events and count ldt_slo_breaches_total.

A request is "bad" (burns budget) when it answered 5xx or exceeded the
latency target; sheds (429/503 from admission) are tracked as their own
SLI but deliberately do not burn the budget — overload protection
working as designed is not an SLO violation of the service.

Wired through telemetry.finish_request — the single authoritative
completion path — so the SLO engine, the capture plane, and the
request histogram can never disagree on a request's outcome. Exposed
as the /sloz JSON endpoint on both fronts' metrics ports, merged onto
the fleet's /fleetz, and rendered as ldt_slo_* gauges on /metrics.

Enabled by LDT_SLO (unset = every observe is one attribute check, the
faults.ACTIVE cost contract). The clock is injectable so the alert
state machine is testable against a fake clock.
"""
from __future__ import annotations

import logging
import re
import time
from bisect import bisect_left
from dataclasses import dataclass

from . import knobs
from .locks import make_lock
from .telemetry import BUCKET_EDGES_MS

_log = logging.getLogger(__name__)

# slow window = SLOW_FACTOR x the spec window: window_sec=300 gives the
# canonical fast-5m / slow-1h burn-rate pair
SLOW_FACTOR = 12
# time buckets per window ring: expiry granularity is window/20
RING_BUCKETS = 20
# burn rate at which the alert engages/clears (budget burning exactly
# as fast as it accrues)
BREACH_BURN = 1.0
# per-tenant window cap: past it new tenants aggregate into "~other"
# so a tenant-id flood cannot grow memory unboundedly
MAX_TENANTS = 64
OVERFLOW_TENANT = "~other"

_SPEC_KEY = re.compile(r"^p(\d{1,2}(?:\.\d+)?)_ms$")


@dataclass(frozen=True)
class SloSpec:
    """Parsed LDT_SLO declaration."""

    percentile: float = 99.0     # which latency percentile is targeted
    target_ms: float | None = None   # latency target (None: error-only)
    err_pct: float = 1.0         # error budget as percent of requests
    window_sec: float = 300.0    # FAST window span (slow = 12x)

    def as_dict(self) -> dict:
        return {"percentile": self.percentile,
                "target_ms": self.target_ms,
                "err_pct": self.err_pct,
                "window_sec": self.window_sec,
                "slow_window_sec": self.window_sec * SLOW_FACTOR}


def parse_spec(text: str | None) -> SloSpec | None:
    """Parse an LDT_SLO spec string (``p99_ms=50,err_pct=0.5,
    window_sec=300``) into an SloSpec. None/blank disables the engine;
    a malformed entry logs a loud warning and is skipped (same
    semantics as a mistyped knob); a spec with no valid entry at all
    disables the engine rather than silently enforcing defaults the
    operator never declared."""
    if not text or not text.strip():
        return None
    percentile = 99.0
    target_ms: float | None = None
    err_pct: float | None = None
    window_sec = 300.0
    valid = 0
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, val = part.partition("=")
        if not sep:
            _log.warning("LDT_SLO entry %r is not key=value — skipped",
                         part)
            continue
        key = key.strip()
        try:
            num = float(val)
        except ValueError:
            _log.warning("LDT_SLO %s=%r is not a number — skipped",
                         key, val)
            continue
        m = _SPEC_KEY.match(key)
        if m:
            percentile = float(m.group(1))
            target_ms = num
            valid += 1
        elif key == "err_pct":
            err_pct = num
            valid += 1
        elif key == "window_sec":
            if num <= 0:
                _log.warning("LDT_SLO window_sec=%r must be positive "
                             "— keeping %gs", val, window_sec)
            else:
                window_sec = num
                valid += 1
        else:
            _log.warning("LDT_SLO key %r is not pNN_ms/err_pct/"
                         "window_sec — skipped", key)
    if not valid:
        _log.warning("LDT_SLO=%r declared no valid target — SLO "
                     "engine stays off", text)
        return None
    return SloSpec(percentile=percentile, target_ms=target_ms,
                   err_pct=err_pct if err_pct is not None else 1.0,
                   window_sec=window_sec)


class _WindowRing:
    """One rolling SLI window: RING_BUCKETS coarse time buckets, each
    holding log-scaled latency bucket counts plus total/bad/shed
    tallies. observe() is O(1): locate the time bucket by epoch
    (reusing it wholesale when its epoch is stale — that IS the
    expiry), bisect the latency into BUCKET_EDGES_MS, bump integers.
    Mutation happens under the owning engine's lock (single writer
    discipline, like Trace spans under the GIL)."""

    __slots__ = ("span", "bucket_sec", "epochs", "lat", "total",
                 "bad", "shed", "sums")

    def __init__(self, window_sec: float):
        self.span = float(window_sec)
        self.bucket_sec = self.span / RING_BUCKETS
        self.epochs = [-1] * RING_BUCKETS
        self.lat = [[0] * (len(BUCKET_EDGES_MS) + 1)
                    for _ in range(RING_BUCKETS)]
        self.total = [0] * RING_BUCKETS
        self.bad = [0] * RING_BUCKETS
        self.shed = [0] * RING_BUCKETS
        self.sums = [0.0] * RING_BUCKETS

    def _slot(self, now: float) -> int:
        ep = int(now / self.bucket_sec)
        i = ep % RING_BUCKETS
        if self.epochs[i] != ep:
            self.epochs[i] = ep
            self.lat[i] = [0] * (len(BUCKET_EDGES_MS) + 1)
            self.total[i] = 0
            self.bad[i] = 0
            self.shed[i] = 0
            self.sums[i] = 0.0
        return i

    def observe(self, now: float, latency_ms: float, bad: bool,
                shed: bool) -> None:
        i = self._slot(now)
        self.total[i] += 1
        self.sums[i] += latency_ms
        self.lat[i][bisect_left(BUCKET_EDGES_MS, latency_ms)] += 1
        if bad:
            self.bad[i] += 1
        if shed:
            self.shed[i] += 1

    def _live(self, now: float) -> list:
        floor = int(now / self.bucket_sec) - RING_BUCKETS + 1
        return [i for i in range(RING_BUCKETS)
                if self.epochs[i] >= floor]

    def counts(self, now: float) -> tuple:
        """(total, bad, shed) over the in-window buckets — the cheap
        scan the per-request alert evaluation runs (2xRING_BUCKETS
        integer reads, no latency-bucket merge)."""
        live = self._live(now)
        return (sum(self.total[i] for i in live),
                sum(self.bad[i] for i in live),
                sum(self.shed[i] for i in live))

    def snapshot(self, now: float) -> dict:
        """Full windowed SLIs: count/bad/shed/err_ratio, mean, and the
        p50 + declared-percentile latency estimates (merged latency
        buckets, interpolated like telemetry.Histogram)."""
        live = self._live(now)
        merged = [0] * (len(BUCKET_EDGES_MS) + 1)
        for i in live:
            row = self.lat[i]
            for j, c in enumerate(row):
                if c:
                    merged[j] += c
        total = sum(self.total[i] for i in live)
        bad = sum(self.bad[i] for i in live)
        shed = sum(self.shed[i] for i in live)
        lat_sum = sum(self.sums[i] for i in live)
        return {"count": total, "bad": bad, "shed": shed,
                "err_ratio": round(bad / total, 6) if total else 0.0,
                "mean_ms": round(lat_sum / total, 3) if total else 0.0,
                "_merged": merged}


def _bucket_percentile(merged: list, q: float) -> float | None:
    """q-th percentile from merged latency bucket counts by linear
    interpolation inside the holding bucket (the +Inf bucket answers
    its lower edge: the window keeps no max)."""
    total = sum(merged)
    if total == 0:
        return None
    target = total * q / 100.0
    cum = 0
    lo = 0.0
    for i, c in enumerate(merged):
        cum += c
        if cum >= target and c > 0:
            if i >= len(BUCKET_EDGES_MS):
                return BUCKET_EDGES_MS[-1]
            hi = BUCKET_EDGES_MS[i]
            frac = (target - (cum - c)) / c
            return lo + (hi - lo) * frac
        if i < len(BUCKET_EDGES_MS):
            lo = BUCKET_EDGES_MS[i]
    return lo


class SloEngine:
    """Declared targets + per-tenant and fleet-wide window pairs + the
    burn-rate alert state machine. `clock` is injectable (monotonic
    seconds) so window expiry and alert transitions run against a fake
    clock in tests."""

    def __init__(self, spec: SloSpec, clock=time.monotonic,
                 min_events: int | None = None):
        self.spec = spec
        self.clock = clock
        if min_events is None:
            min_events = knobs.get_int("LDT_SLO_MIN_EVENTS") or 4
        self.min_events = max(int(min_events), 1)
        self._lock = make_lock("slo.engine")
        self._fleet = (_WindowRing(spec.window_sec),
                       _WindowRing(spec.window_sec * SLOW_FACTOR))
        self._tenants: dict = {}   # tenant -> (fast, slow) window pair
        self._alert = False
        self._alert_since: float | None = None
        self._breaches = 0
        self._observed = 0

    # -- per-request hot path -----------------------------------------------

    def observe(self, tenant: str | None, status, latency_ms: float,
                shed: bool = False) -> None:
        now = self.clock()
        spec = self.spec
        bad = (isinstance(status, int) and status >= 500) or (
            not shed and spec.target_ms is not None
            and latency_ms > spec.target_ms)
        tenant = str(tenant) if tenant else "default"
        with self._lock:
            self._observed += 1
            fast, slow = self._fleet
            fast.observe(now, latency_ms, bad, shed)
            slow.observe(now, latency_ms, bad, shed)
            pair = self._tenants.get(tenant)
            if pair is None:
                if len(self._tenants) >= MAX_TENANTS:
                    tenant = OVERFLOW_TENANT
                    pair = self._tenants.get(tenant)
                if pair is None:
                    pair = (_WindowRing(spec.window_sec),
                            _WindowRing(spec.window_sec * SLOW_FACTOR))
                    self._tenants[tenant] = pair
            pair[0].observe(now, latency_ms, bad, shed)
            pair[1].observe(now, latency_ms, bad, shed)
            transition = self._evaluate_locked(now)
        # registry counters and flight-recorder events are emitted
        # OUTSIDE the engine lock (their own locks; keep the order
        # graph edge-free, flightrec.emit discipline)
        from . import telemetry
        telemetry.REGISTRY.counter_inc(
            "ldt_slo_events_total",
            result="shed" if shed else ("bad" if bad else "good"))
        if transition is not None:
            self._announce(transition)

    # -- burn rates & alert state machine -----------------------------------

    def _burns_locked(self, now: float) -> tuple:
        budget = max(self.spec.err_pct, 1e-9) / 100.0
        fast, slow = self._fleet
        ft, fb, _ = fast.counts(now)
        st, sb, _ = slow.counts(now)
        burn_fast = (fb / ft) / budget if ft else 0.0
        burn_slow = (sb / st) / budget if st else 0.0
        return burn_fast, burn_slow, ft

    def _evaluate_locked(self, now: float) -> dict | None:
        """Run the alert state machine; returns the transition record
        to announce (outside the lock), or None."""
        burn_fast, burn_slow, fast_total = self._burns_locked(now)
        if not self._alert:
            if (fast_total >= self.min_events
                    and burn_fast >= BREACH_BURN
                    and burn_slow >= BREACH_BURN):
                self._alert = True
                self._alert_since = now
                self._breaches += 1
                return {"event": "slo_breach",
                        "burn_fast": round(burn_fast, 3),
                        "burn_slow": round(burn_slow, 3)}
        elif burn_fast < BREACH_BURN:
            since = self._alert_since
            self._alert = False
            self._alert_since = None
            return {"event": "slo_recovered",
                    "burn_fast": round(burn_fast, 3),
                    "breach_sec": round(now - since, 3)
                    if since is not None else None}
        return None

    def _announce(self, transition: dict) -> None:
        from . import flightrec, telemetry
        ev = transition.pop("event")
        if ev == "slo_breach":
            telemetry.REGISTRY.counter_inc("ldt_slo_breaches_total")
            flightrec.emit_event("slo_breach", **transition)
        else:
            flightrec.emit_event("slo_recovered", **transition)

    # -- views --------------------------------------------------------------

    def stats(self) -> dict:
        """Small numeric view for /metrics gauges and /debug/vars; runs
        the state machine too so recovery is visible without traffic."""
        now = self.clock()
        with self._lock:
            transition = self._evaluate_locked(now)
            burn_fast, burn_slow, _ = self._burns_locked(now)
            st, sb, _ = self._fleet[1].counts(now)
            alert = self._alert
            breaches = self._breaches
            observed = self._observed
            tenants = len(self._tenants)
        if transition is not None:
            self._announce(transition)
        budget = max(self.spec.err_pct, 1e-9) / 100.0
        remaining = 1.0 - ((sb / st) / budget if st else 0.0)
        return {"alert": 1 if alert else 0,
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "budget_remaining": round(min(max(remaining, 0.0),
                                              1.0), 4),
                "breaches_total": breaches,
                "observed": observed,
                "tenants": tenants}

    def _window_view(self, pair: tuple, now: float) -> dict:
        budget = max(self.spec.err_pct, 1e-9) / 100.0
        out = {}
        for label, ring in (("fast", pair[0]), ("slow", pair[1])):
            snap = ring.snapshot(now)
            merged = snap.pop("_merged")
            p50 = _bucket_percentile(merged, 50.0)
            pq = _bucket_percentile(merged, self.spec.percentile)
            snap["p50_ms"] = round(p50, 3) if p50 is not None else None
            snap[f"p{self.spec.percentile:g}_ms"] = \
                round(pq, 3) if pq is not None else None
            snap["burn_rate"] = round(
                (snap["bad"] / snap["count"]) / budget, 4) \
                if snap["count"] else 0.0
            snap["window_sec"] = ring.span
            out[label] = snap
        return out

    def snapshot(self) -> dict:
        """The /sloz document: spec, fleet-wide + per-tenant windowed
        SLIs, and the alert state."""
        now = self.clock()
        with self._lock:
            transition = self._evaluate_locked(now)
            fleet = self._window_view(self._fleet, now)
            tenants = {t: self._window_view(pair, now)
                       for t, pair in sorted(self._tenants.items())}
            alert = {"state": "breach" if self._alert else "ok",
                     "since_sec": round(now - self._alert_since, 3)
                     if self._alert_since is not None else None,
                     "breaches_total": self._breaches,
                     "min_events": self.min_events}
            observed = self._observed
        if transition is not None:
            self._announce(transition)
        return {"enabled": True, "spec": self.spec.as_dict(),
                "observed": observed, "fleet": fleet,
                "tenants": tenants, "alert": alert}


# Module-level engine: None = disabled (the fast-path check). Armed by
# init_from_env() at front startup; rebound atomically.
ENGINE: SloEngine | None = None


def init_from_env() -> SloEngine | None:
    """Arm the process SLO engine from LDT_SLO (unset/invalid = stay
    disabled). Called by both fronts' startup; idempotent."""
    global ENGINE
    if ENGINE is not None:
        return ENGINE
    spec = parse_spec(knobs.get_str("LDT_SLO"))
    if spec is None:
        return None
    ENGINE = SloEngine(spec)
    return ENGINE


def observe(trace, meta: dict | None, total_ms: float) -> None:
    """finish_request's SLO hook: one observation per completed
    request. No-op (one attribute check) when the engine is off."""
    eng = ENGINE
    if eng is None:
        return
    meta = meta or {}
    eng.observe(tenant=getattr(trace, "tenant", None),
                status=meta.get("status"), latency_ms=total_ms,
                shed=bool(meta.get("shed")))


def stats() -> dict | None:
    """Gauge source for /metrics and /debug/vars; None when off."""
    eng = ENGINE
    return eng.stats() if eng is not None else None


def sloz() -> dict:
    """The /sloz endpoint body (both fronts' metrics ports)."""
    eng = ENGINE
    if eng is None:
        return {"enabled": False,
                "hint": "set LDT_SLO=p99_ms=...,err_pct=...,"
                        "window_sec=... to declare targets"}
    return eng.snapshot()


def reset_for_tests() -> None:
    """Disarm the module engine (tests re-init with their own spec)."""
    global ENGINE
    ENGINE = None
