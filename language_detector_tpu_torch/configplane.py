"""Runtime config plane: guarded apply of mutable knobs with
SLO-watched probation and auto-rollback.

POST /configz on either front's metrics port stages a batch of mutable
knob overrides (validated against the knobs registry's type/bound/
mrange contract), applies it under a probation window, and watches the
SLO engine's fast-window burn rate: a burn >= 1.0 before the window
elapses auto-rolls the batch back to the prior overrides. Every edge
is journaled to the flight recorder (config_staged / config_applied /
config_committed / config_rolled_back) and counted in
ldt_config_applies_total, so a rollback is reconstructible after the
fact.

The plane is a declared state machine (tools/lint/fsm_registry.py
"config-plane") and its apply/crash interleavings are model-checked
(tools/lint/model_check.py "config-apply"):

    IDLE -> STAGED -> PROBATION -> COMMITTED
                 \\            \\-> ROLLED_BACK -> STAGED (next push)
                  \\-> IDLE (validation refused)

Probation progress is driven by tick(): the fronts call it from
telemetry.finish_request (per completed request) and from every GET
/configz (the fleet's canary poll), so a probation window expires even
on an idle member. The clock and the burn source are injectable for
the model checker — production uses time.monotonic and the SLO
engine's fast burn.
"""
from __future__ import annotations

import json
import logging
import time

from . import flightrec, knobs, telemetry
from .locks import make_lock

_log = logging.getLogger(__name__)

CONFIG_IDLE = 0
CONFIG_STAGED = 1
CONFIG_PROBATION = 2
CONFIG_COMMITTED = 3
CONFIG_ROLLED_BACK = 4

STATE_NAMES = {
    CONFIG_IDLE: "idle",
    CONFIG_STAGED: "staged",
    CONFIG_PROBATION: "probation",
    CONFIG_COMMITTED: "committed",
    CONFIG_ROLLED_BACK: "rolled_back",
}

# the auto-rollback trigger: fast-window error-budget burn at or past
# this during probation reverts the apply (1.0 = burning exactly the
# declared budget)
ROLLBACK_BURN = 1.0


def _slo_fast_burn() -> float | None:
    """Production burn source: the SLO engine's fast-window burn rate,
    None when the engine is off (probation then commits on time
    alone)."""
    from . import slo
    s = slo.stats()
    if s is None:
        return None
    return float(s.get("burn_fast", 0.0))


class ConfigPlane:
    """One process's config-apply state machine (thread-safe)."""

    def __init__(self, clock=time.monotonic, burn_source=_slo_fast_burn):
        self._lock = make_lock("configplane.plane")
        self.clock = clock
        self.burn_source = burn_source
        self.state = CONFIG_IDLE
        self.generation = 0            # last COMMITTED generation
        self.staged_generation = 0     # generation of the in-flight batch
        self.staged: dict | None = None
        self.staged_probation_sec = 0.0
        self.prior: dict | None = None  # raw override map pre-apply
        self.probation_deadline = 0.0
        self.peak_burn = 0.0
        self.last_error: str | None = None
        self.last_rollback: dict | None = None

    # -- guarded FSM writes (fsm_registry "config-plane") -------------

    def mark_staged(self) -> None:
        if self.state == CONFIG_IDLE:
            self.state = CONFIG_STAGED
        elif self.state == CONFIG_COMMITTED:
            self.state = CONFIG_STAGED
        elif self.state == CONFIG_ROLLED_BACK:
            self.state = CONFIG_STAGED

    def mark_idle(self) -> None:
        if self.state == CONFIG_STAGED:
            self.state = CONFIG_IDLE

    def mark_probation(self) -> None:
        if self.state == CONFIG_STAGED:
            self.state = CONFIG_PROBATION

    def mark_committed(self) -> None:
        if self.state == CONFIG_PROBATION:
            self.state = CONFIG_COMMITTED

    def mark_rolled_back(self) -> None:
        if self.state == CONFIG_PROBATION:
            self.state = CONFIG_ROLLED_BACK

    # -- apply path ---------------------------------------------------

    def push(self, updates: dict, probation_sec: float | None = None,
             generation: int | None = None) -> dict:
        """Stage + apply one override batch. Returns the post-apply
        snapshot; on refusal the snapshot carries an "error" key and
        nothing was applied. `generation` stamps an externally
        coordinated generation (the fleet fan-out); local pushes
        auto-increment. probation_sec <= 0 commits immediately (used to
        fan a canary-proven config out to the rest of the fleet)."""
        if probation_sec is None:
            probation_sec = knobs.get_float(
                "LDT_CONFIG_PROBATION_SEC") or 0.0
        with self._lock:
            if self.state == CONFIG_PROBATION:
                snap = self._snapshot_locked()
                snap["error"] = "a config probation is already in flight"
                return snap
            self.staged = dict(updates)
            self.staged_probation_sec = float(probation_sec)
            self.staged_generation = (int(generation) if generation
                                      is not None
                                      else self.generation + 1)
            self.mark_staged()
            flightrec.emit_event(
                "config_staged", generation=self.staged_generation,
                knobs=",".join(sorted(self.staged)))
            return self._apply_locked()

    def _apply_locked(self) -> dict:
        self.prior = knobs.current()["overrides"]
        try:
            knobs.apply_overrides(self.staged or {})
        except ValueError as e:
            self.last_error = str(e)
            telemetry.REGISTRY.counter_inc(
                "ldt_config_applies_total", result="refused")
            _log.warning("configz: apply refused — %s", e)
            self.mark_idle()
            snap = self._snapshot_locked()
            snap["error"] = self.last_error
            return snap
        self.last_error = None
        self.peak_burn = 0.0
        self.probation_deadline = (self.clock()
                                   + self.staged_probation_sec)
        self.mark_probation()
        telemetry.REGISTRY.counter_inc(
            "ldt_config_applies_total", result="applied")
        flightrec.emit_event(
            "config_applied", generation=self.staged_generation,
            probation_sec=self.staged_probation_sec)
        if self.staged_probation_sec <= 0:
            self._commit_locked()
        return self._snapshot_locked()

    def tick(self, now: float | None = None) -> None:
        """Advance a probation: roll back on burn, commit on time.
        Called per completed request and per GET /configz — cheap when
        nothing is in probation."""
        with self._lock:
            if self.state != CONFIG_PROBATION:
                return
            burn = None
            try:
                burn = self.burn_source()
            except Exception:  # a sick burn source must not wedge
                pass           # probation: the window still times out
            if burn is not None and burn > self.peak_burn:
                self.peak_burn = burn
            if burn is not None and burn >= ROLLBACK_BURN:
                self._rollback_locked(
                    f"slo fast burn {burn:.2f} >= {ROLLBACK_BURN:g} "
                    f"during probation")
                return
            if (now if now is not None else self.clock()) \
                    >= self.probation_deadline:
                self._commit_locked()

    def _commit_locked(self) -> None:
        self.mark_committed()
        self.generation = self.staged_generation
        telemetry.REGISTRY.counter_inc(
            "ldt_config_applies_total", result="committed")
        flightrec.emit_event("config_committed",
                             generation=self.generation)
        _log.info("configz: generation %d committed", self.generation)
        self.staged = None
        self.prior = None

    def _rollback_locked(self, reason: str) -> None:
        knobs.clear_overrides()
        if self.prior:
            # the prior overrides were live, so they re-validate
            knobs.apply_overrides(self.prior)
        self.last_rollback = {
            "generation": self.staged_generation,
            "reason": reason,
            "peak_burn": round(self.peak_burn, 4),
            "values": dict(self.staged or {}),
        }
        self.mark_rolled_back()
        telemetry.REGISTRY.counter_inc(
            "ldt_config_applies_total", result="rolled_back")
        flightrec.emit_event(
            "config_rolled_back", generation=self.staged_generation,
            reason=reason)
        _log.warning("configz: generation %d rolled back — %s",
                     self.staged_generation, reason)
        self.staged = None
        self.prior = None

    # -- observability ------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        cur = knobs.current()
        remaining = 0.0
        if self.state == CONFIG_PROBATION:
            remaining = max(0.0, self.probation_deadline - self.clock())
        return {
            "state": STATE_NAMES.get(self.state, "?"),
            "generation": self.generation,
            "staged_generation": self.staged_generation,
            "override_version": cur["version"],
            "values": cur["values"],
            "overrides": cur["overrides"],
            "probation_remaining_sec": round(remaining, 3),
            "peak_burn": round(self.peak_burn, 4),
            "last_error": self.last_error,
            "last_rollback": self.last_rollback,
        }


# -- process singleton + front-facing helpers -------------------------

PLANE: ConfigPlane | None = None
_MODULE_LOCK = make_lock("configplane.module")


def get_plane() -> ConfigPlane:
    global PLANE
    p = PLANE
    if p is None:
        with _MODULE_LOCK:
            if PLANE is None:
                PLANE = ConfigPlane()
            p = PLANE
    return p


def maybe_tick() -> None:
    """Hot-path probation tick: one module-attribute check when no
    plane exists (no POST /configz ever landed)."""
    p = PLANE
    if p is not None:
        p.tick()


def stats() -> dict | None:
    """Config section for /debug/vars and the gauge renderers; None
    until the plane exists (gauges then render generation 0)."""
    p = PLANE
    return p.snapshot() if p is not None else None


def handle_get() -> dict:
    """GET /configz body (also drives probation forward — the fleet's
    canary poll rides this)."""
    p = get_plane()
    p.tick()
    return p.snapshot()


def handle_post(body: bytes) -> tuple[int, dict]:
    """POST /configz: {"set": {knob: value|null}, "probation_sec": s?,
    "generation": g?} -> (http status, response dict). Shared by both
    fronts so apply semantics cannot drift."""
    try:
        req = json.loads(body or b"{}")
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        updates = req.get("set")
        if not isinstance(updates, dict) or not updates:
            raise ValueError('body must carry a non-empty "set" object')
        probation = req.get("probation_sec")
        if probation is not None:
            probation = float(probation)
        generation = req.get("generation")
        if generation is not None:
            generation = int(generation)
    except (ValueError, json.JSONDecodeError) as e:
        return 400, {"error": f"bad /configz request: {e}"}
    snap = get_plane().push(updates, probation_sec=probation,
                            generation=generation)
    if "error" in snap:
        status = 409 if "in flight" in snap["error"] else 400
        return status, snap
    return 200, snap


def reset_for_tests() -> None:
    global PLANE
    PLANE = None
    knobs.clear_overrides()
