"""SLO-driven autotuner over the declared mutable-knob space.

The port's copy of language_detector_tpu/autotune.py, over the port's
knobs.mutable_knobs, slo and telemetry: for the same `evaluate` it
walks the same candidates in the same order and returns the same
result.

The runtime config plane (configplane.py) makes a declared subset of
knobs settable at runtime; this module SEARCHES that space. Given an
``evaluate`` callback that runs one candidate override batch against
replayed or synthetic traffic (chip_smoke.py's autotune phase wires
the real thing: push the batch through the fleet's POST /configz,
replay a loadgen scenario, read back the SLIs), coordinate descent
walks one knob at a time through multiplier moves clamped to the
registry's declared mrange — plus "off" for bound-style knobs and a
geometric seed ladder for knobs starting unset — keeping a move only
when it scores better.

Scoring is feasibility-first against the declared LDT_SLO targets: a
candidate that violates the latency or error-budget target pays a
penalty proportional to the overshoot that dwarfs any throughput win,
so the search first finds the feasible region and only then maximizes
the docs/sec cost proxy inside it. The score is deliberately the same
shape the SLO engine alerts on — what the autotuner optimizes is what
the burn-rate alert measures.

Offline by construction: everything here is pure policy driven
through the injectable ``evaluate``; tests search synthetic response
surfaces with zero servers. The only side effects are the
ldt_autotune_* counters.
"""
from __future__ import annotations

import logging

from . import knobs as _knobs
from . import slo as _slo
from . import telemetry

_log = logging.getLogger(__name__)

# score penalty per unit of relative SLO overshoot: must dwarf any
# achievable docs/sec so feasibility always dominates throughput
PENALTY = 1e6

# multiplier moves for a knob that currently holds a value
MOVES = (0.25, 0.5, 2.0, 4.0)

# rungs of the geometric seed ladder for a knob starting unset/off
SEED_RUNGS = 4


def knob_space(names=None) -> list:
    """The searchable surface: (name, lo, hi, is_bound) per declared
    mutable scalar knob, optionally restricted to `names`."""
    out = []
    for k in _knobs.mutable_knobs():
        if k.ktype not in ("int", "float") or k.mrange is None:
            continue
        if names is not None and k.name not in names:
            continue
        lo, hi = k.mrange
        out.append((k.name, float(lo), float(hi), k.bound))
    return out


def _clamp(knob_name: str, v: float, lo: float, hi: float):
    v = min(max(v, lo), hi)
    if _knobs.KNOBS[knob_name].ktype == "int":
        return int(round(v))
    return v


def candidates(name: str, current, lo: float, hi: float,
               is_bound: bool) -> list:
    """Candidate values for one knob: multiplier moves around a live
    value, a geometric ladder across the range for an unset one, and
    None ("off") for bound-style knobs where non-positive means
    disabled."""
    cands: list = []
    if current is None:
        # seed the search across the declared range geometrically
        for i in range(1, SEED_RUNGS + 1):
            frac = i / (SEED_RUNGS + 1)
            v = _clamp(name, lo * (hi / max(lo, 1e-9)) ** frac, lo, hi)
            if v not in cands:
                cands.append(v)
    else:
        for m in MOVES:
            v = _clamp(name, float(current) * m, lo, hi)
            if v != current and v not in cands:
                cands.append(v)
        if is_bound:
            cands.append(None)  # try turning the bound off
    return cands


def score(metrics: dict, spec) -> float:
    """Feasibility-first scalar score for one evaluated candidate.

    `metrics` carries the replay SLIs: p99_ms, err_pct and the
    docs/sec cost proxy ok_docs_per_sec. `spec` is the parsed LDT_SLO
    declaration (slo.parse_spec); None scores throughput only."""
    s = float(metrics.get("ok_docs_per_sec", 0.0))
    if spec is None:
        return s
    target = spec.target_ms
    if target is not None and target > 0:
        p99 = float(metrics.get("p99_ms", 0.0))
        if p99 > target:
            s -= PENALTY * (p99 / target - 1.0 + 1.0)
    budget = spec.err_pct
    if budget is not None and budget > 0:
        err = float(metrics.get("err_pct", 0.0))
        if err > budget:
            s -= PENALTY * (err / budget - 1.0 + 1.0)
    return s


def autotune(evaluate, names=None, rounds: int = 2,
             spec=None) -> dict:
    """Coordinate descent over the mutable-knob space.

    evaluate(overrides: dict) -> metrics dict (p99_ms, err_pct,
    ok_docs_per_sec, ...). Starts from the current effective values
    (env + any live overrides), walks each knob's candidates in
    declaration order, keeps improvements, and stops early when a
    full round changes nothing. Returns the winning override batch
    with its metrics, plus the baseline's."""
    if spec is None:
        spec = _slo.parse_spec(_knobs.get_str("LDT_SLO"))
    space = knob_space(names)
    current = {name: _knobs.value(name) for name, *_rest in space}
    overrides: dict = {}
    cache: dict = {}

    def run(ov: dict) -> dict:
        key = tuple(sorted((k, v) for k, v in ov.items()
                           if v is not None))
        if key not in cache:
            telemetry.REGISTRY.counter_inc("ldt_autotune_evals_total",
                                           1)
            cache[key] = evaluate(dict(ov))
        return cache[key]

    baseline = run(overrides)
    best_score = score(baseline, spec)
    best_metrics = baseline
    _log.info("autotune: baseline score %.2f (%s)", best_score,
              baseline)
    for rnd in range(rounds):
        telemetry.REGISTRY.counter_inc("ldt_autotune_rounds_total", 1)
        improved = False
        for name, lo, hi, is_bound in space:
            held = overrides.get(name, current[name])
            for cand in candidates(name, held, lo, hi, is_bound):
                trial = dict(overrides)
                if cand is None:
                    trial.pop(name, None)
                else:
                    trial[name] = cand
                m = run(trial)
                sc = score(m, spec)
                if sc > best_score:
                    best_score = sc
                    best_metrics = m
                    overrides = trial
                    improved = True
                    _log.info("autotune: %s=%s scores %.2f", name,
                              cand, sc)
        if not improved:
            break
    return {
        "best": {k: v for k, v in sorted(overrides.items())},
        "best_score": round(best_score, 4),
        "best_metrics": best_metrics,
        "baseline_metrics": baseline,
        "baseline_score": round(score(baseline, spec), 4),
        "evals": len(cache),
        "spec": spec.as_dict() if spec is not None else None,
    }
