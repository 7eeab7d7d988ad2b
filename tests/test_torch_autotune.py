"""The port's SLO autotuner (language_detector_tpu_torch/autotune.py) on
synthetic response surfaces — no servers, no replay: `evaluate` is
injected. tests/test_autotune.py's cases run on the port, and the port's
search equals the reference's (language_detector_tpu/autotune.py) on the
same surfaces: the same candidates in the same order and the same
result dict.
"""
from __future__ import annotations

import pytest

from language_detector_tpu import autotune as jautotune
from language_detector_tpu import knobs as jknobs
from language_detector_tpu import slo as jslo
from language_detector_tpu_torch import autotune, knobs, slo, telemetry

SPEC_TEXT = "p99_ms=100,err_pct=2,window_sec=8"
SPEC = slo.parse_spec(SPEC_TEXT)


def test_knob_space_covers_declared_mutables():
    space = autotune.knob_space()
    names = [s[0] for s in space]
    assert "LDT_MAX_INFLIGHT" in names
    assert "LDT_BROWNOUT_ALPHA" in names
    for name, lo, hi, _b in space:
        assert lo < hi, name
    assert space == jautotune.knob_space()


def test_knob_space_restricts_to_names():
    space = autotune.knob_space(names={"LDT_MAX_INFLIGHT"})
    assert [s[0] for s in space] == ["LDT_MAX_INFLIGHT"]


def test_candidates_for_unset_knob_ladder_in_range():
    cands = autotune.candidates("LDT_MAX_QUEUE_DOCS", None,
                                1.0, 1_000_000.0, True)
    assert cands, "unset knob produced no seed candidates"
    assert all(1 <= c <= 1_000_000 for c in cands)
    assert sorted(cands) == cands


def test_candidates_for_live_value_multiplier_moves():
    cands = autotune.candidates("LDT_MAX_INFLIGHT", 64, 1.0, 65536.0,
                                True)
    assert 16 in cands and 32 in cands
    assert 128 in cands and 256 in cands
    assert None in cands


def test_candidates_clamp_to_mrange():
    cands = autotune.candidates("LDT_BROWNOUT_ALPHA", 0.5, 0.01, 1.0,
                                False)
    assert all(c <= 1.0 for c in cands)
    assert None not in cands


@pytest.mark.parametrize("args", [
    ("LDT_MAX_QUEUE_DOCS", None, 1.0, 1_000_000.0, True),
    ("LDT_MAX_INFLIGHT", 64, 1.0, 65536.0, True),
    ("LDT_MAX_INFLIGHT", 3, 1.0, 65536.0, True),
    ("LDT_BROWNOUT_ALPHA", 0.5, 0.01, 1.0, False),
    ("LDT_BROWNOUT_ALPHA", None, 0.01, 1.0, False)])
def test_candidates_match_reference(args):
    assert autotune.candidates(*args) == jautotune.candidates(*args)


def test_score_feasibility_dominates_throughput():
    good = {"p99_ms": 50, "err_pct": 0.5, "ok_docs_per_sec": 100}
    fast_but_breaching = {"p99_ms": 500, "err_pct": 0.5,
                          "ok_docs_per_sec": 10_000}
    assert autotune.score(good, SPEC) \
        > autotune.score(fast_but_breaching, SPEC)


def test_score_without_spec_is_throughput():
    m = {"p99_ms": 9999, "err_pct": 50, "ok_docs_per_sec": 123.0}
    assert autotune.score(m, None) == 123.0


def _feasible_surface(ov):
    inflight = ov.get("LDT_MAX_INFLIGHT")
    if inflight is None:
        return {"p99_ms": 2000.0, "err_pct": 0.0,
                "ok_docs_per_sec": 500.0}
    return {"p99_ms": 20.0 + inflight * 1.0, "err_pct": 0.0,
            "ok_docs_per_sec": 100.0 * min(inflight, 128) ** 0.5}


def _queue_surface(ov):
    q = ov.get("LDT_MAX_QUEUE_DOCS") or 0
    return {"p99_ms": 10.0 + (q % 97), "err_pct": 0.0,
            "ok_docs_per_sec": float(q or 1)}


def _two_knob_surface(ov):
    inflight = ov.get("LDT_MAX_INFLIGHT") or 4096
    q = ov.get("LDT_MAX_QUEUE_DOCS") or 1 << 20
    return {"p99_ms": 5.0 + inflight / 8 + q / 4096,
            "err_pct": 3.0 if q < 64 else 0.5,
            "ok_docs_per_sec": float(min(inflight, 256) + q % 1000)}


def _flat_surface(ov):
    return {"p99_ms": 10.0, "err_pct": 0.0, "ok_docs_per_sec": 100.0}


def test_autotune_finds_feasible_optimum():
    res = autotune.autotune(_feasible_surface,
                            names={"LDT_MAX_INFLIGHT"}, spec=SPEC)
    best = res["best"]
    assert "LDT_MAX_INFLIGHT" in best
    assert best["LDT_MAX_INFLIGHT"] <= 80
    assert res["best_metrics"]["p99_ms"] <= 100.0
    assert res["baseline_metrics"]["p99_ms"] > 100.0
    assert res["best_score"] > res["baseline_score"]


@pytest.mark.parametrize("surface,names,rounds", [
    (_feasible_surface, {"LDT_MAX_INFLIGHT"}, 2),
    (_queue_surface, {"LDT_MAX_QUEUE_DOCS"}, 2),
    (_two_knob_surface, {"LDT_MAX_INFLIGHT", "LDT_MAX_QUEUE_DOCS"}, 3),
    (_flat_surface, None, 1)])
def test_search_equals_reference(surface, names, rounds):
    """The same surface through both packages: the same candidate
    batches in the same order, and the same result dict."""
    seen: dict = {"port": [], "jax": []}

    def recorder(tag):
        def evaluate(ov):
            seen[tag].append(sorted(ov.items()))
            return surface(ov)
        return evaluate

    got = autotune.autotune(recorder("port"), names=names, rounds=rounds,
                            spec=slo.parse_spec(SPEC_TEXT))
    want = jautotune.autotune(recorder("jax"), names=names, rounds=rounds,
                              spec=jslo.parse_spec(SPEC_TEXT))
    assert seen["port"] == seen["jax"] and seen["port"]
    assert got == want


def test_autotune_counts_evals_and_caches():
    calls = []

    def evaluate(ov):
        calls.append(dict(ov))
        return _flat_surface(ov)

    before = telemetry.REGISTRY.counter_value("ldt_autotune_evals_total")
    res = autotune.autotune(evaluate, names={"LDT_MAX_INFLIGHT"},
                            spec=SPEC, rounds=3)
    after = telemetry.REGISTRY.counter_value("ldt_autotune_evals_total")
    assert res["evals"] == len(calls)
    assert after - before == len(calls)
    assert len({tuple(sorted(c.items())) for c in calls}) == len(calls)


def test_autotune_respects_live_overrides_as_start():
    knobs.apply_overrides({"LDT_MAX_INFLIGHT": "64"})
    jknobs.apply_overrides({"LDT_MAX_INFLIGHT": "64"})
    try:
        seen = []

        def evaluate(ov):
            seen.append(ov.get("LDT_MAX_INFLIGHT"))
            return {"p99_ms": 10.0, "err_pct": 0.0,
                    "ok_docs_per_sec": 1.0}

        res = autotune.autotune(evaluate, names={"LDT_MAX_INFLIGHT"},
                                spec=SPEC, rounds=1)
        assert 128 in seen or 32 in seen
        assert res == jautotune.autotune(
            evaluate, names={"LDT_MAX_INFLIGHT"},
            spec=jslo.parse_spec(SPEC_TEXT), rounds=1)
    finally:
        knobs.clear_overrides()
        jknobs.clear_overrides()


def test_autotune_result_shape_for_bench_round():
    res = autotune.autotune(_flat_surface, names={"LDT_MAX_INFLIGHT"},
                            spec=SPEC)
    for key in ("best", "best_score", "best_metrics",
                "baseline_metrics", "baseline_score", "evals", "spec"):
        assert key in res, key
    assert res["spec"]["target_ms"] == 100.0


def test_autotune_with_pytest_approx_noise_free_determinism():
    a = autotune.autotune(_queue_surface, names={"LDT_MAX_QUEUE_DOCS"},
                          spec=SPEC)
    b = autotune.autotune(_queue_surface, names={"LDT_MAX_QUEUE_DOCS"},
                          spec=SPEC)
    assert a == b


def test_autotune_uses_declared_slo_from_env(monkeypatch):
    monkeypatch.setenv("LDT_SLO", "p99_ms=55,err_pct=3,window_sec=8")
    res = autotune.autotune(_flat_surface, names={"LDT_MAX_INFLIGHT"})
    assert res["spec"]["target_ms"] == 55.0
    assert pytest.approx(res["spec"]["err_pct"]) == 3.0
