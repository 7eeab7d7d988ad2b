"""The port's seeded load model (language_detector_tpu_torch/loadgen.py)
against the reference's (language_detector_tpu/loadgen.py).

The port's generate() must return the same records, and the same
json.dumps bytes, as the reference's for every scenario and seed; and
tests/test_loadgen.py's envelope contract holds on the port: identical
calls are byte-identical, distinct seeds conserve the rate envelope,
and each scenario's signature shape is present.
"""
from __future__ import annotations

import json

import pytest

from language_detector_tpu import loadgen as jloadgen
from language_detector_tpu_torch import loadgen

N = 800
SEEDS = (1234, 7, 99)


def test_scenarios_and_constants_match_reference():
    assert loadgen.scenario_names() == jloadgen.scenario_names()
    assert (loadgen.FLASH_FACTOR, loadgen.CROWD_START,
            loadgen.CROWD_END) == (jloadgen.FLASH_FACTOR,
                                   jloadgen.CROWD_START,
                                   jloadgen.CROWD_END)
    for name in loadgen.scenario_names():
        assert loadgen.mean_intensity(name) == \
            jloadgen.mean_intensity(name)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scenario", jloadgen.scenario_names())
def test_generate_is_byte_identical_to_reference(scenario, seed):
    got = loadgen.generate(scenario, n=N, seed=seed)
    want = jloadgen.generate(scenario, n=N, seed=seed)
    assert got == want
    assert json.dumps(got) == json.dumps(want)
    assert loadgen.interval_counts(got) == jloadgen.interval_counts(want)


@pytest.mark.parametrize("kw", [{"tenants": 5}, {"base_rps": 37.5},
                                {"n": 1}, {"n": 0}])
def test_generate_parameters_match_reference(kw):
    args = {"n": 64, "seed": 7, **kw}
    for scenario in loadgen.scenario_names():
        assert json.dumps(loadgen.generate(scenario, **args)) == \
            json.dumps(jloadgen.generate(scenario, **args))


@pytest.mark.parametrize("scenario", loadgen.scenario_names())
def test_same_seed_is_byte_identical(scenario):
    a = loadgen.generate(scenario, n=N, seed=7)
    b = loadgen.generate(scenario, n=N, seed=7)
    assert json.dumps(a, sort_keys=True) == json.dumps(b,
                                                       sort_keys=True)


@pytest.mark.parametrize("scenario", loadgen.scenario_names())
def test_distinct_seeds_distinct_but_rate_conserving(scenario):
    a = loadgen.generate(scenario, n=N, seed=7)
    b = loadgen.generate(scenario, n=N, seed=8)
    assert json.dumps(a) != json.dumps(b), "seed had no effect"
    assert len(a) == len(b) == N
    span_a = max(r["arrival_ns"] for r in a)
    span_b = max(r["arrival_ns"] for r in b)
    assert abs(span_a - span_b) / max(span_a, 1) < 0.02
    ca = loadgen.interval_counts(a, buckets=10)
    cb = loadgen.interval_counts(b, buckets=10)
    for i, (x, y) in enumerate(zip(ca, cb)):
        assert abs(x - y) <= 3, (i, ca, cb)


@pytest.mark.parametrize("scenario", loadgen.scenario_names())
def test_records_use_capture_shape(scenario):
    recs = loadgen.generate(scenario, n=32, seed=1)
    prev = -1
    for r in recs:
        assert r["arrival_ns"] >= prev
        prev = r["arrival_ns"]
        assert r["docs"] >= 1
        assert r["approx_bytes"] >= 64
        assert isinstance(r["tenant"], str)
        assert isinstance(r["tenant_hash"], int)
        assert isinstance(r["priority"], bool)
        assert r["verdict"] == "ok"


def test_flash_crowd_steps_x10():
    recs = loadgen.generate("flash_crowd", n=2000, seed=3)
    counts = loadgen.interval_counts(recs, buckets=10)
    base = sum(counts[:4]) / 4
    crowd = sum(counts[4:7]) / 3
    assert crowd / base == pytest.approx(loadgen.FLASH_FACTOR, rel=0.15)


def test_burst_lull_alternates():
    recs = loadgen.generate("burst_lull", n=2000, seed=3)
    counts = loadgen.interval_counts(recs, buckets=10)
    assert min(counts[0::2]) > max(counts[1::2])


def test_diurnal_peaks_mid_span():
    recs = loadgen.generate("diurnal", n=2000, seed=3)
    counts = loadgen.interval_counts(recs, buckets=10)
    assert max(counts[4:6]) == max(counts)
    assert min(counts) == min(counts[0], counts[-1])


def test_tenant_shift_rotates_hot_tenant():
    recs = loadgen.generate("tenant_shift", n=3000, seed=3, tenants=32)
    span = max(r["arrival_ns"] for r in recs) + 1

    def hot(third):
        seen: dict = {}
        for r in recs:
            if int(r["arrival_ns"] * 3 / span) == third:
                seen[r["tenant"]] = seen.get(r["tenant"], 0) + 1
        return max(seen, key=seen.get)

    hots = [hot(i) for i in range(3)]
    assert len(set(hots)) == 3, f"hot tenant never rotated: {hots}"


def test_unknown_scenario_raises():
    with pytest.raises(KeyError):
        loadgen.generate("no-such-shape")


def test_base_rate_scales_span():
    a = loadgen.generate("tenant_shift", n=500, seed=1, base_rps=100.0)
    b = loadgen.generate("tenant_shift", n=500, seed=1, base_rps=200.0)
    span_a = max(r["arrival_ns"] for r in a)
    span_b = max(r["arrival_ns"] for r in b)
    assert span_a / span_b == pytest.approx(2.0, rel=0.01)
