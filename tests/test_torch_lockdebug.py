"""The port's concurrent CPU paths under the lock-order watchdog.

LDT_LOCK_DEBUG is read when a lock is made, so each run is a freshly
spawned process whose environment sets it before the port is imported
(chip_smoke.lockdebug_run, the helper the card's `lockdebug` phase
uses): a pooled engine on device="cpu" (3 simulated lanes, pipeline
depth 2, the integrity scrub between flushes) over 600
documents and a 30%-duplicate copy, then the asyncio front's HTTP and
unix-socket lanes under 8 clients. The run with the watchdog must raise
no LockOrderInversion, record a non-empty order graph, and answer
exactly as the same run without it.
"""
from __future__ import annotations

import pytest

import chip_smoke
from language_detector_tpu_torch.tables import DATA_DIR
from torch_support import jax_packer

jax_packer()

N_DOCS = 600


def _inputs():
    lines = open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8") \
        .read().splitlines()
    corpus = [ln.split("\t", 1)[1] for ln in lines]
    docs = chip_smoke.build_docs(corpus, 7, N_DOCS)[:N_DOCS]
    dup = chip_smoke.scheduler_inputs(docs, 7)["dup_heavy"]
    bodies = chip_smoke.service_requests(docs, 7)
    return docs, dup, bodies


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    docs, dup, bodies = _inputs()
    return {flag: chip_smoke.lockdebug_run(
        flag, "cpu", docs, dup, bodies,
        str(tmp_path_factory.mktemp(f"lock{int(flag)}")), lanes=3,
        clients=8, scrub_s=0.01) for flag in (True, False)}


def test_watchdog_watched_and_found_no_inversion(runs):
    on = runs[True]
    assert on["lock_debug"] is True
    dog = on["watchdog"]
    assert dog["inversions"] == 0
    assert dog["locks"] > 0 and dog["edges"] > 0
    assert len(on["edges"]) == dog["edges"]
    # the CPU paths take the card phase's watched roles but the kernel
    # library's and the launch count's, which only a CUDA launch takes
    cpu_roles = {"pool.future", "pool.lane", "staging.ring"}
    assert cpu_roles <= set(dog["roles"])
    assert cpu_roles < set(chip_smoke.LOCKDEBUG_ROLES)
    # the off run made plain locks only
    assert runs[False]["lock_debug"] is False
    assert runs[False]["watchdog"]["locks"] == 0


def test_paths_ran_concurrently_and_scrubbed(runs):
    eng = runs[True]["engine"]
    assert eng["dispatches"] > 0 and eng["scrub"]["scrubs"] > 0
    assert eng["pool_launches"] == \
        eng["dispatches"] + eng["hedges"] + eng["redispatches"]
    assert eng["pending_releases"] == 0 and eng["staging_occupancy"] == 0
    assert runs[True]["front"]["dispatches"] > 0


def test_answers_equal_the_run_without_the_watchdog(runs):
    on, off = runs[True], runs[False]
    assert on["codes"] == off["codes"]
    assert on["answers"] == off["answers"]
    docs, dup, bodies = _inputs()
    assert len(on["codes"]["mix"]) == len(docs)
    for lane in chip_smoke.LOCKDEBUG_LANES:
        assert len(on["answers"][lane]) == len(bodies)
        assert all(a[0] in (200, 203) for a in on["answers"][lane])
