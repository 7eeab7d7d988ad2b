"""The port's measuring layer (language_detector_tpu_torch.bench) against
the reference's bench.py, on the CPU.

The corpora and the synthetic capture equal bench.py's document for
document and record for record. The headline, run with device="cpu" at
256-document batches (two of them, no service bench), has the JAX
bench's keys apart from the port's `card`, and the JAX bench's counts:
packer fallbacks, the mixed pass's retries, dedup, retry-lane and tier
dispatches, the long-heavy pass's split documents, the cache hit rate,
the average document size and the summary sample. The whole JAX
function runs here at that size (about 20 s). The long-doc lane's
counts equal bench.bench_longdoc's on 8 fat-tail documents. Every
mode's entry raises under device "cuda" without CUDA, and the modes
that start the port's fronts refuse "cpu". No mode writes a file at
the repository root, and no source of the bench names the JAX package
or jax.
"""
from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench
from language_detector_tpu_torch import bench as tbench
from language_detector_tpu_torch.bench import (coldstart, corpus, engine,
                                               fronts, kernel, overhead,
                                               replay)
from language_detector_tpu_torch.bench import __main__ as bench_main
from language_detector_tpu_torch.tools import bench_service, fuzz
from torch_support import jax_packer

jax_packer()

ROOT = Path(__file__).resolve().parent.parent
BATCH = 256

# the port's keys beside the reference's: the card's name and power
DEPARTURES = {"card"}
COUNT_FIELDS = ("fallback_docs", "mixed_fallback_docs", "mixed_retried_docs",
                "mixed_dedup_docs", "mixed_retry_lane_dispatches",
                "tier_dispatches", "mixed_retry_offtier_docs",
                "longheavy_split_docs", "doc_bytes_avg", "summary_sample",
                "cache_hit_rate")


@pytest.mark.parametrize("n", [1, 64, 250, 1000])
@pytest.mark.parametrize("name", ["make_corpus", "make_mixed_corpus",
                                  "make_longheavy_corpus"])
def test_corpus_equals_bench(name, n):
    assert getattr(corpus, name)(n) == getattr(bench, name)(n)


@pytest.mark.parametrize("n", [1, 3, 12])
def test_longtail_corpus_equals_bench(n):
    assert corpus.make_longtail_corpus(n) == bench.make_longtail_corpus(n)


def test_make_corpus_is_the_tools_copy():
    assert corpus.make_corpus is fuzz.make_corpus


@pytest.mark.parametrize("tenant,seq,size", [
    (12345, 3, 256), (12345, 19, 256), (0, 0, 8), (0xFFFFFFFFFF, 77, 900),
    (42, 5, 1), (987654321, 131, 64)])
def test_synth_replay_text_equals_bench(tenant, seq, size):
    assert corpus._synth_replay_text(tenant, seq, size) == \
        bench._synth_replay_text(tenant, seq, size)


@pytest.mark.parametrize("kw", [{}, {"n": 200, "tenants": 8,
                                     "rate_rps": 150.0, "seed": 11},
                                {"n": 50, "tenants": 3, "seed": 0}])
def test_synth_capture_records_equal_bench(kw):
    got = corpus.synth_capture_records(**kw)
    assert got == bench.synth_capture_records(**kw)
    assert len(got) == kw.get("n", 2000)


@pytest.fixture(scope="module")
def headlines():
    """The port's headline and the JAX bench's at BATCH x 2."""
    port = engine.bench(BATCH, n_batches=2, http_bench=False,
                        device="cpu")
    ref = bench.bench(BATCH, n_batches=2, http_bench=False)
    return port, ref


def test_headline_keys_equal_the_reference(headlines):
    port, ref = headlines
    assert set(port) == set(ref) | DEPARTURES
    assert set(port["detail"]) == set(ref["detail"])
    assert port["vs_baseline"] is None and port["card"] is None
    assert port["metric"] == ref["metric"] == "batch_detect_throughput"
    d = port["detail"]
    assert d["kernel"] == "plain" and d["pipeline_donation_hits"] == 0
    assert d["http_docs_sec"] is None and d["http_engine_ratio"] is None
    assert d["faults_disabled"] is True and d["xla_compiles"] == {}
    assert port["value"] > 0 and d["pack_ms"] > 0 and d["score_ms"] > 0


@pytest.mark.parametrize("field", COUNT_FIELDS)
def test_headline_counts_equal_the_reference(headlines, field):
    port, ref = headlines
    assert port["detail"][field] == ref["detail"][field]


def test_headline_passes_ran(headlines):
    d = headlines[0]["detail"]
    assert d["mixed_retry_offtier_docs"] == 0
    assert d["longheavy_split_docs"] > 0 and d["mixed_retried_docs"] > 0
    assert sum(d["tier_dispatches"].values()) > 0
    assert len(d["mixed_run_ms"]) == 5
    assert {"dispatch", "pack", "epilogue"} <= set(d["stage_latency_ms"])


def test_longdoc_counts_equal_the_reference():
    port = engine.bench_longdoc(8, device="cpu")
    ref = bench.bench_longdoc(8)
    assert set(port) == set(ref) | DEPARTURES
    assert set(port["detail"]) == set(ref["detail"])
    for k in ("n_docs", "doc_bytes_avg", "split_docs", "subdocs",
              "longdoc_chunks", "scalar_mismatches"):
        assert port["detail"][k] == ref["detail"][k], k
    assert port["detail"]["scalar_mismatches"] == 0
    assert port["detail"]["split_docs"] > 0


def test_multichip_repeats_the_device_and_says_so():
    out = engine.run_multichip(2, device="cpu")
    d = out["detail"]
    assert out["metric"] == "multichip_pool_throughput"
    assert out["vs_baseline"] is None and out["card"] is None
    assert d["simulated"] is True and d["n_devices"] == 2
    assert d["n_lanes"] == 2 and d["lanes_active"] == 2
    assert sum(d["per_lane_dispatches"].values()) > 0
    assert d["docs_total"] == 4096 * 2 * 3 and out["value"] > 0


_GUARDED = {
    "headline": lambda: engine.bench(64, 1, http_bench=False,
                                     device="cuda"),
    "longdoc": lambda: engine.bench_longdoc(1, device="cuda"),
    "multichip": lambda: engine.run_multichip(2, device="cuda"),
    "multichip_child": lambda: engine.bench_multichip_child(2, "cuda"),
    "kernel": lambda: kernel.bench_kernel(64, device="cuda"),
    "smoke": lambda: overhead.smoke("cuda"),
    "scrub_child": lambda: overhead.scrub_child("cuda"),
    "fleet": lambda: fronts.bench_fleet(2, device="cuda"),
    "shm": lambda: fronts.bench_shm(device="cuda"),
    "coldstart": lambda: coldstart.bench_coldstart(device="cuda"),
    "replay": lambda: replay.bench_replay(synth="zipf", device="cuda"),
    "eval": lambda: bench_main.main(["--eval", "--quick"]),
    "profile": lambda: bench_main.main(["--profile", "unused"]),
    "service_aio": lambda: bench_service.run_aio(64, 1, 64),
    "service": lambda: bench_service.run(64, 1, 64),
}


@pytest.mark.parametrize("mode", sorted(_GUARDED))
def test_every_mode_raises_without_cuda(mode, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the guard does not fire")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _GUARDED[mode]()


@pytest.mark.parametrize("mode", ["fleet", "shm", "coldstart", "replay"])
def test_front_modes_refuse_the_cpu(mode):
    fn = {"fleet": fronts.bench_fleet, "shm": fronts.bench_shm,
          "coldstart": coldstart.bench_coldstart,
          "replay": lambda device: replay.bench_replay(
              synth="zipf", device=device)}[mode]
    with pytest.raises(ValueError, match="serve on the card only"):
        fn(device="cpu")


def _root_records() -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for pat in ("BENCH_*.json", "ACC_*.json", "MULTICHIP_*.json",
                        "BENCHMARK.json")
            for p in sorted(ROOT.glob(pat))}


def test_modes_write_nothing_at_the_root(tmp_path):
    """--eval --quick and --kernel 64 print their line and leave the
    reference's records at the root as they were; --out writes where it
    is told."""
    before = _root_records()
    outs = {}
    for argv in (["--eval", "--quick"], ["--kernel", "64"]):
        path = tmp_path / f"{argv[0][2:]}.json"
        r = subprocess.run([sys.executable, "-m",
                            "language_detector_tpu_torch.bench", *argv,
                            "--device", "cpu", "--out", str(path)],
                           cwd=str(ROOT), capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert json.loads(path.read_text()) == line
        outs[argv[0]] = line
    assert _root_records() == before
    assert "BENCHMARK.json" not in before
    ev = outs["--eval"]
    assert ev["quick"] is True and ev["engine"] == "device"
    assert ev["card"] is None and "round" not in ev
    assert ev["agreement"]["top1"] >= ev["agreement"]["floor"]
    k = outs["--kernel"]
    assert k["metric"] == "kernel_dispatch_ms" and k["value"] > 0
    assert set(k["detail"]["tiers"]) == {"service", "mixed", "longheavy"}
    for tier in k["detail"]["tiers"].values():
        assert tier["dispatch_ms"]["plain"] > 0 and tier["grid_g"] > 0
    assert k["detail"]["kernel_selected"] == "plain"


_REFERENCE_NAME = re.compile(r"language_detector_tpu\b(?!_torch)")
_JAX = re.compile(r"\bjax\b")


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in
     (ROOT / "language_detector_tpu_torch" / "bench").glob("*.py")] +
    ["language_detector_tpu_torch/tools/bench_service.py"]))
def test_sources_name_neither_the_reference_nor_jax(path):
    text = (ROOT / path).read_text(encoding="utf-8")
    assert not _REFERENCE_NAME.findall(text)
    assert not _JAX.findall(text)


def test_package_root_is_the_checkout():
    assert tbench.ROOT == ROOT
    assert (tbench.ROOT / tbench.PKG / "bench" / "__main__.py").exists()
