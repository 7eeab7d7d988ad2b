"""The port's faults that the reference's conformance layer found, each
held to the reference:

- detect_spans counts ldt_span_docs_total as the JAX engine does;
- the `artifact_load` fault point: declared, hit before the load, and
  its corrupt rule flips one loaded array after the load;
- every series the port declares is emitted: ldt_xla_compiles_total at
  the kernel library's first load (tests/test_torch_aot.py); the
  reference's ldt_xla_compile_ms and ldt_pipeline_donation_hits_total,
  whose events the port lacks, are not declared;
- the locks of the card paths (the staging ring, the kernel library and
  the launch count) are built through locks.make_lock, so the lock-order
  watchdog sees them;
- knobs.doc_table() over the port's knobs.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from language_detector_tpu_torch import artifact, faults, knobs, telemetry
from language_detector_tpu_torch.models.ngram import NgramBatchEngine
from torch_support import jax_packer

jax_packer()

SPAN_TEXTS = ["Le gouvernement a annoncé de nouvelles mesures. "
              "Правительство объявило о новых мерах поддержки семей.",
              "this is a simple english sentence with common words",
              "", "こんにちは世界、今日はとても良い天気ですね"]


def test_span_docs_counter_delta_equals_reference():
    from language_detector_tpu import telemetry as jtelemetry
    from language_detector_tpu.models.ngram import \
        NgramBatchEngine as JaxEngine

    def delta(reg, eng):
        before = reg.counter_value("ldt_span_docs_total")
        eng.detect_spans(SPAN_TEXTS)
        return reg.counter_value("ldt_span_docs_total") - before

    want = delta(jtelemetry.REGISTRY, JaxEngine())
    got = delta(telemetry.REGISTRY, NgramBatchEngine(device="cpu"))
    assert want == len(SPAN_TEXTS)
    assert got == want


@pytest.fixture()
def packed(tmp_path):
    path = tmp_path / "model.ldta"
    artifact.write_artifact(
        {"a": np.arange(16, dtype=np.int32),
         "b": np.ones((2, 3), dtype=np.float32)}, path)
    yield path
    faults.configure(None)


def test_artifact_load_point_matches_reference(packed):
    from language_detector_tpu import faults as jfaults
    assert faults.FAULT_POINTS["artifact_load"] == \
        jfaults.FAULT_POINTS["artifact_load"]
    faults.configure("artifact_load:delay_ms=1:once")
    assert list(artifact.load_artifact(packed)["a"]) == list(range(16))


def test_artifact_load_corrupt_rule_flips_one_array(packed):
    from language_detector_tpu import artifact as jartifact
    from language_detector_tpu import faults as jfaults
    clean = artifact.load_artifact(packed)
    spec = "artifact_load:corrupt:seed=5:once"
    faults.configure(spec)
    jfaults.configure(spec)
    try:
        got = artifact.load_artifact(packed)
        want = jartifact.load_artifact(packed)
    finally:
        jfaults.configure(None)
    changed = [n for n in clean if not np.array_equal(got[n], clean[n])]
    assert len(changed) == 1
    for n in clean:
        assert np.array_equal(got[n], want[n]), n
    # once: the next load is clean again
    assert all(np.array_equal(artifact.load_artifact(packed)[n], clean[n])
               for n in clean)


def test_port_declares_no_series_of_an_event_it_lacks():
    from language_detector_tpu import telemetry as jtelemetry
    gone = {"ldt_xla_compile_ms", "ldt_pipeline_donation_hits_total"}
    assert gone <= set(jtelemetry.METRICS)
    assert not gone & set(telemetry.METRICS)
    assert "ldt_xla_compiles_total" in telemetry.METRICS
    # the engine's pipeline view keeps the reference's key, at zero
    eng = NgramBatchEngine(device="cpu", pipeline_depth=2)
    texts = [f"this is english sentence number {i} with words"
             for i in range(300)]
    eng.detect_codes(texts)
    eng.detect_codes(texts[::-1])
    assert eng.staging_stats()["hits"] > 0
    assert eng.pipeline_stats()["donation_hits"] == 0


def test_card_path_locks_are_watched():
    """Under LDT_LOCK_DEBUG=1 (read when a lock is made, so in a fresh
    process) the staging ring's lock and the kernel module's library and
    launch-count locks are debug locks under their role names."""
    code = (
        "from language_detector_tpu_torch import locks, native\n"
        "from language_detector_tpu_torch.ops import kernels\n"
        "got = [(l.name, isinstance(l, locks.DebugLock)) for l in (\n"
        "    native.StagingRing()._lock, kernels._lock,\n"
        "    kernels._count_lock)]\n"
        "assert got == [('staging.ring', True), ('kernels.library', True),\n"
        "               ('kernels.launch_count', True)], got\n"
        "kernels.count_launch()\n"
        "assert kernels.launches == 1\n")
    env = {**os.environ, "LDT_LOCK_DEBUG": "1"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       cwd=Path(__file__).resolve().parent.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_doc_table_covers_every_port_knob():
    from language_detector_tpu import knobs as jknobs
    table = knobs.doc_table()
    rows = table.splitlines()[2:]
    assert len(rows) == len(knobs.KNOBS)
    for name in knobs.KNOBS:
        assert f"| `{name}` |" in table
    # the reference's header and row format
    assert table.splitlines()[:2] == jknobs.doc_table().splitlines()[:2]
    assert all(ln.count(" | ") >= 4 for ln in rows)
