"""The port's score-trace CLI (language_detector_tpu_torch/debug.py)
against the reference's (language_detector_tpu/debug.py).

format_trace gives the reference's text and HTML on
tests/test_debug_trace.py's inputs, each format_* gives the reference's
output on the same JSON documents (a /sloz, a /debug/slow, a /tracez, a
/debug/vars, ACC_r01.json, a capture summary, engine stats, spans), the
CLI's views print the reference's bytes for the same input, and
--engine-stats runs the batched engine on --device cpu.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from language_detector_tpu import debug as jdebug
from language_detector_tpu_torch import debug, telemetry
from language_detector_tpu_torch.engine_scalar import (detect_scalar,
                                                       detect_scalar_spans)
from language_detector_tpu_torch.registry import registry
from language_detector_tpu_torch.tables import ScoringTables, load_tables

REPO = Path(__file__).resolve().parent.parent

MIXED = "This is English mixed with 日本語のテキストです。"
GREEK = "ελληνικά γλώσσα είναι " * 60
FR_JA = ("Le gouvernement a annoncé de nouvelles mesures pour aider "
         "les familles. こんにちは世界。今日はとても良い天気ですね。")
CLI_TEXT = "国民の大多数が内閣を支持し ελληνικά γλώσσα"


@pytest.fixture(scope="module")
def port_base_tables():
    """The port's snapshot-parity tables (quadgram tables off), the
    counterpart of conftest.py's base_tables."""
    return ScoringTables.load(quad_path=False)


# -- score traces --------------------------------------------------------------


def test_trace_records_pipeline(port_base_tables):
    tr = debug.trace_detect(MIXED, tables=port_base_tables)
    kinds = [k for k, _ in tr.events]
    assert "pass" in kinds and "span" in kinds and "chunk" in kinds
    assert kinds.count("doc_tote") >= 2
    assert kinds[-1] == "summary"
    text = debug.format_trace(tr)
    assert "span script=" in text and "doc_tote[scored]" in text
    plain = detect_scalar(MIXED, port_base_tables)
    assert tr.result.summary_lang == plain.summary_lang
    assert tr.result.percent3 == plain.percent3


def test_trace_recursion_passes(port_base_tables):
    tr = debug.trace_detect(GREEK, tables=port_base_tables)
    passes = [p["flags"] for k, p in tr.events if k == "pass"]
    assert len(passes) >= 2 and any(f & 2 for f in passes)


@pytest.mark.parametrize("html", [False, True])
@pytest.mark.parametrize("text,base", [(MIXED, True), (GREEK, True),
                                       (FR_JA, False)])
def test_format_trace_equals_reference(base_tables, port_base_tables,
                                       text, base, html):
    """Events and both renders equal the reference's on the same text
    and tables (the snapshot tables, or the shipped ones)."""
    tr = debug.trace_detect(text, tables=port_base_tables if base
                            else None)
    jtr = jdebug.trace_detect(text, tables=base_tables if base else None)
    assert tr.events == jtr.events
    got = debug.format_trace(tr, html=html)
    assert got == jdebug.format_trace(jtr, html=html)
    if html:
        n_chunks = sum(1 for k, _ in tr.events if k == "chunk")
        assert got.startswith("<!doctype html>")
        assert n_chunks > 0 and got.count("class=chunk") == n_chunks


# -- the JSON documents the fronts serve ----------------------------------------


def _sloz() -> dict:
    from language_detector_tpu_torch import slo
    now = [1000.0]
    eng = slo.SloEngine(slo.parse_spec("p99_ms=50,err_pct=1,"
                                       "window_sec=30"),
                        clock=lambda: now[0], min_events=2)
    for i in range(40):
        eng.observe(f"tenant-{i % 3}", 200 if i % 9 else 503,
                    5.0 + i * 3.5, shed=i % 13 == 0)
        now[0] += 0.25
    return eng.snapshot()


def _fleet_sloz() -> dict:
    return {"enabled": True, "alert": "breach", "members": [0, 1],
            "spec": {"percentile": 99.0, "target_ms": 500.0,
                     "err_pct": 1.0, "window_sec": 30.0},
            "tenants": {"tenant-00": {"count": 40, "bad": 2, "shed": 1,
                                      "burn_rate_max": 3.5},
                        "default": {"count": 7, "bad": 0, "shed": 0,
                                    "burn_rate_max": 0.0}}}


def _debug_slow() -> dict:
    ring = telemetry.SlowTraceRing(capacity=4, threshold_ms=0.5)
    for i in range(6):
        tr = telemetry.Trace()
        t = tr.t0
        for name, depth in (("parse", 0), ("queue", 0), ("flush", 1),
                            ("pack", 2), ("device", 2), ("epilogue", 2)):
            tr.add(name, t, t + 0.001 * (i + 1), depth)
            t += 0.001 * (i + 1)
        ring.record(tr, 7.5 * (i + 1),
                    meta={"docs": i + 1, "status": 200, "tenant": "t"})
    return {"threshold_ms": ring.threshold_ms, "capacity": ring.capacity,
            "recorded": ring.recorded, "traces": ring.snapshot()}


def _tracez() -> dict:
    slow = _debug_slow()["traces"]
    return {"count": 2, "requests": [
        {"request_id": "req-1", "processes": [101, 102],
         "traces": [dict(slow[0], slot=0), dict(slow[1], slot=1)],
         "events": [{"ev": "request_end", "ts": 12.5, "pid": 102,
                     "request_id": "req-1", "status": 200,
                     "total_ms": 3.25},
                    {"ev": "request_start", "ts": 12.0, "pid": 101,
                     "request_id": "req-1", "docs": 4}]},
        {"request_id": "req-2", "processes": [101], "traces": [],
         "events": []}]}


def _debug_vars() -> dict:
    from language_detector_tpu_torch.service import admission
    adm = admission.AdmissionController(admission.AdmissionConfig(
        max_queue_docs=512, max_inflight=8))
    return {"admission": adm.stats(), "engine": {"batches": 3}}


def _scorecard() -> dict:
    return json.loads((REPO / "ACC_r01.json").read_text())


def _capture_summary(tmp_path) -> dict:
    from language_detector_tpu_torch import capture
    w = capture.CaptureWriter(str(tmp_path), ring_records=16)
    for i in range(40):
        w.append((0, i % 3, 0, 1 + i % 4, 0.0, 1.0 + i, 0.1, 0.2, 0.3,
                  200 if i % 7 else 429, 8, 0, 0, 0))
    w.close()
    return capture.summarize(str(tmp_path))


DOCS = {
    "format_slo": [_sloz, _fleet_sloz,
                   lambda: {"enabled": False, "hint": "set LDT_SLO"},
                   lambda: {"enabled": False}],
    "format_slow_traces": [_debug_slow,
                           lambda: {"traces": [], "recorded": 0}],
    "format_fleet_traces": [_tracez, lambda: {"requests": []}],
    "format_admission": [_debug_vars, lambda: {"admission": {}},
                         lambda: _debug_vars()["admission"]],
    "format_scorecard": [_scorecard],
    "format_engine_stats": [lambda: {"batches": 2, "device_dispatches": 1,
                                     "zz_extra": 4, "aot_loads": 1},
                            lambda: {}],
}
CASES = [(name, i) for name, makers in DOCS.items()
         for i in range(len(makers))]


@pytest.mark.parametrize("name,i", CASES)
def test_formatter_equals_reference(name, i):
    doc = DOCS[name][i]()
    got = getattr(debug, name)(json.loads(json.dumps(doc)))
    assert got == getattr(jdebug, name)(json.loads(json.dumps(doc)))
    assert got


def test_capture_summary_equals_reference(tmp_path):
    doc = _capture_summary(tmp_path)
    assert doc["records"] == 40
    assert debug.format_capture_summary(doc) == \
        jdebug.format_capture_summary(doc)


def test_format_spans_equals_reference():
    from language_detector_tpu.engine_scalar import \
        detect_scalar_spans as jspans
    from language_detector_tpu.registry import registry as jreg
    from language_detector_tpu.tables import load_tables as jload
    text = FR_JA + " " + MIXED * 3
    r = detect_scalar_spans(text, load_tables(), registry)
    jr = jspans(text, jload(), jreg)
    assert r.spans == jr.spans and r.spans
    assert debug.format_spans(text, r.spans, registry) == \
        jdebug.format_spans(text, jr.spans, jreg)


# -- the CLI -------------------------------------------------------------------


def _cli(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--quiet", "--vector", CLI_TEXT],
                                  ["--vector", FR_JA],
                                  ["--spans", FR_JA + " " + MIXED],
                                  ["--eval"]])
def test_cli_equals_reference(argv, capsys):
    got = _cli(debug._main, argv, capsys)
    assert got == _cli(jdebug._main, argv, capsys)
    assert got


def test_cli_quiet_vector(capsys):
    out = _cli(debug._main, ["--quiet", "--vector", CLI_TEXT], capsys)
    assert "=>" in out and "ja" in out


@pytest.mark.parametrize("flag,maker", [("--slo", _sloz),
                                        ("--slow-traces", _debug_slow),
                                        ("--fleet-traces", _tracez),
                                        ("--admission", _debug_vars),
                                        ("--eval", _scorecard)])
def test_cli_json_views_equal_reference(flag, maker, tmp_path, capsys):
    src = tmp_path / "doc.json"
    src.write_text(json.dumps(maker()))
    got = _cli(debug._main, [flag, str(src)], capsys)
    assert got == _cli(jdebug._main, [flag, str(src)], capsys)


def test_cli_capture_summary_equals_reference(tmp_path, capsys):
    _capture_summary(tmp_path)
    got = _cli(debug._main, ["--capture-summary", str(tmp_path)], capsys)
    assert got == _cli(jdebug._main, ["--capture-summary", str(tmp_path)],
                       capsys)


def test_cli_render_html(tmp_path, capsys):
    out = tmp_path / "trace.html"
    _cli(debug._main, ["--quiet", "--render-html", str(out), FR_JA],
         capsys)
    page = out.read_text()
    assert page.startswith("<!doctype html>") and "class=chunk" in page


def test_cli_engine_stats_on_cpu(capsys):
    """--engine-stats --device cpu: one code line per document, equal to
    the port's CPU engine, then the scheduler's counters."""
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    lines = [ln.split("\t", 1)[1].rstrip("\n") for ln in
             open(REPO / "language_detector_tpu" / "data" /
                  "eval_corpus.tsv", encoding="utf-8")][:80]
    out = _cli(debug._main, ["--engine-stats", "--device", "cpu",
                             *lines], capsys).splitlines()
    want = NgramBatchEngine(device="cpu").detect_codes(lines)
    assert [ln.split()[0] for ln in out[:len(lines)]] == want
    stats = dict(ln.split() for ln in out[len(lines):])
    assert int(stats["device_dispatches"]) >= 1
    assert int(stats["batches"]) >= 1


def test_cli_engine_stats_default_device_is_cuda(monkeypatch):
    """Without --device the engine goes to the card, and raises on a
    host without one instead of scoring on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        debug._main(["--engine-stats", "hello world"])
