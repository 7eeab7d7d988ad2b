"""The port's service bench (tools/bench_service.py), the bench's
--smoke gates and its replay client, on the CPU, against the
reference's.

The asyncio front's bench (warm, cold and unix-socket passes) and the
threaded front's answer every document with no error and print the
reference script's keys (its run in a JAX subprocess, at the same small
size). `--smoke --device cpu` exits 0 under the reference's budgets
and prints the reference's --smoke keys plus `card`; chip_smoke.py
holds the card's run to the same key set. replay_records meets
tests/test_capture.py's bounds against a stub server.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

import chip_smoke
from language_detector_tpu_torch.bench import __main__ as bench_main
from language_detector_tpu_torch.bench import corpus, overhead, replay
from language_detector_tpu_torch.tools import bench_service

ROOT = Path(__file__).resolve().parent.parent
SIZE = ("512", "4", "64")
MODES = {"aio": ["--aio", *SIZE], "aio_cold": ["--aio-cold", *SIZE],
         "threaded": list(SIZE)}


def _ref_proc(args: list, env: dict | None = None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *args], cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _last_line(proc: subprocess.Popen, timeout: float) -> dict:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def service_runs():
    """The reference script's three modes in JAX subprocesses, started
    first, and the port's in this process, at SIZE."""
    procs = {m: _ref_proc(["tools/bench_service.py", *a])
             for m, a in MODES.items()}
    total, clients, per = (int(x) for x in SIZE)
    port = {"aio": bench_service.run_aio(total, clients, per,
                                         device="cpu"),
            "aio_cold": bench_service.run_aio(total, clients, per,
                                              cold_only=True, device="cpu"),
            "threaded": bench_service.run(total, clients, per,
                                          device="cpu")}
    return port, {m: _last_line(p, 300) for m, p in procs.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_service_bench_answers_everything(service_runs, mode):
    d = service_runs[0][mode]["detail"]
    assert d["errors"] == 0 and d["total_docs"] == 512
    assert service_runs[0][mode]["value"] > 0
    if mode == "aio":
        assert d["cold_errors"] == 0 and d["uds_errors"] == 0
        # the wire stats read this process's telemetry registry, which
        # earlier test modules of the same worker may have filled too
        assert d["uds_docs_sec"] > 0 and 0 < d["parse_fast_hit_rate"] <= 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_service_bench_keys_equal_the_reference(service_runs, mode):
    port, ref = service_runs[0][mode], service_runs[1][mode]
    assert set(port) == set(ref)
    assert set(port["detail"]) == set(ref["detail"])
    assert port["metric"] == ref["metric"]
    assert ref["detail"]["errors"] == 0


def test_service_bench_puts_the_socket_path_back(monkeypatch):
    monkeypatch.setenv("LDT_UNIX_SOCKET", "/nonexistent/kept.sock")
    out = bench_service.run_aio(128, 2, 64, cold_only=True, device="cpu")
    assert out["detail"]["errors"] == 0
    assert os.environ["LDT_UNIX_SOCKET"] == "/nonexistent/kept.sock"


@pytest.fixture(scope="module")
def smokes():
    """The port's --smoke on the CPU and the reference's bench.py
    --smoke, side by side in subprocesses. The port's runs torch on one
    intra-op thread (OMP_NUM_THREADS=1, its scrub child too): the plain
    scorer's and the scrub fold's times then do not hang on how many
    other test workers share the host's cores."""
    ref = _ref_proc(["bench.py", "--smoke"])
    port = _ref_proc(["-m", "language_detector_tpu_torch.bench",
                      "--smoke", "--device", "cpu"],
                     env=dict(os.environ, OMP_NUM_THREADS="1"))
    return _last_line(port, 400), _last_line(ref, 400)


def test_smoke_gates_hold_under_the_reference_budgets(smokes):
    d = smokes[0]["detail"]
    assert d["lint_ms"] <= overhead.LINT_BUDGET_MS == 30_000
    assert max(d["flightrec_ns_per_event"], d["trace_ns_per_span"]) \
        <= overhead.TELEM_BUDGET_NS == 50_000
    assert d["capture_ns_per_record"] <= d["capture_budget_ns"] \
        <= overhead.CAPTURE_BUDGET_NS == 50_000
    assert d["scrub"]["overhead_frac"] <= overhead.SCRUB_BUDGET_FRAC == 0.01
    assert d["scrub"]["interval_ms"] == 30_000
    assert d["kernel"] == "plain" and d["batch_size"] == 2048
    assert smokes[0]["card"] is None and smokes[0]["vs_baseline"] is None


def test_smoke_keys_equal_the_reference(smokes):
    port, ref = smokes
    assert set(port) == set(ref) | {"card"}
    assert set(port["detail"]) == set(ref["detail"])
    assert sorted(ref["detail"]) == sorted(chip_smoke.BENCH_SMOKE_KEYS)
    assert set(port["detail"]["scrub"]) == set(ref["detail"]["scrub"])


class _StubHandler(BaseHTTPRequestHandler):
    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        self.rfile.read(n)
        body = json.dumps({"ok": True}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_replay_reproduces_schedule():
    """tests/test_capture.py's bound on the port's replay_records: 200
    of 200 answered, no drop, p95 send-time skew within 10% of the
    span."""
    records = corpus.synth_capture_records(n=200, tenants=8,
                                           rate_rps=150.0, seed=11)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _StubHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        out = replay.replay_records(records, srv.server_address[1],
                                    speedup=1.0, clients=8)
    finally:
        srv.shutdown()
        srv.server_close()
    assert out["requests"] == 200 and out["completed"] == 200
    assert out["counts"]["drop"] == 0 and out["counts"]["ok"] == 200
    assert out["schedule"]["skew_frac_p95"] <= 0.10
    top = max(out["tenants"].values(), key=lambda d: d["requests"])
    assert top["requests"] > 200 / 8
    assert math.isfinite(out["sli"]["p99_ms"])


def test_replay_of_nothing_is_empty():
    assert replay.replay_records([], 1) == {"requests": 0,
                                            "error": "empty capture"}


@pytest.mark.parametrize("synth,n", [("zipf", 2000), ("flash_crowd", None)])
def test_replay_streams_load(synth, n):
    records, source = replay.load_records(None, synth)
    assert source == {"synth": synth, "records": len(records)}
    assert len(records) == (n or len(records)) > 0


def test_replay_rejects_an_unknown_stream_and_an_empty_capture(tmp_path):
    with pytest.raises(SystemExit, match="unknown synth stream"):
        replay.load_records(None, "nope")
    with pytest.raises(SystemExit, match="no capture records"):
        replay.load_records(str(tmp_path), None)


@pytest.mark.parametrize("argv,msg", [
    (["--device", "tpu"], "cuda or cpu"),
    (["--bogus", "--device", "cpu"], "unknown mode"),
    (["--replay", "--device", "cpu"], "usage: bench --replay"),
    (["--profile", "--device", "cpu"], "usage: bench"),
    (["--kernel", "--device"], "needs a value")])
def test_cli_refuses_bad_arguments(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        bench_main.run(list(argv))


def test_cli_flag_parsing():
    argv = ["--replay-synth", "burst", "--speedup", "2.5", "--workers", "3"]
    assert bench_main._flag(argv, "--speedup", 1.0, float) == 2.5
    assert bench_main._flag(argv, "--workers", 2, int) == 3
    assert bench_main._flag(argv, "--clients", 8, int) == 8
    assert argv == ["--replay-synth", "burst"]
    assert bench_main._arg(["--fleet"], 3) == 3
    assert bench_main._arg(["--kernel", "1024"], 4096) == 1024
