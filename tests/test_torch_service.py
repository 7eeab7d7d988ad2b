"""The port's service fronts (language_detector_tpu_torch/service/) on the
CPU: the reference's HTTP contract, the circuit breaker under a device
fault storm, the artifact hot swap, flushes past the all-C threshold
reaching the device step, the kernel launch counter under concurrent
flushes, and the refusals (no CUDA, a failing engine build, the
unported shared-memory lane). The fronts serve with device="cpu"
(the plain scorer); the `cuda` test runs the asyncio front on the card.
"""
from __future__ import annotations

import asyncio
import json
import os
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import chip_smoke
from language_detector_tpu_torch import faults, profiling, telemetry
from language_detector_tpu_torch.models import ngram
from language_detector_tpu_torch.ops import kernels
from language_detector_tpu_torch.service import aioserver, server, swap
from language_detector_tpu_torch.service.admission import (
    AdmissionConfig, AdmissionController)
from language_detector_tpu_torch.tables import DATA_DIR
from torch_support import jax_packer

# while this worker collects, before any of its tests run
jax_packer()


EN = ("this is a simple english sentence with common words that should "
      "be detected without any trouble at all")
FR = ("Le gouvernement a annoncé de nouvelles mesures pour aider les "
      "familles concernées")
# over TINY_BATCH_C_PATH (64) documents: the flush reaches score_chunks
STORM_DOCS = [EN, FR] * 40
ARTIFACT = DATA_DIR / "model.ldta"


def _post(url, payload, content_type="application/json", raw=None,
          timeout=60):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, json.loads(body) if body else None


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _threaded(svc):
    httpd, metricsd, svc = server.make_server(0, 0, service=svc)
    for s in (httpd, metricsd):
        threading.Thread(target=s.serve_forever, daemon=True).start()
    return httpd, metricsd


def _stop(httpd, metricsd, svc):
    httpd.shutdown()
    metricsd.shutdown()
    httpd.server_close()
    metricsd.server_close()
    svc.batcher.close()


@pytest.fixture(scope="module")
def front():
    svc = server.DetectorService(device="cpu", max_delay_ms=1.0)
    httpd, metricsd = _threaded(svc)
    yield {"url": f"http://127.0.0.1:{httpd.server_address[1]}",
           "metrics_url": f"http://127.0.0.1:{metricsd.server_address[1]}",
           "svc": svc}
    _stop(httpd, metricsd, svc)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.configure(None)


# -- the reference's HTTP contract (tests/test_service.py) -------------------


def test_usage(front):
    status, body = _get(front["url"] + "/")
    assert status == 200
    doc = json.loads(body)
    assert doc["result"]["id"] == "language-detector"
    assert doc["result"]["out"]["iso6391code"] == {"type": "string"}


def test_not_found(front):
    status, body = _get(front["url"] + "/nope")
    assert status == 404 and json.loads(body) == {"error": "Not found"}


def test_wrong_content_type(front):
    status, body = _post(front["url"], {"request": []},
                         content_type="text/plain")
    assert status == 400
    assert body == {"error": "Content-Type must be set to application/json"}


@pytest.mark.parametrize("raw", [b"{nope", b'{"nope": []}'])
def test_bad_json(front, raw):
    status, body = _post(front["url"], None, raw=raw)
    assert status == 400
    assert body == {"error":
                    "Unable to parse request - invalid JSON detected"}


def test_missing_text_key_keeps_batch_going(front):
    status, body = _post(front["url"], {"request": [
        {"text": FR}, {"wrong": "key"},
        {"text": "こんにちは世界、今日はとても良い天気ですね"}]})
    assert status == 400
    assert body["response"] == [
        {"iso6391code": "fr", "name": "French"},
        {"error": "Missing text key"},
        {"iso6391code": "ja", "name": "Japanese"}]


def test_unknown_language_203(front):
    status, body = _post(front["url"], {"request": [{"text": "?!"}]})
    assert status == 203
    assert body["response"][0] == {"iso6391code": "un", "name": "Unknown"}


def test_empty_request_list(front):
    status, body = _post(front["url"], {"request": []})
    assert status == 200 and body == {"response": []}


def test_oversized_body_rejected(front):
    big = b'{"request": [{"text": "' + b"a" * 1_100_000 + b'"}]}'
    status, body = _post(front["url"], None, raw=big)
    assert status == 413
    assert body == {"error": "Request body exceeds 1MB limit"}
    status, body = _post(front["url"], {"request": [{"text": EN}]})
    assert status == 200 and body["response"][0]["iso6391code"] == "en"


def test_metrics_endpoint(front):
    _post(front["url"], {"request": [{"text": FR}]})
    status, body = _get(front["metrics_url"] + "/metrics")
    assert status == 200
    text = body.decode()
    assert "augmentation_requests_total" in text
    assert 'augmentation_detected_language{language="French"}' in text
    # the port's engine gauges: the default pipeline depth 2, no pool
    assert "ldt_pipeline_depth 2" in text
    assert "ldt_pool_lanes_total 0" in text
    status, body = _get(front["metrics_url"] + "/debug/vars")
    assert status == 200 and json.loads(body)


def test_pipeline_stats_keys_match_reference(front):
    from language_detector_tpu.models import ngram as ref_ngram
    from language_detector_tpu.registry import registry as ref_reg
    from language_detector_tpu.tables import load_tables as ref_load
    ref = ref_ngram.NgramBatchEngine(ref_load(), ref_reg).pipeline_stats()
    got = front["svc"]._engine.pipeline_stats()
    assert sorted(got) == sorted(ref)
    assert got["depth"] == ref["depth"] == 2 and got["kernel"] == "plain"


def test_aio_front_contract(tmp_path):
    fronts = chip_smoke.Fronts(
        "language_detector_tpu_torch",
        lambda srv, threaded: srv.DetectorService(
            start_batcher=threaded, device="cpu", max_delay_ms=1.0),
        str(tmp_path))
    url = f"http://127.0.0.1:{fronts.port['aio']}"
    try:
        status, body = _get(url + "/")
        assert status == 200 and json.loads(body)["result"]
        status, body = _post(url + "/", {"request": [
            {"text": "ภาษาไทยเป็นภาษาที่สวยงามมาก"}, {"nokey": 1}]})
        assert status == 400
        assert body["response"][0]["iso6391code"] == "th"
        assert body["response"][1] == {"error": "Missing text key"}
        status, _ = _post(url + "/", None, raw=b"not json{{")
        assert status == 400
        status, _ = _get(url + "/bogus")
        assert status == 404
        status, body = _get(
            f"http://127.0.0.1:{fronts.metrics_port['aio']}/metrics")
        assert status == 200 and b"augmentation_requests_total" in body
    finally:
        fronts.close()


# -- the device path ---------------------------------------------------------


def test_flush_over_64_docs_goes_through_score_chunks(front, monkeypatch):
    calls = []
    real = kernels.score_chunks

    def counting(dt, p, full_out=False):
        calls.append(int(p["cnsl"].numel()))
        return real(dt, p, full_out)

    monkeypatch.setattr(kernels, "score_chunks", counting)
    eng = front["svc"]._engine
    before = eng.stats_snapshot()
    status, body = _post(front["url"],
                         {"request": [{"text": t} for t in STORM_DOCS]})
    assert status == 200
    assert [r["iso6391code"] for r in body["response"][:2]] == ["en", "fr"]
    after = eng.stats_snapshot()
    assert calls
    assert after["device_dispatches"] - before["device_dispatches"] == \
        len(calls)
    assert after["c_path_docs"] == before["c_path_docs"]


def test_launch_counter_is_exact_across_threads():
    """kernels.count_launch from many threads at a short switch
    interval: a lost update would leave the count short."""
    old = sys.getswitchinterval()
    base = kernels.launches
    n_threads, per = 16, 2000

    def bump():
        for _ in range(per):
            kernels.count_launch()

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kernels.launches - base == n_threads * per


def test_concurrent_flushes_retire_every_launch(front):
    """Eight clients at once: flushes run on the batcher's workers
    concurrently, every one reaches the device step, and each client
    gets its own documents' answers back in order."""
    import concurrent.futures
    eng = front["svc"]._engine
    texts = [STORM_DOCS[i:] + STORM_DOCS[:i] for i in range(8)]
    payloads = [{"request": [{"text": t} for t in ts]} for ts in texts]
    before = eng.stats_snapshot()["device_dispatches"]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda p: _post(front["url"], p), payloads))
    assert all(status == 200 for status, _ in got)
    for ts, (_, body) in zip(texts, got):
        assert [r["iso6391code"] for r in body["response"]] == \
            ["en" if t == EN else "fr" for t in ts]
    assert eng.stats_snapshot()["device_dispatches"] > before


# -- refusals ----------------------------------------------------------------


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device serves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.DetectorService(start_batcher=False)


def test_failed_engine_build_is_not_swallowed(monkeypatch):
    def broken(*a, **k):
        raise ImportError("no native packer")

    monkeypatch.setattr(ngram.NgramBatchEngine, "__init__", broken)
    with pytest.raises(ImportError, match="no native packer"):
        server.DetectorService(device="cpu", start_batcher=False)


def test_shared_cache_tier_is_refused(monkeypatch, tmp_path):
    """The fleet-shared result-cache tier, refused before the fleet was
    ported (the test keeps its name from then), is served now: a
    service asked for it
    (LDT_RESULT_CACHE_SHM_MB) attaches the table and its metrics read
    the tier's live stats."""
    from language_detector_tpu_torch.service import sharedcache
    monkeypatch.setenv("LDT_RESULT_CACHE_SHM_MB", "4")
    monkeypatch.setenv("LDT_RESULT_CACHE_MB", "1")
    monkeypatch.setenv("LDT_SHARED_CACHE_FILE", str(tmp_path / "c.bin"))
    sharedcache.reset_shared_tier()
    svc = server.DetectorService(device="cpu", max_delay_ms=1.0)
    try:
        assert svc.detect_codes([EN, FR]) == ["en", "fr"]
        st = svc.metrics.shared_cache_stats()
        assert st["path"] == str(tmp_path / "c.bin")
        assert st["misses"] >= 2
    finally:
        svc.batcher.close()
        sharedcache.reset_shared_tier()


def test_shm_lane_is_refused(monkeypatch, tmp_path):
    """The shared-memory ring lane, refused before it was ported (the
    test keeps its name from then), is served now: the asyncio front
    started with LDT_SHM_DIR answers a ring frame with the bytes the
    unix-socket lane gives the same body."""
    from language_detector_tpu_torch.service import shmring, wire
    monkeypatch.setenv("LDT_SHM_DIR", str(tmp_path))
    assert not hasattr(server, "refuse_shm_lane")
    svc = server.DetectorService(device="cpu", start_batcher=False)
    box: dict = {}
    started = threading.Event()

    async def run():
        loop = asyncio.get_running_loop()
        ready = loop.create_future()
        box["loop"] = loop
        box["task"] = loop.create_task(aioserver.serve(0, 0, svc=svc,
                                                       ready=ready))
        await ready
        started.set()
        try:
            await box["task"]
        except asyncio.CancelledError:
            pass

    t = threading.Thread(target=asyncio.run, args=(run(),), daemon=True)
    t.start()
    assert started.wait(60)
    cli = shmring.RingClient(str(tmp_path))
    try:
        cli.wait_attached(10.0)
        body = json.dumps({"request": [{"text": EN}, {"text": FR},
                                       {"nokey": 1}]}).encode()
        got = cli.request(body, timeout=30.0)
        ref = server.DetectorService(device="cpu", max_delay_ms=1.0)
        try:
            st, bufs = wire.handle_frame(ref, body)
        finally:
            ref.batcher.close()
        assert got == (st, b"".join(bufs))
        assert json.loads(got[1])["response"][0]["iso6391code"] == "en"
        assert svc.metrics.shm_stats()["frames"] == 1
        assert svc.metrics.quarantine_stats()["quarantined_docs"] == 0
    finally:
        cli.close(unlink=True)
        box["loop"].call_soon_threadsafe(box["task"].cancel)
        t.join(30)


def test_scalar_service_on_request(front):
    """use_device=False stays the caller's explicit scalar service."""
    svc = server.DetectorService(use_device=False, max_delay_ms=1.0)
    try:
        assert svc._engine is None
        assert svc.detect_codes([EN, FR]) == ["en", "fr"]
    finally:
        svc.batcher.close()


# -- breaker storm (tests/test_faults.py) ------------------------------------


@pytest.fixture()
def storm_front():
    ctrl = AdmissionController(AdmissionConfig(breaker_failures=2,
                                               breaker_cooldown_sec=0.2))
    svc = server.DetectorService(device="cpu", max_delay_ms=1.0,
                                 admission=ctrl)
    httpd, metricsd = _threaded(svc)
    yield {"url": f"http://127.0.0.1:{httpd.server_address[1]}",
           "svc": svc, "ctrl": ctrl}
    _stop(httpd, metricsd, svc)


def _post_headers(url, payload):
    """POST; returns (status, response headers, parsed body)."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json",
                 "X-LDT-Request-Id": "storm-1"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def test_breaker_storm_opens_then_halfopen_recovers(storm_front):
    """The device service's breaker under a device_flush storm: typed
    500s until it opens, then 503s with Retry-After (the flushes are
    shed, never moved to the scalar engine), then a half-open probe
    closes it and the answers equal the JAX front's."""
    from language_detector_tpu.service.server import \
        DetectorService as RefService
    url = storm_front["url"]
    br = storm_front["ctrl"].breaker
    payload = {"request": [{"text": t} for t in STORM_DOCS]}
    ref = RefService(use_device=False, start_batcher=False)
    want = ref.scalar_codes(STORM_DOCS)

    status, body = _post(url, payload)
    assert status == 200
    assert [r["iso6391code"] for r in body["response"]] == want
    trips0 = br.stats()["trips"]
    scalar0 = telemetry.REGISTRY.stage_percentiles().get(
        "scalar_detect", {}).get("count", 0)

    # storm: every device fetch dies; typed 500s until the breaker
    # opens, then every flush is shed with a 503
    faults.configure("device_flush:error:p=1")
    statuses = []
    while br.stats()["state"] != 2 and len(statuses) < 10:
        status, body = _post(url, payload)
        statuses.append(status)
        assert status == 500 and body == {"error": "internal error"}
    assert br.stats()["state"] == 2
    assert br.stats()["trips"] == trips0 + 1
    status, headers, body = _post_headers(url, payload)
    assert status == 503
    assert body == {"error": "device unavailable: circuit breaker open"}
    assert int(headers["Retry-After"]) >= 1
    assert headers["X-LDT-Request-Id"] == "storm-1"
    assert telemetry.REGISTRY.stage_percentiles().get(
        "scalar_detect", {}).get("count", 0) == scalar0
    status, body = _get(url + "/readyz")
    assert status == 503 and json.loads(body)["breaker"] == "open"

    # heal, wait out the cooldown: the half-open probe closes it
    faults.configure(None)
    probes0 = br.stats()["probes"]
    time.sleep(0.25)
    status, body = _post(url, payload)
    assert status == 200
    assert [r["iso6391code"] for r in body["response"]] == want
    assert br.stats()["state"] == 0
    assert br.stats()["probes"] == probes0 + 1
    assert telemetry.REGISTRY.counter_value(
        "ldt_fault_injected_total", point="device_flush") >= 2
    assert telemetry.REGISTRY.stage_percentiles().get(
        "scalar_detect", {}).get("count", 0) == scalar0


def test_brownout_sheds_on_the_device_service(storm_front):
    """Brownout level 2 on the device service sheds non-priority
    traffic (503) instead of degrading to the scalar engine; priority
    traffic stays on the device path. The scalar service keeps the
    reference's level-2 degrade."""
    ctrl = storm_front["ctrl"]
    assert not ctrl.degrade_to_scalar and ctrl.shed_level() == 2
    with ctrl.ladder._lock:
        ctrl.ladder.level, ctrl.ladder.ema = 2, 1.0
    eng = storm_front["svc"]._engine
    before = eng.stats_snapshot()["device_dispatches"]
    admit = ctrl.try_admit(STORM_DOCS)
    assert admit.shed and admit.status == 503
    assert admit.reason == "brownout"
    admit = ctrl.try_admit(STORM_DOCS, priority=True)
    assert not admit.shed and not admit.degrade
    ctrl.release(admit)
    with ctrl.ladder._lock:
        ctrl.ladder.level, ctrl.ladder.ema = 2, 1.0
    status, body = _get(storm_front["url"] + "/readyz")
    assert status == 503 and json.loads(body)["brownout_level"] == 2
    req = urllib.request.Request(
        storm_front["url"],
        data=json.dumps({"request": [{"text": t}
                                     for t in STORM_DOCS]}).encode(),
        method="POST", headers={"Content-Type": "application/json",
                                "X-LDT-Priority": "1"})
    with ctrl.ladder._lock:
        ctrl.ladder.level, ctrl.ladder.ema = 2, 1.0
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200
        assert [r["iso6391code"] for r in
                json.loads(resp.read())["response"][:2]] == ["en", "fr"]
    assert eng.stats_snapshot()["device_dispatches"] > before
    with pytest.raises(RuntimeError, match="scalar engine"):
        storm_front["svc"].scalar_codes([EN])
    scalar = AdmissionController(AdmissionConfig())
    assert scalar.degrade_to_scalar and scalar.shed_level() == 3


# -- hot swap (tests/test_swap.py) -------------------------------------------


def test_hot_swap_keeps_answers_and_stats(front, tmp_path):
    svc = front["svc"]
    payload = {"request": [{"text": t} for t in STORM_DOCS]}
    status, before_body = _post(front["url"], payload)
    assert status == 200
    old = svc._engine
    before = old.stats_snapshot()
    path = shutil.copy(ARTIFACT, tmp_path / "new.ldta")
    info = swap.swap_artifact(svc, path)
    assert info["swapped"] and info["engine"]
    assert svc._engine is not old
    assert svc._engine.device == old.device
    assert svc._engine.stats_snapshot() == before
    status, body = _post(front["url"], payload)
    assert status == 200 and body == before_body
    assert svc._engine.stats_snapshot()["device_dispatches"] > \
        before["device_dispatches"]


JA = "こんにちは世界、今日はとても良い天気ですね"
TH = "ภาษาไทยเป็นภาษาที่สวยงามมาก"
# distinct texts (no dedup), Latin ones change answer without quadgrams
SWAP_DOCS = [t + f" {i}" for i in range(24) for t in (EN, FR, JA, TH)]


def _no_quad_artifact(tmp_path):
    """The shipped artifact without its quadgram tables: another
    artifact whose Latin-script answers differ (they detect unknown)
    while CJK and Thai stay."""
    from language_detector_tpu_torch import artifact
    arrays = {k: v for k, v in artifact.load_artifact(ARTIFACT).items()
              if not k.startswith("q/")}
    path = tmp_path / "noquad.ldta"
    artifact.write_artifact(arrays, path)
    return path


def _scalar_codes(tables, texts):
    from language_detector_tpu_torch.engine_scalar import detect_scalar
    from language_detector_tpu_torch.registry import registry
    return [registry.code(detect_scalar(t, tables, registry).summary_lang)
            for t in texts]


def test_packer_tables_take_turns_across_threads(tmp_path):
    """Two table sets used at once from many threads: the native
    library holds one set for the process, and every call must still
    read its own (none frees or overwrites the other's mid-call)."""
    import concurrent.futures
    from language_detector_tpu_torch import native
    from language_detector_tpu_torch.registry import registry
    from language_detector_tpu_torch.tables import (ScoringTables,
                                                   load_tables)
    with pytest.warns(UserWarning, match="without quad tables"):
        other = ScoringTables.load_mmap(_no_quad_artifact(tmp_path))
    sets = (load_tables(), other)
    texts = SWAP_DOCS[:40]
    want = [native.detect_batch_codes_native(texts, t, registry).tolist()
            for t in sets]
    assert want[0] != want[1]

    def run(i):
        k = i % 2
        if i % 3:
            got = native.detect_batch_codes_native(texts, sets[k],
                                                   registry).tolist()
        else:
            cb = native.pack_chunks_native(texts, sets[k], registry)
            got = None if cb.n_docs != len(texts) else want[k]
        return k, got

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for k, got in pool.map(run, range(96)):
            assert got == want[k]


def test_swap_onto_another_artifact_under_load(tmp_path):
    """A hot swap onto a DIFFERENT artifact while clients keep
    flushing: every response is wholly the old tables' answers or
    wholly the new ones', and after the swap the service answers as
    the scalar engine over the new artifact."""
    import concurrent.futures
    from language_detector_tpu_torch.tables import (ScoringTables,
                                                   load_tables)
    path = _no_quad_artifact(tmp_path)
    with pytest.warns(UserWarning, match="without quad tables"):
        new_tables = ScoringTables.load_mmap(path)
    old_want = _scalar_codes(load_tables(), SWAP_DOCS)
    new_want = _scalar_codes(new_tables, SWAP_DOCS)
    assert old_want != new_want
    svc = server.DetectorService(device="cpu", max_delay_ms=1.0)
    httpd, metricsd = _threaded(svc)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    stop = threading.Event()

    def client(r):
        texts = SWAP_DOCS[r:] + SWAP_DOCS[:r]
        wants = (old_want[r:] + old_want[:r], new_want[r:] + new_want[:r])
        seen = []
        while not stop.is_set():
            status, body = _post(url, {"request": [{"text": t}
                                                   for t in texts]})
            assert status in (200, 203)
            codes = [x["iso6391code"] for x in body["response"]]
            assert codes in wants
            seen.append(wants.index(codes))
        return seen

    try:
        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            runs = [pool.submit(client, 7 * r) for r in range(6)]
            time.sleep(0.5)
            with pytest.warns(UserWarning, match="without quad tables"):
                info = swap.swap_artifact(svc, path)
            assert info["swapped"] and info["engine"]
            time.sleep(0.5)
            stop.set()
            seen = [x for f in runs for x in f.result(timeout=120)]
        assert 0 in seen
        status, body = _post(url, {"request": [{"text": t}
                                               for t in SWAP_DOCS]})
        assert [x["iso6391code"] for x in body["response"]] == new_want
    finally:
        stop.set()
        _stop(httpd, metricsd, svc)


def test_post_swap_on_metrics_port(front, tmp_path):
    path = shutil.copy(ARTIFACT, tmp_path / "post.ldta")
    status, body = _post(front["metrics_url"] + "/swap", {"path": str(path)})
    assert status == 200 and body["swapped"]
    bad = tmp_path / "bad.ldta"
    bad.write_bytes(b"garbage")
    status, body = _post(front["metrics_url"] + "/swap", {"path": str(bad)})
    assert status == 409


# -- profiling ---------------------------------------------------------------


def test_profilez_writes_a_torch_profiler_trace(monkeypatch, tmp_path):
    monkeypatch.setenv("LDT_PROFILE_DIR", str(tmp_path))
    status, payload = profiling.arm(window_sec=0.05)
    assert status == 200
    assert profiling.arm()[0] == 409
    trace = os.path.join(payload["dir"], "trace.json")
    deadline = time.time() + 30
    while not os.path.exists(trace) and time.time() < deadline:
        time.sleep(0.05)
    assert profiling.active() is None
    assert os.path.exists(trace)


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_aio_front_on_card_equals_cpu_front(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    bodies = [json.dumps({"request": [{"text": t} for t in STORM_DOCS]}
                         ).encode()] * 2
    cpu = chip_smoke.Fronts(
        "language_detector_tpu_torch",
        lambda srv, threaded: srv.DetectorService(
            start_batcher=threaded, device="cpu"), str(tmp_path / "c"))
    try:
        want = chip_smoke.drive_lane(cpu, "aio-http", bodies, 2)[0]
    finally:
        cpu.close()
    card = chip_smoke.Fronts("language_detector_tpu_torch",
                             chip_smoke.port_service, str(tmp_path / "g"))
    try:
        assert card.svc["aio"]._engine.device.type == "cuda"
        assert kernels._lib is not None     # loaded with the engine
        n0 = kernels.launches
        got = chip_smoke.drive_lane(card, "aio-http", bodies, 2)[0]
        assert kernels.launches > n0
    finally:
        card.close()
    assert got == want
