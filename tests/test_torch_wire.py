"""The port's service fronts against the reference package's, byte for
byte, on the CPU.

Both packages serve in this process on ephemeral ports, each with its
asyncio front (`serve`, unix-socket lane through LDT_UNIX_SOCKET) and
its threaded front (`make_server` plus `wire.UnixFrameServer`), started
by chip_smoke.Fronts, the helper the card's `service` phase uses. The
reference serves with DetectorService(use_device=False) (its scalar
engine) and, in one test, use_device=True on JAX's CPU backend; the
port serves through its batched engine with device="cpu" (the plain
scorer). Every (status, echoed request id, payload bytes) must be
equal: tests/test_wire.py's CASES bodies on every lane with the fast
request scanner on and off, and tests/test_service.py's requests, over
HTTP and over v1 and v2 frames. Tolerance: zero differing bytes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

import chip_smoke
from language_detector_tpu_torch.tables import DATA_DIR
from torch_support import jax_packer

# while this worker collects, before any of its tests run
jax_packer()


ROOT = Path(__file__).resolve().parent.parent

EN = ("this is a simple english sentence with common words that should "
      "be detected without any trouble at all")
FR = ("Le gouvernement a annoncé de nouvelles mesures pour aider les "
      "familles concernées")
JA = "こんにちは世界、今日はとても良い天気ですね"


def _body(items) -> bytes:
    return json.dumps({"request": items}).encode()


def _corpus_body(n: int) -> bytes:
    """n eval-corpus documents in one request: over 64, the port's
    flush goes through the engine's device path, not the all-C one."""
    lines = open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8") \
        .read().splitlines()
    return _body([{"text": ln.split("\t", 1)[1]} for ln in lines[:n]])


# tests/test_service.py's requests, as bodies
SERVICE_BODIES = [
    _body([{"text": EN}]),
    _body([{"text": FR}, {"wrong": "key"}, {"text": JA}]),
    _body([{"text": "@someone https://t.co/xyz " + FR}]),
    _body([{"text": "?!"}]),
    _body([]),
    b'{"nope": []}',
    b"{nope",
    _body([{"text": t} for t in (
        "le monde est grand et la vie est belle pour tous les hommes",
        "buy cheap now " * 300,
        " ".join("Le gouvernement a annoncé de nouvelles mesures."
                 for _ in range(120)),
        "",
        "国民の大多数が内閣を支持し、集団的自衛権の行使を認める判断を")]),
    _body([{"text": "ภาษาไทยเป็นภาษาที่สวยงามมาก"}, {"nokey": 1}]),
    _corpus_body(100),
]


def _port_service(server, threaded):
    return server.DetectorService(start_batcher=threaded, device="cpu",
                                  max_delay_ms=1.0)


def _reference_service(server, threaded):
    return server.DetectorService(use_device=False,
                                  start_batcher=threaded,
                                  max_delay_ms=1.0)


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    port = chip_smoke.Fronts("language_detector_tpu_torch",
                             _port_service,
                             str(tmp_path_factory.mktemp("port")))
    ref = chip_smoke.Fronts("language_detector_tpu", _reference_service,
                            str(tmp_path_factory.mktemp("ref")))
    yield port, ref
    port.close()
    ref.close()


def test_wire_cases_copy_matches_reference_corpus():
    """chip_smoke.WIRE_CASES is tests/test_wire.py's CASES, unchanged."""
    spec = importlib.util.spec_from_file_location(
        "_reference_test_wire", ROOT / "tests" / "test_wire.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert chip_smoke.WIRE_CASES == mod.CASES


@pytest.mark.parametrize("fast", ["1", "0"])
@pytest.mark.parametrize("lane", chip_smoke.SERVICE_LANES)
def test_wire_cases_bytes_equal_reference(fronts, monkeypatch, lane, fast):
    monkeypatch.setenv("LDT_WIRE_FASTPATH", fast)
    port, ref = fronts
    got = chip_smoke.drive_lane(port, lane, chip_smoke.WIRE_CASES, 1)[0]
    want = chip_smoke.drive_lane(ref, lane, chip_smoke.WIRE_CASES, 1)[0]
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert len(got) == len(want) and not bad, \
        [(chip_smoke.WIRE_CASES[i][:60], got[i][:2], want[i][:2])
         for i in bad[:3]]


@pytest.mark.parametrize("lane", chip_smoke.SERVICE_LANES)
def test_service_requests_bytes_equal_reference(fronts, lane):
    """Per-item errors, 203s, empty lists, bad JSON, mention stripping,
    mixed traffic and a 100-document request, from 4 concurrent
    clients; the request ids ride as headers and v2 frame fields (v1
    frames on odd requests)."""
    port, ref = fronts
    bodies = SERVICE_BODIES * 2
    got = chip_smoke.drive_lane(port, lane, bodies, 4)[0]
    want = chip_smoke.drive_lane(ref, lane, bodies, 4)[0]
    assert got == want
    if lane.endswith("uds"):
        assert got[0][1] == f"{lane}-0" and got[1][1] is None
    else:
        assert got[1][1] == f"{lane}-1"


def test_jax_device_front_bytes_equal(tmp_path):
    """The reference's production configuration (use_device=True, its
    batched engine on JAX's CPU backend) against the port's, on every
    lane: a 100-document flush goes through both packages' device
    steps."""
    port = chip_smoke.Fronts("language_detector_tpu_torch", _port_service,
                             str(tmp_path / "p"))
    ref = chip_smoke.Fronts(
        "language_detector_tpu",
        lambda server, threaded: server.DetectorService(
            use_device=True, start_batcher=threaded, max_delay_ms=1.0),
        str(tmp_path / "r"))
    try:
        assert all(s._engine is not None for s in ref.svc.values())
        bodies = [SERVICE_BODIES[1], SERVICE_BODIES[-1],
                  SERVICE_BODIES[-3]]
        for lane in chip_smoke.SERVICE_LANES:
            assert chip_smoke.drive_lane(port, lane, bodies, 2)[0] == \
                chip_smoke.drive_lane(ref, lane, bodies, 2)[0]
    finally:
        port.close()
        ref.close()
