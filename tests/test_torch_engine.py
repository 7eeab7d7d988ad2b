"""The torch port's engine answers exactly like the reference engine.

On the CPU (device="cpu": the plain PyTorch scorer) the port's packer,
tables and engine are held against the reference package's on the same
documents: packer wires array for array, device tables plane for plane,
and detect_batch / detect_codes answers byte for byte, hints, HTML
input and chunk vectors included. Also: an engine built without a device
on a host with no CUDA raises, and the port runs without importing jax
or the reference package.
"""
from __future__ import annotations

import dataclasses
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from language_detector_tpu import native as jnative
from language_detector_tpu.detector import LanguageDetector as JaxDetector
from language_detector_tpu.registry import registry as jreg
from language_detector_tpu.tables import load_tables as jload_tables
from language_detector_tpu_torch import native as tnative
from language_detector_tpu_torch.detector import \
    LanguageDetector as TorchDetector
from language_detector_tpu_torch.engine_scalar import (FLAG_FINISH,
                                                       FLAG_REPEATS,
                                                       FLAG_TOP40,
                                                       detect_scalar)
from language_detector_tpu_torch.models.ngram import NgramBatchEngine
from language_detector_tpu_torch.ops import device_tables as tdev
from language_detector_tpu_torch.registry import registry as treg
from language_detector_tpu_torch.tables import DATA_DIR
from language_detector_tpu_torch.tables import load_tables as tload_tables
from torch_support import jax_packer, lost_workers

# while this worker collects, before any of its tests run
jax_packer()


REPO = Path(__file__).resolve().parent.parent


def _eval_docs() -> list[str]:
    return [ln.split("\t", 1)[1].rstrip("\n") for ln in
            open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")]


def _edge_docs(seed: int = 20261016) -> list[str]:
    """Short, mixed-script, squeeze-spam, gate-failing, empty and long
    documents built from the eval corpus."""
    docs = _eval_docs()
    rng = random.Random(seed)
    out = ["", " ", "\n\t ", "a", "123 456 789", "!!! ??? ...",
           "🎉🎊🎈 🎉🎊🎈", "x" * 300, "word " + "a" * 50 + " end",
           ("buy cheap now " * 400).strip(), "word " * 600,
           "The quick brown fox. " + "spam ham " * 300,
           "hello \udcd9 world this is english text with a surrogate"]
    for i in range(40):                # gate-failing mixed composites
        out.append(docs[i][:150] + " " + docs[(i * 7 + 3) % len(docs)][:150])
    for _ in range(40):                # mid-word slices
        t = rng.choice(docs)
        lo = rng.randrange(max(1, len(t) - 60))
        out.append(t[lo:lo + rng.randint(1, 60)])
    for _ in range(20):                # repetitive spam of a snippet
        out.append((rng.choice(docs)[:rng.randint(5, 30)] + " ")
                   * rng.randint(50, 300))
    for _ in range(4):                 # long multi-paragraph documents
        out.append(" ".join(rng.choice(docs)
                            for _ in range(rng.randint(40, 120))))
    out.append("".join(chr(rng.randrange(0x4E00, 0x9FFF))
                       for _ in range(2000)))
    return out


@pytest.fixture(scope="module")
def corpus() -> list[str]:
    return _eval_docs() + _edge_docs()


@pytest.fixture(scope="module")
def jax_engine():
    from language_detector_tpu.models.ngram import \
        NgramBatchEngine as JaxEngine
    return JaxEngine()


@pytest.fixture(scope="module")
def cpu_engine():
    return NgramBatchEngine(device="cpu")


def _wire_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("flags", [0, FLAG_TOP40 | FLAG_REPEATS | FLAG_FINISH],
                         ids=["plain", "retry-flags"])
def test_packer_wires_equal_reference(corpus, flags):
    """The copied C++ packer builds the reference packer's wire array
    for array (and the same per-doc host arrays)."""
    cj = jnative.pack_chunks_native(corpus, jload_tables(), jreg,
                                    flags=flags)
    ct = tnative.pack_chunks_native(corpus, tload_tables(), treg,
                                    flags=flags)
    _wire_equal(cj.wire, ct.wire)
    for f in ("doc_chunk_start", "direct_adds", "text_bytes", "fallback",
              "squeezed", "n_slots", "n_chunks"):
        assert np.array_equal(getattr(cj, f), getattr(ct, f)), f


def test_native_libraries_are_the_ports_own():
    """The port loads its own packer build, never the reference's
    libldtpack.so (their table state must not alias in one process)."""
    assert tnative.available()
    assert tnative._SO.name == "libldtpack_torch.so"
    assert tnative._SO.parent.parent.name == "language_detector_tpu_torch"


def test_jax_packer_loaded_in_every_worker():
    """No worker of this test run lost the JAX package's first-use
    native build (a worker that did skips the JAX tests whose module
    skip marks it evaluated before torch_support.jax_packer repaired
    it; the JAX loader's own build lock is ROADMAP queue C)."""
    assert not lost_workers(), (
        f"the JAX package's native packer failed to load at first in "
        f"{lost_workers()}: JAX tests there were skipped")


def _jax_planes(jdt) -> dict:
    planes = {f.name: getattr(jdt, f.name)
              for f in dataclasses.fields(jdt)}
    planes["kind_tbl"] = {f.name: np.asarray(getattr(jdt.kind_tbl, f.name))
                          for f in dataclasses.fields(jdt.kind_tbl)}
    return {k: (v if k == "kind_tbl" else np.asarray(v))
            for k, v in planes.items()
            if k not in ("kind_tbl2", "quad2_enabled")}


def test_device_tables_from_numpy_matches_from_host(jax_engine,
                                                    cpu_engine):
    """Tables carried over from the reference's planes equal the port's
    own upload plane for plane, and the fingerprints line up with the
    reference's."""
    from language_detector_tpu.ops.device_tables import \
        fingerprint as jfingerprint
    carried = tdev.device_tables_from_numpy(_jax_planes(jax_engine.dt),
                                            "cpu")
    own = cpu_engine.dt
    a, b = carried.to_numpy(), own.to_numpy()
    for name in tdev.PLANES:
        assert a[name].dtype == b[name].dtype, name
        assert np.array_equal(a[name], b[name]), name
    assert tdev.fingerprint(carried) == tdev.fingerprint(own) == \
        jfingerprint(jax_engine.dt)
    assert len(tdev.PLANES) == len(jfingerprint(jax_engine.dt))


def _rows(results) -> list:
    return [(r.summary_lang, tuple(r.language3), tuple(r.percent3),
             tuple(r.normalized_score3), r.text_bytes, r.is_reliable)
            for r in results]


def test_detect_batch_matches_reference(corpus):
    """LanguageDetector.detect_batch: byte-identical answers on the eval
    corpus plus the edge documents (one > 64-doc batch)."""
    jd = JaxDetector()
    td = TorchDetector(device="cpu")
    want = jd.detect_batch(corpus)
    got = td.detect_batch(corpus)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]


def test_engine_detect_batch_matches_reference(corpus, jax_engine,
                                               cpu_engine):
    """NgramBatchEngine.detect_batch result rows, and their agreement
    with the scalar engine on a sample."""
    got = _rows(cpu_engine.detect_batch(corpus))
    assert got == _rows(jax_engine.detect_batch(corpus))
    for i in range(0, len(corpus), 9):
        want = detect_scalar(corpus[i], cpu_engine.tables, cpu_engine.reg)
        assert got[i] == _rows([want])[0], corpus[i][:60]


@pytest.mark.parametrize("size", ["device-path", "c-path"])
def test_detect_codes_matches_reference(corpus, jax_engine, cpu_engine,
                                        size):
    """detect_codes on a > 64-doc batch (device path, gate retries
    included) and on a <= 64-doc batch (the all-C path)."""
    docs = corpus if size == "device-path" else corpus[-60:]
    before = cpu_engine.stats_snapshot()
    got = cpu_engine.detect_codes(docs)
    assert got == jax_engine.detect_codes(docs)
    after = cpu_engine.stats_snapshot()
    if size == "device-path":
        assert after["device_dispatches"] > before["device_dispatches"]
        assert after["scalar_recursion_docs"] > \
            before["scalar_recursion_docs"]
    else:
        assert after["c_path_docs"] == before["c_path_docs"] + len(docs)


def test_multi_slice_stream_matches_reference(corpus, jax_engine,
                                              cpu_engine):
    """A ragged multi-slice stream (one deferred retry pass) answers
    exactly like the reference's one-call codes."""
    want = jax_engine.detect_codes(corpus)
    assert cpu_engine.detect_codes(corpus, batch_size=29) == want
    assert [r.summary_lang for r in
            cpu_engine.detect_many(corpus, batch_size=29)] == \
        [jreg.code_to_lang[c] for c in want]


def test_no_device_means_cuda_and_raises_without_it():
    """Entry points resolve device=None to CUDA; without CUDA they
    raise instead of dropping to the CPU or the scalar engine."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        NgramBatchEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchDetector()


def test_hints_html_and_chunks_answer_like_reference(cpu_engine,
                                                     jax_engine):
    """hints, is_plain_text=False and return_chunks=True answer through
    LanguageDetector.detect, LanguageDetector.detect_batch and
    NgramBatchEngine.detect_batch exactly as the JAX detector and engine
    do, on "hello world" and a mixed-script document."""
    from language_detector_tpu.hints import CLDHints as JaxHints
    from language_detector_tpu_torch.hints import CLDHints
    docs = ["hello world",
            "This is English text mixed with 日本語のテキストです。"
            "東京は日本の首都 and Это русский текст <b>too</b>."]
    td, jd = TorchDetector(device="cpu"), JaxDetector()
    for kw, jkw in (
            ({"hints": CLDHints(content_language_hint="ja", tld_hint="ru")},
             {"hints": JaxHints(content_language_hint="ja",
                                tld_hint="ru")}),
            ({"is_plain_text": False}, {"is_plain_text": False}),
            ({"return_chunks": True}, {"return_chunks": True})):
        assert [dataclasses.astuple(r) for r in
                td.detect_batch(docs, **kw)] == \
            [dataclasses.astuple(r) for r in jd.detect_batch(docs, **jkw)]
        got = cpu_engine.detect_batch(docs, **kw)
        want = jax_engine.detect_batch(docs, **jkw)
        assert _rows(got) == _rows(want)
        assert [[(c.offset, c.bytes, c.lang1) for c in r.chunks or []]
                for r in got] == \
            [[(c.offset, c.bytes, c.lang1) for c in r.chunks or []]
             for r in want]
        for d in docs:
            assert dataclasses.astuple(td.detect(d, **kw)) == \
                dataclasses.astuple(jd.detect(d, **jkw))


def test_port_imports_neither_jax_nor_reference():
    """A fresh process that imports every module of the port
    (pkgutil.walk_packages, the service fronts included) and runs CPU
    plain, hinted, HTML, span, chunk-vector and service calls, a
    detect_codes call through the stream scheduler (dedup, tier lanes,
    the long-doc lane, depth 2), and the traffic model, the autotuner
    and a score trace (aot, loadgen, autotune and debug among the
    modules), holds no jax* and no language_detector_tpu module."""
    code = (
        "import importlib.util, pkgutil, sys\n"
        "import language_detector_tpu_torch as lt\n"
        "mods = [m.name for m in pkgutil.walk_packages(lt.__path__,\n"
        "        'language_detector_tpu_torch.')\n"
        "        if importlib.util.find_spec(m.name).origin.endswith('.py')]"
        "\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'language_detector_tpu_torch.service.aioserver' in mods\n"
        "for m in ('aot', 'loadgen', 'autotune', 'debug'):\n"
        "    assert 'language_detector_tpu_torch.' + m in mods, m\n"
        "from language_detector_tpu_torch import autotune, debug, loadgen\n"
        "recs = loadgen.generate('flash_crowd', n=50, seed=7)\n"
        "assert len(recs) == 50\n"
        "res = autotune.autotune(lambda ov: {'p99_ms': 1.0, 'err_pct': 0.0,"
        "\n"
        "    'ok_docs_per_sec': 1.0}, names={'LDT_MAX_INFLIGHT'}, rounds=1)\n"
        "assert res['evals'] >= 1\n"
        "assert 'summary' in debug.format_trace(debug.trace_detect('hello "
        "world'))\n"
        "from language_detector_tpu_torch.tables import DATA_DIR\n"
        "ln = open(DATA_DIR / 'eval_corpus.tsv', encoding='utf-8')"
        ".readline()\n"
        "d = lt.LanguageDetector(device='cpu')\n"
        "doc = ln.split('\\t', 1)[1]\n"
        "r = d.detect_batch([doc] * 70)\n"
        "assert r[0].language == ln.split('\\t')[0], r[0]\n"
        "h = lt.CLDHints(content_language_hint='id')\n"
        "assert d.detect_batch([doc] * 3, hints=h)[0].language\n"
        "assert d.detect_batch(['<p lang=fr>' + doc + '</p>'],\n"
        "                      is_plain_text=False)[0].language\n"
        "assert d.detect_spans([doc + ' ' + doc])[0].spans\n"
        "assert d.detect_batch([doc], return_chunks=True)[0].chunks\n"
        "assert lt.detect_language_version().startswith('V')\n"
        "from language_detector_tpu_torch.service.server import "
        "DetectorService\n"
        "svc = DetectorService(device='cpu', max_delay_ms=1.0)\n"
        "assert svc.detect_codes([doc] * 70)[0] == ln.split('\\t')[0]\n"
        "svc.batcher.close()\n"
        "lines = [x.split('\\t', 1)[1] for x in\n"
        "         open(DATA_DIR / 'eval_corpus.tsv', encoding='utf-8')]\n"
        "many = [f'{lines[i % len(lines)]} {i}' for i in range(1100)]\n"
        "many += [' '.join(lines)] + many[:50]\n"
        "from language_detector_tpu_torch.models.ngram import "
        "NgramBatchEngine\n"
        "e = NgramBatchEngine(device='cpu', longdoc_chunk_slots=1024)\n"
        "assert len(e.detect_codes(many)) == len(many)\n"
        "st = e.stats_snapshot()\n"
        "assert st['dedup_docs'] == 50 and st['longdoc_split_docs'] == 1\n"
        "assert st['tier_short_dispatches'] + st['tier_mid_dispatches']\n"
        "assert e.pipeline_stats()['depth'] == 2\n"
        "bad = [m for m in sys.modules if m.startswith('jax') or "
        "m == 'language_detector_tpu'"
        " or m.startswith('language_detector_tpu.')]\n"
        "print('BAD', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout
