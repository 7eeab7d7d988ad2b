"""The port's divergence soak (tools/soak.py) and its documents
(tools/fuzz.py), on the CPU.

The fuzz soup equals tests/test_batch_agreement.py's document for
document on the same seed and texts, and the bench corpus equals
bench.py's. Every soak path answers as the scalar engine on a slice of
its own documents at the reference's seeds, and a seeded divergence (an
engine that flips one answer) makes main return 1.
"""
from __future__ import annotations

import random
import re

import pytest

import bench
from language_detector_tpu_torch.models.ngram import NgramBatchEngine
from language_detector_tpu_torch.tables import DATA_DIR
from language_detector_tpu_torch.tools import fuzz, soak
from test_batch_agreement import _fill_fuzz_docs

# documents a path takes here: above the engine's all-C cut
# (TINY_BATCH_C_PATH, 64), so detect_codes dispatches too
PATH_DOCS = 96


def _texts() -> list:
    base = fuzz.make_corpus(64)
    corpus = [ln.split("\t", 1)[1] for ln in (DATA_DIR / "eval_corpus.tsv")
              .read_text(encoding="utf-8").splitlines()]
    return [" ".join(base[i:i + 12]) for i in range(0, 64, 4)] + corpus


@pytest.mark.parametrize("seed", [99001, 20260730])
def test_fill_fuzz_docs_equals_reference(seed):
    texts = _texts()
    got, want = [], []
    fuzz.fill_fuzz_docs(got, random.Random(seed), texts, 160)
    _fill_fuzz_docs(want, random.Random(seed), texts, 160)
    assert got == want and len(got) == 160


@pytest.mark.parametrize("n", [64, 1000])
def test_make_corpus_equals_bench(n):
    assert fuzz.make_corpus(n) == bench.make_corpus(n)


def test_fuzz_docs_fall_back_without_golden_suite(monkeypatch, tmp_path):
    monkeypatch.setenv("LDT_REFERENCE_DIR", str(tmp_path))
    assert fuzz.golden_pairs() == [] and fuzz.golden_texts() == []
    base = fuzz.make_corpus(64)
    want: list = []
    _fill_fuzz_docs(want, random.Random(7),
                    [" ".join(base[i:i + 12]) for i in range(0, 64, 4)],
                    40)
    assert fuzz.fuzz_docs(40, 7) == want


def test_golden_pairs_parse_a_snapshot(tmp_path):
    internal = tmp_path / "cld2" / "internal"
    internal.mkdir(parents=True)
    (internal / "unittest_data.h").write_text(
        '// const char* kTeststr_xx = "commented out";\n'
        'const char* kTeststr_fr = "Le \\x63hat" " noir\\n";\n'
        'const char* kTeststr_fr2 = "encore";\n'
        'const char* kTeststr_version = "v";\n'
        'const char* kTeststr_zz_Abcd = "\\101\\102";\n',
        encoding="utf-8")
    (internal / "cld2_unittest.cc").write_text(
        "  {FRENCH, kTeststr_fr},\n", encoding="utf-8")
    assert fuzz.golden_pairs(str(tmp_path)) == [
        ("fr", "fr", b"Le chat noir\n"), ("fr2", "fr", b"encore"),
        ("zz_Abcd", "zz", b"AB")]


@pytest.fixture(scope="module")
def engine():
    return NgramBatchEngine(device="cpu")


@pytest.fixture(scope="module")
def docs():
    """Each path's documents at half of scale 1, cut to PATH_DOCS (the
    bucket input, 56 documents, whole)."""
    return {k: v[:PATH_DOCS] for k, v in soak.soak_docs(0.5).items()}


@pytest.mark.parametrize("label", [p[0] for p in soak.PATHS])
def test_path_answers_as_scalar(engine, docs, capsys, label):
    _, key, fn, per_doc = next(p for p in soak.PATHS if p[0] == label)
    before = engine.stats_snapshot()["device_dispatches"]
    assert fn(engine, docs[key]) == 0
    dispatched = engine.stats_snapshot()["device_dispatches"] > before
    if label == "cache hits":
        # the batcher sends only its cache misses, the unique documents
        # (32 here, 64 at scale 1): the all-C path answers them
        assert not dispatched
        assert "cache hit rate" in capsys.readouterr().out
    else:
        assert dispatched


def test_cache_path_dispatches_at_scale_2(engine, capsys):
    """At scale 2 the cache pass's distinct misses (119) exceed the
    engine's all-C cut (TINY_BATCH_C_PATH, 64), so the batcher's flushes
    dispatch: on the card, the cache path launches the kernel."""
    dedup = soak.soak_docs(2)["dedup"]
    assert len(set(dedup)) > NgramBatchEngine.TINY_BATCH_C_PATH
    before = engine.stats_snapshot()["device_dispatches"]
    assert soak.run_cache(engine, dedup) == 0
    assert engine.stats_snapshot()["device_dispatches"] > before
    assert "cache hit rate" in capsys.readouterr().out


class _Flipped(NgramBatchEngine):
    """An engine whose detect_batch swaps the first two answers that
    differ: one seeded divergence."""

    def detect_batch(self, texts, *a, **kw):
        got = list(super().detect_batch(texts, *a, **kw))
        j = next(j for j in range(1, len(got))
                 if soak.stuple(got[j]) != soak.stuple(got[0]))
        got[0] = got[j]
        return got


def test_divergence_fails_the_soak(capsys):
    assert soak.main(0.02, engine=_Flipped(device="cpu")) == 1
    out = capsys.readouterr().out
    n = len(soak.soak_docs(0.02)["plain"])
    assert f"plain detect_batch           {n - 1}/{n} exact" in out
    # the hinted, HTML and chunk-vector paths answer through
    # detect_batch too
    assert re.search(r"SOAK FAILED \(\d+\)$", out.rstrip())


def test_clean_soak_exits_zero(engine, capsys):
    assert soak.cli(["0.01", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "SOAK CLEAN"
    assert [ln[:28].rstrip() for ln in out if "exact" in ln] == \
        [p[0] for p in soak.PATHS]
