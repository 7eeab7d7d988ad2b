"""The port's quad-table trainers against the reference package's
scripts (tools/cldr_vocab.py, train_quad_tables.py,
calibrate_quad_tables.py, sweep_quad_tables.py), on the CPU.

The CLD2 snapshot the octagram word sources come from is absent on
every host this runs on, so those sources are generated here: three
small generated-table files (bucket rows with word comments, `[150]`
markers, empty slots, KeyMask, SizeOne and an Ind[] array) in a
snapshot-shaped directory, read by the port through LDT_REFERENCE_DIR
and by the reference through its `REF` path, monkeypatched. The CLDR
phrases come from the committed fixture tests/data/torch_trainer_cldr.tsv
(80 seeded phrases a language from collect_cldr_phrases; `write_fixture`
writes it, and a test regenerates it where babel imports). The trained
npz, the calibration's dev hits, biases and expected scores, and the
sweep's golden hits equal the reference's.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import io
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from language_detector_tpu_torch.registry import registry
from language_detector_tpu_torch.tables import load_tables
from language_detector_tpu_torch.tools import calibrate_quad_tables as cq
from language_detector_tpu_torch.tools import cldr_vocab as cv
from language_detector_tpu_torch.tools import sweep_quad_tables as sw
from language_detector_tpu_torch.tools import train_quad_tables as tq
from torch_support import jax_packer

jax_packer()

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "torch_trainer_cldr.tsv"
FIXTURE_PER_LANG = 80
FIXTURE_SEED = 12
SHIPPED_QUAD = REPO / "language_detector_tpu" / "data" / "quad_tables.npz"
OCTA_SOURCES = ("cld2_generated_deltaocta0527.cc",
                "cld2_generated_distinctocta0527.cc",
                "cld2_generated_deltaoctachrome.cc")


@pytest.fixture(scope="module")
def ref():
    """The reference scripts, imported by the top-level names they use
    for each other (calibrate's `tq` is train_quad_tables)."""
    tools_dir = str(REPO / "tools")
    if tools_dir not in sys.path:
        sys.path.insert(0, tools_dir)
    import calibrate_quad_tables
    import cldr_vocab
    import sweep_quad_tables
    import train_quad_tables
    assert calibrate_quad_tables.tq is train_quad_tables
    return type("Ref", (), {"tq": train_quad_tables,
                            "cq": calibrate_quad_tables,
                            "sw": sweep_quad_tables, "cv": cldr_vocab})


# -- the committed CLDR fixture -------------------------------------------------


def fixture_rows(phrases: list) -> str:
    """The fixture's text from collect_cldr_phrases' items: per language
    (by code), FIXTURE_PER_LANG of its `cldr` phrases drawn with one
    seeded rng from the sorted (phrase, qprob) list, one
    "code<TAB>qprob<TAB>phrase" line each."""
    by = collections.defaultdict(list)
    for phrase, langs, cls in phrases:
        if cls == "cldr":
            (lang, q), = langs
            by[registry.code(lang)].append((phrase, q))
    rng = random.Random(FIXTURE_SEED)
    rows = []
    for code in sorted(by):
        items = sorted(by[code])
        for phrase, q in rng.sample(items, min(FIXTURE_PER_LANG,
                                                 len(items))):
            rows.append(f"{code}\t{q}\t{phrase}\n")
    return "".join(rows)


def write_fixture(path: Path = FIXTURE) -> None:
    """Regenerate the committed fixture from babel's CLDR data."""
    phrases = tq.collect_cldr_phrases(load_tables(), registry)
    path.write_text(fixture_rows(phrases), encoding="utf-8")


@pytest.fixture(scope="module")
def phrases():
    return tq.read_phrases(FIXTURE)


@pytest.fixture(scope="module")
def cldr_port():
    pytest.importorskip("babel")
    return tq.collect_cldr_phrases(load_tables(), registry)


def test_fixture_is_current(cldr_port, phrases):
    """The committed fixture is what write_fixture makes on this host,
    and it is small: 80 phrases for most of 148 languages."""
    assert FIXTURE.read_text(encoding="utf-8") == fixture_rows(cldr_port)
    assert FIXTURE.stat().st_size < 260_000
    langs = collections.Counter(lang for _, ((lang, _),), _ in phrases)
    assert len(langs) >= 140 and max(langs.values()) == FIXTURE_PER_LANG
    assert {cls for _, _, cls in phrases} == {"cldr"}


def test_collect_cldr_phrases_matches_reference(ref, cldr_port):
    """Every CLDR, gettext-catalog and stop-word item, in order, equals
    the reference's on this host."""
    want = ref.tq.collect_cldr_phrases(ref.tq.load_tables(),
                                       ref.tq.registry)
    assert cldr_port == want
    assert len(cldr_port) > 100_000


def test_cldr_helpers_match_reference(ref):
    """The phrase cleaner and the stop-word source equal the
    reference's."""
    for s in ("{0} days ago", "Janvier", "14:00 — p.m.", "''", "%s files",
              "  Σάββατο ", "1234", "n’importe quoi", "ABC"):
        assert cv._clean_phrase(s) == ref.cv._clean_phrase(s)
    assert cv.collect_english_stopwords(registry) == \
        ref.cv.collect_english_stopwords(ref.tq.registry)


# -- the generated-table word sources -------------------------------------------


def _word(rng) -> str:
    letters = rng.choice(("abcdefghijklmnopqrstuvwxyzäöüéñß",
                          "абвгдежзийклмнопрст", "αβγδεζηθικλμνξοπρσ"))
    w = "".join(rng.choice(letters) for _ in range(rng.randint(1, 8)))
    return rng.choice(("_{}_", "_{}", "{}_", "{}", "__")).format(w)


def write_generated_source(path: Path, seed: int, buckets: int) -> None:
    """A generated octagram table source in the snapshot's layout: the
    KeyMask and SizeOne constants, an IndirectProbBucket4 array whose
    rows carry their words as comments (some with a [150] marker, some
    empty, some with five words), and the Ind[] array."""
    rng = random.Random(seed)
    keymask, size_one, pairs = 0xFFFFF000, 24, 16
    lines = [f"// {path.name}: a generated table written by the test",
             f"static const uint32 kTestKeyMask = 0x{keymask:08x};",
             f"static const uint32 kTestSizeOne = {size_one};",
             "static const IndirectProbBucket4 kTestBuckets[] = {"]
    for _ in range(buckets):
        kv = [0 if rng.random() < 0.2 else
              (rng.getrandbits(32) & keymask) |
              rng.randrange(size_one + pairs) for _ in range(4)]
        n = rng.choice((0, 1, 2, 4, 4, 5))
        words = ", ".join(_word(rng) for _ in range(n))
        marker = "[150] " if rng.random() < 0.2 else ""
        row = ",".join(f"0x{v:08x}" for v in kv)
        lines.append(f"  {{{{{row}}}}},  // {marker}{words}")
    lines.append("};")
    ind = [0 if rng.random() < 0.1 else
           (rng.randrange(256) << 24) | (rng.randrange(256) << 16) |
           (rng.randrange(1, 256) << 8) | rng.randrange(240)
           for _ in range(size_one + 2 * pairs)]
    lines.append(f"static const uint32 kTestInd[{len(ind)}] = {{")
    lines += [f"  0x{v:08x}," for v in ind]
    lines.append("};")
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


@pytest.fixture
def snapshot(tmp_path, monkeypatch, ref):
    """A snapshot-shaped directory holding the three generated sources;
    LDT_REFERENCE_DIR names it and the reference's REF points into it."""
    internal = tmp_path / "cld2" / "internal"
    internal.mkdir(parents=True)
    for i, name in enumerate(OCTA_SOURCES):
        write_generated_source(internal / name, 100 + i, 96)
    monkeypatch.setenv("LDT_REFERENCE_DIR", str(tmp_path))
    monkeypatch.setattr(ref.tq, "REF", internal)
    return internal


def test_parse_words_and_parsed_table_match_reference(ref, snapshot):
    for name in OCTA_SOURCES:
        path = snapshot / name
        words = tq.parse_words(path)
        assert words == ref.tq.parse_words(path)
        assert len(words) > 100
        got, want = tq.ParsedTable(path), ref.tq.ParsedTable(path)
        assert (got.keymask, got.size_one, got.size) == \
            (want.keymask, want.size_one, want.size) == (0xFFFFF000, 24, 96)
        assert np.array_equal(got.buckets, want.buckets)
        assert np.array_equal(got.ind, want.ind) and got.ind.size == 56


def test_collect_training_words_matches_reference(ref, snapshot):
    """The words, their languages and source weights equal the
    reference's item for item, from every source; the corpus built from
    them and the fixture's phrases equals the reference's."""
    got = tq.collect_training_words(load_tables(), registry)
    want = ref.tq.collect_training_words(ref.tq.load_tables(),
                                         ref.tq.registry)
    assert got == want
    assert {w for _, _, w in got} == {1.0, 0.3}
    assert len(got) > 200
    for word, _, _ in got[:200]:
        assert np.array_equal(tq.quads_of_word(word),
                              ref.tq.quads_of_word(word))


@pytest.mark.parametrize("case", ["unset", "file_missing"])
def test_word_sources_name_the_knob(case, snapshot, monkeypatch):
    """Without the knob, or without a source file, the trainer raises an
    error naming LDT_REFERENCE_DIR and the file; it never trains on an
    empty octagram corpus."""
    if case == "unset":
        monkeypatch.delenv("LDT_REFERENCE_DIR")
    else:
        (snapshot / OCTA_SOURCES[2]).unlink()
    with pytest.raises(FileNotFoundError) as e:
        tq.collect_training_words(load_tables(), registry)
    assert "LDT_REFERENCE_DIR" in str(e.value)
    assert OCTA_SOURCES[0 if case == "unset" else 2] in str(e.value)
    with pytest.raises(FileNotFoundError):
        tq.collect_corpus(load_tables(), registry, phrases=[])


# -- train ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpora(ref, phrases):
    """(port corpus, reference corpus) over the fixture's phrases."""
    port = tq.collect_corpus(load_tables(), registry, words=[],
                             phrases=phrases)
    want = [(ref.tq.quads_of_phrase(p), langs, cls)
            for p, langs, cls in phrases]
    return port, want


@pytest.mark.parametrize("buckets,buckets2", [(4096, 1024), (65536, 8192)])
def test_train_matches_reference(ref, corpora, buckets, buckets2):
    """The npz arrays equal the reference trainer's key for key; the
    small table spills into the dual table."""
    port, want_corpus = corpora
    assert len(port) == len(want_corpus)
    for (a, la, ca), (b, lb, cb) in zip(port, want_corpus):
        assert np.array_equal(a, b) and la == lb and ca == cb
    got = tq.train(load_tables(), registry, port, buckets=buckets,
                   buckets2=buckets2, verbose=False)
    want = ref.tq.train(ref.tq.load_tables(), ref.tq.registry, want_corpus,
                        buckets=buckets, buckets2=buckets2, verbose=False)
    assert sorted(got) == sorted(want)
    assert "quadgram2_buckets" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert int(got["quadgram_meta"][1]) == buckets


def test_train_main_writes_only_its_out(tmp_path, snapshot, phrases,
                                        monkeypatch):
    """`main` trains from the snapshot's words and the phrases and writes
    --out; its default is under build/, never the shipped tables."""
    assert tq.DEFAULT_OUT == REPO / "build" / "torch_tables" / \
        "quad_tables.npz"
    monkeypatch.setattr(tq, "collect_cldr_phrases",
                        lambda tables, reg: phrases[:2000])
    before = hashlib.sha256(SHIPPED_QUAD.read_bytes()).hexdigest()
    out = tmp_path / "q" / "quad_tables.npz"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tq.main(["--buckets", "4096", "--out", str(out)])
    assert f"wrote {out}" in buf.getvalue()
    z = np.load(out)
    assert int(z["quadgram_meta"][1]) == 4096
    assert hashlib.sha256(SHIPPED_QUAD.read_bytes()).hexdigest() == before


# -- calibrate --------------------------------------------------------------------


def _recording(train, calls: list):
    def wrapper(*a, **k):
        calls.append(dict(k.get("lang_bias") or {}))
        return train(*a, **k)
    return wrapper


def test_calibrate_matches_reference(ref, phrases, tmp_path, monkeypatch):
    """Both scripts' mains at 2 iterations over the fixture's phrases
    (no octagram words): the printed dev hits per iteration, the bias
    each round trained with, and the npz (trained at the best round's
    bias, with the expected scores regenerated from its dev detections)
    are equal; the port's engine scores on the CPU. The trained tables
    answer some dev documents differently from the shipped ones, so a
    stale install cannot pass; the shipped npz is untouched."""
    before = hashlib.sha256(SHIPPED_QUAD.read_bytes()).hexdigest()
    runs = {}
    for name, mod, tqm, argv in (("ref", ref.cq, ref.tq, []),
                                 ("port", cq, tq, ["--device", "cpu"])):
        calls: list = []
        monkeypatch.setattr(tqm, "collect_training_words",
                            lambda tables, reg: [])
        monkeypatch.setattr(tqm, "collect_cldr_phrases",
                            lambda tables, reg: phrases)
        monkeypatch.setattr(tqm, "train", _recording(tqm.train, calls))
        out = tmp_path / f"{name}.npz"
        monkeypatch.setattr(sys, "argv", ["calibrate", "--iters", "2",
                                          "--out", str(out), *argv])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        runs[name] = (buf.getvalue().splitlines()[:-1], calls,
                      dict(np.load(out)))
    (p_lines, p_calls, p_npz), (r_lines, r_calls, r_npz) = \
        runs["port"], runs["ref"]
    assert p_lines == r_lines
    assert [ln for ln in p_lines if ln.startswith("iter ")] and \
        "dev docs: 1656 across 138 languages" in p_lines
    assert p_calls == r_calls and len(p_calls) == 2
    assert sorted(p_npz) == sorted(r_npz)
    for k in r_npz:
        assert np.array_equal(p_npz[k], r_npz[k]), k
    assert int((p_npz["expected_score_override"] > 0).sum()) > 100
    assert hashlib.sha256(SHIPPED_QUAD.read_bytes()).hexdigest() == before

    base = load_tables()
    docs = cq.build_dev_docs(base, registry, words=[], phrases=phrases)
    texts = [t for _, t in docs]
    shipped = [r.summary_lang for r in cq.detect_all(base, texts, "cpu")]
    trained = [r.summary_lang for r in cq.detect_all(
        cq.make_tables(base, p_npz), texts, "cpu")]
    differ = sum(a != b for a, b in zip(shipped, trained))
    assert 0 < differ < len(texts)


def test_calibrate_function_records_rounds(phrases):
    """`calibrate` (the main's loop) returns each round's dev hits, wins,
    bias and dispatches; its dev hits equal the best round's; on the CPU
    no card memory is read."""
    base = load_tables()
    corpus = tq.collect_corpus(base, registry, words=[],
                               phrases=phrases[::2])
    docs = cq.build_dev_docs(base, registry, docs_per_lang=4,
                             words=[], phrases=phrases[::2])
    with contextlib.redirect_stdout(io.StringIO()):
        run = cq.calibrate(base, corpus, docs, iters=2, device="cpu")
    its = run["iterations"]
    assert len(its) == 2 and its[0]["bias"] == {}
    assert its[1]["bias"] and run["best_dev_hits"] == max(
        i["dev_hits"] for i in its)
    assert all(i["dispatches"] > 0 and i["card_bytes"] is None
               for i in its)
    assert sum(its[0]["wins"].values()) == len(docs)
    assert run["expected_dispatches"] > 0


def test_device_cuda_raises_without_a_card(monkeypatch):
    """calibrate's --device cuda (the default) raises before any work
    when there is no card; detect_all has no scalar fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cq.main(["--device", "cuda", "--out", "/nonexistent/x.npz"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cq.main(["--out", "/nonexistent/x.npz"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cq.detect_all(load_tables(), ["bonjour"], "cuda")


# -- sweep ------------------------------------------------------------------------

GOLDEN = {"en": ("ENGLISH", "The quick brown fox jumps over the lazy dog "
                 "near the river bank today and the children play in "
                 "the garden"),
          "fr": ("FRENCH", "Le gouvernement a annonc\\xc3\\xa9 de nouvelles "
                 "mesures pour aider les familles et les enfants")}


def write_golden_suite(root: Path) -> None:
    """A two-entry golden suite in the snapshot's layout: unittest_data.h
    (concatenated literals, a hex escape, a commented-out variant) and
    the kTestPair rows of cld2_unittest.cc."""
    internal = root / "cld2" / "internal"
    internal.mkdir(parents=True, exist_ok=True)
    data = ["// the golden suite, written by the test"]
    pairs = []
    for code, (cname, text) in GOLDEN.items():
        half = len(text) // 2
        data.append(f'const char* kTeststr_{code} = "{text[:half]}"\n'
                    f'    "{text[half:]}";')
        data.append(f'// const char* kTeststr_{code}9 = "gone";')
        pairs.append(f"  {{{cname}, kTeststr_{code}}},")
    (internal / "unittest_data.h").write_text("\n".join(data) + "\n")
    (internal / "cld2_unittest.cc").write_text("\n".join(pairs) + "\n")


def test_sweep_evaluate_matches_reference(ref, corpora, tmp_path,
                                          monkeypatch):
    """`evaluate` over a two-entry golden suite read through
    LDT_REFERENCE_DIR equals the reference `evaluate` pointed at the
    same pairs and corpus, for two configurations; without a suite the
    port's `_init` stops naming the knob."""
    from language_detector_tpu_torch.tools.fuzz import golden_pairs
    write_golden_suite(tmp_path)
    monkeypatch.setenv("LDT_REFERENCE_DIR", str(tmp_path))
    pairs = golden_pairs()
    assert [(n, lang) for n, lang, _ in pairs] == [("en", "en"),
                                                   ("fr", "fr")]
    assert "annoncé".encode() in pairs[1][2]
    port, want_corpus = corpora
    monkeypatch.setattr(sw, "_corpus", port)
    monkeypatch.setattr(sw, "_pairs", pairs)
    monkeypatch.setattr(ref.sw, "_corpus", want_corpus)
    monkeypatch.setattr(ref.sw, "_pairs", pairs)
    hits = []
    for cfg in ({}, {"shrink": 0.5, "slope": 2.5, "base": 5}):
        got = sw.evaluate(cfg)
        assert got == ref.sw.evaluate(cfg)
        hits.append(got[1])
    assert max(hits) >= 1
    monkeypatch.delenv("LDT_REFERENCE_DIR")
    with pytest.raises(SystemExit, match="LDT_REFERENCE_DIR"):
        sw._init()
