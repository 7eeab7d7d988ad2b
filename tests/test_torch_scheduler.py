"""The port's stream scheduler answers and counts like the reference's.

On the CPU (device="cpu": the plain PyTorch scorer) the port engine's
detect_codes / detect_many go through its copy of the reference
scheduler: batch-internal dedup, the short / mid / long tier lanes with
undersized lanes coalesced upward, the long-doc lane (span-split
sub-packs merged back into one summary), the overlapped retry lane and
LDT_PIPELINE_DEPTH jobs in flight over staging-ring leases. This file
holds it against the JAX engine on one seeded corpus built from
eval_corpus.tsv (answers exact at every depth, with the long-doc lane on
and off: on is the reference's default, off the port's; scheduler
counters equal at depth 1, where the schedule is
deterministic), and carries the port's counterparts of the reference's
tests/test_bucket_scheduler.py, tests/test_pipeline.py and
tests/test_longdoc_span_merge.py, plus the hinted path through the shared
pipeline core, the staging ring's lease accounting and the near-deadline
retry skip.
"""
from __future__ import annotations

import os
import random

import numpy as np
import pytest

from language_detector_tpu_torch import faults, native, telemetry
from language_detector_tpu_torch.engine_scalar import (detect_scalar,
                                                       split_for_spans)
from language_detector_tpu_torch.models.ngram import NgramBatchEngine
from language_detector_tpu_torch.preprocess import pack
from language_detector_tpu_torch.registry import registry as treg
from language_detector_tpu_torch.result_vector import merge_longdoc_chunks
from language_detector_tpu_torch.service.admission import Deadline
from language_detector_tpu_torch.tables import DATA_DIR, load_tables
from torch_support import jax_packer

# the counters the two schedulers must agree on at depth 1
SCHEDULER_KEYS = ("batches", "device_dispatches", "fallback_docs",
                  "scalar_recursion_docs", "tier_short_dispatches",
                  "tier_mid_dispatches", "tier_long_dispatches",
                  "tier_mixed_dispatches", "tier_longdoc_dispatches",
                  "dedup_docs", "longdoc_split_docs", "longdoc_subdocs",
                  "retry_lane_dispatches", "retry_skipped_docs",
                  "retry_offtier_docs", "c_path_docs")

# while this worker collects, before any of its tests run
jax_packer()


def _eval_docs() -> list[str]:
    return [ln.split("\t", 1)[1].rstrip("\n") for ln in
            open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")]


def scheduler_corpus(seed: int = 20261017) -> list[str]:
    """1,511 documents from the eval corpus: short slices (the short
    tier), concatenations of 3-15 documents (mid), of 20-60 (long, under
    the long-doc threshold) and of 80-130 (past 16,352 chars: the
    long-doc lane at its default threshold), CJK runs, degenerate and
    squeeze-spam documents, then 320 copies of earlier documents (about
    a fifth of the batch), shuffled."""
    docs = _eval_docs()
    rng = random.Random(seed)
    out = []
    for _ in range(760):
        t = rng.choice(docs)
        lo = rng.randrange(max(1, len(t) - 20))
        out.append(t[lo:lo + rng.randint(10, 400)])
    for lo, hi, n in ((3, 15, 340), (20, 60, 50), (80, 130, 6)):
        for _ in range(n):
            out.append(" ".join(rng.choice(docs)
                                for _ in range(rng.randint(lo, hi))))
    for _ in range(30):
        out.append("".join(chr(rng.randrange(0x4E00, 0x9FFF))
                           for _ in range(rng.randint(300, 3000))))
    out += ["", "a", "   ", "123 456", ("buy cheap now " * 300).strip()]
    out += [rng.choice(out) for _ in range(320)]
    rng.shuffle(out)
    return out


def _jax_engine(depth: int, **kw):
    """The reference engine built under LDT_PIPELINE_DEPTH=depth (it
    reads the knob at construction)."""
    from language_detector_tpu.models.ngram import \
        NgramBatchEngine as JaxEngine
    saved = os.environ.get("LDT_PIPELINE_DEPTH")
    os.environ["LDT_PIPELINE_DEPTH"] = str(depth)
    try:
        return JaxEngine(**kw)
    finally:
        if saved is None:
            os.environ.pop("LDT_PIPELINE_DEPTH", None)
        else:
            os.environ["LDT_PIPELINE_DEPTH"] = saved


def _engine(depth: int = 2, **kw) -> NgramBatchEngine:
    return NgramBatchEngine(device="cpu", pipeline_depth=depth, **kw)


# the long-doc lane on (the reference's default sub-pack size; the
# port's own default is off) and off
LANE = {"on": {"longdoc_chunk_slots": 1024},
        "off": {"longdoc_chunk_slots": 0}}


def _rows(results) -> list:
    return [(int(r.summary_lang), tuple(r.language3), tuple(r.percent3),
             tuple(r.normalized_score3), int(r.text_bytes),
             bool(r.is_reliable)) for r in results]


def _scalar_rows(eng, texts) -> list:
    return _rows([detect_scalar(t, eng.tables, eng.reg) for t in texts])


def _drained(eng) -> None:
    """Every dispatch retired and every staging lease back."""
    s = eng.pipeline_stats()
    assert s["inflight"] == 0
    assert s["staging_ring_occupancy"] == 0
    assert eng.staging_stats()["pending_releases"] == 0


@pytest.fixture(scope="module")
def corpus() -> list[str]:
    return scheduler_corpus()


@pytest.fixture(scope="module")
def jax_answers(corpus):
    """(codes, detect_many rows, stats) of fresh JAX engines at depth 1
    and 2, the long-doc lane on (the JAX engine's default, 1024-slot
    sub-packs) and off: {(depth, lane): ...}."""
    out = {}
    for depth in (1, 2):
        for lane in ("on", "off"):
            kw = {} if lane == "on" else {"longdoc_chunk_slots": 0}
            eng = _jax_engine(depth, **kw)
            codes = eng.detect_codes(corpus)
            stats = dict(eng.stats)
            out[depth, lane] = (codes, _rows(eng.detect_many(corpus)),
                                stats)
    return out


# -- the slice as a whole: the port's scheduler against the JAX engine ------


def test_corpus_exercises_every_lane(corpus):
    """The corpus is over TIER_MIN_DOCS unique documents, about a fifth
    duplicates, holds documents past the long-doc engage threshold and
    CJK runs."""
    uniq = set(corpus)
    assert len(corpus) >= 1500
    assert len(uniq) > NgramBatchEngine.TIER_MIN_DOCS
    assert 0.15 < 1 - len(uniq) / len(corpus) < 0.25
    min_chars = (4096 - pack._TIER_BASE_SLOTS) << 2
    assert sum(len(t) > min_chars for t in uniq) >= 4
    assert sum(t != "" and all("\u4e00" <= c <= "\u9fff" for c in t)
               for t in uniq) >= 20


@pytest.mark.parametrize("lane", ["on", "off"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_answers_equal_jax_engine(corpus, jax_answers, depth, lane):
    """detect_codes and detect_many at port depth 1, 2 and 3 equal the
    JAX engine's at depth 1 and at its default depth 2, exactly, with
    the long-doc lane on and off; every dispatch retires and
    retry_offtier_docs stays 0."""
    eng = _engine(depth, **LANE[lane])
    codes = eng.detect_codes(corpus)
    rows = _rows(eng.detect_many(corpus))
    for jdepth in (1, 2):
        jcodes, jrows, _ = jax_answers[jdepth, lane]
        assert codes == jcodes
        assert rows == jrows
    assert eng.stats["retry_offtier_docs"] == 0
    assert (eng.stats["longdoc_split_docs"] > 0) == (lane == "on")
    assert eng.pipeline_stats()["depth"] == depth
    _drained(eng)


@pytest.mark.parametrize("lane", ["on", "off"])
def test_depth1_counters_equal_jax_engine(corpus, jax_answers, lane):
    """At depth 1 the schedule is deterministic: the port's tier, dedup,
    long-doc, retry-lane and dispatch counters after one detect_codes
    call equal the JAX engine's after the same call."""
    eng = _engine(1, **LANE[lane])
    eng.detect_codes(corpus)
    want = jax_answers[1, lane][2]
    got = eng.stats_snapshot()
    assert {k: got[k] for k in SCHEDULER_KEYS} == \
        {k: want[k] for k in SCHEDULER_KEYS}
    assert got["retry_offtier_docs"] == 0
    assert got["dedup_docs"] > 0 and got["retry_lane_dispatches"] > 0
    assert got["tier_short_dispatches"] and got["tier_mid_dispatches"]
    if lane == "on":
        assert got["longdoc_split_docs"] > 0 and \
            got["tier_longdoc_dispatches"] > 0
    else:
        assert got["longdoc_split_docs"] == 0


# -- tests/test_bucket_scheduler.py counterparts ----------------------------


@pytest.fixture(scope="module")
def small_lanes():
    """An engine whose scheduler splits test-sized streams: the routing
    constants are class attributes read through self."""
    eng = _engine(2)
    eng.TIER_MIN_DOCS = 8
    eng.RETRY_LANE_MIN = 2
    eng.TIER_COALESCE_MIN = 1
    return eng


def test_tier_ladder_boundaries():
    """tier_of_text flips exactly at tier_max_chars(k), and tiers are
    monotone in length."""
    assert pack.N_TIERS == len(pack.SLOT_TIER_BUDGETS) + 1
    for k in range(len(pack.SLOT_TIER_BUDGETS)):
        m = pack.tier_max_chars(k)
        assert pack.tier_of_text("x" * m) == k
        assert pack.tier_of_text("x" * (m + 1)) == k + 1
    assert pack.tier_of_text("") == 0
    last = 0
    for n in range(0, pack.tier_max_chars(len(
            pack.SLOT_TIER_BUDGETS) - 1) + 100, 97):
        t = pack.tier_of_text("y" * n)
        assert t >= last
        last = t


def test_bucket_boundary_parity(small_lanes):
    """Documents of length m-1, m and m+1 at every tier boundary answer
    exactly as the scalar engine through the tiered detect_many, and
    every tier lane ran."""
    eng = small_lanes
    docs = _eval_docs()
    base = " ".join(docs) + " "
    boundary = []
    for k in range(len(pack.SLOT_TIER_BUDGETS)):
        m = pack.tier_max_chars(k)
        src = base * (m // len(base) + 2)
        boundary += [src[:m + d] for d in (-1, 0, 1)]
    mix = boundary + docs[:48]
    random.Random(6).shuffle(mix)
    before = eng.stats_snapshot()
    got = eng.detect_many(mix, batch_size=16)
    assert _rows(got) == _scalar_rows(eng, mix)
    st = eng.stats_snapshot()
    for tier in ("short", "mid", "long"):
        assert st[f"tier_{tier}_dispatches"] > \
            before[f"tier_{tier}_dispatches"]


def test_undersized_lanes_coalesce_upward():
    """Lanes below TIER_COALESCE_MIN fold into the next wider budget:
    results stay exact and only the widest lane's counter moves."""
    eng = _engine(2)
    eng.TIER_MIN_DOCS = 8
    docs = _eval_docs()[:20] + [" ".join(_eval_docs()[20:50])] * 2
    got = eng.detect_many(docs, batch_size=4096)
    st = eng.stats_snapshot()
    assert st["tier_short_dispatches"] == st["tier_mid_dispatches"] == 0
    assert st["tier_long_dispatches"] > 0
    assert _rows(got) == _scalar_rows(eng, docs)


def _mixed_corpus(n: int) -> list[str]:
    """Service-sized documents with a squeeze-spam tail, long documents
    and degenerate inputs (bench.make_mixed_corpus's shape, from the
    eval corpus)."""
    docs = _eval_docs()
    out = [docs[i % len(docs)] for i in range(n)]
    for i in range(0, n, 100):
        out[i] = ("buy cheap now " * 300).strip()
    for i in range(37, n, 50):
        out[i] = " ".join(out[(i + j * 13 + 1) % n]
                          for j in range(20 + i % 21))
    for i in range(73, n, 100):
        out[i] = ["", "   ", "123 !!!", "a"][i // 100 % 4]
    for i in range(5, n, 9):           # gate-failing composites
        out[i] = out[i][:60] + " " + docs[(i * 7 + 3) % len(docs)][:60]
    return out


def test_retry_lane_parity(small_lanes):
    """Gate-failing docs resolved through the overlapped retry lane stay
    exact against the scalar engine under slices small enough to
    overlap."""
    eng = small_lanes
    docs = _mixed_corpus(300)
    before = eng.stats_snapshot()["retry_lane_dispatches"]
    got = eng.detect_many(docs, batch_size=32)
    assert eng.stats_snapshot()["retry_lane_dispatches"] > before
    assert _rows(got) == _scalar_rows(eng, docs)
    assert eng.stats_snapshot()["retry_offtier_docs"] == 0
    _drained(eng)


def test_dedup_parity_and_stats(small_lanes):
    """Heavy duplication: duplicates answer as their first occurrence,
    results stay exact, dedup_docs counts exactly the collapsed
    positions, and the codes path shares the scheduler."""
    eng = small_lanes
    uniq = _eval_docs()[:40]
    rng = random.Random(11)
    docs = uniq + [uniq[rng.randrange(len(uniq))] for _ in range(120)]
    rng.shuffle(docs)
    before = eng.stats_snapshot()["dedup_docs"]
    got = eng.detect_many(docs, batch_size=16)
    assert eng.stats_snapshot()["dedup_docs"] - before == \
        len(docs) - len(set(docs))
    assert _rows(got) == _scalar_rows(eng, docs)
    codes = eng.detect_codes(docs, batch_size=16)
    assert codes == [eng.reg.code(r.summary_lang) for r in got]


def test_single_flush_fast_path(small_lanes):
    """A batch that fits one dispatch takes the no-pool path (one mixed
    dispatch) and stays exact, duplicates included."""
    eng = _engine(2)
    docs = _eval_docs()[:24] * 2
    got = eng.detect_many(docs, batch_size=4096)
    st = eng.stats_snapshot()
    assert st["tier_mixed_dispatches"] == 1
    assert st["dedup_docs"] == 24
    assert _rows(got) == _scalar_rows(eng, docs)


def test_gc_paused_forces_periodic_collect(monkeypatch):
    """Sustained bulk calls force a gc.collect() every GC_COLLECT_EVERY
    exits, and the GC is back on afterwards."""
    import gc
    calls = []
    real = gc.collect
    monkeypatch.setattr(gc, "collect", lambda *a: calls.append(1) or 0)
    monkeypatch.setattr(NgramBatchEngine, "GC_COLLECT_EVERY", 4)
    monkeypatch.setattr(NgramBatchEngine, "_bulk_since_collect", 0)
    try:
        for _ in range(9):
            with NgramBatchEngine._gc_paused():
                pass
    finally:
        monkeypatch.setattr(gc, "collect", real)
    assert len(calls) == 2
    assert gc.isenabled()


# -- tests/test_pipeline.py counterparts ------------------------------------

_VOCAB = {
    "en": ("the quick brown fox jumps over a lazy dog while bright "
           "stars shine above quiet rivers and old houses near the "
           "harbor where fishermen mend their nets every "
           "morning").split(),
    "fr": ("le renard brun rapide saute par dessus le chien paresseux "
           "pendant que les etoiles brillantes scintillent au dessus "
           "des rivieres tranquilles et des vieilles maisons du "
           "port").split(),
    "ru": ("быстрая коричневая лиса прыгает через ленивую собаку пока "
           "яркие звезды сияют над тихими реками и старыми домами "
           "возле гавани где рыбаки чинят свои сети каждое "
           "утро").split(),
    "el": ("η γρηγορη καφε αλεπου πηδαει πανω απο το τεμπελικο σκυλι "
           "ενω τα λαμπερα αστερια λαμπουν πανω απο ησυχα ποταμια και "
           "παλια σπιτια κοντα στο λιμανι").split(),
}


def _long_doc(rng, size: int) -> str:
    """Multi-span document: runs of one script long enough to form
    spans, switching scripts every few sentences (non-repetitive, so
    the squeezer stays out of the chunk-merge path)."""
    parts: list = []
    total = 0
    while total < size:
        lang = rng.choice(list(_VOCAB))
        for _ in range(rng.randint(2, 5)):
            s = " ".join(rng.choice(_VOCAB[lang])
                         for _ in range(rng.randint(8, 14))) + ". "
            parts.append(s)
            total += len(s)
    return "".join(parts)


def _pipeline_corpus(rng, n_short=160, n_long=8) -> list[str]:
    texts = []
    langs = list(_VOCAB)
    for i in range(n_short):
        lang = langs[i % len(langs)]
        texts.append(" ".join(rng.choice(_VOCAB[lang])
                              for _ in range(rng.randint(6, 40)))
                     + f" tag{i}")
    for _ in range(n_long):
        texts.append(_long_doc(rng, rng.randint(5000, 18000)))
    texts += ["", "a", "   ", "12345 67890 $$$"]
    rng.shuffle(texts)
    return texts


def test_depth1_vs_depth3_identical():
    """Depth is a latency knob, not a semantics knob: depth 1 and depth
    3 agree over short docs, multi-span long docs (the long-doc lane
    forced on every one of them) and the empty / tiny edge paths."""
    corpus = _pipeline_corpus(random.Random(42))
    e1, e3 = _engine(1, longdoc_split_slots=1024, **LANE["on"]), \
        _engine(3, longdoc_split_slots=1024, **LANE["on"])
    assert _rows(e3.detect_many(corpus, batch_size=32)) == \
        _rows(e1.detect_many(corpus, batch_size=32))
    s1, s3 = e1.pipeline_stats(), e3.pipeline_stats()
    assert s1["depth"] == 1 and s3["depth"] == 3
    assert s1["donation_hits"] == s3["donation_hits"] == 0
    for e in (e1, e3):
        _drained(e)
    assert e3.stats["longdoc_split_docs"] > 0
    assert e3.stats["retry_offtier_docs"] == 0


def test_depth2_default_reuses_staging_leases():
    """The default depth over many small slices of one shape tier
    equals depth 1 and serves later packs from the staging ring."""
    rng = random.Random(7)
    corpus = [" ".join(rng.choice(_VOCAB["en"]) for _ in range(12))
              + f" doc{i}" for i in range(96)]
    ref = _rows(_engine(1).detect_many(corpus, batch_size=16))
    e2 = NgramBatchEngine(device="cpu")
    assert e2.pipeline_depth == 2
    assert _rows(e2.detect_many(corpus, batch_size=16)) == ref
    assert e2.pipeline_stats()["staging_ring_hits"] > 0
    _drained(e2)


def test_device_flush_error_retires_dispatch():
    """A flush that dies before its fetch retires its dispatch: nothing
    left in flight, every lease back, and the next call is exact."""
    e3 = _engine(3)
    corpus = [f"plain english words number {i} for the flush test run"
              for i in range(48)]
    ref = _rows(_engine(1).detect_many(corpus, batch_size=16))
    faults.configure("device_flush:error:once")
    try:
        with pytest.raises(faults.FaultInjected):
            e3.detect_many(corpus, batch_size=16)
    finally:
        faults.configure(None)
    _drained(e3)
    assert _rows(e3.detect_many(corpus, batch_size=16)) == ref


def test_longdoc_chunk_merge_exact_vs_scalar():
    """Multi-span long documents through the long-doc lane (split in
    preprocess/pack.py, merged in result_vector.py) equal the scalar
    engine on every document, and the lane really split them."""
    rng = random.Random(23)
    docs = [_long_doc(rng, rng.randint(5000, 14000)) for _ in range(104)]
    eng = _engine(2, longdoc_split_slots=1024, **LANE["on"])
    got = eng.detect_many(docs, batch_size=32)
    assert _rows(got) == _scalar_rows(eng, docs)
    assert eng.stats["longdoc_split_docs"] >= 100
    assert eng.stats["longdoc_subdocs"] > eng.stats["longdoc_split_docs"]
    assert eng.pipeline_stats()["longdoc_chunks"] > 0


def test_longdoc_lane_off_still_exact():
    """longdoc_chunk_slots=0 turns the lane off; answers do not depend
    on it."""
    rng = random.Random(29)
    docs = [_long_doc(rng, rng.randint(5000, 9000)) for _ in range(12)]
    off = _engine(1, longdoc_chunk_slots=0)
    ref = _rows(off.detect_many(docs, batch_size=32))
    assert off.stats["longdoc_split_docs"] == 0
    eng = _engine(2, longdoc_split_slots=1024, **LANE["on"])
    assert _rows(eng.detect_many(docs, batch_size=32)) == ref
    assert eng.stats["longdoc_split_docs"] > 0


def test_longdoc_default_threshold_takes_fat_tail():
    """At the default LONGDOC_SPLIT_SLOTS mid-size documents ride
    their tier unsplit while the fat tail splits, and both stay
    exact."""
    rng = random.Random(31)
    mids = [_long_doc(rng, 6000) for _ in range(4)]
    fats = [_long_doc(rng, 30000) for _ in range(4)]
    eng = _engine(2, **LANE["on"])
    assert eng.longdoc_split_slots == 4096
    got = eng.detect_many(mids + fats, batch_size=32)
    assert eng.stats["longdoc_split_docs"] == len(fats)
    assert _rows(got) == _scalar_rows(eng, mids + fats)


def _span_scan_corpus(rng) -> list[str]:
    """Documents that reach every rule of the span scanner: the
    long-doc corpus, mixed scripts with embedded foreign letters and
    combining marks, letters whose lowercase is longer in UTF-8, lone
    surrogates and astral symbols, and single-script runs past the
    scanner's 40 KB span cap (the hard cap and the near-end even split)."""
    docs = [_long_doc(rng, rng.randint(2000, 30000)) for _ in range(6)]
    docs += [_pipeline_corpus(rng, n_short=20, n_long=2)[i]
             for i in range(24)]
    docs += ["Ⱥⱥ ȺBC Ⱦ Ⱥ" * 300 + " mixed ΑΒΓ abc" * 50,
             "abc\ud800def \udfff ghi 😀 jkl 𝔘𝔫𝔦 " * 200,
             "naïve cafe\u0301 x\u0300y " * 400 + "слово a слово " * 300,
             "English wordsωmixed inside latinиtext " * 500,
             "plain latin words go on and on " * 1400,
             "слово " * 7000 + "word " * 20, "", "   ", "123 !!!"]
    return docs


def test_native_span_scan_equals_python():
    """The engine's span scan (native.span_extents_native, the packer's
    C++ segmentation, threaded over a batch) returns exactly the Python
    scan's spans (pack.span_extents over segment_text): char extents,
    scripts and span bytes."""
    tables = load_tables()
    docs = _span_scan_corpus(random.Random(5)) + scheduler_corpus()[:400]
    got = native.span_extents_native(docs, tables, treg)
    assert got == [pack.span_extents(d, tables) for d in docs]
    one = native.span_extents_native(docs[:3], tables, treg, n_threads=1)
    assert one == got[:3]


@pytest.mark.parametrize("budget", [64, 1024])
def test_native_split_equals_python_split(budget):
    """split_longdoc over the native scan (as the engine calls it, the
    document's spans precomputed in one batch) splits every document
    exactly as over the Python scan, bounds included."""
    tables = load_tables()
    docs = _span_scan_corpus(random.Random(6))
    eng = _engine(1)
    pre = native.span_extents_native(docs, tables, treg)
    n_split = 0
    for d, spans in zip(docs, pre):
        want = pack.split_longdoc(d, tables, budget, want_bounds=True)
        assert pack.split_longdoc(d, tables, budget, want_bounds=True,
                                  segment=eng._span_scan,
                                  spans=spans) == want
        n_split += want is not None
    assert n_split >= 8


# -- tests/test_longdoc_span_merge.py counterparts --------------------------

MERGE_TEXTS = [
    ("hello world this is a plainly english document " * 6 +
     "это русское предложение о языках и текстах " * 6),
    ("bonjour le monde ceci est une phrase en francais " * 5 +
     "これは日本語の文章ですよろしくお願いします" * 5 +
     "and back to english words for the tail of the document " * 4),
    "short single-span doc",
]


def _split_pack(texts, budget=8):
    """texts -> (sub-doc ChunkBatch, groups, ramp rows): a tiny budget
    forces multi-sub-doc groups, and distinct row values pin slice
    placement exactly."""
    tables = load_tables()
    subs_all, groups = [], []
    for t in texts:
        subs, _ = split_for_spans(t, tables, budget)
        groups.append((len(subs_all), len(subs)))
        subs_all.extend(subs)
    cb = native.pack_chunks_native(subs_all, tables, treg)
    G = int(cb.n_chunks.sum())
    rows = np.arange(max(G, 1) * 5, dtype=np.int32).reshape(-1, 5)
    return cb, groups, rows


def test_span_rows_sum_to_merged_totals():
    """Per-group span records partition the merged document's chunk rows
    and byte total exactly, contiguously from its first merged row."""
    cb, groups, rows = _split_pack(MERGE_TEXTS)
    assert any(n > 1 for _, n in groups)
    mrows, mcb, span_rows = merge_longdoc_chunks(rows, cb, groups,
                                                 keep_spans=True)
    assert len(span_rows) == len(groups)
    for j, (s, n) in enumerate(groups):
        recs = span_rows[j]
        assert len(recs) == n
        assert sum(nc for _, nc, _ in recs) == int(mcb.n_chunks[j])
        assert sum(tb for _, _, tb in recs) == int(mcb.text_bytes[j])
        assert int(mcb.text_bytes[j]) == int(cb.text_bytes[s:s + n].sum())
        pos = int(mcb.doc_chunk_start[j])
        for rs, nc, _ in recs:
            assert rs == pos
            pos += nc


def test_retained_slices_equal_source_rows():
    """Each retained slice of the merged rows is the sub-document's own
    row range, bit for bit."""
    cb, groups, rows = _split_pack(MERGE_TEXTS)
    mrows, _, span_rows = merge_longdoc_chunks(rows, cb, groups,
                                               keep_spans=True)
    for j, (s, n) in enumerate(groups):
        for k, (rs, nc, tb) in enumerate(span_rows[j]):
            i = s + k
            g0 = int(cb.doc_chunk_start[i])
            assert nc == int(cb.n_chunks[i])
            assert tb == int(cb.text_bytes[i])
            np.testing.assert_array_equal(mrows[rs:rs + nc],
                                          rows[g0:g0 + nc])


def test_keep_spans_false_unchanged():
    """keep_spans=False returns the 2-tuple with the identical merge."""
    cb, groups, rows = _split_pack(MERGE_TEXTS)
    out0 = merge_longdoc_chunks(rows, cb, groups)
    assert len(out0) == 2
    mrows0, mcb0 = out0
    mrows1, mcb1, _ = merge_longdoc_chunks(rows, cb, groups,
                                           keep_spans=True)
    np.testing.assert_array_equal(mrows0, mrows1)
    for f in ("n_chunks", "text_bytes", "doc_chunk_start", "direct_adds",
              "fallback", "squeezed"):
        np.testing.assert_array_equal(getattr(mcb0, f), getattr(mcb1, f))


# -- hinted path, staging ring, deadline ------------------------------------


@pytest.mark.parametrize("priors", [False, True], ids=["priors-off",
                                                        "priors-on"])
def test_hinted_pipeline_equals_jax(corpus, priors):
    """The hinted path through _pipelined_jobs at depth 2 (a content
    budget small enough for several slices, so the worker pool runs)
    answers exactly as the JAX engine's _detect_hinted, hint priors off
    and on."""
    from language_detector_tpu.hints import CLDHints as JaxHints
    from language_detector_tpu_torch.hints import CLDHints
    docs = corpus[:400]
    kw = {"content_language_hint": "fr,ru", "tld_hint": "jp"}
    eng = NgramBatchEngine(device="cpu", pipeline_depth=2,
                           hint_priors=priors)
    jeng = _jax_engine(2)
    jeng.hint_priors_enabled = priors
    for e in (eng, jeng):
        e.DISPATCH_CHAR_BUDGET = 40_000
    n_slices = sum(1 for _ in eng._slices(docs, 16384))
    assert n_slices > 3
    before = eng.stats_snapshot()["device_dispatches"]
    got = eng.detect_batch(docs, hints=CLDHints(**kw))
    want = jeng.detect_batch(docs, hints=JaxHints(**kw))
    assert _rows(got) == _rows(want)
    assert eng.stats_snapshot()["device_dispatches"] - before == n_slices
    _drained(eng)


def test_staging_ring_reuses_leases_across_calls(corpus):
    """A second call of the same shapes is served from the ring."""
    eng = _engine(2)
    eng.detect_codes(corpus[:600])
    first = eng.staging_stats()
    assert first["hits"] + first["misses"] > 0
    eng.detect_codes(corpus[:600])
    second = eng.staging_stats()
    assert second["hits"] > first["hits"]
    assert second["misses"] == first["misses"]
    _drained(eng)


def test_scorer_launch_fault_releases_lease(corpus):
    """A refused launch gives its lease back and leaves nothing in
    flight; the engine then answers as before."""
    eng = _engine(2)
    want = eng.detect_codes(corpus[:300])
    faults.configure("scorer_launch:error:once")
    try:
        with pytest.raises(faults.FaultInjected):
            eng.detect_codes(corpus[:300])
    finally:
        faults.configure(None)
    _drained(eng)
    assert eng.detect_codes(corpus[:300]) == want


def test_near_deadline_skips_retry_lane(corpus):
    """A flush whose deadline is closer than two expected flushes sets
    trace.no_retry: its gate failures resolve in the scalar engine
    (counted in retry_skipped_docs, no retry-lane dispatch), with the
    JAX engine's answers under the same trace."""
    docs = corpus[:500]
    eng = _engine(2)
    jeng = _jax_engine(2)
    tr = telemetry.Trace()
    # due now: below two expected flushes whatever the stage histograms
    # of earlier tests in this process hold
    tr.deadline = Deadline(0.0)
    got = eng.detect_codes(docs, trace=tr)
    assert tr.no_retry
    from language_detector_tpu import telemetry as jtelemetry
    from language_detector_tpu.service.admission import \
        Deadline as JaxDeadline
    jtr = jtelemetry.Trace()
    jtr.deadline = JaxDeadline(0.0)
    assert got == jeng.detect_codes(docs, trace=jtr)
    st = eng.stats_snapshot()
    assert st["retry_skipped_docs"] == jeng.stats["retry_skipped_docs"] > 0
    assert st["retry_lane_dispatches"] == 0
    _drained(eng)
