"""The torch port's hinted and HTML detection equals the reference's.

Held against the JAX package on the CPU (device="cpu": the plain PyTorch
scorer), exactly (tolerance 0: equal hint lists, equal wire arrays,
equal packed words, equal answers):

- the port's hints module (apply_hints, prior_vector, the lang-tag
  scanner) on the cases of tests/test_hints_parity.py;
- its hinted packs, with and without prior planes, array for array, and
  prior-free hinted wires byte-identical to the plain ones;
- the plain scorer on those wires (word1 and full output) against the
  JAX XLA programs and evalsuite.oracle_score_chunks;
- the documented hint flip (evalsuite.HINT_DEMO_TEXT turns `id` only
  with hint priors on);
- engine answers for hinted batches (priors off and on) and HTML
  batches, and the scalar engine's hinted answers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from language_detector_tpu import hints as jhints
from language_detector_tpu import native as jnative
from language_detector_tpu.engine_scalar import \
    detect_scalar as jdetect_scalar
from language_detector_tpu.evalsuite import (HINT_DEMO_HINT, HINT_DEMO_TEXT,
                                             hint_flip_demo,
                                             oracle_score_chunks)
from language_detector_tpu.ops.device_tables import \
    DeviceTables as JaxDeviceTables
from language_detector_tpu.ops.score import score_chunks, score_chunks_full
from language_detector_tpu.registry import registry as jreg
from language_detector_tpu.tables import load_tables as jload_tables
from language_detector_tpu_torch import hints as thints
from language_detector_tpu_torch import native as tnative
from language_detector_tpu_torch.engine_scalar import detect_scalar
from language_detector_tpu_torch.models.ngram import NgramBatchEngine
from language_detector_tpu_torch.ops.device_tables import DeviceTables
from language_detector_tpu_torch.ops.score import (score_chunks_plain,
                                                   wire_to_device,
                                                   words_to_numpy)
from language_detector_tpu_torch.registry import registry as treg
from language_detector_tpu_torch.tables import DATA_DIR
from language_detector_tpu_torch.tables import load_tables as tload_tables
from test_hints_parity import CASES, PRIOR_TEXTS
from torch_support import jax_packer

# (hint keyword arguments) on top of the parity cases' own: every
# CLDHints channel, alone and together
EXTRA_HINTS = [
    dict(encoding_hint="CHINESE_GB"),
    dict(encoding_hint="JAPANESE_EUC_JP"),
    dict(encoding_hint="KOREAN_EUC_KR"),
    dict(content_language_hint="id", tld_hint="my",
         language_hint=jreg.code_to_lang["nl"]),
    dict(content_language_hint="pt-BR,es;q=0.5,fr"),
]

# while this worker collects, before any of its tests run
jax_packer()


def _case_hints(mod, kw: dict):
    return mod.CLDHints(
        content_language_hint=kw.get("content_language", b"").decode()
        or None,
        tld_hint=kw.get("tld", b"").decode() or None,
        language_hint=kw.get("language", jreg.code_to_lang["un"]))


def _all_cases() -> list:
    """(text, is_plain_text, {CLDHints field: value}) for every case."""
    out = []
    for text, plain, kw in CASES:
        h = _case_hints(jhints, kw)
        out.append((text, plain, {f.name: getattr(h, f.name)
                                  for f in dataclasses.fields(h)}))
    for kw in EXTRA_HINTS:
        out.append(("short text", True, kw))
        out.append((PRIOR_TEXTS[1], True, kw))
    return out


ALL_CASES = _all_cases()


def _eval_docs() -> list[str]:
    return [ln.split("\t", 1)[1].rstrip("\n") for ln in
            open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8")]


def _boosts(hb) -> tuple:
    return (list(hb.boost_latn), list(hb.boost_othr),
            list(hb.whack_latn), list(hb.whack_othr))


@pytest.mark.parametrize("case", range(len(ALL_CASES)))
def test_apply_hints_and_prior_vector_match_reference(case):
    """The port's HintBoosts and dense prior vector equal the JAX
    package's, field for field."""
    text, plain, kw = ALL_CASES[case]
    jt, tt = jload_tables(), tload_tables()
    jhb = jhints.apply_hints(text, plain, jhints.CLDHints(**kw), jt, jreg)
    thb = thints.apply_hints(text, plain, thints.CLDHints(**kw), tt, treg)
    assert _boosts(thb) == _boosts(jhb)
    jpv = jhints.prior_vector(jhb, jt)
    tpv = thints.prior_vector(thb, tt)
    assert (jpv is None) == (tpv is None)
    if jpv is not None:
        assert tpv.dtype == jpv.dtype and np.array_equal(tpv, jpv)


@pytest.mark.parametrize("body", [
    '<html lang="fr">', "<html lang='pt-BR'>", '<div xml:lang="DE_de">x',
    '<meta http-equiv=content-language content="es, en" x=y>',
    '<meta http-equiv="content-language" content="es, en">',
    '<a lang="it" href=x>', '<script lang="js">',
    '<p lang="fr"></p><p lang="fr"></p><p lang=nl>x</p>'])
def test_lang_tag_scanner_matches_reference(body):
    assert thints.get_lang_tags_from_html(body) == \
        jhints.get_lang_tags_from_html(body)


def test_scalar_hinted_answers_match_reference():
    """detect_scalar with hints or HTML (the engines' exception path and
    the oracle the engine is held against) answers like the JAX
    package's on every case."""
    jt, tt = jload_tables(), tload_tables()
    for text, plain, kw in ALL_CASES:
        want = jdetect_scalar(text, jt, jreg, 0, is_plain_text=plain,
                              hints=jhints.CLDHints(**kw))
        got = detect_scalar(text, tt, treg, 0, is_plain_text=plain,
                            hints=thints.CLDHints(**kw))
        assert dataclasses.astuple(got) == dataclasses.astuple(want), \
            (text[:40], kw)


def _hinted_packs(with_priors: bool, texts=PRIOR_TEXTS) -> tuple:
    """The same per-doc content-language hints packed by both packages
    (cprior/prior_tbl planes only when with_priors)."""
    codes = ["id", "ms", "sr", "fr", "uk", "ja", "af"]
    out = []
    for mod, nat, tables, reg in ((jhints, jnative, jload_tables(), jreg),
                                  (thints, tnative, tload_tables(), treg)):
        hbs = [mod.apply_hints(t, True, mod.CLDHints(
            content_language_hint=codes[i % len(codes)]), tables, reg)
            for i, t in enumerate(texts)]
        pvs = ([mod.prior_vector(hb, tables) for hb in hbs]
               if with_priors else None)
        out.append(nat.pack_chunks_native(texts, tables, reg,
                                          hint_boosts=hbs,
                                          hint_priors=pvs))
    return tuple(out)


@pytest.mark.parametrize("with_priors", [False, True],
                         ids=["no-prior", "prior"])
def test_hinted_wire_matches_reference(with_priors):
    jcb, tcb = _hinted_packs(with_priors, _eval_docs()[:60] + PRIOR_TEXTS)
    assert ("cprior" in tcb.wire) == with_priors
    assert tcb.wire["cwhack"].shape[-1] > 1  # real whack rows
    assert sorted(jcb.wire) == sorted(tcb.wire)
    for k in jcb.wire:
        assert jcb.wire[k].dtype == tcb.wire[k].dtype, k
        assert np.array_equal(jcb.wire[k], tcb.wire[k]), k


def test_prior_free_wires_are_the_plain_ones():
    """hint_priors=None and an all-None prior list give the same wire,
    with no cprior/prior_tbl keys; without boosts either, that wire is
    the plain pack's, byte for byte."""
    tables = tload_tables()
    n = len(PRIOR_TEXTS)
    plain = tnative.pack_chunks_native(PRIOR_TEXTS, tables, treg)
    nones = tnative.pack_chunks_native(PRIOR_TEXTS, tables, treg,
                                       hint_boosts=[None] * n,
                                       hint_priors=[None] * n)
    _, hinted = _hinted_packs(False)
    hinted_nones = tnative.pack_chunks_native(
        PRIOR_TEXTS, tables, treg,
        hint_boosts=[thints.apply_hints(
            t, True, thints.CLDHints(content_language_hint=c), tables,
            treg) for t, c in zip(PRIOR_TEXTS,
                                  ["id", "ms", "sr", "fr", "uk", "ja",
                                   "af"])],
        hint_priors=[None] * n)
    for a, b in ((plain, nones), (hinted, hinted_nones)):
        assert "cprior" not in a.wire and "prior_tbl" not in b.wire
        assert sorted(a.wire) == sorted(b.wire)
        for k in a.wire:
            assert np.array_equal(a.wire[k], b.wire[k]), k


@pytest.fixture(scope="module")
def scorers():
    jt = jload_tables()
    return (jt, JaxDeviceTables.from_host(jt, jreg),
            DeviceTables.from_host(tload_tables(), treg, "cpu"))


@pytest.mark.parametrize("with_priors", [False, True],
                         ids=["no-prior", "prior"])
def test_plain_scorer_on_hinted_wires(scorers, with_priors):
    """score_chunks_plain on a real hinted wire: word1 equals the JAX
    score_chunks and the numpy oracle, full output the JAX
    score_chunks_full."""
    jt, jdt, tdt = scorers
    _, tcb = _hinted_packs(with_priors, _eval_docs()[:60] + PRIOR_TEXTS)
    w = wire_to_device(tcb.wire, "cpu")
    got = words_to_numpy(score_chunks_plain(tdt, w))
    gotf = words_to_numpy(score_chunks_plain(tdt, w, full_out=True))
    assert np.array_equal(got, np.asarray(score_chunks(jdt, tcb.wire)))
    assert np.array_equal(got, oracle_score_chunks(jt, jreg, tcb.wire))
    assert np.array_equal(gotf,
                          np.asarray(score_chunks_full(jdt, tcb.wire)))


@pytest.fixture(scope="module")
def engines():
    return (NgramBatchEngine(device="cpu", hint_priors=False),
            NgramBatchEngine(device="cpu", hint_priors=True))


def test_documented_hint_flip(engines):
    """HINT_DEMO_TEXT with content-language `id` answers `id` through
    the port's engine only with hint priors on, as the reference's
    flip demo documents."""
    off, on = engines
    demo = hint_flip_demo()
    h = thints.CLDHints(content_language_hint=HINT_DEMO_HINT)
    got_off = off.detect_batch([HINT_DEMO_TEXT], hints=h)[0]
    got_on = on.detect_batch([HINT_DEMO_TEXT], hints=h)[0]
    assert treg.code(got_on.summary_lang) == demo["after"] == "id"
    assert treg.code(got_off.summary_lang) == demo["before"] != "id"


def _rows(results) -> list:
    return [(r.summary_lang, tuple(r.language3), tuple(r.percent3),
             tuple(r.normalized_score3), r.text_bytes, r.is_reliable)
            for r in results]


# one CLDHints per detect_batch call, as the API applies them
ENGINE_HINTS = [dict(content_language_hint="id"),
                dict(tld_hint="rs"),
                dict(content_language_hint="sr,no"),
                dict(encoding_hint="CHINESE_GB"),
                dict(language_hint=jreg.code_to_lang["nl"],
                     content_language_hint="de")]


def _hint_docs() -> list[str]:
    docs = _eval_docs()
    return docs[::2] + [d[:40] for d in docs[1::4]] + PRIOR_TEXTS + \
        ["", "a", " ".join(docs[:30])]


@pytest.mark.parametrize("priors", [False, True], ids=["off", "on"])
def test_hinted_engine_matches_reference(engines, monkeypatch, priors):
    """detect_batch(hints=...) answers like the JAX engine (LDT_HINTS
    set to match) on every document, for every hint object; with
    priors off also like the port's detect_scalar on a sample."""
    from language_detector_tpu.models.ngram import \
        NgramBatchEngine as JaxEngine
    monkeypatch.setenv("LDT_HINTS", "1" if priors else "0")
    jeng = JaxEngine()
    assert jeng.hint_priors_enabled == priors
    eng = engines[priors]
    docs = _hint_docs()
    for kw in ENGINE_HINTS:
        got = eng.detect_batch(docs, hints=thints.CLDHints(**kw))
        assert _rows(got) == _rows(jeng.detect_batch(
            docs, hints=jhints.CLDHints(**kw))), kw
        if not priors:
            for i in range(0, len(docs), 7):
                want = detect_scalar(docs[i], eng.tables, eng.reg,
                                     hints=thints.CLDHints(**kw))
                assert _rows([got[i]]) == _rows([want]), (kw, docs[i][:40])


def _html_docs() -> list[str]:
    docs = _eval_docs()
    langs = ["fr", "de", None, "sr", "ms", "pt-BR"]
    out = []
    for i, d in enumerate(docs[:90]):
        lang = langs[i % len(langs)]
        attr = f' lang="{lang}"' if lang else ""
        out.append(f"<html{attr}><head><style>p {{ color: red }}</style>"
                   f"<script>var x = '{d[:20]}';</script></head><body>"
                   f"<p>{d}</p><p>caf&eacute; &amp; &lt;b&gt;</p>"
                   "</body></html>")
    out.append('<meta http-equiv=content-language content="id" x=y><p>'
               + PRIOR_TEXTS[1] + "</p>")
    out += ["<p></p>", "", "plain text without tags"]
    return out


@pytest.mark.parametrize("hint", [None, "content-language"])
def test_html_engine_matches_reference(engines, hint):
    """detect_batch(is_plain_text=False) answers like the JAX engine and
    the port's detect_scalar, lang= attributes scanned per document."""
    from language_detector_tpu.models.ngram import \
        NgramBatchEngine as JaxEngine
    eng = engines[0]
    docs = _html_docs()
    kw = {} if hint is None else {"content_language_hint": "fr"}
    th = thints.CLDHints(**kw) if kw else None
    jh = jhints.CLDHints(**kw) if kw else None
    got = eng.detect_batch(docs, hints=th, is_plain_text=False)
    assert _rows(got) == _rows(JaxEngine().detect_batch(
        docs, hints=jh, is_plain_text=False))
    for i in range(0, len(docs), 5):
        want = detect_scalar(docs[i], eng.tables, eng.reg, hints=th,
                             is_plain_text=False)
        assert _rows([got[i]]) == _rows([want]), docs[i][:60]


def test_hint_priors_read_environment(monkeypatch):
    """hint_priors=None reads LDT_HINTS with the reference's boolean
    rule (unset, "", 0, false, no and off mean off); an explicit value
    wins over the environment."""
    monkeypatch.delenv("LDT_HINTS", raising=False)
    assert not NgramBatchEngine(device="cpu").hint_priors_enabled
    for v, on in (("1", True), ("yes", True), (" Off ", False),
                  ("0", False), ("", False)):
        monkeypatch.setenv("LDT_HINTS", v)
        assert NgramBatchEngine(device="cpu").hint_priors_enabled == on, v
    monkeypatch.setenv("LDT_HINTS", "0")
    assert NgramBatchEngine(device="cpu",
                            hint_priors=True).hint_priors_enabled
