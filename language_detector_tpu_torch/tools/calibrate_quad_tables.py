"""Error-driven calibration of the trained quadgram tables.

The port of the reference package's tools/calibrate_quad_tables.py: the
arithmetic, the iteration order, the seeds and the defaults are the
reference's line for line. Two passes the reference performs with big
corpora, reproduced here with synthetic per-language dev documents
sampled from the training vocabulary (octa-comment words + CLDR
phrases, train_quad_tables.py's sources):

1. **Win-rate bias calibration.** Languages with too little/too much
   training mass systematically under/over-win against their neighbors
   (e.g. Scots beating English on shared function words). Iterate:
   train -> detect dev docs -> per-language win counts -> multiplicative
   bias update bias_l *= (truth_l / wins_l)^eta -> retrain. This is class-
   prior calibration; it uses no golden-suite data.

2. **Expected-score regeneration** (cld2_do_score.cc:34 equivalent).
   Mean score/KB per (language, script4) over correctly-detected dev
   docs populates kAvgDeltaOctaScore for the trained tables, giving
   ReliabilityExpected (cldutil.cc:587-605) real data instead of the
   "no data" zero that disables it.

Prints golden-suite accuracy per iteration for monitoring (selection
uses only dev docs; the suite is read from LDT_REFERENCE_DIR, and
without one it prints 0/0).

Departures from the reference script:
  - detection runs the port's batched engine on --device: cuda by
    default, which raises without CUDA; cpu scores with the plain
    PyTorch version. There is no scalar fallback. Each iteration's
    engine is dropped before the next is built;
  - --out defaults to build/torch_tables/quad_tables.npz under the
    checkout, never the shipped language_detector_tpu/data/ file;
  - build_dev_docs takes already-collected sources, like
    train_quad_tables.collect_corpus.

make_tables swaps in the trained primary `quadgram` table and the
expected scores but keeps the base tables' `quadgram2` dual table (the
trained `quadgram2_*` arrays are written to the npz, not read here),
as the reference does.

Usage:
  python -m language_detector_tpu_torch.tools.calibrate_quad_tables
      [--iters 8] [--eta 0.5] [--docs-per-lang 12] [--train-args JSON]
      [--out PATH] [--no-expected] [--device {cuda,cpu}]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import random
from pathlib import Path

import numpy as np

from ..registry import registry
from ..tables import NgramTable, load_tables
from . import train_quad_tables as tq


def build_dev_docs(tables, reg, docs_per_lang: int = 12,
                   words_per_doc: int = 20, seed: int = 11,
                   words: list | None = None, phrases: list | None = None):
    """[(lang, text)] synthetic dev documents sampled from the training
    vocabulary, weighted like the trainer weights words. words /
    phrases: already-collected sources (collect_corpus's); None
    collects that source here."""
    if words is None:
        words = tq.collect_training_words(tables, reg)
    if phrases is None:
        phrases = tq.collect_cldr_phrases(tables, reg)
    rng = random.Random(seed)
    vocab: dict = collections.defaultdict(list)   # lang -> [(word, wt)]
    for word, langs, sw in words:
        core = word.strip("_").replace("_", " ")
        if not core:
            continue
        for lang, q in langs:
            vocab[lang].append((core, sw * 3.0 ** (q / 2.0)))
    for phrase, langs, cls in phrases:
        if cls != "cldr":
            continue  # match the production training sources
        for lang, q in langs:
            vocab[lang].append((phrase, 3.0 ** (q / 2.0)))

    docs = []
    for lang, items in sorted(vocab.items()):
        if len(items) < 25:
            continue  # too little vocabulary to make meaningful docs
        words_ = [w for w, _ in items]
        weights = [wt for _, wt in items]
        for _ in range(docs_per_lang):
            toks = rng.choices(words_, weights=weights, k=words_per_doc)
            docs.append((lang, " ".join(toks)))
    return docs


def make_tables(base_tables, out: dict):
    quad = NgramTable.from_npz(out, "quadgram")
    return dataclasses.replace(
        base_tables, quadgram=quad,
        avg_delta_octa_score=out["expected_score_override"])


def _detect(prod, texts, device) -> tuple:
    """(results, engine stats): the port's batched engine on device,
    dropped when it returns."""
    from ..models.ngram import NgramBatchEngine
    eng = NgramBatchEngine(prod, registry, device=device)
    results = eng.detect_many(texts, batch_size=4096)
    return results, eng.stats_snapshot()


def detect_all(prod, texts, device):
    """Detect a list of texts with the port's batched engine on device
    (cuda raises without a card; no scalar fallback)."""
    return _detect(prod, texts, device)[0]


def golden_accuracy(prod) -> tuple:
    from ..detector import LanguageDetector
    from .fuzz import golden_pairs
    pairs = golden_pairs()
    if not pairs:
        return 0, 0
    # detect_bytes answers on the all-C single-document path (or the
    # scalar engine); it never reaches the batched engine's device
    det = LanguageDetector(tables=prod, device="cpu")
    hits = 0
    for name, lang, raw in pairs:
        # UTF-8 validity gate, like the reference harness (CheckUTF8)
        got = det.detect_bytes(raw).language
        if got == lang or (got, lang) == ("hmn", "blu"):
            hits += 1
    return hits, len(pairs)


def expected_scores_from_dev(prod, docs, results) -> np.ndarray:
    """Regenerate kAvgDeltaOctaScore from dev scoring (cld2_do_score.cc):
    mean normalized score (score<<10/bytes ~ score/KB) per (lang,
    script4) over correctly-detected docs; zero (= model off) elsewhere;
    reference values kept for the CJK uni/bi-scored languages."""
    sums = collections.defaultdict(float)
    counts = collections.Counter()
    for (lang, text), r in zip(docs, results):
        if r.summary_lang != lang or not r.normalized_score3[0]:
            continue
        # script4 of the doc's first letter script
        sc = 0
        for ch in text:
            sc = int(prod.script_of_cp[min(ord(ch), 0x10FFFF)])
            if sc:
                break
        ls4 = {1: 0, 3: 1, 6: 2}.get(sc, 3)
        sums[(lang, ls4)] += r.normalized_score3[0]
        counts[(lang, ls4)] += 1
    expected = np.zeros_like(prod.avg_delta_octa_score)
    for key, total in sums.items():
        if counts[key] >= 4:
            expected[key[0], key[1]] = int(total / counts[key])
    for code in ("ja", "ko", "zh", "zh-Hant"):
        lang = registry.code_to_lang[code]
        expected[lang] = load_tables().avg_delta_octa_score[lang]
    return expected


def calibrate(base, corpus, docs, iters: int = 8, eta: float = 0.5,
              train_kwargs: dict | None = None, expected: bool = True,
              device="cuda") -> dict:
    """The reference main's loop over already-built inputs: `iters`
    rounds of train -> detect -> bias update, keeping the round with the
    most dev hits, then (with `expected`) the expected scores
    regenerated from its detections. Returns {"out": the npz dict,
    "iterations": [{"dev_hits", "wins", "bias" (the bias trained
    with), "dispatches", "card_bytes" (CUDA memory allocated after the
    round's engine was dropped; None on the CPU)}], "best_dev_hits",
    "bias": the best round's, "expected_dispatches"}."""
    train_kwargs = train_kwargs or {}
    texts = [t for _, t in docs]
    truth = collections.Counter(lang for lang, _ in docs)
    cuda = str(device).startswith("cuda")
    if cuda:
        import torch

    bias: dict = {}
    best = None
    history = []
    for it in range(max(iters, 1)):
        out = tq.train(base, registry, corpus, lang_bias=bias,
                       verbose=False, **train_kwargs)
        prod = make_tables(base, out)
        results, stats = _detect(prod, texts, device)
        wins = collections.Counter(r.summary_lang for r in results)
        dev_hits = sum(1 for (lang, _), r in zip(docs, results)
                       if r.summary_lang == lang)
        gh, gt = golden_accuracy(prod)
        print(f"iter {it}: dev {dev_hits}/{len(docs)} "
              f"({dev_hits/len(docs)*100:.1f}%), golden {gh}/{gt} "
              f"({gh/max(gt,1)*100:.1f}%)", flush=True)
        history.append({
            "dev_hits": dev_hits, "wins": dict(wins), "bias": dict(bias),
            "dispatches": stats["device_dispatches"],
            "card_bytes": torch.cuda.memory_allocated(device)
            if cuda else None})
        if best is None or dev_hits > best[0]:
            best = (dev_hits, dict(bias), out, docs, results)
        # multiplicative win-rate update on languages in the dev set
        for lang, t in truth.items():
            w = wins.get(lang, 0)
            upd = ((t / max(w, 0.5)) ** eta)
            bias[lang] = float(np.clip(bias.get(lang, 1.0) * upd, 0.25,
                                       4.0))

    dev_hits, bias, out, docs, results = best
    print(f"best dev: {dev_hits}/{len(docs)}; bias entries: "
          f"{sum(1 for v in bias.values() if abs(v-1) > 0.01)}")
    expected_dispatches = 0
    if expected:
        prod = make_tables(base, out)
        results, stats = _detect(prod, texts, device)
        expected_dispatches = stats["device_dispatches"]
        out["expected_score_override"] = expected_scores_from_dev(
            prod, docs, results)
        prod = make_tables(base, out)
        gh, gt = golden_accuracy(prod)
        print(f"with regenerated expected scores: golden {gh}/{gt} "
              f"({gh/max(gt,1)*100:.1f}%)")
    return {"out": out, "iterations": history, "best_dev_hits": dev_hits,
            "bias": bias, "expected_dispatches": expected_dispatches}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--eta", type=float, default=0.5)
    ap.add_argument("--docs-per-lang", type=int, default=12)
    ap.add_argument("--train-args", default="{}",
                    help="JSON kwargs forwarded to train()")
    ap.add_argument("--out", default=str(tq.DEFAULT_OUT))
    ap.add_argument("--no-expected", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the dev documents are scored (cuda "
                    "raises without a card)")
    args = ap.parse_args(argv)
    train_kwargs = json.loads(args.train_args)

    from ..models.ngram import resolve_device
    resolve_device(args.device)
    base = load_tables()
    corpus = tq.collect_corpus(base, registry)
    print(f"corpus items: {len(corpus)}", flush=True)
    docs = build_dev_docs(base, registry, docs_per_lang=args.docs_per_lang)
    truth = collections.Counter(lang for lang, _ in docs)
    print(f"dev docs: {len(docs)} across {len(truth)} languages",
          flush=True)
    run = calibrate(base, corpus, docs, args.iters, args.eta,
                    train_kwargs, not args.no_expected, args.device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **run["out"])
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
