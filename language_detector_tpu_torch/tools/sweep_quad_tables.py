"""Hyperparameter sweep for the trained quadgram tables.

The port of the reference package's tools/sweep_quad_tables.py:
collects the training corpus once, then trains + evaluates each
configuration against the CLD2 golden suite in parallel worker
processes. Reports accuracy per config; use the winner for
train_quad_tables.py's defaults.

Departures from the reference script: the golden suite is read from
LDT_REFERENCE_DIR (tools/fuzz.py golden_pairs), and without one the
sweep stops with an error naming the knob (the reference divides by
zero); the workers are spawned, each handed the corpus and the suite
(the reference forks them to share the corpus copy-on-write).
Detection is the port's LanguageDetector.detect_bytes, which answers on
the all-C single-document path (or the scalar engine) and never builds
the batched engine, so no device is involved.

Usage:
  python -m language_detector_tpu_torch.tools.sweep_quad_tables
      [CONFIG_JSON ...]
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import multiprocessing as mp
import sys

from ..registry import registry
from ..tables import NgramTable, load_tables

_corpus = None
_pairs = None


def _init():
    global _corpus, _pairs
    from .fuzz import golden_pairs
    from .train_quad_tables import collect_corpus
    pairs = golden_pairs()
    if not pairs:
        raise SystemExit(
            "sweep_quad_tables: no golden suite (set LDT_REFERENCE_DIR to "
            "a CLD2 source snapshot holding cld2/internal/unittest_data.h)")
    tables = load_tables()
    _corpus = collect_corpus(tables, registry)
    _pairs = pairs


def _adopt(corpus, pairs):
    """Worker initializer: the parent's corpus and suite."""
    global _corpus, _pairs
    _corpus, _pairs = corpus, pairs


def evaluate(cfg: dict) -> tuple:
    from ..detector import LanguageDetector
    from .train_quad_tables import train
    tables = load_tables()
    out = train(tables, registry, _corpus, verbose=False, **cfg)
    quad = NgramTable.from_npz(out, "quadgram")
    prod = dataclasses.replace(
        tables, quadgram=quad,
        avg_delta_octa_score=out["expected_score_override"])
    # detect_bytes never reaches the batched engine's device
    det = LanguageDetector(tables=prod, device="cpu")
    hits = 0
    for name, lang, raw in _pairs:
        # UTF-8 validity gate, like the reference harness (CheckUTF8)
        got = det.detect_bytes(raw).language
        if got == lang or (got, lang) == ("hmn", "blu"):
            hits += 1
    return cfg, hits, len(_pairs)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    grid = []
    for shrink, slope, base in itertools.product(
            [0.1, 0.5, 2.0], [1.5, 2.5, 3.5], [5]):
        grid.append(dict(shrink=shrink, slope=slope, base=base))
    if argv:  # explicit configs as JSON dicts
        grid = [json.loads(a) for a in argv]
    _init()
    print(f"corpus items: {len(_corpus)}, goldens: {len(_pairs)}, "
          f"configs: {len(grid)}", flush=True)
    n_proc = max(1, min(len(grid), mp.cpu_count() - 2))
    if n_proc == 1:
        for cfg in grid:
            cfg, hits, total = evaluate(cfg)
            print(f"{hits:4d}/{total} = {hits/total*100:5.1f}%  {cfg}",
                  flush=True)
    else:
        ctx = mp.get_context("spawn")
        with ctx.Pool(n_proc, initializer=_adopt,
                      initargs=(_corpus, _pairs)) as pool:
            for cfg, hits, total in pool.imap_unordered(evaluate, grid):
                print(f"{hits:4d}/{total} = {hits/total*100:5.1f}%  {cfg}",
                      flush=True)


if __name__ == "__main__":
    main()
