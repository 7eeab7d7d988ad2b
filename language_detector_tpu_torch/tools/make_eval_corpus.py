"""Expand the golden suite into a large labeled TSV corpus.

The port of the reference package's tools/make_eval_corpus.py. The
reference's published evaluations run ~765K labeled documents
(cld2/docs/evaluate_cld2_large_20140122.txt); the snapshot carries no
such corpus, so this derives one from the golden documents: per
document, deterministic contiguous word windows (30-60 words, seed
20260730, fuzz.window_pairs) — window sampling preserves the document's
language while varying the n-gram mix, so the large-scale eval
exercises real per-document variance instead of identical copies. The
file is the reference's byte for byte.

Departure from the reference script: the golden suite is read from the
snapshot LDT_REFERENCE_DIR names (fuzz.golden_pairs); without one the
tool stops with "golden suite unavailable", as the reference does when
its fixed snapshot path is absent.

Usage:
  python -m language_detector_tpu_torch.tools.make_eval_corpus OUT.tsv [n_docs]
"""
from __future__ import annotations

import sys

from .fuzz import WINDOW_SEED, golden_pairs, window_pairs


def main(out: str, n_docs: int = 100_000) -> None:
    pairs = [(lang, raw.decode("utf-8", errors="replace"))
             for _, lang, raw in golden_pairs()]
    if not pairs:
        sys.exit("golden suite unavailable")
    with open(out, "w", encoding="utf-8") as f:
        for lang, doc in window_pairs(pairs, n_docs, WINDOW_SEED):
            f.write(f"{lang}\t{doc}\n")
    print(f"wrote {n_docs} docs to {out}")


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:]))
