"""By hand, not a tier-1 test: the port's and the reference's quad
trainer on the full CLDR corpus (babel's CLDR phrases, gettext catalogs
and English stop words, as collect_cldr_phrases gives them on this
host; no octagram words, the CLD2 snapshot being absent) at the
defaults (65,536 primary and 8,192 dual buckets), one after the other
in one process on the CPU. Prints each one's item count and seconds,
and whether the two npz array sets are equal key for key.

    JAX_PLATFORMS=cpu python tests/torch_trainer_full_cldr.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def run(tq) -> dict:
    t0 = time.monotonic()
    tables = tq.load_tables()
    phrases = tq.collect_cldr_phrases(tables, tq.registry)
    t1 = time.monotonic()
    corpus = [(tq.quads_of_phrase(p), langs, cls)
              for p, langs, cls in phrases]
    t2 = time.monotonic()
    out = tq.train(tables, tq.registry, corpus, verbose=False)
    t3 = time.monotonic()
    print(f"{tq.__name__}: {len(phrases)} items, collect {t1 - t0:.1f} s, "
          f"fingerprints {t2 - t1:.1f} s, train {t3 - t2:.1f} s",
          flush=True)
    return out


def main() -> int:
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import train_quad_tables as ref_tq

    from language_detector_tpu_torch.tools import train_quad_tables as tq
    got, want = run(tq), run(ref_tq)
    equal = sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for k in want)
    print(f"npz arrays equal key for key: {equal} "
          f"({', '.join(f'{k} {want[k].shape}' for k in sorted(want))})")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
