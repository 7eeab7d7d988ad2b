"""Divergence soak: every engine path against the scalar oracle.

The port of the reference package's tools/soak.py. Randomized fuzz
documents (tools/fuzz.py's construction soup) go through each
production path of the port's engine, and every answer is held to
detect_scalar's:

  plain    detect_batch, full ScalarResult tuple equality
  codes    multi-slice detect_codes (ragged slices force the deferred
           cross-slice gate-retry path)
  hints    TLD + content-language hints
  html     is_plain_text=False with rotating lang= attributes
  vectors  return_chunks: per-range vector AND summary equality
  c-abi    raw ctypes detect_language_n vs the device engine
  buckets  documents straddling each slot-tier boundary, through the
           tiered scheduler and the retry lane
  dedup    heavy duplication through detect_many
  cache    the same documents twice through a cache-enabled Batcher

Each path is a function (engine, docs) -> mismatches; soak() runs them
at a scale (1 = the reference's counts, about 7K documents). On the
card it also holds the kernel's launches to the engine's dispatches.
Prints SOAK CLEAN and exits 0, or SOAK FAILED (n) and exits 1.

Usage:
  python -m language_detector_tpu_torch.tools.soak [scale]
      [--device {cuda,cpu}]
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import random

from ..hints import CLDHints
from .fuzz import fuzz_docs

HINTS = (CLDHints(tld_hint="fr"), CLDHints(content_language_hint="de,en"))


def stuple(r) -> tuple:
    return (r.summary_lang, list(r.language3), list(r.percent3),
            r.text_bytes, r.is_reliable)


class Oracle:
    """detect_scalar on the engine's tables, each (text, options)
    answered once: paths that share documents share the answers."""

    def __init__(self, eng):
        self.eng = eng
        self._memo: dict = {}

    def __call__(self, text: str, is_plain_text: bool = True, hints=None,
                 want_chunks: bool = False):
        from ..engine_scalar import detect_scalar
        key = (text, is_plain_text, repr(hints), want_chunks)
        r = self._memo.get(key)
        if r is None:
            r = self._memo[key] = detect_scalar(
                text, self.eng.tables, self.eng.reg, 0,
                is_plain_text=is_plain_text, hints=hints,
                want_chunks=want_chunks)
        return r


def _n(base: int, scale: float) -> int:
    return max(1, round(base * scale))


def soak_docs(scale: float = 1) -> dict:
    """Each path's documents at a scale, from the reference's seeds
    (99001-99023) and counts (times scale)."""
    from ..preprocess.pack import SLOT_TIER_BUDGETS, tier_max_chars
    docs = fuzz_docs(_n(2048, scale), seed=99001)
    nh = _n(256, scale)
    hdocs = fuzz_docs(nh, seed=99002)
    rng = random.Random(99003)
    html_docs = [
        f"<html lang='{rng.choice(['fr', 'ja', '', 'de'])}'>"
        f"<p>{d[:400]}</p></html>"
        for d in fuzz_docs(nh, seed=99004)]
    # bucket boundaries: docs whose length straddles each slot-budget
    # tier (length m-1 / m / m+1 at every boundary)
    src = " ".join(fuzz_docs(48, seed=99020))
    while len(src) < tier_max_chars(len(SLOT_TIER_BUDGETS) - 1) + 4096:
        src += " " + src
    bdocs = []
    for k in range(len(SLOT_TIER_BUDGETS)):
        m = tier_max_chars(k)
        for i in range(_n(8, scale)):
            for delta in (-1, 0, 1):
                start = (i * 241) % 1024
                bdocs.append(src[start:start + m + delta])
    bdocs += fuzz_docs(_n(64, scale), seed=99022)
    uniq = fuzz_docs(_n(64, scale), seed=99021)
    rngd = random.Random(99023)
    ddocs = [uniq[rngd.randrange(len(uniq))]
             for _ in range(_n(256, scale))]
    return {"plain": docs, "hints": hdocs, "html": html_docs,
            "vectors": fuzz_docs(_n(192, scale), seed=99005),
            "c_abi": fuzz_docs(_n(1024, scale), seed=99010),
            "buckets": bdocs, "dedup": ddocs}


@contextlib.contextmanager
def tiered(eng):
    """Instance overrides that force the tiered scheduler and the retry
    lane at soak batch sizes."""
    eng.TIER_MIN_DOCS = 16
    eng.RETRY_LANE_MIN = 4
    eng.TIER_COALESCE_MIN = 1
    try:
        yield eng
    finally:
        del eng.TIER_MIN_DOCS, eng.RETRY_LANE_MIN, eng.TIER_COALESCE_MIN


def run_batch(eng, docs, oracle=None, **kw) -> int:
    """detect_batch(docs, **kw) (plain text, hints=, or
    is_plain_text=False), full result tuples against the oracle's with
    the same options."""
    oracle = oracle or Oracle(eng)
    got = eng.detect_batch(docs, **kw)
    return sum(1 for t, g in zip(docs, got)
               if stuple(g) != stuple(oracle(t, **kw)))


def run_codes(eng, docs, oracle=None) -> int:
    """Held to the scalar engine's summary code (the reference holds
    them to detect_batch's, which the plain path holds to it)."""
    oracle = oracle or Oracle(eng)
    codes = eng.detect_codes(docs, batch_size=257)
    return sum(1 for t, c in zip(docs, codes)
               if eng.reg.code(oracle(t).summary_lang) != c)


def run_vectors(eng, docs, oracle=None) -> int:
    oracle = oracle or Oracle(eng)
    got = eng.detect_batch(docs, return_chunks=True)
    bad = 0
    for t, g in zip(docs, got):
        w = oracle(t, want_chunks=True)
        gch = [(c.offset, c.bytes, c.lang1) for c in (g.chunks or [])]
        wch = [(c.offset, c.bytes, c.lang1) for c in (w.chunks or [])]
        if gch != wch or g.summary_lang != w.summary_lang:
            bad += 1
    return bad


def run_c_abi(eng, docs, oracle=None) -> int:
    """The packer library's own detect_language_n (the all-C path, on
    the tables the engine serves) against the engine's codes."""
    from .. import native
    lib = native.ensure_init(eng.tables, eng.reg)
    want = eng.detect_codes(docs, batch_size=16384)
    bad = 0
    for t, w in zip(docs, want):
        enc = t.encode("utf-8", "surrogatepass")
        if lib.detect_language_n(enc, len(enc)).decode() != w:
            bad += 1
    return bad


def run_many(eng, docs, oracle=None) -> int:
    """detect_many under the tiered overrides: the bucket-boundary
    documents route to adjacent shape lanes and the dedup repeats fan
    out, and every answer must be the oracle's."""
    oracle = oracle or Oracle(eng)
    with tiered(eng):
        got = eng.detect_many(docs, batch_size=64)
    return sum(1 for t, g in zip(docs, got)
               if stuple(g) != stuple(oracle(t)))


def run_cache(eng, docs, oracle=None) -> int:
    """Twice through a cache-enabled Batcher: every engine dedup and
    cache hit must answer the oracle, and the second pass must hit
    (zero hits counts as one failure)."""
    from ..service.batcher import Batcher
    oracle = oracle or Oracle(eng)
    want = {t: eng.reg.code(oracle(t).summary_lang) for t in set(docs)}
    with tiered(eng):
        bat = Batcher(lambda ts: eng.detect_codes(ts, batch_size=128),
                      cache_bytes=8 << 20)
        try:
            bad = 0
            for _pass in range(2):  # second pass serves from the cache
                got = bat.submit(docs).result(timeout=600)
                bad += sum(1 for t, c in zip(docs, got) if want[t] != c)
            cs = bat.cache_stats()
        finally:
            bat.close()
    print(f"{'cache hit rate':28s} {cs['hit_rate']:.3f} "
          f"({cs['hits']} hits)", flush=True)
    if cs["hits"] == 0:
        print("cache hit soak: zero hits (cache inert?)")
        bad += 1
    return bad


# (report label, documents key, path function, documents it answers
# per document given)
PATHS = (
    ("plain detect_batch", "plain", run_batch, 1),
    ("codes multi-slice+retry", "plain", run_codes, 1),
    ("hints fr", "hints", functools.partial(run_batch, hints=HINTS[0]), 1),
    ("hints de,en", "hints", functools.partial(run_batch, hints=HINTS[1]),
     1),
    ("html", "html", functools.partial(run_batch, is_plain_text=False), 1),
    ("chunk vectors", "vectors", run_vectors, 1),
    ("raw C ABI", "c_abi", run_c_abi, 1),
    ("bucket boundaries", "buckets", run_many, 1),
    ("dedup repeats", "dedup", run_many, 1),
    ("cache hits", "dedup", run_cache, 2),
)


def soak(eng, scale: float = 1) -> int:
    """Run every path at a scale, printing one line each; returns the
    failures. On a CUDA engine the kernel's launches over the run must
    equal the engine's dispatches (a difference counts as one
    failure)."""
    from ..ops import kernels
    docs = soak_docs(scale)
    oracle = Oracle(eng)
    failures = 0
    cuda = eng.device.type == "cuda"
    launches0 = kernels.launches
    dispatches0 = eng.stats_snapshot()["device_dispatches"]
    for label, key, fn, per_doc in PATHS:
        bad = fn(eng, docs[key], oracle)
        n = per_doc * len(docs[key])
        failures += bad
        print(f"{label:28s} {n - bad}/{n} exact", flush=True)
    if cuda:
        launches = kernels.launches - launches0
        dispatches = eng.stats_snapshot()["device_dispatches"] - dispatches0
        print(f"{'kernel launches':28s} {launches} "
              f"({dispatches} dispatches)", flush=True)
        if launches != dispatches:
            failures += 1
    return failures


def main(scale: float = 1, device: str = "cuda", engine=None) -> int:
    """The soak at a scale on an engine (default: a new engine on
    device); 0 when clean, else 1."""
    from ..models.ngram import NgramBatchEngine
    eng = engine if engine is not None else NgramBatchEngine(device=device)
    failures = soak(eng, scale)
    print("SOAK", "CLEAN" if failures == 0 else f"FAILED ({failures})")
    return 0 if failures == 0 else 1


def cli(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scale", nargs="?", type=float, default=1,
                    help="multiplies the per-path document counts")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without CUDA) or cpu "
                         "(the plain PyTorch scorer)")
    args = ap.parse_args(argv)
    return main(args.scale, args.device)


if __name__ == "__main__":
    raise SystemExit(cli())
