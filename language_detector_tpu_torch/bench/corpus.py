"""The bench's documents and synthetic captures.

Copies of the reference's bench.py corpora (make_mixed_corpus,
make_longheavy_corpus, make_longtail_corpus, _synth_replay_text,
synth_capture_records), so that the port imports nothing of the
reference package. make_corpus and _SEEDS are tools/fuzz.py's, which
already copies bench.make_corpus.
"""
from __future__ import annotations

import random

from ..tools.fuzz import _SEEDS, make_corpus

__all__ = ["make_corpus", "make_mixed_corpus", "make_longheavy_corpus",
           "make_longtail_corpus", "synth_capture_records"]


def make_mixed_corpus(n: int) -> list:
    """Realistic traffic mix: service-sized docs plus a spam tail (1%
    squeeze-trigger documents), 2% long documents (3-8KB), and 1%
    degenerate inputs. Measures what the clean corpus cannot: squeeze,
    retry, and long-doc cost."""
    docs = make_corpus(n)
    for i in range(0, n, 100):            # 1% spam -> squeeze fallback
        docs[i] = ("buy cheap now " * 300).strip()
    for i in range(37, n, 50):            # 2% long docs
        parts = [docs[(i + j * 13 + 1) % n] for j in range(20 + i % 21)]
        docs[i] = " ".join(parts)
    for i in range(73, n, 100):           # 1% degenerate
        docs[i] = ["", "   ", "123 !!!", "a"][i // 100 % 4]
    return docs


def make_longheavy_corpus(n: int) -> list:
    """Long-document-heavy mix: 25% of documents are 3-20KB (multi-span,
    multi-chunk), the rest service-sized. Report MB/s alongside
    docs/sec: the average document here is ~10x the service mix."""
    docs = make_corpus(n)
    base = list(docs)  # compose from the pristine service docs only
    for i in range(0, n, 4):              # 25% long docs, 3-20KB
        reps = 20 + (i * 7) % 120
        parts = [base[(i + j * 11 + 3) % n] for j in range(reps)]
        docs[i] = " ".join(parts)
    return docs


def make_longtail_corpus(n: int) -> list:
    """Fat-tail documents (~18-60KB) past the long-doc lane's engage
    threshold, so every one takes the span-split lane. Each doc is
    dominated by one script with a sprinkle of foreign sentences:
    multi-span enough to split, single-language enough to pass the
    reliability gate."""
    rng = random.Random(7)
    out = []
    for i in range(n):
        home = _SEEDS[i % len(_SEEDS)]
        foreign = _SEEDS[(i + 3) % len(_SEEDS)]
        words = home.split()
        target = 18_000 + (i * 4099) % 42_000
        parts, size = [], 0
        while size < target:
            rng.shuffle(words)
            sent = " ".join(words)
            if rng.random() < 0.08:       # ~8% embedded foreign spans
                sent = foreign
            parts.append(sent)
            size += len(sent) + 1
        out.append(" ".join(parts))
    return out


def _synth_replay_text(tenant_hash: int, seq: int, target_bytes: int,
                       dup_modulo: int = 16) -> str:
    """Deterministic payload synthesis for replay: a capture stores
    shape (size bucket, doc count), never content, so replay fabricates
    text to the recorded size. Keying the RNG on (tenant, seq %
    dup_modulo) makes each tenant cycle a small set of distinct
    documents, the duplicate-heavy stream that exercises the result
    caches."""
    rng = random.Random((tenant_hash & 0xFFFFFFFF) * 31
                        + seq % dup_modulo)
    vocab = _SEEDS[rng.randrange(len(_SEEDS))].split()
    words = []
    size = 0
    while size < max(target_bytes, 8):
        w = vocab[rng.randrange(len(vocab))]
        words.append(w)
        size += len(w.encode()) + 1
    return " ".join(words)


def synth_capture_records(n: int = 2000, tenants: int = 32,
                          rate_rps: float = 200.0,
                          seed: int = 1234) -> list:
    """Synthetic capture for `--replay-synth zipf`: zipfian tenant skew
    (rank-r tenant gets ~1/r of the traffic) over exponential
    interarrivals, small doc counts, service-sized byte buckets, and a
    10% priority mix. Records use capture.merge_captures()'s dict
    shape, so replay_records cannot tell them from a real
    capture."""
    from .. import capture as cap

    rng = random.Random(seed)
    weights = [1.0 / r for r in range(1, tenants + 1)]
    total_w = sum(weights)
    cum = []
    acc = 0.0
    for w in weights:
        acc += w / total_w
        cum.append(acc)
    out = []
    t_ns = 0
    for _ in range(n):
        t_ns += int(rng.expovariate(rate_rps) * 1e9)
        u = rng.random()
        rank = next(r for r, edge in enumerate(cum) if u <= edge)
        tenant = f"tenant-{rank:02d}"
        out.append({
            "arrival_ns": t_ns,
            "tenant": tenant,
            "tenant_hash": cap.tenant_hash(tenant),
            "docs": 1 + rng.randrange(8),
            "size_bucket": 8 + rng.randrange(4),
            "approx_bytes": 1 << (7 + rng.randrange(4)),
            "deadline_ms": 0.0,
            "priority": rng.random() < 0.10,
            "verdict": "ok",
        })
    return out
