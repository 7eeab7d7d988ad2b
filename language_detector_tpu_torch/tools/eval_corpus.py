"""Per-language precision/recall/F evaluation harness.

The port of the reference package's offline evaluator
(tools/eval_corpus.py, itself the rebuild of CLD2's scoreutf8text.cc):
detect every labeled document, tally per-language correct/wrong-got/
wrong-missed counts, and print per-language precision/recall/F plus the
_Totals_Known aggregate row and the top confusions per language. The
report is the reference's, byte for byte apart from the rate in its
first line.

Input: a TSV of "code<TAB>text" lines (--corpus, streamed — corpora of
millions of lines never fully materialize), or the CLD2 golden suite
from LDT_REFERENCE_DIR by default. Detection runs the port's batched
engine (codes only, 16K-document slices) over 65,536-document blocks on
--device: cuda by default, which raises without CUDA; cpu scores with
the plain PyTorch version. There is no scalar fallback. --mesh N shards
the blocks over an N-device mesh and raises when fewer devices exist.

Usage:
  python -m language_detector_tpu_torch.tools.eval_corpus
      [--corpus file.tsv] [--out eval.txt] [--mesh N] [--limit N]
      [--warm] [--quad-tables file.npz] [--device {cuda,cpu}]
"""
from __future__ import annotations

import argparse
import collections
import time
from pathlib import Path

from ..registry import registry
from ..tables import ScoringTables
from .fuzz import golden_pairs

# label aliases: the golden labels use a few codes the newer registry
# renames (the reference's tests/test_golden_parity.py applies the same
# equivalence)
ALIASES = {("hmn", "blu"): True}


def iter_pairs(path: str | None, limit: int | None = None):
    """Stream (label, text) pairs; TSV files are read line-by-line so a
    multi-GB corpus never materializes. Lines without a tab are
    skipped."""
    n = 0
    if path:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                if "\t" not in line:
                    continue
                code, text = line.rstrip("\n").split("\t", 1)
                yield code.strip(), text
                n += 1
                if limit and n >= limit:
                    return
        return
    for _, lang, raw in golden_pairs():
        yield lang, raw.decode("utf-8", errors="replace")
        n += 1
        if limit and n >= limit:
            return


def make_detector(tables, mesh_size: int | None = None,
                  device: str = "cuda"):
    """codes-detector over 16K-doc slices: the port's batched engine on
    `device`, sharded over a mesh of mesh_size devices when asked (a
    CPU mesh of that many shards with device cpu). Raises without the
    devices asked for."""
    from ..models.ngram import NgramBatchEngine
    mesh = None
    if mesh_size:
        from ..parallel.mesh import batch_mesh
        mesh = (batch_mesh(mesh_size, devices=["cpu"] * mesh_size)
                if device == "cpu" else batch_mesh(mesh_size))
    eng = NgramBatchEngine(tables, registry, device=device, mesh=mesh)
    return lambda texts: eng.detect_codes(texts, batch_size=16384)


BLOCK = 65536  # docs per streamed detection block


def evaluate(pair_iter, tables, mesh_size: int | None = None,
             warm: bool = False, device: str = "cuda") -> str:
    """The report over every pair. warm=True runs the first block once,
    untimed, before timing it (the first call loads the kernel library
    and fills the staging ring; a small suite would otherwise publish a
    start-up-dominated rate)."""
    detect = make_detector(tables, mesh_size, device)
    per_lang = collections.defaultdict(lambda: dict(correct=0, got=0,
                                                    actual=0))
    confusion = collections.defaultdict(collections.Counter)
    n_docs = 0
    took = 0.0
    block: list = []

    def flush():
        nonlocal n_docs, took
        if not block:
            return
        t0 = time.time()
        got = detect([t for _, t in block])
        took += time.time() - t0
        n_docs += len(block)
        for (want, _), g in zip(block, got):
            hit = g == want or (g, want) in ALIASES
            per_lang[want]["actual"] += 1
            per_lang[g]["got"] += 1
            if hit:
                per_lang[want]["correct"] += 1
            else:
                confusion[want][g] += 1
        block.clear()

    for pair in pair_iter:
        block.append(pair)
        if len(block) >= BLOCK:
            if warm:
                detect([t for _, t in block])  # start-up pass, untimed
                warm = False
            flush()
    if warm and block:
        detect([t for _, t in block])  # start-up pass, untimed
    flush()

    lines = []
    lines.append(f"Evaluation over {n_docs} labeled documents "
                 f"({len(per_lang)} languages), "
                 f"{n_docs/max(took,1e-9):.0f} docs/sec")
    lines.append("")
    lines.append(f"{'Language':12s} {'Precision':>9s} {'Recall':>8s} "
                 f"{'F':>7s} {'N':>6s}  Top confusions")
    tot_c = tot_g = tot_a = 0
    for code in sorted(per_lang):
        d = per_lang[code]
        if d["actual"] == 0:
            continue  # only appears as a wrong guess
        prec = d["correct"] / d["got"] if d["got"] else 0.0
        rec = d["correct"] / d["actual"]
        f = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        conf = " ".join(f"{g}={n}" for g, n in
                        confusion[code].most_common(5))
        lines.append(f"{code:12s} {prec*100:8.2f}% {rec*100:7.2f}% "
                     f"{f:7.4f} {d['actual']:6d}  {conf}")
        tot_c += d["correct"]
        tot_g += d["got"]
        tot_a += d["actual"]
    prec = tot_c / tot_g if tot_g else 0.0
    rec = tot_c / tot_a if tot_a else 0.0
    f = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    lines.append("")
    lines.append(f"{'_Totals_Known':12s} {prec*100:8.2f}% {rec*100:7.2f}% "
                 f"{f:7.4f} {tot_a:6d}")
    return "\n".join(lines) + "\n"


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default=None,
                    help="TSV code<TAB>text (default: golden suite)")
    ap.add_argument("--quad-tables", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh", type=int, default=None,
                    help="shard blocks over an N-device mesh")
    ap.add_argument("--limit", type=int, default=None,
                    help="stop after N corpus lines")
    ap.add_argument("--warm", action="store_true",
                    help="run the first block once untimed before timing "
                         "(small suites)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without CUDA) or cpu "
                         "(the plain PyTorch scorer)")
    args = ap.parse_args(argv)

    tables = ScoringTables.load(quad_path=args.quad_tables)
    pairs = iter_pairs(args.corpus, args.limit)
    report = evaluate(pairs, tables, args.mesh, warm=args.warm,
                      device=args.device)
    print(report)
    if args.out:
        Path(args.out).write_text(report)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
