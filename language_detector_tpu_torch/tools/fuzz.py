"""Documents for the offline tools: the bench corpus, the golden suite
and the fuzz construction soup.

Copies, so that the port imports nothing of the reference package:
make_corpus and _SEEDS are bench.py's (bench.py:44-73), fill_fuzz_docs
is tests/test_batch_agreement.py's _fill_fuzz_docs, and golden_pairs is
tests/golden_data.py's parser of the reference CLD2 suite, read from
the snapshot LDT_REFERENCE_DIR names ([] without one).
"""
from __future__ import annotations

import random
import re
from pathlib import Path

from .. import knobs

# Self-contained corpus: service-sized snippets in several scripts; padded
# with index salt so quad repeat filters see realistic variety.
_SEEDS = [
    "The quick brown fox jumps over the lazy dog near the river bank today",
    "Le gouvernement a annoncé de nouvelles mesures pour aider les familles",
    "Der Hund läuft schnell durch den großen Wald und findet einen Knochen",
    "El rápido zorro marrón salta sobre el perro perezoso cerca del río",
    "Быстрая коричневая лиса прыгает через ленивую собаку сегодня утром",
    "こんにちは世界。今日はとても良い天気ですね。散歩に行きましょう。",
    "Η γρήγορη καφέ αλεπού πηδά πάνω από το τεμπέλικο σκυλί σήμερα",
    "De snelle bruine vos springt over de luie hond bij de rivier vandaag",
    "Il veloce volpe marrone salta sopra il cane pigro vicino al fiume",
    "A rápida raposa marrom pula sobre o cachorro preguiçoso perto do rio",
]


def make_corpus(n: int) -> list:
    """n service-like documents (~150-250 bytes) cycling scripts; word
    order varies deterministically so the squeeze/repeat predictors see
    natural text, not synthetic repetition."""
    rng = random.Random(42)
    vocab = [s.split() for s in _SEEDS]
    out = []
    for i in range(n):
        words = list(vocab[i % len(_SEEDS)])
        rng.shuffle(words)
        k = 18 + (i * 7) % 14
        out.append(" ".join((words * 3)[:k]))
    return out


def fill_fuzz_docs(docs: list, rng, texts: list, n: int) -> None:
    """Append n documents built from `texts`: slices and concatenations
    across scripts, spam runs, punctuation storms, random codepoints —
    every construction the packer's special paths (squeeze, rounds,
    direct adds, boosts) can hit."""
    for i in range(n):
        kind = i % 8
        if kind == 0:    # cross-script concatenation
            docs.append(" ".join(
                texts[rng.randrange(len(texts))][:rng.randint(20, 300)]
                for _ in range(rng.randint(1, 5))))
        elif kind == 1:  # repetitive spam of a random snippet
            snip = texts[rng.randrange(len(texts))][:rng.randint(5, 30)]
            docs.append((snip + " ") * rng.randint(50, 300))
        elif kind == 2:  # mid-codepoint slices (invalid boundaries ok)
            t = texts[rng.randrange(len(texts))]
            lo = rng.randrange(max(1, len(t) - 100))
            docs.append(t[lo:lo + rng.randint(1, 80)])
        elif kind == 3:  # punctuation / digit storms
            docs.append(" ".join(
                rng.choice(["!!!", "123", "...", "@x", "#tag", "???"])
                for _ in range(rng.randint(1, 40))))
        elif kind == 4:  # random BMP codepoints
            docs.append("".join(
                chr(rng.choice([rng.randrange(0x20, 0x2000),
                                rng.randrange(0x3040, 0x9FFF)]))
                for _ in range(rng.randint(1, 120))))
        elif kind == 5:  # words glued without spaces
            t = texts[rng.randrange(len(texts))]
            docs.append(t.replace(" ", "")[:rng.randint(10, 400)])
        elif kind == 6:  # long multi-paragraph
            docs.append(" ".join(
                texts[(i * 13 + j * 7) % len(texts)][:400]
                for j in range(rng.randint(4, 12))))
        else:            # whitespace-heavy
            t = texts[rng.randrange(len(texts))][:200]
            docs.append(t.replace(" ", "   \n\t "))


# -- the reference's golden suite -----------------------------------------------

_ESC = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "'": "'"}


def _unescape(lit: str) -> bytes:
    out = bytearray()
    i = 0
    raw = lit.encode("utf-8")
    while i < len(raw):
        c = raw[i]
        if c != 0x5C:  # backslash
            out.append(c)
            i += 1
            continue
        nxt = chr(raw[i + 1])
        if nxt == "x":
            j = i + 2
            h = ""
            while j < len(raw) and chr(raw[j]) in "0123456789abcdefABCDEF":
                h += chr(raw[j])
                j += 1
            out.append(int(h, 16) & 0xFF)
            i = j
        elif nxt in "01234567":
            j = i + 1
            o = ""
            while j < len(raw) and chr(raw[j]) in "01234567" and len(o) < 3:
                o += chr(raw[j])
                j += 1
            out.append(int(o, 8) & 0xFF)
            i = j
        else:
            out.extend(_ESC.get(nxt, nxt).encode())
            i += 2
    return bytes(out)


def _expected_labels(internal: Path) -> dict:
    """kTeststr name -> expected ISO code, from the kTestPair tables
    ({LANG_ENUM, kTeststr_*} rows) resolved through the registry's C
    enum names."""
    from ..registry import registry

    cname_to_code = {str(c): str(registry.lang_code[i])
                     for i, c in enumerate(registry.lang_cname)}
    out: dict = {}
    for name in ("cld2_unittest_full.cc", "cld2_unittest.cc"):
        path = internal / name
        if not path.exists():
            continue
        for line in path.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if line.startswith("//"):
                continue
            m = re.match(r"\{(\w+),\s*kTeststr_(\w+)\}", line)
            if m and m.group(1) in cname_to_code:
                out.setdefault(m.group(2), cname_to_code[m.group(1)])
    return out


def golden_pairs(reference_dir: str | None = None) -> list:
    """[(name, expected_lang_code, text_bytes)] from the snapshot's
    unittest_data.h; reference_dir None reads LDT_REFERENCE_DIR, and
    no snapshot gives []."""
    root = reference_dir or knobs.get_str("LDT_REFERENCE_DIR")
    if not root:
        return []
    internal = Path(root) / "cld2" / "internal"
    data_h = internal / "unittest_data.h"
    if not data_h.exists():
        return []
    src = data_h.read_text(encoding="utf-8")
    # Strip line comments so commented-out variants are ignored
    src = "\n".join(ln for ln in src.splitlines()
                    if not ln.lstrip().startswith("//"))
    labels = _expected_labels(internal)
    out = []
    for m in re.finditer(
            r'const char\*\s+kTeststr_(\w+)\s*=\s*((?:"(?:[^"\\]|\\.)*"\s*)+);',
            src, re.S):
        name = m.group(1)
        lits = re.findall(r'"((?:[^"\\]|\\.)*)"', m.group(2))
        text = b"".join(_unescape(lit) for lit in lits)
        if name == "version":
            continue
        # kTestPair labels are per base name; the numbered variants
        # (kTeststr_ar2 etc.) share the base entry's language.
        base = name.rstrip("0123456789")
        lang = labels.get(name) or labels.get(base)
        if lang is None:
            # Not in any kTestPair table: fall back to the name prefix
            lang = name.split("_")[0]
        out.append((name, lang, text))
    return out


def golden_texts(reference_dir: str | None = None) -> list:
    """The golden paragraphs as text ([] without a snapshot)."""
    return [t.decode("utf-8", errors="replace")
            for _, _, t in golden_pairs(reference_dir)]


WINDOW_SEED = 20260730


def window_pairs(pairs: list, n: int, seed: int = WINDOW_SEED) -> list:
    """n (code, text) pairs cycling through `pairs`, each a seeded
    contiguous 30-60-word window of its document (the whole document
    when shorter): the reference's tools/make_eval_corpus.py windowing,
    which keeps a document's language while varying its n-gram mix."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        lang, text = pairs[i % len(pairs)]
        words = text.split()
        take = rng.randint(30, 60)
        if len(words) > take:
            start = rng.randint(0, len(words) - take)
            words = words[start:start + take]
        out.append((lang, " ".join(words).replace("\t", " ")
                    .replace("\n", " ")))
    return out


def write_windowed_tsv(out, n: int, seed: int = WINDOW_SEED) -> Path:
    """A labeled TSV of n windows of the shipped eval corpus's
    documents (data/eval_corpus.tsv)."""
    from ..tables import DATA_DIR
    with open(DATA_DIR / "eval_corpus.tsv", encoding="utf-8") as f:
        pairs = [tuple(ln.rstrip("\n").split("\t", 1)) for ln in f
                 if "\t" in ln]
    out = Path(out)
    with open(out, "w", encoding="utf-8") as f:
        for lang, doc in window_pairs(pairs, n, seed):
            f.write(f"{lang}\t{doc}\n")
    return out


def fuzz_docs(n: int, seed: int) -> list:
    """n fuzz documents over the golden suite when there is one, else
    over the bench corpus, so the soak runs without the snapshot."""
    texts = golden_texts()
    if not texts:
        base = make_corpus(64)
        texts = [" ".join(base[i:i + 12]) for i in range(0, 64, 4)]
    docs: list = []
    fill_fuzz_docs(docs, random.Random(seed), texts, n)
    return docs


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        description="write a labeled TSV of windows of the eval corpus")
    ap.add_argument("out")
    ap.add_argument("n_docs", nargs="?", type=int, default=100_000)
    args = ap.parse_args()
    write_windowed_tsv(args.out, args.n_docs)
    print(f"wrote {args.n_docs} docs to {args.out}")
