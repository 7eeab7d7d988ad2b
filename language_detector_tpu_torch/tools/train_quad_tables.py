"""Train replacement quadgram tables for the port's scorer.

The port of the reference package's tools/train_quad_tables.py: the
arithmetic, the iteration order, the seeds and the defaults are the
reference's line for line, so the arrays come out equal. The CLD2
snapshot's two quadgram data files are missing, which cripples
Latin/Cyrillic/Greek-script detection. This tool rebuilds a quadgram
table from the labeled word data embedded in the octagram table
sources: every kept bucket entry in cld2_generated_deltaocta0527.cc /
cld2_generated_distinctocta0527.cc carries its word as a source
comment, positionally aligned with the packed (lang, qprob) payloads
already extracted into the artifact; plus CLDR phrases from babel
(cldr_vocab.py).

Pipeline:
  1. parse (bucket, slot) -> word from the snapshot's source comments
  2. join with the extracted buckets/indirect arrays -> (word, [(lang, q)])
  3. scan each word with the runtime's own quad scanner -> quadgram FPs
  4. accumulate weighted per-language counts per FP
  5. quantize top-3 languages to a kLgProbV2Tbl subscript, pack langprobs,
     distribute into a 4-way-associative bucket table (CLD2 layout)
  6. write the npz to --out

Departures from the reference script:
  - the generated-table sources are read from
    $LDT_REFERENCE_DIR/cld2/internal/; without the knob or a file the
    trainer raises, naming both (it never trains on an empty octagram
    corpus);
  - --out defaults to build/torch_tables/quad_tables.npz under the
    checkout, never the shipped language_detector_tpu/data/ file; the
    tables are served through ScoringTables.load(quad_path=...);
  - collect_corpus takes already-collected sources (read_phrases reads
    a "code<TAB>qprob<TAB>phrase" file of CLDR phrases).

Usage:
  python -m language_detector_tpu_torch.tools.train_quad_tables
      [--buckets 65536] [--cldr-weight 2.0] [--shrink 0.0] [--out PATH]
"""
from __future__ import annotations

import argparse
import collections
import re
from pathlib import Path

import numpy as np

from .. import knobs
from ..preprocess.grams import quad_positions
from ..preprocess.hashing import quad_hash_v2, quad_subscript_key
from ..registry import registry
from ..tables import load_tables

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "build" / "torch_tables" / "quad_tables.npz"


def source_path(name: str) -> Path:
    """$LDT_REFERENCE_DIR/cld2/internal/<name>, the snapshot's generated
    table source; raises naming the knob when it is unset or the file
    is absent."""
    root = knobs.get_str("LDT_REFERENCE_DIR")
    if not root:
        raise FileNotFoundError(
            f"LDT_REFERENCE_DIR is unset: the trainer reads {name} from "
            "$LDT_REFERENCE_DIR/cld2/internal/ (a CLD2 source snapshot)")
    path = Path(root) / "cld2" / "internal" / name
    if not path.is_file():
        raise FileNotFoundError(
            f"{path} is missing: LDT_REFERENCE_DIR={root} holds no "
            f"cld2/internal/{name}")
    return path


def read_phrases(path) -> list:
    """[(phrase, [(lang, q)], "cldr")] from a "code<TAB>qprob<TAB>phrase"
    file (one already-collected CLDR phrase a line), in the shape
    collect_cldr_phrases returns."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            code, q, phrase = line.rstrip("\n").split("\t")
            out.append((phrase, [(registry.code_to_lang[code], int(q))],
                        "cldr"))
    return out


# kLgProbV2Tbl backmap (cldutil_shared.h:311-314): row of the (hi, lo=1)
# entry per hi value; row hi,lo = backmap[hi] + (lo - 1).
BACKMAP = [0, 0, 1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 66]


def parse_words(path: Path) -> dict:
    """(bucket_index, slot) -> word, from the generated table's comments."""
    words = {}
    bucket = 0
    pat = re.compile(r"\{\{0x[0-9a-f]{8},0x[0-9a-f]{8},0x[0-9a-f]{8},"
                     r"0x[0-9a-f]{8}\}\},\s*//(.*)$")
    in_table = False
    for line in path.read_text(encoding="utf-8").splitlines():
        if "static const IndirectProbBucket4" in line:
            in_table = True
            bucket = 0
            continue
        if not in_table:
            continue
        if line.startswith("};"):
            break
        m = pat.search(line)
        if not m:
            continue
        comment = m.group(1).strip()
        comment = re.sub(r"^\[\w+\]\s*", "", comment)  # strip [150] markers
        parts = [w.strip() for w in comment.split(",")]
        parts = [w for w in parts if w]
        for slot, w in enumerate(parts[:4]):
            if w:
                words[(bucket, slot)] = w
        bucket += 1
    return words


def decode_langprob_langs(lp: int, othr: bool, tables, reg):
    """langprob -> [(lang, qprob)] using the word's script side."""
    entry = tables.lg_prob[lp & 0xFF]
    out = []
    for j, shift in enumerate((8, 16, 24)):
        pslang = (lp >> shift) & 0xFF
        if pslang == 0:
            continue
        lang = int(reg.plang_to_lang_othr[pslang] if othr
                   else reg.plang_to_lang_latn[pslang])
        out.append((lang, int(entry[5 + j])))
    return out


def word_payload(table, bucket: int, slot: int):
    """(bucket, slot) -> list of packed langprobs, or []."""
    kv = int(table.buckets[bucket, slot])
    if kv == 0:
        return []
    ind = kv & ~table.keymask & 0xFFFFFFFF
    if ind < table.size_one:
        lp = int(table.ind[ind])
        return [lp] if lp else []
    i = ind + (ind - table.size_one)
    return [int(x) for x in (table.ind[i], table.ind[i + 1]) if x]


class ParsedTable:
    """Bucket/indirect arrays parsed straight from a generated table source
    (used for the alternative table builds whose C symbols collide with the
    extracted ones: chrome and 0122 variants)."""

    def __init__(self, path: Path):
        src = path.read_text(encoding="utf-8")
        m = re.search(r"KeyMask = (0x[0-9a-fA-F]+)", src)
        self.keymask = int(m.group(1), 16)
        m = re.search(r"SizeOne = (\d+)", src)
        self.size_one = int(m.group(1))
        # Bucket array: every {{0x..,0x..,0x..,0x..}} row in order
        rows = re.findall(
            r"\{\{(0x[0-9a-f]{8}),(0x[0-9a-f]{8}),(0x[0-9a-f]{8}),"
            r"(0x[0-9a-f]{8})\}\}", src)
        self.buckets = np.array(
            [[int(x, 16) for x in r] for r in rows], dtype=np.uint32)
        self.size = len(rows)
        # Indirect array: hex words after the "Ind[" declaration
        ind_src = src[src.index("Ind["):]
        ind_src = ind_src[:ind_src.index("};")]
        self.ind = np.array(
            [int(x, 16) for x in re.findall(r"0x[0-9a-f]{8}", ind_src)],
            dtype=np.uint32)


def collect_training_words(tables, reg):
    """[(word, [(lang, q)], source_weight)] from the snapshot's octagram
    table builds: both delta tables (0527 + chrome; frequent words) at full
    weight, distinctocta0527 (close-pair discriminators) at reduced weight.
    The other distinct variants (distinctoctachrome/0122) measurably hurt
    golden-suite accuracy when added -- their close-pair word skew outweighs
    the extra vocabulary -- so they are deliberately excluded."""
    sources = [(source_path("cld2_generated_deltaocta0527.cc"),
                tables.deltaocta, 1.0),
               (source_path("cld2_generated_distinctocta0527.cc"),
                tables.distinctocta, 0.3)]
    chrome = source_path("cld2_generated_deltaoctachrome.cc")
    sources.append((chrome, ParsedTable(chrome), 1.0))
    out = []
    script_of = tables.script_of_cp
    for path, table, src_weight in sources:
        words = parse_words(path)
        for (bucket, slot), word in words.items():
            lps = word_payload(table, bucket, slot)
            if not lps:
                continue
            core = word.strip("_")
            if not core:
                continue
            # Script side from the word's first letter
            sc = 0
            for ch in core:
                sc = int(script_of[min(ord(ch), 0x10FFFF)])
                if sc:
                    break
            othr = sc != 1  # not Latin
            langs = {}
            for lp in lps:
                for lang, q in decode_langprob_langs(lp, othr, tables, reg):
                    if lang != 26:  # skip UNKNOWN filler
                        langs[lang] = max(langs.get(lang, 0), q)
            if langs:
                out.append((word, sorted(langs.items()), src_weight))
    return out


def quads_of_phrase(phrase: str):
    """Quadgram fingerprints for a clean lowercase phrase ('foo bar baz')
    scanned as running text: includes the word-boundary quads between
    consecutive tokens, exactly as the runtime scanner would emit them."""
    raw = phrase.encode("utf-8")
    text = b" " + raw + b" "
    buf = np.zeros(len(text) + 32, dtype=np.uint8)
    buf[:len(text)] = np.frombuffer(text, dtype=np.uint8)
    buf[len(text):len(text) + 3] = 0x20
    pos, lens, _ = quad_positions(buf, 1, len(text) - 1)
    if len(pos) == 0:
        return np.zeros(0, dtype=np.uint32)
    return quad_hash_v2(buf, pos, lens)


def quads_of_word(word: str):
    """Quadgram fingerprints the runtime scanner would produce for this word
    in running text. Leading '_' = preceded by space (always true for word
    start); trailing '_' = followed by space. Comment words without a
    trailing '_' are 8-char truncations of longer words: the real text
    continues with unknown letters, so the word is scanned with a letter
    placeholder and quads that would include the unknown bytes are dropped
    (instead of training a spurious word-final boundary quad)."""
    truncated = not word.endswith("_")
    core = word.strip("_")
    core_raw = core.encode("utf-8")
    text = b" " + core_raw + (b"x " if truncated else b" ")
    buf = np.zeros(len(text) + 32, dtype=np.uint8)
    buf[:len(text)] = np.frombuffer(text, dtype=np.uint8)
    buf[len(text):len(text) + 3] = 0x20
    pos, lens, _ = quad_positions(buf, 1, len(text) - 1)
    if len(pos) == 0:
        return np.zeros(0, dtype=np.uint32)
    if truncated:
        keep = (pos + lens) <= 1 + len(core_raw)  # exclude the placeholder
        pos, lens = pos[keep], lens[keep]
        if len(pos) == 0:
            return np.zeros(0, dtype=np.uint32)
    return quad_hash_v2(buf, pos, lens)


# Quantization hyperparameters, selected by sweep on the golden suite
# (tools/sweep_quad_tables.py). The model: per-language quad distributions
# P(g|lang), optionally shrunk toward the size-unbiased background
# (SHRINK = pseudo-mass as a fraction of the median language mass; 0 =
# raw), scaled to mean-language-mass weight units, and quantized by
# dominance (BASE + SLOPE * log2(1 + w1/(rest + ALPHA))) onto CLD2's
# 1..12 log-scale, with ~x3 steps between ranked languages and the top
# class clipped to HI_CAP (lower caps keep trained quads from shouting
# over the real reference word tables).
SHRINK = 0.0
ALPHA = 5.0
BASE = 3      # sweep r03: base 3-4 beats 5 (306 vs 304/402 goldens)
SLOPE = 2.0
HI_CAP = 12


def quantize_top3(weights: list, total_weight: float, lg_prob: np.ndarray,
                  alpha: float = None, base: float = None,
                  slope: float = None, hi_cap: int = None) -> tuple:
    """[(lang, weight)] sorted desc -> (pslangs[3], prob_subscript).

    The top qprob encodes distinctiveness: a quad dominated by one
    language scores high (CLD2's quantized log-ratio semantics, +1 ~ x3);
    a quad shared across languages spreads. Chooses the kLgProbV2Tbl row
    (hi, lo) plus the group whose mid value best matches the middle
    weight (table layout, cldutil_shared.h:42-61).
    """
    alpha = ALPHA if alpha is None else alpha
    base = BASE if base is None else base
    slope = SLOPE if slope is None else slope
    hi_cap = HI_CAP if hi_cap is None else hi_cap
    top = weights[:3]
    w1 = top[0][1]
    rest = max(total_weight - w1 + alpha, 1e-3)
    dominance = w1 / rest
    hi = int(np.clip(round(base + slope * np.log2(1 + dominance)), 2,
                     hi_cap))
    qs = [hi]
    for lang, w in top[1:]:
        # log-ratio below the winner, one step per ~x3
        q = hi - round(np.log2(max(w1 / max(w, 1e-9), 1)) / np.log2(3))
        qs.append(int(np.clip(q, 1, hi)))
    lo = qs[-1] if len(qs) >= 2 else hi
    row = BACKMAP[hi] + (lo - 1)
    if len(qs) >= 3:
        mid = min(qs[1], hi)
        best_g, best_d = 0, 1 << 30
        for g in range(3):
            d = abs(int(lg_prob[row + 78 * g][6]) - mid)
            if d < best_d:
                best_g, best_d = g, d
        row = row + 78 * best_g
    pslangs = [registry.per_script_number(1, lang) for lang, _ in top]
    while len(pslangs) < 3:
        pslangs.append(0)
    return pslangs, row


def build_table(fp_entries: dict, bucketcount: int, keymask: int,
                lg_prob: np.ndarray, alpha: float = None,
                base: float = None, slope: float = None,
                hi_cap: int = None):
    """Quantize (fp -> ranked lang weights) and pack into CLD2 bucket +
    indirect arrays. Bucket overflow spills to the caller (the
    reference's answer to collisions is the DUAL quad table probed on
    primary miss, cldutil.cc:356-363 -- the spill list feeds it)."""
    entries = []  # (fp, priority, langprob)
    for fp, (ranked, total_w, priority) in fp_entries.items():
        pslangs, row = quantize_top3(ranked, total_w, lg_prob, alpha,
                                     base, slope, hi_cap)
        lp = ((pslangs[2] & 0xFF) << 24) | ((pslangs[1] & 0xFF) << 16) | \
             ((pslangs[0] & 0xFF) << 8) | (row & 0xFF)
        entries.append((fp, priority, lp))
    return pack_entries(entries, bucketcount, keymask)


def pack_entries(entries: list, bucketcount: int, keymask: int):
    """Pack pre-quantized (fp, priority, langprob) entries into a bucket +
    indirect table: dedup langprobs, highest-priority entries claim the 4
    bucket slots first, overflow returns as a spill list."""
    langprob_index: dict = {}
    singles: list = []
    for _, _, lp in entries:
        if lp not in langprob_index:
            langprob_index[lp] = len(singles)
            singles.append(lp)
    size_one = max(len(singles), 2)
    ind_bits = (~keymask) & 0xFFFFFFFF
    if len(singles) > ind_bits:
        raise SystemExit(
            f"indirect overflow: {len(singles)} langprobs > the "
            f"{ind_bits:#x} index bits below keymask {keymask:#x}")
    buckets = np.zeros((bucketcount, 4), dtype=np.uint32)
    if not entries:
        return buckets, np.array([0, 0], dtype=np.uint32), 2, 0, []
    entries = sorted(entries, key=lambda e: -e[1])
    fps = np.array([e[0] for e in entries], dtype=np.uint32)
    subs, keys = quad_subscript_key(fps, keymask, bucketcount)
    slot_used = np.zeros(bucketcount, dtype=np.int32)
    filled = 0
    spilled = []
    for (fp, w, lp), sub, key in zip(entries, subs.tolist(), keys.tolist()):
        s = slot_used[sub]
        if s >= 4:
            spilled.append((fp, w, lp))
            continue
        buckets[sub, s] = np.uint32(key) | np.uint32(langprob_index[lp])
        slot_used[sub] = s + 1
        filled += 1
    return buckets, np.array(singles, dtype=np.uint32), len(singles), \
        filled, spilled


def collect_cldr_phrases(tables, reg):
    """[(phrase, [(lang, q)], cls)] from babel CLDR locale data ('cldr'),
    package gettext catalogs ('mo'), and the English stop-word list
    ('ensw') (tools/cldr_vocab.py), restricted to quadgram-scored
    (RTypeMany) scripts."""
    from .cldr_vocab import (collect_cldr_words, collect_english_stopwords,
                             collect_mo_phrases)
    script_of = tables.script_of_cp
    rtype = reg.ulscript_rtype
    out = []
    sources = [(collect_cldr_words(reg), "cldr"),
               (collect_mo_phrases(reg), "mo"),
               (collect_english_stopwords(reg), "ensw")]
    for items, cls in sources:
        for phrase, lang, q in items:
            sc = 0
            for ch in phrase:
                sc = int(script_of[min(ord(ch), 0x10FFFF)])
                if sc:
                    break
            if sc <= 0 or sc >= len(rtype) or int(rtype[sc]) != 2:
                continue
            out.append((phrase, [(lang, q)], cls))
    return out


def collect_corpus(tables, reg, words: list | None = None,
                   phrases: list | None = None):
    """All training items with their quad fingerprints precomputed:
    [(fps ndarray, [(lang, q)], src_weight_class)] where src_weight_class is
    'octa' / 'distinct' / 'cldr' (resolved to multipliers at train time so
    hyperparameter sweeps reuse one collection pass).

    words / phrases: already-collected sources, in the shapes
    collect_training_words and collect_cldr_phrases return (a host
    without the snapshot or babel passes what it has, e.g. the phrases
    of read_phrases); None collects that source here."""
    if words is None:
        words = collect_training_words(tables, reg)
    if phrases is None:
        phrases = collect_cldr_phrases(tables, reg)
    items = []
    for word, langs, sw in words:
        cls = "octa" if sw >= 1.0 else "distinct"
        items.append((quads_of_word(word), langs, cls))
    for phrase, langs, cls in phrases:
        items.append((quads_of_phrase(phrase), langs, cls))
    return items


def train(tables, reg, corpus, buckets: int = 65536,
          cldr_weight: float = 2.0, distinct_weight: float = 0.3,
          shrink: float = SHRINK, alpha: float = ALPHA, base: float = BASE,
          slope: float = SLOPE, hi_cap: int = HI_CAP,
          mo_weight: float = 0.0, ensw_weight: float = 0.0,
          prior_pow: float = 0.0, lang_bias: dict | None = None,
          close_pool: float = 0.0, buckets2: int = 8192,
          verbose: bool = True) -> dict:
    """Accumulate the collected corpus into a packed quadgram table set.

    lang_bias: optional per-language multiplicative calibration on
    P(g|lang) (hook for error-driven win-rate calibration sweeps).
    Returns the npz-ready array dict (see main for the artifact contract).

    Defaults reflect the sweep results (tools/sweep_quad_tables.py,
    golden suite): cldr_weight 2.0 peaks at 75.6%; the gettext-catalog
    and English-stop-word sources measurably HURT (-2% / -0.5%) despite
    adding function words, so they default off; 131072/32768 buckets
    both lose to 65536; win-rate calibration and expected-score
    regeneration from synthetic docs were tried and rejected
    (tools/calibrate_quad_tables.py: dev accuracy saturates at 95% while
    golden accuracy stays flat -- the remaining gap is vocabulary-vs-
    running-text distribution mismatch, not class priors).
    """
    src_w = {"octa": 1.0, "distinct": distinct_weight,
             "cldr": cldr_weight, "mo": mo_weight, "ensw": ensw_weight}

    fp_scores: dict = collections.defaultdict(dict)
    for fps, langs, cls in corpus:
        sw = src_w[cls]
        if sw <= 0:
            continue
        for fp in set(fps.tolist()):
            d = fp_scores[fp]
            for lang, q in langs:
                # qprob is log-scale (+1 ~ x3); weight words accordingly
                wt = sw * 3.0 ** (q / 2.0)
                d[lang] = d.get(lang, 0) + wt
    if verbose:
        print(f"distinct quadgram fingerprints: {len(fp_scores)}")

    # Per-language quad distributions: p(g|lang) = w / T_lang, with
    # optional Bayesian shrinkage toward the size-unbiased background
    # G_g = mean_lang(w_g,lang / T_lang) using pseudo-mass m = shrink *
    # median language mass (keeps tiny training corpora from claiming
    # common quads). Scaled back to mean-language-mass weight units so
    # the dominance quantizer's absolute ALPHA pseudocount keeps its
    # historical meaning.
    if close_pool > 0:
        # Close-set quadgram pooling: CLD2's design separates close pairs
        # ({bs,hr,sr}, {no,nn,da}, {id,ms}, ...) with distinct WORDS, not
        # quadgrams -- its real tables list close-set members at
        # near-equal probability per quad. Our per-language training data
        # instead lets one member dominate shared quads, so pull every
        # member up to close_pool * the set's max weight and let the
        # authentic distinct-octa evidence + RefineScoredClosePairs
        # decide (lang_script.cc:258 close sets, impl.cc:1154-1203).
        cs_members: dict = collections.defaultdict(list)
        for code, lang in reg.code_to_lang.items():
            cs = reg.close_set(lang)
            if cs:
                cs_members[cs].append(lang)
        for langw in fp_scores.values():
            active = {reg.close_set(l) for l in langw} - {0}
            for cs in active:
                members = cs_members[cs]
                mx = max(langw.get(m, 0.0) for m in members)
                if mx <= 0:
                    continue
                floor = close_pool * mx
                for m in members:
                    if langw.get(m, 0.0) < floor:
                        langw[m] = floor

    lang_total = collections.Counter()
    for langw in fp_scores.values():
        for lang, w in langw.items():
            lang_total[lang] += w
    n_langs = len(lang_total)
    mean_total = float(np.mean(list(lang_total.values())))
    m = shrink * float(np.median(list(lang_total.values())))
    bias = dict(lang_bias or {})
    if prior_pow > 0:
        # Language prior from training-data richness: vocabulary size is
        # a (crude) proxy for real-world text volume, so well-resourced
        # languages win ties on shared quads against tiny ones (e.g.
        # English vs Interlingua on "_the"). Partially undoes the
        # per-language mass normalization, at quantization time only.
        med = float(np.median(list(lang_total.values())))
        for lang, t in lang_total.items():
            bias[lang] = bias.get(lang, 1.0) * (t / med) ** prior_pow

    fp_entries: dict = {}
    for fp, langw in fp_scores.items():
        raw_total = sum(langw.values())
        if m > 0:
            g_share = sum(w / lang_total[lang]
                          for lang, w in langw.items()) / n_langs
        else:
            g_share = 0.0
        ws = [(lang,
               (w + m * g_share) / (lang_total[lang] + m) * mean_total *
               bias.get(lang, 1.0))
              for lang, w in langw.items()]
        ws.sort(key=lambda kv: -kv[1])
        fp_entries[fp] = (ws, sum(w for _, w in ws), raw_total)

    # >=32K buckets use a 2-byte key (cldutil.cc:103-105 comment)
    keymask = 0xFFFF0000 if buckets >= 32768 else 0xFFFFF000
    bucket_arr, ind, size_one, filled, spilled = build_table(
        fp_entries, buckets, keymask, tables.lg_prob, alpha, base, slope,
        hi_cap)
    # Bucket-overflow spill -> dual quadgram table probed on primary miss
    # (kQuad_obj2 convention, cldutil.cc:356-373)
    keymask2 = 0xFFFF0000 if buckets2 >= 32768 else 0xFFFFF000
    b2, ind2, so2, f2, d2 = pack_entries(spilled, buckets2, keymask2) \
        if buckets2 else (None, None, 0, 0, spilled)
    if verbose:
        print(f"buckets {buckets} filled {filled} spilled {len(spilled)} "
              f"indirect {size_one}; dual {buckets2} filled {f2} "
              f"dropped {len(d2)}")

    # Expected-score calibration for the trained tables: keep the reference
    # values only for the CJK unigram/bigram-scored languages (that scoring
    # path is unchanged); zero elsewhere = "no reliability data yet", letting
    # the top-2 delta model govern (cldutil.cc:587-589) until regenerated.
    expected = np.zeros_like(tables.avg_delta_octa_score)
    for code in ("ja", "ko", "zh", "zh-Hant"):
        lang = reg.code_to_lang[code]
        expected[lang] = tables.avg_delta_octa_score[lang]

    out = {
        "quadgram_buckets": bucket_arr,
        "quadgram_ind": ind,
        "quadgram_meta": np.array([size_one, buckets, keymask, 20260730],
                                  dtype=np.uint32),
        "quadgram_langscripts": np.array("trained-from-octa-and-cldr-data"),
        "expected_score_override": expected,
    }
    if buckets2 and f2:
        out.update({
            "quadgram2_buckets": b2,
            "quadgram2_ind": ind2,
            "quadgram2_meta": np.array([so2, buckets2, keymask2, 20260730],
                                       dtype=np.uint32),
            "quadgram2_langscripts": np.array("spill-of-primary-table"),
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--buckets", type=int, default=65536)
    ap.add_argument("--cldr-weight", type=float, default=2.0,
                    help="source weight multiplier for CLDR phrases "
                         "(0 disables the CLDR source)")
    ap.add_argument("--shrink", type=float, default=SHRINK)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    tables = load_tables()
    reg = registry
    corpus = collect_corpus(tables, reg)
    print(f"training items: {len(corpus)}")
    out = train(tables, reg, corpus, buckets=args.buckets,
                cldr_weight=args.cldr_weight, shrink=args.shrink)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
