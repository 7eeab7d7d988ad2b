"""The port's offline evaluator and expected-score tool against the
reference package's scripts (tools/eval_corpus.py,
tools/gen_expected_score.py), on the CPU.

Inputs: the checked-in eval_corpus.tsv plus 600 seeded windows of the
port's evalsuite.generate_corpus() documents, with tab-less lines mixed
in. The evaluator runs with BLOCK 128 on both sides, so block flushes
and the partial last block are exercised: the port's report
(device="cpu") equals the JAX engine's byte for byte apart from the
rate in its first line, also over a 4-shard CPU mesh and under --limit.
The expected-score npz equals the JAX script's array for array (run in
a subprocess on the CPU) and the printed summary line is the same.
"""
from __future__ import annotations

import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from language_detector_tpu.tables import ScoringTables as JaxTables
from language_detector_tpu_torch import evalsuite
from language_detector_tpu_torch.tables import DATA_DIR, ScoringTables
from language_detector_tpu_torch.tools import eval_corpus as port_eval
from language_detector_tpu_torch.tools import fuzz
from language_detector_tpu_torch.tools import gen_expected_score as port_exp
from torch_support import jax_packer

jax_packer()

REPO = Path(__file__).resolve().parent.parent
BLOCK = 128   # the streamed block on both sides here (65,536 in use)
RATE = re.compile(r", \d+ docs/sec$")


@pytest.fixture(scope="module")
def jax_eval():
    """The reference's tools/eval_corpus module. Importing it sets JAX's
    compilation-cache options for the process; they are put back."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        return importlib.import_module("tools.eval_corpus")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _windows(n: int, seed: int) -> list:
    """n (code, text) pairs: seeded 3-30-word windows of the generated
    corpus's documents."""
    rng = np.random.default_rng(seed)
    gen = evalsuite.generate_corpus()
    out = []
    for i in range(n):
        code, text = gen[int(rng.integers(len(gen)))]
        words = text.split(" ")
        lo = int(rng.integers(len(words)))
        out.append((code, " ".join(words[lo:lo + int(rng.integers(3, 31))])))
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> Path:
    """eval_corpus.tsv, then 600 windows, with a tab-less line and an
    empty line every 100 pairs (both skipped)."""
    lines = (DATA_DIR / "eval_corpus.tsv").read_text(
        encoding="utf-8").splitlines()
    for i, (code, text) in enumerate(_windows(600, 20261017)):
        if i % 100 == 0:
            lines += ["a line without a tab", ""]
        lines.append(f"{code}\t{text}")
    path = tmp_path_factory.mktemp("eval") / "corpus.tsv"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return path


@pytest.fixture(scope="module")
def tables():
    return JaxTables.load(), ScoringTables.load()


def _rateless(report: str) -> str:
    first, rest = report.split("\n", 1)
    assert RATE.search(first), first
    return RATE.sub("", first) + "\n" + rest


def test_iter_pairs_equal_and_skip_tabless_lines(jax_eval, corpus):
    pairs = list(port_eval.iter_pairs(str(corpus)))
    assert pairs == list(jax_eval.iter_pairs(str(corpus)))
    assert len(pairs) == 130 + 600
    assert all(code and "\t" not in code for code, _ in pairs)
    assert list(port_eval.iter_pairs(str(corpus), 57)) == pairs[:57]


@pytest.fixture(scope="module")
def jax_report(jax_eval, corpus, tables):
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_eval, "BLOCK", BLOCK)
    try:
        return jax_eval.evaluate(jax_eval.iter_pairs(str(corpus)),
                                 tables[0])
    finally:
        mp.undo()


@pytest.mark.parametrize("mesh", [None, 4], ids=["engine", "mesh4"])
def test_report_equals_jax(monkeypatch, corpus, tables, jax_report, mesh):
    monkeypatch.setattr(port_eval, "BLOCK", BLOCK)
    got = port_eval.evaluate(port_eval.iter_pairs(str(corpus)), tables[1],
                             mesh, device="cpu")
    assert _rateless(got) == _rateless(jax_report)
    assert got.startswith("Evaluation over 730 labeled documents")
    assert "_Totals_Known" in got.splitlines()[-1]


def test_cli_limit_and_out(monkeypatch, capsys, corpus, tables, tmp_path):
    monkeypatch.setattr(port_eval, "BLOCK", BLOCK)
    out = tmp_path / "eval.txt"
    assert port_eval.main(["--corpus", str(corpus), "--limit", "300",
                           "--device", "cpu", "--out", str(out),
                           "--warm"]) == 0
    printed = capsys.readouterr().out
    want = port_eval.evaluate(port_eval.iter_pairs(str(corpus), 300),
                              tables[1], device="cpu")
    assert _rateless(out.read_text()) == _rateless(want)
    assert printed == out.read_text() + "\n" + f"wrote {out}\n"
    assert "over 300 labeled documents" in printed


@pytest.mark.parametrize("mesh", [None, 2], ids=["engine", "mesh2"])
def test_cuda_without_cuda_raises(tables, mesh):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_eval.evaluate(iter([("en", "a short english text")]),
                           tables[1], mesh, device="cuda")


def test_expected_score_equals_jax(capsys, tmp_path):
    pairs = _windows(300, 20261018)
    tsv = tmp_path / "exp.tsv"
    tsv.write_text("".join(f"{c}\t{t}\n" for c, t in pairs),
                   encoding="utf-8")
    jax_out, port_out = tmp_path / "jax.npz", tmp_path / "port.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, str(REPO / "tools" / "gen_expected_score.py"),
         "--corpus", str(tsv), "--out", str(jax_out)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert run.returncode == 0, run.stderr
    assert port_exp.main(["--corpus", str(tsv), "--out", str(port_out),
                          "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.splitlines()
    want = run.stdout.splitlines()
    assert printed[0] == want[0]
    assert printed[0].startswith("300 lines, ")
    assert printed[1] == want[1].replace(str(jax_out), str(port_out))
    with np.load(jax_out) as a, np.load(port_out) as b:
        assert sorted(a.files) == sorted(b.files) == \
            ["expected_score_override"]
        x, y = a["expected_score_override"], b["expected_score_override"]
        assert x.dtype == y.dtype == np.int16 and x.shape == y.shape
        assert np.array_equal(x, y)
        assert (y > 0).sum() > 0


def test_windows_equal_make_eval_corpus(monkeypatch, tmp_path):
    """fuzz.window_pairs is tools/make_eval_corpus.py's windowing, here
    over the eval corpus's documents in place of the golden suite."""
    import golden_data
    make_eval_corpus = importlib.import_module("tools.make_eval_corpus")
    pairs = list(port_eval.iter_pairs(str(DATA_DIR / "eval_corpus.tsv")))
    monkeypatch.setattr(golden_data, "golden_pairs", lambda: [
        (str(i), c, t.encode()) for i, (c, t) in enumerate(pairs)])
    make_eval_corpus.main(str(tmp_path / "ref.tsv"), 500)
    want = list(port_eval.iter_pairs(str(tmp_path / "ref.tsv")))
    assert fuzz.window_pairs(pairs, 500) == want
    path = fuzz.write_windowed_tsv(tmp_path / "port.tsv", 500)
    assert path.read_bytes() == (tmp_path / "ref.tsv").read_bytes()
