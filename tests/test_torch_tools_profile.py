"""The port's profile scripts (tools/profile_score.py,
tools/profile_pack.py) and the --device rule of every offline tool, on
the CPU.

profile_score prints the reference's lines and its timed scorer's words
equal the plain scorer's on the same wire. Every profile_pack anchor is
found in the port's packer.cc and a missing one is named; the
instrumented twin, built under a temporary build directory and run in
its own process, packs the bench corpus to the real packer's wire array
for array with cycles in every stage. Every tool that runs the engine
raises without CUDA when --device cuda (the default).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from language_detector_tpu_torch import native
from language_detector_tpu_torch.ops.device_tables import DeviceTables
from language_detector_tpu_torch.ops.score import (score_chunks_plain,
                                                   wire_to_device)
from language_detector_tpu_torch.registry import registry
from language_detector_tpu_torch.tables import DATA_DIR, load_tables
from language_detector_tpu_torch.tools import (eval_corpus,
                                               gen_expected_score,
                                               profile_pack, profile_score,
                                               soak)
from language_detector_tpu_torch.tools.fuzz import make_corpus


def test_profile_score_lines_and_words(capsys):
    out = profile_score.main(256, 2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4
    assert lines[0].startswith(f"wire: B=256 N={out['N']} G={out['G']} "
                               f"K={out['K']} avg_slots=")
    for line, label in zip(lines[1:], ("fixed dispatch latency:",
                                       "compute + readback:",
                                       "transfer+compute+readback:")):
        assert line.startswith(label) and line.endswith(" ms")
    assert out["kernel_ms"] is None and out["device"] == "cpu"
    tables = load_tables()
    cb = native.pack_chunks_native(make_corpus(256), tables, registry)
    dt = DeviceTables.from_host(tables, registry, "cpu")
    want = score_chunks_plain(dt, wire_to_device(cb.wire, "cpu"))
    assert out["words"].dtype == np.uint32
    assert out["words"].shape == (out["G"],)
    assert np.array_equal(out["words"], want.numpy().view(np.uint32))


def test_every_anchor_is_in_the_packer():
    src = (profile_pack.NATIVE / "packer.cc").read_text()
    twin = profile_pack.instrument(src)
    for _, slot in profile_pack.SCOPES:
        assert twin.count(f"LDT_PROF_SCOPE({slot});") == 1
    assert len(twin.splitlines()) == len(src.splitlines()) + \
        len(profile_pack.SCOPES) + 1   # + the mid-line anchor's break


@pytest.mark.parametrize("slot", [s for _, s in profile_pack.SCOPES])
def test_missing_anchor_is_named(slot):
    anchor = next(a for a, s in profile_pack.SCOPES if s == slot)
    src = (profile_pack.NATIVE / "packer.cc").read_text()
    with pytest.raises(RuntimeError, match="profile anchor not found") as e:
        profile_pack.instrument(src.replace(anchor, "/* moved */"))
    assert repr(anchor.splitlines()[0]) in str(e.value)


def test_twin_packs_the_real_wire(tmp_path):
    out = tmp_path / "twin.npz"
    assert profile_pack.main(256, 2, out_dir=tmp_path / "build",
                             wire_out=str(out)) == 0
    assert (tmp_path / "build" / "packer_prof.cc").exists()
    want = native.pack_chunks_native(make_corpus(256), load_tables(),
                                     registry, flags=0).wire
    with np.load(out) as z:
        got = {k[len("wire_"):]: z[k] for k in z.files
               if k.startswith("wire_")}
        cycles = z["cycles"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    for name, c in zip(profile_pack.NAMES, cycles):
        if name != "-":
            assert c > 0, name


def test_use_library_refuses_once_loaded(tmp_path):
    assert native.available()
    with pytest.raises(RuntimeError, match="loaded already"):
        native.use_library(tmp_path / "libldtpack_prof.so")
    assert native._SO.name == "libldtpack_torch.so"


@pytest.mark.parametrize("tool", ["eval_corpus", "gen_expected_score",
                                  "soak", "profile_score"])
def test_cuda_by_default_raises_without_cuda(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tsv = str(DATA_DIR / "eval_corpus.tsv")
    run = {"eval_corpus": lambda: eval_corpus.main(["--corpus", tsv]),
           "gen_expected_score": lambda: gen_expected_score.main(
               ["--corpus", tsv, "--out", str(tmp_path / "e.npz")]),
           "soak": lambda: soak.cli(["0.01"]),
           "profile_score": lambda: profile_score.cli(["64", "1"])}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()
    assert not (tmp_path / "e.npz").exists()
