"""The port's table life-cycle tools against the reference package's
scripts (tools/artifact_tool.py, gen_service_codes.py,
make_eval_corpus.py), on the CPU, and a front of the port hot-swapped
onto a pack of the port's tool.

The reference scripts are imported by their top-level names from
tools/ (as tests/test_artifact_verify.py does), their DATA / MANIFEST /
OUT monkeypatched onto copies under tmp_path: nothing is written into
language_detector_tpu/. Both tools run on the same trees and must print
the same lines and return the same exit codes; packs of the same npz
pair must be the same file byte for byte.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from language_detector_tpu_torch import artifact
from language_detector_tpu_torch.registry import registry
from language_detector_tpu_torch.tables import (DATA_DIR, ScoringTables,
                                               load_tables)
from language_detector_tpu_torch.tools import artifact_tool
from language_detector_tpu_torch.tools import gen_service_codes as gsc
from language_detector_tpu_torch.tools import make_eval_corpus as mec
from language_detector_tpu_torch.tools import train_quad_tables as tq
from torch_support import jax_packer

jax_packer()

REPO = Path(__file__).resolve().parent.parent
SHIPPED = ("cld2_tables.npz", "quad_tables.npz", "MANIFEST.json",
           "model.ldta")
FIXTURE = REPO / "tests" / "data" / "torch_trainer_cldr.tsv"


@pytest.fixture(scope="module")
def ref():
    """The reference scripts, imported from tools/ by their names."""
    tools_dir = str(REPO / "tools")
    if tools_dir not in sys.path:
        sys.path.insert(0, tools_dir)
    import artifact_tool as ref_artifact_tool
    import gen_service_codes as ref_gen_service_codes
    import make_eval_corpus as ref_make_eval_corpus
    return type("Ref", (), {"at": ref_artifact_tool,
                            "gsc": ref_gen_service_codes,
                            "mec": ref_make_eval_corpus})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Quad tables trained by the port's trainer on the committed CLDR
    fixture at 4,096 / 1,024 buckets, as an npz."""
    base = load_tables()
    corpus = tq.collect_corpus(base, registry, words=[],
                               phrases=tq.read_phrases(FIXTURE))
    out = tq.train(base, registry, corpus, buckets=4096, buckets2=1024,
                   verbose=False)
    path = tmp_path_factory.mktemp("trained") / "quad_tables.npz"
    np.savez_compressed(path, **out)
    return path


@pytest.fixture(autouse=True)
def _shipped_untouched():
    """No test writes into the shipped data directory."""
    before = {n: hashlib.sha256((DATA_DIR / n).read_bytes()).hexdigest()
              for n in SHIPPED}
    yield
    after = {n: hashlib.sha256((DATA_DIR / n).read_bytes()).hexdigest()
             for n in SHIPPED}
    assert after == before


def _tree(root: Path, quad: Path | None = None) -> Path:
    """A copy of the shipped data directory (quad: another quad npz)."""
    root.mkdir(parents=True, exist_ok=True)
    for name in SHIPPED:
        shutil.copy(DATA_DIR / name, root / name)
    if quad is not None:
        shutil.copy(quad, root / "quad_tables.npz")
    return root


def _run(fn, *args) -> tuple:
    """(exit code, printed lines) of one call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue().splitlines()


def _ref_on(monkeypatch, ref, tree: Path):
    monkeypatch.setattr(ref.at, "DATA", tree)
    monkeypatch.setattr(ref.at, "MANIFEST", tree / "MANIFEST.json")


# -- --pack ----------------------------------------------------------------


def test_defaults_read_the_shipped_tables_and_write_under_build():
    assert artifact_tool.DATA == DATA_DIR
    assert artifact_tool.MANIFEST == DATA_DIR / "MANIFEST.json"
    assert artifact_tool.OUT == REPO / "build" / "torch_tables"
    assert gsc.OUT == REPO / "build" / "torch_tables" / "cld_codes.json"


def test_pack_of_the_shipped_pair_equals_the_reference(ref, tmp_path,
                                                        monkeypatch):
    """The port's --pack of the shipped npz pair is the reference's file
    byte for byte, array-equal to the shipped model.ldta (g/ included),
    and prints the same line; pack() writes the same bytes."""
    tree = _tree(tmp_path / "ref")
    (tree / "model.ldta").unlink()
    _ref_on(monkeypatch, ref, tree)
    rc_ref, out_ref = _run(ref.at.cmd_pack)
    monkeypatch.setattr(artifact_tool, "OUT", tmp_path / "port")
    rc, out = _run(artifact_tool.main, ["--pack"])
    assert rc == rc_ref == 0
    assert [ln.replace(str(tmp_path / "port"), str(tree))
            for ln in out] == out_ref
    got = (tmp_path / "port" / "model.ldta").read_bytes()
    assert got == (tree / "model.ldta").read_bytes()
    lib = artifact_tool.pack(DATA_DIR / "cld2_tables.npz",
                             DATA_DIR / "quad_tables.npz",
                             tmp_path / "lib" / "model.ldta")
    assert lib.read_bytes() == got
    packed = artifact.load_artifact(lib)
    shipped = artifact.load_artifact(DATA_DIR / "model.ldta")
    assert sorted(packed) == sorted(shipped)
    assert {k for k in packed if k.startswith("g/")} == {
        "g/docs_u8", "g/docs_off", "g/codes_u8", "g/codes_off"}
    for k in packed:
        assert packed[k].dtype == shipped[k].dtype, k
        assert np.array_equal(packed[k], shipped[k]), k
    assert sorted(os.listdir(tmp_path / "lib")) == ["model.ldta"]


def test_pack_of_trained_tables_equals_the_reference(ref, trained, tmp_path,
                                                     monkeypatch):
    """Tables trained by the port's trainer pack to the reference's file
    byte for byte; the baked canary codes are the scalar engine's over
    the packed tables, and they are what load_mmap reads back."""
    tree = _tree(tmp_path / "ref", quad=trained)
    _ref_on(monkeypatch, ref, tree)
    assert _run(ref.at.cmd_pack)[0] == 0
    out = artifact_tool.pack(tree / "cld2_tables.npz", trained,
                             tmp_path / "port.ldta")
    assert out.read_bytes() == (tree / "model.ldta").read_bytes()
    from language_detector_tpu_torch.engine_scalar import detect_scalar
    from language_detector_tpu_torch.integrity import CANARY_DOCS
    tables = ScoringTables.load_mmap(out)
    assert tables.canary_docs == CANARY_DOCS
    assert list(tables.canary_codes) == [
        registry.code(detect_scalar(d, tables, registry).summary_lang)
        for d in CANARY_DOCS]
    assert int(tables.quadgram.size) == 4096


def test_pack_without_quad_tables_equals_the_reference(ref, tmp_path,
                                                       monkeypatch):
    tree = _tree(tmp_path / "ref")
    (tree / "quad_tables.npz").unlink()
    _ref_on(monkeypatch, ref, tree)
    rc_ref, out_ref = _run(ref.at.cmd_pack)
    rc, out = _run(artifact_tool.main, ["--pack", "--data", str(tree),
                                        "--out", str(tmp_path / "port")])
    assert rc == rc_ref == 0
    assert (tmp_path / "port" / "model.ldta").read_bytes() == \
        (tree / "model.ldta").read_bytes()
    assert not any(k.startswith("q/") for k in artifact.load_artifact(
        tmp_path / "port" / "model.ldta"))
    (tree / "cld2_tables.npz").unlink()
    assert _run(ref.at.cmd_pack) == _run(
        artifact_tool.main, ["--pack", "--data", str(tree), "--out",
                             str(tmp_path / "port")]) == \
        (1, ["PACK FAIL: cld2_tables.npz missing"])


def test_pack_round_trip_failure_leaves_no_file(ref, tmp_path,
                                                monkeypatch):
    """A round trip that reads back other bytes fails both tools with
    the same PACK FAIL line and leaves no file behind."""
    import language_detector_tpu.artifact as ref_artifact

    def doctored(load):
        def call(path):
            back = dict(load(path))
            back["q/quadgram_meta"] = back["q/quadgram_meta"] + 1
            return back
        return call

    tree = _tree(tmp_path / "ref")
    (tree / "model.ldta").unlink()
    _ref_on(monkeypatch, ref, tree)
    monkeypatch.setattr(ref_artifact, "load_artifact",
                        doctored(ref_artifact.load_artifact))
    monkeypatch.setattr(artifact, "load_artifact",
                        doctored(artifact.load_artifact))
    out_dir = tmp_path / "port"
    rc_ref, out_ref = _run(ref.at.cmd_pack)
    rc, out = _run(artifact_tool.main, ["--pack", "--data", str(tree),
                                        "--out", str(out_dir)])
    assert rc == rc_ref == 1
    assert out == out_ref == ["PACK FAIL: q/quadgram_meta round-trip "
                              "mismatch"]
    assert not (tree / "model.ldta").exists()
    assert os.listdir(out_dir) == []
    with pytest.raises(artifact_tool.PackError, match="quadgram_meta"):
        artifact_tool.pack(tree / "cld2_tables.npz",
                           tree / "quad_tables.npz", out_dir / "x.ldta")
    assert os.listdir(out_dir) == []


def test_repack_over_a_mapped_file_keeps_its_mapping(trained, tmp_path):
    """A pack renames a new file into place: views over the file the
    path held before (a front serving it) keep their bytes."""
    out = artifact_tool.pack(DATA_DIR / "cld2_tables.npz",
                             DATA_DIR / "quad_tables.npz",
                             tmp_path / "model.ldta")
    views = artifact.load_artifact(out)
    before = views["q/quadgram_buckets"].copy()
    artifact_tool.pack(DATA_DIR / "cld2_tables.npz", trained, out)
    assert np.array_equal(views["q/quadgram_buckets"], before)
    assert artifact.load_artifact(out)["q/quadgram_buckets"].shape[0] == \
        4096
    assert sorted(os.listdir(tmp_path)) == ["model.ldta"]


# -- --verify and --dump -----------------------------------------------------


def _corrupt(tree: Path, case: str) -> None:
    """Damage a copy of the shipped data directory."""
    manifest = json.loads((tree / "MANIFEST.json").read_text())
    qpath = tree / "quad_tables.npz"
    if case == "structure":
        # an out-of-range indirect subscript in a filled slot
        z = dict(np.load(qpath, allow_pickle=False))
        buckets = z["quadgram_buckets"].copy()
        r, c = np.argwhere(buckets != 0)[0]
        keymask = int(z["quadgram_meta"][2])
        buckets[r, c] = (buckets[r, c] & np.uint32(keymask)) | np.uint32(
            len(z["quadgram_ind"]) + 5)
        z["quadgram_buckets"] = buckets
        np.savez(qpath, **z)
    elif case == "manifest_drift":
        key = next(iter(manifest["quad_tables.npz"]["arrays"]))
        manifest["quad_tables.npz"]["arrays"][key]["sha256"] = "0" * 64
        (tree / "MANIFEST.json").write_text(json.dumps(manifest))
    elif case == "stale_pack":
        # retrained tables, manifest refreshed, pack not rerun
        z = dict(np.load(qpath, allow_pickle=False))
        z["quadgram_meta"] = z["quadgram_meta"].copy()
        z["quadgram_meta"][3] += 1
        np.savez(qpath, **z)
        manifest["quad_tables.npz"] = artifact_tool.describe(qpath)
        (tree / "MANIFEST.json").write_text(json.dumps(manifest))
    elif case == "extra_key":
        # an array no npz holds (a g/ one is exempt)
        # (copies: the file is rewritten under the views' mapping)
        arrays = {k: np.array(v) for k, v in
                  artifact.load_artifact(tree / "model.ldta").items()}
        arrays["c/bogus"] = np.arange(3, dtype=np.int32)
        arrays["g/extra"] = np.zeros(2, dtype=np.uint8)
        artifact.write_artifact(arrays, tree / "model.ldta")
    elif case == "quad_missing":
        qpath.unlink()
    elif case == "manifest_missing":
        (tree / "MANIFEST.json").unlink()
    else:
        assert case == "clean"


VERIFY_CASES = ("clean", "structure", "manifest_drift", "stale_pack",
                "extra_key", "quad_missing", "manifest_missing")


@pytest.mark.parametrize("case", VERIFY_CASES)
def test_verify_matches_the_reference(ref, case, tmp_path, monkeypatch):
    """--verify prints the reference's lines and returns its exit code
    on the shipped tables and on each damaged tree."""
    tree = _tree(tmp_path / "tree")
    _corrupt(tree, case)
    _ref_on(monkeypatch, ref, tree)
    rc_ref, out_ref = _run(ref.at.cmd_verify)
    rc, out = _run(artifact_tool.main, ["--verify", "--data", str(tree)])
    assert (rc, out) == (rc_ref, out_ref)
    if case == "clean":
        assert (rc, out) == (0, ["artifact verify OK"])
    else:
        assert rc == 1 and out and all(
            ln.startswith("VERIFY FAIL: ") for ln in out)
    if case == "stale_pack":
        assert out == ["VERIFY FAIL: model.ldta: q/quadgram_meta drifted "
                       "from quad_tables.npz (rerun --pack)"]
    if case == "extra_key":
        assert out == ["VERIFY FAIL: model.ldta: c/bogus no longer in the "
                       "npz sources (stale pack — rerun --pack)"]


def test_verify_of_the_shipped_tables_by_default():
    assert _run(artifact_tool.main, ["--verify"]) == (
        0, ["artifact verify OK"])


def _blob_middle(raw: bytes, name: str) -> int:
    """The file offset of the middle byte of one array's blob."""
    n = int.from_bytes(raw[8:12], "little")
    for i in range(n):
        d = artifact._DESC.unpack_from(raw, artifact._HDR.size +
                                       i * artifact._DESC.size)
        if d[0].rstrip(b"\0").decode() == name:
            return d[-2] + d[-1] // 2
    raise KeyError(name)


def test_verify_checks_the_digest_footer(ref, tmp_path, monkeypatch):
    """A flipped blob byte fails both tools on model.ldta's digest; a
    pack without a footer fails the port's verify only (it requires
    the footer), which the reference passes."""
    tree = _tree(tmp_path / "tree")
    raw = bytearray((tree / "model.ldta").read_bytes())
    at = _blob_middle(raw, "c/script_of_cp")
    raw[at] ^= 0x10
    (tree / "model.ldta").write_bytes(bytes(raw))
    _ref_on(monkeypatch, ref, tree)
    for fn, args in ((ref.at.cmd_verify, ()),
                     (artifact_tool.cmd_verify, (tree,))):
        rc, out = _run(fn, *args)
        assert rc == 1 and len(out) == 1, out
        assert out[0].startswith("VERIFY FAIL: model.ldta: ")
        assert "fails its digest" in out[0]
    raw[at] ^= 0x10
    raw[12:16] = (0).to_bytes(4, "little")     # header flags: no footer
    (tree / "model.ldta").write_bytes(bytes(raw))
    assert artifact.artifact_digest(tree / "model.ldta") is None
    assert _run(ref.at.cmd_verify) == (0, ["artifact verify OK"])
    rc, out = _run(artifact_tool.cmd_verify, tree)
    assert rc == 1 and out == ["VERIFY FAIL: model.ldta: no digest footer "
                               "(a pack older than the footer — rerun "
                               "--pack)"]


def test_life_cycle_of_a_retrained_tree(trained, tmp_path):
    """The operator's cycle over one directory: the shipped
    cld2_tables.npz beside retrained quad tables, packed, its manifest
    written and verified there; the pack answers as the npz pair."""
    tree = tmp_path / "tree"
    tree.mkdir()
    shutil.copy(DATA_DIR / "cld2_tables.npz", tree / "cld2_tables.npz")
    shutil.copy(trained, tree / "quad_tables.npz")
    argv = ["--data", str(tree), "--out", str(tree)]
    rc, out = _run(artifact_tool.main, ["--pack", *argv])
    assert rc == 0 and out[0].startswith(f"wrote {tree / 'model.ldta'}")
    assert _run(artifact_tool.main, ["--write-manifest", *argv]) == (
        0, [f"wrote {tree / 'MANIFEST.json'}"])
    assert _run(artifact_tool.main, ["--verify", *argv[:2]]) == (
        0, ["artifact verify OK"])
    packed = artifact.load_artifact(tree / "model.ldta")
    z = np.load(trained)
    assert all(np.array_equal(np.asarray(packed["q/" + k]), z[k])
               for k in z.files)
    np.savez(tree / "quad_tables.npz", **{k: z[k] for k in z.files
                                         if k != "quadgram2_ind"})
    rc, out = _run(artifact_tool.main, ["--verify", *argv[:2]])
    assert rc == 1 and "VERIFY FAIL: quad_tables.npz: missing " \
        "quadgram2_ind" in out


def test_phase_canary_over_the_shipped_and_a_doctored_pack(tmp_path):
    """chip_smoke's card_canary (phase `artifact`) on the CPU: over the
    shipped npz pair packed by the port the scrub's canary takes the
    baked codes, which are the shipped pack's, and agrees 1.0; over a
    copy whose first baked code is doctored it fails and counts one
    canary detection."""
    from language_detector_tpu_torch import telemetry
    from language_detector_tpu_torch.ops import kernels
    pair = (DATA_DIR / "cld2_tables.npz", DATA_DIR / "quad_tables.npz")
    arrays = artifact_tool.pack_arrays(*pair)
    codes = arrays["g/codes_u8"].copy()
    codes[:int(arrays["g/codes_off"][1])] = ord("z")
    arrays["g/codes_u8"] = codes
    shipped = list(ScoringTables.load_mmap(DATA_DIR / "model.ldta")
                   .canary_codes)
    assert "un" not in shipped
    got = {name: chip_smoke.card_canary(ScoringTables.load_mmap(path),
                                        kernels, telemetry, registry,
                                        "cpu")
           for name, path in (
               ("shipped", artifact_tool.pack(*pair,
                                              tmp_path / "model.ldta")),
               ("doctored", artifact_tool._write_pack(
                   arrays, tmp_path / "doctored.ldta")))}
    assert got["shipped"] == {"scrub": ["ok"], "expect": shipped,
                              "source": "artifact", "agreement": 1.0,
                              "launches": 0, "detected": 0}
    assert got["doctored"] == {
        "scrub": ["mismatch"], "expect": ["zz"] + shipped[1:],
        "source": "artifact", "agreement": 1 - 1 / len(shipped),
        "launches": 0, "detected": 1}


@pytest.mark.parametrize("case", ("shipped", "quad_missing"))
def test_dump_matches_the_reference(ref, case, tmp_path, monkeypatch):
    tree = _tree(tmp_path / "tree")
    if case == "quad_missing":
        (tree / "quad_tables.npz").unlink()
    _ref_on(monkeypatch, ref, tree)
    rc_ref, out_ref = _run(ref.at.cmd_dump)
    rc, out = _run(artifact_tool.main, ["--dump", "--data", str(tree)])
    assert (rc, out) == (rc_ref, out_ref)
    assert rc == 0 and len(out) > 50
    assert ("quad_tables.npz: MISSING" in out) == (case == "quad_missing")


# -- --write-manifest --------------------------------------------------------


def test_write_manifest_equals_the_reference(ref, trained, tmp_path,
                                             monkeypatch):
    """The manifest of the shipped pair is the shipped file byte for
    byte, and of a retrained pair the reference's."""
    rc, out = _run(artifact_tool.main, ["--write-manifest", "--out",
                                        str(tmp_path / "a")])
    assert rc == 0 and out == [f"wrote {tmp_path / 'a' / 'MANIFEST.json'}"]
    assert (tmp_path / "a" / "MANIFEST.json").read_bytes() == \
        (DATA_DIR / "MANIFEST.json").read_bytes()
    tree = _tree(tmp_path / "tree", quad=trained)
    _ref_on(monkeypatch, ref, tree)
    assert _run(ref.at.cmd_write_manifest) == (
        0, [f"wrote {tree / 'MANIFEST.json'}"])
    assert _run(artifact_tool.cmd_write_manifest, tree,
                tmp_path / "b")[0] == 0
    assert (tmp_path / "b" / "MANIFEST.json").read_bytes() == \
        (tree / "MANIFEST.json").read_bytes()


# -- gen_service_codes, make_eval_corpus -----------------------------------------


def test_gen_service_codes_equals_the_shipped_file(ref, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(ref.gsc, "OUT", tmp_path / "ref.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.gsc.main()
        gsc.main(["--out", str(tmp_path / "port.json")])
    want = (REPO / "language_detector_tpu" / "service" /
            "cld_codes.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    assert (tmp_path / "ref.json").read_bytes() == want
    assert buf.getvalue().splitlines() == [
        f"wrote {tmp_path / 'ref.json'} (281 codes)",
        f"wrote {tmp_path / 'port.json'} (281 codes)"]


GOLDEN = {"en": ("ENGLISH", " ".join(
              f"the committee said on day {i} that the new bridge would "
              f"open to traffic after the spring" for i in range(8))),
          "fr": ("FRENCH", "Le gouvernement a annonc\\xc3\\xa9 de "
                 "nouvelles mesures pour aider les familles")}


def _write_golden_suite(root: Path) -> None:
    """A two-entry golden suite in the snapshot's layout."""
    internal = root / "cld2" / "internal"
    internal.mkdir(parents=True, exist_ok=True)
    data, pairs = [], []
    for code, (cname, text) in GOLDEN.items():
        data.append(f'const char* kTeststr_{code} = "{text}";')
        pairs.append(f"  {{{cname}, kTeststr_{code}}},")
    (internal / "unittest_data.h").write_text("\n".join(data) + "\n")
    (internal / "cld2_unittest.cc").write_text("\n".join(pairs) + "\n")


def test_make_eval_corpus_equals_the_reference(ref, tmp_path, monkeypatch):
    """Over a two-entry golden suite (read by the port through
    LDT_REFERENCE_DIR, handed to the reference through its golden_data
    parser) both scripts write the same file and print the same line;
    without a suite both stop with the same message."""
    import golden_data
    from language_detector_tpu_torch.tools.fuzz import golden_pairs
    _write_golden_suite(tmp_path / "snap")
    monkeypatch.setenv("LDT_REFERENCE_DIR", str(tmp_path / "snap"))
    pairs = golden_pairs()
    assert [(n, lang) for n, lang, _ in pairs] == [("en", "en"),
                                                   ("fr", "fr")]
    monkeypatch.setattr(golden_data, "golden_pairs", lambda: pairs)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.mec.main(str(tmp_path / "ref.tsv"), 50)
        mec.main(str(tmp_path / "port.tsv"), 50)
    got = (tmp_path / "port.tsv").read_bytes()
    assert got == (tmp_path / "ref.tsv").read_bytes()
    lines = got.decode().splitlines()
    assert len(lines) == 50 and {ln.split("\t")[0] for ln in lines} == \
        {"en", "fr"}
    assert len({ln for ln in lines if ln.startswith("en")}) > 1
    assert buf.getvalue().splitlines() == [
        f"wrote 50 docs to {tmp_path / 'ref.tsv'}",
        f"wrote 50 docs to {tmp_path / 'port.tsv'}"]
    monkeypatch.setattr(golden_data, "golden_pairs", lambda: [])
    monkeypatch.delenv("LDT_REFERENCE_DIR")
    for main in (ref.mec.main, mec.main):
        with pytest.raises(SystemExit, match="golden suite unavailable"):
            main(str(tmp_path / "none.tsv"), 5)


# -- the packed tables on the port's engine and front --------------------------


def _canary_engine(tables):
    from language_detector_tpu_torch.models.ngram import NgramBatchEngine
    with chip_smoke.env_knobs(LDT_POOL_LANES="1",
                              LDT_SCRUB_INTERVAL_SEC="60"):
        return NgramBatchEngine(tables, registry, device="cpu")


def test_canary_takes_the_baked_codes(trained, tmp_path):
    """The scrub's canary over a port-packed artifact takes its expected
    codes from the baked g/ arrays and agrees 1.0; over npz tables (no
    g/ arrays) it pins them with the scalar engine."""
    packed = artifact_tool.pack(DATA_DIR / "cld2_tables.npz", trained,
                                tmp_path / "model.ldta")
    tables = ScoringTables.load_mmap(packed)
    for tabs, source in ((tables, "artifact"),
                         (ScoringTables.load(DATA_DIR / "cld2_tables.npz",
                                             trained), "scalar")):
        eng = _canary_engine(tabs)
        try:
            mon = eng.integrity
            assert [mon.scrub_lane(ln) for ln in mon.lanes] == ["ok"]
            state = mon.canary_state
            assert state["source"] == source
            assert state["agreement"] == 1.0
            assert state["expect"] == list(tables.canary_codes)
        finally:
            eng.pool.close()


def _doctored_pack(trained, path: Path) -> Path:
    """A pack of the trained tables whose first baked canary code is
    wrong (same length, so the offsets hold)."""
    arrays = artifact_tool.pack_arrays(DATA_DIR / "cld2_tables.npz",
                                       trained)
    codes = bytearray(arrays["g/codes_u8"].tobytes())
    assert codes[:2] == b"en"
    codes[:2] = b"zz"
    arrays["g/codes_u8"] = np.frombuffer(bytes(codes), dtype=np.uint8)
    return artifact_tool._write_pack(arrays, path)


def _scrape_sum(text: str, name: str, **labels) -> float:
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name + "{") and all(
                f'{k}="{v}"' in line for k, v in labels.items()):
            total += float(line.rsplit(" ", 1)[1])
    return total


def test_cpu_front_swaps_onto_a_port_pack(trained, tmp_path):
    """A tests/torch_cpu_front front (the port's asyncio front on the
    CPU, one pool lane scrubbed at every flush) swaps onto a pack of the
    port's tool over POST /swap and answers as detect_scalar over
    load_mmap of that pack; its scrub's canary passes there, and fails
    on a pack whose baked codes were doctored: the monitor reads the
    baked codes, it does not re-pin them."""
    from language_detector_tpu_torch.engine_scalar import detect_scalar
    packed = artifact_tool.pack(DATA_DIR / "cld2_tables.npz", trained,
                                tmp_path / "model.ldta")
    bad = _doctored_pack(trained, tmp_path / "doctored.ldta")
    tables = ScoringTables.load_mmap(packed)
    texts = [t for _, (_, t) in sorted(GOLDEN.items())]
    texts = [f"{t} {i}".replace("\\xc3\\xa9", "é")
             for i in range(48) for t in texts]
    want = [registry.code(detect_scalar(t, tables, registry).summary_lang)
            for t in texts]
    shipped = load_tables()
    assert want != [registry.code(detect_scalar(
        t, shipped, registry).summary_lang) for t in texts]
    port, mport = chip_smoke.free_port(), chip_smoke.free_port()
    env = chip_smoke.proc_env(LISTEN_PORT=port, PROMETHEUS_PORT=mport,
                              LDT_POOL_LANES=1,
                              LDT_SCRUB_INTERVAL_SEC="0.001")
    env.pop("LDT_UNIX_SOCKET", None)
    proc = subprocess.Popen([sys.executable, "-m", "tests.torch_cpu_front"],
                            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}/"
    swap = f"http://127.0.0.1:{mport}/swap"
    body = {"request": [{"text": t} for t in texts]}
    try:
        chip_smoke.wait_for(
            lambda: chip_smoke.get_url(url + "readyz")[0] == 200,
            "the CPU front", 120, proc)
        assert chip_smoke.post_json(swap, {"path": str(packed)})[0] == 200
        status, got = chip_smoke.post_json(url, body)
        assert status in (200, 203)
        assert [r["iso6391code"] for r in got["response"]] == want
        metrics = chip_smoke.scrape(mport)
        assert _scrape_sum(metrics, "ldt_integrity_scrub_total",
                           result="ok") > 0
        assert _scrape_sum(metrics, "ldt_integrity_detected_total") == 0
        assert chip_smoke.post_json(swap, {"path": str(bad)})[0] == 200
        chip_smoke.post_json(url, body)
        metrics = chip_smoke.scrape(mport)
        assert _scrape_sum(metrics, "ldt_integrity_detected_total",
                           kind="canary") >= 1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
