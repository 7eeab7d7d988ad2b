"""Table-artifact dump / verify / pack tool.

The port of the reference package's tools/artifact_tool.py, itself the
counterpart of CLD2's cld2_dynamic_data_tool --dump/--verify
(cld2_dynamic_data_tool.cc:51+, file contract cld2_dynamic_data.h:23-110):
it prints the artifact "header" (per-array shape/dtype/checksum), checks
structural invariants of every scoring table, compares content hashes
against the manifest so silent drift/corruption is caught, and packs the
npz pair into the single-file mmap artifact (model.ldta) the port's
fronts serve and hot-swap, with the golden-canary g/ arrays the
integrity scrub checks. Modes, printed lines and exit codes are the
reference's; a pack of the same npz pair is the same file byte for byte.

Departures from the reference script:
  - --data DIR is the directory read (default: the shipped tables,
    tables.DATA_DIR): its cld2_tables.npz, quad_tables.npz, MANIFEST.json
    and model.ldta. To pack retrained quad tables, put them beside a
    copy of cld2_tables.npz in one directory and name it with --data
    (library callers pass both npz paths to pack());
  - --pack and --write-manifest write model.ldta and MANIFEST.json into
    --out DIR (default build/torch_tables/ under the checkout), never
    into the shipped data directory. The pack is written under a
    temporary name and renamed into place once its round trip holds,
    so a front serving the old file at that path keeps its mapping;
  - --verify also requires model.ldta's digest footer
    (artifact.verify_artifact): every blob's crc32 is checked, and a
    pack without a footer fails;
  - pack(cld2_npz, quad_npz, out) is the library function --pack runs.

Usage:
  python -m language_detector_tpu_torch.tools.artifact_tool --dump
  python -m language_detector_tpu_torch.tools.artifact_tool --verify
  python -m language_detector_tpu_torch.tools.artifact_tool --pack
  python -m language_detector_tpu_torch.tools.artifact_tool --write-manifest
      [--data DIR] [--out DIR]     (exit 1 on a failure)
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

from .. import artifact
from ..tables import DATA_DIR

REPO = Path(__file__).resolve().parents[2]
DATA = DATA_DIR
MANIFEST = DATA / "MANIFEST.json"
OUT = REPO / "build" / "torch_tables"
ARTIFACTS = ("cld2_tables.npz", "quad_tables.npz")
FORMAT_VERSION = 1

# Ngram table prefixes per artifact (CLD2TableSummary equivalents,
# cld2tablesummary.h:37-49)
NGRAM_PREFIXES = {
    "cld2_tables.npz": ("deltaocta", "distinctocta", "cjkdeltabi",
                        "distinctbi", "cjkcompat"),
    "quad_tables.npz": ("quadgram", "quadgram2"),
}


class PackError(RuntimeError):
    """A pack whose round trip failed; the file was deleted. `problems`
    are the reference's PACK FAIL lines without the prefix."""

    def __init__(self, problems: list):
        super().__init__("; ".join(problems))
        self.problems = problems


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _sources(data=None) -> dict:
    """{artifact name: path} read under --data."""
    root = DATA if data is None else Path(data)
    return {name: root / name for name in ARTIFACTS}


def describe(path: Path) -> dict:
    z = np.load(path, allow_pickle=False)
    return {
        "format_version": FORMAT_VERSION,
        "arrays": {k: {"shape": list(z[k].shape), "dtype": str(z[k].dtype),
                       "sha256": _sha(z[k])}
                   for k in sorted(z.files)},
    }


def check_structure(path: Path) -> list[str]:
    """Structural invariants of the scoring tables (the bits the runtime
    assumes without checking on the hot path)."""
    errors: list[str] = []
    name = path.name
    z = np.load(path, allow_pickle=False)

    def err(msg):
        errors.append(f"{name}: {msg}")

    for prefix in NGRAM_PREFIXES.get(name, ()):
        missing = [k for k in ("meta", "buckets", "ind")
                   if f"{prefix}_{k}" not in z.files]
        if missing:
            # the dual quad table (quadgram2, primary-bucket spill) is
            # optional: absent entirely is fine, partially present is not
            if prefix == "quadgram2" and len(missing) == 3:
                continue
            err(f"missing {', '.join(f'{prefix}_{k}' for k in missing)}")
            continue
        meta = z[f"{prefix}_meta"]
        buckets = z[f"{prefix}_buckets"]
        ind = z[f"{prefix}_ind"]
        size_one, size, keymask = int(meta[0]), int(meta[1]), int(meta[2])
        if buckets.dtype != np.uint32 or buckets.ndim != 2 \
                or buckets.shape[1] != 4:
            err(f"{prefix}_buckets must be [n,4] uint32, "
                f"got {buckets.shape} {buckets.dtype}")
            continue
        if size != buckets.shape[0]:
            err(f"{prefix} meta size {size} != bucket rows "
                f"{buckets.shape[0]}")
        if size & (size - 1):
            err(f"{prefix} bucket count {size} not a power of two")
        # 0xFFFFFFFF appears on the empty dummy table
        # (generated_distinct_bi_0.cc equivalent)
        if keymask not in (0xFFFFF000, 0xFFFF0000, 0xFFFFFF00, 0xFFFFFFFF):
            err(f"{prefix} unexpected keymask {keymask:#x}")
        if ind.dtype != np.uint32:
            err(f"{prefix}_ind must be uint32")
        # size_one == 0 is legal: every entry is then a two-word pair
        # (cjkcompat's direct-indexed layout)
        if not 0 <= size_one <= len(ind):
            err(f"{prefix} size_one {size_one} out of range "
                f"(indirect len {len(ind)})")
        # every non-empty slot's indirect subscript must be resolvable:
        # subscripts >= size_one consume TWO consecutive indirect words
        # (LinearizeAll convention, scoreonescriptspan.cc:936-964)
        subs = (buckets & ~np.uint32(keymask)).ravel()
        subs = subs[buckets.ravel() != 0]
        if len(subs):
            two = subs[subs >= size_one]
            if subs.max(initial=0) >= len(ind):
                err(f"{prefix} indirect subscript {int(subs.max())} >= "
                    f"indirect len {len(ind)}")
            elif len(two) and int(two.max()) + 1 >= len(ind):
                err(f"{prefix} two-word subscript {int(two.max())} "
                    f"overruns indirect array")

    if name == "cld2_tables.npz":
        for k, n in (("script_of_cp", 0x110000), ("cjk_uni_prop", 0x110000),
                     ("interchange_ok", 0x110000)):
            if k not in z.files:
                err(f"missing {k}")
            elif z[k].shape[0] != n:
                err(f"{k} must cover {n} codepoints, got {z[k].shape}")
        if "lg_prob_v2" in z.files and z["lg_prob_v2"].shape != (240, 8):
            err(f"lg_prob_v2 must be [240,8] (kLgProbV2Tbl), "
                f"got {z['lg_prob_v2'].shape}")
        if "avg_delta_octa_score" in z.files \
                and z["avg_delta_octa_score"].shape != (614, 4):
            err("avg_delta_octa_score must be [614,4] "
                "(kAvgDeltaOctaScore, 614 langs x 4 script4)")
    if name == "quad_tables.npz":
        if "expected_score_override" in z.files \
                and z["expected_score_override"].shape != (614, 4):
            err("expected_score_override must be [614,4]")
    return errors


def cmd_dump(data=None) -> int:
    for name, path in _sources(data).items():
        if not path.exists():
            print(f"{name}: MISSING")
            continue
        d = describe(path)
        print(f"{name} ({path.stat().st_size // 1024} KB, "
              f"format v{d['format_version']})")
        for k, info in d["arrays"].items():
            print(f"  {k:28} {str(info['shape']):>16} {info['dtype']:>8} "
                  f"{info['sha256'][:12]}")
    return 0


def cmd_verify(data=None) -> int:
    errors: list[str] = []
    mpath = MANIFEST if data is None else Path(data) / "MANIFEST.json"
    manifest = json.loads(mpath.read_text()) if mpath.exists() else None
    if manifest is None:
        errors.append(f"manifest missing: {mpath}")
    sources = _sources(data)
    for name, path in sources.items():
        if not path.exists():
            # quad_tables.npz is an optional trained add-on -- but once
            # the manifest records it, absence is drift, not an option
            if name == "quad_tables.npz" and not (manifest
                                                  and name in manifest):
                continue
            errors.append(f"{name}: artifact missing")
            continue
        errors.extend(check_structure(path))
        if manifest and name in manifest:
            want = manifest[name]["arrays"]
            got = describe(path)["arrays"]
            for k in want.keys() - got.keys():
                errors.append(f"{name}: array {k} missing")
            for k in got.keys() - want.keys():
                errors.append(f"{name}: unexpected array {k}")
            for k in want.keys() & got.keys():
                if want[k] != got[k]:
                    errors.append(
                        f"{name}: {k} drifted "
                        f"(manifest {want[k]['sha256'][:12]} != "
                        f"file {got[k]['sha256'][:12]})")
    # the mmap artifact is derived from the npz pair: stale contents
    # would silently serve old tables (load_tables prefers it)
    ldta = (DATA if data is None else Path(data)) / "model.ldta"
    if ldta.exists():
        try:
            # structure and every blob's crc32 against the digest footer
            digest = artifact.verify_artifact(ldta)
            packed = artifact.load_artifact(ldta)
        except ValueError as e:
            packed = None
            errors.append(f"model.ldta: {e}")
        else:
            if digest is None:
                errors.append("model.ldta: no digest footer (a pack "
                              "older than the footer — rerun --pack)")
        if packed is not None:
            expected_keys: set = set()
            for name, prefix, path in _npz_sources(sources):
                if not path.exists():
                    continue
                z = np.load(path, allow_pickle=False)
                for k in z.files:
                    pk = prefix + k
                    expected_keys.add(pk)
                    if pk not in packed:
                        errors.append(f"model.ldta: {pk} missing "
                                      "(stale pack — rerun --pack)")
                    elif not np.array_equal(np.asarray(packed[pk]),
                                            z[k]):
                        errors.append(f"model.ldta: {pk} drifted from "
                                      f"{name} (rerun --pack)")
            # reverse direction: arrays the npz no longer carries (or a
            # deleted quad_tables.npz) must not survive in the pack
            for pk in sorted(set(packed) - expected_keys):
                if pk.startswith("g/"):
                    # golden-canary namespace: --pack derives these
                    # itself (no npz source), exempt from the check
                    continue
                errors.append(f"model.ldta: {pk} no longer in the npz "
                              "sources (stale pack — rerun --pack)")
    if errors:
        for e in errors:
            print(f"VERIFY FAIL: {e}")
        return 1
    print("artifact verify OK")
    return 0


def _npz_sources(sources: dict):
    """(name, prefix, path) for every npz source of the mmap artifact —
    the single enumeration --pack and --verify share."""
    for name, prefix in (("cld2_tables.npz", "c/"),
                         ("quad_tables.npz", "q/")):
        yield name, prefix, sources[name]


def _canary_arrays(npz: dict) -> dict:
    """Golden-query canary pack baked into the artifact (g/ namespace):
    the pinned integrity.CANARY_DOCS plus the codes the tables being
    packed ACTUALLY detect for them (scalar oracle — the device kernel
    is held bit for bit to it). integrity.py's per-lane canary check
    compares live device results against these at scrub time."""
    from ..engine_scalar import detect_scalar
    from ..integrity import CANARY_DOCS
    from ..registry import registry as reg
    from ..tables import ScoringTables

    tables = ScoringTables._build(npz["c/"], npz.get("q/"))
    codes = [reg.code(detect_scalar(d, tables, reg).summary_lang)
             for d in CANARY_DOCS]

    def concat(chunks):
        off = np.zeros(len(chunks) + 1, dtype=np.int64)
        off[1:] = np.cumsum([len(b) for b in chunks])
        return (np.frombuffer(b"".join(chunks), dtype=np.uint8), off)

    du8, doff = concat([d.encode("utf-8") for d in CANARY_DOCS])
    cu8, coff = concat([c.encode("ascii") for c in codes])
    return {"g/docs_u8": du8, "g/docs_off": doff,
            "g/codes_u8": cu8, "g/codes_off": coff}


def pack_arrays(cld2_npz, quad_npz=None) -> dict:
    """The artifact's arrays: c/<name> from cld2_npz, q/<name> from
    quad_npz (None: packed without quad tables), then the g/ canaries."""
    arrays: dict = {}
    npz: dict = {}
    for prefix, path in (("c/", cld2_npz), ("q/", quad_npz)):
        if path is None:
            continue
        z = np.load(path, allow_pickle=False)
        npz[prefix] = {k: z[k] for k in z.files}
        for k in z.files:
            arrays[prefix + k] = z[k]
    arrays.update(_canary_arrays(npz))
    return arrays


def _write_pack(arrays: dict, out) -> Path:
    """Write arrays to out with an immediate round-trip verification:
    every array loaded back through the mmap path must be bit-identical
    to its source. On a mismatch nothing is left behind (PackError)."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    try:
        artifact.write_artifact(arrays, tmp)
        back = artifact.load_artifact(tmp)
        problems = [f"{k} round-trip mismatch" for k in arrays
                    if k in back and
                    not np.array_equal(np.asarray(back[k]), arrays[k])]
        problems += [f"{k} missing after round trip"
                     for k in set(arrays) - set(back)]
        del back
        if problems:
            raise PackError(problems)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def pack(cld2_npz, quad_npz, out) -> Path:
    """npz pair -> single-file mmap artifact at `out` (quad_npz None:
    without quad tables), round-trip verified; returns out. Raises
    PackError, leaving no file, when the round trip fails."""
    return _write_pack(pack_arrays(cld2_npz, quad_npz), out)


def cmd_pack(data=None, out=None) -> int:
    """npz pair -> <out>/model.ldta, round-trip verified."""
    sources = _sources(data)
    if not sources["cld2_tables.npz"].exists():
        print("PACK FAIL: cld2_tables.npz missing")
        return 1
    qpath = sources["quad_tables.npz"]
    # quad_tables.npz is an optional trained add-on
    arrays = pack_arrays(sources["cld2_tables.npz"],
                         qpath if qpath.exists() else None)
    target = (OUT if out is None else Path(out)) / "model.ldta"
    try:
        _write_pack(arrays, target)
    except PackError as e:
        for p in e.problems:
            print(f"PACK FAIL: {p}")
        return 1
    print(f"wrote {target} ({target.stat().st_size // 1024} KB, "
          f"{len(arrays)} arrays, round-trip verified)")
    return 0


def cmd_write_manifest(data=None, out=None) -> int:
    target = (OUT if out is None else Path(out)) / "MANIFEST.json"
    manifest = {name: describe(path)
                for name, path in _sources(data).items()
                if path.exists()}
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(json.dumps(manifest, indent=1, sort_keys=True)
                      + "\n")
    print(f"wrote {target}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--dump", action="store_true")
    g.add_argument("--verify", action="store_true")
    g.add_argument("--pack", action="store_true",
                   help="npz pair -> <out>/model.ldta mmap artifact")
    g.add_argument("--write-manifest", action="store_true")
    ap.add_argument("--data", default=None,
                    help="directory of the npz pair, MANIFEST.json and "
                    f"model.ldta (default {DATA})")
    ap.add_argument("--out", default=None,
                    help=f"where --pack / --write-manifest write "
                    f"(default {OUT})")
    args = ap.parse_args(argv)
    if args.dump:
        return cmd_dump(args.data)
    if args.verify:
        return cmd_verify(args.data)
    if args.pack:
        return cmd_pack(args.data, args.out)
    return cmd_write_manifest(args.data, args.out)


if __name__ == "__main__":
    sys.exit(main())
