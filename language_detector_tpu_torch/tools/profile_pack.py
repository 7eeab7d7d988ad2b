"""Stage-level cycle profile of the native packer's hot path.

The port of the reference package's tools/profile_pack.py, over the
port's own native/packer.cc. Writes an instrumented twin of it with
LDT_PROF_SCOPE markers at the stage boundaries (the scaffolding —
counters and ProfScope — is compiled into packer.cc only under
-DLDT_PROF), builds it with native/build.sh under build/torch_prof/
(never into the package directory), and packs the bench corpus through
the twin in a fresh process, so the serving library of any process is
left alone. Prints the best wall time and the per-stage cycle minima
over the runs (the least host-interfered reading).

The anchors are the port's packer signatures; a missing anchor is an
error that names it, so the profile never measures the wrong stage.
The packer is host code: nothing here runs on the card.

Usage:
  python -m language_detector_tpu_torch.tools.profile_pack
      [batch_size] [runs]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
NATIVE = _PKG / "native"
BUILD = _PKG.parent / "build" / "torch_prof"

# (anchor, scope slot): each anchor is an exact stretch of packer.cc;
# the marker goes right after it
SCOPES = [
    ("int segment_text(const uint8_t* text, int text_len, SegScratch* ss,\n"
     "                 bool collect_src = false) {\n", 0),
    ("int64_t scan_quad_round(const Span& sp, int64_t start,\n"
     "                        std::vector<Rec>* recs, int* n_quota,\n"
     "                        int* n_emit) {\n", 1),
    ("void scan_word_range(const Span& sp, int64_t start, int64_t end,\n"
     "                     std::vector<Rec>* recs, int* n_emit) {\n", 2),
    ("      int cum_entries = 0;  // consumed base entries, exclusive", 4),
    ("void build_span(const std::vector<uint32_t>& cur, int ulscript,\n"
     "                Span* sp, const std::vector<int32_t>* src = "
     "nullptr) {\n", 5),
    ("void pack_resolve_one_doc(const uint8_t* text, int text_len, "
     "int b,\n                          const ROut& o) {\n", 7),
]
NAMES = ["segment", "quad_scan", "word_scan", "-", "emit",
         "build_span", "-", "total_doc"]


def instrument(src: str) -> str:
    """packer.cc with a scope marker after every anchor; raises naming
    the first anchor that is missing."""
    for anchor, slot in SCOPES:
        if anchor not in src:
            raise RuntimeError(f"profile anchor not found in packer.cc: "
                               f"{anchor.splitlines()[0]!r}")
        ins = f"  LDT_PROF_SCOPE({slot});\n"
        if not anchor.endswith("\n"):  # mid-line anchor: break the line
            ins = "\n    " + ins
        src = src.replace(anchor, anchor + ins, 1)
    return src


def build_instrumented(out_dir: Path = BUILD) -> Path:
    """Write the twin's source and build it into out_dir with the
    production flags plus -DLDT_PROF; returns the library's path."""
    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    prof_cc = out_dir / "packer_prof.cc"
    prof_cc.write_text(instrument((NATIVE / "packer.cc").read_text()))
    so = out_dir / "libldtpack_prof.so"
    # build.sh owns the flag set: the twin differs from production only
    # by -DLDT_PROF and the source file (-I finds ldt_internal.h)
    env = dict(os.environ, LDT_SRC=str(prof_cc),  # ldt-lint: disable=knob-direct-env -- whole-environment passthrough to the build subprocess, not a config read
               LDT_EXTRA_FLAGS=f"-DLDT_PROF -I{NATIVE}",
               LDT_GLUE_OUT=str(out_dir / "libldtglue_prof.so"))
    subprocess.run(["bash", str(NATIVE / "build.sh"), str(so)],
                   check=True, env=env, stdout=subprocess.DEVNULL)
    return so


def measure(so: Path, batch_size: int, runs: int,
            wire_out: str | None = None) -> dict:
    """In a process that has not loaded the packer: pack the bench
    corpus through the twin `runs` times; the best wall time and each
    stage's least cycles. wire_out saves the last pack's wire and the
    cycles (npz)."""
    import numpy as np

    from .. import native
    from ..registry import registry as reg
    from ..tables import load_tables
    from .fuzz import make_corpus
    lib = native.use_library(so)
    tables = load_tables()
    docs = make_corpus(batch_size)
    native.pack_chunks_native(docs, tables, reg, flags=0)  # warm + init
    prof = (ctypes.c_uint64 * 8).in_dll(lib, "ldt_prof_cycles")
    best = [float("inf")] * 8
    best_wall = float("inf")
    for _ in range(runs):
        for i in range(8):
            prof[i] = 0
        t0 = time.time()
        cb = native.pack_chunks_native(docs, tables, reg, flags=0)
        best_wall = min(best_wall, time.time() - t0)
        for i in range(8):
            best[i] = min(best[i], prof[i])
    if wire_out:
        np.savez(wire_out, cycles=np.array(best, np.float64),
                 **{f"wire_{k}": v for k, v in cb.wire.items()})
    return {"wall_ms": best_wall * 1e3, "cycles": best}


def report(batch_size: int, runs: int, result: dict) -> None:
    print(f"pack wall (best of {runs}): {result['wall_ms']:.1f} ms "
          f"/ {batch_size} docs")
    for name, v in zip(NAMES, result["cycles"]):
        if name != "-":
            print(f"{name:12s} {v / 1e6:8.1f} Mcycles")


def main(batch_size: int = 16384, runs: int = 8,
         out_dir: Path = BUILD, wire_out: str | None = None) -> int:
    """Build the twin, then profile it in a fresh process (which
    prints the report); returns that process's exit code."""
    so = build_instrumented(out_dir)
    cmd = [sys.executable, "-m", __spec__.name, str(batch_size),
           str(runs), "--twin", str(so)]
    if wire_out:
        cmd += ["--wire-out", str(wire_out)]
    return subprocess.run(cmd, cwd=str(_PKG.parent)).returncode


def cli(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("batch_size", nargs="?", type=int, default=16384)
    ap.add_argument("runs", nargs="?", type=int, default=8)
    ap.add_argument("--twin", default=None,
                    help="profile this built twin in this process (the "
                         "fresh process main starts)")
    ap.add_argument("--wire-out", default=None,
                    help="save the last pack's wire and the cycles (npz)")
    args = ap.parse_args(argv)
    if args.twin is None:
        return main(args.batch_size, args.runs, wire_out=args.wire_out)
    report(args.batch_size, args.runs,
           measure(Path(args.twin), args.batch_size, args.runs,
                   args.wire_out))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
