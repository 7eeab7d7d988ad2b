"""ldt-lint over the PyTorch/CUDA port (language_detector_tpu_torch/).

The analyzers are the JAX package's own (tools/lint/*.py), not copies:
an import hook loads each source under ``tools.lint_torch.<name>`` with
a fixed rewrite map applied to its text, so the port is held to exactly
the rules the reference is, and a change to an analyzer reaches both.

Rewrite map (word-bounded, applied in order):

  language_detector_tpu   -> language_detector_tpu_torch
                             (module names, repo paths, messages)
  tools.lint              -> tools.lint_torch
  docs/OBSERVABILITY.md   -> docs/TORCH_OBSERVABILITY.md
  docs/ROBUSTNESS.md      -> docs/TORCH_ROBUSTNESS.md

The reference's docs predate the port, so the port's knob, metric,
event, layout and fault tables live in the two TORCH_* files, written
by ``python -m tools.lint_torch --write-docs``. Where the port truly
differs from the reference, ``PATCHES`` below edits the loaded module
after it runs (each entry says why). Two analyzers are left out of the
run, see ``__main__.LEFT_OUT``.

Run: python -m tools.lint_torch   (exits non-zero on any violation)
"""
from __future__ import annotations

import importlib.abc
import importlib.util
import re
import sys
from pathlib import Path

REF_DIR = Path(__file__).resolve().parent.parent / "lint"
PORT_PKG = "language_detector_tpu_torch"

REWRITES = (
    (re.compile(r"\blanguage_detector_tpu\b"), PORT_PKG),
    (re.compile(r"\btools\.lint\b"), "tools.lint_torch"),
    (re.compile(r"\bdocs/OBSERVABILITY\.md\b"),
     "docs/TORCH_OBSERVABILITY.md"),
    (re.compile(r"\bdocs/ROBUSTNESS\.md\b"), "docs/TORCH_ROBUSTNESS.md"),
)


def rewrite(text: str) -> str:
    for pat, repl in REWRITES:
        text = pat.sub(repl, text)
    return text


def _drop_aot_backend(mod) -> None:
    # the reference's AotStore keys bundle entries by JAX backend; the
    # port's keys them by torch/CUDA/arch and has no `backend` attribute
    entry = mod.LOCK_OWNERSHIP[f"{PORT_PKG}/aot.py"]["AotStore"]
    entry.lockfree.pop("backend", None)


def _add_staging_ring(mod) -> None:
    # the reference's ring lock is a plain threading.Lock outside the
    # map; the port's guards the pinned leases that flush workers, pool
    # lanes and stream callbacks return, so it is a watched role
    # ("staging.ring") and its state is mapped here
    mod.LOCK_OWNERSHIP.setdefault(f"{PORT_PKG}/native/__init__.py", {})[
        "StagingRing"] = mod._cl(
            lock="_lock",
            attrs=("_free", "_out", "_hits", "_misses", "_pending"),
            lockfree={
                "cap": "assigned once in __init__, read-only after",
                "pinned": "assigned once in __init__, read-only after",
            })


# {module name under tools.lint_torch: [post-exec patch]}
PATCHES = {
    "ownership": [_drop_aot_backend, _add_staging_ring],
}


# names the reference's modules are loaded under when their own would
# clash: tools.lint_torch.__main__ is the port's CLI, which wraps the
# reference's as tools.lint_torch.refmain
_ALIASES = {"refmain": "__main__"}


class _RefLoader(importlib.abc.Loader):
    def __init__(self, name: str, path: Path):
        self.name = name
        self.path = path

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        module.__file__ = str(self.path)
        code = compile(rewrite(self.path.read_text()), str(self.path),
                       "exec")
        exec(code, module.__dict__)
        for patch in PATCHES.get(self.name.rsplit(".", 1)[-1], ()):
            patch(module)


class _RefFinder(importlib.abc.MetaPathFinder):
    """Finds tools.lint_torch.<name> in tools/lint/<name>.py whenever
    tools/lint_torch/ holds no module of that name itself."""

    def find_spec(self, fullname, path=None, target=None):
        head, _, leaf = fullname.rpartition(".")
        if head != __name__ or not leaf:
            return None
        own = Path(__file__).resolve().parent
        if (own / f"{leaf}.py").exists() or (own / leaf).is_dir():
            return None
        src = REF_DIR / f"{_ALIASES.get(leaf, leaf)}.py"
        if not src.exists():
            return None
        return importlib.util.spec_from_loader(
            fullname, _RefLoader(fullname, src), origin=str(src))


if not any(isinstance(f, _RefFinder) for f in sys.meta_path):
    sys.meta_path.insert(0, _RefFinder())
