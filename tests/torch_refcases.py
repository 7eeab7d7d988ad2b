"""Run a reference test file's cases against the port.

`adopt("faults", globals(), exclude={...})` reads tests/test_faults.py,
applies the rewrite map below to its source and execs it into the
calling module's globals, so pytest collects each reference case as a
test of that module (tests/test_torch_ref_faults.py), run against
`language_detector_tpu_torch`. The reference file itself is not
touched.

Rewrite map (applied in order, word-bounded):

  language_detector_tpu      -> language_detector_tpu_torch, except in
                                "language_detector_tpu" / "data" paths:
                                the port reads the reference's data
  libldtpack.so              -> libldtpack_torch.so (the port's packer)
  tools.lint                 -> tools.lint_torch

`replace` adds (old, new) text pairs for one file; each must match, so
a stale pair fails loudly. `exclude` maps a case (a function name, or
"Class::method") to the reason it does not run on the port; each must
name a case the file has. After adopt returns, the calling module
defines port fixtures of the same names as any conftest or reference
fixture that would hand a case a JAX-package object (an engine, tables,
a service): a later definition in the module wins. Every adopted module also gets
the port's stage-latency histograms of a fresh process for its run
(_port_stage_histograms_fresh).
"""
from __future__ import annotations

import re
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent

REWRITES = (
    (re.compile(r"\blanguage_detector_tpu\b(?!\"\s*/\s*\"data\")"),
     "language_detector_tpu_torch"),
    (re.compile(r"\blibldtpack\.so\b"), "libldtpack_torch.so"),
    (re.compile(r"\btools\.lint\b"), "tools.lint_torch"),
)


def port_source(name: str, replace=()) -> str:
    """tests/test_<name>.py with the rewrite map and `replace` applied."""
    text = (TESTS / f"test_{name}.py").read_text()
    for pat, repl in REWRITES:
        text = pat.sub(repl, text)
    for old, new in replace:
        if old not in text:
            raise AssertionError(f"test_{name}.py: replace pair no longer "
                                 f"matches: {old!r}")
        text = text.replace(old, new)
    return text


@pytest.fixture(scope="module", autouse=True)
def _port_stage_histograms_fresh():
    """Each adopted file starts from the port's stage-latency histograms
    of a fresh process (none) and leaves them as it found them: the
    admission estimators read them (service/admission.py
    expected_flush_ms), and the reference's cases assume a process of
    their own, as they have in the reference's run."""
    from language_detector_tpu_torch import telemetry
    reg = telemetry.REGISTRY
    name = "ldt_stage_latency_ms"
    with reg._lock:
        saved = {k: h for k, h in reg._hists.items() if k[0] == name}
        for k in saved:
            del reg._hists[k]
    yield
    with reg._lock:
        for k in [k for k in reg._hists if k[0] == name]:
            del reg._hists[k]
        reg._hists.update(saved)


def adopt(name: str, globs: dict, exclude: dict | None = None,
          replace=()) -> list:
    """Exec the rewritten reference file into `globs`, drop the excluded
    cases; returns the names of the adopted cases."""
    path = TESTS / f"test_{name}.py"
    code = compile(port_source(name, replace), str(path), "exec")
    keep = {k: globs[k] for k in ("__name__", "__file__", "__doc__")
            if k in globs}
    exec(code, globs)
    globs.update(keep)
    globs["_port_stage_histograms_fresh"] = _port_stage_histograms_fresh
    for case, why in (exclude or {}).items():
        assert why, f"{case}: an exclusion needs its reason"
        cls, _, meth = case.partition("::")
        if meth:
            assert hasattr(globs.get(cls), meth), \
                f"test_{name}.py has no case {case}"
            delattr(globs[cls], meth)
        else:
            assert case in globs, f"test_{name}.py has no case {case}"
            del globs[case]
    return sorted(k for k, v in globs.items()
                  if k.startswith("test_") and callable(v))
