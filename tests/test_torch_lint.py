"""The reference's static analysis over the port (tools/lint_torch).

The gate: `python -m tools.lint_torch` reports nothing on the live
tree. Its non-vacuity: every analyzer that runs scans files of
language_detector_tpu_torch/ and none of language_detector_tpu/, and a
violation seeded into a copy of a port module is flagged under its
rule. The reference's own cases of tests/test_lint.py run again against
tools.lint_torch (the analyzers loaded over the port's registries), all
but those of the two analyzers left out over the port;
tests/test_torch_ref_model_check.py does the same for
tests/test_model_check.py.
"""
from __future__ import annotations

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from torch_refcases import adopt

REPO = Path(__file__).resolve().parent.parent
PORT = "language_detector_tpu_torch"
REF = "language_detector_tpu"

_LEFT_OUT = "runs trace-safety or jit-contract, which tools.lint_torch " \
            "leaves out over the port (tools/lint_torch/__main__.py " \
            "LEFT_OUT: the port has no jax.jit)"

LINT_CASES = adopt("lint", globals(), exclude={
    name: _LEFT_OUT for name in (
        "test_trace_bad_fixture_trips_every_rule",
        "test_trace_good_fixture_is_clean",
        "test_trace_suppression_honored_and_reasonless_inert",
        "test_jit_bad_fixture_trips", "test_jit_good_fixture_is_clean",
        "test_jit_ring_bad_fixture_trips",
        "test_jit_ring_good_fixture_is_clean",
        "test_jit_live_device_path_is_clean",
        "test_pallas_bad_fixture_trips",
        "test_pallas_good_fixture_is_clean")})

from tools.lint_torch import (__main__ as cli, base, docs,  # noqa: E402
                              event_registry, faults_registry,
                              fsm_registry, future_resolution,
                              knob_registry, layout_registry,
                              lock_discipline, metric_registry,
                              model_check, ownership, torn_write)


def _port_rel(rel: str) -> bool:
    return rel.startswith(f"{PORT}/") and (REPO / rel).is_file()


# analyzer -> the repo-relative files it reads
SCAN_SETS = {
    "lock-discipline": lambda: set(ownership.LOCK_OWNERSHIP),
    "knob-registry": lambda: {knob_registry.KNOBS_REL} | {
        str(p.relative_to(REPO)) for p in base.iter_package_files(REPO)},
    "metric-registry": lambda: {metric_registry.TELEMETRY_REL} | {
        str(p.relative_to(REPO)) for p in base.iter_package_files(REPO)},
    "event-registry": lambda: {event_registry.FLIGHTREC_REL} | {
        str(p.relative_to(REPO)) for p in base.iter_package_files(REPO)},
    "fault-registry": lambda: {faults_registry.FAULTS_REL} | {
        str(p.relative_to(REPO)) for p in base.iter_package_files(REPO)},
    "fsm-conformance": lambda: {m.file for m in fsm_registry.MACHINES},
    "model-check": lambda: {p[1] for p in model_check.PRODUCTS},
    "future-resolution": lambda: set(future_resolution.SCAN_FILES),
    "layout-registry": lambda: set(layout_registry.SCAN_FILES),
    "publish-order": lambda: set(layout_registry.SCAN_FILES),
    "torn-write": lambda: {p[1] for p in torn_write.TORN_PRODUCTS},
}


# -- the gate -------------------------------------------------------------------


def test_port_lint_gate_is_clean():
    """`python -m tools.lint_torch` is clean, and the run imported the
    port's modules (the model checker drives them) and nothing of the
    JAX package."""
    code = (
        "import sys\n"
        "from tools.lint_torch import __main__ as cli\n"
        "rc = cli.main([])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'language_detector_tpu' or "
        "m.startswith('language_detector_tpu.'))\n"
        "assert not bad, bad\n"
        f"assert '{PORT}.service.admission' in sys.modules\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ldt-lint: clean" in r.stdout


def test_left_out_analyzers_are_named_with_reasons():
    ran = {name for name, _fn, _emits in cli.ANALYZERS}
    assert set(cli.LEFT_OUT) == {"trace-safety", "jit-contract"}
    assert not ran & set(cli.LEFT_OUT)
    assert all(len(why) > 40 for why in cli.LEFT_OUT.values())
    assert cli.main(["--rule", "trace-host-sync"]) == 2


def test_port_doc_tables_are_current():
    """The gate's drift rules (metric-undocumented, event-undocumented,
    knob-docs-drift, layout-drift, fault-registry) are what keep the
    port's doc tables current: they read the port's own files, not the
    reference's. The port's launch counter is documented there."""
    for mod in (metric_registry, event_registry, knob_registry,
                layout_registry):
        assert mod.DOCS_REL == docs.OBSERVABILITY_REL
    assert faults_registry.DOCS_REL == docs.ROBUSTNESS_REL
    assert "`ldt_kernel_launches_total`" in \
        (REPO / docs.OBSERVABILITY_REL).read_text()


# -- it scans the right files ---------------------------------------------------


def test_every_analyzer_has_a_port_scan_set():
    assert set(SCAN_SETS) == {name for name, _f, _e in cli.ANALYZERS}
    for name, scan in SCAN_SETS.items():
        files = scan()
        assert files, f"{name}: empty scan set"
        stray = sorted(f for f in files if not _port_rel(f))
        assert not stray, f"{name} reads files outside the port: {stray}"
        assert not any(f.startswith(f"{REF}/") for f in files)


def test_registries_are_the_ports():
    assert knob_registry.KNOBS_REL == f"{PORT}/knobs.py"
    assert metric_registry.DOCS_REL == docs.OBSERVABILITY_REL
    assert faults_registry.DOCS_REL == docs.ROBUSTNESS_REL
    assert base.repo_root() == REPO
    pkg = {p.relative_to(REPO).parts[0]
           for p in base.iter_package_files(REPO)}
    assert pkg == {PORT}
    for m in fsm_registry.MACHINES:
        assert (REPO / m.file).is_file(), m.name
    for product in model_check.PRODUCTS:
        assert (REPO / product[1]).is_file(), product[0]
    # the model checker drives the port's own classes
    from language_detector_tpu_torch.service import admission
    assert model_check.run_product(model_check.PRODUCTS[0][0])[1] > 1
    assert admission.__name__.startswith(PORT)


# -- seeded violations ----------------------------------------------------------


@pytest.fixture()
def seed_tree(tmp_path):
    """A copy of the port's sources and doc tables to seed faults into."""
    shutil.copytree(REPO / PORT, tmp_path / PORT,
                    ignore=shutil.ignore_patterns("*.so", "*.o",
                                                  "__pycache__", "build"))
    (tmp_path / "docs").mkdir()
    for rel in (docs.OBSERVABILITY_REL, docs.ROBUSTNESS_REL):
        shutil.copy(REPO / rel, tmp_path / rel)
    return tmp_path


def _seed_method(root: Path, rel: str, cls: str, body: str) -> None:
    """Append a method to class `cls` of a copied module."""
    path = root / rel
    text = path.read_text()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.ClassDef) and n.name == cls)
    lines = text.splitlines(keepends=True)
    method = "".join("    " + ln + "\n" for ln in body.splitlines())
    lines.insert(node.end_lineno, "\n" + method)
    path.write_text("".join(lines))


def _seed_append(root: Path, rel: str, text: str) -> None:
    with open(root / rel, "a") as f:
        f.write("\n" + text + "\n")


def _rule_set(violations) -> set:
    return {v.rule for v in violations}


def test_seeded_direct_env_read_of_undeclared_knob(seed_tree):
    rel = f"{PORT}/slo.py"
    _seed_append(seed_tree, rel, "def _seeded():\n"
                       "    a = os.environ.get('LDT_SEEDED_KNOB')\n"
                       "    return a, knobs.get_str('LDT_SEEDED_KNOB')")
    v, _ = knob_registry.check(root=seed_tree, files=[rel])
    assert {"knob-direct-env", "knob-undeclared"} <= _rule_set(v)
    assert all(x.path == rel for x in v)
    assert knob_registry.check(root=REPO, files=[rel])[0] == []


def test_seeded_undeclared_metric(seed_tree):
    rel = f"{PORT}/slo.py"
    _seed_append(seed_tree, rel, "def _seeded():\n    telemetry.REGISTRY."
                       "counter_inc('ldt_seeded_total')")
    v, _ = metric_registry.check(root=seed_tree, files=[rel])
    assert "metric-undeclared" in _rule_set(v)
    assert any("ldt_seeded_total" in x.message for x in v)


def test_seeded_undeclared_fsm_transition(seed_tree):
    rel = f"{PORT}/service/admission.py"
    _seed_method(seed_tree, rel, "CircuitBreaker",
                "def _seeded(self):\n"
                "    if self._state == BREAKER_OPEN:\n"
                "        self._state = BREAKER_CLOSED")
    v, _ = fsm_registry.check(root=seed_tree, files=[rel])
    hits = [x for x in v if x.rule == "fsm-undeclared-transition"]
    assert hits and all(x.path == rel for x in hits)
    assert fsm_registry.check(root=REPO, files=[rel])[0] == []


def test_seeded_lock_taken_outside_its_ownership(seed_tree):
    rel = f"{PORT}/telemetry.py"
    _seed_method(seed_tree, rel, "Histogram",
                "def _seeded(self):\n    return self.counts")
    v, _ = lock_discipline.check(root=seed_tree)
    assert [x.path for x in v if x.rule == "lock-discipline"] == [rel]


def test_seeded_reasonless_suppression(seed_tree):
    rel = f"{PORT}/slo.py"
    _seed_append(seed_tree, rel, "_SEEDED = 1  # ldt-lint: disable=knob-direct-env")
    v, _ = knob_registry.check(root=seed_tree, files=[rel])
    assert _rule_set(v) == {"lint-suppression-missing-reason"}
