"""The case map (tests/torch_case_map.py) and the port's surface against
the reference's.

Every case of the 49 reference test modules is adopted, held by a named
port test or left out with a reason of the closed list; a seeded
unaccounted case, a stale port node id and an unlisted reason each make
the map fail. Every module of language_detector_tpu/ has its port, every
public name and method its counterpart, the registries and the CLIs'
argparse options match, each up to the departures listed with a reason.
"""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

import torch_case_map as cm

REF = cm.REPO / cm.REF_PKG
PORT = cm.REPO / cm.PORT_PKG


def test_every_reference_case_is_accounted_for():
    kinds, problems = cm.account()
    assert not problems, "\n".join(problems)
    assert len(kinds) == len(cm.ref_modules()) == 49
    n = cm.counts(kinds)
    assert n["a"] and n["b"] and n["c"]
    assert sum(n.values()) == sum(len(v) for v in kinds.values())


def test_the_twenty_one_modules_run_on_the_port():
    """Each of the modules that had only hand-written port copies has an
    adopted case or none left to adopt (all held or left out)."""
    kinds, _ = cm.account()
    adopted = cm.adoptions()
    for mod in ("swap", "service", "wire", "pool", "integrity", "sharding",
                "bucket_scheduler", "pipeline", "batch_agreement", "spans",
                "result_vector", "hints_parity", "kernel_parity",
                "debug_trace"):
        assert mod in adopted, mod
        assert "a" in kinds[mod].values(), mod
    for mod in ("aot", "autotune", "loadgen", "longdoc_span_merge",
                "shared_cache", "shmring", "supervisor"):
        assert "a" not in kinds[mod].values(), mod


@pytest.fixture()
def seeded():
    """The tree as read, in a form the fault cases can change."""
    mods = cm.ref_modules()
    cases = {m: cm.cases_of(cm.TESTS / f"test_{m}.py") for m in mods}
    adopted = {m: (f, dict(ex)) for m, (f, ex) in cm.adoptions().items()}
    left = {m: dict(v) for m, v in cm.LEFT.items()}
    return mods, cases, adopted, left


def test_seeded_unaccounted_case_fails(seeded):
    mods, cases, adopted, left = seeded
    cases["shmring"] = cases["shmring"] + ["test_seeded_new_case"]
    _, problems = cm.account(mods, cases, adopted, left)
    assert problems == ["test_shmring.py::test_seeded_new_case: not "
                        "accounted for"]


def test_stale_port_node_id_fails(seeded):
    mods, cases, adopted, left = seeded
    left["loadgen"]["test_flash_crowd_steps_x10"] = \
        "held by tests/test_torch_loadgen.py::test_renamed_away"
    adopted["swap"][1]["test_compile_cache_dir_knob"] = \
        "held by tests/test_torch_no_such_file.py::test_compile_cache_dir_knob"
    _, problems = cm.account(mods, cases, adopted, left)
    assert problems == [
        "test_loadgen.py::test_flash_crowd_steps_x10: held by tests/"
        "test_torch_loadgen.py::test_renamed_away, which tests/"
        "test_torch_loadgen.py does not define",
        "test_swap.py::test_compile_cache_dir_knob: held by tests/"
        "test_torch_no_such_file.py, which does not exist"]


@pytest.mark.parametrize("reason", [
    "left out: too slow: the port is fast enough",
    "left out: C2 [a departure nobody listed]: it differs",
    "left out: C3 [tests/test_pool.py::test_round_robin_rotation]: red",
    "skipped, see the port's own test",
])
def test_unlisted_reason_fails(seeded, reason):
    mods, cases, adopted, left = seeded
    left["shmring"]["test_lease_fault_retries_frame"] = reason
    _, problems = cm.account(mods, cases, adopted, left)
    assert len(problems) == 1 and problems[0].startswith(
        "test_shmring.py::test_lease_fault_retries_frame: "), problems


def test_entry_naming_no_reference_case_fails(seeded):
    mods, cases, adopted, left = seeded
    left["shmring"]["test_never_written"] = \
        "held by tests/test_torch_shmring.py::test_lease_fault_retries_frame"
    adopted["swap"][1]["test_gone"] = "left out: oracle: needs the suite"
    _, problems = cm.account(mods, cases, adopted, left)
    assert sorted(problems) == [
        "shmring: test_never_written names no reference case",
        "swap: test_gone names no reference case"]


# -- the port's surface ------------------------------------------------------


def _rel(p: Path) -> str:
    return p.relative_to(REF).as_posix()


def test_every_reference_module_has_its_port():
    missing = [_rel(p) for p in REF.rglob("*.py")
               if not (PORT / p.relative_to(REF)).is_file()]
    assert not missing, missing


def _bound(path: Path, imports: bool) -> tuple[set, dict]:
    """Top-level names a module binds (through def, class, assignment,
    and with `imports` import) and each class's method names."""
    names: set = set()
    methods: dict = {}

    def visit(body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                names.add(n.name)
            if isinstance(n, ast.ClassDef):
                methods[n.name] = {
                    b.name for b in n.body
                    if isinstance(b, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))}
            if isinstance(n, ast.Assign):
                names.update(x.id for t in n.targets for x in ast.walk(t)
                             if isinstance(x, ast.Name))
            if isinstance(n, ast.AnnAssign) \
                    and isinstance(n.target, ast.Name):
                names.add(n.target.id)
            if imports and isinstance(n, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in n.names)
            if isinstance(n, ast.If):
                visit(n.body)
                visit(n.orelse)
            if isinstance(n, ast.Try):
                visit(n.body)
                visit(n.orelse)
                for h in n.handlers:
                    visit(h.body)

    visit(ast.parse(path.read_text()).body)
    return names, methods


def _public(names) -> set:
    return {n for n in names if not n.startswith("_")}


def test_public_names_and_methods_have_counterparts():
    """A public top-level name or public method of a reference module
    exists in the port's counterpart (a name the port imports counts),
    except SURFACE_LEFT_OUT; every listed name is really absent."""
    problems = []
    for ref in sorted(REF.rglob("*.py")):
        rel = _rel(ref)
        left = cm.SURFACE_LEFT_OUT.get(rel, {})
        rn, rm = _bound(ref, imports=False)
        pn, pm = _bound(PORT / rel, imports=True)
        missing = set(_public(rn) - pn)
        for cls, meths in rm.items():
            if cls.startswith("_") or cls not in pm:
                continue
            missing |= {f"{cls}.{m}" for m in _public(meths) - pm[cls]}
        for name in sorted(missing - set(left)):
            problems.append(f"{rel}: {name} has no counterpart")
        for name in sorted(set(left) - missing):
            problems.append(f"{rel}: listed {name} is not missing")
        problems += [f"{rel}: {name} has no reason"
                     for name, why in left.items() if not why]
    assert not problems, "\n".join(problems)
    assert set(cm.SURFACE_LEFT_OUT) <= {_rel(p) for p in REF.rglob("*.py")}


@pytest.mark.parametrize("ref_mod,port_mod,attr,ref_only,port_only", [
    ("knobs", "knobs", "KNOBS", cm.KNOBS_REF_ONLY, cm.KNOBS_PORT_ONLY),
    ("telemetry", "telemetry", "METRICS", cm.METRICS_REF_ONLY,
     cm.METRICS_PORT_ONLY),
    ("flightrec", "flightrec", "EVENTS", cm.EVENTS_REF_ONLY,
     cm.EVENTS_PORT_ONLY),
    ("faults", "faults", "FAULT_POINTS", cm.FAULTS_REF_ONLY,
     cm.FAULTS_PORT_ONLY),
])
def test_registries_equal_up_to_listed_departures(ref_mod, port_mod, attr,
                                                  ref_only, port_only):
    import importlib
    ref = getattr(importlib.import_module(f"{cm.REF_PKG}.{ref_mod}"), attr)
    port = getattr(importlib.import_module(f"{cm.PORT_PKG}.{port_mod}"),
                   attr)
    assert set(ref) - set(port) == set(ref_only)
    assert set(port) - set(ref) == set(port_only)
    assert all(ref_only.values()) and all(port_only.values())


def _options(paths) -> set:
    out = set()
    for path in paths:
        for n in ast.walk(ast.parse(path.read_text())):
            if isinstance(n, ast.Call) \
                    and getattr(n.func, "attr", None) == "add_argument":
                out |= {a.value for a in n.args
                        if isinstance(a, ast.Constant)
                        and isinstance(a.value, str)}
    return out


def _reference_clis() -> list[str]:
    files = [p for p in REF.rglob("*.py")] \
        + sorted((cm.REPO / "tools").glob("*.py")) + [cm.REPO / "bench.py"]
    return sorted(p.relative_to(cm.REPO).as_posix() for p in files
                  if "add_argument" in p.read_text())


def _port_files(ref: str) -> list[Path]:
    if ref in cm.CLI_FILES:
        return sorted((cm.REPO / cm.CLI_FILES[ref]).rglob("*.py"))
    if ref.startswith("tools/"):
        return [PORT / ref]
    return [PORT / Path(ref).relative_to(cm.REF_PKG)]


def test_cli_options_are_a_subset_of_the_ports():
    clis = _reference_clis()
    assert {"language_detector_tpu/debug.py", "tools/artifact_tool.py",
            "tools/eval_corpus.py"} <= set(clis)
    for ref in clis:
        port = _port_files(ref)
        assert port and all(p.is_file() for p in port), ref
        ro, po = _options([cm.REPO / ref]), _options(port)
        assert ro and ro <= po, (ref, sorted(ro - po))
        extra = po - ro - {"--device"}
        assert extra == set(cm.CLI_PORT_ONLY.get(ref, {})), (ref, extra)
