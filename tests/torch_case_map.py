"""Where each case of the reference's tests runs on the port.

Every `test_*` function and `Test*` class method of every reference
test module, `tests/test_<name>.py` (not `test_torch_*`), is exactly
one of:

  (a) adopted: it runs on the port through `torch_refcases.adopt` in a
      `tests/test_torch_*.py` module (`tests/test_torch_ref_<name>.py`,
      and `tests/test_torch_lint.py` for test_lint), and is not in that
      call's `exclude`;
  (b) held by a named port test: its reason reads
      "held by tests/test_torch_<x>.py::<case>[; why]", a hand-written
      port test that checks the same behaviour on the port;
  (c) left out, its reason reading "left out: <class>: why" with a
      class of the closed list CLASSES: `oracle` (it needs the CLD2
      oracle library or the golden suite), `JAX-only` (jit tracing,
      per-shape XLA compiles, Pallas or interpret mode, the jax.export
      AOT path), `C2 [<departure>]` (a ROADMAP C2 departure, named by a
      key of C2_DEPARTURES) or `C3 [<node id>]` (a JAX test named in
      ROADMAP C3 as red or a timing test on the JAX package).

The reasons of cases a module with an adopt call does not run are that
call's `exclude` dict; the reasons of modules no port module adopts
are LEFT below. `account()` reads the files with `ast` and returns every
problem it finds (tests/test_torch_case_map.py holds it to none).

The surface lists below are the reference's names, registry entries and
CLI options the port does not carry, each with its reason.
"""
from __future__ import annotations

import ast
import functools
import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"
REF_PKG = "language_detector_tpu"
PORT_PKG = "language_detector_tpu_torch"

CLASSES = {
    "oracle": "it needs the CLD2 oracle library or the golden suite",
    "JAX-only": "it tests a JAX-only mechanism: jit tracing, per-shape "
                "XLA compiles, Pallas or interpret mode, or the "
                "jax.export AOT path",
    "C2": "it tests a ROADMAP C2 departure, named",
    "C3": "it is a JAX test named in ROADMAP C3",
}

# key -> a phrase of its bullet in ROADMAP.md's C2 section
C2_DEPARTURES = {
    "scalar fallback": "The device service never answers on the scalar "
                       "engine",
}

HELD_RE = re.compile(r"held by (tests/test_torch_\w+\.py)::"
                     r"([\w:]+)(\[[^\]]*\])?(;|$)")
LEFT_RE = re.compile(r"left out: (oracle|JAX-only|C2 \[([^\]]+)\]|"
                     r"C3 \[([^\]]+)\]): \S")

_ORACLE_LIB = ("left out: oracle: it compares with the compiled CLD2 "
               "oracle library (tools/oracle/, built from the reference "
               "snapshot)")
_GOLDEN = ("left out: oracle: its documents are the CLD2 golden suite "
           "(tests/golden_data.py reads the reference snapshot)")


def _held(module: str, *cases: str, in_file: str | None = None) -> dict:
    """{case: held by the same-named case of tests/test_torch_<x>.py}."""
    f = in_file or f"tests/test_torch_{module}.py"
    return {c: f"held by {f}::{c}" for c in cases}


# Reasons of the reference modules that no port module adopts.
LEFT: dict[str, dict[str, str]] = {
    "aot": {
        "test_fresh_process_export_then_load_bit_identity":
            "held by tests/test_torch_cuda.py::"
            "test_bundle_boot_hot_fresh_process; the port's bundle in a "
            "fresh process on the card (the reference's jax.export "
            "entries are red, ROADMAP C3)",
        "test_same_process_second_engine_loads":
            "held by tests/test_torch_aot.py::test_export_then_load_native;"
            " a second store loads the first one's library entry",
        "test_preload_deserializes_every_entry":
            "held by tests/test_torch_aot.py::test_preload_loads_every_entry",
        "test_digest_mismatch_refused":
            "held by tests/test_torch_aot.py::test_key_mismatch_refused"
            "[digest]",
        "test_backend_mismatch_refused":
            "held by tests/test_torch_aot.py::test_key_mismatch_refused"
            "[arch]",
        "test_jax_version_mismatch_refused":
            "held by tests/test_torch_aot.py::test_key_mismatch_refused"
            "[torch]; the port's entry key names torch and CUDA where "
            "the reference's names jax",
        "test_kernel_mismatch_refused":
            "held by tests/test_torch_aot.py::test_key_mismatch_refused"
            "[kernel]",
        "test_compile_cache_dir_created_when_missing":
            "left out: JAX-only: it checks jax.config's compilation "
            "cache directory, which the port does not have (its "
            "LDT_COMPILE_CACHE_DIR: tests/test_torch_aot.py::"
            "test_compile_cache_dir_knob)",
        **_held("aot", "test_corrupt_entry_refused_via_fault_seam",
                "test_require_escalates_to_typed_error",
                "test_refused_entry_falls_back_and_self_heals",
                "test_aot_dir_created_when_missing",
                "test_aot_off_without_knob"),
    },
    "autotune": _held(
        "autotune", "test_knob_space_covers_declared_mutables",
        "test_knob_space_restricts_to_names",
        "test_candidates_for_unset_knob_ladder_in_range",
        "test_candidates_for_live_value_multiplier_moves",
        "test_candidates_clamp_to_mrange",
        "test_score_feasibility_dominates_throughput",
        "test_score_without_spec_is_throughput",
        "test_autotune_finds_feasible_optimum",
        "test_autotune_counts_evals_and_caches",
        "test_autotune_respects_live_overrides_as_start",
        "test_autotune_result_shape_for_bench_round",
        "test_autotune_with_pytest_approx_noise_free_determinism",
        "test_autotune_uses_declared_slo_from_env"),
    "loadgen": _held(
        "loadgen", "test_same_seed_is_byte_identical",
        "test_distinct_seeds_distinct_but_rate_conserving",
        "test_records_use_capture_shape", "test_flash_crowd_steps_x10",
        "test_burst_lull_alternates", "test_diurnal_peaks_mid_span",
        "test_tenant_shift_rotates_hot_tenant",
        "test_unknown_scenario_raises", "test_base_rate_scales_span"),
    "longdoc_span_merge": _held(
        "longdoc_span_merge", "test_span_rows_sum_to_merged_totals",
        "test_retained_slices_equal_source_rows",
        "test_keep_spans_false_unchanged",
        in_file="tests/test_torch_scheduler.py"),
    "shared_cache": _held(
        "shared_cache", "test_put_get_roundtrip",
        "test_two_attached_views_share_entries",
        "test_incompatible_layout_refused",
        "test_oversized_value_never_published", "test_cross_process_hits",
        "test_writer_killed_mid_slot_never_serves_and_stays_live",
        "test_torn_payload_refused_by_crc",
        "test_displacement_adopts_dead_slots",
        "test_eviction_on_full_window",
        "test_epoch_roll_flushes_and_refuses_stale",
        "test_put_under_new_epoch_reclaims_stale_slots",
        "test_result_cache_writes_through_and_promotes",
        "test_result_cache_rich_values_stay_private",
        "test_result_cache_epoch_forwarded_to_shared",
        "test_single_flight_claim_resolve",
        "test_single_flight_epoch_roll_wakes_waiters",
        "test_single_flight_collapses_concurrent_fills"),
    "shmring": _held(
        "shmring", "test_roundtrip_parity_and_pipelining",
        "test_error_frames_match_uds_contract",
        "test_client_sigkill_mid_writing_is_reclaimed",
        "test_worker_crash_fences_old_generation_no_hang",
        "test_quarantine_bisection_isolates_poison_doc",
        "test_lease_fault_retries_frame",
        "test_oversize_frame_refused_at_submit"),
    "supervisor": {
        **_held("supervisor", "test_child_exit_code_propagates",
                "test_clean_exit_propagates_zero",
                "test_recycle_restarts_then_propagates",
                "test_restart_on_crash_recovers",
                "test_crash_without_optin_propagates",
                "test_crash_loop_detected",
                "test_generation_env_handed_to_children",
                "test_compile_cache_dir_shared_across_generations",
                "test_compile_cache_dir_defaults_per_supervisor",
                "test_sighup_swap_drill_promotes_standby",
                "test_sighup_swap_aborts_when_standby_dies",
                "test_sighup_swap_aborts_on_injected_fault",
                "test_sighup_swap_artifact_pointer",
                "test_signal_forwarded_to_child"),
        **_held("supervisor", "test_fleet_spawns_n_members_and_drains_clean",
                "test_fleet_two_simultaneous_recycles",
                "test_fleet_sigterm_during_rolling_swap",
                "test_fleet_member_death_during_rolling_swap",
                "test_fleet_crash_loop_parks_member_and_circuit_recovers",
                "test_fleet_spawn_fault_retries_after_backoff",
                "test_fleet_worker_lost_fault_fails_over",
                in_file="tests/test_torch_fleet.py"),
        "test_generation2_warmup_substantially_below_generation1":
            "left out: C3 [tests/test_supervisor.py::"
            "test_generation2_warmup_substantially_below_generation1]: a "
            "JAX timing test (its second generation loads serialized XLA "
            "executables); the port checks without a clock that the "
            "standby is handed generation 1's bundle and cache dirs",
    },
    "long_docs": {c: _GOLDEN for c in (
        "test_multi_round_spans_stay_on_device",
        "test_detect_many_routes_long_docs", "test_dispatch_volume_cap",
        "test_single_script_60kb_on_device")},
    "eval_regression": {"test_golden_accuracy_floor": _GOLDEN},
    "golden_parity": {"test_golden_full_parity": _ORACLE_LIB,
                      "test_golden_accuracy_floor": _GOLDEN},
    "hash_parity": {"test_hash_parity": _ORACLE_LIB,
                    "test_pair_hash_parity": _ORACLE_LIB},
    "html_parity": {"test_html_span_parity": _ORACLE_LIB,
                    "test_french_html_file_span_parity": _ORACLE_LIB,
                    "test_french_html_detection_parity": _ORACLE_LIB},
    "long_spans": {"test_long_span_parity": _ORACLE_LIB},
    "segment_parity": {"test_span_parity": _ORACLE_LIB},
    "squeeze_parity": {"test_squeeze_parity": _ORACLE_LIB},
}

# -- the port's surface against the reference's -----------------------------

# reference module (package-relative) -> {public name or Class.method:
# why the port has none}
_JAX_PROGRAM = ("a JAX program, or the selection among them: the port has "
                "one device program, the kernel csrc/fused_tote.cu, and "
                "its plain version (ROADMAP B)")
SURFACE_LEFT_OUT = {
    "__init__.py": {
        "enable_jit_cache": "JAX's persistent compilation cache; the "
                            "port's kernel library cache is "
                            "LDT_COMPILE_CACHE_DIR (aot.py)"},
    "aot.py": {
        "shape_signature": "keys an XLA executable by tier shape; the "
                           "port's bundle keeps one entry a kernel "
                           "library (ROADMAP C2)"},
    "ops/device_tables.py": {
        "KindTables": "the per-kind table pytree of the JAX scorer; the "
                      "port keeps its planes on DeviceTables"},
    "ops/kernels.py": {
        **{name: _JAX_PROGRAM for name in (
            "KernelSelection", "select_kernel", "mesh_selection",
            "score_chunks_fused", "score_chunks_fused_donated",
            "score_chunks_fused_full", "score_chunks_fused_impl",
            "score_chunks_lax", "score_chunks_lax_donated",
            "score_chunks_lax_full", "score_chunks_lax_impl")},
        "TILE_G": "the Pallas grid tile; the Hopper kernel's launch "
                  "shape is its own",
        "pl": "jax.experimental.pallas",
        "table_digest_impl": "the jitted digest; the port's is "
                             "kernels.table_digest (torch ops)"},
    "ops/score.py": {name: _JAX_PROGRAM for name in (
        "score_chunks", "score_chunks_donated", "score_chunks_full",
        "score_chunks_impl")},
    "parallel/mesh.py": {
        "batch_sharding": "a jax NamedSharding; the port's mesh is a "
                          "DeviceMesh of torch devices"},
    "telemetry.py": {
        "TelemetryRegistry.percentile_across":
            "reads ldt_xla_compile_ms, which the port does not declare "
            "(ROADMAP C2)"},
}

# the reference's registry entries the port does not carry, and the
# port's own, each with its reason (ROADMAP C2)
KNOBS_REF_ONLY = {
    "LDT_KERNEL": "one kernel: no JAX program to select",
    "LDT_KERNEL_INTERPRET": "no Pallas interpret mode",
    "LDT_LONGDOC_SPLIT_SLOTS": "the long-doc lane's threshold is the "
                               "constant LONGDOC_SPLIT_SLOTS",
    "TPU_WORKER_HOSTNAMES": "the multi-process contract sets up "
                            "torch.distributed, not a TPU pod",
}
KNOBS_PORT_ONLY = {
    "CUDA_HOME": "where nvcc is found for the kernel's build",
    "LDT_REFERENCE_DIR": "the CLD2 snapshot's golden suite and octagram "
                         "sources, hard-coded in the reference",
}
METRICS_REF_ONLY = {
    "ldt_xla_compile_ms": "no per-shape compile; the breaker folds in no "
                          "library build",
    "ldt_pipeline_donation_hits_total": "the port donates no device "
                                        "buffer",
}
METRICS_PORT_ONLY = {
    "ldt_kernel_launches_total": "the kernel wrapper's launch count, so "
                                 "a fleet holds launches to dispatches",
}
EVENTS_REF_ONLY: dict = {}
EVENTS_PORT_ONLY: dict = {}
FAULTS_REF_ONLY: dict = {}
FAULTS_PORT_ONLY: dict = {}

# reference CLI file -> the port files that parse its options (default:
# the same path under the port's package, or language_detector_tpu_torch/
# tools/<name> for tools/<name>)
CLI_FILES = {
    "bench.py": f"{PORT_PKG}/bench",
}
# options the port adds beyond `--device` (cuda by default, raising
# without a card): reference CLI -> {option: why}
CLI_PORT_ONLY = {
    "tools/artifact_tool.py": {
        "--data": "the table directory read (the reference reads the "
                  "shipped one)",
        "--out": "the directory written (the reference writes into the "
                 "shipped data)"},
}

# -- reading the tests -------------------------------------------------------


def ref_modules() -> list[str]:
    """Names <name> of the reference's tests/test_<name>.py."""
    return sorted(p.stem[5:] for p in TESTS.glob("test_*.py")
                  if not p.stem.startswith("test_torch_"))


@functools.lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text())


def cases_of(path: Path) -> list[str]:
    """The test functions and Test* class methods of a test file."""
    tree = _tree(path)
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.startswith("test_"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef) \
                and node.name.startswith("Test"):
            out += [f"{node.name}::{b.name}" for b in node.body
                    if isinstance(b, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    and b.name.startswith("test_")]
    return out


def _strings(tree: ast.Module) -> dict:
    """Module-level NAME = "string" assignments (for exclude reasons)."""
    env: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                env[node.targets[0].id] = _value(node.value, env)
            except ValueError:
                pass
    return env


def _value(node: ast.AST, env: dict):
    """A constant, a name bound to one, a tuple, a dict or
    `{k: v for k in (...)}` of them."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name) and node.id in env:
        return env[node.id]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _value(node.left, env) + _value(node.right, env)
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(_value(e, env) for e in node.elts)
    if isinstance(node, ast.Dict):
        return {_value(k, env): _value(v, env)
                for k, v in zip(node.keys, node.values)}
    if isinstance(node, ast.DictComp) and len(node.generators) == 1 \
            and isinstance(node.generators[0].target, ast.Name):
        gen = node.generators[0]
        out = {}
        for item in _value(gen.iter, env):
            inner = dict(env, **{gen.target.id: item})
            out[_value(node.key, inner)] = _value(node.value, inner)
        return out
    raise ValueError(ast.dump(node)[:80])


def adoptions() -> dict:
    """{reference module: (port file, {excluded case: reason})} for every
    adopt("<name>", ..., exclude=...) call in tests/test_torch_*.py."""
    out: dict = {}
    for path in sorted(TESTS.glob("test_torch_*.py")):
        tree = _tree(path)
        env = _strings(tree)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "adopt"):
                continue
            name = _value(node.args[0], env)
            exclude = {}
            for kw in node.keywords:
                if kw.arg == "exclude":
                    exclude = _value(kw.value, env)
            assert name not in out, f"test_{name}.py adopted twice"
            out[name] = (f"tests/{path.name}", exclude)
    return out


def _defines(path: Path, case: str) -> bool:
    tree = _tree(path)
    cls, _, meth = case.rpartition("::")
    for node in tree.body:
        if not cls and isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) \
                and node.name == meth:
            return True
        if cls and isinstance(node, ast.ClassDef) and node.name == cls:
            return any(getattr(b, "name", None) == meth
                       for b in node.body)
    return False


@functools.lru_cache(maxsize=None)
def _roadmap_section(head: str, stop: str) -> str:
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index(head)
    end = text.index(stop, start)
    return re.sub(r"\s+", " ", text[start:end]).replace(":: ", "::")


def reason_problems(where: str, reason: str) -> list[str]:
    """What is wrong with one (b) or (c) reason; [] when it is sound."""
    m = HELD_RE.match(reason)
    if m:
        f, case = m.group(1), m.group(2)
        path = REPO / f
        if not path.is_file():
            return [f"{where}: held by {f}, which does not exist"]
        if not _defines(path, case):
            return [f"{where}: held by {f}::{case}, which {f} does not "
                    "define"]
        return []
    m = LEFT_RE.match(reason)
    if not m:
        return [f"{where}: reason is neither 'held by <port node id>' "
                f"nor 'left out: <class>: why' with a class of "
                f"{sorted(CLASSES)}: {reason[:80]!r}"]
    if m.group(2) is not None:
        dep = m.group(2)
        if dep not in C2_DEPARTURES:
            return [f"{where}: C2 departure {dep!r} is not listed"]
        if C2_DEPARTURES[dep] not in _roadmap_section("**C2.", "**C3."):
            return [f"{where}: C2 departure {dep!r} is not in ROADMAP C2"]
    if m.group(3) is not None:
        node = m.group(3)
        if node not in _roadmap_section("**C3.", "## Recent"):
            return [f"{where}: {node} is not named in ROADMAP C3"]
        f, _, case = node.partition("::")
        if not (REPO / f).is_file() or not _defines(REPO / f, case):
            return [f"{where}: C3 node id {node} does not exist"]
    return []


def account(modules=None, cases=None, adopted=None, left=None) -> tuple:
    """({module: {case: "a" | "b" | "c"}}, [problems]) over every case
    of every reference test module. The arguments stand in for what is
    read from the tree (the tests seed faults through them)."""
    modules = ref_modules() if modules is None else modules
    adopted = adoptions() if adopted is None else adopted
    left = LEFT if left is None else left
    kinds: dict = {}
    problems: list = []
    for mod in sorted(set(adopted) | set(left)):
        if mod not in modules:
            problems.append(f"{mod}: no reference module tests/test_{mod}.py")
    for mod in modules:
        have = (cases or {}).get(mod) or cases_of(TESTS / f"test_{mod}.py")
        if mod in adopted and mod in left:
            problems.append(f"{mod}: adopted and in LEFT too")
        reasons = adopted[mod][1] if mod in adopted else left.get(mod, {})
        for case in sorted(set(reasons) - set(have)):
            problems.append(f"{mod}: {case} names no reference case")
        out = kinds.setdefault(mod, {})
        for case in have:
            where = f"test_{mod}.py::{case}"
            if case in reasons:
                why = reasons[case]
                problems += reason_problems(where, why)
                out[case] = "b" if why.startswith("held by") else "c"
            elif mod in adopted:
                out[case] = "a"
            else:
                problems.append(f"{where}: not accounted for")
    return kinds, problems


def counts(kinds: dict) -> dict:
    n = {"a": 0, "b": 0, "c": 0}
    for per in kinds.values():
        for k in per.values():
            n[k] += 1
    return n
